"""One frame as one captured program: the port's counterpart of ``jax.jit``
over a frame.

The JAX examples compile each frame into one program (``jax.jit`` of the
sample app's frame tail, ``examples/sample_app.py:228``; of the frame graph's
tail, ``examples/frame_graph.py:78``; of the dataset's upscale,
``examples/dataset_preprocessing.py:64``).  On the card the port records
the frame's launches once into a CUDA graph and replays it, so a frame costs
the host one graph launch however many passes it runs.

``CapturedFrame`` takes the frame function and example inputs (tensors, all
on one device), warms the function up on a side stream (the kernels'
libraries, their plan tables and the dither texture come into being there,
so the capture never misses a cache), captures one ``torch.cuda.CUDAGraph``,
and on each call copies the new inputs into its static ones, replays, and
returns its static output: the same tensors at every call, overwritten by
the next replay, so a caller that keeps an output across frames clones it
(``replay`` replays on the static inputs as they stand, for a caller that
writes them itself: a sharded call's staging, ``parallel``).
On a CPU device it calls the function eagerly (the examples' ``--cpu``
path).  A capture that fails raises, naming the last operation dispatched;
nothing falls back to the eager function.

What a graph does not see: the function's Python runs at capture only, so
the kernels' launch counters (``launches``) count the warm-up and the
capture, never a replay (a replay's launches are read from a trace), and a
value the function reads on the host (a Python int frame, say) is frozen at
capture: per-frame values enter as input tensors (a frame index as a 0-d
int32 tensor, ``ops.extras.frame_index``).  Tensors that the function reads
from a cache (K2's and the torch path's tables) must outlive the graph,
which holds their addresses while the cache may evict them: the caches hand
them out through ``keep``, and the graph keeps what it was captured with.

``CapturedStep`` is the same for a training step, the counterpart of
``jax.jit`` over ``examples/train_through_fsr.py``'s step (forward,
gradient, Adam update and clip in one program): the forward, the backward,
the optimiser's update and whatever else the step does to its parameters
are one graph.  A step mutates state, so its warm-up (``warm_up_step``)
puts the parameters and the optimiser's state back as they were: the first
replay is the first step.
"""

from __future__ import annotations

import contextlib
import gc
from typing import Callable, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["CapturedFrame", "CapturedStep", "WARMUP", "keep", "warm_up_step"]

# Eager calls on a side stream before the capture: the first fills every
# cache the frame reads (libraries, plans, tables, constants on the device),
# the second runs as the capture will.
WARMUP = 2


# What the frame being captured reads from caches (``keep``); None when no
# capture is under way.
_kept: Optional[List] = None


def keep(value):
    """Return ``value``, tensors a cache hands out; during a capture, the
    captured frame also holds on to them, so that its graph's addresses stay
    valid when the cache evicts them."""
    if _kept is not None:
        _kept.append(value)
    return value


@contextlib.contextmanager
def _keeping(into: List):
    global _kept
    outer, _kept = _kept, into
    try:
        yield
    finally:
        _kept = outer


class _LastOp(TorchDispatchMode):
    """Remembers the last aten operation dispatched (the one that broke a
    failed capture)."""

    op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.op = func
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def _capturing(graph, device, name: str, kept: List):
    """Capture into ``graph`` on the current stream of ``device`` (the side
    stream of a warm-up), naming the last operation dispatched if it fails.

    The cyclic garbage collector is off while the capture runs: a dead
    captured object in a reference cycle (a graph, its pool) that it frees
    mid-capture resets its graph and frees device memory, which a stream
    that is capturing does not permit, and the capture fails at the next
    launch (seen on an H100: "operation not permitted when stream is
    capturing (function reset)", then cudaError 901).  It runs again, as
    before, once the capture has ended."""
    last = _LastOp()
    collecting = gc.isenabled()
    gc.disable()
    try:
        # Captured on the side stream, this device's: torch.cuda.graph's
        # default capture stream is one for the whole process, made on the
        # device current at its first use, so a capture on a second card
        # would run on the first card's stream and fail.
        with last, _keeping(kept), torch.cuda.graph(graph, stream=torch.cuda.current_stream(device)):
            yield
    except RuntimeError as e:
        raise RuntimeError(f"capturing {name} on {device} failed at {last.op}: {e}") from e
    finally:
        if collecting:
            gc.enable()


class CapturedFrame:
    """``fn(*inputs)`` captured once as a CUDA graph and replayed per call.

    fn: the frame, a function of tensors returning a tensor (or a tuple of
    them) and reading nothing per frame but its inputs; example_inputs: its
    inputs at the shapes and dtypes every call takes, all on one device (a
    CUDA device captures; a CPU device calls ``fn`` eagerly).  Each call
    copies its inputs (any device, same shapes) into the static inputs,
    replays the graph and returns the static output.  static: the example
    inputs are the static inputs themselves, not copied (a caller that
    allocated them, so that other graphs can name them too: a row-sharded
    call's buffers, ``parallel.spatial.CapturedSpatial``).
    """

    def __init__(self, fn: Callable, *example_inputs: torch.Tensor, static: bool = False):
        devices = {x.device for x in example_inputs}
        if len(devices) != 1:
            raise ValueError(f"a captured frame takes its inputs on one device, got {sorted(map(str, devices))}")
        (self.device,) = devices
        self.fn = fn
        self.graph = None
        if self.device.type != "cuda":
            return
        self.inputs = tuple(example_inputs) if static else tuple(x.clone() for x in example_inputs)
        name = getattr(fn, "__qualname__", repr(fn))
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                for _ in range(WARMUP):
                    fn(*self.inputs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            self.kept = []
            with torch.cuda.stream(side), _capturing(graph, self.device, name, self.kept):
                self.output = fn(*self.inputs)
        self.graph = graph

    def __call__(self, *inputs: torch.Tensor):
        if self.graph is None:
            return self.fn(*inputs)
        if len(inputs) != len(self.inputs):
            raise ValueError(f"the captured frame takes {len(self.inputs)} inputs, got {len(inputs)}")
        for static, x in zip(self.inputs, inputs):
            if x.shape != static.shape:
                raise ValueError(f"the captured frame takes an input of {tuple(static.shape)}, got {tuple(x.shape)}")
        with torch.cuda.device(self.device):
            for static, x in zip(self.inputs, inputs):
                static.copy_(x, non_blocking=True)
        return self.replay()

    def replay(self):
        """Replay the graph on the static inputs as they stand (``inputs``),
        with no copy, and return the static output: a caller that writes a
        frame's inputs straight into ``inputs`` (a sharded call's staging)
        saves the copies ``__call__`` makes.  A CPU frame has no graph and
        raises."""
        if self.graph is None:
            raise RuntimeError(f"a captured frame on {self.device} has no graph to replay: call it")
        with torch.cuda.device(self.device):
            self.graph.replay()
        return self.output


def warm_up_step(step: Callable, params, optimizer) -> None:
    """Take ``WARMUP`` steps, then put ``params`` and ``optimizer``'s state
    back, in place, as they were before them, and set the gradients to None.

    step, params, optimizer: as ``CapturedStep`` takes them.  State that
    the warm-up created (Adam's moments and step count) is zeroed, the
    state the optimiser would create at its first step; state that existed
    before is copied back.  The tensors stay the same tensors, so a graph
    captured after the warm-up names them, and the next step is the first
    step from where the warm-up started, bit for bit."""
    params = list(params)
    before = [p.detach().clone() for p in params]
    state = {p: {k: v.clone() for k, v in s.items() if torch.is_tensor(v)} for p, s in optimizer.state.items()}
    for _ in range(WARMUP):
        step()
    with torch.no_grad():
        for p, p0 in zip(params, before):
            p.copy_(p0)
        for p, s in optimizer.state.items():
            old = state.get(p, {})
            for k, v in s.items():
                if k in old:
                    v.copy_(old[k])
                elif torch.is_tensor(v):
                    v.zero_()
    optimizer.zero_grad(set_to_none=True)


class CapturedStep:
    """A training step captured once as a CUDA graph and replayed per call.

    step: a function of no arguments that runs one step (the forward, the
    backward, ``optimizer.step()`` and anything else the step does to its
    parameters, a clamp say) and returns the loss as a 0-d tensor, reading
    nothing per step from the host; params: every tensor the step updates
    in place, all on one device; optimizer: its ``torch.optim`` optimiser,
    whose fresh state is zeros (Adam, AdamW), built with
    ``capturable=True`` on a CUDA device.  A CUDA device warms the step up
    on a side stream (``warm_up_step``: the optimiser's state comes into
    being there, the caches the step reads fill, and the parameters and
    state are put back), captures one step with the gradients set to None
    (the backward assigns them in the graph's pool), and each call replays
    it and returns the static loss, overwritten by the next replay: nothing
    waits for the device.  A CPU device calls ``step`` eagerly.  A capture
    that fails raises, naming the last operation dispatched.

    The graph's pool keeps what the step allocates (the backward's saved
    tensors among it) between replays, as much as an eager step's peak.
    """

    def __init__(self, step: Callable, params, optimizer: torch.optim.Optimizer):
        params = list(params)
        devices = {p.device for p in params}
        if len(devices) != 1:
            raise ValueError(f"a captured step takes its parameters on one device, got {sorted(map(str, devices))}")
        (self.device,) = devices
        self.step = step
        self.graph = None
        if self.device.type != "cuda":
            return
        if not all(g.get("capturable", False) for g in optimizer.param_groups):
            raise ValueError(f"a step captured on {self.device} needs its optimiser built with capturable=True")
        name = getattr(step, "__qualname__", repr(step))
        with torch.cuda.device(self.device):
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                warm_up_step(step, params, optimizer)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            self.kept = []
            with torch.cuda.stream(side), _capturing(graph, self.device, name, self.kept):
                self.loss = step()
        self.graph = graph

    def __call__(self) -> torch.Tensor:
        """One step: the graph replayed on the card, ``step()`` on the CPU;
        the loss as a 0-d tensor."""
        if self.graph is None:
            return self.step()
        with torch.cuda.device(self.device):
            self.graph.replay()
        return self.loss
