"""The training example's captured step (``capture.CapturedStep``) on the
CPU: what a capture relies on, which runs here without a card.

On the card ``CapturedStep`` warms the step up, puts the parameters and
the optimiser's state back (``capture.warm_up_step``), captures one step as
a CUDA graph and replays it per call; ``chip_smoke.py`` phase 20 holds the
replays bit-equal to the eager steps there.  Here ``warm_up_step`` runs on
its own with the example's CPU optimiser (Adam, not capturable), and must
leave no trace: after it, three steps give the parameters and Adam state of
three steps from a fresh start, bit for bit.  The step functions make no
host read of a device value (no ``.item()``), and ``CapturedStep`` on a CPU
device is the eager step.  The steps' losses against the JAX example's are
in ``tests/test_torch_grad.py``.
"""

from __future__ import annotations

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from examples_torch import train_through_fsr as ttrain
from fsr_tpu_torch.utils import capture

SIZE = 16  # 16 -> 32 rows, the example test's size


def _problem(demo: str):
    """One of the example's problems on the CPU, from seed 0, at the
    example's default learning rates."""
    if demo == "inverse":
        hi = torch.from_numpy(ttrain.make_scene(np.random.default_rng(0), (2 * SIZE, 4 * SIZE)))
        return ttrain.Inverse(hi, 3e-3)
    lo, hi = (torch.from_numpy(a) for a in ttrain.prefilter_scenes(np.random.default_rng(0), SIZE))
    return ttrain.Prefilter(lo, hi, 1e-3)


def _assert_same(a, b) -> None:
    """Parameters and Adam state of two problems bit-equal."""
    for pa, pb in zip(a.params, b.params):
        assert torch.equal(pa, pb)
        sa, sb = a.opt.state[pa], b.opt.state[pb]
        assert sorted(sa) == sorted(sb) == ["exp_avg", "exp_avg_sq", "step"]
        for k in sa:
            assert torch.equal(sa[k], sb[k]), k


@pytest.mark.parametrize("before", [0, 1], ids=["fresh", "after_a_step"])
@pytest.mark.parametrize("demo", ["inverse", "prefilter"])
def test_warm_up_leaves_no_trace(demo, before):
    """``warm_up_step`` takes ``WARMUP`` steps and puts everything back:
    the state it created is zeroed (fresh Adam: moments and step count 0),
    the state that was there is copied back, the gradients are None.
    Then three steps equal three steps of a problem that never warmed up,
    parameters and Adam state bit for bit (the example's non-capturable CPU
    Adam), for the inverse problem's render and the prefilter's (k, b)."""
    warm, cold = _problem(demo), _problem(demo)
    assert not warm.opt.param_groups[0]["capturable"]
    for _ in range(before):
        warm.step()
        cold.step()
    start = [p.detach().clone() for p in warm.params]
    capture.warm_up_step(warm.step, warm.params, warm.opt)
    assert capture.WARMUP == 2
    assert all(p.grad is None for p in warm.params)
    for p, p0 in zip(warm.params, start):
        assert torch.equal(p, p0)
    for _ in range(3):
        assert torch.equal(warm.step(), cold.step())
    _assert_same(warm, cold)


@pytest.mark.parametrize("demo", ["inverse", "prefilter"])
def test_captured_step_on_cpu_is_the_eager_step(demo):
    """On a CPU device ``CapturedStep`` captures nothing and each call is
    the step function's call: the same 0-d losses and the same parameters
    and Adam state as calling the step function, bit for bit."""
    prob, ref = _problem(demo), _problem(demo)
    step = capture.CapturedStep(prob.step, prob.params, prob.opt)
    assert step.graph is None and step.device == torch.device("cpu")
    for _ in range(3):
        loss = step()
        assert loss.dim() == 0 and not loss.requires_grad
        assert torch.equal(loss, ref.step())
    _assert_same(prob, ref)


def test_captured_step_takes_one_device():
    prob = _problem("inverse")
    other = torch.zeros((1,), device="meta")
    with pytest.raises(ValueError, match="one device"):
        capture.CapturedStep(prob.step, [prob.lo, other], prob.opt)


class _Ops(TorchDispatchMode):
    """Counts the aten operations dispatched, by name, apart inside the
    optimiser's ``step`` (``adam``) and outside it (``counts``)."""

    def __init__(self):
        super().__init__()
        self.counts, self.adam = collections.Counter(), collections.Counter()
        self.in_adam = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        (self.adam if self.in_adam else self.counts)[str(func)] += 1
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("demo", ["inverse", "prefilter"])
def test_step_reads_nothing_on_the_host(demo, monkeypatch):
    """One step of each demo dispatches no ``aten._local_scalar_dense``
    (what ``.item()``, ``float()`` and ``bool()`` of a tensor run, a host
    sync on a card) outside the optimiser, through the forward and the
    twin's backward (the gather's ``index_put`` backward counted, so the
    mode saw it); the loss comes back as a 0-d tensor.  Inside it, torch's
    CPU Adam (not capturable) reads its step count, a CPU tensor, once per
    parameter; on a card the example's Adam is capturable and reads none
    (a capture fails on a host read, and a replay dispatches nothing)."""
    prob = _problem(demo)
    prob.step()  # the first step makes Adam's state
    ops = _Ops()
    adam_step = prob.opt.step

    def counted(*args, **kwargs):
        ops.in_adam = True
        try:
            return adam_step(*args, **kwargs)
        finally:
            ops.in_adam = False

    monkeypatch.setattr(prob.opt, "step", counted)
    with ops:
        loss = prob.step()
    scalar = "aten._local_scalar_dense.default"
    assert loss.dim() == 0
    assert ops.counts[scalar] == 0
    assert ops.counts["aten.index_put.default"] > 0 and sum(ops.counts.values()) > 1000
    assert ops.adam[scalar] == len(prob.params)
