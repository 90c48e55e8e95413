"""Sharded dataset preprocessing with FSR upscaling.

Counterpart of ``examples/dataset_preprocessing.py``.  Batched upscale of
an image corpus across the cards of a mesh inside an input pipeline:
frames stream in as host-side uint8 batches, get put batch-sharded over the
mesh straight into the captured graphs' static inputs
(``CapturedBatch.put``: one host-to-device copy per card, the JAX example's
``device_put``), upscaled (EASU+RCAS) and dithered to 8-bit codes (TEPD,
in K1's store), and stay sharded on the cards for the downstream consumer
(e.g. training-data augmentation at higher resolution), as the JAX
example's outputs do.  One K1 launch per card per batch.  ``run`` replays
one captured graph per mesh device (``CapturedPreprocess``), as the JAX
example jits ``preprocess``; on CPU devices the same calls run eagerly.
``preprocess`` is the eager reference the replays are held against.

The mesh is every visible CUDA device (``make_mesh()``, which raises with
none); there is no CPU fallback.  ``devices=`` (e.g. ``[cpu] * 2``) runs
the same code on other devices.

    python examples_torch/dataset_preprocessing.py
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch


def synthetic_corpus(n_batches: int, batch: int, hw, seed: int = 0):
    """Stand-in for a real loader (a DataLoader / webdataset).

    Yields uint8 — the natural output of an image decoder.  The kernels
    decode v/255 on the card, so the host->device transfer and the
    device-side buffers stay bytes (4x less traffic than shipping floats).
    """
    rng = np.random.default_rng(seed)
    for _ in range(n_batches):
        yield (rng.random((batch, 3, *hw)) * 255).astype(np.uint8)


def _upscale_kwargs(out_hw) -> dict:
    """The upscale each card runs: decode, EASU+RCAS, TEPD and the D3D
    UNORM encode, one K1 launch."""
    from fsr_tpu_torch.kernels.epilogue import Epilogue

    return dict(out_size=out_hw, sharpness=0.25, impl="auto", epilogue=Epilogue(dither_bits=8),
                out_dtype=torch.uint8)


def preprocess(frames, frame_idx, out_hw, mesh):
    """uint8 in -> dithered uint8 display codes out, a ``Sharded`` over the
    mesh: each card decodes, runs EASU+RCAS, TEPD and the D3D UNORM encode
    in one K1 launch on its share of the batch (eagerly)."""
    from fsr_tpu_torch.parallel import sharding

    return sharding.upscale_batch_sharded(frames, mesh, frame=frame_idx, **_upscale_kwargs(out_hw))


class CapturedPreprocess:
    """``preprocess`` as one captured CUDA graph per mesh device
    (``sharding.CapturedBatch``, the counterpart of ``jax.jit(preprocess)``;
    on a CPU device the same call, eagerly): device k's graph upscales its
    share of a (per_device * devices, 3, H, W) uint8 batch, with the frame
    index as a 0-d int32 device input.  ``batch.put(frames)`` copies a
    host batch straight into the graphs' static inputs (``batch.inputs``,
    a ``Sharded``), the one copy per share; a call from ``batch.inputs``
    copies no share, a call from another tensor or ``Sharded`` copies each
    share into them first.  A call writes the index (outside the graph),
    replays the graphs and returns their static outputs as a ``Sharded``,
    with no gather: the next call overwrites them."""

    def __init__(self, mesh, per_device: int, in_hw, out_hw):
        from fsr_tpu_torch.parallel import sharding

        example = torch.zeros((per_device * mesh.shape["batch"], 3, *in_hw), dtype=torch.uint8)
        self.batch = sharding.CapturedBatch(example, mesh, **_upscale_kwargs(out_hw))

    def __call__(self, frames, frame_idx: int):
        return self.batch(frames, frame_idx)


def run(n_batches: int, per_device: int, in_hw, out_hw, devices=None):
    """Preprocess ``n_batches`` of ``per_device`` frames per mesh device;
    returns (the outputs, seconds, devices in the mesh).  Each host batch is
    put sharded over the mesh into the graphs' static inputs
    (``CapturedBatch.put``, one copy per share) and the graphs, captured
    before the clock starts, are replayed on them (``CapturedPreprocess``;
    eager calls on CPU devices); each batch waits for its cards, as the JAX example's
    ``block_until_ready``.  The outputs stay on the cards: each batch's
    ``Sharded``, its shards copied on their own cards since the next replay
    overwrites the graphs' outputs."""
    from fsr_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(axis_names=("batch",), devices=devices)
    batch = per_device * mesh.size
    step = CapturedPreprocess(mesh, per_device, in_hw, out_hw)
    outs = []
    t0 = time.perf_counter()
    for i, host_batch in enumerate(synthetic_corpus(n_batches, batch, in_hw)):
        out = step(step.batch.put(torch.from_numpy(host_batch)), i)
        assert out.shape == (batch, 3, *out_hw) and out.dtype == torch.uint8
        outs.append(dataclasses.replace(out, shards=tuple(s.clone() for s in out.shards)))
        for dev in {s.device for s in out.shards if s.device.type == "cuda"}:
            torch.cuda.synchronize(dev)
    return outs, time.perf_counter() - t0, mesh.size


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("dataset_preprocessing: no CUDA device", file=sys.stderr)
        return 2
    in_hw, out_hw = (64, 128), (128, 256)
    outs, dt, n_dev = run(4, 4, in_hw, out_hw)
    total = sum(o.shape[0] for o in outs)
    print(
        f"preprocessed {total} frames {in_hw}->{out_hw} on {n_dev} devices "
        f"in {dt:.2f}s ({total / dt:.1f} frames/s incl. host transfer)"
    )
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
