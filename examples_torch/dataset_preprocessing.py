"""Sharded dataset preprocessing with FSR upscaling.

Counterpart of ``examples/dataset_preprocessing.py``.  Batched upscale of
an image corpus across the cards of a mesh inside an input pipeline:
frames stream in as host-side uint8 batches, get batch-sharded over the
mesh (``fsr_tpu_torch.parallel.sharding``), upscaled (EASU+RCAS), dithered
to 8-bit codes (TEPD, in K1's store) and gathered back on the host for
the downstream consumer (e.g. training-data augmentation at higher
resolution).  One K1 launch per card per batch.

The mesh is every visible CUDA device (``make_mesh()``, which raises with
none); there is no CPU fallback.  ``devices=`` (e.g. ``[cpu] * 2``) runs
the same code on other devices.

    python examples_torch/dataset_preprocessing.py
"""

from __future__ import annotations

import argparse
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


def preprocess(frames: torch.Tensor, frame_idx: int, out_hw, mesh) -> torch.Tensor:
    """uint8 in -> dithered uint8 display codes out, on the frames' device:
    each card decodes, runs EASU+RCAS, TEPD and the D3D UNORM encode in one
    K1 launch on its share of the batch."""
    from fsr_tpu_torch.kernels.epilogue import Epilogue
    from fsr_tpu_torch.parallel import sharding

    return sharding.upscale_batch_sharded(
        frames, mesh, out_size=out_hw, sharpness=0.25, impl="auto",
        epilogue=Epilogue(dither_bits=8), frame=frame_idx, out_dtype=torch.uint8,
    )


def run(n_batches: int, per_device: int, in_hw, out_hw, devices=None):
    """Preprocess ``n_batches`` of ``per_device`` frames per mesh device;
    returns (the host outputs, seconds, devices in the mesh)."""
    from fsr_tpu_torch.parallel import sharding

    mesh = sharding.make_mesh(axis_names=("batch",), devices=devices)
    batch = per_device * mesh.size
    outs = []
    t0 = time.perf_counter()
    for i, host_batch in enumerate(synthetic_corpus(n_batches, batch, in_hw)):
        out = preprocess(torch.from_numpy(host_batch), i, out_hw, mesh)  # gathered on the host
        assert out.shape == (batch, 3, *out_hw) and out.dtype == torch.uint8
        outs.append(out)
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
