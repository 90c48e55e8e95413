"""The comparison that decides ``correct``.

Every kept frame of the timed path is held against the configuration's
plain reference (``reference/<name>.py``: ``expected(inputs, cfg, dtype)``),
which computes the same frame again from the same inputs.  The outputs are
UNORM8 codes, and the program and the reference compute in float32 in
different orders, so a value that lies within a few 1e-6 of a rounding edge
can land one code off.  Two numbers are compared, each on the frame where
it is largest: the share of a frame's bytes that differ from the reference
(``worst_frame_off_share``), which catches a fault spread over a frame, and
the largest difference of one byte (``max_code_off``), which catches a
fault confined to a few pixels, such as a wrong rule at one edge.  Their
limits are the configuration's (``check``), set from the program's and the
control's readings.
"""

from __future__ import annotations

import importlib
from typing import Iterable, Tuple

import torch

__all__ = ["reference_of", "readings", "control"]


def reference_of(cfg: dict):
    return importlib.import_module(f"fsrbench.reference.{cfg['reference']}")


def byte_readings(got: torch.Tensor, want: torch.Tensor) -> dict:
    """One frame of UNORM codes: the share of its bytes off the reference,
    and the largest difference of one byte."""
    diff = (got.to(torch.int16) - want.to(torch.int16)).abs_()
    return {"worst_frame_off_share": float((diff != 0).sum()) / diff.numel(), "max_code_off": int(diff.max())}


def readings(pairs: Iterable[Tuple[torch.Tensor, dict]], cfg: dict, device, candidate=None) -> dict:
    """Each (output, inputs) frame against the reference on ``device``: the
    number of ``frames``, those of the wrong shape or type, and the largest
    of each frame reading over them.  ``candidate(inputs)``, where given,
    stands in for the program's output (the control)."""
    ref = reference_of(cfg)
    want_shape = (cfg["channels"], *cfg["out_size"])
    want_dtype = getattr(torch, cfg["out_dtype"])
    out = {"frames": 0, "frames_wrong_shape": 0}
    with torch.no_grad():
        for got, inputs in pairs:
            inputs = {k: v.to(device) for k, v in inputs.items()}
            got = candidate(inputs) if candidate is not None else got.to(device)
            out["frames"] += 1
            if tuple(got.shape) != want_shape or got.dtype != want_dtype:
                out["frames_wrong_shape"] += 1
                continue
            for k, v in byte_readings(got, ref.expected(inputs, cfg)).items():
                out[k] = max(out.get(k, v), v)
    return out


def control(cfg: dict, dtype=torch.bfloat16):
    """The control's output for a frame's inputs: the reference computed in
    ``dtype``, put in the program's place."""
    ref = reference_of(cfg)
    return lambda inputs: ref.expected(inputs, cfg, dtype)
