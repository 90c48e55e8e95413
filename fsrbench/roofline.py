"""The least time one NVIDIA H100 could take for a configuration's frame.

Peaks from NVIDIA's H100 SXM data sheet (dense, at its 700 W limit):
HBM3 at 3.35 TB/s, 67 TFLOP/s in float32 outside the tensor cores, and
twice that for float16 pairs (``__hfma2``).  The floor per output frame is
the larger of the function's bytes (the source read once, the output
written once) over the HBM rate and its operations (the configuration's
``floor.ops_per_output_pixel``, counted from the algorithm, not from any
kernel's recompute) over the rate of the precision the configuration
states.  It reads the same work whatever kernel implements it.
"""

from __future__ import annotations

__all__ = ["PEAKS", "BYTES_PER_ELEMENT", "frame_bytes", "floor_s_per_frame"]

PEAKS = {
    "hbm_bytes_per_s": 3.35e12,
    "ops_per_s": {"float32": 67e12, "float16": 134e12, "bfloat16": 134e12},
}
BYTES_PER_ELEMENT = {"uint8": 1, "uint16": 2, "float16": 2, "bfloat16": 2, "float32": 4}


def frame_bytes(cfg: dict) -> int:
    """Bytes one frame must move: its source read once, its output written once."""
    (hin, win), (hout, wout), c = cfg["in_size"], cfg["out_size"], cfg["channels"]
    return (hin * win * c * BYTES_PER_ELEMENT[cfg["in_dtype"]]
            + hout * wout * c * BYTES_PER_ELEMENT[cfg["out_dtype"]])


def floor_s_per_frame(cfg: dict) -> tuple:
    """(seconds, "bytes" or "operations"): the floor of one output frame and
    which of the two bounds it."""
    hout, wout = cfg["out_size"]
    floor = cfg["floor"]
    by_bytes = frame_bytes(cfg) / PEAKS["hbm_bytes_per_s"]
    by_ops = floor["ops_per_output_pixel"] * hout * wout / PEAKS["ops_per_s"][floor["precision"]]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")
