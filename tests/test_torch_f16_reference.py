"""The float16 upscale against the benchmark's plain reference of its
semantics (``fsrbench/reference/fsr1_f16.py``: FsrEasuH with the direction
and length estimate in float32, "mixed", then FsrRcasH), within the limits
of the float16 Performance configuration
(``fsrbench/configs/fsr1-perf2x-4k-u8-f16.json``), on the CPU at tiny sizes.

Observed here: ``upscale(u8, preset="performance", compute_dtype=float16,
out_dtype=uint8)`` is byte-equal to the reference on every case (share 0,
largest difference 0); the port's float32 path (K1's semantics) reads
0.133-0.146 of a frame's bytes off it (largest difference 2-6 codes) and
the reference in bfloat16 (the control) 0.66-0.68 (12-25 codes), so both
exceed the share's limit of 1e-3 by two orders of magnitude.  At this size
neither reaches the 64 codes of ``max_code_off``, which the 4K frames'
readings set (PERF.md section 2)."""

import json
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import fsr_tpu_torch
from fsrbench import check
from fsrbench.reference import fsr1_f16

ROOT = Path(__file__).resolve().parent.parent
CFG = json.loads((ROOT / "fsrbench" / "configs" / "fsr1-perf2x-4k-u8-f16.json").read_text())
# (source size, output size, the call's size argument): the configuration's
# preset at a tiny size, and an odd-sized upscale.
SIZES = [((32, 48), (64, 96), {"preset": CFG["preset"]}), ((27, 41), (50, 77), {"out_size": (50, 77)})]


def _case(seed, in_hw, out_hw):
    src = torch.randint(0, 256, (3, *in_hw), dtype=torch.uint8, generator=torch.Generator().manual_seed(seed))
    return src, dict(CFG, out_size=list(out_hw))


def _program(src, cfg, size, compute_dtype=torch.float16):
    out = fsr_tpu_torch.upscale(src[None], **size, sharpness=cfg["sharpness_stops"], apply_rcas=cfg["apply_rcas"],
                                denoise=cfg["denoise"], compute_dtype=compute_dtype, out_dtype=torch.uint8)
    return out[0]


def _over(reading):
    return [k for k, limit in CFG["check"].items() if reading[k] > limit]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
@pytest.mark.parametrize("in_hw, out_hw, size", SIZES, ids=["performance-2x", "odd"])
def test_the_float16_upscale_lies_within_the_limits(seed, in_hw, out_hw, size):
    src, cfg = _case(seed, in_hw, out_hw)
    got = _program(src, cfg, size)
    assert got.shape == (3, *out_hw) and got.dtype == torch.uint8
    assert _over(check.byte_readings(got, fsr1_f16.expected({"src": src}, cfg))) == []


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 7])
@pytest.mark.parametrize("witness", ["float32 path", "bfloat16 control"])
def test_the_float32_path_and_the_control_exceed_a_limit(seed, witness):
    in_hw, out_hw, size = SIZES[0]
    src, cfg = _case(seed, in_hw, out_hw)
    if witness == "float32 path":
        got = _program(src, cfg, size, torch.float32)
    else:
        got = check.control(cfg)({"src": src})
    assert "worst_frame_off_share" in _over(check.byte_readings(got, fsr1_f16.expected({"src": src}, cfg)))


def test_the_reference_imports_nothing_of_the_program():
    code = (f"import sys, json; sys.path.insert(0, {str(ROOT)!r}); import fsrbench.reference.fsr1_f16; "
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    names = set(json.loads(res.stdout.strip().splitlines()[-1]))
    assert "torch" in names and not names & {"fsr_tpu_torch", "fsr_tpu", "jax", "jaxlib", "flax"}
