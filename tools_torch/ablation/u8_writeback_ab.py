"""The byte-output routes of K1 on the H100, timed in turn.

    python3 tools_torch/ablation/u8_writeback_ab.py

Counterpart of ``tools/ablation/u8_writeback_ab.py``.  From uint8 1080p
frames (uniform codes from seed 7), 2x to 4K with RCAS at sharpness 0.25,
the routes that end in display bytes or codes:

  direct_u8        K1 stores uint8 codes (the production byte path)
  u16_codes        K1 stores 10-bit codes in uint16 (``out_dtype=torch.uint16``)
  u16_codes+narrow the same, then one narrowing pass in torch to 8-bit
                   codes with the JAX tool's formula (c*255*2 + 1023) // 2046
                   in int32 (not the UNORM round of the float: this route
                   measures the store, not the codes)
  bf16_out         K1 stores bfloat16 (no encode)
  bf16_out+encode  the same, then ``kernels/epilogue.encode_unorm8`` in torch
  direct_u8 b2     direct_u8 on a batch of 2, per frame

each timed in turn (``cuda_times_in_turn``, 10 calls queued per sample:
device time per frame), beside its byte floor: the bytes each of its passes
must read and write once, over 3.35 TB/s.  Then the fidelity line: the
largest code difference of bf16_out+encode from direct_u8 (the encode of a
bfloat16-rounded value may land one code off the float32 value's).  Exits
non-zero without a card.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", ".."))

import numpy as np
import torch

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import fused
from fsr_tpu_torch.kernels.epilogue import encode_unorm8

IN_HW, OUT_HW = (1080, 1920), (2160, 3840)
HBM_BYTES_PER_S = 3.35e12


def narrow(codes: torch.Tensor) -> torch.Tensor:
    """10-bit codes to 8-bit codes, the JAX tool's formula in int32."""
    return ((codes.to(torch.int32) * 255 * 2 + 1023) // 2046).to(torch.uint8)


def routes(x8: torch.Tensor) -> dict:
    """{route: (call, frames per call, byte floor in bytes per frame)} from
    the uint8 frame ``x8`` (3, H, W)."""
    con = EasuConstants.create(IN_HW[::-1], None, OUT_HW[::-1])
    rcon = RcasConstants(0.25)
    src = x8.numel()
    out = 3 * OUT_HW[0] * OUT_HW[1]  # output elements per frame

    def k1(img, **kw):
        return fused.upscale_fused(img, OUT_HW, con, rcon, **kw)

    x8b = torch.stack([x8, x8])
    u8, u16, bf16 = torch.uint8, torch.uint16, torch.bfloat16
    return {
        "direct_u8": (lambda: k1(x8, out_dtype=u8), 1, src + out),
        "u16_codes": (lambda: k1(x8, out_dtype=u16), 1, src + 2 * out),
        "u16_codes+narrow": (lambda: narrow(k1(x8, out_dtype=u16)), 1, src + 2 * out + 2 * out + out),
        "bf16_out": (lambda: k1(x8, compute_dtype=bf16), 1, src + 2 * out),
        "bf16_out+encode": (lambda: encode_unorm8(k1(x8, compute_dtype=bf16).float()), 1,
                            src + 2 * out + 2 * out + out),
        "direct_u8 b2": (lambda: k1(x8b, out_dtype=u8), 2, src + out),
    }


def source(dev) -> torch.Tensor:
    """The JAX tool's uint8 frame."""
    return torch.from_numpy((np.random.default_rng(7).random((3, *IN_HW)) * 255).astype(np.uint8)).to(dev)


def measure(dev) -> tuple:
    """({route: (device ms per frame, byte floor ms per frame)}, the largest
    code difference of bf16_out+encode from direct_u8)."""
    from fsr_tpu_torch.utils.profiling import cuda_times_in_turn

    r = routes(source(dev))
    t = cuda_times_in_turn({k: call for k, (call, _, _) in r.items()}, 5, queue=10)
    got, want = r["bf16_out+encode"][0](), r["direct_u8"][0]()
    dev_codes = int((got.to(torch.int32) - want.to(torch.int32)).abs().max().item())
    return {k: (t[k] / n, nbytes / HBM_BYTES_PER_S * 1e3) for k, (_, n, nbytes) in r.items()}, dev_codes


def main() -> int:
    if not torch.cuda.is_available():
        print("u8_writeback_ab: no CUDA device; the readings are device times", file=sys.stderr)
        return 1
    from tools_torch.ablation import kernel_ab

    times, dev_codes = measure(torch.device("cuda:0"))
    print("ms per 4K frame, in turn, 5 rounds, 10 calls queued per sample (byte floor):")
    for k, (ms, floor) in times.items():
        print(f"{k:<17}: {ms:.4f} ms  (floor {floor:.4f})", flush=True)
    print(f"bf16+encode vs direct_u8 max code dev: {dev_codes}")
    print(kernel_ab.card())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
