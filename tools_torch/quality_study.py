"""Objective quality study: FSR vs bilinear on a downscale->upscale loop.

Counterpart of ``tools/quality_study.py``.  For each test image:
box-downsample by 2x, upscale back with {bilinear, EASU, EASU+RCAS}, report
PSNR against the original.  This mirrors how spatial upscalers are
evaluated (the reference's claims are visual; this adds numbers).  It runs
on the CUDA device (the 2x upscales are K1 launches) unless ``--cpu`` asks
for the plain-torch path; ``--write`` writes the table to
``docs/QUALITY_TORCH.md`` with the card's name and power limit.

    python tools_torch/quality_study.py [--cpu] [--write]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

if __name__ == "__main__":
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import torch

def test_images(hw=(512, 512)):
    h, w = hw
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    imgs = {}
    # Zone-plate-ish radial chirp: the classic aliasing/ringing stressor.
    r2 = ((x - w / 2) ** 2 + (y - h / 2) ** 2) / (w * h)
    zone = 0.5 + 0.5 * np.cos(r2 * 4000.0)
    imgs["zoneplate"] = np.stack([zone, zone, zone])
    # Text-like structure: thin strokes and hard edges.
    strokes = (
        ((x.astype(np.int32) // 7 + y.astype(np.int32) // 13) % 5 == 0)
        | ((np.sin(x / 2.3) * np.cos(y / 3.1)) > 0.85)
    ).astype(np.float32)
    imgs["strokes"] = np.stack([strokes, strokes * 0.8 + 0.1, 1.0 - strokes * 0.7])
    # Natural-ish: smooth shading + oriented edges + mild noise.
    rng = np.random.default_rng(0)
    base = 0.5 + 0.35 * np.sin(x / 37.0 + np.sin(y / 23.0) * 2.0)
    edges = np.clip(np.sign(np.sin((x + 2 * y) / 9.0)) * 0.18 + base, 0, 1)
    nat = np.clip(edges + rng.normal(0, 0.01, (h, w)), 0, 1).astype(np.float32)
    imgs["natural"] = np.stack([nat, np.clip(nat * 0.9 + 0.05, 0, 1), np.clip(nat ** 1.2, 0, 1)])
    return {k: v.astype(np.float32) for k, v in imgs.items()}


def box_down2(img):
    c, h, w = img.shape
    return img.reshape(c, h // 2, 2, w // 2, 2).mean(axis=(2, 4))


def study(device, hw=(512, 512)) -> list:
    """[(image, PSNR of bilinear, EASU, EASU+RCAS)] in dB, the upscales run
    on ``device`` (float32)."""
    import fsr_tpu_torch
    from fsr_tpu_torch.core.constants import EasuConstants
    from fsr_tpu_torch.ops import easu as easu_ops
    from fsr_tpu_torch.utils.image import psnr

    rows = []
    for name, ref_img in test_images(hw).items():
        low_np = box_down2(ref_img)
        low = torch.from_numpy(np.ascontiguousarray(low_np)).to(device)
        out_hw = ref_img.shape[-2:]
        con = EasuConstants.create((low_np.shape[-1], low_np.shape[-2]), None, (out_hw[1], out_hw[0]))
        bil = easu_ops.bilinear(low, out_hw, con).cpu().numpy()
        easu = fsr_tpu_torch.upscale(low, out_size=out_hw, apply_rcas=False).cpu().numpy()
        fsr = fsr_tpu_torch.upscale(low, out_size=out_hw, sharpness=0.25).cpu().numpy()
        rows.append((name, psnr(bil, ref_img), psnr(easu, ref_img), psnr(fsr, ref_img)))
    return rows


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--write", action="store_true", help="write docs/QUALITY_TORCH.md")
    ap.add_argument("--cpu", action="store_true", help="run on the CPU (the plain-torch path), not the card")
    args = ap.parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        print("quality_study: no CUDA device; pass --cpu", file=sys.stderr)
        return 2
    device = torch.device("cpu" if args.cpu else "cuda")
    where = "the CPU (plain-torch path)" if args.cpu else f"{_card()} (K1)"

    rows = study(device)
    for name, b, e, f in rows:
        print(f"{name:10s}: bilinear {b:6.2f} dB | EASU {e:6.2f} dB | EASU+RCAS {f:6.2f} dB")

    if args.write:
        table = ["| image | bilinear | EASU | EASU+RCAS |", "|---|---|---|---|"]
        for name, b, e, f in rows:
            table.append(f"| {name} | {b:.2f} dB | {e:.2f} dB | {f:.2f} dB |")
        body = (
            "# Quality study (fsr_tpu_torch)\n\n"
            "PSNR of a 2x downscale->upscale loop against the original at\n"
            "512x512 (tools_torch/quality_study.py; box downsample,\n"
            f"f32 path), run on {where}.  EASU's edge-adaptive kernel beats\n"
            "bilinear on structured content; RCAS trades a little PSNR for\n"
            "perceived sharpness by design (it amplifies contrast rather than\n"
            "reconstructing signal).\n\n"
            + "\n".join(table) + "\n"
        )
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "docs", "QUALITY_TORCH.md")
        with open(out, "w") as fobj:
            fobj.write(body)
        print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
