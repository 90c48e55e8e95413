"""The float16 frame tail on the H100: each configuration's call against the
bare K6 on the same frames, in a parent commit's tree and in this one.

    python3 tools_torch/ablation/f16_tail_ab.py [--parent DIR] [--rounds N]
    python3 tools_torch/ablation/f16_tail_ab.py --measure [--tree DIR] [--rounds N]

``--measure`` measures one tree (DIR, default this checkout) in this
process and prints one JSON line last.  The configurations, batch 4, float16
math, to 4K (``UpscalePipeline`` or ``upscale`` as a user calls them):

- (a16) HDR tail: float16 1080p frames, ``hdr_srtm``, ``hdr_out``, grain 0.25;
- (b16) display: uint8 1440p frames, grain 0.25, 8-bit TEPD, uint8 out;
- (c16) byte video: uint8 1080p frames, ``upscale(scale=2.0, out_dtype=uint8)``;
- (d16) RGBA display: uint8 RGBA 1440p frames, (b16)'s options;
- (u16) gamma2 + 10-bit TEPD, uint16 out, from float16 1080p frames;
- (vi-b16) (b16) on 4 row strips of ``[cuda:0] * 4`` (``mesh=``);

and beside each, the bare call on the same frames (``upscale(compute_dtype=
float16)``, no option: one K6 launch; on the strips the bare sharded
call).  For each call: the aten operations it dispatches (a
``TorchDispatchMode`` around one call), K6's launches (``easu_h.launches``),
a trace of 5 calls (``utils.profiling.device_trace``: device operations
per call by kernel name, busy ms per call, idle share), and the CUDA-event ms per call
with 10 calls queued and with one, every call taken in turn (``--rounds``
rounds, medians); and a SHA-256 of each output's bytes.

Without ``--measure`` the script builds both trees' kernel libraries in
parallel, then runs ``--measure`` on the parent's tree (DIR, default
``_parent``: a ``git archive`` of the parent commit unpacked at the root of
the checkout) and on this one, in turn: parent, this, this, parent.  It
prints per configuration each tree's median ms per 4K frame (10 queued),
traced busy ms, operations and aten operations, and whether both trees'
outputs are bit-equal, with the card's name and power limit.  Exits
non-zero without a card or parent sources, or when the two trees' outputs
differ.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import pathlib
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
NFRAMES = 4
OUT4K = (2160, 3840)
BUILD = "from fsr_tpu_torch.kernels import _build; _build.library()"
MARK = "F16_TAIL_AB "
TRACED = 5  # calls per trace


def _card() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def _configs(torch, dev):
    """(name, call, bare call) per configuration, on frames made from one
    seed on the card."""
    import fsr_tpu_torch as ft
    from fsr_tpu_torch.parallel import sharding, spatial

    f16, u8, u16 = torch.float16, torch.uint8, torch.uint16
    gen = torch.Generator(device=dev).manual_seed(22)
    p16 = torch.rand((NFRAMES, 3, 1080, 1920), generator=gen, device=dev).half()
    q8 = (torch.rand((NFRAMES, 3, 1440, 2560), generator=gen, device=dev) * 255).to(u8)
    p8 = (torch.rand((NFRAMES, 3, 1080, 1920), generator=gen, device=dev) * 255).to(u8)
    r8 = (torch.rand((NFRAMES, 4, 1440, 2560), generator=gen, device=dev) * 255).to(u8)
    grain = torch.rand((3, *OUT4K), generator=gen, device=dev) - 0.5
    mesh = sharding.make_mesh(4, ("sp",), None, devices=[dev] * 4)
    hdr = ft.UpscalePipeline(OUT4K, hdr_srtm=True, hdr_out=True, grain_amount=0.25, compute_dtype=f16)
    display = dict(grain_amount=0.25, dither_bits=8, out_dtype=u8, compute_dtype=f16)
    disp = ft.UpscalePipeline(OUT4K, **display)
    disp_sp = ft.UpscalePipeline(OUT4K, mesh=mesh, **display)
    u10 = ft.UpscalePipeline(OUT4K, gamma2_out=True, dither_bits=10, out_dtype=u16, compute_dtype=f16)

    def bare(x):
        return lambda: ft.upscale(x, out_size=OUT4K, compute_dtype=f16)

    return [
        ("(a16) HDR tail, f16 1080p", lambda: hdr(p16, grain=grain, frame=3), bare(p16)),
        ("(b16) display, u8 1440p -> u8", lambda: disp(q8, grain=grain, frame=3), bare(q8)),
        ("(c16) byte video, u8 1080p -> u8", lambda: ft.upscale(p8, scale=2.0, out_dtype=u8, compute_dtype=f16),
         bare(p8)),
        ("(d16) RGBA display, u8 1440p -> u8", lambda: disp(r8, grain=grain, frame=3), bare(r8)),
        ("(u16) gamma2 + 10-bit TEPD, f16 1080p -> u16", lambda: u10(p16, frame=3), bare(p16)),
        ("(vi-b16) display, 4 strips", lambda: disp_sp(q8, grain=grain, frame=3),
         lambda: spatial.upscale_spatial_sharded(q8, OUT4K, mesh, compute_dtype=f16)),
    ]


def _digest(out) -> str:
    import torch

    t = out if isinstance(out, torch.Tensor) else out.gather()
    return hashlib.sha256(t.contiguous().cpu().view(-1).view(torch.uint8).numpy().tobytes()).hexdigest()


def measure(rounds: int) -> dict:
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from fsr_tpu_torch.kernels import easu_h
    from fsr_tpu_torch.utils.profiling import cuda_time_ms, device_trace

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    dev = torch.device("cuda:0")
    fns, rows = {}, {}
    for name, call, bare in _configs(torch, dev):
        for key, fn in ((name, call), (name + " | bare K6", bare)):
            out = fn()
            torch.cuda.synchronize()
            Count.n, easu_h.easu_h.launches = 0, 0
            with Count():
                out = fn()
            torch.cuda.synchronize()
            aten, k6 = Count.n, easu_h.easu_h.launches
            # Retaken when CUPTI missed one of the call's K6 launches.
            tr = device_trace(fn, TRACED, short=lambda tr, k6=k6: sum(
                c for k, c in tr["launches"].items() if "easu_h_kernel" in k) < k6)
            kernels = {}
            for k, v in tr["launches"].items():
                kernels[k[:60]] = round(kernels.get(k[:60], 0.0) + v, 4)
            rows[key] = dict(aten_ops=aten, k6_launches=k6, trace_ops=tr["ops_per_call"],
                             trace_busy_ms=tr["busy_ms"] / TRACED, idle_share=tr["idle_share"],
                             trace_kernels=kernels, sha256=_digest(out))
            fns[key] = fn
            del out
    q10 = {k: [] for k in fns}
    one = {k: [] for k in fns}
    for _ in range(rounds):  # in turn, so that every reading sees the same clocks and card state
        for k, fn in fns.items():
            q10[k].append(cuda_time_ms(fn, warmup=1, iters=5, queue=10))
            one[k].append(cuda_time_ms(fn, warmup=1, iters=5))
    for k in fns:
        rows[k]["ms_call_q10"] = statistics.median(q10[k])
        rows[k]["ms_call_one"] = statistics.median(one[k])
    return rows


def _measure_in(tree: pathlib.Path, rounds: int) -> dict:
    res = subprocess.run([sys.executable, str(pathlib.Path(__file__).resolve()), "--measure", "--tree", str(tree),
                          "--rounds", str(rounds)], capture_output=True, text=True, timeout=1200)
    if res.returncode != 0:
        raise RuntimeError(f"--measure in {tree}: exit {res.returncode}\n{res.stdout[-4000:]}{res.stderr[-4000:]}")
    line = next(ln for ln in reversed(res.stdout.splitlines()) if ln.startswith(MARK))
    return json.loads(line[len(MARK):])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--measure", action="store_true", help="measure one tree in this process")
    ap.add_argument("--tree", default=str(ROOT), help="the tree --measure imports (default this checkout)")
    ap.add_argument("--parent", default=str(ROOT / "_parent"),
                    help="root of the parent commit's checkout (default _parent)")
    ap.add_argument("--rounds", type=int, default=3)
    args = ap.parse_args(argv)
    if args.measure:
        sys.path.insert(0, str(pathlib.Path(args.tree).resolve()))
        import torch

        if not torch.cuda.is_available():
            print("f16_tail_ab: no CUDA device", file=sys.stderr)
            return 2
        rows = measure(args.rounds)
        print(f"tree {args.tree} on {_card()}")
        for k, r in rows.items():
            print(f"  {k}: {r['ms_call_q10'] / NFRAMES:.4f} ms/frame (10 queued), {r['ms_call_one'] / NFRAMES:.4f} "
                  f"(one call); traced busy {r['trace_busy_ms'] / NFRAMES:.4f} ms/frame, idle {r['idle_share']:.3f}, "
                  f"{r['trace_ops']:g} device operations, {r['aten_ops']} aten operations, K6 launches "
                  f"{r['k6_launches']}; {r['trace_kernels']}")
        print(MARK + json.dumps(rows))
        return 0
    import torch

    if not torch.cuda.is_available():
        print("f16_tail_ab: no CUDA device", file=sys.stderr)
        return 2
    trees = {"parent": pathlib.Path(args.parent).resolve(), "this": ROOT}
    if not (trees["parent"] / "fsr_tpu_torch" / "csrc").is_dir():
        print(f"f16_tail_ab: no parent sources in {trees['parent']}", file=sys.stderr)
        return 2
    with concurrent.futures.ThreadPoolExecutor(2) as pool:
        for res in pool.map(lambda t: subprocess.run([sys.executable, "-c", BUILD], cwd=t, capture_output=True,
                                                     text=True), trees.values()):
            if res.returncode != 0:
                raise RuntimeError(f"build failed:\n{res.stdout}{res.stderr}")
    runs = {"parent": [], "this": []}
    for which in ("parent", "this", "this", "parent"):
        runs[which].append(_measure_in(trees[which], args.rounds))
    print(f"parent against this tree, in turn (parent, this, this, parent), on {_card()}; ms per 4K frame, "
          f"batch {NFRAMES}, 10 queued, medians of {args.rounds} rounds per run:")
    ok = True
    for k in runs["this"][0]:
        cells = []
        for which in ("parent", "this"):
            rs = [r[k] for r in runs[which]]
            cells.append(f"{which} " + " / ".join(f"{r['ms_call_q10'] / NFRAMES:.4f}" for r in rs)
                         + f" (traced busy {rs[0]['trace_busy_ms'] / NFRAMES:.4f}, idle {rs[0]['idle_share']:.3f}, "
                         f"{rs[0]['trace_ops']:g} device ops, {rs[0]['aten_ops']} aten ops, "
                         f"K6 {rs[0]['k6_launches']})")
        same = len({r[k]["sha256"] for w in runs.values() for r in w}) == 1
        ok &= same
        print(f"  {k}: " + "; ".join(cells) + f"; outputs bit-equal across the trees: {same}")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
