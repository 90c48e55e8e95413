"""The probes P1-P4 (``fsr_tpu_torch/kernels/probes.py``) and their tools
(``tools_torch/ablation``) on the CPU, where the wrappers run their plain
versions, against the JAX package.

- P1/P2 (the op-mix replays): their plain version is K1's on the one-tile
  frame, held to the JAX XLA path as tests/test_torch_kernels.py holds K1's
  (float32 within 6e-5, the JAX package's fused-vs-XLA bound).
- P3 (FMA chains): the plain recurrence against the JAX probe's kernel body
  (tools/ablation/fused_roofline.py:124-131) in jnp on the same block;
  float32 within 1e-5 relative (64 steps, each rounded on either side);
  float16 bit-equal to numpy's FMA per step (float64 product and sum, one
  rounding to float16) and within 2**-5 relative of the jnp float16 body
  (XLA on the CPU keeps float32 between the steps, the plain version rounds
  each of the 64 steps to float16: half a step each).
- P4 (float16): modes 0 and 2 bit-equal to numpy's float16 arithmetic;
  mode 1 within one float16 step per FMA (numpy rounds the product and the
  sum apart, the plain version once).
- The op counts of both conventions, pinned, beside the JAX tool's.
- The op-mix tool's SASS parser and its P2 <= P1 <= K1 check.

One torch thread (a module fixture), as tests/test_torch_parallel.py.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.ops import easu as jeasu
from fsr_tpu.ops import rcas as jrcas

from fsr_tpu_torch.kernels import probes
from tools_torch.ablation import fp16_probe, fused_roofline, opmix_floor

ROOT = Path(__file__).resolve().parents[1]
F32_TOL = 6e-5
P3_F32_REL = 1e-5
P3_F16_REL = 2.0 ** -5


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _by_path(name, rel):
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_tile(img, apply_rcas):
    hin, win = img.shape[-2:]
    hout, wout = probes.TILE
    out = jeasu.easu(jnp.asarray(img), (hout, wout), JEasu.create((win, hin), None, (wout, hout)))
    if apply_rcas:
        out = jrcas.rcas(out, JRcas(0.25))
    return np.asarray(out)


REPLAYS = [
    ("P1", lambda op, fp, rcas: probes.opmix_replay(op, fp, opmix_floor.SHARP, rcas), True),
    ("P1 EASU only", lambda op, fp, rcas: probes.opmix_replay(op, fp, opmix_floor.SHARP, rcas), False),
    ("P2", lambda op, fp, rcas: probes.opmix_replay_shared(op, fp, opmix_floor.SHARP), True),
]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("replay", REPLAYS, ids=lambda r: r[0])
def test_replay_plain_version_matches_jax(replay, seed):
    _, fn, rcas = replay
    img = opmix_floor.tiny_frame("cpu", seed)
    padded, fplan = opmix_floor.operand(img)
    got = fn(padded, fplan, rcas)
    assert got.shape == (3, *probes.TILE) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), _jax_tile(img.numpy(), rcas), atol=F32_TOL, rtol=0)


def test_replay_tool_path_and_window():
    img = opmix_floor.tiny_frame("cpu")
    padded, fplan = opmix_floor.operand(img)
    # One K1 tile at 2x: an 8 x 16 source padded by 3 on each side.
    assert padded.shape == (3, 14, 22) and (fplan.qy, fplan.qx) == (2, 2)
    # P2's window: the taps of the tile and its clamped ring reach rows
    # 1..12 and columns 1..20 of the padded operand.
    assert probes.window(fplan) == (1, 1, 12, 20)
    for shared, rcas in ((False, True), (False, False), (True, True)):
        want = probes.opmix_replay(padded, fplan, opmix_floor.SHARP, rcas)
        torch.testing.assert_close(opmix_floor.replay(img, shared, rcas), want, rtol=0, atol=0)
    assert probes.opmix_replay.launches == probes.opmix_replay_shared.launches == 0


def _jax_fma_body(x, chains, dtype):
    # tools/ablation/fused_roofline.py:124-131, in jnp on the same block.
    a = jnp.asarray(x).astype(dtype)
    accs = [a * dtype(1.0 + 1e-7 * i) for i in range(chains)]
    for _ in range(probes.CHAIN - 1):
        accs = [acc * dtype(1.0000001) + a for acc in accs]
    out = accs[0]
    for acc in accs[1:]:
        out = out + acc
    return np.asarray(out.astype(jnp.float32))


def _numpy_fma_f16(x, chains):
    # One rounding per FMA: float64 holds the float16 product and sum exactly.
    def fma(b, c, d):
        return (b.astype(np.float64) * np.float64(c) + d.astype(np.float64)).astype(np.float16)

    a = x.astype(np.float16)
    zero = np.zeros_like(a)
    accs = [fma(a, np.float16(s), zero) for s in probes.FMA_SCALES[:chains]]
    for _ in range(probes.CHAIN - 1):
        accs = [fma(acc, np.float16(probes.FMA_MULTIPLIER), a) for acc in accs]
    out = accs[0]
    for acc in accs[1:]:
        out = fma(out, 1.0, acc)
    return out


@pytest.mark.parametrize("chains", [4, 8])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_fma_plain_recurrence_matches_jax_body(dtype, chains):
    x = fused_roofline.fma_input("cpu").numpy()[:8]
    got = probes.fma_rate(torch.from_numpy(x), getattr(torch, dtype), chains)
    assert got.dtype == getattr(torch, dtype) and got.shape == x.shape
    want = _jax_fma_body(x, chains, getattr(jnp, dtype))
    rel = P3_F32_REL if dtype == "float32" else P3_F16_REL
    np.testing.assert_allclose(got.float().numpy(), want, rtol=rel, atol=0)
    if dtype == "float16":
        np.testing.assert_array_equal(got.numpy(), _numpy_fma_f16(x, chains))
    # Each chain grows to about 64 a.
    np.testing.assert_allclose(got.float().numpy(), chains * 64 * x, rtol=P3_F16_REL)


def _numpy_fp16(x, mode):
    if mode == 0:
        return x.astype(np.float32) * np.float32(2.0)
    if mode == 1:
        acc = x
        for _ in range(8):
            acc = acc * x + np.float16(0.125)
        return acc.astype(np.float32)
    return (x.astype(np.float32) * np.float32(0.5)).astype(np.float16)


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_fp16_probe_plain_version_matches_numpy(mode):
    x = fp16_probe.probe_input("cpu")
    got = probes.fp16_probe(x, mode)
    want = torch.from_numpy(_numpy_fp16(x.numpy(), mode))
    assert got.dtype == (torch.float16 if mode == 2 else torch.float32)
    a = fp16_probe.agreement(mode, got, want)
    assert a["ok"], a
    if mode == 1:
        # numpy rounds acc * x and the sum apart, so it parts from the
        # FMA-like plain version at some values, by at most one step each.
        assert 0 < a["off"] and a["max_abs"] <= 2.0 ** -9
    assert probes.fp16_probe.launches == 0


def test_op_counts_pinned_beside_jax():
    ours = fused_roofline.ops_per_pixel()
    jax_tool = _by_path("jax_fused_roofline", "tools/ablation/fused_roofline.py").ops_per_pixel()
    print("\nops per pixel, JAX tool:", jax_tool)
    for conv, c in ours.items():
        print(f"ops per pixel, port, {conv}:", c)
    for name, c in fused_roofline.op_counts().items():
        print(f"  {name}: " + ", ".join(f"{k} {v}" for k, v in sorted(c.calls.items())))
    assert jax_tool == fused_roofline.JAX_COUNTS
    assert ours["convention 1"] == {"easu_resolve": 320, "rcas_resolve": 96, "texel_response": 23, "luma": 4,
                                    "per_px": 422.25}
    assert ours["convention 2"] == {"easu_resolve": 386, "rcas_resolve": 96, "texel_response": 23, "luma": 4,
                                    "per_px": 488.75}


def test_op_count_classes():
    # A bit trick costs what it costs in CUDA: the magic subtract (rcp) or
    # the shift and subtract (rsq); torch's emulation of the unsigned wrap
    # (widening and narrowing copies, masks, compare, subtract, select)
    # counts nothing.  The 3-channel ops count 3 in convention 2.
    counts = fused_roofline.op_counts()
    texel = counts["texel_response"]
    assert texel.calls["rsub"] == 2
    assert not {"_to_copy", "bitwise_and", "ge", "where"} & set(texel.calls)
    easu = counts["easu_resolve"]
    assert easu.calls["rsub"] == 3 and easu.calls["__rshift__"] == 1
    assert easu.calls["reciprocal"] == 4 and easu.elems["mul"] > easu.calls["mul"]
    assert counts["rcas_resolve"].calls["rsub"] == 1


@pytest.mark.parametrize("trick, cost", [("prx_lo_rcp", 1), ("prx_lo_rsq", 2), ("prx_lo_sqrt", 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_bit_trick_costs_its_integer_ops(trick, cost, dtype):
    from fsr_tpu_torch.core import approx

    x = torch.full((1, 1), 0.5, dtype=dtype)
    c = fused_roofline.count(lambda: getattr(approx, trick)(x))
    assert sum(c.calls.values()) == sum(c.elems.values()) == cost


def test_stream_ops():
    c = fused_roofline.ops_per_pixel()["convention 2"]
    assert opmix_floor.RING == 612 / 512
    assert opmix_floor.stream_ops("replay easu_only") == c["easu_resolve"] + 4 * c["texel_response"] + 12 * c["luma"]
    assert opmix_floor.stream_ops("replay") > opmix_floor.stream_ops("shared") > c["per_px"]
    assert opmix_floor.headline_pixels() == 4 * 2160 * 3840


SASS_LISTING = """\
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_113replay_kernelILb1EEEvPKfPfNS_6ParamsEf
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x00000a00ff017b82 */
                                                                          /* 0x000fe40000000800 */
        /*0010*/              @!P0 FFMA.FTZ R3, R2, R5, R4 ;
        /*0020*/                   LDS.128 R4, [R2] ;
\t\tFunction : _ZN12_GLOBAL__N_112fused_kernelIffLb1ELb0ELb0EEEvPKT_PT0_NS_6ParamsE
        /*0000*/                   LDG.E.CONSTANT R1, desc[UR4][R2.64] ;
        /*0010*/               @P1 FFMA R1, R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_112fused_kernelIffLb1ELb0ELb1EEEvPKT_PT0_NS_6ParamsE
        /*0000*/                   FFMA R1, R2, R3, R4 ;
"""


def test_parse_sass_counts_the_named_kernels():
    counts = opmix_floor.parse_sass(SASS_LISTING.splitlines(True))
    # K1's RGBA instantiation and the encoding lines are not counted.
    assert counts == {"P1": {"LDC": 1, "FFMA": 1, "LDS": 1}, "K1 f32": {"LDG": 1, "FFMA": 1}}
    lines = opmix_floor.sass_lines(counts)
    assert len(lines) == 3 and lines[1].startswith("P1") and lines[2].split()[-1] == "2"


@pytest.mark.parametrize("p1, verdict", [(0.9, "holds"), (1.2, "FAILS"), (0.4, "FAILS")])
def test_report_checks_the_replays_order(p1, verdict):
    # P2 0.5, K1 1.0 per call: P1 must lie between them.
    ms = {"P2": 0.5, "P1": p1, "P1 EASU only": 0.3, "K1 f32": 1.0, "K1 bf16": 1.0}
    lines = opmix_floor.report(ms)
    checks = [line.split(":")[-1].strip() for line in lines if "P2 <= P1 <= K1" in line]
    assert checks == [verdict, verdict]


def test_chip_smoke_op_constants_are_convention_2():
    chip_smoke = _by_path("chip_smoke", "chip_smoke.py")
    easu, rcas = fused_roofline.easu_rcas_ops()
    assert (chip_smoke.EASU_OPS, chip_smoke.RCAS_OPS) == (easu, rcas)
    assert chip_smoke.EASU_RCAS_OPS == fused_roofline.ops_per_pixel()["convention 2"]["per_px"]


def test_chip_smoke_k6_op_constants_are_counted_by_type():
    """K6's bound: its function's operations (the float16 torch path, its
    non-fast forms) by type, the halves' at the half rate; more operations
    than the fast float32 count, but a shorter floor."""
    chip_smoke = _by_path("chip_smoke", "chip_smoke.py")
    h = fused_roofline.easu_rcas_h_ops()
    assert (chip_smoke.EASU_H_OPS, chip_smoke.RCAS_H_OPS) == tuple(zip(h["float32"], h["float16"]))
    f32, half = (sum(v) for v in zip(chip_smoke.EASU_H_OPS, chip_smoke.RCAS_H_OPS))
    assert f32 + half > chip_smoke.EASU_RCAS_OPS
    assert chip_smoke._bound(0, f32, half_ops=half)[0] < chip_smoke._bound(0, chip_smoke.EASU_RCAS_OPS)[0]


def _bad_calls():
    img = opmix_floor.tiny_frame("cpu")
    padded, fplan = opmix_floor.operand(img)
    x = fused_roofline.fma_input("cpu")
    h = fp16_probe.probe_input("cpu")
    sharp = opmix_floor.SHARP
    return {
        "P1": (lambda t: probes.opmix_replay(t, fplan, sharp), padded),
        "P2": (lambda t: probes.opmix_replay_shared(t, fplan, sharp), padded),
        "P3": (lambda t: probes.fma_rate(t, torch.float32, 4), x),
        "P4": (lambda t: probes.fp16_probe(t, 0), h),
    }


@pytest.mark.parametrize("fault", ["meta device", "dtype", "non-contiguous"])
@pytest.mark.parametrize("kernel", ["P1", "P2", "P3", "P4"])
def test_wrappers_raise(kernel, fault):
    fn, t = _bad_calls()[kernel]
    if fault == "meta device":
        bad, err = torch.empty_like(t, device="meta"), ValueError
    elif fault == "dtype":
        bad, err = t.to(torch.bfloat16), TypeError
    else:
        bad, err = t.transpose(-1, -2).contiguous().transpose(-1, -2), ValueError
        assert not bad.is_contiguous()
    with pytest.raises(err):
        fn(bad)


def test_wrappers_raise_on_bad_arguments():
    img = opmix_floor.tiny_frame("cpu")
    padded, fplan = opmix_floor.operand(img)
    with pytest.raises(ValueError, match="grid"):
        probes.opmix_replay(padded, fplan, 1.0, grid=(1, 70000, 1))
    with pytest.raises(ValueError, match="reach"):
        probes.opmix_replay(padded[:, :8].contiguous(), fplan, 1.0)
    x = fused_roofline.fma_input("cpu")
    with pytest.raises(ValueError, match="chains"):
        probes.fma_rate(x, torch.float32, 6)
    with pytest.raises(TypeError):
        probes.fma_rate(x, torch.bfloat16)
    with pytest.raises(ValueError, match="even"):
        probes.fma_rate(x[:1, :3].contiguous(), torch.float16)
    with pytest.raises(ValueError, match="mode"):
        probes.fp16_probe(fp16_probe.probe_input("cpu"), 3)


def test_port_and_tools_leave_jax_out():
    code = (
        "import pkgutil, importlib, sys, fsr_tpu_torch, tools_torch, examples_torch\n"
        "for pkg in (fsr_tpu_torch, tools_torch, examples_torch):\n"
        "    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "        importlib.import_module(m.name)\n"
        "assert 'fsr_tpu_torch.autodiff' in sys.modules\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'fsr_tpu' "
        "or m.startswith('fsr_tpu.')]\n"
        "print(len([m for m in sys.modules if m.startswith('tools_torch.')]),\n"
        "      len([m for m in sys.modules if m.startswith('examples_torch.')]), bad)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, check=True)
    # tools_torch.ablation and its ten tools (kernel_ab, headline_probe,
    # fused_stage_ablation, gather_ablation, u8_writeback_ab, train_ab and
    # f16_tail_ab among them), tools_torch.quality_study and
    # tools_torch.preset_bench; examples_torch's train_through_fsr,
    # video_upscale, dataset_preprocessing, frame_graph and sample_app.
    assert res.stdout.split(None, 2) == ["13", "5", "[]\n"]
