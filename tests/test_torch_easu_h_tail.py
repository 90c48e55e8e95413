"""K6's frame tail (``fsr_tpu_torch.kernels.easu_h``: the SRTM prologue,
the K5 epilogue and the uint8 / 10-bit UNORM stores inside the launch) on
the CPU, where the wrapper runs its plain version, against the port's
torch path and the JAX package.

The plain version (``easu_h_reference``) is the torch path's float16 chain,
so with every option it is bit-equal to ``upscale(impl="torch",
compute_dtype=float16)``, whole frames and row strips (on the card the
kernel is held to the same bits, ``chip_smoke.py`` phases 17 and 18).  The
dispatch hands one ``easu_h`` call every option and a row strip's
``StripSource`` as it stands, and returns that call's result.

Against ``fsr_tpu.upscale(impl="xla", compute_dtype=float16)`` and
``fsr_tpu.UpscalePipeline(compute_dtype=float16)`` with the same options:
float outputs by ``tests/test_torch_easu_h.py``'s limits (median <= 1e-3,
at most 1% of the values over 1/255; an HDR output after the forward
tonemap).  Codes: the JAX path rounds its float16 chain at other places
(XLA on the CPU keeps float32 inside a fusion), so a code moves wherever
the two half values straddle a code boundary: at most ``CODE_SHARE`` of the
codes differ, and at most ``STEP_SHARE`` of the values (code / max code)
differ by more than one 8-bit step (1/255; a 10-bit code follows its half
value by up to five codes there, a byte by at most one, rarely two).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.kernels.epilogue import Epilogue as JEpilogue
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import dispatch as tdispatch
from fsr_tpu_torch.kernels import easu_h as teasu_h
from fsr_tpu_torch.kernels import epilogue as tepilogue
from fsr_tpu_torch.kernels import halo as thalo
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.ops import extras as tx
from fsr_tpu_torch.parallel import sharding, spatial
from fsr_tpu_torch.utils import profiling

F16, U8, U16 = torch.float16, torch.uint8, torch.uint16
CPU = torch.device("cpu")
PERF = ((27, 48), (54, 96))
QUALITY = ((36, 64), (54, 96))
# tests/test_torch_easu_h.py's limits against fsr_tpu in float16.
MEDIAN, BUDGET, SHARE = 1e-3, 1.0 / 255.0, 0.01
# Codes against fsr_tpu (module note): measured up to 0.46 (10-bit) and
# 0.14 (8-bit) of the codes differ, at most 2e-4 of the values by more
# than one 8-bit step.
CODE_SHARE, STEP_SHARE = 0.5, 1e-3
KINDS = ("float16", "float32", "bfloat16", "uint8")

# The tails of the float16 configurations: (a16) the HDR tail, (b16) the
# display path (RGBA: (d16)), (c16) bytes out, (u16) gamma2 and 10-bit TEPD
# to UNORM10; and the prologue with a dither page into a float16 output.
TAILS = {
    "hdr": (dict(prologue="srtm"), dict(transform="srtm_inv", grain_amount=0.25), None),
    "display": ({}, dict(grain_amount=0.25, dither_bits=8), "uint8"),
    "bytes": ({}, None, "uint8"),
    "u10": ({}, dict(transform="gamma2", dither_bits=10), "uint16"),
    "page": (dict(prologue="srtm"), dict(grain_amount=0.25, dither_bits=8, dither_texture=True), None),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Many small float16 ops per case: one torch thread for this module, so
    that pytest's workers do not oversubscribe the cores; restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _img(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _source(kind, shape, seed=50):
    x = _img(seed, shape)
    return (x * 255).astype(np.uint8) if kind == "uint8" else x


def _torch(x, kind):
    t = torch.from_numpy(x)
    return t if kind in ("uint8", "float32") else t.to(getattr(torch, kind))


def _jax(x, kind):
    return jnp.asarray(x) if kind in ("uint8", "float32") else jnp.asarray(x).astype(getattr(jnp, kind))


def _operands(out_hw, seed=51):
    rng = np.random.default_rng(seed)
    return rng.uniform(-0.5, 0.5, (3, *out_hw)).astype(np.float32), rng.uniform(0, 1, (8, 16)).astype(np.float32)


def _tail(name, out_hw, frame=5, seed=51):
    """The port's keyword arguments of tail ``name`` for an ``out_hw`` output."""
    kw, epi, od = TAILS[name]
    grain, page = _operands(out_hw, seed)
    kw = dict(kw, frame=frame, grain=torch.from_numpy(grain), dither_page=torch.from_numpy(page))
    if epi is not None:
        kw["epilogue"] = Epilogue(**epi)
    if od is not None:
        kw["out_dtype"] = getattr(torch, od)
    return kw


def _jax_tail(name, out_hw, frame=5, seed=51):
    kw, epi, od = TAILS[name]
    grain, page = _operands(out_hw, seed)
    kw = dict(kw, frame=frame, grain=jnp.asarray(grain), dither_page=jnp.asarray(page))
    if epi is not None:
        kw["epilogue"] = JEpilogue(**epi)
    if od is not None:
        kw["out_dtype"] = getattr(jnp, od)
    return kw


def _con(in_hw, out_hw, viewport=None, offset=(0, 0)):
    vp = viewport or in_hw
    return EasuConstants.create((vp[1], vp[0]), (in_hw[1], in_hw[0]), (out_hw[1], out_hw[0]), (offset[1], offset[0]))


def _bits_equal(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    if got.dtype == F16:
        got, want = got.view(torch.int16), want.view(torch.int16)
    elif got.dtype == U16:
        got, want = got.to(torch.int32), want.to(torch.int32)
    assert torch.equal(got, want), f"{int((got != want).sum())} of {got.numel()} values differ"


class _K6Calls:
    """Counts the float16 dispatch's ``easu_h`` calls and keeps what each
    was handed and returned."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = teasu_h.easu_h

        def k6(image, *args, **kwargs):
            out = real(image, *args, **kwargs)
            self.calls.append((image, kwargs, out))
            return out

        monkeypatch.setattr(teasu_h, "easu_h", k6)


# --- the plain version with each tail is the torch path's float16 chain -----


@pytest.mark.parametrize("tail", list(TAILS))
@pytest.mark.parametrize("nc", [3, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_reference_with_each_tail_equals_the_torch_path(kind, nc, tail, monkeypatch):
    """``easu_h_reference`` with the tail and ``upscale(impl="kernel")``
    (one ``easu_h`` call, its result the call's) bit-equal to
    ``upscale(impl="torch")``: every source type, RGB and RGBA."""
    (in_hw, out_hw) = PERF
    x = _torch(_source(kind, (2, nc, *in_hw)), kind)
    kw = _tail(tail, out_hw)
    want = fsr_tpu_torch.upscale(x, out_size=out_hw, compute_dtype=F16, impl="torch", **kw)
    got = teasu_h.easu_h_reference(x, out_hw, _con(in_hw, out_hw), RcasConstants(0.25), **kw)
    _bits_equal(got, want)
    calls = _K6Calls(monkeypatch)
    out = fsr_tpu_torch.upscale(x, out_size=out_hw, compute_dtype=F16, impl="kernel", **kw)
    assert len(calls.calls) == 1 and out is calls.calls[0][2]
    _bits_equal(out, want)


@pytest.mark.parametrize("mode", ["off", "rcas", "denoise"])
@pytest.mark.parametrize("tail", ["display", "hdr"])
def test_each_rcas_mode_with_a_tail_equals_the_torch_path(tail, mode):
    """RCAS off, on and denoise with a tail, at the Quality ratio (K2's
    tables in K6), RGBA float16."""
    in_hw, out_hw = QUALITY
    x = _torch(_source("float16", (1, 4, *in_hw), seed=52), "float16")
    rc, dn = {"off": (False, False), "rcas": (True, False), "denoise": (True, True)}[mode]
    kw = _tail(tail, out_hw)
    want = fsr_tpu_torch.upscale(x, out_size=out_hw, compute_dtype=F16, apply_rcas=rc, denoise=dn, impl="torch",
                                 **kw)
    _bits_equal(teasu_h.easu_h_reference(x, out_hw, _con(in_hw, out_hw), RcasConstants(0.25), rc, dn, **kw), want)
    _bits_equal(fsr_tpu_torch.upscale(x, out_size=out_hw, compute_dtype=F16, apply_rcas=rc, denoise=dn,
                                      impl="kernel", **kw), want)


@pytest.mark.parametrize("tail", ["display", "u10"])
def test_tail_at_a_drs_offset_and_a_frame_tensor(tail):
    """A DRS viewport inside its container, and the frame index as a 0-d
    int32 tensor: the same bits as the torch path with a host int."""
    in_hw, out_hw, vp, off = (40, 60), (54, 96), (30, 52), (4, 6)
    x = _torch(_source("uint8", (1, 3, *in_hw), seed=53), "uint8")
    kw = _tail(tail, out_hw, frame=7)
    drs = dict(out_size=out_hw, input_viewport=vp, input_offset=off, compute_dtype=F16)
    want = fsr_tpu_torch.upscale(x, impl="torch", **drs, **kw)
    con = _con(in_hw, out_hw, vp, off)
    _bits_equal(teasu_h.easu_h_reference(x, out_hw, con, RcasConstants(0.25), **kw), want)
    kw["frame"] = torch.tensor(7, dtype=torch.int32)
    _bits_equal(teasu_h.easu_h_reference(x, out_hw, con, RcasConstants(0.25), **kw), want)
    _bits_equal(fsr_tpu_torch.upscale(x, impl="kernel", **drs, **kw), want)


@pytest.mark.parametrize("tail", list(TAILS))
def test_pipeline_runs_its_chain_in_one_k6_call(tail, monkeypatch):
    """``UpscalePipeline(compute_dtype=float16)``'s options (HDR tail,
    display, bytes, gamma2 + 10-bit dither): one ``easu_h`` call with every
    option, whose result is the pipeline's, bit-equal to the torch path's
    pipeline; a dither the output cannot hold runs after it (float16 with a
    dither: the after-pass, as the JAX package's)."""
    kw, epi, od = TAILS[tail]
    epi = epi or {}
    opts = dict(hdr_srtm=kw.get("prologue") == "srtm", hdr_out=epi.get("transform") == "srtm_inv",
                gamma2_out=epi.get("transform") == "gamma2", grain_amount=epi.get("grain_amount", 0.0),
                dither_bits=epi.get("dither_bits"), out_dtype=getattr(torch, od) if od else None,
                compute_dtype=F16)
    in_hw, out_hw = PERF
    x = _torch(_source("uint8", (2, 4, *in_hw), seed=54), "uint8")
    grain = torch.from_numpy(_operands(out_hw)[0])
    want = fsr_tpu_torch.UpscalePipeline(out_hw, impl="torch", **opts)(x, grain=grain, frame=3)
    calls = _K6Calls(monkeypatch)
    got = fsr_tpu_torch.UpscalePipeline(out_hw, impl="kernel", **opts)(x, grain=grain, frame=3)
    assert len(calls.calls) == 1
    _, k6_kw, k6_out = calls.calls[0]
    after = opts["dither_bits"] is not None and od is None
    assert (got is k6_out) != after
    assert k6_kw["out_dtype"] == (None if after else opts["out_dtype"])
    _bits_equal(got, want)


# --- row strips, read in place -----------------------------------------------


def _mesh(n):
    return sharding.make_mesh(n, ("sp",), None, devices=[CPU] * n)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("tail", list(TAILS))
@pytest.mark.parametrize("nc,kind", [(3, "float16"), (4, "uint8"), (3, "bfloat16"), (4, "float32")])
def test_strips_with_each_tail_equal_the_unsharded_call(kind, nc, tail, n, monkeypatch):
    """n row strips with a tail (the grain at the strip's rows, the dither
    at its global rows): one ``easu_h`` call per strip, handed the strip's
    ``StripSource`` as it stands and the strip's first global row, its
    rows bit-equal to the unsharded kernel call's and to the torch path's
    strips."""
    in_hw, out_hw = ((32, 48), (64, 96)) if kind in ("float16", "bfloat16") else ((48, 64), (72, 96))
    x = _torch(_source(kind, (2, nc, *in_hw), seed=55 + n), kind)
    kw = dict(_tail(tail, out_hw), compute_dtype=F16)
    want = fsr_tpu_torch.upscale(x, out_size=out_hw, impl="kernel", **kw)
    calls = _K6Calls(monkeypatch)
    got = spatial.upscale_spatial_sharded(x, out_hw, _mesh(n), impl="kernel", **kw)
    assert len(calls.calls) == n
    layout = spatial._layout(in_hw, out_hw, n, None, (0, 0))
    for (image, k6_kw, out), st, shard in zip(calls.calls, layout.strips, got.shards):
        assert isinstance(image, thalo.StripSource) and k6_kw["row_offset"] == st.row0 and out is shard
    _bits_equal(got.gather(), want)
    _bits_equal(got.gather(), spatial.upscale_spatial_sharded(x, out_hw, _mesh(n), impl="torch", **kw).gather())


def test_strip_reference_reads_a_strip_source_as_the_halo_d_rows():
    """The plain version of a strip with a tail on a ``StripSource`` and on
    its halo'd rows as one tensor: the same bits."""
    in_hw, out_hw = (32, 48), (64, 96)
    x = _torch(_source("float16", (1, 4, *in_hw), seed=57), "float16")
    layout = spatial._layout(in_hw, out_hw, 4, None, (0, 0))
    sources = spatial._sources(list(x.split(in_hw[0] // 4, dim=-2)), layout.halo)
    for src, st in zip(sources, layout.strips):
        kw = dict(_tail("display", layout.out_hw), row_plan=st.rows, row_offset=st.row0)
        got = teasu_h.easu_h_reference(src, layout.out_hw, layout.con, RcasConstants(0.25), **kw)
        _bits_equal(got, teasu_h.easu_h_reference(thalo.halo_rows_reference(src), layout.out_hw, layout.con,
                                                  RcasConstants(0.25), **kw))


# --- against the JAX package ---------------------------------------------------


def _against_jax(got: torch.Tensor, want: np.ndarray, hdr: bool):
    assert tuple(got.shape) == want.shape
    g, w = got.float().numpy(), np.asarray(want).astype(np.float32)
    if got.dtype in (U8, U16):
        d = np.abs(g - w) / (255.0 if got.dtype == U8 else 1023.0)
        assert (d > 0).mean() <= CODE_SHARE
        assert (d > BUDGET + 1e-7).mean() <= STEP_SHARE
        assert np.median(d) <= MEDIAN
        return
    assert np.isfinite(g).all()
    if hdr:
        g, w = (tx.srtm(torch.from_numpy(a[..., :3, :, :])).numpy() for a in (g, w))
    d = np.abs(g - w)
    assert np.median(d) <= MEDIAN and (d > BUDGET).mean() <= SHARE


@pytest.mark.parametrize("tail", list(TAILS))
@pytest.mark.parametrize("nc,kind", [(3, "float16"), (4, "uint8"), (3, "bfloat16"), (4, "float32")])
def test_upscale_with_a_tail_matches_fsr_tpu(kind, nc, tail):
    """``upscale(compute_dtype=float16, impl="kernel")`` with a tail against
    ``fsr_tpu.upscale(impl="xla", compute_dtype=float16)`` with the same
    options (module note)."""
    in_hw, out_hw = PERF
    x = _source(kind, (nc, *in_hw), seed=58)
    got = fsr_tpu_torch.upscale(_torch(x, kind), out_size=out_hw, compute_dtype=F16, impl="kernel",
                                **_tail(tail, out_hw))
    want = fsr_tpu.upscale(_jax(x, kind), out_size=out_hw, compute_dtype=jnp.float16, impl="xla",
                           **_jax_tail(tail, out_hw))
    _against_jax(got, np.asarray(want), tail == "hdr")


@pytest.mark.parametrize("opts", [
    dict(hdr_srtm=True, hdr_out=True, grain_amount=0.25),
    dict(grain_amount=0.25, dither_bits=8, out_dtype="uint8"),
    dict(gamma2_out=True, dither_bits=10, out_dtype="uint16"),
    dict(hdr_srtm=True, grain_amount=0.25, dither_bits=10),
], ids=["hdr", "display", "u10", "hdr-dither-after"])
@pytest.mark.parametrize("nc", [3, 4])
def test_pipeline_matches_fsr_tpu_pipeline(opts, nc):
    """``UpscalePipeline(compute_dtype=float16)`` against
    ``fsr_tpu.UpscalePipeline(compute_dtype=jnp.float16)``: the same
    options, frame and grain (module note); a float16 output with a dither
    runs the after-pass in both."""
    in_hw, out_hw = QUALITY
    x = _source("uint8" if "out_dtype" in opts else "float32", (nc, *in_hw), seed=59)
    grain = _operands(out_hw)[0]
    od = opts.get("out_dtype")
    tkw = dict(opts, out_dtype=getattr(torch, od) if od else None, compute_dtype=F16)
    jkw = dict(opts, out_dtype=getattr(jnp, od) if od else None, compute_dtype=jnp.float16)
    got = fsr_tpu_torch.UpscalePipeline(out_hw, impl="kernel", **tkw)(torch.from_numpy(x),
                                                                       grain=torch.from_numpy(grain), frame=4)
    want = fsr_tpu.UpscalePipeline(out_hw, **jkw)(jnp.asarray(x), grain=jnp.asarray(grain), frame=4)
    _against_jax(got, np.asarray(want), bool(opts.get("hdr_out")))


# --- the store's codes, and what K6 takes -----------------------------------------


@pytest.mark.parametrize("bits", [8, 10])
def test_every_code_survives_its_half_rounding(bits):
    """The fused store encodes from the float16 value: every 8-bit code
    k/255 and every 10-bit code k/1023, rounded to half and encoded, comes
    back as k; so do the TEPD quantize's levels (float32(k) * float32(1 /
    max) and k/max + 1/max, as ``extras.tepd_quantize`` forms them)."""
    m = 2 ** bits - 1
    k = np.arange(m + 1)
    inv = np.float32(1.0 / m)
    n = k.astype(np.float32) * inv  # floor(sqrt(v) * max) * (1 / max), float32
    up = np.minimum(n[:-1] + inv, np.float32(1.0))  # the dither's step up, clipped
    for levels, want in ((k / m, k), (n, k), (up, k[1:])):
        half = levels.astype(np.float16).astype(np.float32)
        codes = np.floor(np.clip(half, 0, 1) * np.float32(m) + np.float32(0.5)).astype(np.int64)
        assert np.array_equal(codes, want)
    # and the port's encode on those halves
    enc = tepilogue.encode_unorm8 if bits == 8 else tepilogue.encode_unorm10
    t = torch.from_numpy((k / m).astype(np.float16))
    assert torch.equal(enc(t).to(torch.int64), torch.from_numpy(k))


def test_supported_outputs_and_refusals():
    with profiling.recording() as rec:
        in_hw, out_hw = PERF
        con = _con(in_hw, out_hw)
        shape = (3, *in_hw)
        for od in (None, F16, U8, U16):
            assert teasu_h.supported(shape, out_hw, con, out_dtype=od)
            assert tdispatch.supported(torch.empty(shape), out_hw, con, F16, od)
        for od in (torch.float32, torch.bfloat16):
            assert not teasu_h.supported(shape, out_hw, con, out_dtype=od)
            assert not tdispatch.supported(torch.empty(shape), out_hw, con, F16, od)
        x = torch.from_numpy(_img(60, shape))
        with pytest.raises(ValueError, match="float16, uint8 or uint16"):
            teasu_h.easu_h(x, out_hw, con, RcasConstants(0.25), out_dtype=torch.float32)
        with pytest.raises(ValueError, match="unknown prologue"):
            teasu_h.easu_h(x, out_hw, con, RcasConstants(0.25), prologue="pq")
        with pytest.raises(ValueError, match="requires grain"):
            teasu_h.easu_h(x, out_hw, con, RcasConstants(0.25), epilogue=Epilogue(grain_amount=0.3))
        with pytest.raises(NotImplementedError, match="impl='torch'"):
            tdispatch.upscale_fused(x, out_hw, con, RcasConstants(0.25), True, False, F16, out_dtype=torch.float32)
    assert not rec.launches()  # CPU tensors run the plain version
