"""The frame index as a tensor, and the captured frame, on the CPU.

JAX traces ``frame`` (``fsr_tpu/kernels/fused.py:652-657`` reads it as a
kernel operand; ``examples/dataset_preprocessing.py:64`` jits ``upscale``
over it).  The port takes a 0-d integer tensor on the image's device the
same way (``ops.extras.frame_index``): the kernels read it through a device
pointer and the plain versions and the torch path compute with it, so no
call reads it back to the host and a captured CUDA graph takes each
replay's frame.  Held here:

- the dither functions with a tensor frame bit-equal to the int frame and
  to ``jax.jit`` of ``fsr_tpu.ops.extras`` with a traced frame, over frames
  {0, 7, 2**31 - 1, -1} (the floor-mod page choice covers -1);
- ``upscale`` (K1's and K2's plain versions, and the torch path),
  ``UpscalePipeline`` (hash and texture dither, fused and after-pass) and
  ``tonemap_pass`` with a tensor frame bit-equal to the int frame, and
  against ``jax.jit`` with a traced frame: XLA by tests/test_torch_epilogue.py's
  limits (at most 2e-4 of the values at another dither step, each within
  2.05 steps), K1 in Pallas interpret mode once (its traced operand) by
  that file's interpret limit (0.2% of the codes, each by one);
- no host read: a dispatch mode that raises on ``aten._local_scalar_dense``
  around the sample app's eager frame, the pipeline with a tensor frame and
  the frame graph's tail;
- the sharded paths (rows over a ``[cpu] * n`` mesh, the pipeline on it,
  the batch over one) with a tensor frame bit-equal to the int frame;
- ``utils.capture.CapturedFrame`` on the CPU calls the function eagerly, and
  a capture keeps the cached tables its graph reads (``capture.keep``);
- the C struct carries a tensor frame as ``frame_dev``.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import fsr_tpu
from fsr_tpu.core import tonemap as jtm
from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.kernels import fused as jfused
from fsr_tpu.kernels import pad as jpad
from fsr_tpu.kernels.epilogue import Epilogue as JEpilogue
from fsr_tpu.ops import extras as jx

import fsr_tpu_torch
from examples_torch import frame_graph, sample_app
from fsr_tpu_torch.core import tonemap as tm
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.kernels import epilogue as tepilogue
from fsr_tpu_torch.kernels import fused as tfused
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.ops import easu as teasu
from fsr_tpu_torch.ops import extras as tx
from fsr_tpu_torch.parallel import sharding, spatial
from fsr_tpu_torch.utils import capture
from fsr_tpu_torch.utils.capture import CapturedFrame

FRAMES = (0, 7, 2**31 - 1, -1)
# tests/test_torch_epilogue.py's limits against the JAX package.
ATOL = 2e-6
XLA_FLIP_SHARE = 2e-4
INTERPRET_FLIP_SHARE = 2e-3
SHAPES = {"K1": ((40, 144), (80, 288)), "K2": ((48, 160), (72, 240))}


def _t(frame):
    return torch.tensor(frame, dtype=torch.int32)


def _rand(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _check_dither(got, want, bits, share):
    d = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32))
    step = 1.0 / (255.0 if bits == 8 else 1023.0)
    assert (d > ATOL).mean() <= share, f"{(d > ATOL).sum()} of {d.size} at another dither step"
    assert d.max() <= 2.05 * step, f"dither mismatch beyond one step: {d.max()}"


def _same(got, want, what):
    """Bit-equal, or a message with the count and size of the differences."""
    assert got.shape == want.shape and got.dtype == want.dtype, what
    if not torch.equal(got, want):
        d = (got.double() - want.double()).abs()
        raise AssertionError(f"{what}: {int((d > 0).sum())} of {d.numel()} values differ, max {d.max().item():g}")


class _NoHostRead(TorchDispatchMode):
    """Raises on any read of a tensor's value into a Python number."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a tensor's value was read back to the host")
        return func(*args, **(kwargs or {}))


# --- the dither functions -------------------------------------------------------


@pytest.mark.parametrize("frame", FRAMES)
def test_dither_functions_take_a_tensor_frame(frame):
    jit_hash = jax.jit(lambda f: jx.tepd_dither((48, 300), f, origin=(5, 17)))
    got = tx.tepd_dither((48, 300), _t(frame), origin=(5, 17))
    np.testing.assert_array_equal(got.numpy(), tx.tepd_dither((48, 300), frame, origin=(5, 17)).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jit_hash(jnp.int32(frame))))

    tex = _rand(1, (3, 16, 24))
    jit_tex = jax.jit(lambda f, t: jx.texture_dither((40, 50), f, t, origin=(9, 3)))
    got = tx.texture_dither((40, 50), _t(frame), torch.from_numpy(tex), origin=(9, 3))
    np.testing.assert_array_equal(got.numpy(),
                                  tx.texture_dither((40, 50), frame, torch.from_numpy(tex), origin=(9, 3)).numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(jit_tex(jnp.int32(frame), jnp.asarray(tex))))
    # The page is frame mod pages, floor-mod as jnp's %: -1 takes the last.
    page = tx.select_page(torch.from_numpy(tex), _t(frame))
    np.testing.assert_array_equal(page.numpy(), tex[frame % 3])


def test_frame_index_rules():
    assert tx.frame_index(np.int64(5)) == 5 and isinstance(tx.frame_index(np.int64(5)), int)
    f = tx.frame_index(torch.tensor([9], dtype=torch.int64), "cpu")
    assert isinstance(f, torch.Tensor) and f.dtype == torch.int32 and f.shape == () and int(f) == 9
    # A wider tensor is cast on its device, wrapping as JAX's int32 cast does.
    assert int(tx.frame_index(torch.tensor(2**32 + 3), "cpu")) == 3
    # A CPU tensor for an image elsewhere is read as a host int.
    assert tx.frame_index(_t(4), "meta") == 4
    with pytest.raises(ValueError, match="lies on meta"):
        tx.frame_index(torch.empty((), dtype=torch.int32, device="meta"), "cpu")
    with pytest.raises(ValueError, match="integer scalar"):
        tx.frame_index(torch.tensor(1.0), "cpu")
    with pytest.raises(ValueError, match="integer scalar"):
        tx.frame_index(torch.tensor([1, 2]), "cpu")


def test_c_params_carries_a_device_frame():
    E = tepilogue.Epilogue
    frame = _t(-1)
    args = tepilogue.bind(E(dither_bits=8), (8, 8), frame=frame, device=torch.device("cpu"))
    st = tepilogue.c_params(args)
    assert st.frame_dev == args.frame.data_ptr() == frame.data_ptr() and st.frame == 0
    st = tepilogue.c_params(tepilogue.bind(E(dither_bits=8), (8, 8), frame=-1))
    assert st.frame_dev is None and st.frame == (1 << 32) - 1
    # fsr::EpilogueParams: frame_dev last, the earlier fields where they were.
    assert tepilogue._CEpilogue.grain_amount.offset == 16 and tepilogue._CEpilogue.row0.offset == 40
    assert tepilogue._CEpilogue.frame_dev.offset == 48 and ctypes.sizeof(tepilogue._CEpilogue) == 56


# --- upscale, the pipeline, tonemap_pass ------------------------------------------


@pytest.mark.parametrize("kernel", ["K1", "K2"])
@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("bits", [8, 10])
def test_upscale_tensor_frame(kernel, impl, bits):
    in_hw, out_hw = SHAPES[kernel]
    img = _rand(2, (3, *in_hw))
    x = torch.from_numpy(img)
    kw = dict(out_size=out_hw, impl=impl, epilogue=Epilogue(dither_bits=bits))
    for frame in FRAMES:
        got = fsr_tpu_torch.upscale(x, frame=_t(frame), **kw)
        _same(got, fsr_tpu_torch.upscale(x, frame=frame, **kw), f"frame {frame}")
    run = jax.jit(lambda a, f: fsr_tpu.upscale(a, out_size=out_hw, impl="xla", epilogue=JEpilogue(dither_bits=bits),
                                               frame=f))
    want = np.asarray(run(jnp.asarray(img), jnp.int32(7)))
    _check_dither(fsr_tpu_torch.upscale(x, frame=_t(7), **kw).numpy(), want, bits, XLA_FLIP_SHARE)


PIPELINES = {
    "hash8-u8": dict(dither_bits=8, out_dtype="uint8"),
    "texture10": dict(dither_bits=10, texture=True),
    "texture10-bf16-afterpass": dict(dither_bits=10, texture=True, compute_dtype="bfloat16"),
    "hash10-bf16-afterpass": dict(dither_bits=10, compute_dtype="bfloat16"),
}


@pytest.mark.parametrize("case", sorted(PIPELINES))
@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_pipeline_tensor_frame(case, impl):
    in_hw, out_hw = SHAPES["K1"]
    img = _rand(3, (3, *in_hw))
    spec = dict(PIPELINES[case])
    tex = _rand(4, (3, 32, 32)) if spec.pop("texture", False) else None
    kw = {k: getattr(torch, v) if k in ("out_dtype", "compute_dtype") else v for k, v in spec.items()}
    pipe = fsr_tpu_torch.UpscalePipeline(out_hw, dither_texture=tex, impl=impl, **kw)
    x = torch.from_numpy(img)
    for frame in FRAMES:
        _same(pipe(x, frame=_t(frame)), pipe(x, frame=frame), f"frame {frame}")
    if "compute_dtype" in spec:
        return  # the JAX pipeline's bf16 base rounds elsewhere (tests/test_torch_pipeline.py)
    jkw = {k: getattr(jnp, v) if k == "out_dtype" else v for k, v in spec.items()}
    jpipe = fsr_tpu.UpscalePipeline(out_hw, dither_texture=None if tex is None else jnp.asarray(tex), **jkw)
    want = np.asarray(jax.jit(lambda a, f: jpipe(a, frame=f))(jnp.asarray(img), jnp.int32(-1)))
    got = pipe(x, frame=_t(-1)).numpy()
    if got.dtype == np.uint8:
        d = np.abs(got.astype(int) - want.astype(int))
        assert (d > 0).mean() <= XLA_FLIP_SHARE and d.max() <= 1
    else:
        _check_dither(got, want, spec["dither_bits"], XLA_FLIP_SHARE)


@pytest.mark.parametrize("frame", FRAMES)
def test_tonemap_pass_tensor_frame(frame):
    hdr = _rand(5, (3, 16, 40), 0.0, 4.0)
    got = tm.tonemap_pass(torch.from_numpy(hdr), tonemapper="aces", hdr10_dither_frame=_t(frame))
    want = tm.tonemap_pass(torch.from_numpy(hdr), tonemapper="aces", hdr10_dither_frame=frame)
    _same(got, want, f"frame {frame}")
    run = jax.jit(lambda a, f: jtm.tonemap_pass(a, tonemapper="aces", hdr10_dither_frame=f))
    jout = np.asarray(run(jnp.asarray(hdr), jnp.int32(frame)))
    np.testing.assert_array_equal(np.round(got.numpy() * 1023.0), np.round(jout * 1023.0))


def test_k1_traced_frame_matches_jax_kernel():
    """The JAX K1 with its frame traced (the SMEM operand of
    fsr_tpu/kernels/fused.py:652-657), in interpret mode: the port's K1
    plain version with a tensor frame, uint8 in and out, 8-bit dither."""
    in_hw, out_hw = SHAPES["K1"]
    img8 = (_rand(6, (3, *in_hw)) * 255).astype(np.uint8)
    args = ((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    jc, tc = JEasu.create(*args), EasuConstants.create(*args)
    jfused.INTERPRET = jpad.INTERPRET = True
    try:
        run = jax.jit(lambda a, f: jfused.upscale_fused(a, out_hw, jc, JRcas(0.25), epilogue=JEpilogue(dither_bits=8),
                                                        frame=f, out_dtype=jnp.uint8))
        want = np.asarray(run(jnp.asarray(img8), jnp.int32(7)))
    finally:
        jfused.INTERPRET = jpad.INTERPRET = False
    got = tfused.upscale_fused(torch.from_numpy(img8), out_hw, tc, RcasConstants(0.25),
                               epilogue=Epilogue(dither_bits=8), frame=_t(7), out_dtype=torch.uint8).numpy()
    assert got.dtype == want.dtype == np.uint8
    d = np.abs(got.astype(int) - want.astype(int))
    assert (d > 0).mean() <= INTERPRET_FLIP_SHARE and d.max() <= 1


# --- no host reads; the captured frame on the CPU ---------------------------------


def _app(**globs):
    cfg = sample_app.merge_config(sample_app.DEFAULT_CONFIG, {"globals": {"width": 128, "height": 64, **globs}})
    return sample_app.SampleApp(cfg, device="cpu")


@pytest.mark.parametrize("globs", [dict(), dict(hdr=True), dict(mode="bilinear", hdr=True), dict(mode="native")],
                         ids=["fsr", "fsr-hdr", "bilinear-hdr", "native"])
def test_sample_app_frame_reads_nothing_back(globs):
    app = _app(**globs)
    inputs = app.frame_inputs({"cy": 0.46, "cx": 0.5, "zoom": 1.7}, 5)
    with _NoHostRead():
        got = app.frame_tail(*inputs)
    _same(got, app.render_frame({"cy": 0.46, "cx": 0.5, "zoom": 1.7}, 0.0, 5), "render_frame")


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_pipeline_and_frame_graph_read_nothing_back(impl):
    in_hw, out_hw = SHAPES["K2"]
    x = torch.from_numpy(_rand(7, (3, *in_hw)))
    tex = _rand(8, (4, 16, 16))
    for kw in (dict(dither_bits=8, out_dtype=torch.uint8), dict(dither_bits=10, dither_texture=tex),
               dict(dither_bits=10, compute_dtype=torch.bfloat16, dither_texture=tex)):
        pipe = fsr_tpu_torch.UpscalePipeline(out_hw, impl=impl, **kw)
        want = pipe(x, frame=3)
        with _NoHostRead():
            got = pipe(x, frame=_t(3))
        _same(got, want, f"pipeline {kw}")
    scene = torch.from_numpy(frame_graph.render_scene((36, 64), 7))
    with _NoHostRead():
        got = frame_graph.frame_tail(scene, (72, 128))
    _same(got, frame_graph.frame_tail(scene, (72, 128)), "frame_tail")


def test_captured_frame_on_the_cpu_calls_eagerly():
    in_hw, out_hw = SHAPES["K1"]
    epi = Epilogue(dither_bits=8)

    def frame(img, f):
        return fsr_tpu_torch.upscale(img, out_size=out_hw, epilogue=epi, frame=f, out_dtype=torch.uint8)

    x = torch.from_numpy(_rand(9, (3, *in_hw)))
    run = CapturedFrame(frame, x, _t(0))
    assert run.graph is None and run.device == torch.device("cpu")
    for k, f in enumerate(FRAMES):
        y = torch.from_numpy(_rand(10 + k, (3, *in_hw)))
        _same(run(y, _t(f)), frame(y, f), f"frame {f}")
    with pytest.raises(ValueError, match="one device"):
        CapturedFrame(frame, x, torch.empty((), dtype=torch.int32, device="meta"))


def test_cached_tables_are_kept_with_a_capture():
    """The torch path's tables come from a cache that may evict them; what a
    capture reads is held with its graph (``capture.keep``), nothing outside
    one."""
    in_hw, out_hw = SHAPES["K2"]
    con = EasuConstants.create((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    x = torch.from_numpy(_rand(11, (3, *in_hw)))
    want = teasu.bilinear(x, out_hw, con)
    tables = teasu._tables(con, out_hw, in_hw, x.device)
    kept = []
    with capture._keeping(kept):
        _same(teasu.bilinear(x, out_hw, con), want, "bilinear while keeping")
    assert kept == [tables] and capture._kept is None
    teasu._tables.cache_clear()
    assert teasu._tables(con, out_hw, in_hw, x.device) is not tables
    assert capture.keep(tables) is tables and kept == [tables]


# --- the sharded paths ------------------------------------------------------------


def _cpu_mesh(n, names=("sp",), shape=None):
    return sharding.make_mesh(n, names, shape, devices=[torch.device("cpu")] * n)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_sharded_paths_take_a_tensor_frame(impl):
    """Each strip or share takes the frame on its own device
    (``sharding.shard_frame``): rows over a mesh, the pipeline on it and the
    batch over one, each bit-equal to the same call with an int frame."""
    x = torch.from_numpy(_rand(12, (2, 3, 32, 48)))
    epi = Epilogue(dither_bits=8)
    tex = _rand(13, (3, 16, 16))
    pipes = [fsr_tpu_torch.UpscalePipeline((64, 96), dither_bits=10, impl=impl, mesh=_cpu_mesh(4)),
             fsr_tpu_torch.UpscalePipeline((48, 72), dither_bits=8, out_dtype=torch.uint8, dither_texture=tex,
                                           impl=impl, mesh=_cpu_mesh(4, ("dp", "sp"), (2, 2)), batch_axis="dp")]
    for frame in FRAMES:
        for out_hw in ((64, 96), (48, 72)):
            def rows(f):
                return spatial.upscale_spatial_sharded(x, out_hw, _cpu_mesh(4), epilogue=epi, frame=f, impl=impl,
                                                       out_dtype=torch.uint8).gather()
            _same(rows(_t(frame)), rows(frame), f"rows to {out_hw}, frame {frame}")
        for k, pipe in enumerate(pipes):
            _same(pipe(x, frame=_t(frame)).gather(), pipe(x, frame=frame).gather(),
                  f"pipeline {k} on a mesh, frame {frame}")

        def batch(f):
            return sharding.upscale_batch_sharded(x, _cpu_mesh(2, ("batch",)), scale=2.0, impl=impl, epilogue=epi,
                                                  frame=f).gather()
        _same(batch(_t(frame)), batch(frame), f"batch, frame {frame}")
    assert sharding.shard_frame(None, "cpu", "cpu") is None and sharding.shard_frame(np.int64(3), "cpu", "cpu") == 3
    with pytest.raises(ValueError, match="lies on meta"):
        sharding.shard_frame(torch.empty((), dtype=torch.int32, device="meta"), "cpu", "cpu")
