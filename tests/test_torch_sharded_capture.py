"""The sharded calls captured once per device, on meshes of CPU devices.

``parallel.spatial.CapturedSpatial`` (the row-sharded call, and
``UpscalePipeline(mesh=)`` through ``from_pipeline``) and
``parallel.sharding.CapturedBatch`` are the port's counterparts of JAX's
jitted ``shard_map``s.  On a CPU device they run the same staging into
static buffers and the same per-strip bodies as the CUDA graphs, eagerly,
so each is held here:

- bit-equal to the eager sharded call on the same inputs, shard by shard,
  for 2x on K1's plain version, 1.5x on K2's, the torch path, DRS, dp x sp,
  u8 in and out, RGBA, the pipeline's fused 10-bit epilogue with grain and
  its bf16 after-pass (hash and texture), and the batch on both paths;
  each over two calls in a row with other inputs and frames (a halo row
  left from the call before would show at the seams);
- shard by shard against the ``addressable_shards`` entry of JAX's jitted
  sharded call (on the conftest's 8 virtual CPU devices) within
  tests/test_torch_sharded.py's limits: the torch path within 2e-6, the
  kernels' plain versions within 6e-5;
- the graphs' static inputs as a ``Sharded`` (``inputs``): the same
  tensors as the statics; ``put`` from a tensor, a view and a ``Sharded``
  equal to the call from the tensor; a producer's writes in place and a
  call from ``inputs`` bit-equal to the eager call and within the limits
  below of JAX's jitted call, with no copy into a static (and one per strip
  or share from a tensor); ``put``'s ``ValueError``s;
- the staging step writing into buffers bit-equal to ``_exchange_halo``'s
  fresh tensors for 2, 3, 4 and 8 strips;
- no ``aten._local_scalar_dense`` in a call with a tensor frame;
- the ``ValueError``s of a call unlike its capture.

No Pallas kernel runs here (JAX's sharded calls run on XLA).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from fsr_tpu.parallel import sharding as jsharding
from fsr_tpu.parallel import spatial as jspatial

import fsr_tpu_torch
from fsr_tpu_torch.kernels.epilogue import Epilogue
from fsr_tpu_torch.parallel import Sharded, sharding, spatial
from fsr_tpu_torch.utils.capture import CapturedFrame

CPU = torch.device("cpu")
U8 = torch.uint8
TORCH_TOL = 2e-6
KERNEL_TOL = 6e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread, as tests/test_torch_parallel.py: the strips' many
    small ops oversubscribe the cores beside other pytest workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, shape, lo=0.0, hi=1.0):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _image(seed, kind, shape):
    x = torch.from_numpy(_rand(seed, shape))
    return (x * 255).to(U8) if kind == "u8" else x * 8 if kind == "hdr" else x


def _t(frame):
    return torch.tensor(frame, dtype=torch.int32)


def _mesh(n, names=("sp",), shape=None):
    return sharding.make_mesh(n, names, shape, devices=[CPU] * n)


def _jmesh(n, names=("sp",), shape=None):
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return jsharding.make_mesh(n, names, shape=shape)


def _same_shards(got: Sharded, want: Sharded, what: str):
    """The same layout, and each shard bit-equal."""
    assert isinstance(got, Sharded) and got.spec == want.spec and got.shape == want.shape, what
    assert len(got.shards) == len(want.shards)
    for j, (a, b) in enumerate(zip(got.shards, want.shards)):
        assert a.shape == b.shape and a.dtype == b.dtype and a.device == b.device, f"{what}, shard {j}"
        if not torch.equal(a, b):
            d = (a.double() - b.double()).abs()
            raise AssertionError(f"{what}, shard {j}: {int((d > 0).sum())} of {d.numel()} values differ, "
                                 f"max {d.max().item():g}")


# --- the row-sharded call ---------------------------------------------------------

# name, in (H, W), out (H, W), mesh (names, shape), batch_axis, image kind,
# options (``upscale_spatial_sharded``'s).
ROWS = [
    ("2x K1", (32, 48), (64, 96), (("sp",), (4,)), None, "float", dict(impl="kernel")),
    ("1.5x K2", (48, 72), (72, 108), (("sp",), (4,)), None, "float", dict(impl="kernel")),
    ("1.5x torch", (48, 72), (72, 108), (("sp",), (3,)), None, "float", dict(impl="torch")),
    ("DRS K2", (96, 144), (132, 192), (("sp",), (4,)), None, "float",
     dict(impl="kernel", input_viewport=(92, 138), input_offset=(2, 3))),
    ("dp x sp K1", (32, 48), (64, 96), (("dp", "sp"), (2, 2)), "dp", "float", dict(impl="kernel")),
    ("2x u8 -> u8, hash dither8", (32, 48), (64, 96), (("sp",), (4,)), None, "u8",
     dict(impl="kernel", out_dtype=U8, epilogue=Epilogue(dither_bits=8))),
    ("1.5x RGBA u8 -> u8", (48, 72), (72, 108), (("sp",), (2,)), None, "u8",
     dict(impl="kernel", out_dtype=U8)),
    ("2x RGBA torch, grain + page dither10", (32, 48), (64, 96), (("sp",), (4,)), None, "float",
     dict(impl="torch", epilogue=Epilogue(grain_amount=0.3, dither_bits=10, dither_texture=True))),
]


@pytest.mark.parametrize("case", ROWS, ids=[c[0] for c in ROWS])
def test_captured_rows_equal_the_eager_call(case):
    """Two calls in a row, with other inputs and frames (an int, then a
    tensor), from a tensor and from a ``Sharded``: each bit-equal to the
    eager call, shard by shard."""
    name, in_hw, out_hw, (names, shape), batch_axis, kind, kw = case
    n = int(np.prod(shape))
    mesh = _mesh(n, names, shape)
    c = 4 if "RGBA" in name else 3
    lead = (4,) if batch_axis else (2,)
    kw = dict(kw)
    if kw.get("epilogue") is not None and kw["epilogue"].dither_texture:
        kw["dither_page"] = torch.from_numpy(_rand(20, (12, 20)))
    grain = torch.from_numpy(_rand(21, (3, *out_hw), -0.5, 0.5))
    cap = spatial.CapturedSpatial(_image(0, kind, (*lead, c, *in_hw)), out_hw, mesh, batch_axis=batch_axis,
                                  grain=grain, **kw)
    assert len(cap.programs.captured) == 1  # one program for the one device, all strips in it
    outs = []
    for k, frame in enumerate((5, _t(2**31 - 1))):
        x = _image(1 + k, kind, (*lead, c, *in_hw))
        g = grain * (1 - 2 * k)
        want = spatial.upscale_spatial_sharded(x, out_hw, mesh, batch_axis=batch_axis, frame=frame, grain=g, **kw)
        got = cap(x, frame=frame, grain=g)
        _same_shards(got, want, f"{name}, call {k}")
        outs.append(got.gather().clone())
        xs = Sharded.put(x, mesh, cap.spec)
        _same_shards(cap(xs, frame=frame, grain=g), want, f"{name}, call {k}, a Sharded input")
    assert not torch.equal(outs[0], outs[1])


# name, in (H, W), out (H, W), strips, impl (tests/test_torch_sharded.py's).
JAX_ROWS = [("2x K1", (64, 96), (128, 192), 4, "kernel"), ("1.5x K2", (96, 144), (144, 216), 4, "kernel"),
            ("1.5x torch", (96, 144), (144, 216), 3, "torch")]


def _ranges(index, shape):
    return tuple((sl.start or 0, n if sl.stop is None else sl.stop) for sl, n in zip(index, shape))


def _check_against_jax(got: Sharded, want: jax.Array, tol: float):
    """Each shard against the JAX shard whose index covers the same frames
    or rows (shards are row-major over the named dimensions)."""
    assert got.shape == tuple(want.shape)
    jax_shards = {_ranges(s.index, want.shape): np.asarray(s.data) for s in want.addressable_shards}
    named = [(d, a) for d, a in enumerate(got.spec) if a is not None]
    assert len(got.shards) == len(jax_shards)
    for j, shard in enumerate(got.shards):
        at = np.unravel_index(j, [got.mesh.shape[a] for _, a in named])
        r = [(0, n) for n in got.shape]
        for (d, a), i in zip(named, at):
            b = got.shape[d] // got.mesh.shape[a]
            r[d] = (int(i) * b, (int(i) + 1) * b)
        np.testing.assert_allclose(shard.float().numpy(), jax_shards[tuple(r)], atol=tol, rtol=0)


@pytest.mark.parametrize("case", JAX_ROWS, ids=[c[0] for c in JAX_ROWS])
def test_captured_rows_match_jax(case):
    _, in_hw, out_hw, n, impl = case
    img = _rand(3, (2, 3, *in_hw))
    cap = spatial.CapturedSpatial(torch.zeros((2, 3, *in_hw)), out_hw, _mesh(n), impl=impl)
    got = cap(torch.from_numpy(img))
    want = jspatial.upscale_spatial_sharded(jnp.asarray(img), out_hw, _jmesh(n), axis="sp")
    _check_against_jax(got, want, TORCH_TOL if impl == "torch" else KERNEL_TOL)


def test_captured_dp_by_sp_matches_jax():
    img = _rand(4, (4, 3, 32, 64))
    mesh = _mesh(8, ("dp", "sp"), (2, 4))
    cap = spatial.CapturedSpatial(torch.zeros((4, 3, 32, 64)), (64, 128), mesh, batch_axis="dp", impl="torch")
    got = cap(torch.from_numpy(img))
    assert got.spec == ("dp", None, "sp", None) and len(got.shards) == 8
    want = jspatial.upscale_spatial_sharded(jnp.asarray(img), (64, 128), _jmesh(8, ("dp", "sp"), (2, 4)),
                                            axis="sp", batch_axis="dp")
    _check_against_jax(got, want, TORCH_TOL)


# --- the pipeline -----------------------------------------------------------------

# name, the pipeline's options, image kind, whether calls pass grain.
PIPES = [
    ("HDR tail: SRTM, grain, fused hash dither10", dict(hdr_srtm=True, grain_amount=0.3, dither_bits=10), "hdr",
     True),
    ("display: u8 -> u8, grain, fused page dither8, bf16",
     dict(grain_amount=0.25, dither_bits=8, out_dtype=U8, compute_dtype=torch.bfloat16, texture=True), "u8", True),
    ("bf16 after-pass, hash", dict(dither_bits=10, compute_dtype=torch.bfloat16), "float", False),
    ("bf16 after-pass, texture", dict(dither_bits=10, compute_dtype=torch.bfloat16, texture=True), "float", False),
    ("bf16 after-pass, texture, dp x sp, u16", dict(dither_bits=10, compute_dtype=torch.bfloat16, texture=True,
                                                    out_dtype=torch.uint16, dp=True), "float", False),
]


@pytest.mark.parametrize("impl", ["kernel", "torch"])
@pytest.mark.parametrize("case", PIPES, ids=[c[0] for c in PIPES])
def test_captured_pipeline_equals_the_eager_pipeline(case, impl):
    name, opts, kind, with_grain = case
    opts = dict(opts)
    in_hw, out_hw = (32, 48), (64, 96)
    dp = opts.pop("dp", False)
    if opts.pop("texture", False):
        opts["dither_texture"] = _rand(30, (3, 20, 24))  # 20 rows: no strip starts on a page row 0
    mesh = _mesh(4, ("dp", "sp"), (2, 2)) if dp else _mesh(4)
    pipe = fsr_tpu_torch.UpscalePipeline(out_hw, impl=impl, mesh=mesh, batch_axis="dp" if dp else None, **opts)
    grain = torch.from_numpy(_rand(31, (3, *out_hw), -0.5, 0.5)) if with_grain else None
    cap = spatial.CapturedSpatial.from_pipeline(pipe, _image(0, kind, (2, 3, *in_hw)), grain=grain)
    outs = []
    for k, frame in enumerate((7, _t(-1), 2**31 - 1)):
        x = _image(1 + k, kind, (2, 3, *in_hw))
        g = None if grain is None else grain.flip(-1) if k else grain
        want = pipe(x, grain=g, frame=frame)
        got = cap(x, frame=frame, grain=g)
        _same_shards(got, want, f"{name}, call {k}")
        outs.append(got.gather().clone())
    assert not torch.equal(outs[0], outs[1])


def test_from_pipeline_needs_a_mesh():
    with pytest.raises(ValueError, match="has no mesh"):
        spatial.CapturedSpatial.from_pipeline(fsr_tpu_torch.UpscalePipeline((64, 96)), torch.zeros((3, 32, 48)))


# --- the batch --------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_captured_batch_matches_eager_and_jax(impl):
    """Two calls with other inputs and frames, bit-equal to the eager
    batch-sharded call; the first without an epilogue against JAX's
    jitted ``shard_map``."""
    mesh = _mesh(4, ("batch",))
    epi = Epilogue(dither_bits=8)
    cap = sharding.CapturedBatch(torch.zeros((8, 3, 32, 48)), mesh, scale=2.0, impl=impl, epilogue=epi,
                                 out_dtype=U8)
    for k, frame in enumerate((3, _t(-1))):
        x = torch.from_numpy(_rand(5 + k, (8, 3, 32, 48)))
        want = sharding.upscale_batch_sharded(x, mesh, scale=2.0, impl=impl, epilogue=epi, out_dtype=U8, frame=frame)
        _same_shards(cap(x, frame), want, f"batch, call {k}")
        _same_shards(cap(sharding.shard_batch(x, mesh), frame), want, f"batch, call {k}, a Sharded input")
    imgs = _rand(7, (8, 3, 32, 48))
    plain = sharding.CapturedBatch(torch.zeros((8, 3, 32, 48)), mesh, scale=2.0, impl=impl)
    want = jsharding.upscale_batch_sharded(jnp.asarray(imgs), _jmesh(4, ("batch",)), scale=2.0, impl="xla")
    _check_against_jax(plain(torch.from_numpy(imgs)), want, TORCH_TOL if impl == "torch" else KERNEL_TOL)


# --- the staging step -------------------------------------------------------------


@pytest.mark.parametrize("n", [2, 3, 4, 8])
def test_staging_into_buffers_equals_the_exchange(n):
    """Written into buffers full of garbage, each strip's rows, halo rows
    and edge rows are those of ``_exchange_halo``'s ``torch.cat``."""
    for halo, dtype, lead in ((spatial._HALO, torch.float32, (2,)), (spatial._GHALO, U8, ()),
                              (spatial._HALO, torch.bfloat16, (2, 1))):
        h = max(halo, 2) + 1
        x = (torch.from_numpy(_rand(n, (*lead, 3, n * h, 11))) * 200).to(dtype)
        strips = list(x.chunk(n, -2))
        want = spatial._exchange_halo(strips, halo)
        bufs = [torch.full_like(w, 77) for w in want]
        got = spatial._exchange_halo(strips, halo, into=bufs)
        assert all(g is b for g, b in zip(got, bufs))
        for k, (g, w) in enumerate(zip(got, want)):
            assert torch.equal(g, w), f"{n} strips, halo {halo}, {dtype}: strip {k}"


# --- no host read -----------------------------------------------------------------


class _NoHostRead(TorchDispatchMode):
    """Raises on any read of a tensor's value into a Python number."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten._local_scalar_dense.default:
            raise AssertionError("a tensor's value was read back to the host")
        return func(*args, **(kwargs or {}))


def test_a_tensor_frame_is_never_read_on_the_host():
    x = torch.from_numpy(_rand(8, (2, 3, 32, 48)))
    mesh = _mesh(4)
    tex = _rand(9, (3, 20, 24))
    rows = spatial.CapturedSpatial(x, (64, 96), mesh, impl="kernel", epilogue=Epilogue(dither_bits=10))
    paged = spatial.CapturedSpatial.from_pipeline(
        fsr_tpu_torch.UpscalePipeline((64, 96), dither_bits=8, out_dtype=U8, dither_texture=tex, mesh=mesh), x)
    after = spatial.CapturedSpatial.from_pipeline(
        fsr_tpu_torch.UpscalePipeline((64, 96), dither_bits=10, compute_dtype=torch.bfloat16, dither_texture=tex,
                                      mesh=mesh), x)
    batch = sharding.CapturedBatch(x, _mesh(2, ("batch",)), scale=2.0, epilogue=Epilogue(dither_bits=8))
    frame = _t(11)
    with _NoHostRead():
        for call in (rows, paged, after, batch):
            call(x, frame)


# --- the static inputs as a Sharded: inputs, put, writable -------------------------


class _CopiesInto(TorchDispatchMode):
    """Counts the ``copy_``s whose destination shares storage with one of
    ``statics``."""

    def __init__(self, statics):
        super().__init__()
        self.ptrs = {t.untyped_storage().data_ptr() for t in statics}
        self.count = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket.__name__ == "copy_" and args[0].untyped_storage().data_ptr() in self.ptrs:
            self.count += 1
        return func(*args, **(kwargs or {}))


def _statics(cap):
    return [ins[0] for ins in cap.programs.shard_inputs]


def _write_in_place(inputs: Sharded, seed: int, kind: str):
    """A producer's write of each shard where it lies, from numpy-seeded
    values; returns the global tensor written."""
    for k, shard in enumerate(inputs.shards):
        shard.copy_(_image(seed + k, kind, tuple(shard.shape)))
    return inputs.gather().clone()


def _row_capture(case):
    name, in_hw, out_hw, (names, shape), batch_axis, kind, kw = case
    mesh = _mesh(int(np.prod(shape)), names, shape)
    c = 4 if "RGBA" in name else 3
    kw = dict(kw)
    if kw.get("epilogue") is not None and kw["epilogue"].dither_texture:
        kw["dither_page"] = torch.from_numpy(_rand(20, (12, 20)))
    grain = torch.from_numpy(_rand(21, (3, *out_hw), -0.5, 0.5))
    full = (4 if batch_axis else 2, c, *in_hw)
    cap = spatial.CapturedSpatial(_image(0, kind, full), out_hw, mesh, batch_axis=batch_axis, grain=grain, **kw)

    def eager(x, frame, g):
        return spatial.upscale_spatial_sharded(x, out_hw, mesh, batch_axis=batch_axis, frame=frame, grain=g, **kw)
    return cap, eager, full, grain


@pytest.mark.parametrize("case", ROWS, ids=[c[0] for c in ROWS])
def test_captured_rows_inputs_put_and_writes_in_place(case):
    """``inputs`` are the graphs' own-row buffers; ``put`` from a tensor, a
    view of a larger one and a ``Sharded`` (with the grain) equals the call
    from the same tensor; a producer's writes in place after ``writable()``
    and a call from ``inputs`` equal the eager call, with no copy into a
    buffer; a call from a tensor copies each strip's rows once."""
    name, *_, kind, _ = case
    cap, eager, full, grain = _row_capture(case)
    ins = cap.inputs
    assert isinstance(ins, Sharded) and ins.spec == cap.spec and ins.shape == cap.shape and ins.dtype == cap.dtype
    assert all(a is b for a, b in zip(ins.shards, cap.buffers)) and all(a is b for a, b in zip(ins.shards,
                                                                                           _statics(cap)))
    assert cap.writable() is ins
    for k, frame in enumerate((9, _t(-5))):
        x = _image(40 + k, kind, full)
        g = grain.flip(-2) if k else grain
        want = cap(x, frame=frame, grain=g)
        want = Sharded(want.mesh, want.spec, tuple(s.clone() for s in want.shards), want.shape, want.dtype)
        wide = torch.cat([x, x], -1)[..., : x.shape[-1]]  # a view of a larger tensor
        for what, src in (("a tensor", x), ("a view", wide), ("a Sharded", Sharded.put(x, cap.mesh, cap.spec))):
            assert cap.put(src, grain=g) is ins
            with _CopiesInto(cap.buffers) as copies:
                got = cap(ins, frame=frame)
            assert copies.count == 0
            _same_shards(got, want, f"{name}: put from {what}, call {k}")
        written = _write_in_place(cap.writable(), 60 + k, kind)
        want = eager(written, frame, g)
        with _CopiesInto(cap.buffers) as copies:
            got = cap(ins, frame=frame, grain=g)
        assert copies.count == 0
        _same_shards(got, want, f"{name}: written in place, call {k}")
    with _CopiesInto(cap.buffers) as copies:
        cap(_image(70, kind, full), grain=grain)
    assert copies.count == len(cap.buffers)


@pytest.mark.parametrize("case", JAX_ROWS, ids=[c[0] for c in JAX_ROWS])
def test_captured_rows_written_in_place_match_jax(case):
    _, in_hw, out_hw, n, impl = case
    cap = spatial.CapturedSpatial(torch.zeros((2, 3, *in_hw)), out_hw, _mesh(n), impl=impl)
    img = _write_in_place(cap.writable(), 80, "float")
    want = jspatial.upscale_spatial_sharded(jnp.asarray(img.numpy()), out_hw, _jmesh(n), axis="sp")
    _check_against_jax(cap(cap.inputs), want, TORCH_TOL if impl == "torch" else KERNEL_TOL)


@pytest.mark.parametrize("impl", ["kernel", "torch"])
def test_captured_batch_inputs_put_and_writes_in_place(impl):
    """The batch's ``inputs`` are its graphs' static shares; ``put`` from a
    tensor and a ``Sharded`` equals the call from the same tensor; writes in
    place and a call from ``inputs`` equal the eager call with no copy into
    a share, and match JAX's jitted ``shard_map``."""
    mesh = _mesh(4, ("batch",))
    kw = dict(scale=2.0, impl=impl, epilogue=Epilogue(dither_bits=8), out_dtype=U8)
    cap = sharding.CapturedBatch(torch.zeros((8, 3, 32, 48)), mesh, **kw)
    ins = cap.inputs
    assert ins.spec == cap.spec and ins.shape == (8, 3, 32, 48) and all(a is b for a, b in zip(ins.shards,
                                                                                              _statics(cap)))
    x = torch.from_numpy(_rand(90, (8, 3, 32, 48)))
    want = cap(x, 4)
    want = Sharded(want.mesh, want.spec, tuple(s.clone() for s in want.shards), want.shape, want.dtype)
    for what, src in (("a tensor", x), ("a Sharded", sharding.shard_batch(x, mesh))):
        assert cap.put(src) is ins
        with _CopiesInto(_statics(cap)) as copies:
            got = cap(ins, 4)
        assert copies.count == 0
        _same_shards(got, want, f"put from {what}")
    written = _write_in_place(ins, 91, "float")
    with _CopiesInto(_statics(cap)) as copies:
        got = cap(ins, _t(6))
    assert copies.count == 0
    _same_shards(got, sharding.upscale_batch_sharded(written, mesh, frame=6, **kw), "written in place")
    with _CopiesInto(_statics(cap)) as copies:
        cap(x, 4)
    assert copies.count == 4
    plain = sharding.CapturedBatch(torch.zeros((8, 3, 32, 48)), mesh, scale=2.0, impl=impl)
    img = _write_in_place(plain.inputs, 92, "float")
    want = jsharding.upscale_batch_sharded(jnp.asarray(img.numpy()), _jmesh(4, ("batch",)), scale=2.0, impl="xla")
    _check_against_jax(plain(plain.inputs), want, TORCH_TOL if impl == "torch" else KERNEL_TOL)


def test_put_unlike_its_capture_raises():
    x = torch.from_numpy(_rand(11, (2, 3, 32, 48)))
    mesh = _mesh(4)
    cap = spatial.CapturedSpatial(x, (64, 96), mesh, epilogue=Epilogue(grain_amount=0.2),
                                  grain=torch.zeros((3, 64, 96)))
    with pytest.raises(ValueError, match=r"\(2, 3, 32, 48\) torch.float32 input, got a \(1, 3, 32, 48\)"):
        cap.put(x[:1])
    with pytest.raises(ValueError, match=r"torch.float32 input, got a \(2, 3, 32, 48\) torch.uint8"):
        cap.put(x.to(U8))
    with pytest.raises(ValueError, match=r"\(None, None, 'sp', None\).*\('batch', None, None, None\)"):
        cap.put(sharding.shard_batch(x, _mesh(2, ("batch",))))
    with pytest.raises(ValueError, match=r"grain of \(3, 64, 96\), got \(3, 32, 96\)"):
        cap.put(x, grain=torch.zeros((3, 32, 96)))
    with pytest.raises(ValueError, match=r"grain of \(3, 64, 96\), got \(3, 32, 96\)"):
        cap(cap.inputs, grain=torch.zeros((3, 32, 96)))
    batch = sharding.CapturedBatch(x, _mesh(2, ("batch",)), scale=2.0)
    with pytest.raises(ValueError, match=r"\(2, 3, 32, 48\) torch.float32 input, got a \(4, 3, 32, 48\)"):
        batch.put(torch.cat([x, x]))
    with pytest.raises(ValueError, match=r"torch.float32 input, got a \(2, 3, 32, 48\) torch.bfloat16"):
        batch.put(x.to(torch.bfloat16))
    with pytest.raises(ValueError, match=r"\('batch', None, None, None\).*\(None, None, 'batch', None\)"):
        batch.put(Sharded.put(x, _mesh(2, ("batch",)), (None, None, "batch", None)))


# --- the errors -------------------------------------------------------------------


def test_a_call_unlike_its_capture_raises():
    x = torch.from_numpy(_rand(10, (2, 3, 32, 48)))
    mesh = _mesh(4)
    grain = torch.zeros((3, 64, 96))
    cap = spatial.CapturedSpatial(x, (64, 96), mesh, epilogue=Epilogue(grain_amount=0.2), grain=grain)
    with pytest.raises(ValueError, match=r"\(2, 3, 32, 48\) torch.float32 input, got a \(1, 3, 32, 48\)"):
        cap(x[:1], grain=grain)
    with pytest.raises(ValueError, match=r"torch.float32 input, got a \(2, 3, 32, 48\) torch.uint8"):
        cap(x.to(U8), grain=grain)
    with pytest.raises(ValueError, match=r"\(None, None, 'sp', None\).*\('batch', None, None, None\)"):
        cap(sharding.shard_batch(x, _mesh(2, ("batch",))), grain=grain)
    with pytest.raises(ValueError, match=r"grain of \(3, 64, 96\), got \(3, 32, 96\)"):
        cap(x, grain=grain[:, :32])
    with pytest.raises(ValueError, match="captured with grain"):
        cap(x)
    with pytest.raises(ValueError, match="requires dither_page"):
        spatial.CapturedSpatial(x, (64, 96), mesh, epilogue=Epilogue(dither_bits=8, dither_texture=True))
    with pytest.raises(ValueError, match="spatial sharding needs"):
        spatial.CapturedSpatial(x, (62, 96), mesh)
    with pytest.raises(TypeError):
        spatial.CapturedSpatial(x, (64, 96), mesh, frame=3)
    batch = sharding.CapturedBatch(x, _mesh(2, ("batch",)), scale=2.0)
    with pytest.raises(ValueError, match=r"\(2, 3, 32, 48\) torch.float32 input, got a \(4, 3, 32, 48\)"):
        batch(torch.cat([x, x]))
    with pytest.raises(ValueError, match=r"\('batch', None, None, None\).*\(None, None, 'batch', None\)"):
        batch(Sharded.put(x, _mesh(2, ("batch",)), (None, None, "batch", None)))
    with pytest.raises(RuntimeError, match="no graph to replay"):
        CapturedFrame(lambda a: a * 2, x).replay()
