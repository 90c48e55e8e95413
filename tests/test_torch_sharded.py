"""``fsr_tpu_torch.parallel.Sharded``: sharded results stay on their devices,
shard by shard against the JAX package's sharded arrays.

The batch-sharded, row-sharded and dp x sp calls and
``UpscalePipeline(mesh=)`` return a ``Sharded`` on meshes of
``torch.device("cpu")``; each of its shards is held against the
``addressable_shards`` entry of the JAX result (on the conftest's 8 virtual
CPU devices) whose index covers the same frames or rows.  Limits are those
of the gathered comparisons (tests/test_torch_parallel.py): the torch path
within 2e-6, the kernels' plain versions within 6e-5, dithered values at
most 2e-4 of them at another step, each within 2.05 steps.  The DRS case
has no JAX sharded call (``fsr_tpu.parallel.spatial`` takes no viewport):
its JAX result is ``fsr_tpu.upscale`` laid out with ``jax.device_put`` in
the spec the JAX sharded call returns.  The bf16 after-pass is held, as in
tests/test_torch_pipeline.py, to JAX's after-pass on the same bf16 base,
laid out as the JAX pipeline's sharded result is.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import fsr_tpu
import fsr_tpu_torch
from fsr_tpu.ops import extras as jx
from fsr_tpu.parallel import sharding as jsharding
from fsr_tpu.parallel import spatial as jspatial

from fsr_tpu_torch.parallel import Sharded, sharding, spatial

CPU = torch.device("cpu")
TORCH_TOL = 2e-6
KERNEL_TOL = 6e-5
ATOL = 2e-6
FLIP_SHARE = 2e-4


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


def _mesh(n, names=("sp",), shape=None):
    return sharding.make_mesh(n, names, shape, devices=[CPU] * n)


def _jmesh(n, names=("sp",), shape=None):
    assert len(jax.devices()) >= 8, "conftest should provide 8 CPU devices"
    return jsharding.make_mesh(n, names, shape=shape)


def _ranges(index, shape):
    """A shard's index as (start, stop) per dimension."""
    return tuple((sl.start or 0, n if sl.stop is None else sl.stop) for sl, n in zip(index, shape))


def _port_index(x: Sharded, j: int):
    """The global rows, frames, ... of shard j: row-major over the named
    dimensions, as ``Sharded.shards`` is ordered."""
    named = [(d, a) for d, a in enumerate(x.spec) if a is not None]
    at = np.unravel_index(j, [x.mesh.shape[a] for _, a in named]) if named else ()
    index = [slice(0, n) for n in x.shape]
    for (d, a), i in zip(named, at):
        b = x.shape[d] // x.mesh.shape[a]
        index[d] = slice(int(i) * b, (int(i) + 1) * b)
    return tuple(index)


def _check_shards(got: Sharded, want: jax.Array, check):
    """Each port shard on its mesh device, with the index and values of
    the JAX shard whose index covers the same frames or rows."""
    assert isinstance(got, Sharded) and got.shape == tuple(want.shape)
    assert [s.device for s in got.shards] == sharding._shard_devices(got.mesh, got.spec)
    jax_shards = {_ranges(s.index, want.shape): s for s in want.addressable_shards}
    assert len(got.shards) == len(jax_shards), f"{len(got.shards)} port shards, {len(jax_shards)} JAX shards"
    for j, shard in enumerate(got.shards):
        r = _ranges(_port_index(got, j), got.shape)
        assert r in jax_shards, f"shard {j} covers {r}; JAX's cover {sorted(jax_shards)}"
        assert tuple(shard.shape) == tuple(e - s for s, e in r)
        check(shard, np.asarray(jax_shards[r].data))


def _within(tol):
    def check(shard, want):
        np.testing.assert_allclose(shard.float().numpy(), want, atol=tol, rtol=0)
    return check


def _steps(bits):
    """Dithered values (tests/test_torch_parallel.py's ``_check_steps``)."""
    def check(shard, want):
        d = np.abs(shard.double().numpy() - want.astype(np.float64))
        assert (d > ATOL).mean() <= FLIP_SHARE, f"{(d > ATOL).sum()} of {d.size} values at another step"
        assert d.max() <= 2.05 / (255.0 if bits == 8 else 1023.0)
    return check


# --- the type ---------------------------------------------------------------------

LAYOUTS = [
    # name: (global shape, mesh (names, shape), spec)
    ("rows", (2, 3, 8, 5), (("sp",), (4,)), (None, None, "sp", None)),
    ("batch", (4, 3, 2, 2), (("batch",), (2,)), ("batch", None, None, None)),
    ("dp x sp", (4, 3, 8, 5), (("dp", "sp"), (2, 4)), ("dp", None, "sp", None)),
    ("sp on a dp x sp mesh", (4, 3, 8, 5), (("dp", "sp"), (2, 4)), (None, None, "sp", None)),
    ("sp before dp", (3, 8, 4), (("dp", "sp"), (2, 4)), (None, "sp", "dp")),
    ("replicated", (3, 2), (("sp",), (4,)), (None, None)),
]


@pytest.mark.parametrize("case", LAYOUTS, ids=[c[0] for c in LAYOUTS])
def test_put_and_gather(case):
    """``Sharded.put`` splits as ``jax.device_put`` does, blocks in
    ``addressable_shards``' index order, each a view of the input on the
    (CPU) device; ``gather`` gives the tensor back, with its gradient."""
    _, shape, (names, mesh_shape), spec = case
    n = int(np.prod(mesh_shape))
    x = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(shape)
    got = Sharded.put(x, _mesh(n, names, mesh_shape), spec)
    assert got.spec == spec and got.shape == shape and got.dtype == torch.float32
    want = jax.device_put(jnp.asarray(x.numpy()), NamedSharding(_jmesh(n, names, mesh_shape), P(*spec)))
    if all(a is None for a in spec):  # JAX replicates on every device; the port holds one block
        assert len(got.shards) == 1 and torch.equal(got.shards[0], x)
    else:
        _check_shards(got, want, _within(0.0))
    for s in got.shards:
        assert s.untyped_storage().data_ptr() == x.untyped_storage().data_ptr()  # views, no copy
    torch.testing.assert_close(got.gather(), x, atol=0, rtol=0)
    v = x.clone().requires_grad_()
    w = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    (Sharded.put(v, got.mesh, spec).gather() * w).sum().backward()
    torch.testing.assert_close(v.grad, w, atol=0, rtol=0)


def test_layout_errors():
    x = torch.zeros((4, 3, 8, 6))
    mesh = _mesh(8, ("dp", "sp"), (2, 4))
    for spec, match in [((None, None, "sp"), "names 3 dimensions"), (("sp", None, "sp", None), "distinct axes"),
                        ((None, None, "tp", None), "distinct axes"), ((None, None, None, "sp"), "does not split")]:
        with pytest.raises(ValueError, match=match):
            Sharded.put(x, mesh, spec)
    good = Sharded.put(x, mesh, ("dp", None, "sp", None))
    with pytest.raises(ValueError, match="takes 8 blocks"):
        Sharded(mesh, good.spec, good.shards[:7], good.shape, good.dtype)
    with pytest.raises(ValueError, match="takes 8 blocks"):
        Sharded(mesh, good.spec, good.shards, good.shape, torch.bfloat16)
    assert good.gather(CPU).device == CPU


# --- shard by shard against JAX -------------------------------------------------


@pytest.mark.parametrize("impl", ["torch", "kernel"])
def test_batch_shards_match_jax(impl):
    imgs = _rand(0, (8, 3, 32, 48))
    got = sharding.upscale_batch_sharded(torch.from_numpy(imgs), _mesh(4, ("batch",)), scale=2.0, impl=impl)
    assert got.spec == ("batch", None, None, None)
    want = jsharding.upscale_batch_sharded(jnp.asarray(imgs), _jmesh(4, ("batch",)), scale=2.0, impl="xla")
    _check_shards(got, want, _within(TORCH_TOL if impl == "torch" else KERNEL_TOL))


# name, in (H, W), out (H, W), strips, impl: 2x on K1's plain version, 1.5x
# on K2's, and the torch path.
ROWS = [("2x K1", (64, 96), (128, 192), 4, "kernel"), ("1.5x K2", (96, 144), (144, 216), 4, "kernel"),
        ("1.5x torch", (96, 144), (144, 216), 3, "torch")]


@pytest.mark.parametrize("case", ROWS, ids=[c[0] for c in ROWS])
def test_row_shards_match_jax(case):
    _, in_hw, out_hw, n, impl = case
    img = _rand(1, (2, 3, *in_hw))
    got = spatial.upscale_spatial_sharded(torch.from_numpy(img), out_hw, _mesh(n), impl=impl)
    assert got.spec == (None, None, "sp", None)
    want = jspatial.upscale_spatial_sharded(jnp.asarray(img), out_hw, _jmesh(n), axis="sp")
    _check_shards(got, want, _within(TORCH_TOL if impl == "torch" else KERNEL_TOL))


def test_drs_row_shards_match_jax():
    """A DRS viewport and offset (K2's plain version per strip) against
    JAX's unsharded DRS result, laid out as its sharded calls return."""
    img = _rand(2, (3, 96, 144))
    kw = dict(input_viewport=(92, 138), input_offset=(2, 3))
    got = spatial.upscale_spatial_sharded(torch.from_numpy(img), (132, 192), _mesh(4), impl="kernel", **kw)
    want = fsr_tpu.upscale(jnp.asarray(img), out_size=(132, 192), impl="xla", **kw)
    want = jax.device_put(want, NamedSharding(_jmesh(4), P(None, "sp", None)))
    _check_shards(got, want, _within(KERNEL_TOL))


def test_dp_by_sp_shards_match_jax():
    img = _rand(3, (4, 3, 32, 64))
    got = spatial.upscale_spatial_sharded(torch.from_numpy(img), (64, 128), _mesh(8, ("dp", "sp"), (2, 4)),
                                          axis="sp", batch_axis="dp", impl="torch")
    assert got.spec == ("dp", None, "sp", None) and len(got.shards) == 8
    want = jspatial.upscale_spatial_sharded(jnp.asarray(img), (64, 128), _jmesh(8, ("dp", "sp"), (2, 4)),
                                            axis="sp", batch_axis="dp")
    _check_shards(got, want, _within(TORCH_TOL))


@pytest.mark.parametrize("texture", [False, True], ids=["hash", "texture"])
def test_pipeline_after_pass_shards_match_jax(texture):
    """bf16 storage: the dither runs after the upscale, per strip on its
    device over its rows of the pattern; each shard against JAX's sharded
    after-pass on the same base, in the layout of the JAX pipeline's result."""
    in_hw, out_hw = (64, 96), (96, 144)
    img = _rand(4, (3, *in_hw))
    tex = _rand(5, (2, 20, 40)) if texture else None  # 20 rows: no strip starts on a page row 0
    mesh = _mesh(4)
    pipe = fsr_tpu_torch.UpscalePipeline(out_hw, dither_bits=10, compute_dtype=torch.bfloat16, mesh=mesh,
                                         dither_texture=tex)
    got = pipe(torch.from_numpy(img), frame=3)
    assert got.dtype == torch.float32 and got.spec == (None, "sp", None)
    base = spatial.upscale_spatial_sharded(torch.from_numpy(img), out_hw, mesh, compute_dtype=torch.bfloat16)
    jmesh = _jmesh(4)
    jpipe = fsr_tpu.UpscalePipeline(out_hw, dither_bits=10, compute_dtype=jnp.bfloat16, mesh=jmesh,
                                    dither_texture=None if tex is None else jnp.asarray(tex))
    layout = jpipe(jnp.asarray(img), frame=3).sharding
    dit = jx.texture_dither(out_hw, 3, jnp.asarray(tex)) if texture else jx.tepd_dither(out_hw, 3)
    want = jax.jit(lambda b: jx.tepd_quantize(b, dit, bits=10), out_shardings=layout)(
        jax.device_put(jnp.asarray(base.gather().float().numpy()), layout))
    _check_shards(got, want, _steps(10))


# --- a Sharded input ----------------------------------------------------------


def test_sharded_input_is_used_without_a_copy(monkeypatch):
    """A ``Sharded`` laid out as the call's spec gives the same shards as
    the tensor, and its own shards reach the strips and shares (the same
    tensors, no copy); a row-sharded input reaches the halo exchange as it
    is."""
    x = torch.from_numpy(_rand(6, (4, 3, 32, 48)))
    seen = []
    exchange = spatial._exchange_halo

    def spy(strips, halo):
        seen.append(list(strips))
        return exchange(strips, halo)

    monkeypatch.setattr(spatial, "_exchange_halo", spy)
    cases = [
        (_mesh(4), (None, None, "sp", None),
         lambda m, v: spatial.upscale_spatial_sharded(v, (64, 96), m, impl="kernel")),
        (_mesh(8, ("dp", "sp"), (2, 4)), ("dp", None, "sp", None),
         lambda m, v: spatial.upscale_spatial_sharded(v, (64, 96), m, batch_axis="dp", impl="kernel")),
        (_mesh(4), (None, None, "sp", None),
         lambda m, v: fsr_tpu_torch.UpscalePipeline((64, 96), dither_bits=8, out_dtype=torch.uint8, mesh=m)(
             v, frame=2)),
    ]
    for mesh, spec, call in cases:
        xs = Sharded.put(x, mesh, spec)
        seen.clear()
        got, want = call(mesh, xs), call(mesh, x)
        assert got.spec == want.spec == spec
        for a, b in zip(got.shards, want.shards):
            torch.testing.assert_close(a, b, atol=0, rtol=0)
        groups = len(xs.shards) // mesh.shape["sp"]
        assert all(s is t for s, t in zip(sum(seen[:groups], []), xs.shards))
    parts = []
    xs = sharding.shard_batch(x, _mesh(4, ("batch",)))
    out = sharding.map_shards(lambda k, part: parts.append(part) or part * 2, xs, xs.mesh)
    assert all(p is s for p, s in zip(parts, xs.shards)) and len(parts) == 4
    torch.testing.assert_close(out.gather(), x * 2, atol=0, rtol=0)
    got = sharding.upscale_batch_sharded(xs, xs.mesh, scale=2.0)
    torch.testing.assert_close(got.gather(), fsr_tpu_torch.upscale(x, scale=2.0), atol=0, rtol=0)


def test_mismatched_spec_raises():
    """A ``Sharded`` laid out other than the call's spec (or on another
    mesh) raises a ValueError naming both layouts."""
    x = torch.from_numpy(_rand(7, (4, 3, 32, 48)))
    rows, batch = _mesh(4), _mesh(4, ("batch",))
    dpsp = _mesh(8, ("dp", "sp"), (2, 4))
    by_rows = Sharded.put(x, rows, (None, None, "sp", None))
    by_batch = sharding.shard_batch(x, batch)
    want_rows, want_batch = r"\(None, None, 'sp', None\)", r"\('batch', None, None, None\)"
    with pytest.raises(ValueError, match=f"{want_batch}.*{want_rows}"):
        sharding.upscale_batch_sharded(by_rows, batch, scale=2.0)
    with pytest.raises(ValueError, match=f"{want_rows}.*{want_batch}"):
        spatial.upscale_spatial_sharded(by_batch, (64, 96), rows)
    with pytest.raises(ValueError, match=r"\('dp', None, 'sp', None\).*\(None, None, 'sp', None\)"):
        spatial.upscale_spatial_sharded(Sharded.put(x, dpsp, (None, None, "sp", None)), (64, 96), dpsp,
                                        batch_axis="dp")
    with pytest.raises(ValueError, match="on mesh"):  # the same spec on another mesh
        spatial.upscale_spatial_sharded(Sharded.put(x, _mesh(2), (None, None, "sp", None)), (64, 96), rows)
    with pytest.raises(ValueError, match=want_rows):
        fsr_tpu_torch.UpscalePipeline((64, 96), mesh=rows)(by_batch)
