"""Port plain-torch ops (easu, rcas, bilinear) against the JAX ops and the
numpy oracle.

f32: within 2e-6 of the JAX ops (XLA on the CPU may fuse and reassociate)
and within 2e-5 of the oracle (the tests/test_ops_vs_oracle.py contract).
bf16: the ops path accumulates in bf16 on both sides, but XLA may keep
excess precision inside a fusion, so the bound is statistical.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fsr_tpu.core.constants import EasuConstants as JEasu
from fsr_tpu.core.constants import RcasConstants as JRcas
from fsr_tpu.ops import easu as jeasu
from fsr_tpu.ops import rcas as jrcas

from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants
from fsr_tpu_torch.ops import easu as teasu
from fsr_tpu_torch.ops import rcas as trcas
from fsr_tpu_torch.reference import scalar as ref

JAX_TOL = 2e-6
ORACLE_TOL = 2e-5

SIZES = [
    ((54, 96), (108, 192)),    # 2.0x (performance)
    ((72, 128), (108, 192)),   # 1.5x (quality)
    ((64, 114), (108, 192)),   # ~1.7x (balanced, ragged ratio)
    ((84, 148), (108, 192)),   # ~1.3x (ultra quality, ragged ratio)
    ((108, 192), (108, 192)),  # 1.0x
    ((50, 50), (100, 100)),
]


def _cons(in_hw, out_hw):
    args = ((in_hw[1], in_hw[0]), None, (out_hw[1], out_hw[0]))
    return JEasu.create(*args), EasuConstants.create(*args)


def _img(rng, shape):
    return rng.uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("in_hw,out_hw", SIZES)
def test_easu_f32_matches_jax_and_oracle(in_hw, out_hw):
    img = _img(np.random.default_rng(0), (3, *in_hw))
    jc, tc = _cons(in_hw, out_hw)
    got = teasu.easu(torch.from_numpy(img), out_hw, tc).numpy()
    np.testing.assert_allclose(got, np.asarray(jeasu.easu(jnp.asarray(img), out_hw, jc)), atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(got, ref.easu_ref(img, out_hw, tc), atol=ORACLE_TOL, rtol=0)


def test_easu_batched_matches_jax():
    in_hw, out_hw = (32, 48), (64, 96)
    imgs = _img(np.random.default_rng(1), (2, 2, 3, *in_hw))
    jc, tc = _cons(in_hw, out_hw)
    got = teasu.easu(torch.from_numpy(imgs), out_hw, tc).numpy()
    assert got.shape == (2, 2, 3, *out_hw)
    np.testing.assert_allclose(got, np.asarray(jeasu.easu(jnp.asarray(imgs), out_hw, jc)), atol=JAX_TOL, rtol=0)


@pytest.mark.parametrize("border", ["clamp", "zero"])
@pytest.mark.parametrize("denoise", [False, True])
def test_rcas_matches_jax(border, denoise):
    img = _img(np.random.default_rng(2), (2, 4, 40, 64))  # batch, RGBA passthrough
    got = trcas.rcas(torch.from_numpy(img), RcasConstants(0.25), denoise=denoise, border=border).numpy()
    want = np.asarray(jrcas.rcas(jnp.asarray(img), JRcas(0.25), denoise=denoise, border=border))
    np.testing.assert_allclose(got, want, atol=JAX_TOL, rtol=0)
    np.testing.assert_array_equal(got[:, 3], img[:, 3])
    if border == "clamp":
        np.testing.assert_allclose(
            got[0], ref.rcas_ref(img[0], RcasConstants(0.25), denoise=denoise), atol=ORACLE_TOL, rtol=0)


@pytest.mark.parametrize("dy,dx", [(-1, 0), (1, 0), (0, -1), (0, 1), (2, -3)])
@pytest.mark.parametrize("border", ["clamp", "zero"])
def test_shift_clamped_bit_equal(dy, dx, border):
    img = _img(np.random.default_rng(3), (3, 7, 11))
    got = trcas.shift_clamped(torch.from_numpy(img), dy, dx, border).numpy()
    np.testing.assert_array_equal(got, np.asarray(jrcas.shift_clamped(jnp.asarray(img), dy, dx, border)))


def test_rcas_isolated_pixel_matches_oracle():
    img = np.zeros((3, 9, 9), np.float32)
    img[:, 4, 4] = 0.5
    got = trcas.rcas(torch.from_numpy(img), RcasConstants(0.0)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref.rcas_ref(img, RcasConstants(0.0)), atol=ORACLE_TOL, rtol=0)
    np.testing.assert_allclose(got, np.asarray(jrcas.rcas(jnp.asarray(img), JRcas(0.0))), atol=JAX_TOL, rtol=0)


def test_bilinear_matches_jax_and_oracle():
    in_hw, out_hw = (30, 44), (63, 88)
    img = _img(np.random.default_rng(4), (3, *in_hw))
    jc, tc = _cons(in_hw, out_hw)
    got = teasu.bilinear(torch.from_numpy(img), out_hw, tc).numpy()
    np.testing.assert_allclose(got, np.asarray(jeasu.bilinear(jnp.asarray(img), out_hw, jc)), atol=JAX_TOL, rtol=0)
    np.testing.assert_allclose(got, ref.bilinear_ref(img, out_hw, tc), atol=1e-5, rtol=0)


def test_bf16_ops_path_matches_jax():
    """torch rounds every bf16 op, as JAX does op by op; jitted XLA keeps
    excess precision inside fusions.  So the port is bit-equal to JAX's
    bf16 ops path run op by op, and its median/p99 distance to the f32
    oracle is within 10% of the jitted path's."""
    import jax

    in_hw, out_hw = (27, 48), (54, 96)
    img = _img(np.random.default_rng(5), (3, *in_hw))
    jc, tc = _cons(in_hw, out_hw)

    def jax_path():
        out = jrcas.rcas(jeasu.easu(jnp.asarray(img), out_hw, jc, compute_dtype=jnp.bfloat16),
                         JRcas(0.25), compute_dtype=jnp.bfloat16)
        return np.asarray(out.astype(jnp.float32))

    jitted = jax_path()
    with jax.disable_jit():
        op_by_op = jax_path()
    got = trcas.rcas(teasu.easu(torch.from_numpy(img), out_hw, tc, compute_dtype=torch.bfloat16),
                     RcasConstants(0.25), compute_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_array_equal(got, op_by_op)
    oracle = ref.rcas_ref(ref.easu_ref(img, out_hw, tc), RcasConstants(0.25))
    d_got, d_jax = np.abs(got - oracle), np.abs(jitted - oracle)
    assert np.median(d_got) <= 1.1 * np.median(d_jax)
    assert np.percentile(d_got, 99) <= 1.1 * np.percentile(d_jax, 99)
