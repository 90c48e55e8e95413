"""The port's native C host layer (``fsr_tpu_torch/core/native.py``) against
its numpy constants, as tests/test_native.py holds the JAX package's; the
port's copy of the C source byte-equal to the JAX package's; the library
built under ``fsr_tpu_torch/_build/``, never in the JAX package's tree."""

import pathlib
import shutil

import numpy as np
import pytest

from fsr_tpu_torch.core import native
from fsr_tpu_torch.core.constants import EasuConstants, RcasConstants

pytestmark = pytest.mark.skipif(shutil.which("cc") is None, reason="no C toolchain")

ROOT = pathlib.Path(__file__).resolve().parents[1]

CONFIGS = [
    (960, 540, 960, 540, 1920, 1080),
    (1920, 1080, 1920, 1080, 3840, 2160),
    (2954, 1662, 2954, 1662, 3840, 2160),
    (1280, 720, 1920, 1080, 2560, 1440),
]


@pytest.mark.parametrize("cfg", CONFIGS)
def test_native_easu_con_bit_parity(cfg):
    vw, vh, iw, ih, ow, oh = cfg
    got = native.easu_con((vw, vh), (iw, ih), (ow, oh))
    want = EasuConstants.create((vw, vh), (iw, ih), (ow, oh)).as_uint4()
    np.testing.assert_array_equal(got, want)


def test_native_easu_con_offset():
    got = native.easu_con((1280, 720), (1920, 1080), (2560, 1440), (64.0, 32.0))
    want = EasuConstants.create((1280, 720), (1920, 1080), (2560, 1440), (64, 32)).as_uint4()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("sharp", [0.0, 0.125, 0.25, 0.5, 1.0, 2.0])
def test_native_rcas_con_bit_parity(sharp):
    got = native.rcas_con(sharp)
    want = RcasConstants(sharp).as_uint4()
    np.testing.assert_array_equal(got, want)


def test_native_f16_packing_exhaustive():
    # Full sweep over interesting values incl. denormals and rounding ties.
    rng = np.random.default_rng(0)
    vals = np.concatenate([
        rng.uniform(-2, 2, 2000).astype(np.float32),
        rng.uniform(-70000, 70000, 500).astype(np.float32),
        np.array([0.0, -0.0, 1.0, 65504.0, 65520.0, 1e-8, 5.96e-8, 6.1e-5],
                 np.float32),
    ])
    for v in vals:
        got = native.f32_to_f16_bits(float(v))
        want = int(np.float16(np.float32(v)).view(np.uint16))
        assert got == want, (v, hex(got), hex(want))


def test_port_source_is_the_jax_packages():
    assert native.SOURCE.read_bytes() == (ROOT / "csrc" / "fsr_host.c").read_bytes()


def test_library_lands_in_the_ports_build_tree():
    assert native.available()
    so = native.library_path()
    assert so.exists()
    assert so.parent.parent == ROOT / "fsr_tpu_torch" / "_build"
    assert so.parent.name.startswith("host-")


def test_build_leaves_the_jax_tree_alone(tmp_path):
    jax_lib = ROOT / "csrc" / "libfsr_host.so"
    before = jax_lib.read_bytes() if jax_lib.exists() else None
    so = tmp_path / "host" / "libfsr_host.so"
    native.build(so)
    assert so.exists() and list(so.parent.iterdir()) == [so]
    # tests/test_native.py may build the JAX library meanwhile; one that
    # was there must be as it was.
    if before is not None:
        assert jax_lib.read_bytes() == before
