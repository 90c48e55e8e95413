"""ctypes binding to the native host layer (``fsr_tpu_torch/csrc/fsr_host.c``).

Counterpart of ``fsr_tpu/core/native.py``.  The reference's constant setup
is native C compiled into the host app (A_CPU path); this module exposes
the equivalent C implementation for C/C++ embedders and cross-checks.  The
port owns its copy of the source (byte-equal to the JAX package's
``csrc/fsr_host.c``) and builds it at first use with ``cc`` into
``fsr_tpu_torch/_build/host-<hash of the source and flags>/``, never into
the JAX package's tree.  ``load`` returns None only when there is no ``cc``
(the numpy constants in ``fsr_tpu_torch.core.constants`` are always
available and bit-identical); a failed build raises with the compiler's
output.  Host constant setup only: no device is involved.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Optional, Tuple

import numpy as np

__all__ = ["load", "available", "library_path", "build", "easu_con", "rcas_con", "f32_to_f16_bits"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "fsr_host.c"
CFLAGS = ("-O2", "-fPIC", "-Wall", "-Wextra", "-fvisibility=hidden")


def library_path() -> pathlib.Path:
    """Where ``load`` builds the library: a directory named by the hash of
    the source and the flags, so an edited source builds anew."""
    h = hashlib.sha256(SOURCE.read_bytes() + " ".join(CFLAGS).encode()).hexdigest()[:16]
    return _PKG / "_build" / f"host-{h}" / "libfsr_host.so"


def build(so: pathlib.Path) -> None:
    """Compile ``SOURCE`` into the shared library ``so`` (atomically: the
    library appears whole or not at all)."""
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=so.parent)
    os.close(fd)
    try:
        cmd = ["cc", *CFLAGS, "-shared", "-o", tmp, str(SOURCE), "-lm"]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
        if res.returncode != 0:
            raise RuntimeError(f"cc failed (exit {res.returncode}): {' '.join(cmd)}\n{res.stdout}{res.stderr}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


@functools.lru_cache(maxsize=None)
def load() -> Optional[ctypes.CDLL]:
    """The native library (built on first call), or None without ``cc``."""
    if shutil.which("cc") is None:
        return None
    so = library_path()
    if not so.exists():
        build(so)
    lib = ctypes.CDLL(str(so))
    u32p = ctypes.POINTER(ctypes.c_uint32)
    f = ctypes.c_float
    lib.fsr_easu_con.argtypes = [u32p] + [f] * 6
    lib.fsr_easu_con.restype = None
    lib.fsr_easu_con_offset.argtypes = [u32p] + [f] * 8
    lib.fsr_easu_con_offset.restype = None
    lib.fsr_rcas_con.argtypes = [u32p, f]
    lib.fsr_rcas_con.restype = None
    lib.fsr_f32_to_f16_bits.argtypes = [f]
    lib.fsr_f32_to_f16_bits.restype = ctypes.c_uint16
    return lib


def available() -> bool:
    return load() is not None


def _lib() -> ctypes.CDLL:
    lib = load()
    if lib is None:
        raise RuntimeError("native host library unavailable (no cc)")
    return lib


def easu_con(
    viewport: Tuple[float, float],
    input_size: Tuple[float, float],
    output_size: Tuple[float, float],
    input_offset: Tuple[float, float] = (0.0, 0.0),
) -> np.ndarray:
    """Native con0..con3 block (4x4 uint32), reference bit layout."""
    lib = _lib()
    con = (ctypes.c_uint32 * 16)()
    if input_offset == (0.0, 0.0):
        lib.fsr_easu_con(con, viewport[0], viewport[1],
                         input_size[0], input_size[1],
                         output_size[0], output_size[1])
    else:
        lib.fsr_easu_con_offset(con, viewport[0], viewport[1],
                                input_size[0], input_size[1],
                                output_size[0], output_size[1],
                                input_offset[0], input_offset[1])
    return np.ctypeslib.as_array(con).reshape(4, 4).copy()


def rcas_con(sharpness_stops: float) -> np.ndarray:
    lib = _lib()
    con = (ctypes.c_uint32 * 4)()
    lib.fsr_rcas_con(con, sharpness_stops)
    return np.ctypeslib.as_array(con).copy()


def f32_to_f16_bits(x: float) -> int:
    return int(_lib().fsr_f32_to_f16_bits(x))
