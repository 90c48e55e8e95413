"""Build and load the hand-written CUDA kernels (``fsr_tpu_torch/csrc/*.cu``).

The sources have a plain C interface and are compiled by ``nvcc`` into one
shared library, loaded with ``ctypes``.  The build happens at first use, into
``fsr_tpu_torch/_build/<hash of the sources and flags>/``, so a fresh
checkout builds everything the first time a kernel launches and reuses the
library afterwards.  A failed build raises with the compiler's output.

Nothing here runs at import: the CPU tests import every module on machines
with no ``nvcc``.
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

__all__ = ["library", "build_dir", "NVCC_FLAGS"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


def _sources():
    return sorted(p for p in _CSRC.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def build_dir() -> pathlib.Path:
    h = hashlib.sha256()
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    lib.fsr_edge_pad.argtypes = [vp, vp, i, i, ll, i, i, i, i, i, i, vp]
    lib.fsr_edge_pad.restype = i
    lib.fsr_upscale_fused.argtypes = [
        vp, vp, i, i, i, i, i, i, i, i, ip, ip, fp, fp, f, i, i, vp,
    ]
    lib.fsr_upscale_fused.restype = i


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built from the sources on first call."""
    out_dir = build_dir()
    so = out_dir / "libfsr_kernels.so"
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *(str(p) for p in _sources() if p.suffix == ".cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        (out_dir / "build.log").write_text(" ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed (exit {res.returncode}):\n{res.stdout}{res.stderr}"
            )
        os.replace(tmp, so)  # atomic: concurrent builders never see a partial file
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    return lib
