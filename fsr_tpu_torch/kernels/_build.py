"""Build and load the hand-written CUDA kernels (``fsr_tpu_torch/csrc/*.cu``).

The sources have a plain C interface.  ``nvcc`` compiles each ``.cu`` file
to an object, all of them at once in parallel processes, then links them
into one shared library, loaded with ``ctypes``.  The ``.cuh`` headers are
hashed with the sources.  The build happens at first use, into
``fsr_tpu_torch/_build/<hash of the sources and flags>/``, so a fresh
checkout builds everything the first time a kernel launches and reuses the
library afterwards.  A failed build raises with the compiler's output.
``load`` builds another source directory or with more flags the same way
(the measurement tools build a parent commit's kernels and variants beside
these); ``library`` is the package's own, loaded once per process under the
set-up span ``fsr.library``.

The ablation tools build variants with one ``-D`` macro of
``ABLATION_MACROS`` each: a stage of K1 or K2 knocked out, the output wrong
by design.  ``NVCC_FLAGS`` defines none, and the library's
``fsr_ablation_mask()`` reports, one bit per macro in that order, which a
library was built with (``ablation_mask``).

Nothing here runs at import: the CPU tests import every module on machines
with no ``nvcc``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

from fsr_tpu_torch.utils import profiling

__all__ = ["library", "load", "library_path", "build_dir", "cuda_tool", "ablation_mask", "source_seconds",
           "NVCC_FLAGS", "ABLATION_MACROS", "SECONDS_LINE"]

_PKG = pathlib.Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD_ROOT = _PKG / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

# The stage knockouts (csrc/fsr_pixel.cuh:ABLATION_MASK), bit k of the mask
# for ABLATION_MACROS[k].
ABLATION_MACROS = (
    "FSR_ABL_K1_SET", "FSR_ABL_K1_NORM", "FSR_ABL_K1_WEIGHTS", "FSR_ABL_K1_POLY", "FSR_ABL_K1_DERING",
    "FSR_ABL_RCASLIMIT", "FSR_ABL_K2_NOG", "FSR_ABL_K2_WEIGHTS", "FSR_ABL_K2_STAGEONLY",
)


# build.log's last line: each .cu source's nvcc wall seconds, slowest first.
SECONDS_LINE = "nvcc seconds per source: "


def source_seconds(build: pathlib.Path) -> str:
    """The per-source seconds that build directory ``build``'s log records
    (empty for a library built before they were recorded)."""
    log = (build / "build.log").read_text().splitlines() if (build / "build.log").exists() else []
    return next((line[len(SECONDS_LINE):] for line in log if line.startswith(SECONDS_LINE)), "")


def _sources(csrc: pathlib.Path = _CSRC, skip=()):
    return sorted(p for p in csrc.iterdir() if p.suffix in (".cu", ".cuh") and p.name not in skip)


def cuda_tool(name: str) -> str:
    """The path of the CUDA toolkit's program ``name`` (nvcc, cuobjdump)."""
    found = shutil.which(name)
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found (set CUDA_HOME or put {name} on PATH)")


def build_dir(csrc: pathlib.Path = _CSRC, flags=NVCC_FLAGS, skip=()) -> pathlib.Path:
    h = hashlib.sha256()
    for p in _sources(csrc, skip):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    h.update(" ".join(flags).encode())
    return _BUILD_ROOT / h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, i, ll, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
    ip, fp = ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float)
    lib.fsr_edge_pad.argtypes = [vp, vp, i, i, ll, i, i, i, i, i, i, vp]
    lib.fsr_edge_pad.restype = i
    lib.fsr_upscale_fused.argtypes = [
        vp, vp, i, i, i, i, i, i, i, i, i, i, i, ip, ip, fp, fp, f, i, i, i, i, i, i, vp, vp,
    ]
    lib.fsr_upscale_fused.restype = i
    lib.fsr_easu_gather.argtypes = [
        vp, vp, i, i, i, i, i, i, i, i, i, vp, vp, vp, vp, f, i, i, i, vp, vp,
    ]
    lib.fsr_easu_gather.restype = i
    lib.fsr_rcas.argtypes = [vp, vp, i, i, i, i, i, f, i, i, vp]
    lib.fsr_rcas.restype = i
    replay = [vp, vp, i, i, i, i, i, i, ip, ip, fp, fp, f]
    lib.fsr_opmix_replay.argtypes = replay + [i, i, i, i, vp]
    lib.fsr_opmix_replay.restype = i
    lib.fsr_opmix_replay_shared.argtypes = replay + [ip, i, i, i, vp]
    lib.fsr_opmix_replay_shared.restype = i
    lib.fsr_fma_rate.argtypes = [vp, vp, i, i, i, i, f, fp, vp]
    lib.fsr_fma_rate.restype = i
    lib.fsr_fp16_probe.argtypes = [vp, vp, ll, i, vp]
    lib.fsr_fp16_probe.restype = i
    # Sources from before the strip-source form or peer access (a parent
    # commit's, kernel_ab.py) have neither.
    if hasattr(lib, "fsr_upscale_fused_strip"):
        lib.fsr_upscale_fused_strip.argtypes = list(lib.fsr_upscale_fused.argtypes)
        lib.fsr_upscale_fused_strip.restype = i
        lib.fsr_easu_gather_strip.argtypes = list(lib.fsr_easu_gather.argtypes)
        lib.fsr_easu_gather_strip.restype = i
    if hasattr(lib, "fsr_enable_peer"):
        lib.fsr_enable_peer.argtypes = [i, i]
        lib.fsr_enable_peer.restype = i
    # Sources from before K6 (a parent commit's, kernel_ab.py) have no
    # float16 upscale.
    if hasattr(lib, "fsr_easu_h"):
        lib.fsr_easu_h.argtypes = [vp, vp, i, i, i, i, i, i, i, vp, vp, vp, vp, f, i, i, vp]
        lib.fsr_easu_h.restype = i
    # K6's strip-source form (sources before it have none).
    if hasattr(lib, "fsr_easu_h_strip"):
        lib.fsr_easu_h_strip.argtypes = list(lib.fsr_easu_h.argtypes)
        lib.fsr_easu_h_strip.restype = i
    # K6 with the frame tail, whole frames and strips (sources before it
    # have neither).
    tail = [vp, vp, i, i, i, i, i, i, i, i, vp, vp, vp, vp, f, i, i, i, ll, vp, vp]
    for name in ("fsr_easu_h_tail", "fsr_easu_h_tail_strip"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = tail
            getattr(lib, name).restype = i
    # K6's reciprocal over every half pattern (a test entry; sources before
    # the paired K6 have none).
    if hasattr(lib, "fsr_easu_h_rcp_check"):
        lib.fsr_easu_h_rcp_check.argtypes = [vp, vp]
        lib.fsr_easu_h_rcp_check.restype = i
    # Sources from before the knockouts (a parent commit's, kernel_ab.py)
    # export no mask.
    if hasattr(lib, "fsr_ablation_mask"):
        lib.fsr_ablation_mask.argtypes = []
        lib.fsr_ablation_mask.restype = i


def _nvcc(cmd):
    """Run one nvcc command; (its result, its wall seconds)."""
    t0 = time.perf_counter()
    res = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return res, time.perf_counter() - t0


def _compile(out_dir: pathlib.Path, so: pathlib.Path, csrc: pathlib.Path, flags, skip) -> None:
    """One nvcc per .cu source, all started together, then one link.  Objects
    go to a private scratch directory, so concurrent builders never share a
    file; the library appears at ``so`` atomically.  ``build.log`` holds
    each command's output and, last, each source's wall seconds
    (``SECONDS_LINE``, the slowest first: the build's critical path)."""
    nvcc = cuda_tool("nvcc")
    work = pathlib.Path(tempfile.mkdtemp(dir=out_dir))
    try:
        jobs = []
        for src in (p for p in _sources(csrc, skip) if p.suffix == ".cu"):
            obj = work / (src.stem + ".o")
            jobs.append(([nvcc, *flags, "-c", "-o", str(obj), str(src)], obj))
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            done = list(pool.map(_nvcc, [cmd for cmd, _ in jobs]))
        log, failed = [], []
        for (cmd, _), (res, _) in zip(jobs, done):
            log.append(" ".join(cmd) + "\n" + res.stdout)
            if res.returncode != 0:
                failed.append(f"{cmd[-1]} (exit {res.returncode}):\n{res.stdout}")
        seconds = sorted(((sec, pathlib.Path(cmd[-1]).name) for (cmd, _), (_, sec) in zip(jobs, done)), reverse=True)
        if not failed:
            lib = work / "lib.so"
            cmd = [nvcc, "-shared", *flags[:2], "-o", str(lib), *(str(o) for _, o in jobs)]
            res = subprocess.run(cmd, capture_output=True, text=True)
            log.append(" ".join(cmd) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(f"link (exit {res.returncode}):\n{res.stdout}{res.stderr}")
            else:
                os.replace(lib, so)
        log.append(SECONDS_LINE + ", ".join(f"{name} {sec:.1f}" for sec, name in seconds))
        (out_dir / "build.log").write_text("\n".join(log))
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def library_path(csrc: pathlib.Path = _CSRC, flags=NVCC_FLAGS, skip=()) -> pathlib.Path:
    """Where ``load`` builds the shared library of ``csrc`` under ``flags``."""
    return build_dir(csrc, flags, skip) / "libfsr_kernels.so"


def load(csrc: pathlib.Path = _CSRC, flags=NVCC_FLAGS, skip=()) -> ctypes.CDLL:
    """The shared library of the sources in ``csrc`` (a directory with this
    package's C interface) compiled with ``flags``, built on first call.
    ``skip``: names of ``.cu`` sources left out (their entry points then
    missing; the measurement tools' variants leave out what they never
    launch, and build faster)."""
    so = library_path(csrc, flags, skip)
    out_dir = so.parent
    if not so.exists():
        out_dir.mkdir(parents=True, exist_ok=True)
        _compile(out_dir, so, csrc, tuple(flags), tuple(skip))
    lib = ctypes.CDLL(str(so))
    _declare(lib)
    return lib


def ablation_mask(lib: ctypes.CDLL) -> frozenset:
    """The ``ABLATION_MACROS`` that ``lib`` was built with (none for the
    production build)."""
    mask = lib.fsr_ablation_mask()
    return frozenset(m for k, m in enumerate(ABLATION_MACROS) if mask >> k & 1)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The kernels' shared library, built from the package's sources on
    first call; recorded as the set-up span ``fsr.library`` with the count
    ``built`` (1 where this call built it, ``utils/profiling.py``)."""
    with profiling.trace_annotation("fsr.library", always=True) as span:
        span.args = {"built": int(not library_path().exists())}
        return load()
