"""Build and load the hand-written CUDA kernels of ``csrc/``.

The kernels have a plain C interface and are compiled by ``nvcc`` into a
shared library for ``sm_90a`` (Hopper), loaded with ``ctypes``: no PyTorch
headers, so a build takes seconds. Each source compiles in its own
``nvcc`` process, all started together, and one more links them. The
library is built at first use into
``build/pyrayhf_tpu_torch/`` beside the package (a directory git ignores),
keyed by a hash of the sources and flags, so a changed source rebuilds
and an unchanged one loads at once. Nothing here runs at import time.

Flags: no fast math (IEEE division and square root, which the O-mode
quotient near reflection needs) and ``-fmad=false``, so each expression
rounds as the plain PyTorch version's does.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["build", "load", "find_nvcc", "error_string", "build_log",
           "MAX_SMEM_BYTES"]

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / \
    "pyrayhf_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v")
# dynamic shared memory one block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448

_lock = threading.Lock()
_lib = None


def find_nvcc():
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix. Raises if none exists."""
    cands = [Path(os.environ[v]) / "bin" / "nvcc"
             for v in ("CUDA_HOME", "CUDA_PATH") if os.environ.get(v)]
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file() and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels cannot be built")


def _sources():
    return sorted(SRC_DIR.glob("*.cu"))


def _library_path():
    h = hashlib.sha256()
    for src in sorted(SRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS + ARCH_FLAGS).encode())
    return BUILD_DIR / f"libpyrayhf_kernels_{h.hexdigest()[:16]}.so"


def build():
    """Compile ``csrc/*.cu`` unless an up-to-date library exists.

    Returns (library path, seconds spent compiling, 0 when cached). The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library, see :func:`build_log`.
    """
    so = _library_path()
    if so.exists():
        return so, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    t0 = time.perf_counter()
    jobs = []                       # one compile per source, in parallel
    for src in _sources():
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [str(nvcc), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, errors = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            errors.append(f"{cmd[-1]}: exit code {proc.returncode}:\n"
                          f"{err[-6000:]}")
    if not errors:
        cmd = [str(nvcc), *ARCH_FLAGS, "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        r = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + r.stdout + r.stderr)
        if r.returncode != 0:
            errors.append(f"link: exit code {r.returncode}:\n"
                          f"{r.stderr[-6000:]}")
    dt = time.perf_counter() - t0
    so.with_suffix(".log").write_text("".join(log))
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    if errors:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    os.replace(tmp, so)
    return so, dt


def build_log():
    """The compiler output of the current library's build ('' if none)."""
    log = _library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load():
    """The loaded kernel library (built at first use), with typed entries."""
    global _lib
    with _lock:
        if _lib is None:
            so, _ = build()
            lib = ctypes.CDLL(str(so))
            i, p, d = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
            lib.pyrayhf_ionogram.argtypes = [
                i, i, i, i,            # dtype, mode, solve, uniform
                p, i, i, i, i,         # tab, C, B, N, ld
                p, p, p, i,            # mult, omm, dmult, P
                p, i, i, i, i,         # freq, F, n_groups, warps, per_block
                p, p, p, p,            # span, slope, emax, valid
                p, d, p, p]            # alt_min, inv_dalt, out, stream
            lib.pyrayhf_ionogram.restype = ctypes.c_int
            # dtype, mode, solve, uniform, C, N, ld, warps
            lib.pyrayhf_ionogram_blocks_per_sm.argtypes = [i] * 8
            lib.pyrayhf_ionogram_blocks_per_sm.restype = ctypes.c_int
            lib.pyrayhf_ionogram_mxu.argtypes = [
                i, i, p, i, i, i,      # dtype, mode, tab, B, N, K1
                p, p, p, i,            # mult, omm, dmult, P
                p, i, i, i,            # freq, F, f_group, warps
                p, p, p, p,            # span, slope, emax, valid
                p, d, p, p]            # alt_min, inv_dalt, out, stream
            lib.pyrayhf_ionogram_mxu.restype = ctypes.c_int
            lib.pyrayhf_fan2d.argtypes = [
                i, i, i,               # dtype, spherical, shared memory
                p, i, i, i,            # tab, F, nz, nx
                p, p, i, i, i,         # va0, vb0, E, n_steps, max_bounces
                ctypes.POINTER(d),     # 16 scalars (see csrc/fan2d.cu)
                p, i, p]               # out, block, stream
            lib.pyrayhf_fan2d.restype = ctypes.c_int
            q = ctypes.c_longlong
            lib.pyrayhf_segment_table.argtypes = [
                i, p, q, p, q, p, q,   # dtype, den, bmag, bpsi, row strides
                p, i, i, i, i,         # alt, B, N, C, ld
                p, p]                  # tab, stream
            lib.pyrayhf_segment_table.restype = ctypes.c_int
            lib.pyrayhf_fan_tables.argtypes = [
                i, i, p, p, p, p, p,   # dtype, X, ne, babs, bpsi, nu, f0s
                i, i, i,               # F, nz, nx
                ctypes.POINTER(d),     # 13 scalars (see csrc/fan_tables.cu)
                p, p, p]               # flag, tab, stream
            lib.pyrayhf_fan_tables.restype = ctypes.c_int
            lib.pyrayhf_error_string.argtypes = [ctypes.c_int]
            lib.pyrayhf_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def error_string(err):
    """CUDA's name for error code ``err``."""
    return load().pyrayhf_error_string(int(err)).decode()
