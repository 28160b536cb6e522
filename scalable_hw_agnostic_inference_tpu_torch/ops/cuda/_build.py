"""Build the port's CUDA kernels and load them through ``ctypes``.

No JAX counterpart: the JAX package's kernels compile inside ``jax.jit``.
Here every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` per source, all started together), linked into ONE shared library
with a plain C interface, and loaded with ``ctypes`` — no PyTorch headers,
so a build takes seconds, not minutes.

The build happens at first use, never at import (the CPU tests import every
module of the port). It lands in ``ops/cuda/.build/<key>/``, a directory
``.gitignore`` lists, keyed on a hash of the sources, the flags and the
``nvcc`` path, so an edited source rebuilds and an unchanged one loads the
library already built. A file lock keeps two processes from building at
once.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import List, Optional

PACKAGE_ROOT = Path(__file__).resolve().parents[2]
CSRC = PACKAGE_ROOT / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / ".build"
LIB_NAME = "libshai_kernels.so"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
                              "-Xptxas=-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

#: C entry points: name -> argtypes (every one returns a cudaError_t as int)
ENTRY_POINTS = {
    # q, k, v, lengths, out, B, T, S, H, Hkv, D, scale, causal, device, stream
    "shai_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                             _I, _I, _P],
    # q, k_pool, v_pool, k_scale, v_scale, tables, lengths, out, part_o,
    # part_ml, counters, rows, rows_per_table, rows_per_tile, H, Hkv, D, bs,
    # M, quantized, splits, scale, device, stream (B2 and B3 both)
    "shai_ragged_paged_attention": [_P] * 11 + [_I] * 10 + [_F, _I, _P],
    # the same pointers, then groups (host int32 [n_groups, 3]), n_groups,
    # rows, rows_per_tile, dec_splits, H, Hkv, D, bs, M, n_tables,
    # quantized, scale, device, stream (B3 over row groups)
    "shai_ragged_paged_attention_groups": [_P] * 12 + [_I] * 11
    + [_F, _I, _P],
    # x, wq, scale, y, part, counters, M, N, K, ctas, row_tiles, device,
    # stream (W8A16, decode and wide)
    "shai_int8_matmul": [_P] * 6 + [_I] * 6 + [_P],
}

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()
_count_lock = threading.Lock()
#: seconds the last build took (0.0 when the library was already built)
last_build_seconds = 0.0


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, then ``/usr/local/cuda/bin/nvcc``, then
    ``nvcc`` on ``PATH``."""
    candidates = []
    cuda_home = os.environ.get("CUDA_HOME")
    if cuda_home:
        candidates.append(Path(cuda_home) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file() and os.access(c, os.X_OK):
            return str(c)
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, /usr/local/cuda/bin, PATH): the "
        "port's CUDA kernels are built from source at first use")


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def build_key(nvcc: str) -> str:
    h = hashlib.sha256()
    h.update(nvcc.encode())
    h.update("\0".join(COMPILE_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run_all(cmds: List[List[str]], log: Path) -> None:
    """Start every command at once, wait for all, raise on any failure with
    the compiler's output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    with open(log, "a") as f:
        for c, out in zip(cmds, outputs):
            f.write("$ " + " ".join(c) + "\n" + out + "\n")
    failed = [(c, p.returncode, out)
              for c, p, out in zip(cmds, procs, outputs) if p.returncode]
    if failed:
        c, rc, out = failed[0]
        raise RuntimeError(f"nvcc failed (exit {rc}): {' '.join(c)}\n{out}")


def build() -> Path:
    """Compile the kernels unless a library for these sources exists;
    return the library's path."""
    global last_build_seconds
    nvcc = find_nvcc()
    out_dir = BUILD_ROOT / build_key(nvcc)
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with open(BUILD_ROOT / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if lib.is_file():  # another process built it while we waited
                return lib
            t0 = time.monotonic()
            tmp = Path(tempfile.mkdtemp(dir=BUILD_ROOT, prefix=".tmp-"))
            log = tmp / "build.log"
            objs = [tmp / (src.stem + ".o") for src in sources()]
            _run_all([[nvcc, *COMPILE_FLAGS, "-c", str(src), "-o", str(obj)]
                      for src, obj in zip(sources(), objs)], log)
            _run_all([[nvcc, *ARCH_FLAGS, "-shared", "-o",
                       str(tmp / LIB_NAME), *map(str, objs)]], log)
            if out_dir.exists():
                shutil.rmtree(out_dir)
            tmp.rename(out_dir)
            last_build_seconds = time.monotonic() - t0
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return lib


def build_log() -> str:
    """The compiler's output of the library in use (``-Xptxas=-v`` lists
    each kernel's registers, shared memory and spills)."""
    log = BUILD_ROOT / build_key(find_nvcc()) / "build.log"
    return log.read_text() if log.is_file() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.shai_cuda_error_string.argtypes = [ctypes.c_int]
            lib.shai_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(err: int, what: str) -> None:
    """Raise when a C entry point reports a CUDA error."""
    if err:
        msg = library().shai_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def count(wrapper, attr: str = "launches") -> None:
    """Add one to a kernel wrapper's launch counter, under a lock: the
    ranks of one model may run as threads (``parallel.loopback``), and
    ``+=`` on an attribute is not atomic across threads."""
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
