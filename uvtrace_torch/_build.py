"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled with nvcc into one shared library with a
plain C interface, loaded with ctypes. The library goes to
`build/uvtrace_torch/` beside the package (git-ignored), named by a hash of
the sources and flags, so a checkout builds once at first use and again only
when a source changes. Needs the CUDA toolkit (`nvcc` on PATH, or under
$CUDA_HOME/bin) and a Hopper card (sm_90a).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "uvtrace_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-fmad=false",  # no multiply-add contraction (see csrc/fused_trace.cu)
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
]
MAX_DYNAMIC_SMEM = 232448  # bytes of shared memory a block may opt into on sm_90


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH or set CUDA_HOME")
    return str(path)


def build() -> Path:
    """Compile the kernels if the cached library is missing; return its path.
    The build log (with ptxas' register and spill report) is kept beside it."""
    sources = sorted(SRC_DIR.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    lib = BUILD_DIR / f"libuvtrace_torch_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, sources)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all of it or nothing
    return lib


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures."""
    lib = ctypes.CDLL(str(build()))
    i32, u32, f32, ptr = ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p
    lib.fused_trace_smem_bytes.argtypes = [i32, i32, i32]
    lib.fused_trace_smem_bytes.restype = ctypes.c_size_t
    lib.fused_trace_launch.argtypes = [u32, u32, f32, f32, f32, f32] + [i32] * 7 + [ptr] * 9
    lib.fused_trace_launch.restype = i32
    return lib
