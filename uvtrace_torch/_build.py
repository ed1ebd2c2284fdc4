"""Build and load the port's CUDA kernels.

Every `csrc/*.cu` file is compiled by its own nvcc process, all started
together, and the objects are linked into one shared library with a plain C
interface, loaded with ctypes. The library goes to `build/uvtrace_torch/`
beside the package (git-ignored), named by a digest of the flags and of every
`csrc/*.cu` and `csrc/*.cuh` file, so a checkout builds once at first use and
again only when a source or a shared header changes. Needs the CUDA toolkit
(`nvcc` on PATH, or under $CUDA_HOME/bin) and a Hopper card (sm_90a).

Every kernel launch goes through `launch`, which counts it
(`launches.<entry point>`) and traces it as the span `kernel.<entry point>`,
with its ray count where the wrapper gives one
(uvtrace_torch/utils/timing.py).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from uvtrace_torch.utils import timing

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "uvtrace_torch"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
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


def source_digest(src_dir: Path = SRC_DIR) -> str:
    """Digest of the flags and of every .cu and .cuh file's name and bytes:
    the library's name, so that an edit to any source or header rebuilds."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*src_dir.glob("*.cu"), *src_dir.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return digest.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libuvtrace_torch_{source_digest()}.so"


def build() -> Path:
    """Compile the kernels if the cached library is missing; return its path.
    The build log (with ptxas' register and spill report) is kept beside it."""
    lib = library_path()
    if lib.exists():
        return lib
    timing.count("builds.kernel_library")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(SRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        jobs.append((cmd, obj, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    log, failed = [], []
    for cmd, _, proc in jobs:
        out, err = proc.communicate()
        log.append(" ".join(cmd) + "\n" + out + err)
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{err[-4000:]}")
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    if not failed:
        cmd = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
               *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stderr[-4000:]}")
    for _, obj, _ in jobs:
        obj.unlink(missing_ok=True)
    lib.with_suffix(".log").write_text("\n".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent loader sees all of it or nothing
    return lib


def ptr(x) -> ctypes.c_void_p:
    """A tensor's device address for a kernel's C entry point (null for None)."""
    return ctypes.c_void_p(0 if x is None else x.data_ptr())


def call(name: str, device, *args) -> int:
    """Call the kernel library's C entry point `name` with args and the
    current stream of `device` (a CUDA device); returns its CUDA error."""
    import torch

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        return getattr(load(), name)(*args, ctypes.c_void_p(stream))


def launch(name: str, device, *args, rays: int | None = None) -> None:
    """`call` the entry point `name` inside the span `kernel.<name>` (rays:
    the rays it traces, padding included, for the trace kernels); raise when
    it returns a CUDA error (a launch the card refused never runs and is not
    counted)."""
    span_name, launches = _COUNTER_NAMES[name]
    with timing.span(span_name, rays=rays):
        rc = call(name, device, *args)
    if rc:
        raise RuntimeError(f"{name} failed with CUDA error {rc}")
    timing.count(launches)


def check_elements(n: int) -> None:
    """Raise unless a sampler kernel can take n elements: it counts them in
    one 32-bit thread index."""
    if n >= 1 << 31:
        raise ValueError(f"{n} elements: a sampler kernel draws fewer than 2^31")


def check_tensor(name: str, x, dtype, shape, device):
    """Raise unless x is a contiguous tensor of this dtype, shape and device:
    a kernel reads its pointer with exactly that layout."""
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) or x.device != device or not x.is_contiguous():
        raise ValueError(f"{name}: expected contiguous {dtype}{list(shape)} on {device}, "
                         f"got {x.dtype}{list(x.shape)} on {x.device}")


_I32, _U32, _F32, _PTR = ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p
# the C entry points of csrc/*.cu: (argument types, result type); a launch
# entry point takes the stream last and returns cudaGetLastError()
SIGNATURES = {
    "fused_trace_smem_bytes": ([_I32, _I32], ctypes.c_size_t),
    "fused_trace_launch": ([_U32, _U32, _F32, _F32, _F32, _F32] + [_I32] * 7 + [_PTR] * 11, _I32),
    "traverse_mxu_launch": ([_PTR, _PTR] + [_I32] * 3 + [_PTR] * 8, _I32),
    "traverse_pallas_launch": ([_PTR, _PTR, _I32] + [_PTR] * 9, _I32),
    "threefry_uniform_launch": ([_U32, _U32, _F32, _F32, _U32, _PTR, _PTR], _I32),
    "generate_stratified_launch": ([_U32] * 11 + [_F32] * 4 + [_PTR] * 3, _I32),
    "generate_reference_launch": ([_U32, _U32] + [_F32] * 8 + [_I32] + [_PTR] * 3, _I32),
    "bounce_step_launch": ([_U32, _U32, _I32, _F32] + [_PTR] * 12, _I32),
    "hit_histogram_launch": ([_I32, _I32] + [_PTR] * 4, _I32),
    "texel_bin_launch": ([_I32, _I32] + [_PTR] * 12, _I32),
    "shadow_sample_launch": ([_U32, _U32] + [_I32] * 3 + [_PTR, _F32, _F32] + [_PTR] * 10, _I32),
    "pack_sorted_launch": ([_I32] * 3 + [_PTR] * 7, _I32),
    "visibility_reduce_launch": ([_I32] * 2 + [_F32] * 3 + [_PTR] * 7, _I32),
    "direct_grad_launch": ([_U32, _U32] + [_I32] * 3 + [_PTR] + [_F32] * 3 + [_PTR] * 9, _I32),
    "source_sample_launch": ([_U32] * 4 + [_I32] * 2 + [_PTR] * 9, _I32),
    "transfer_rays_launch": ([_U32] * 2 + [_I32] * 4 + [_PTR] * 11, _I32),
    "transfer_reduce_launch": ([_I32] * 2 + [_F32] * 2 + [_PTR] * 9, _I32),
    "transfer_grad_launch": ([_U32] * 2 + [_I32] * 4 + [_PTR] * 11, _I32),
}


# (span, launch counter) of each entry point, named once
_COUNTER_NAMES = {name: (f"kernel.{name}", f"launches.{name}") for name in SIGNATURES}


@functools.cache
def load() -> ctypes.CDLL:
    """The kernel library, built on first use, with its C signatures (the
    set-up span `setup.kernel_library`, `built` where it compiled)."""
    with timing.setup_span("setup.kernel_library") as s:
        s.set(built=not library_path().exists())
        lib = ctypes.CDLL(str(build()))
        for name, (argtypes, restype) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
    return lib
