"""Seconds the process spent loading, and where needed compiling, the
port's two native libraries: its `setup.kernel_library` (nvcc, the CUDA
kernels) and `setup.native_library` (g++, the cluster builder) spans, which
the program records whether tracing is on or not. Part of setup_s."""

from benchmarks.harness import spans as program

NAMES = ("setup.kernel_library", "setup.native_library")


def read(run):
    spans = [s for s in program.recorded() or () if s.name in NAMES]
    return sum(program.ms(s) for s in spans) * 1e-3 if spans else None
