"""ctypes binding for the native C++ SAH builder (bvh/cpp/builder.cpp, a
byte-identical copy of uvtrace/bvh/cpp/builder.cpp), the port of
uvtrace/bvh/native.py.

Compiled with g++ -O3 -march=native -fopenmp at first use into
build/uvtrace_torch/ beside the package (git-ignored), under a digest of
the source, the flags and the host's name (-march=native code may not run
on another machine that shares the checkout); the library is written to a
temporary file and moved into place, so processes that start together (the
ranks of a torch.distributed run) never load a half-written one.
`available()` is false only when g++ or the library cannot be built. Used for triangle clustering (every traversal of the port) and for
the fine BVH of the "jax" traversal, where it replaces the numpy builders at
~20-100x their speed on large scenes, the role of the reference's SSE/OpenMP
builder (bvh.cpp).

The builder hands out node ids with an atomic counter inside OpenMP tasks
(builder.cpp:203, tasks for ranges over 4096 triangles), so its node order
depends on how the tasks were scheduled and changes from build to build.
Each task partitions only its own range of `tri_idx` in place, so every
node's triangle range, and the tree itself, is the same in every build. The
outputs here are put in an order that depends on the tree alone: clusters by
the start of their range in `tri_idx` (the order of a sequential depth-first
build), fine BVH nodes level by level and, within a level, by that start.
Every rank of a multi-process run therefore builds the same slot layout, and
closest-hit ties (which break by the lowest slot) fall the same way in every
run.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from uvtrace_torch.utils import timing

_SRC = Path(__file__).resolve().parent / "cpp" / "builder.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "uvtrace_torch"
GXX_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC", "-std=c++17"]


def _library_path() -> Path:
    key = " ".join([*GXX_FLAGS, os.uname().nodename]).encode() + _SRC.read_bytes()
    digest = hashlib.sha256(key).hexdigest()[:16]
    return BUILD_DIR / f"libuvtrace_builder_{digest}.so"


@functools.cache
def _load() -> ctypes.CDLL:
    with timing.setup_span("setup.native_library") as s:
        lib_path = _library_path()
        built = not lib_path.exists()
        s.set(built=built)
        if built:
            timing.count("builds.native_library")
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)], check=True, capture_output=True)
                os.replace(tmp, lib_path)  # atomic: a concurrent loader sees all of it or nothing
            finally:
                tmp.unlink(missing_ok=True)
        lib = ctypes.CDLL(str(lib_path))
    lib.uvtrace_build.restype = ctypes.c_int32
    lib.uvtrace_build.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
    ]
    return lib


def available() -> bool:
    """Whether the native builder compiles and loads here."""
    try:
        _load()
        return True
    except (subprocess.CalledProcessError, OSError):
        return False


def _run(tris: np.ndarray, max_leaf: int, mode: int):
    lib = _load()
    tris = np.ascontiguousarray(tris, np.float32)
    if tris.ndim != 3 or tris.shape[1:] != (3, 3):
        raise ValueError(f"tris must be f32[T, 3, 3], got {tris.shape}")
    t = tris.shape[0]
    cap = 2 * t
    node_min = np.empty((cap, 3), np.float32)
    node_max = np.empty((cap, 3), np.float32)
    left_first = np.empty(cap, np.int32)
    tri_count = np.empty(cap, np.int32)
    tri_idx = np.empty(t, np.int32)
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    n = lib.uvtrace_build(
        tris.ctypes.data_as(fp), t, max_leaf, mode,
        node_min.ctypes.data_as(fp), node_max.ctypes.data_as(fp),
        left_first.ctypes.data_as(ip), tri_count.ctypes.data_as(ip), tri_idx.ctypes.data_as(ip),
    )
    if n < 0:
        raise RuntimeError("native builder failed")
    return node_min[:n], node_max[:n], left_first[:n], tri_count[:n], tri_idx


def _canonical_order(left_first: np.ndarray, tri_count: np.ndarray) -> np.ndarray:
    """The node ids in an order that depends on the tree alone: level by
    level from the root, by the start of each node's range in tri_idx within
    a level. Two siblings stay adjacent (their ranges are neighbours, and no
    other node of their level starts between them)."""
    levels = [np.zeros(1, np.int64)]
    while True:
        inner = levels[-1][tri_count[levels[-1]] == 0]
        if not inner.size:
            break
        c = left_first[inner].astype(np.int64)
        levels.append(np.stack([c, c + 1], 1).reshape(-1))
    start = np.where(tri_count > 0, left_first, 0).astype(np.int64)
    for nodes in reversed(levels):  # an inner node's range starts where its left child's does
        inner = nodes[tri_count[nodes] == 0]
        start[inner] = start[left_first[inner]]
    depth = np.empty(len(tri_count), np.int64)
    for d, nodes in enumerate(levels):
        depth[nodes] = d
    return np.lexsort((start, depth))


def build_bvh_native(tris: np.ndarray, max_leaf_size: int | None = None):
    """Native counterpart of bvh.builder.build_bvh -> FlatBVH, with its nodes
    in `_canonical_order`."""
    from uvtrace_torch.bvh.types import FlatBVH

    tris = np.ascontiguousarray(tris, np.float32)
    nm, nx, lf, tc, ti = _run(tris, max_leaf_size or 0, mode=0)
    order = _canonical_order(lf, tc)
    new_id = np.empty_like(order)
    new_id[order] = np.arange(len(order))
    lf, tc = lf[order], tc[order]
    lf = np.where(tc > 0, lf, new_id[lf]).astype(np.int32)
    return FlatBVH(node_min=nm[order], node_max=nx[order], left_first=lf, tri_count=tc, tri_idx=ti,
                   sorted_tris=tris[ti])


def build_clusters_native(tris: np.ndarray, cluster_size: int = 128):
    """Native counterpart of ops.cluster.build_clusters -> ClusteredScene,
    with the clusters in the order of their range's start in tri_idx."""
    from uvtrace_torch.ops.cluster import ClusteredScene

    tris = np.ascontiguousarray(tris, np.float32)
    nm, nx, lf, tc, ti = _run(tris, cluster_size, mode=1)
    leaves = np.nonzero(tc > 0)[0]
    leaves = leaves[np.argsort(lf[leaves], kind="stable")]
    l_count = len(leaves)
    out_tris = np.zeros((l_count, cluster_size, 3, 3), np.float32)
    out_idx = np.full((l_count, cluster_size), -1, np.int32)
    for i, node in enumerate(leaves):
        start, cnt = lf[node], tc[node]
        ids = ti[start : start + cnt]
        out_tris[i, :cnt] = tris[ids]
        out_idx[i, :cnt] = ids
    return ClusteredScene(tris=out_tris, box_min=nm[leaves].copy(), box_max=nx[leaves].copy(), tri_idx=out_idx)
