"""An experiment, not a shipped path: the fused kernel's in-kernel generator
in front of the split kernel's per-ray tree walk, timed on an NVIDIA GPU.

    python3 scripts/torch_fused_on_walk.py                  # testroomopt and the 443k-triangle box room
    python3 scripts/torch_fused_on_walk.py --scene box192

The fused kernel B1 (csrc/fused_trace.cu) walks clusters per packet, exactly
(it visits while entry <= packet bound); the split kernel B2
(csrc/traverse_mxu.cu) walks a tree per ray under a visit rule that is sized
on adversarial rays, not proved. On scenes of many clusters the per-ray walk
is much the faster. This script builds, in the git-ignored build directory,
one translation unit that includes fused_trace.cu for its `stratum_cell` and
`generate_ray` and a copy of traverse_mxu.cu whose kernel generates its ray
instead of loading it (two text substitutions, checked), and times it against
B1 and against B2 on the same rays from memory (2^20 stratified rays, lamp at
(0, floor + 0.8, 0), 1 m rod, key fold_in(PRNGKey(0), 0); CUDA events over 10
launches after a warm-up). It prints one JSON line per scene with the three
times, how many rays' slots differ from B1's, and the card's name and power
limit. Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from uvtrace_torch import _build  # noqa: E402
from uvtrace_torch.geometry.gltf import load_glb  # noqa: E402
from uvtrace_torch.geometry.procedural import make_box_room  # noqa: E402
from uvtrace_torch.ops import rng  # noqa: E402
from uvtrace_torch.ops import traverse_mxu as tm  # noqa: E402
from uvtrace_torch.ops.cluster import build_clusters  # noqa: E402

SCENES = ("testroomopt", "box192")

LOAD_RAY = """    for (int c = 0; c < 3; ++c) {
      o[c] = orig[3 * (size_t)i + c];
      const float d = dir[3 * (size_t)i + c];
"""
GENERATE_RAY = """    float gen_oy, gen_d[3];
    {
      const int pid = i / packet, lane = i - pid * packet;
      generate_ray(stratum_cell(pid, gen.gh, gen.gy, gen.gphi), gen.key0, gen.key1, pid, packet, lane, gen.gh,
                   gen.gy, gen.gphi, gen.ly, gen.llen, gen_oy, gen_d);
    }
    const float gen_o[3] = {gen.lx, gen_oy, gen.lz};
    for (int c = 0; c < 3; ++c) {
      o[c] = gen_o[c];
      const float d = gen_d[c];
"""
GEN_ARGS = """
struct GenArgs {
  uint32_t key0, key1;
  float lx, ly, lz, llen;
  int gh, gy, gphi;
};
__constant__ GenArgs gen;
extern "C" int fused_walk_set_generator(uint32_t key0, uint32_t key1, float lx, float ly, float lz, float llen,
                                        int gh, int gy, int gphi) {
  const GenArgs a = {key0, key1, lx, ly, lz, llen, gh, gy, gphi};
  return (int)cudaMemcpyToSymbol(gen, &a, sizeof(a));
}
"""


def build_library() -> ctypes.CDLL:
    """The experiment's library: fused_trace.cu, then the walk with the
    generator in place of its ray loads, as namespace `fused_walk`."""
    walk = (_build.SRC_DIR / "traverse_mxu.cu").read_text()
    if walk.count(LOAD_RAY) != 1 or walk.count("traverse_mxu_launch") != 1:
        raise SystemExit("csrc/traverse_mxu.cu no longer has the lines this experiment replaces")
    walk = walk.replace(LOAD_RAY, GENERATE_RAY).replace("traverse_mxu_launch", "fused_walk_launch")
    out_dir = _build.BUILD_DIR / "fused_on_walk"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib = out_dir / "fused_on_walk.cu", out_dir / "libfused_on_walk.so"
    src.write_text(f'#include "fused_trace.cu"\n{GEN_ARGS}\nnamespace fused_walk {{\n{walk}\n}}\n')
    cmd = [_build._nvcc(), *[f for f in _build.NVCC_FLAGS if f not in ("-Xptxas", "-v")], "-shared",
           f"-I{_build.SRC_DIR}", "-o", str(lib), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit("nvcc failed:\n" + proc.stderr[-4000:])
    dll = ctypes.CDLL(str(lib))
    i32, u32, f32, ptr = ctypes.c_int, ctypes.c_uint32, ctypes.c_float, ctypes.c_void_p
    dll.fused_walk_set_generator.argtypes = [u32, u32, f32, f32, f32, f32, i32, i32, i32]
    dll.fused_walk_launch.argtypes = [ptr, ptr] + [i32] * 3 + [ptr] * 8
    return dll


def cuda_ms(fn, reps: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def measure(name: str, dll: ctypes.CDLL, card: str) -> dict:
    if name == "testroomopt":
        mesh = load_glb(os.path.join(ROOT, "assets", "testroomopt.glb"))
    else:
        mesh = make_box_room(subdivisions=192, clutter=96)
    scene = tm.build_mxu_scene(build_clusters(mesh.tris, cluster_size=128), device="cuda")
    n, packet = 1 << 20, tm.PACKET
    lamp = (0.0, float(mesh.floor_height + 0.8), 0.0)
    key = rng.fold_in(rng.PRNGKey(0), 0)
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
    _, g, (gh, gy, gphi) = tm._launch_shape(n, packet, 4)
    if dll.fused_walk_set_generator(k0, k1, *lamp, 1.0, gh, gy, gphi) != 0:
        raise SystemExit("cudaMemcpyToSymbol failed")
    t = torch.empty(n, dtype=torch.float32, device="cuda")
    slot = torch.empty(n, dtype=torch.int32, device="cuda")
    counts = torch.zeros(scene.tri_idx_flat.shape[0], dtype=torch.int32, device="cuda")
    tests = torch.zeros(g, dtype=torch.int32, device="cuda")
    ptr = _build.ptr

    def fused_on_walk():
        counts.zero_()
        tests.zero_()
        rc = dll.fused_walk_launch(None, None, n, packet, scene.cluster_size, ptr(scene.node_box),
                                   ptr(scene.node_meta), ptr(scene.tri_feat), ptr(t), ptr(slot), ptr(counts),
                                   ptr(tests), ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        if rc != 0:
            raise SystemExit(f"launch failed with CUDA error {rc}")

    fused_on_walk()
    b1_t, b1_slot, b1_counts, o, d = tm.fused_trace_counts(scene, key, lamp, 1.0, n, with_rays=True)
    torch.cuda.synchronize()
    differ = int((slot != b1_slot).sum())
    if differ > n // 1000 or int(counts.sum()) != int((slot >= 0).sum()):
        raise SystemExit(f"{name}: {differ} slots differ from the fused kernel's")
    return {
        "scene": name, "triangles": mesh.triangle_count, "clusters": scene.n_clusters,
        "b1_ms": cuda_ms(lambda: tm.fused_trace_counts(scene, key, lamp, 1.0, n)),
        "b2_counts_from_memory_ms": cuda_ms(lambda: tm.traverse_mxu_counts(scene, o, d)),
        "generator_on_walk_ms": cuda_ms(fused_on_walk),
        "slots_differ_from_b1": differ, "leaf_tests_per_ray": tests.sum().item() / n, "card": card,
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--scene", choices=SCENES, action="append")
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this script needs an NVIDIA GPU", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 and smi.stdout.strip() else "unknown"
    dll = build_library()
    for name in args.scene or SCENES:
        print(json.dumps(measure(name, dll, card)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
