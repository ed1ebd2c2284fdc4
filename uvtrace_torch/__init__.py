"""uvtrace_torch — the PyTorch/CUDA port of uvtrace for NVIDIA Hopper.

A second package beside `uvtrace/` (JAX, the reference). It mirrors
uvtrace's module names and imports torch and numpy, never jax. Every module
of uvtrace/ is ported: the direct-lighting dose path (stratified sampler,
fused generate + trace + histogram kernel in csrc/fused_trace.cu), the split
path (threefry uniforms, generate_stratified, the split trace kernel in
csrc/traverse_mxu.cu), the gen-1 packet DFS (csrc/traverse_pallas.cu),
diffuse bounces with Russian roulette, texel-resolution dose maps, the
top-down probe dose grid, dose accumulation and shading, the route loop of
the Simulator, checkpoints, the PNG/GLB exports, the rasterizer and the
texel atlas bake, the differentiable layer (`diff`: the dose estimator in
torch autograd, route optimization, the dose image), multi-device runs over
torch.distributed (`parallel`), the native C++ cluster builder
(`bvh/native.py`), the reference's plain-array traversals (the budgeted
clustered traversal and the fine-BVH walk, plain torch), the `info` /
`compute` / `calibrate` / `optimize-route` / `dose-image` / `render` /
`bench` CLI, the throughput benchmark (`bench.py`, the counterpart of the
repo root's bench.py) and the small forward step with the multi-device dry
run (`entry.py`, the counterpart of the root's __graft_entry__.py). The
kernels build on first use, never on import.
"""

__version__ = "0.1.0"

from uvtrace_torch.geometry.mesh import TriangleMesh
from uvtrace_torch.bvh.types import FlatBVH
from uvtrace_torch.sim.params import SimParams
