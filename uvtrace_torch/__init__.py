"""uvtrace_torch — the PyTorch/CUDA port of uvtrace for NVIDIA Hopper.

A second package beside `uvtrace/` (JAX, the reference). It mirrors
uvtrace's module names and imports torch and numpy, never jax. Ported so far:
the direct-lighting dose path (stratified sampler, fused generate + trace +
histogram kernel in csrc/fused_trace.cu), the split path (threefry uniforms,
generate_stratified, the split trace kernel in csrc/traverse_mxu.cu), diffuse
bounces with Russian roulette, texel-resolution dose maps, the top-down
probe dose grid, dose accumulation and shading, the route loop of the
Simulator, checkpoints, the PNG/GLB exports, the rasterizer and the texel
atlas bake, the differentiable layer (`diff`: the dose estimator in torch
autograd, route optimization, the dose image), and the `info` / `compute` /
`calibrate` / `optimize-route` / `dose-image` / `render` CLI.
ROADMAP.md lists what is still to port.
"""

__version__ = "0.1.0"
