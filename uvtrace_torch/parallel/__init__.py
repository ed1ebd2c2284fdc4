from uvtrace_torch.parallel.multihost import initialize, make_2d_mesh, process_info, spawn
from uvtrace_torch.parallel.sharded import (
    RAY_AXIS,
    TEXEL_AXIS,
    Collectives,
    make_ray_mesh,
    mesh_shape,
    sharded_launch_fn,
)
