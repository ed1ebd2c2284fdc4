from uvtrace_torch.bvh.types import FlatBVH
from uvtrace_torch.bvh.builder import build_bvh
