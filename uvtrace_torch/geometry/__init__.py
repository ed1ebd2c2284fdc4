from uvtrace_torch.geometry.mesh import TriangleMesh
from uvtrace_torch.geometry.gltf import load_glb
from uvtrace_torch.geometry.procedural import make_box_room
