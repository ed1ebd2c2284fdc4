"""Multi-process execution (torch.distributed) and the rays x texels device
mesh: the port of uvtrace/parallel/multihost.py.

The reference is a single-process, single-GPU application; scale-out is a
deliverable of the new framework (BASELINE: ">= 85% efficiency at 2 hosts",
config 5: rays and texels sharded over many devices). Design:

- `initialize()` wraps torch.distributed.init_process_group. Call it once
  in every process before building a mesh. By default it reads torchrun's
  environment (env://); NCCL when the card is there, gloo on the CPU.
- the mesh spans every rank. The `rays` axis carries the embarrassingly
  parallel photon batch; the optional `texels` axis shards large texel dose
  maps (a 4K atlas is ~16M slots: each rank keeps n_texels / texel_shards
  of them, uvtrace_torch/parallel/sharded.py).
- one rank per device, on `cuda:LOCAL_RANK`. NCCL refuses two ranks on one
  card; such ranks run over gloo, and the collectives stage their CUDA
  tensors through the host (`sharded.Collectives`). The kernels still run on
  the card.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

RAY_AXIS = "rays"
TEXEL_AXIS = "texels"


def initialize(backend: Optional[str] = None, init_method: Optional[str] = None,
               world_size: Optional[int] = None, rank: Optional[int] = None) -> None:
    """torch.distributed.init_process_group, once per process.

    backend: None picks "nccl" when torch sees a CUDA device and "gloo"
    otherwise; ranks that share one card pass "gloo". init_method: None reads
    torchrun's environment (env://), except for an explicit world_size of 1
    without that environment, which gets a one-rank group on an in-memory
    store. A second call is a no-op. Any other failure raises: a process
    that went on alone would compute 1/N of the photons and say nothing."""
    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if init_method is None and world_size == 1 and "MASTER_ADDR" not in os.environ:
        dist.init_process_group(backend, store=dist.HashStore(), world_size=1, rank=0 if rank is None else rank)
        return
    kw = {k: v for k, v in (("world_size", world_size), ("rank", rank)) if v is not None}
    dist.init_process_group(backend, init_method=init_method or "env://", **kw)


def make_2d_mesh(ray_shards: Optional[int] = None, texel_shards: int = 1,
                 device_type: Optional[str] = None) -> DeviceMesh:
    """(rays, texels) mesh over every rank of the process group;
    texel_shards=1 gives the plain ray-parallel layout. ray_shards None: the
    world size over texel_shards. device_type None: "cuda" for an NCCL group,
    "cpu" for gloo (gloo groups then serve CUDA tensors through the host).

    For a CUDA mesh, init_device_mesh sets the current device of a process
    that has not touched CUDA yet to LOCAL_RANK (or rank % devices): one
    rank per card, as NCCL needs. A CPU mesh sets no device, so ranks that
    share one card over gloo stay where they are; the Simulator takes its
    device= explicitly in either case."""
    world = dist.get_world_size()
    if texel_shards < 1 or world % texel_shards:
        raise ValueError(f"texel_shards={texel_shards} must divide the world size {world}")
    if ray_shards is None:
        ray_shards = world // texel_shards
    if ray_shards * texel_shards != world:
        raise ValueError(f"a {ray_shards} x {texel_shards} mesh needs {ray_shards * texel_shards} ranks, "
                         f"the process group has {world}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (ray_shards, texel_shards), mesh_dim_names=(RAY_AXIS, TEXEL_AXIS))


def process_info() -> dict:
    """This process's rank, the world size, its local rank and the CUDA
    devices it sees."""
    return {
        "rank": dist.get_rank() if dist.is_initialized() else 0,
        "world_size": dist.get_world_size() if dist.is_initialized() else 1,
        "local_rank": int(os.environ.get("LOCAL_RANK", 0)),
        "local_devices": torch.cuda.device_count(),
    }
