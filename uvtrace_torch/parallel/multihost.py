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
- `spawn()` starts the ranks itself, for callers outside torchrun (the
  bench's --scaling rows, the entry points' dry run).
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
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


def _rank_main(fn, rank: int, world: int, backend: str, init: str, args: tuple, results):
    """One spawned rank: joins the group, runs fn, reports (rank, traceback
    or None, value) and leaves the group."""
    try:
        if backend == "nccl":
            torch.cuda.set_device(rank)  # one card a rank
        else:
            torch.set_num_threads(1)  # as torchrun's OMP_NUM_THREADS=1
        initialize(backend, init, world, rank)
        results.put((rank, None, fn(rank, world, *args)))
    except BaseException:
        results.put((rank, traceback.format_exc(), None))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, backend: str, args: tuple = (), timeout: float = 1800.0) -> list:
    """fn(rank, world, *args) on `world` spawned processes that form one
    `backend` process group ("nccl": rank r on cuda:r; "gloo": CPU ranks, or
    ranks that share cards) through a file:// store in a temporary directory;
    returns the ranks' values by rank. fn must be importable (a module-level
    function). A rank that raises, or ranks that outlive `timeout` seconds,
    raise RuntimeError, and every rank still running is killed."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="uvtrace_torch_ranks_") as tmp:
        init = f"file://{os.path.join(tmp, 'store')}"
        procs = [ctx.Process(target=_rank_main, args=(fn, rank, world, backend, init, args, results), daemon=True)
                 for rank in range(world)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        out = [None] * world
        pending, exited = set(range(world)), {}
        try:
            while pending:
                try:
                    rank, err, value = results.get(timeout=1.0)
                except queue.Empty:
                    # a rank that exited without a result (killed, or a spawn
                    # that could not start) fails the call, once its last
                    # message has had time to arrive
                    now = time.monotonic()
                    for r in pending:
                        if procs[r].exitcode is not None:
                            exited.setdefault(r, now)
                    late = [r for r, t in exited.items() if r in pending and now - t > 5.0]
                    if late:
                        raise RuntimeError(f"rank {late[0]} of {world} exited with code "
                                           f"{procs[late[0]].exitcode} without a result") from None
                    if time.monotonic() > deadline:
                        raise RuntimeError(f"{world} {backend} ranks did not finish within {timeout:.0f} s") from None
                    continue
                if err is not None:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n{err}")
                out[rank] = value
                pending.discard(rank)
        finally:
            for p in procs:
                p.join(timeout=max(1.0, min(60.0, deadline - time.monotonic())))
                if p.is_alive():
                    p.kill()
                    p.join()
    return out
