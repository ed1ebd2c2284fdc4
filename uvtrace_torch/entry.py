"""Entry points of the port: a small forward step and a multi-device dry run,
the counterpart of the repo root's __graft_entry__.py (which imports jax).

    python -m uvtrace_torch.entry              # on the card
    python -m uvtrace_torch.entry --device cpu

entry(): one forward step of the flagship pipeline (generate -> trace ->
histogram -> dose accumulate) on a small procedural room, with example
arguments.

dryrun_multichip(n): one step of each product multi-device path
(Simulator(device_mesh=...) -> sharded_launch_fn -> launch_counts) on n
ranks, each printing a [dryrun] line naming the path it ran.
"""

from __future__ import annotations

import argparse

N_RAYS = 2048


def _make_scene():
    from uvtrace_torch.geometry.procedural import make_box_room
    from uvtrace_torch.ops.cluster import build_clusters

    room = make_box_room(subdivisions=3, clutter=2, seed=0)
    return room, build_clusters(room.tris, cluster_size=128)


def entry(device="cuda"):
    """(step, example_args): step(scene, photon_map, max_photon_map, key,
    lamp_xyz, duration) -> (photon_map, max_photon_map) traces N_RAYS
    stratified rays from the key and accumulates their hits.

    On "cuda" the step is the flagship path: generate_stratified ->
    traverse_mxu_slots (the split kernel, csrc/traverse_mxu.cu) -> slot-space
    counts -> slots_to_tri -> accumulate_dose. On the CPU it is the
    budget-free clustered traversal (the budget equals the cluster count, so
    no cluster is ever dropped) in triangle space, as the reference's CPU
    branch."""
    import torch

    from uvtrace_torch.device import resolve
    from uvtrace_torch.ops import accumulate as acc_ops
    from uvtrace_torch.ops import rng
    from uvtrace_torch.ops import traverse_clustered as tc
    from uvtrace_torch.ops import traverse_mxu as tm
    from uvtrace_torch.ops.generate import generate_stratified

    dev = resolve(device)
    room, cs = _make_scene()
    t_count = room.triangle_count
    on_card = dev.type == "cuda"
    if on_card:
        scene = tm.build_mxu_scene(cs, device=dev)
        n_bins = int(scene.tri_idx_flat.shape[0])

        def extend(scene, o, d):
            return tm.traverse_mxu_slots(scene, o, d)
    else:
        scene = tc.cluster_arrays(cs, device=dev)
        n_clusters = scene.n_clusters
        n_bins = t_count

        def extend(scene, o, d):
            return tc.traverse_clustered(scene, o, d, max_clusters=n_clusters)

    def step(scene, photon_map, max_photon_map, key, lamp_xyz, duration):
        rays = generate_stratified(key, N_RAYS, lamp_xyz, 1.0, packet=1024, device=dev)
        _, hit = extend(scene, rays.orig, rays.dir)
        counts = acc_ops.hit_counts(hit, n_bins, "segment")
        if on_card:
            counts = acc_ops.slots_to_tri(counts, scene.tri_idx_flat, t_count)
        return acc_ops.accumulate_dose(photon_map, max_photon_map, counts, duration)

    example_args = (
        scene,
        torch.zeros(t_count, dtype=torch.float32, device=dev),
        torch.zeros(t_count, dtype=torch.float32, device=dev),
        rng.PRNGKey(0),
        (0.0, room.floor_height + 0.8, 0.0),
        60.0,
    )
    return step, example_args


def _dryrun_sections(rank: int, world: int, device: str, share_cards: bool) -> list[str]:
    """The dry run's sections on this rank of a `world`-rank group; returns
    their [dryrun] lines. Raises RuntimeError when a section computes an
    empty or wrongly sharded map."""
    import torch

    from uvtrace_torch.io.routexml import LightPos
    from uvtrace_torch.parallel import make_2d_mesh, make_ray_mesh
    from uvtrace_torch.sim import SimParams, Simulator

    if device == "cpu":
        dev = torch.device("cpu")
    else:
        dev = torch.device("cuda", rank % torch.cuda.device_count() if share_cards else rank)
    mesh_type = "cpu" if device == "cpu" or share_cards else "cuda"
    room, _ = _make_scene()
    lines = []

    # 1) bounce + texel atlas through the chunked launch, one all_reduce per launch
    params = SimParams(photon_count=world * 2048, max_iterations=1, max_bounces=1, reflectance=0.3,
                       texel_density=4.0)
    sim = Simulator(room, params, route=[LightPos(0.0, 0.0, 60.0)], ray_chunk=1024,
                    device_mesh=make_ray_mesh(world, device_type=mesh_type), device=dev)
    sim.run_iteration()
    if not (float(sim.photon_map.sum()) > 0.0 and float(sim.photon_map_tex.sum()) > 0.0):
        raise RuntimeError("dry run, bounce + texel launch: an empty triangle or texel map")
    lines.append(f"[dryrun] ok: product Simulator(device_mesh=rays:{world}) bounce+texel launch "
                 "(sharded_launch_fn -> launch_counts)")

    # 2) the split kernel on every rank (its plain version on the CPU)
    params2 = SimParams(photon_count=world * 1024, max_iterations=1, traversal="mxu")
    sim2 = Simulator(room, params2, route=[LightPos(0.2, 0.1, 30.0)], ray_chunk=1024,
                     device_mesh=make_ray_mesh(world, device_type=mesh_type), device=dev)
    sim2.run_iteration()
    if not float(sim2.photon_map.sum()) > 0.0:
        raise RuntimeError("dry run, traversal mxu: an empty triangle map")
    what = "its plain version" if dev.type == "cpu" else "the CUDA kernel csrc/traverse_mxu.cu"
    lines.append(f"[dryrun] ok: product Simulator(device_mesh=rays:{world}) split trace per rank, "
                 f"{what} (traverse_mxu_counts)")

    # 3) a 2-D (rays x texels) mesh, config 5's layout: each rank keeps only
    #    its own range of the texel slots
    if world >= 2 and world % 2 == 0:
        texel_shards = 2
        mesh2 = make_2d_mesh(ray_shards=world // texel_shards, texel_shards=texel_shards, device_type=mesh_type)
        params3 = SimParams(photon_count=world * 1024, max_iterations=1, texel_density=4.0)
        sim3 = Simulator(room, params3, route=[LightPos(0.0, 0.0, 30.0)], ray_chunk=1024, device_mesh=mesh2,
                         device=dev)
        sim3.run_iteration()
        own = sim3.photon_map_tex.shape[0]
        if own != sim3._n_texels // texel_shards:
            raise RuntimeError(f"dry run, rays x texels mesh: rank {rank} holds {own} texel slots, "
                               f"not {sim3._n_texels // texel_shards}")
        if not float(sim3.full_texel_map(sim3.photon_map_tex).sum()) > 0.0:
            raise RuntimeError("dry run, rays x texels mesh: an empty texel map")
        lines.append(f"[dryrun] ok: product Simulator(device_mesh=rays:{world // texel_shards} x "
                     f"texels:{texel_shards}) — texel map sharded over 'texels' via reduce_scatter, "
                     f"{own} of {sim3._n_texels} slots a rank")
    return lines


def dryrun_multichip(n_devices: int, device="cuda", share_cards: bool = False) -> None:
    """Runs the product multi-device path in three sections and prints a
    [dryrun] line for each: (1) one bounce + texel launch on a 1-D `rays`
    mesh, (2) traversal="mxu" on every rank (the split kernel on a card, its
    plain version on the CPU), (3) for an even n_devices >= 2, a rays x
    texels mesh of (n/2) x 2 on which every rank keeps exactly half the
    texel slots.

    Inside a process group of n_devices ranks (torchrun), it runs on this
    rank, rank 0 printing. Otherwise it spawns n_devices ranks: NCCL with
    rank r on cuda:r ("cuda"; at most the card count, else ValueError), or
    gloo on the CPU (device="cpu"). share_cards=True (on "cuda") spawns gloo
    ranks on cuda:(r % cards) instead, so that ranks can share one card (NCCL
    refuses that); their collectives stage through the host."""
    import torch
    import torch.distributed as dist

    from uvtrace_torch.device import resolve
    from uvtrace_torch.parallel import spawn

    dev_type = resolve(device).type
    if dist.is_initialized():
        if dist.get_world_size() != n_devices:
            raise ValueError(f"dryrun_multichip({n_devices}) in a process group of {dist.get_world_size()} ranks")
        lines = _dryrun_sections(dist.get_rank(), n_devices, dev_type, share_cards)
        if dist.get_rank() == 0:
            print("\n".join(lines), flush=True)
        return
    if dev_type == "cuda" and not share_cards and n_devices > torch.cuda.device_count():
        raise ValueError(f"dryrun_multichip({n_devices}) on cuda needs {n_devices} cards (one NCCL rank a card), "
                         f"torch sees {torch.cuda.device_count()}: pass device='cpu' for gloo ranks on the CPU, "
                         "or share_cards=True")
    backend = "nccl" if dev_type == "cuda" and not share_cards else "gloo"
    lines = spawn(_dryrun_sections, n_devices, backend, (dev_type, share_cards), timeout=900.0)[0]
    print("\n".join(lines), flush=True)


if __name__ == "__main__":
    import torch

    p = argparse.ArgumentParser(description="the port's entry step and multi-device dry run")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args()
    fn, example = entry(args.device)
    out = fn(*example)
    if args.device == "cuda":
        torch.cuda.synchronize()
    print("entry OK:", float(out[0].sum()))
    dryrun_multichip(min(8, torch.cuda.device_count()) if args.device == "cuda" else 8, device=args.device)
    print("dryrun_multichip OK")
