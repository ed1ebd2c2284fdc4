"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests skip themselves where there is no NVIDIA GPU. The file imports no
JAX, so on a machine without JAX it runs alone:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.io.routexml import LightPos
from uvtrace_torch.ops import rng
from uvtrace_torch.ops import traverse_mxu as tm
from uvtrace_torch.ops import traverse_pallas as tp
from uvtrace_torch.ops.bounce import bounce_rays, coherence_sort
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.ops.generate import (generate_reference, generate_reference_reference, generate_stratified,
                                         generate_stratified_reference)
from uvtrace_torch.sim import SimParams, Simulator
from uvtrace_torch.utils import timing

PACKET = 1024


def launched(entry: str) -> int:
    """Launches of the C entry point `entry` counted so far."""
    return timing.counters()[f"launches.{entry}"]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


def _check_fused_kernel(scene, lamp, n, packet, closed=True):
    """fused_trace_counts against its plain version: equal rays (both
    generated in f32 on the card, no contraction); slots and t (rtol 1e-5)
    equal but on ties, edge flips and grazing rays of the f32 sums taken in
    another order (<= 0.1% of rays; a differing slot still has t within rtol
    1e-5); counts and cluster visits equal within the number of disagreeing
    rays."""
    before = launched("fused_trace_launch")
    k = tm.fused_trace_counts(scene, rng.PRNGKey(4), lamp, 1.0, n, packet=packet,
                              with_rays=True, with_visits=True)
    assert launched("fused_trace_launch") == before + 1
    p = tm.fused_trace_counts_reference(scene, rng.PRNGKey(4), lamp, 1.0, n, packet=packet,
                                        with_rays=True, with_visits=True)
    torch.cuda.synchronize()
    kt, ks, kc, ko, kd, kv = (x.cpu().numpy() for x in k)
    pt, ps, pc, po, pd, pv = (x.cpu().numpy() for x in p)
    np.testing.assert_array_equal(ko, po)
    np.testing.assert_array_equal(kd, pd)
    mism = int((ks != ps).sum())
    t_rel = np.abs(kt - pt) / np.abs(pt)
    # grazing rays (t_den cancelling) may disagree in t like a flip does
    disagree = int(((ks != ps) | (t_rel > 1e-5)).sum())
    assert disagree <= n // 1000
    assert (t_rel[ks != ps] <= 1e-5).all()
    assert kc.sum() == (ks >= 0).sum() and pc.sum() == (ps >= 0).sum()
    if closed:
        assert kc.sum() == pc.sum() == n
    assert np.abs(kc.astype(np.int64) - pc).sum() <= 2 * mism
    assert np.abs(kv.astype(np.int64) - pv).sum() <= disagree


@pytest.mark.cuda
@pytest.mark.parametrize("c_sz,packet", [(64, 1024), (128, 2048), (128, 384)])
def test_kernel_matches_plain(c_sz, packet):
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=c_sz), device="cuda")
    lamp = (0.1, room.floor_height + 0.8, -0.2)
    _check_fused_kernel(scene, lamp, 8 * PACKET if packet != 384 else 8 * 384, packet)


@pytest.mark.cuda
@pytest.mark.parametrize("c_sz,packet", [(32, 128), (64, 128), (128, 128), (32, 256), (128, 256), (32, 1024),
                                         (128, 1024), (64, 4096)])
def test_kernel_keeps_its_rays_in_registers_at_every_block_size(c_sz, packet):
    """A block is packet / 4 threads, each with 4 rays in registers: from one
    warp (128 rays) to 1024 threads (4096 rays), at tiles of 32, 64 and 128
    triangles."""
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=c_sz), device="cuda")
    _check_fused_kernel(scene, (0.1, room.floor_height + 0.8, -0.2), 8 * packet, packet)


@pytest.mark.cuda
def test_kernel_runs_a_scene_whose_rays_no_longer_fit_shared_memory():
    """4,624 clusters of 8 triangles at 4096-ray packets: with the rays'
    features and keys in shared memory (48 B a ray, as the kernel was first
    built) a block needed more than the 232,448 bytes it may have; with the
    rays in registers it needs two tiles and 8 B a cluster. A packet of 4224
    rays is more than a block of 1024 threads holds, and raises."""
    _need_cuda()
    scene = tm.build_mxu_scene(_floor_tiles(68), device="cuda")
    l_count = scene.n_clusters
    assert 8 * (4096 + l_count + 32) + 4 * (10 * 4096 + 40 * 8 + 32) > 232448
    _check_fused_kernel(scene, (1.7, 1.0, 1.7), 4 * 4096, 4096, closed=False)
    before = launched("fused_trace_launch")
    with pytest.raises(ValueError, match="4096"):
        tm.fused_trace_counts(scene, rng.PRNGKey(0), (1.7, 1.0, 1.7), 1.0, 2 * 4224, packet=4224)
    assert launched("fused_trace_launch") == before


@pytest.mark.cuda
def test_simulator_on_cuda_launches_the_kernel():
    """The Simulator's main path goes through the kernel: one launch per
    chunk, and the same dose as the CPU Simulator within the flip bound."""
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    params = SimParams(photon_count=3 * 2500, max_iterations=2)
    route = [LightPos(0.0, 0.0, 1.0), LightPos(1.0, -1.5, 2.0), LightPos(-1.2, 2.0, 0.5)]
    maps = {}
    for dev in ("cuda", "cpu"):
        sim = Simulator(room, params, route=list(route), ray_chunk=1024, device=dev)
        before = launched("fused_trace_launch")
        sim.compute()
        if dev == "cuda":
            # 2 iterations x 3 waypoints x 3 chunks of 1024 (2500 rounds up to 3072)
            assert launched("fused_trace_launch") - before == 2 * 3 * 3
        maps[dev] = sim.photon_map.cpu().numpy()
    assert np.abs(maps["cuda"] - maps["cpu"]).sum() <= 2 * 2.0 * 1e-3 * 2 * 3 * 3072


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    _need_cuda()
    room = make_box_room(subdivisions=2, clutter=0, seed=0)
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=64), device="cuda")
    bad = scene._replace(tri_feat=scene.tri_feat.double())
    with pytest.raises(ValueError):
        tm.fused_trace_counts(bad, rng.PRNGKey(0), (0.0, 0.0, 0.0), 1.0, PACKET)
    with pytest.raises(ValueError):
        tm.fused_trace_counts(scene, rng.PRNGKey(0), (0.0, 0.0, 0.0), 1.0, 1000)


def _rays(kind: str, room, scene, n: int):
    """f32[n, 3] origins and directions on the card: stratified primaries,
    incoherent rays (random origins inside the room, uniform directions), or
    first-bounce rays (rho 0.3, coherence-sorted: parked dead lanes at the
    end, all-dead packets among them)."""
    lamp = (0.1, room.floor_height + 0.8, -0.2)
    if kind == "incoherent":
        g = np.random.default_rng(7)
        lo, hi = room.tris.reshape(-1, 3).min(0), room.tris.reshape(-1, 3).max(0)
        o = (lo + (hi - lo) * g.uniform(0.05, 0.95, (n, 3))).astype(np.float32)
        d = g.normal(size=(n, 3))
        d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
        return torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    rays = generate_stratified(rng.PRNGKey(5), n, lamp, 1.0, device="cuda")
    if kind == "stratified":
        return rays.orig, rays.dir
    t, slot = tm.traverse_mxu_padded_reference(scene, rays.orig, rays.dir)
    normals = torch.from_numpy(room.normals).cuda()[scene.tri_idx_flat.clamp_min(0).long()]
    rho = torch.full((scene.tri_idx_flat.shape[0],), 0.3, device="cuda")
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    o, d, alive = bounce_rays(rng.PRNGKey(9), rays.orig, rays.dir, t, slot, normals, rho, alive)
    o, d, _ = coherence_sort(o, d, alive)
    return o, d


def _assert_kernel_agrees(k, p, n):
    """Slots and t (rtol 1e-5) equal but for ties, edge flips and grazing
    rays (<= 0.1% of rays, a differing slot still with t within rtol 1e-5);
    returns (slot mismatches, disagreeing rays)."""
    kt, ks, pt, ps = (x.cpu().numpy() for x in (k[0], k[1], p[0], p[1]))
    same = ks == ps
    both = (ks >= 0) & (ps >= 0)
    t_rel = np.where(both, np.abs(kt - pt) / np.abs(pt), 0.0)
    disagree = int((~same | (t_rel > 1e-5)).sum())
    assert disagree <= max(1, n // 1000), disagree
    assert (t_rel[~same] <= 1e-5).all() and (kt[~both & same] == pt[~both & same]).all()
    return int((~same).sum()), disagree


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stratified", "incoherent", "parked"])
@pytest.mark.parametrize("packet", [1024, 4096, 384])
def test_split_kernel_matches_plain(kind, packet):
    """Kernel B2 against its plain version in both modes: slots, and counts
    (equal within twice the slot mismatches); then bit for bit: the kernel's
    per-triangle FMA chain is the plain matmul's and its slab test and visit
    rule are the plain walk's op for op, so t, slots, counts and the (ray,
    leaf) and (ray, triangle) tests per packet are equal; an all-dead packet
    tests nothing."""
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=64), device="cuda")
    n = 3 * 4096
    o, d = _rays(kind, room, scene, n)
    before = launched("traverse_mxu_launch")
    k = tm.traverse_mxu_padded(scene, o, d, packet=packet, with_counts=True, with_visits=True)
    ks_only = tm.traverse_mxu_slots(scene, o, d, packet=packet)
    assert launched("traverse_mxu_launch") == before + 2
    p = tm.traverse_mxu_padded_reference(scene, o, d, packet=packet, with_counts=True, with_visits=True)
    torch.cuda.synchronize()
    assert torch.equal(k[0], ks_only[0]) and torch.equal(k[1], ks_only[1])
    mism, _ = _assert_kernel_agrees(k, p, n)
    kc, pc = k[2].cpu().numpy().astype(np.int64), p[2].cpu().numpy()
    assert kc.sum() == int((k[1] >= 0).sum()) and np.abs(kc - pc).sum() <= 2 * mism
    kv = k[3].cpu().numpy()
    assert kv.shape == (n // packet,) and k[3].dtype == torch.int32
    assert all(torch.equal(a, b) for a, b in zip(k, p))  # bit_equal
    if kind == "parked":
        dead = (o.view(-1, packet, 3) == 1e6).all(2).all(1).cpu().numpy()
        assert dead.any() and (kv[dead] == 0).all()


@pytest.mark.cuda
def test_config2_simulator_on_cuda_launches_the_split_kernel():
    """A 4-bounce Simulator on the card runs B2 once per chunk for the
    primaries and once per bounce segment, and deposits what the CPU run
    deposits within 5% (depth >= 2 re-pairs roulette draws after an ulp-level
    ray flip, so the comparison is statistical)."""
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    params = SimParams(photon_count=4096, max_iterations=1, max_bounces=4, reflectance=0.5, seed=2)
    totals = {}
    for dev in ("cuda", "cpu"):
        sim = Simulator(room, params, route=[LightPos(0.0, 0.0, 1.0)], ray_chunk=1024, device=dev)
        before = (launched("traverse_mxu_launch"), launched("fused_trace_launch"))
        sim.compute()
        if dev == "cuda":
            assert launched("traverse_mxu_launch") - before[0] == 4 * (1 + 4)
            assert launched("fused_trace_launch") == before[1]
        totals[dev] = float(sim.photon_map.sum())
    assert totals["cuda"] > 4096 and abs(totals["cuda"] - totals["cpu"]) <= 0.05 * totals["cpu"]


@pytest.mark.cuda
def test_dose_grid_on_cuda_matches_cpu():
    """The probe grid through B2 equals the CPU grid from the same dose map,
    except on probes whose first hit is a tie."""
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    params = SimParams(photon_count=4096, max_iterations=1, traversal="mxu")
    grids = {}
    for dev in ("cpu", "cuda"):
        sim = Simulator(room, params, route=[LightPos(0.0, 0.0, 1.0)], ray_chunk=1024, device=dev)
        if dev == "cuda":
            sim.photon_map = cpu_map.cuda()
            sim.photon_map_size = 4096
        else:
            sim.compute()
            cpu_map = sim.photon_map
        grids[dev] = sim.dose_grid(res=64)
    assert (grids["cuda"] != grids["cpu"]).mean() <= 0.01 and (grids["cuda"] > 0).mean() > 0.5


@pytest.mark.cuda
def test_split_kernel_raises_on_a_tree_deeper_than_its_stack():
    """The per-ray stack holds STACK_DEPTH nodes: a deeper walk tree raises
    with the numbers, it does not run or fall back; wrong layouts raise."""
    _need_cuda()
    room = make_box_room(subdivisions=2, clutter=0, seed=0)
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=64), device="cuda")
    o = torch.zeros(PACKET, 3, device="cuda")
    before = launched("traverse_mxu_launch")
    with pytest.raises(ValueError, match="stack"):
        tm.traverse_mxu_slots(scene._replace(walk_depth=tm.STACK_DEPTH + 1), o, o)
    with pytest.raises(ValueError):
        tm.traverse_mxu_slots(scene._replace(leaf_feat=scene.leaf_feat.double()), o, o)
    assert launched("traverse_mxu_launch") == before


@pytest.mark.cuda
def test_split_kernel_nan_ray_misses_alone():
    """A NaN ray misses every box (NaN-propagating min/max in the slab test)
    and makes no leaf test; its warp's other rays get what they get alone."""
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=64), device="cuda")
    o, d = _rays("incoherent", room, scene, PACKET)
    t, slot = tm.traverse_mxu_slots(scene, o, d)
    o2 = o.clone()
    o2[5, 1] = float("nan")
    t2, slot2, visits, _ = tm.traverse_mxu_padded(scene, o2, d, with_visits=True)
    visits_ok = tm.traverse_mxu_padded(scene, o, d, with_visits=True)[2]
    keep = torch.arange(PACKET, device="cuda") != 5
    assert int(slot2[5]) == -1 and float(t2[5]) == float(torch.tensor(tm.BIG))
    assert torch.equal(t2[keep], t[keep]) and torch.equal(slot2[keep], slot[keep])
    assert 0 < int(visits[0]) < int(visits_ok[0])


def _floor_tiles(side: int, c_sz: int = 8, h: float = 0.05):
    """A ClusteredScene of side^2 clusters, each a 2 x 2-quad floor tile of 8
    triangles, h metres wide."""
    from uvtrace_torch.ops.cluster import ClusteredScene

    i, j = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    x0, z0 = i.reshape(-1) * h, j.reshape(-1) * h
    tris = []
    for a in range(2):
        for b in range(2):
            def p(u, v):
                return np.stack([x0 + (a + u) * h / 2, np.zeros_like(x0), z0 + (b + v) * h / 2], -1)
            tris += [np.stack([p(0, 0), p(1, 0), p(1, 1)], 1), np.stack([p(0, 0), p(1, 1), p(0, 1)], 1)]
    tris = np.stack(tris, 1).astype(np.float32)
    flat = tris.reshape(tris.shape[0], -1, 3)
    return ClusteredScene(tris=tris, box_min=flat.min(1), box_max=flat.max(1),
                          tri_idx=np.arange(tris.shape[0] * c_sz, dtype=np.int32).reshape(-1, c_sz))


@pytest.mark.cuda
def test_split_kernel_runs_a_scene_past_the_old_shared_memory_limit():
    """25,600 clusters of 8 triangles at 4096-ray packets: the packet kernel
    this one replaced needed 8 B of shared memory per cluster and per ray and
    raised past 232,448 bytes (about 24,750 clusters here). The tree walk
    keeps nothing per cluster in shared memory: it runs and equals its plain
    version bit for bit."""
    _need_cuda()
    scene = tm.build_mxu_scene(_floor_tiles(160), device="cuda")
    assert 8 * (4096 + scene.n_clusters + 32) + 4 * (40 * 8 + 32) > 232448
    g = np.random.default_rng(3)
    n = 2 * 4096
    o = np.stack([g.uniform(-0.5, 8.5, n), g.uniform(0.2, 2.0, n), g.uniform(-0.5, 8.5, n)], -1)
    d = g.normal(size=(n, 3))
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = (torch.from_numpy(a.astype(np.float32)).cuda() for a in (o, d))
    k = tm.traverse_mxu_padded(scene, o, d, packet=4096, with_counts=True, with_visits=True)
    p = tm.traverse_mxu_padded_reference(scene, o, d, packet=4096, with_counts=True, with_visits=True)
    torch.cuda.synchronize()
    assert (k[1] >= 0).float().mean() > 0.3
    assert all(torch.equal(a, b) for a, b in zip(k, p))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["stratified", "incoherent", "parked"])
def test_gen1_kernel_matches_plain(kind):
    """Kernel B3 against its plain version: the same DFS, slab tests and
    Möller–Trumbore in the same f32 order, so t, triangle ids and the
    per-packet leaf statistics are expected bit-equal; the rule of
    _assert_kernel_agrees is the bound."""
    _need_cuda()
    room = make_box_room(subdivisions=6, clutter=3, seed=2)
    clusters = build_clusters(room.tris, cluster_size=128)
    scene = tp.build_pallas_scene(clusters, device="cuda")
    n = 3 * 4096
    o, d = _rays(kind, room, tm.build_mxu_scene(clusters, device="cuda"), n)
    before = launched("traverse_pallas_launch")
    k = tp.traverse_pallas(scene, o, d, with_stats=True)
    assert launched("traverse_pallas_launch") == before + 1
    p = tp.traverse_pallas_reference(scene, o, d, with_stats=True)
    torch.cuda.synchronize()
    _, disagree = _assert_kernel_agrees(k, p, n)
    assert k[1].dtype == torch.int32 and k[2].shape == (n // tp.PACKET, 2)
    ks, ps = k[2].cpu().numpy().astype(np.int64), p[2].cpu().numpy()
    assert np.abs(ks[:, 0] - ps[:, 0]).sum() <= disagree
    if kind == "parked":
        dead = (o.view(-1, tp.PACKET, 3) == 1e6).all(2).all(1).cpu().numpy()
        assert dead.any() and (ks[dead, 0] == 0).all()


def _assert_gen1_bit_equal(scene, o, d):
    k = tp.traverse_pallas(scene, o, d, with_stats=True)
    p = tp.traverse_pallas_reference(scene, o, d, with_stats=True)
    torch.cuda.synchronize()
    for name, a, b in zip(("t", "ids", "leaves and active columns"), k, p):
        assert torch.equal(a, b), name
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["mixed", "dead", "single", "nan"])
def test_gen1_kernel_bit_equal_on_sparse_columns(kind):
    """The leaf's active columns are dealt out over the block's warps; t, ids,
    leaves and active columns per packet stay bit-equal to the plain version
    when a leaf has 1-3 active columns among full ones (stratified packets
    with every eighth column incoherent), none (parked dead lanes), a single
    live ray in a parked packet, or a NaN ray."""
    _need_cuda()
    room = make_box_room(subdivisions=6, clutter=3, seed=2)
    clusters = build_clusters(room.tris, cluster_size=128)
    scene = tp.build_pallas_scene(clusters, device="cuda")
    n = 4 * tp.PACKET
    o, d = _rays("stratified", room, None, n)
    io, idir = _rays("incoherent", room, None, n)
    parked_o = torch.full((n, 3), 1e6, device="cuda")
    parked_d = torch.tensor([1.0, 0.0, 0.0], device="cuda").expand(n, 3).contiguous()
    if kind == "mixed":
        o, d = o.clone().view(-1, 8, 8, 3), d.clone().view(-1, 8, 8, 3)
        o[:, 0], d[:, 0] = io.view(-1, 8, 8, 3)[:, 0], idir.view(-1, 8, 8, 3)[:, 0]
        o, d = o.view(-1, 3), d.view(-1, 3)
    elif kind == "dead":
        o, d = parked_o, parked_d
    elif kind == "single":
        o, d = parked_o, parked_d.clone()
        for packet, lane in enumerate((0, 7, 517, 1023)):
            o[packet * tp.PACKET + lane], d[packet * tp.PACKET + lane] = io[lane], idir[lane]
    else:
        o = io.clone()
        o[5, 1] = float("nan")
        d = idir
    t, ids, stats = _assert_gen1_bit_equal(scene, o, d)
    if kind == "dead":
        assert (ids == -1).all() and int(stats.sum()) == 0
    if kind == "single":
        assert int((ids >= 0).sum()) == 4 and (stats[:, 0] > 0).all() and (stats[:, 1] == stats[:, 0]).all()
    if kind == "nan":
        assert int(ids[5]) == -1 and float(t[5]) == float(torch.tensor(tp.BIG)) and (ids[:1024] >= 0).sum() > 1000


@pytest.mark.cuda
def test_gen1_kernel_walks_a_tree_at_its_stack_depth():
    """A top tree of STACK_DEPTH levels whose left children are the inner
    nodes and whose boxes all equal the room's: the right sibling of every
    level waits on the stack while the walk descends, so the last inner node
    fills the stack's last entry. Bit-equal to the plain version."""
    _need_cuda()
    room = make_box_room(subdivisions=6, clutter=3, seed=2)
    real = tp.build_pallas_scene(build_clusters(room.tris, cluster_size=128), device="cuda")
    levels = tp.STACK_DEPTH
    n_nodes = 2 * levels - 1
    meta = np.zeros((n_nodes, 2), np.int32)
    node, cluster = 0, 0
    for level in range(levels - 1):  # inner node `node`: children 2 level + 1 (inner, but the last) and + 2 (leaf)
        meta[node] = (2 * level + 1, 0)
        meta[2 * level + 2] = (cluster % real.n_clusters, 1)
        cluster += 1
        node = 2 * level + 1
    meta[node] = (cluster % real.n_clusters, 1)
    box = np.zeros((n_nodes, 8), np.float32)
    verts = room.tris.reshape(-1, 3)
    box[:, 0:3], box[:, 3:6] = verts.min(0), verts.max(0)
    scene = real._replace(node_box=torch.from_numpy(box.reshape(-1)).cuda(),
                          node_meta=torch.from_numpy(meta.reshape(-1)).cuda(), depth=levels)
    o, d = _rays("incoherent", room, None, 2 * tp.PACKET)
    _, ids, stats = _assert_gen1_bit_equal(scene, o, d)
    assert (stats[:, 0] == levels).all() and (ids >= 0).float().mean() > 0.9


@pytest.mark.cuda
def test_pallas_simulator_on_cuda_launches_the_gen1_kernel():
    """traversal="pallas" with the native sampler: one B3 launch per chunk
    (2500 photons per lamp: 3 chunks of 1024, the last masked), none of B1
    or B2, and the CPU run's map within the flip bound."""
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    params = SimParams(photon_count=3 * 2500, max_iterations=2, sampler="native", traversal="pallas")
    route = [LightPos(0.0, 0.0, 1.0), LightPos(1.0, -1.5, 2.0), LightPos(-1.2, 2.0, 0.5)]
    maps = {}
    for dev in ("cuda", "cpu"):
        sim = Simulator(room, params, route=list(route), ray_chunk=1024, device=dev)
        before = (launched("traverse_pallas_launch"), launched("fused_trace_launch"),
                  launched("traverse_mxu_launch"))
        sim.compute()
        if dev == "cuda":
            assert launched("traverse_pallas_launch") - before[0] == 2 * 3 * 3
            assert (launched("fused_trace_launch"), launched("traverse_mxu_launch")) == before[1:]
        maps[dev] = sim.photon_map.cpu().numpy()
    assert np.abs(maps["cuda"] - maps["cpu"]).sum() <= 2 * 2.0 * 1e-3 * 2 * 3 * 2500


@pytest.mark.cuda
def test_gen1_kernel_rejects_what_it_cannot_take():
    _need_cuda()
    room = make_box_room(subdivisions=2, clutter=0, seed=0)
    scene = tp.build_pallas_scene(build_clusters(room.tris, cluster_size=128), device="cuda")
    o = torch.zeros(tp.PACKET, 3, device="cuda")
    with pytest.raises(ValueError):
        tp.traverse_pallas(scene._replace(tri=scene.tri.double()), o, o)
    with pytest.raises(ValueError, match="1024"):
        tp.traverse_pallas(scene, o[:1000], o[:1000])
    with pytest.raises(ValueError, match="stack"):
        tp.traverse_pallas(scene._replace(depth=tp.STACK_DEPTH + 1), o, o)


@pytest.mark.cuda
@pytest.mark.parametrize("traversal,bounces", [("mxu", 0), ("mxu", 1), ("pallas", 1)])
def test_texel_launch_on_cuda_matches_plain(traversal, bounces):
    """A launch with an atlas on the card (B2 in counts mode and on the
    bounce segment, or B3) against the same launch through the plain
    versions on the card: each triangle's texel counts sum exactly to its
    count, and the texel counts differ in at most 0.2% of the hits
    (tests/test_torch_texel.py's rule)."""
    _need_cuda()
    from uvtrace_torch.ops import texel
    from uvtrace_torch.sim.launch import launch_counts

    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    params = SimParams(photon_count=1 << 14, max_iterations=1, texel_density=32.0, traversal=traversal,
                       max_bounces=bounces, reflectance=0.5)
    sim = Simulator(room, params, route=[LightPos(0.0, 0.0, 1.0)], ray_chunk=4096, device="cuda")
    kw = dict(t_count=room.triangle_count, n=1 << 14, chunk=4096, max_bounces=bounces,
              normals=sim._normals_launch if bounces else None,
              reflectance=sim._reflectance_launch() if bounces else None, atlas=sim._atlas_launch,
              n_texels=sim._n_texels, tri_v0=sim._tri_v0, tri_e1=sim._tri_e1, tri_e2=sim._tri_e2,
              slot_map=sim._slot_map)
    plain = dict(extend_fn=tp.traverse_pallas_reference) if traversal == "pallas" else dict(
        extend_fn=tm.traverse_mxu_padded_reference,
        extend_counts_fn=lambda s, o, d: tm.traverse_mxu_padded_reference(s, o, d, with_counts=True),
        extend_bounce_fn=lambda s, o, d: tm.traverse_mxu_padded_reference(s, o, d, packet=4096))
    lamp = [0.0, room.floor_height + 0.8, 0.0]
    before = (launched("traverse_mxu_launch"), launched("traverse_pallas_launch"), launched("fused_trace_launch"))
    kc, kt, _ = launch_counts(sim.scene, rng.PRNGKey(3), lamp, 1.0, **sim._trace, **kw)
    new = (launched("traverse_mxu_launch") - before[0], launched("traverse_pallas_launch") - before[1],
           launched("fused_trace_launch") - before[2])
    assert new == ((4 * (1 + bounces), 0, 0) if traversal == "mxu" else (0, 4 * (1 + bounces), 0))
    pc, pt, _ = launch_counts(sim.scene, rng.PRNGKey(3), lamp, 1.0, **plain, **kw)
    tri_of = texel.slot_triangles(sim.atlas).long()
    per_tri = torch.zeros(room.triangle_count, dtype=torch.int64, device="cuda").index_add_(0, tri_of, kt.long())
    assert torch.equal(per_tri, kc.long())
    hits = int(kc.sum())
    assert hits >= 1 << 14 and int((kc - pc).abs().sum()) <= 2 * (1 + bounces) * ((1 << 14) // 1000)
    assert int((kt - pt).abs().sum()) / 2 <= 2e-3 * hits


@pytest.mark.cuda
def test_texel_dose_grid_on_cuda_matches_cpu():
    """dose_grid(64, texels=True) through B2 on the card equals the CPU
    grid from the same texel map, except on probes whose first hit is a tie
    or whose barycentrics sit on a cell boundary (at most 1%)."""
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    params = SimParams(photon_count=1 << 14, max_iterations=1, traversal="mxu", texel_density=16.0)
    grids = {}
    for dev in ("cpu", "cuda"):
        sim = Simulator(room, params, route=[LightPos(0.0, 0.0, 1.0)], ray_chunk=4096, device=dev)
        if dev == "cuda":
            sim.photon_map, sim.photon_map_tex = cpu_map.cuda(), cpu_tex.cuda()
            sim.photon_map_size = 1 << 14
            before = launched("traverse_mxu_launch")
        else:
            sim.compute()
            cpu_map, cpu_tex = sim.photon_map, sim.photon_map_tex
        grids[dev] = sim.dose_grid(res=64, texels=True)
    assert launched("traverse_mxu_launch") - before == 2
    assert (grids["cuda"] != grids["cpu"]).mean() <= 0.01 and (grids["cuda"] > 0).mean() > 0.2


def _diff_batches(room, scene):
    """One waypoint's three kinds of shadow-ray batches of the diff layer as
    (origins, unit directions, lengths): rod to triangle samples (the direct
    estimator's draws, made by hand), and as K12 (`bounce.transfer_rays`)
    makes them for the 2-bounce term, source to source and the first
    receiver chunk (rays that start on surfaces): 1 + 2 batches of 32
    sources in chunks of 16."""
    from uvtrace_torch import diff as D
    from uvtrace_torch.diff import bounce
    from uvtrace_torch.diff import estimator as est

    xz = torch.tensor([0.3, -0.2], device=scene.v0.device)
    keys = rng.split(rng.PRNGKey(1), 3)
    tri = (scene.v0, scene.e1, scene.e2, scene.normal)
    direct = est.shadow_rays(est._rod_points(xz, room.floor_height + 0.8, 1.0, rng.uniform(keys[1], (4, 1), "cuda")),
                             bounce.receivers_reference(keys[0], 4, tri)[0].view(4, -1, 3))
    recorded = []
    rays = bounce.transfer_rays

    def record(key, n_s, targets, sources):
        out = rays(key, n_s, targets, sources)
        recorded.append((sources[0].repeat_interleave(out[1].shape[0] // sources[0].shape[0], 0), *out[:2]))
        return out

    bounce.transfer_rays = record
    try:
        with torch.no_grad():
            rho = torch.full((room.triangle_count,), 0.5, device=scene.v0.device)
            D.bounce_irradiance(scene, xz, room.floor_height + 0.8, 1.0, 450.0, rho, room.areas, rng.PRNGKey(2),
                                n_samples=4, n_sources=32, n_bounces=2)
    finally:
        bounce.transfer_rays = rays
    assert len(recorded) == 1 + 2
    return {"direct": direct, "source_to_source": recorded[0], "receiver": recorded[1]}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["direct", "source_to_source", "receiver"])
def test_diff_visibility_through_b2_matches_plain(kind):
    """The diff layer's shadow rays through B2 against its plain version:
    t and slots equal but for ties, visibility bits equal but on at most
    0.1% of rays, and no occluder the plain version finds is lost."""
    _need_cuda()
    from uvtrace_torch.diff import estimator as est
    from uvtrace_torch import diff as D

    room = make_box_room(subdivisions=6, clutter=4, seed=2)
    scene = D.make_diff_scene(room, device="cuda")
    orig, dirs, dist = _diff_batches(room, scene)[kind]
    o, d, inverse = est.pack_shadow_rays(orig, dirs)
    before = launched("traverse_mxu_launch")
    k = tm.traverse_mxu_slots(scene.trav_scene, o, d, packet=est.SHADOW_PACKET)
    assert launched("traverse_mxu_launch") == before + 1
    p = tm.traverse_mxu_padded_reference(scene.trav_scene, o, d, packet=est.SHADOW_PACKET)
    _assert_kernel_agrees(k, p, o.shape[0])
    thr = dist.reshape(-1) * (1.0 - 1e-3) - 1e-3
    r = orig.shape[0]
    vis_k, vis_p = k[0][inverse] >= thr, p[0][inverse] >= thr
    assert int((vis_k != vis_p).sum()) <= max(1, r // 1000)
    assert not bool((vis_k & ~vis_p).any())  # no lost occluder
    assert 0 < float(vis_p.float().mean()) < 1


@pytest.mark.cuda
def test_diff_irradiance_and_gradient_on_cuda_match_cpu():
    """irradiance, the 2-bounce term and their gradients on the card equal
    the CPU's (B2's plain version) within rtol 1e-4: the same keys and
    uniforms, f32 sums in another order."""
    _need_cuda()
    from uvtrace_torch import diff as D

    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    out = {}
    for dev in ("cpu", "cuda"):
        scene = D.make_diff_scene(room, device=dev)
        xz = torch.tensor([0.3, -0.2], device=dev, requires_grad=True)
        rho = torch.full((room.triangle_count,), 0.4, device=dev, requires_grad=True)
        e = D.irradiance(scene, xz, room.floor_height + 0.8, 1.0, 450.0, rng.PRNGKey(3), n_samples=4)
        b = D.bounce_irradiance(scene, xz, room.floor_height + 0.8, 1.0, 450.0, rho, room.areas, rng.PRNGKey(4),
                                n_samples=2, n_sources=16, n_bounces=2)
        g = torch.autograd.grad(e.mean() + b.mean(), (xz, rho))
        out[dev] = [x.detach().cpu().numpy() for x in (e, b, *g)]
    for c, k in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose(k, c, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["mxu-fused", "mxu", "pallas", "clustered"])
def test_bench_headline_on_cuda_matches_cpu(backend):
    """The bench's headline pipeline (uvtrace_torch/bench.py) on the card
    against the same pipeline on the CPU (the plain versions), 2 x 4096 rays
    on a small room: counts equal but for at most 0.1% of the rays flipping,
    each moving two counts by one; the card's kernel launched once an
    iteration."""
    _need_cuda()
    from uvtrace_torch import bench

    room = make_box_room(subdivisions=6, clutter=4, seed=2)
    counter = {"mxu-fused": "fused_trace_launch", "mxu": "traverse_mxu_launch",
               "pallas": "traverse_pallas_launch"}.get(backend)
    before = launched(counter) if counter else 0
    k = bench.headline_pipeline(room, backend, 4096, "cuda")(2)[0].cpu().numpy().astype(np.int64)
    if counter:
        assert launched(counter) == before + 2
    p = bench.headline_pipeline(room, backend, 4096, "cpu")(2)[0].numpy().astype(np.int64)
    assert np.abs(k - p).sum() <= 2 * 9


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["mxu-fused", "mxu", "pallas"])
def test_bench_pins_on_cuda(backend, monkeypatch, capsys):
    """`bench` at 5 x 2^20 rays on testroomopt passes its pin gate (the JAX
    package's pinned hit totals within 64) through each kernel."""
    _need_cuda()
    from uvtrace_torch import bench

    for k in ("RAYS", "PRECISION"):
        monkeypatch.delenv(f"UVTRACE_BENCH_{k}", raising=False)
    monkeypatch.setenv("UVTRACE_BENCH_BACKEND", backend)
    monkeypatch.setenv("UVTRACE_BENCH_ITERS", "5")
    row = bench.main(device="cuda")
    pin, tol = bench.check_pinned_total(row["hit_total"], backend == "mxu-fused", 5)
    assert abs(row["hit_total"] - pin) <= tol and row["value"] > 0
    capsys.readouterr()


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy().view(np.uint32)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [1, 1023, 1 << 20, (1 << 20) + 37, (4, 44866, 1), (64, 1), (3, 5, 7)])
@pytest.mark.parametrize("seed,gi", [(0, 0), (3, 7919), (2**32 - 1, 2**31 + 5)])
def test_threefry_uniform_kernel_bit_equal(shape, seed, gi):
    """K1 (rng.uniform on the card) against its plain version on the card,
    bit for bit, in the (minval, maxval) forms its callers draw: one launch
    a draw."""
    _need_cuda()
    key = rng.fold_in(rng.PRNGKey(seed), gi)
    for lo, hi in [(0.0, 1.0), (-1.0, 1.0), (0.0, 2.0 * np.pi)]:
        before = launched("threefry_uniform_launch")
        k = rng.uniform(key, shape, "cuda", minval=lo, maxval=hi)
        assert launched("threefry_uniform_launch") == before + 1
        p = rng.uniform_reference(key, shape, "cuda", minval=lo, maxval=hi)
        assert k.shape == p.shape and k.dtype == torch.float32
        np.testing.assert_array_equal(_bits(k), _bits(p))


@pytest.mark.cuda
@pytest.mark.parametrize("n,packet,height_bands", [
    (1 << 20, 1024, 4),  # launch.py's chunk, the bench's and chip_smoke's 2^20
    (1 << 18, 1024, 4),  # the two-rank route's chunks of 2^18
    (2048, 1024, 4),  # entry()'s step: too few packets for height bands
    (512, 512, 4),  # a chunk below 1024: packet = chunk
    (3 * 4096, 4096, 1),
])
@pytest.mark.parametrize("seed,gi", [(0, 0), (7, 2**31 + 1)])
def test_generate_stratified_kernel_bit_equal(n, packet, height_bands, seed, gi):
    """K2 against generate_stratified_reference on the card: origins and
    directions bit for bit (both use CUDA's IEEE cosf/sinf/sqrtf)."""
    _need_cuda()
    key = rng.fold_in(rng.PRNGKey(seed), gi)
    lamp = (0.3, -0.6, 1.1)
    before = launched("generate_stratified_launch")
    k = generate_stratified(key, n, lamp, 1.0, packet=packet, height_bands=height_bands, device="cuda")
    assert launched("generate_stratified_launch") == before + 1
    p = generate_stratified_reference(key, n, lamp, 1.0, packet=packet, height_bands=height_bands, device="cuda")
    np.testing.assert_array_equal(_bits(k.orig), _bits(p.orig))
    np.testing.assert_array_equal(_bits(k.dir), _bits(p.dir))


@pytest.mark.cuda
@pytest.mark.parametrize("global_seed,start,n", [
    (0, 0, 1 << 20), (3458748736, 2**31 - 1000, 3001), (77, 2**31 - (1 << 19), 1 << 20),
    (2**32 - 1, 2**24 - 1, 1023), (12345, 2**32 - 500, 1000), (5, 0, 1)])
def test_generate_reference_kernel_bit_equal(global_seed, start, n):
    """K3 against generate_reference_reference on the card, bit for bit,
    with photon ids that cross 2^24 (f32 precision lost in the seed's sum)
    and 2^31 (int32 wrap); negative lamp coordinates clip at 0."""
    _need_cuda()
    for lamp in [(0.3, -0.45, 1.1), (-2.5, -1.2, -3.75)]:
        before = launched("generate_reference_launch")
        k = generate_reference(n, lamp, 1.0, global_seed, start, device="cuda")
        assert launched("generate_reference_launch") == before + 1
        p = generate_reference_reference(n, lamp, 1.0, global_seed, start, device="cuda")
        np.testing.assert_array_equal(_bits(k.orig), _bits(p.orig))
        np.testing.assert_array_equal(_bits(k.dir), _bits(p.dir))


@pytest.fixture(scope="module")
def launch_segments():
    """The launch layer's ops' inputs as config 2 (rho 0.25) makes them on a
    box room, on the card: a chunk of 2^20 stratified primaries through B2
    (every lane alive), and its second segment (bounced by K4,
    coherence-sorted, traced by B2 at 4096-ray packets, three lanes in four
    dead); slot-space normals, reflectance, triangles and a texel atlas."""
    _need_cuda()
    from uvtrace_torch.ops.bounce import bounce_step, sort_rays
    from uvtrace_torch.ops.texel import build_atlas

    room = make_box_room(subdivisions=8, clutter=4, seed=5)
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=128), device="cuda")
    safe = scene.tri_idx_flat.clamp_min(0).long()
    n = 1 << 20
    rays = generate_stratified(rng.PRNGKey(5), n, (0.1, room.floor_height + 0.8, -0.2), 1.0, device="cuda")
    t, hit = tm.traverse_mxu_slots(scene, rays.orig, rays.dir)
    normals = torch.from_numpy(room.normals).cuda()[safe]
    rho = torch.full((safe.shape[0],), 0.25, device="cuda")
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    o2, d2, a2, k2 = bounce_step(rng.fold_in(rng.PRNGKey(9), 0), rays.orig, rays.dir, t, hit, normals, rho, alive)
    o2, d2, a2 = sort_rays(k2, o2, d2, a2)
    t2, hit2 = tm.traverse_mxu_slots(scene, o2, d2, packet=4096)
    tris = torch.from_numpy(room.tris).cuda()
    atlas = build_atlas(room.areas, density=256.0, max_slots=1 << 22, device="cuda")
    geometry = dict(normals=normals, rho=rho, tri=(tris[:, 0][safe], (tris[:, 1] - tris[:, 0])[safe],
                                                    (tris[:, 2] - tris[:, 0])[safe]),
                    atlas=atlas._replace(base=atlas.base[safe], k=atlas.k[safe]), n_texels=atlas.n_slots)
    return {"primary": (rays.orig, rays.dir, t, hit, alive), "second": (o2, d2, t2, hit2, a2)}, geometry


def _segment(segments, which: str, n: int):
    """A segment's (orig, dir, t, hit, alive) at n rays: n = 2^20 + 37 repeats
    its first 37 rays at the end."""
    seg = segments[which]
    extra = n - seg[0].shape[0]
    return tuple(torch.cat([x, x[:extra]]).contiguous() for x in seg) if extra else seg


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["primary", "second"])
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 37])
def test_bounce_step_kernel_bit_equal(launch_segments, which, n):
    """K4 against bounce_step_reference on the card: new origins, directions
    (bit for bit), alive lanes and sort keys, on a chunk's primaries and on
    its second segment (most lanes dead)."""
    from uvtrace_torch.ops.bounce import bounce_step, bounce_step_reference

    segments, geo = launch_segments
    o, d, t, hit, alive = _segment(segments, which, n)
    key = rng.fold_in(rng.fold_in(rng.PRNGKey(3), 7919 + 1), 5)
    before = launched("bounce_step_launch")
    k = bounce_step(key, o, d, t, hit, geo["normals"], geo["rho"], alive)
    assert launched("bounce_step_launch") == before + 1
    p = bounce_step_reference(key, o, d, t, hit, geo["normals"], geo["rho"], alive)
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.cpu().numpy().view(np.uint8 if a.dtype == torch.bool else np.uint32),
                                      b.cpu().numpy().view(np.uint8 if b.dtype == torch.bool else np.uint32))
    assert 0 < int(k[2].sum()) < n


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["primary", "second"])
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 37])
def test_hit_histogram_kernel_bit_equal(launch_segments, which, n):
    """K5 against hit_histogram_reference on the card, added into non-zero
    counts, with and without the alive mask."""
    from uvtrace_torch.ops.accumulate import hit_histogram, hit_histogram_reference

    segments, geo = launch_segments
    _, _, _, hit, alive = _segment(segments, which, n)
    bins = geo["normals"].shape[0]
    start = torch.randint(0, 50, (bins,), dtype=torch.int32, device="cuda", generator=None)
    for mask in (None, alive):
        before = launched("hit_histogram_launch")
        k = hit_histogram(hit, start.clone(), mask)
        assert launched("hit_histogram_launch") == before + 1
        p = hit_histogram_reference(hit, start.clone(), mask)
        assert torch.equal(k, p)
        live = hit >= 0 if mask is None else (hit >= 0) & mask
        assert int((k - start).sum()) == int(live.sum())


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["primary", "second"])
@pytest.mark.parametrize("n", [1 << 20, (1 << 20) + 37])
def test_texel_bin_kernel_bit_equal(launch_segments, which, n):
    """K6 against texel_bin_reference on the card: the texel counts of a
    segment's alive hits added into non-zero counts, bit for bit (the
    kernel repeats the plain version's f32 steps, NaN handling and int
    conversion)."""
    from uvtrace_torch.ops.texel import texel_bin, texel_bin_reference

    segments, geo = launch_segments
    o, d, t, hit, alive = _segment(segments, which, n)
    start = torch.randint(0, 5, (geo["n_texels"],), dtype=torch.int32, device="cuda")
    before = launched("texel_bin_launch")
    k = texel_bin(geo["atlas"], o, d, t, hit, *geo["tri"], start.clone(), alive)
    assert launched("texel_bin_launch") == before + 1
    p = texel_bin_reference(geo["atlas"], o, d, t, hit, *geo["tri"], start.clone(), alive)
    assert torch.equal(k, p)
    assert int((k - start).sum()) == int(((hit >= 0) & alive).sum())


@pytest.fixture(scope="module")
def direct_inputs():
    """The direct estimator's inputs on a box room on the card: the
    triangles, the lit points of a 64 x 64 dose-image plan, a lamp."""
    _need_cuda()
    from uvtrace_torch import diff as D

    room = make_box_room(subdivisions=8, clutter=4, seed=5)
    scene = D.make_diff_scene(room, device="cuda")
    plan = D.plan_dose_image(scene, res=64)
    return scene, {"triangles": (scene.v0, scene.e1, scene.e2, scene.normal),
                   "points": (plan.points[plan.mask].contiguous(), plan.normals[plan.mask].contiguous())}


def _direct_forward(scene, targets, n_s, key, xz, kernels: bool):
    """K8, the sort, K7, B2 and K9 (or their plain versions on the card)."""
    from uvtrace_torch.diff import direct as dr

    if kernels:
        sample, pack, reduce = dr.shadow_sample, dr.pack_sorted, dr.visibility_reduce
    else:
        sample, pack, reduce = dr.shadow_sample_reference, dr.pack_sorted_reference, dr.visibility_reduce_reference
    rod, dirs, dist, g, sort_key = sample(key, n_s, targets, xz, -0.2, 1.2)
    o, d, inverse = pack(torch.sort(sort_key, stable=True).indices, rod, dirs)
    t = tm.traverse_mxu_slots(scene.trav_scene, o, d, packet=dr.SHADOW_PACKET)[0]
    return (rod, dirs, dist, g, sort_key), (o, d, inverse), reduce(t, inverse, dist, g, n_s, 450.0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n_s", [("triangles", 4), ("triangles", 1), ("points", 8)])
def test_direct_forward_kernels_bit_equal(direct_inputs, mode, n_s):
    """K8 (rod points, directions, lengths, G, sort keys) and K7 (the packed
    batch and the inverse permutation) bit for bit against their plain
    versions on the card; K9's visibility bits equal, E within rtol 1e-6
    (its plain version's sum is in the kernel's order)."""
    from uvtrace_torch.diff import direct as dr

    scene, targets = direct_inputs
    key, xz = rng.fold_in(rng.PRNGKey(0), 6), torch.tensor([0.3, -0.2], device="cuda")
    before = [launched("shadow_sample_launch"), launched("pack_sorted_launch"), launched("visibility_reduce_launch")]
    k = _direct_forward(scene, targets[mode], n_s, key, xz, True)
    assert [launched("shadow_sample_launch"), launched("pack_sorted_launch"), launched("visibility_reduce_launch")] == [
        b + 1 for b in before]
    p = _direct_forward(scene, targets[mode], n_s, key, xz, False)
    for a, b in zip(k[0] + k[1], p[0] + p[1]):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.cpu().numpy().view(np.uint8), b.cpu().numpy().view(np.uint8))
    (ek, vk), (ep, vp) = k[2], p[2]
    assert torch.equal(vk, vp) and 0 < float(vk.float().mean()) < 1
    np.testing.assert_allclose(ek.cpu().numpy(), ep.cpu().numpy(), rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n_s", [("triangles", 4), ("points", 8)])
def test_direct_grad_kernel_matches_plain(direct_inputs, mode, n_s):
    """K10 against its plain version on the card within 1e-5 of the sum of
    the absolute values of the terms the plain version adds (the f32 sums
    run in another order), and bit for bit from one call to the next."""
    from uvtrace_torch.diff import direct as dr

    scene, targets = direct_inputs
    key, xz = rng.fold_in(rng.PRNGKey(0), 6), torch.tensor([0.3, -0.2], device="cuda")
    _, _, (e, vis) = _direct_forward(scene, targets[mode], n_s, key, xz, True)
    grad = torch.linspace(-1.0, 2.0, e.shape[0], device="cuda")
    args = (grad, vis, key, n_s, targets[mode], xz, -0.2, 1.2, 450.0)
    before = launched("direct_grad_launch")
    k = dr.direct_grad(*args)
    assert launched("direct_grad_launch") == before + 1
    assert torch.equal(k, dr.direct_grad(*args))
    p = dr.direct_grad_reference(*args)
    scale = dr.direct_grad_terms(*args).abs().sum((1, 2))
    assert bool(((k - p).abs() <= 1e-5 * scale).all()) and bool((scale > 0).all())


@pytest.mark.cuda
def test_direct_function_on_cuda_repeats_and_matches_cpu(direct_inputs):
    """irradiance through the Function on the card: forward and gradients
    (lamp, power) the same on a repeat, bit for bit, and the CPU's within
    rtol 1e-4 (the same keys and uniforms; B2 against its plain version)."""
    from uvtrace_torch import diff as D

    room = make_box_room(subdivisions=8, clutter=4, seed=5)
    out = {}
    for dev in ("cuda", "cuda", "cpu"):
        scene = direct_inputs[0] if dev == "cuda" else D.make_diff_scene(room, device="cpu")
        xz = torch.tensor([0.3, -0.2], device=dev, requires_grad=True)
        pw = torch.tensor(450.0, device=dev, requires_grad=True)
        e = D.irradiance(scene, xz, room.floor_height + 0.8, 1.0, pw, rng.PRNGKey(3), n_samples=4)
        g = torch.autograd.grad(e.mean(), (xz, pw))
        res = [x.detach().cpu().numpy() for x in (e, *g)]
        if dev in out:
            for a, b in zip(res, out[dev]):
                np.testing.assert_array_equal(a, b)
        out[dev] = res
    for c, k in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose(k, c, rtol=1e-4, atol=1e-6)


@pytest.fixture(scope="module")
def bounce_inputs():
    """The interreflection term's inputs on a box room on the card: the
    area CDF, the triangles, the lit points of a 64 x 64 dose-image plan and
    64 sources drawn by K11's plain version."""
    _need_cuda()
    from uvtrace_torch import diff as D
    from uvtrace_torch.diff import bounce
    from uvtrace_torch.diff import estimator as est

    room = make_box_room(subdivisions=8, clutter=4, seed=5)
    scene = D.make_diff_scene(room, device="cuda")
    plan = D.plan_dose_image(scene, res=64)
    cdf = est._source_cdf(scene, room.areas)[0]
    tri = (scene.v0, scene.e1, scene.e2, scene.normal)
    keys = rng.split(rng.fold_in(rng.PRNGKey(0), 6), 4)
    _, x_m, n_m = bounce.source_sample_reference((keys[0], keys[1]), 64, cdf, tri)
    return scene, cdf, keys, (x_m, n_m), {"triangles": tri, "points": (plan.points[plan.mask].contiguous(),
                                                                        plan.normals[plan.mask].contiguous())}


def _assert_bits_equal(k, p):
    for a, b in zip(k, p):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.cpu().numpy().view(np.uint8), b.cpu().numpy().view(np.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("m", [64, 37])
def test_source_sample_kernel_bit_equal(bounce_inputs, m):
    """K11 against its plain version on the card: the source triangles
    (searchsorted over the area CDF), points and normals bit for bit."""
    from uvtrace_torch.diff import bounce

    _, cdf, keys, _, targets = bounce_inputs
    before = launched("source_sample_launch")
    k = bounce.source_sample((keys[0], keys[1]), m, cdf, targets["triangles"])
    assert launched("source_sample_launch") == before + 1
    _assert_bits_equal(k, bounce.source_sample_reference((keys[0], keys[1]), m, cdf, targets["triangles"]))
    assert k[0].min() >= 0 and k[0].max() < cdf.shape[0]


def _transfer_chunk(scene, keys, n_s, targets, sources, strength, acc, kernels: bool):
    """K12, the sort, K7, B2 and K13 in reduce mode (or their plain versions
    on the card, K7's included)."""
    from uvtrace_torch.diff import bounce
    from uvtrace_torch.diff import direct as dr

    if kernels:
        rays, pack, reduce = bounce.transfer_rays, dr.pack_sorted, bounce.transfer_reduce
    else:
        rays, pack, reduce = bounce.transfer_rays_reference, dr.pack_sorted_reference, bounce.transfer_reduce_reference
    out = rays(keys[3], n_s, targets, sources)
    o, d, inverse = pack(torch.sort(out[3], stable=True).indices, sources[0], out[0])
    t = tm.traverse_mxu_slots(scene.trav_scene, o, d, packet=dr.SHADOW_PACKET)[0]
    return out, reduce(t, inverse, out[1], out[2], sources[0].shape[0], strength, acc)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n_s,b", [("triangles", 4, 16), ("triangles", 1, 5), ("points", 1, 16)])
def test_transfer_forward_kernels_bit_equal(bounce_inputs, mode, n_s, b):
    """K12 (directions, lengths, form factors, sort keys) and K13's reduce
    mode (the sum into none and into a previous chunk's, the visibility
    bytes) bit for bit against their plain versions on the card."""
    from uvtrace_torch.diff import bounce

    scene, _, keys, (x_m, n_m), targets = bounce_inputs
    strength = torch.linspace(0.5, 2.0, 2 * b, device="cuda")
    before = [launched("transfer_rays_launch"), launched("transfer_reduce_launch")]
    acc = {True: None, False: None}
    for c in (0, b):
        src = (x_m[c:c + b].contiguous(), n_m[c:c + b].contiguous())
        res = {}
        for kernels in (True, False):
            prev = None if acc[kernels] is None else acc[kernels].clone()
            res[kernels] = _transfer_chunk(scene, keys, n_s, targets[mode], src, strength[c:c + b], prev, kernels)
            acc[kernels] = res[kernels][1][0]
        _assert_bits_equal(res[True][0] + res[True][1], res[False][0] + res[False][1])
        assert 0 < float(res[True][1][1].float().mean()) < 1
    assert [launched("transfer_rays_launch"), launched("transfer_reduce_launch")] == [x + 2 for x in before]


@pytest.mark.cuda
def test_transfer_matrix_kernels_bit_equal(bounce_inputs):
    """The 64 x 64 source-to-source matrix: K12 with the sources as
    receivers and K13's matrix mode bit for bit against their plain
    versions on the same trace; `transfer_matrix` is that matrix."""
    from uvtrace_torch.diff import bounce
    from uvtrace_torch.diff import direct as dr

    scene, _, _, sources, _ = bounce_inputs
    k_rays = bounce.transfer_rays(None, 1, sources, sources)
    _assert_bits_equal(k_rays, bounce.transfer_rays_reference(None, 1, sources, sources))
    o, d, inverse = dr.pack_sorted(torch.sort(k_rays[3], stable=True).indices, sources[0], k_rays[0])
    t = tm.traverse_mxu_slots(scene.trav_scene, o, d, packet=dr.SHADOW_PACKET)[0]
    before = launched("transfer_reduce_launch")
    k = bounce.transfer_reduce(t, inverse, k_rays[1], k_rays[2], 64)
    assert launched("transfer_reduce_launch") == before + 1
    _assert_bits_equal([k], [bounce.transfer_reduce_reference(t, inverse, k_rays[1], k_rays[2], 64)])
    assert (torch.diagonal(k) == 0).all() and 0 < float((k > 0).float().mean()) < 1
    _assert_bits_equal([bounce.transfer_matrix(scene, *sources)], [k])


@pytest.mark.cuda
@pytest.mark.parametrize("mode,n_s", [("triangles", 4), ("points", 1)])
def test_transfer_grad_kernel_matches_plain(bounce_inputs, mode, n_s):
    """K14 against its plain version on the card within 1e-5 of the sum of
    the absolute values of the terms the plain version adds (the f32 sums
    run in another order), and bit for bit from one call to the next."""
    from uvtrace_torch.diff import bounce

    scene, _, keys, (x_m, n_m), targets = bounce_inputs
    src = (x_m[:16].contiguous(), n_m[:16].contiguous())
    _, (out, vis) = _transfer_chunk(scene, keys, n_s, targets[mode], src, torch.ones(16, device="cuda"), None, True)
    grad = torch.linspace(-1.0, 2.0, out.shape[0], device="cuda")
    args = (grad, vis, keys[3], n_s, targets[mode], src)
    before = launched("transfer_grad_launch")
    k = bounce.transfer_grad(*args)
    assert launched("transfer_grad_launch") == before + 1
    assert torch.equal(k, bounce.transfer_grad(*args))
    p = bounce.transfer_grad_reference(*args)
    scale = bounce.transfer_grad_terms(*args).abs().sum(1)
    assert bool(((k - p).abs() <= 1e-5 * scale).all()) and bool((scale > 0).all())


@pytest.mark.cuda
def test_bounce_function_on_cuda_repeats_and_matches_cpu(bounce_inputs):
    """The 2-bounce term through K11-K14 on the card: value and gradients
    (lamp, power, reflectance) the same on a repeat, bit for bit, and the
    CPU's within rtol 1e-4 (the same keys and uniforms; B2 against its plain
    version)."""
    from uvtrace_torch import diff as D

    room = make_box_room(subdivisions=8, clutter=4, seed=5)
    out = {}
    for dev in ("cuda", "cuda", "cpu"):
        scene = bounce_inputs[0] if dev == "cuda" else D.make_diff_scene(room, device="cpu")
        xz = torch.tensor([0.3, -0.2], device=dev, requires_grad=True)
        pw = torch.tensor(450.0, device=dev, requires_grad=True)
        rho = torch.full((room.triangle_count,), 0.4, device=dev, requires_grad=True)
        e = D.bounce_irradiance(scene, xz, room.floor_height + 0.8, 1.0, pw, rho, room.areas, rng.PRNGKey(3),
                                n_samples=2, n_sources=24, n_bounces=2, source_chunk=10)
        g = torch.autograd.grad(e.mean(), (xz, pw, rho))
        res = [x.detach().cpu().numpy() for x in (e, *g)]
        if dev in out:
            for a, b in zip(res, out[dev]):
                np.testing.assert_array_equal(a, b)
        out[dev] = res
    for c, k in zip(out["cpu"], out["cuda"]):
        np.testing.assert_allclose(k, c, rtol=1e-4, atol=1e-6)


@pytest.mark.cuda
def test_kernel_spans_on_the_autograd_thread_nest_under_the_caller(bounce_inputs, monkeypatch):
    """The backward kernels K10 (`direct_grad`) and K14 (`transfer_grad`)
    launch on the autograd engine's device thread while the caller waits in
    torch.autograd.grad: their `kernel.*` spans take the span the calling
    thread has open as parent. A kernel span takes no CUDA event: the
    profiler times kernels."""
    import threading

    from uvtrace_torch import _build
    from uvtrace_torch import diff as D

    room = make_box_room(subdivisions=8, clutter=4, seed=5)
    scene = bounce_inputs[0]
    threads = {}
    call = _build.call

    def on_thread(name, device, *args):
        threads.setdefault(name, set()).add(threading.get_ident())
        return call(name, device, *args)

    monkeypatch.setattr(_build, "call", on_thread)
    xz = torch.tensor([0.3, -0.2], device="cuda", requires_grad=True)
    rho = torch.full((room.triangle_count,), 0.4, device="cuda", requires_grad=True)
    timing.reset()
    with timing.tracing():
        with timing.span("test.forward"):
            e = D.bounce_irradiance(scene, xz, room.floor_height + 0.8, 1.0, 450.0, rho, room.areas, rng.PRNGKey(3),
                                    n_samples=2, n_sources=24, n_bounces=2, source_chunk=10)
        with timing.span("test.backward") as backward:
            torch.autograd.grad(e.mean(), (xz, rho))
    torch.cuda.synchronize()
    spans = timing.spans()
    for entry in ("direct_grad_launch", "transfer_grad_launch"):
        launched_on = threads[entry]
        assert threading.get_ident() not in launched_on  # the autograd engine's thread
        kernel = [s for s in spans if s.name == f"kernel.{entry}"]
        assert kernel and all(s.parent == backward.id for s in kernel)
    kernels = [s for s in spans if s.name.startswith("kernel.")]
    assert len(kernels) == sum(timing.counters()[f"launches.{e}"] for e in threads)
    assert all(s.device_ms is None for s in kernels)
    timing.reset()


@pytest.mark.cuda
def test_a_launch_sort_span_times_its_device_interval():
    """`launch.sort`, the one span with CUDA events, reads a positive device
    interval, and records nothing with tracing off; the sort is unchanged."""
    from uvtrace_torch.ops.bounce import sort_rays

    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(11)
    n = 1 << 22
    key = torch.randint(0, 1 << 20, (n,), device="cuda", generator=g, dtype=torch.int32)
    orig = torch.rand(n, 3, device="cuda", generator=g)
    direction = torch.rand(n, 3, device="cuda", generator=g)
    alive = torch.ones(n, dtype=torch.bool, device="cuda")
    timing.reset()
    sort_rays(key, orig, direction, alive)
    assert timing.spans() == []
    with timing.tracing():
        for _ in range(3):
            out = sort_rays(key, orig, direction, alive)
    spans = timing.spans()
    assert [s.name for s in spans] == ["launch.sort"] * 3
    assert all(s.device_ms is not None and s.device_ms > 0 for s in spans)
    perm = torch.sort(key, stable=True).indices
    assert torch.equal(out[0], orig[perm]) and torch.equal(out[2], alive[perm])
    timing.reset()


@pytest.fixture(scope="module")
def testroom_route():
    """Config 4 on the card: the test room's diff scene and lange_route.xml's
    start as the command line clips it into its bounds (rod base y, rod
    length, power, bounds, waypoints f32[12,2], durations f32[12])."""
    _need_cuda()
    from pathlib import Path

    from uvtrace_torch import diff as D
    from uvtrace_torch.geometry.gltf import load_glb
    from uvtrace_torch.io.routexml import load_route_xml
    from uvtrace_torch.sim import SimParams

    assets = Path(__file__).resolve().parents[1] / "assets"
    mesh = load_glb(assets / "testroomopt.glb")
    route = load_route_xml(str(assets / "lange_route.xml"))
    p = route.apply_to(SimParams())
    lo, hi = mesh.aabb
    bounds = ((float(lo[0]) + 0.1, float(lo[2]) + 0.1), (float(hi[0]) - 0.1, float(hi[2]) - 0.1))
    wp = np.clip(np.array([[w.x, w.y] for w in route.waypoints], np.float32), np.float32(bounds[0]) + 1e-3,
                 np.float32(bounds[1]) - 1e-3)
    durs = np.array([w.duration for w in route.waypoints], np.float32)
    return mesh, D.make_diff_scene(mesh, device="cuda"), (mesh.floor_height + p.light_height, p.light_length,
                                                          p.light_intensity, bounds, wp, durs)


@pytest.mark.cuda
def test_transfer_reduce_kept_mode_bit_equal_on_testroom(testroom_route):
    """K13's kept-visibility mode on config 4's waypoint 0, chunk 0 (16
    sources x 179,464 receivers): given the bytes its traced mode kept, the
    sums bit for bit the traced mode's, alone and into a previous chunk's,
    and its plain version's; the bytes are read, not written."""
    from uvtrace_torch.diff import bounce
    from uvtrace_torch.diff import estimator as est

    mesh, scene, _ = testroom_route
    keys = rng.split(rng.fold_in(rng.fold_in(rng.PRNGKey(0), 0), 1), 4)
    _, x_m, n_m, _ = est.source_points(scene, mesh.areas, keys, 64)
    tri = (scene.v0, scene.e1, scene.e2, scene.normal)
    src = (x_m[:16].contiguous(), n_m[:16].contiguous())
    dirs, dist, f, sort_key = bounce.transfer_rays(keys[3], 4, tri, src)
    t, inverse = scene.trace_fn(scene.trav_scene, src[0], dirs, sort_key)
    strength = torch.linspace(0.5, 2.0, 16, device="cuda")
    prev = torch.linspace(0.0, 1.0, 4 * mesh.triangle_count, device="cuda")
    for acc in (None, prev):
        traced, vis = bounce.transfer_reduce(t, inverse, dist, f, 16, strength, None if acc is None else acc.clone())
        assert vis.shape == (16 * 179_464,) and 0 < float(vis.float().mean()) < 1
        kept_bytes = vis.clone()
        before = launched("transfer_reduce_launch")
        kept, same = bounce.transfer_reduce(None, None, None, f, 16, strength, None if acc is None else acc.clone(),
                                            vis)
        assert launched("transfer_reduce_launch") == before + 1 and same is vis
        plain = bounce.transfer_reduce_reference(None, None, None, f, 16, strength, acc, vis)[0]
        _assert_bits_equal([kept, vis], [traced, kept_bytes])
        _assert_bits_equal([kept], [plain])


@pytest.mark.cuda
def test_planned_route_on_testroom_is_bit_equal_to_the_unplanned(testroom_route, monkeypatch):
    """Config 4's 2-bounce route (rho 0.25, 64 sources in chunks of 16), 3
    Adam steps: with its transfer plan each step's loss, both gradients,
    the parameters and Adam's moments equal the unplanned run's bit for
    bit, as do the final waypoints, durations and dose; a step's peak
    device memory (steps 2 and 3) is no higher than the unplanned step's
    plus the plan's bytes."""
    import sys

    from uvtrace_torch import diff as D
    from uvtrace_torch.diff import optimize

    mesh, scene, (base_y, rod_len, power, bounds, wp, durs) = testroom_route
    build = optimize.plan_route_transfer
    runs, plans = {}, []
    for planned in (False, True):
        def plan_or_none(*args, _planned=planned, **kwargs):
            if not _planned:
                return None  # the unplanned path
            plans.append(build(*args, **kwargs))
            return plans[-1]

        monkeypatch.setattr(optimize, "plan_route_transfer", plan_or_none)
        steps, peaks = [], []

        def progress(i, loss):
            f = sys._getframe(1).f_locals
            steps.append([torch.tensor([loss]), *(x.detach().clone() for x in (*f["grads"], *f["params"])),
                          *(x.clone() for pair in f["opt_state"] for x in pair)])
            torch.cuda.synchronize()
            peaks.append(torch.cuda.max_memory_allocated())
            torch.cuda.reset_peak_memory_stats()

        before = timing.counters()
        res = D.optimize_route(scene, wp, durs, base_y, rod_len, power, steps=3, learning_rate=0.05, n_samples=4,
                               bounds=bounds, progress=progress, reflectance=0.25, areas=mesh.areas, n_sources=64,
                               n_bounces=2)
        served = timing.counters()["diff.transfer.served"] - before["diff.transfer.served"]
        assert served == (12 * 4 if planned else 0)
        runs[planned] = (res, steps, peaks)
    (p_res, p_steps, p_peaks), (u_res, u_steps, u_peaks) = runs[True], runs[False]
    assert p_res.history == u_res.history
    for a, b in zip(p_steps, u_steps):
        _assert_bits_equal(a, b)
    for name in ("waypoints_xz", "durations", "final_dose_masked"):
        np.testing.assert_array_equal(getattr(p_res, name), getattr(u_res, name))
    [plan] = plans
    plan_bytes = sum(x.nbytes for w in plan.waypoints for x in (w.src, w.x_m, w.n_m, w.f_ss, *w.vis))
    assert 130e6 < plan_bytes < 140e6  # 12 waypoints x 4 chunks x 16 x 179,464 bytes, and the rest
    assert max(p_peaks[1:]) <= max(u_peaks[1:]) + plan_bytes
