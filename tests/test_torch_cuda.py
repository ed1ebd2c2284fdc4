"""The CUDA kernel against its plain PyTorch version, on the card.

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
from uvtrace_torch.ops.cluster import build_clusters
from uvtrace_torch.sim import SimParams, Simulator

PACKET = 1024


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("c_sz,packet", [(64, 1024), (128, 2048), (128, 384)])
def test_kernel_matches_plain(c_sz, packet):
    """Equal rays (both generated in f32 on the card, no contraction); slots
    and t (rtol 1e-5) equal but on ties, edge flips and grazing rays of the
    f32 sums taken in another order (<= 0.1% of rays; a differing slot still
    has t within rtol 1e-5); counts and cluster visits equal within the
    number of disagreeing rays."""
    _need_cuda()
    room = make_box_room(subdivisions=4, clutter=2, seed=5)
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=c_sz), device="cuda")
    lamp = (0.1, room.floor_height + 0.8, -0.2)
    n = 8 * PACKET if packet != 384 else 8 * 384
    before = tm.fused_trace_counts.launches
    k = tm.fused_trace_counts(scene, rng.PRNGKey(4), lamp, 1.0, n, packet=packet,
                              with_rays=True, with_visits=True)
    assert tm.fused_trace_counts.launches == before + 1
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
    assert kc.sum() == pc.sum() == n  # closed room
    assert np.abs(kc.astype(np.int64) - pc).sum() <= 2 * mism
    assert np.abs(kv.astype(np.int64) - pv).sum() <= disagree


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
        before = tm.fused_trace_counts.launches
        sim.compute()
        if dev == "cuda":
            # 2 iterations x 3 waypoints x 3 chunks of 1024 (2500 rounds up to 3072)
            assert tm.fused_trace_counts.launches - before == 2 * 3 * 3
        maps[dev] = sim.photon_map.cpu().numpy()
    assert np.abs(maps["cuda"] - maps["cpu"]).sum() <= 2 * 2.0 * 1e-3 * 2 * 3 * 3072


@pytest.mark.cuda
def test_kernel_rejects_what_it_cannot_take():
    _need_cuda()
    room = make_box_room(subdivisions=2, clutter=0, seed=0)
    scene = tm.build_mxu_scene(build_clusters(room.tris, cluster_size=64), device="cuda")
    bad = scene._replace(feat10=scene.feat10.double())
    with pytest.raises(ValueError):
        tm.fused_trace_counts(bad, rng.PRNGKey(0), (0.0, 0.0, 0.0), 1.0, PACKET)
    with pytest.raises(ValueError):
        tm.fused_trace_counts(scene, rng.PRNGKey(0), (0.0, 0.0, 0.0), 1.0, 1000)
