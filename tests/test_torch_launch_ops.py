"""The launch layer's per-ray ops: the plain versions of the kernels K4
(`bounce_step`), K5 (`hit_histogram`) and K6 (`texel_bin`) of
csrc/launch_ops.cu against the JAX package on the same inputs made with
numpy from a seed, on the CPU; then the dispatch of each (a CUDA request
reaches its C entry point or raises, a CPU request never touches the kernel
library, other devices are refused), and the launch loop's use of them.

Tolerances, with their reasons: the roulette uniforms are threefry bits and
f32 arithmetic on both sides, so `alive` is bit-equal; new directions go
through sqrt, cos and sin, whose XLA-CPU and torch versions differ by an
ulp, so origins and directions agree within 1e-6, and the sort keys, read
from them, are equal; histograms are integers, bit-equal; a texel slot is
equal but where u k or v k lies on a cell boundary (the f32 sums may round
either way there, tests/test_torch_texel.py), each such hit moving one count.
There is no card here, so a CUDA request is followed as far as the C entry
point, with `_build.call` (the C call behind `_build.launch`) replaced by
a recorder, as in
tests/test_torch_sampler_dispatch.py; the kernels' bit equality to these
plain versions is tests/test_torch_cuda.py's, on the card.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace.ops import texel as jax_texel
from uvtrace.ops.accumulate import hit_counts as jax_hit_counts
from uvtrace.ops.bounce import bounce_rays as jax_bounce_rays
from uvtrace.ops.bounce import coherence_sort as jax_coherence_sort
from uvtrace_torch import _build
from uvtrace_torch.geometry.procedural import make_box_room
from uvtrace_torch.ops import accumulate as acc
from uvtrace_torch.ops import bounce
from uvtrace_torch.ops import rng
from uvtrace_torch.ops import texel
from uvtrace_torch.sim import launch
from uvtrace_torch.utils import timing


def _kw(key) -> np.ndarray:
    return np.asarray(jax.random.key_data(key)).astype(np.uint32)


def _unit(g, n):
    v = g.normal(size=(n, 3))
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _jax_key(orig, direction, alive, cell_meters=1.0):
    """The key of uvtrace/ops/bounce.py:coherence_sort (:111-121), which the
    JAX package computes inside the sort."""
    oct_ = ((direction[:, 0] >= 0).astype(jnp.int32) * 4 + (direction[:, 1] >= 0).astype(jnp.int32) * 2
            + (direction[:, 2] >= 0).astype(jnp.int32))
    cell = jnp.zeros_like(oct_)
    for a in range(3):
        cell = cell * 8 + (jnp.floor(orig[:, a] / cell_meters).astype(jnp.int32) & 7)
    return np.asarray(jnp.where(alive, oct_ * 512 + cell, jnp.int32(1 << 30)))


def _bounce_inputs(seed: int, rho: float, r: int = 4096, t_count: int = 300, dead: bool = False):
    g = np.random.default_rng(seed)
    orig = g.uniform(-2, 2, (r, 3)).astype(np.float32)
    direction = _unit(g, r)
    t_hit = g.uniform(0.1, 3.0, r).astype(np.float32)
    hit = g.integers(-1, t_count, r).astype(np.int32)
    t_hit[hit < 0] = 1e30
    normals = _unit(g, t_count)
    normals[:3] = [(0, 0, 1), (0, 0, -1), (1, 0, 0)]  # the basis' sign flip and a normal in the plane
    refl = np.full(t_count, rho, np.float32)
    alive = np.zeros(r, bool) if dead else g.uniform(size=r) < 0.8
    return orig, direction, t_hit, hit, normals, refl, alive


@pytest.mark.parametrize("rho,dead", [(0.0, False), (0.25, False), (1.0, False), (0.25, True)],
                         ids=["rho0", "rho0.25", "rho1", "all-dead"])
def test_bounce_step_reference_matches_jax(rho, dead):
    """bounce_step_reference against JAX's bounce_rays and the key of its
    coherence_sort; the stable sort on the key orders the rays as JAX's
    coherence_sort does."""
    args = _bounce_inputs(13, rho, dead=dead)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5), 7919 + 2), 3)
    jo, jd, ja = (np.array(x) for x in jax_bounce_rays(key, *(jnp.asarray(a) for a in args)))
    po, pd, pa, pk = (x.numpy() for x in bounce.bounce_step_reference(_kw(key), *(torch.from_numpy(a) for a in args)))
    np.testing.assert_array_equal(pa, ja)
    if rho == 0.0 or dead:
        assert not pa.any()
    elif rho == 1.0:  # u < 1 always: every alive lane that hits survives
        np.testing.assert_array_equal(pa, args[6] & (args[3] >= 0))
    else:
        assert 0 < pa.sum() < pa.size
    np.testing.assert_allclose(po, jo, rtol=0, atol=1e-6)
    np.testing.assert_allclose(pd, jd, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(po[~pa], 1e6)
    np.testing.assert_array_equal(pd[~pa], np.broadcast_to([1.0, 0.0, 0.0], pd[~pa].shape))
    assert pk.dtype == np.int32
    np.testing.assert_array_equal(pk, _jax_key(jnp.asarray(jo), jnp.asarray(jd), jnp.asarray(ja)))
    assert (pk[~pa] == 1 << 30).all()
    sorted_p = bounce.sort_rays(*(torch.from_numpy(a) for a in (pk, jo, jd, ja)))
    for a, b in zip(sorted_p, jax_coherence_sort(jnp.asarray(jo), jnp.asarray(jd), jnp.asarray(ja))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_bounce_rays_and_coherence_sort_are_bounce_step():
    """The JAX package's names call the new functions: bounce_rays is
    bounce_step without its key, coherence_sort sorts on coherence_key."""
    args = [torch.from_numpy(a) for a in _bounce_inputs(2, 0.5)]
    key = rng.fold_in(rng.PRNGKey(3), 1)
    step = bounce.bounce_step(key, *args)
    for a, b in zip(bounce.bounce_rays(key, *args), step[:3]):
        assert torch.equal(a, b)
    assert torch.equal(step[3], bounce.coherence_key(*step[:3]))
    for a, b in zip(bounce.coherence_sort(*step[:3]), bounce.sort_rays(step[3], *step[:3])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell_meters", [0.3, 0.7])
def test_coherence_sort_at_a_cell_size_that_is_no_power_of_two(cell_meters):
    """The cell divides by the cell size as JAX does (an IEEE division), also
    where the divisor's reciprocal is inexact."""
    g = np.random.default_rng(4)
    r = 5000
    orig = g.uniform(-4, 4, (r, 3)).astype(np.float32)
    orig[:64] = np.float32(cell_meters) * g.integers(-9, 9, (64, 3)).astype(np.float32)  # on cell edges
    direction = _unit(g, r)
    alive = g.uniform(size=r) < 0.7
    want = _jax_key(jnp.asarray(orig), jnp.asarray(direction), jnp.asarray(alive), cell_meters)
    got = bounce.coherence_key(*(torch.from_numpy(a) for a in (orig, direction, alive)), cell_meters)
    np.testing.assert_array_equal(got.numpy(), want)
    j = jax_coherence_sort(*(jnp.asarray(a) for a in (orig, direction, alive)), cell_meters=cell_meters)
    p = bounce.coherence_sort(*(torch.from_numpy(a) for a in (orig, direction, alive)), cell_meters=cell_meters)
    for a, b in zip(p, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


HISTOGRAM_CASES = {
    "misses": dict(r=5000, lo=-3),
    "alive": dict(r=5000, lo=-3, alive=True),
    "all misses": dict(r=2048, lo=-5, hi=0),
    "empty": dict(r=0, lo=-1),
    "past the last bin": dict(r=3000, lo=-2, hi=420),
    "into counts": dict(r=5000, lo=-3, start=True),
}


@pytest.mark.parametrize("case", list(HISTOGRAM_CASES))
@pytest.mark.parametrize("method", ["segment", "sort"])
def test_hit_histogram_reference_matches_jax(case, method):
    """hit_histogram_reference adds JAX's hit_counts into the counts, bit for
    bit; JAX drops every id outside [0, bins), as the histogram does."""
    spec, bins = HISTOGRAM_CASES[case], 400
    g = np.random.default_rng(len(case))
    ids = g.integers(spec["lo"], spec.get("hi", bins), spec["r"]).astype(np.int32)
    alive = g.uniform(size=spec["r"]) < 0.5 if spec.get("alive") else None
    start = g.integers(0, 1000, bins).astype(np.int32) if spec.get("start") else np.zeros(bins, np.int32)
    counts = torch.from_numpy(start.copy())
    got = acc.hit_histogram_reference(torch.from_numpy(ids), counts,
                                      None if alive is None else torch.from_numpy(alive))
    assert got is counts and got.dtype == torch.int32
    masked = ids if alive is None else np.where(alive, ids, -1)
    want = start + np.asarray(jax_hit_counts(jnp.asarray(masked), bins, method))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.equal(acc.hit_counts(torch.from_numpy(masked), bins, method), torch.from_numpy(want - start))


def _texel_inputs(seed: int, r: int = 20000, t_count: int = 60):
    """Triangles, an atlas over them and hits on them from known
    barycentrics (some outside the triangle, some misses)."""
    g = np.random.default_rng(seed)
    v0, e1, e2 = (g.normal(size=(t_count, 3)).astype(np.float32) for _ in range(3))
    v0[-1], e2[-1] = 0.0, 2.0 * e1[-1]  # a degenerate triangle: the determinant's floor
    areas = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1) + 0.05
    hit = g.integers(-1, t_count, r).astype(np.int32)
    safe = np.maximum(hit, 0)
    u, v = g.uniform(-0.05, 1.05, (2, r)).astype(np.float32)
    d = _unit(g, r)
    t = g.uniform(0.5, 3.0, r).astype(np.float32)
    orig = (v0[safe] + u[:, None] * e1[safe] + v[:, None] * e2[safe] - t[:, None] * d).astype(np.float32)
    t[hit < 0] = 1e30
    return areas, (orig, d, t, hit), (v0, e1, e2), g.uniform(size=r) < 0.7


@pytest.mark.parametrize("with_alive", [False, True])
@pytest.mark.parametrize("method", ["segment", "sort"])
def test_texel_bin_reference_matches_jax(with_alive, method):
    """texel_bin_reference against the JAX package's texel binning
    (uvtrace/sim/launch.py:107-115): every hit's slot equal but on cell
    boundaries, and the counts added into non-zero ones off by at most two
    a differing slot."""
    areas, (orig, d, t, hit), (v0, e1, e2), alive = _texel_inputs(7)
    jatlas = jax_texel.build_atlas(areas, density=6.0)
    patlas = texel.build_atlas(areas, density=6.0)
    hit_j = np.where(alive, hit, -1) if with_alive else hit
    safe = np.maximum(hit_j, 0)
    ju, jv = jax_texel.barycentrics(*(jnp.asarray(a) for a in (orig, d, t, v0[safe], e1[safe], e2[safe])))
    want_slots = np.asarray(jax_texel.texel_ids(jatlas, jnp.asarray(hit_j), ju, jv))
    start = np.random.default_rng(1).integers(0, 9, patlas.n_slots).astype(np.int32)
    want = start + np.asarray(jax_hit_counts(jnp.asarray(want_slots), patlas.n_slots, method))
    tens = [torch.from_numpy(a) for a in (orig, d, t, hit, v0, e1, e2)]
    kw = dict(alive=torch.from_numpy(alive)) if with_alive else {}
    slots = texel.texel_slots(patlas, *tens, **kw).numpy()
    counts = torch.from_numpy(start.copy())
    got = texel.texel_bin_reference(patlas, *tens, counts, **kw)
    assert got is counts and got.dtype == torch.int32
    np.testing.assert_array_equal(slots < 0, hit_j < 0)
    pu, pv = (x.numpy() for x in texel.barycentrics(*(torch.from_numpy(a) for a in (orig, d, t, v0[safe],
                                                                                     e1[safe], e2[safe]))))
    np.testing.assert_allclose(pu, np.asarray(ju), rtol=0, atol=1e-5)
    np.testing.assert_allclose(pv, np.asarray(jv), rtol=0, atol=1e-5)
    k = np.asarray(jatlas.k, np.float32)[safe]

    def near_int(x):
        x = np.clip(x, 0, 1)
        return np.abs(x * k - np.round(x * k)) <= 4 * np.spacing(np.float32(np.maximum(x * k, 1)))

    differ = slots != want_slots
    fold = np.abs(np.clip(pu, 0, 1) + np.clip(pv, 0, 1) - 1) <= 1e-6  # the diagonal, where u + v > 1 folds
    boundary = (near_int(pu) | near_int(pv) | near_int(1 - np.clip(pu, 0, 1)) | near_int(1 - np.clip(pv, 0, 1))
                | fold)
    assert not (differ & ~boundary).any() and differ.mean() < 1e-3
    assert np.abs(got.numpy().astype(np.int64) - want).sum() <= 2 * differ.sum()
    assert got.numpy().sum() - start.sum() == (hit_j >= 0).sum()


# --------------------------------------------------------------- dispatch

KEY = rng.fold_in(rng.PRNGKey(7), 3)


def _must_not_run(name):
    def fail(*args, **kwargs):
        raise AssertionError(f"{name} ran")
    return fail


@pytest.fixture
def no_library(monkeypatch):
    """The kernel library cannot be built, loaded or launched."""
    for name in ("build", "load", "launch"):
        monkeypatch.setattr(_build, name, _must_not_run(f"_build.{name}"))


@pytest.fixture
def on_card(monkeypatch):
    """The kernels' wrappers as far as the C entry point, on CPU tensors:
    the plain bodies refused and every `_build.call` recorded."""
    for mod, name in ((bounce, "bounce_step_reference"), (acc, "hit_histogram_reference"),
                      (texel, "texel_bin_reference"), (rng, "uniform_reference")):
        monkeypatch.setattr(mod, name, _must_not_run(name))
    calls = []
    monkeypatch.setattr(_build, "call", lambda name, device, *args: calls.append((name, device, args)))
    return calls


def _check_signature(name, args):
    """The arguments fit the entry point's ctypes signature (its stream is
    added by `_build.launch`)."""
    argtypes, restype = _build.SIGNATURES[name]
    assert restype is _build._I32
    assert len(args) + 1 == len(argtypes)
    for a, t in zip(args, argtypes):
        if t is _build._PTR:
            assert isinstance(a, _build._PTR)
        elif t is _build._F32:
            assert isinstance(a, float) and np.float32(a) == a
        else:
            lo, hi = (0, 2**32) if t is _build._U32 else (-2**31, 2**31)
            assert isinstance(a, int) and lo <= a < hi


def _small_bounce(r=1000):
    return [torch.from_numpy(a) for a in _bounce_inputs(3, 0.5, r=r, t_count=40)]


def _small_texels(r=1000):
    areas, rays, tris, alive = _texel_inputs(3, r=r, t_count=40)
    return texel.build_atlas(areas, density=4.0), [torch.from_numpy(a) for a in (*rays, *tris)], torch.from_numpy(alive)


ENTRY_POINTS = ("bounce_step_launch", "hit_histogram_launch", "texel_bin_launch")


def launched(entry: str) -> int:
    """Launches of the C entry point `entry` counted so far."""
    return timing.counters()[f"launches.{entry}"]


def test_cpu_requests_never_touch_the_kernel_library(no_library):
    before = [launched(e) for e in ENTRY_POINTS]
    args = _small_bounce()
    for a, b in zip(bounce.bounce_step(KEY, *args), bounce.bounce_step_reference(KEY, *args)):
        assert torch.equal(a, b)
    ids = torch.from_numpy(np.random.default_rng(0).integers(-2, 50, 999).astype(np.int32))
    assert torch.equal(acc.hit_histogram(ids, torch.zeros(50, dtype=torch.int32)),
                       acc.hit_histogram_reference(ids, torch.zeros(50, dtype=torch.int32)))
    atlas, tens, alive = _small_texels()
    assert torch.equal(texel.texel_bin(atlas, *tens, torch.zeros(atlas.n_slots, dtype=torch.int32), alive),
                       texel.texel_bin_reference(atlas, *tens, torch.zeros(atlas.n_slots, dtype=torch.int32), alive))
    assert [launched(e) for e in ENTRY_POINTS] == before


def _on(device: str):
    """A stand-in for a tensor on `device`: the wrappers read its device
    before they dispatch."""
    return types.SimpleNamespace(device=torch.device(device))


def test_cuda_requests_reach_the_kernel_wrappers(monkeypatch):
    """Each wrapper sends a CUDA request to its kernel wrapper, with its
    arguments as given, and never to the plain version."""
    calls = []
    for mod, name in ((bounce, "_bounce_step_kernel"), (acc, "_hit_histogram_kernel"), (texel, "_texel_bin_kernel")):
        monkeypatch.setattr(mod, name, lambda *a, _n=name: calls.append((_n, a)) or _n)
    for mod, name in ((bounce, "bounce_step_reference"), (acc, "hit_histogram_reference"),
                      (texel, "texel_bin_reference")):
        monkeypatch.setattr(mod, name, _must_not_run(name))
    orig, ids, counts, alive, atlas = _on("cuda:0"), _on("cuda:0"), _on("cuda:0"), _on("cuda:0"), object()
    assert bounce.bounce_step(KEY, orig, 2, 3, 4, 5, 6, 7, cell_meters=0.5) == "_bounce_step_kernel"
    assert acc.hit_histogram(ids, counts, alive) == "_hit_histogram_kernel"
    assert texel.texel_bin(atlas, orig, 2, 3, 4, 5, 6, 7, 8) == "_texel_bin_kernel"
    assert calls == [("_bounce_step_kernel", (KEY, orig, 2, 3, 4, 5, 6, 7, 0.5)),
                     ("_hit_histogram_kernel", (ids, counts, alive)),
                     ("_texel_bin_kernel", (atlas, orig, 2, 3, 4, 5, 6, 7, 8, None))]


def test_bounce_step_kernel_reaches_its_entry_point(on_card):
    before = launched("bounce_step_launch")
    o, d, t, hit, normals, refl, alive = _small_bounce(1000)
    out = bounce._bounce_step_kernel(KEY, o, d, t, hit, normals, refl, alive, 0.7)
    assert launched("bounce_step_launch") == before + 1
    [(name, device, args)] = on_card
    assert name == "bounce_step_launch" and device == o.device
    _check_signature(name, args)
    assert args[:4] == (int(KEY[0]), int(KEY[1]), 1000, float(np.float32(0.7)))
    assert [p.value for p in args[4:]] == [x.data_ptr() for x in (o, d, t, hit, alive, normals, refl, *out)]
    assert [(x.dtype, tuple(x.shape)) for x in out] == [(torch.float32, (1000, 3)), (torch.float32, (1000, 3)),
                                                        (torch.bool, (1000,)), (torch.int32, (1000,))]
    bounce._bounce_step_kernel(KEY, o[:0], d[:0], t[:0], hit[:0], normals, refl, alive[:0], 1.0)  # no launch
    assert len(on_card) == 1
    with pytest.raises(ValueError, match="hit_ids"):
        bounce._bounce_step_kernel(KEY, o, d, t, hit.long(), normals, refl, alive, 1.0)
    with pytest.raises(ValueError, match="normals"):
        bounce._bounce_step_kernel(KEY, o, d, t, hit, normals.t(), refl, alive, 1.0)


def test_hit_histogram_kernel_reaches_its_entry_point(on_card):
    before = launched("hit_histogram_launch")
    ids = torch.arange(-3, 997, dtype=torch.int32)
    counts = torch.zeros(70, dtype=torch.int32)
    alive = torch.ones(1000, dtype=torch.bool)
    assert acc._hit_histogram_kernel(ids, counts, alive) is counts
    assert acc._hit_histogram_kernel(ids, counts, None) is counts
    assert launched("hit_histogram_launch") == before + 2
    for (name, _, args), a in zip(on_card, (alive, None)):
        assert name == "hit_histogram_launch"
        _check_signature(name, args)
        assert args[:2] == (1000, 70)
        assert [p.value for p in args[2:]] == [ids.data_ptr(), None if a is None else a.data_ptr(), counts.data_ptr()]
    acc._hit_histogram_kernel(ids[:0], counts, None)  # nothing to count: no launch
    assert len(on_card) == 2
    with pytest.raises(ValueError, match="ids"):
        acc._hit_histogram_kernel(ids.long(), counts, None)
    with pytest.raises(ValueError, match="counts"):
        acc._hit_histogram_kernel(ids, counts.long(), None)


def test_hit_counts_on_cuda_runs_the_kernel_for_segment_and_sort(monkeypatch):
    """hit_counts, the JAX name the bench, entry() and the traversal checks
    call, histograms "segment" and "sort" through hit_histogram."""
    seen = []
    monkeypatch.setattr(acc, "hit_histogram", lambda ids, counts, alive=None: seen.append(alive) or counts)
    for method in ("segment", "sort"):
        acc.hit_counts(torch.zeros(8, dtype=torch.int32), 5, method)
    assert seen == [None, None]


def test_texel_bin_kernel_reaches_its_entry_point(on_card):
    before = launched("texel_bin_launch")
    atlas, (o, d, t, hit, v0, e1, e2), alive = _small_texels(1000)
    counts = torch.zeros(atlas.n_slots, dtype=torch.int32)
    assert texel._texel_bin_kernel(atlas, o, d, t, hit, v0, e1, e2, counts, alive) is counts
    assert launched("texel_bin_launch") == before + 1
    [(name, _, args)] = on_card
    assert name == "texel_bin_launch"
    _check_signature(name, args)
    assert args[:2] == (1000, atlas.n_slots)
    assert [p.value for p in args[2:]] == [x.data_ptr() for x in (o, d, t, hit, alive, v0, e1, e2, atlas.base,
                                                                   atlas.k, counts)]
    with pytest.raises(ValueError, match="tri_v0"):
        texel._texel_bin_kernel(atlas, o, d, t, hit, v0[:, :2], e1, e2, counts, None)
    with pytest.raises(ValueError, match="atlas.k"):
        texel._texel_bin_kernel(atlas._replace(k=atlas.k[:-1]), o, d, t, hit, v0, e1, e2, counts, None)


@pytest.mark.parametrize("kernel", ["bounce_step", "hit_histogram", "texel_bin"])
def test_a_failing_launch_raises(on_card, monkeypatch, kernel):
    """No fallback: a launch the card refuses raises, the plain version is
    not run in its place, and nothing is counted."""
    monkeypatch.setattr(_build, "call", lambda name, device, *args: 700)  # the card's error
    atlas, tens, alive = _small_texels()
    call = {
        "bounce_step": lambda: bounce._bounce_step_kernel(KEY, *_small_bounce(), 1.0),
        "hit_histogram": lambda: acc._hit_histogram_kernel(tens[3], torch.zeros(40, dtype=torch.int32), None),
        "texel_bin": lambda: texel._texel_bin_kernel(atlas, *tens, torch.zeros(atlas.n_slots, dtype=torch.int32),
                                                     alive),
    }[kernel]
    before = launched(f"{kernel}_launch")
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    assert launched(f"{kernel}_launch") == before


def test_other_devices_are_refused(on_card):
    meta = torch.empty(8, 3, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        bounce.bounce_step(KEY, meta, meta, meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        acc.hit_histogram(torch.empty(8, dtype=torch.int32, device="meta"),
                          torch.empty(8, dtype=torch.int32, device="meta"))
    with pytest.raises(ValueError, match="cpu or cuda"):
        texel.texel_bin(None, meta, meta, meta, meta, meta, meta, meta, meta)
    with pytest.raises(ValueError, match="counts on cpu"):
        acc.hit_histogram(torch.empty(8, dtype=torch.int32, device="meta"), torch.zeros(8, dtype=torch.int32))
    assert on_card == []


def test_launch_counts_runs_the_three_ops_per_segment(monkeypatch):
    """launch_counts with bounces and an atlas calls bounce_step once a
    bounce, hit_histogram once a bounce segment (and once for the primaries
    outside counts mode), texel_bin once a segment, each on the lanes alive
    in it, and gives the counts it gave before the ops were counted."""
    room = make_box_room(subdivisions=2, clutter=1, seed=3)
    from uvtrace_torch.sim import SimParams, Simulator

    params = SimParams(photon_count=3000, max_iterations=1, max_bounces=2, reflectance=0.5, texel_density=8.0,
                       traversal="pallas")
    sim = Simulator(room, params, ray_chunk=1024, device="cpu")
    kw = dict(t_count=sim.triangle_count, n=3000, chunk=1024, max_bounces=2, normals=sim._normals_launch,
              reflectance=sim._reflectance_launch(), atlas=sim._atlas_launch, n_texels=sim._n_texels,
              tri_v0=sim._tri_v0, tri_e1=sim._tri_e1, tri_e2=sim._tri_e2, sampler="native", **sim._trace)
    lamp = [0.1, room.floor_height + 0.8, -0.2]
    calls = []
    alive_at = {"bounce_step": 7, "hit_histogram": 2, "texel_bin": 9}  # the positional index of `alive`

    def spy(name, fn):
        def wrapped(*args):
            calls.append((name, len(args) > alive_at[name] and args[alive_at[name]] is not None))
            return fn(*args)
        return wrapped

    monkeypatch.setattr(launch, "bounce_step", spy("bounce_step", bounce.bounce_step))
    monkeypatch.setattr(acc, "hit_histogram", spy("hit_histogram", acc.hit_histogram))
    monkeypatch.setattr(texel, "texel_bin", spy("texel_bin", texel.texel_bin))
    counts, tex_counts, _ = launch.launch_counts(sim.scene, KEY, lamp, 1.0, **kw)
    assert int(counts.sum()) > 3000 and int(tex_counts.sum()) == int(counts.sum())
    chunk = [("hit_histogram", False), ("texel_bin", False)] + [
        ("bounce_step", True), ("hit_histogram", True), ("texel_bin", True)] * 2
    assert calls == chunk * 3


def test_texel_counts_are_texel_bin_for_every_method(monkeypatch):
    """The texel counts of a launch are texel_bin's integer histogram for
    every histogram method: "onehot" bins texels through texel_bin once a
    segment too, and gives the texel and hit counts of "segment"."""
    room = make_box_room(subdivisions=2, clutter=1, seed=3)
    from uvtrace_torch.sim import SimParams, Simulator

    params = SimParams(photon_count=3000, max_iterations=1, max_bounces=2, reflectance=0.5, texel_density=8.0,
                       traversal="pallas")
    sim = Simulator(room, params, ray_chunk=1024, device="cpu")
    kw = dict(t_count=sim.triangle_count, n=3000, chunk=1024, max_bounces=2, normals=sim._normals_launch,
              reflectance=sim._reflectance_launch(), atlas=sim._atlas_launch, n_texels=sim._n_texels,
              tri_v0=sim._tri_v0, tri_e1=sim._tri_e1, tri_e2=sim._tri_e2, sampler="native", **sim._trace)
    lamp = [0.1, room.floor_height + 0.8, -0.2]
    binned, texel_bin = [], texel.texel_bin

    def spy(*args):
        binned.append(args[0] is sim._atlas_launch)
        return texel_bin(*args)

    monkeypatch.setattr(texel, "texel_bin", spy)
    counts_s, tex_s, _ = launch.launch_counts(sim.scene, KEY, lamp, 1.0, method="segment", **kw)
    assert binned == [True] * 9  # 3 chunks x (primaries + 2 bounce segments)
    counts_o, tex_o, _ = launch.launch_counts(sim.scene, KEY, lamp, 1.0, method="onehot", **kw)
    assert binned == [True] * 18
    assert int(tex_s.sum()) > 3000
    assert torch.equal(tex_o, tex_s) and torch.equal(counts_o, counts_s)
