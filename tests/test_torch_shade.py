"""The port's accumulation and shading against uvtrace/ops/accumulate.py and
uvtrace/ops/shade.py on the same inputs. All are f32 elementwise maps in the
same operation order, so they agree exactly or to a few ulps (rtol 1e-6)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from uvtrace.ops import accumulate as jax_acc
from uvtrace.ops import shade as jax_shade
from uvtrace_torch.ops import accumulate as acc
from uvtrace_torch.ops import shade


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    t = 257
    return dict(
        tris=rng.normal(size=(t, 3, 3)).astype(np.float32),
        counts=rng.integers(0, 5000, size=t).astype(np.int32),
        pmap=rng.uniform(0, 1e4, size=t).astype(np.float32),
        field=rng.uniform(-0.2, 1.3, size=t).astype(np.float32),
    )


def test_slots_to_tri_matches_jax(data):
    rng = np.random.default_rng(2)
    t = data["counts"].shape[0]
    slot_map = np.full(6 * 64, -1, np.int32)
    slot_map[rng.choice(slot_map.size, t, replace=False)] = rng.permutation(t)
    counts_slots = rng.integers(0, 100, size=slot_map.size).astype(np.int32)
    ref = np.asarray(jax_acc.slots_to_tri(jnp.asarray(counts_slots), jnp.asarray(slot_map), t))
    got = acc.slots_to_tri(torch.from_numpy(counts_slots), torch.from_numpy(slot_map), t)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_accumulate_dose_matches_jax(data):
    pm, mx = data["pmap"], data["pmap"][::-1].copy()
    for step in (1.0, 0.37, 2.5):
        ref = jax_acc.accumulate_dose(jnp.asarray(pm), jnp.asarray(mx), jnp.asarray(data["counts"]), step)
        got = acc.accumulate_dose(torch.from_numpy(pm), torch.from_numpy(mx),
                                  torch.from_numpy(data["counts"]), step)
        for r, g in zip(ref, got):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_areas_and_dosage_match_jax(data):
    areas_ref = np.array(jax_shade.triangle_areas(jnp.asarray(data["tris"])))
    areas = shade.triangle_areas(torch.from_numpy(data["tris"]))
    np.testing.assert_allclose(areas.numpy(), areas_ref, rtol=1e-6)
    for n, power in [(3072, 45.0), (1 << 20, 450.0 * 100.0)]:
        ref = jax_shade.compute_dosage(jnp.asarray(data["pmap"]), jnp.asarray(areas_ref), n, power)
        got = shade.compute_dosage(torch.from_numpy(data["pmap"]), torch.from_numpy(areas_ref), n, power)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)


@pytest.mark.parametrize("threshold_view", [False, True])
def test_colors_match_jax(data, threshold_view):
    f = data["field"]
    np.testing.assert_allclose(shade.greyscale_to_heatmap(torch.from_numpy(f)).numpy(),
                               np.asarray(jax_shade.greyscale_to_heatmap(jnp.asarray(f))), rtol=1e-6)
    dose = f * 300.0
    ref = jax_shade.dosage_to_color(jnp.asarray(dose), 100.0, threshold_view)
    got = shade.dosage_to_color(torch.from_numpy(dose), 100.0, threshold_view)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6, atol=1e-7)
