"""The port's entry points (uvtrace_torch/entry.py) against the repo root's
__graft_entry__.py, on the CPU.

entry("cpu")'s step and __graft_entry__.entry()'s step jitted on the CPU run
the same pipeline (generate_stratified -> the budget-free clustered
traversal -> histogram -> accumulate_dose) on the same small room from the
same key. Their rays differ where generate_stratified's dir.x/z differ from
XLA-CPU's by up to 2 ulp (cos/sin), which may flip a hit at an edge: at most
0.1% of the 2048 rays (3), each moving two triangle counts by one, so the
photon maps (counts x the duration, 60) differ by at most 6 x 60 in sum and
the max maps by at most 6 in sum. The dry run spawns gloo ranks and prints
one [dryrun] line for each section it runs.
"""

import math
import os
import sys

import jax
import numpy as np

from uvtrace_torch import entry as port_entry

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
import __graft_entry__ as jax_entry  # noqa: E402  the repo root's module


def test_entry_step_matches_graft_entry():
    fn, args = port_entry.entry("cpu")
    photon, max_photon = (x.numpy() for x in fn(*args))
    jfn, jargs = jax_entry.entry()
    jphoton, jmax = (np.asarray(x) for x in jax.jit(jfn)(*jargs))
    assert photon.shape == jphoton.shape == (port_entry._make_scene()[0].triangle_count,)
    flips = math.ceil(port_entry.N_RAYS / 1000)
    duration = args[5]
    assert duration == float(jargs[5]) == 60.0
    assert np.abs(max_photon - jmax).sum() <= 2 * flips
    assert np.abs(photon - jphoton).sum() <= 2 * flips * duration
    assert photon.sum() == port_entry.N_RAYS * duration  # a closed room: every ray hits
    np.testing.assert_array_equal(photon, max_photon * duration)


def test_entry_example_args_are_graft_entrys():
    _, args = port_entry.entry("cpu")
    _, jargs = jax_entry.entry()
    np.testing.assert_array_equal(args[3], np.asarray(jargs[3]))  # PRNGKey(0)'s two words
    np.testing.assert_array_equal(np.asarray(args[4], np.float32), np.asarray(jargs[4]))
    assert not args[1].any() and not args[2].any() and not np.asarray(jargs[1]).any()


def test_dryrun_four_ranks_prints_three_sections(capsys):
    port_entry.dryrun_multichip(4, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3 and all(ln.startswith("[dryrun] ok: ") for ln in lines)
    assert "rays:4" in lines[0] and "rays:4" in lines[1] and "rays:2 x texels:2" in lines[2]


def test_dryrun_one_rank_prints_two_sections(capsys):
    port_entry.dryrun_multichip(1, device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 2 and all(ln.startswith("[dryrun] ok: ") for ln in lines)
