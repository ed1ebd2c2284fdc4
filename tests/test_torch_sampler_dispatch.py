"""The samplers' dispatch: a CUDA request launches the kernel of
csrc/samplers.cu (K1 `rng.uniform`, K2 `generate_stratified`, K3
`generate_reference`) or raises, a CPU request runs the plain version and
never touches the kernel library.

There is no card here, so a CUDA request is followed as far as the C entry
point: `_build.call`, the C call behind `_build.launch`, is replaced by a
recorder (or by a failure), output
tensors are allocated on the CPU, and the plain bodies raise if they are
reached. The entry point's arguments are checked against the ctypes
signature that `_build.load` gives it. Bit equality of the kernels to the
plain versions is tests/test_torch_cuda.py's, on the card; the plain
versions' equality to JAX is tests/test_torch_rng.py's, test_torch_split.py's
and test_torch_samplers.py's.
"""

import contextlib
import types

import numpy as np
import pytest
import torch

from uvtrace_torch import _build
from uvtrace_torch.ops import generate as gen
from uvtrace_torch.ops import rng
from uvtrace_torch.ops.bounce import bounce_rays
from uvtrace_torch.utils import timing

LAMP = (0.3, -0.45, 1.1)
KEY = rng.fold_in(rng.PRNGKey(7), 3)


def launched(entry: str) -> int:
    """Launches of the C entry point `entry` counted so far."""
    return timing.counters()[f"launches.{entry}"]


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
    """A CUDA request as far as the C entry point: outputs on the CPU, the
    plain bodies refused, and every `_build.call` recorded."""
    real_empty = torch.empty

    def empty(*args, device=None, **kwargs):
        assert torch.device(device).type == "cuda"
        return real_empty(*args, **kwargs)

    monkeypatch.setattr(torch, "empty", empty)
    for mod, name in ((rng, "uniform_reference"), (rng, "random_bits"), (rng, "photon_seeds"),
                      (gen, "generate_stratified_reference"), (gen, "generate_reference_reference")):
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


def test_cpu_draws_never_touch_the_kernel_library(no_library):
    samplers = ("threefry_uniform_launch", "generate_stratified_launch", "generate_reference_launch")
    before = [launched(e) for e in samplers]
    u = rng.uniform(KEY, (3, 5), "cpu", minval=-1.0, maxval=1.0)
    assert torch.equal(u, rng.uniform_reference(KEY, (3, 5), "cpu", minval=-1.0, maxval=1.0))
    s = gen.generate_stratified(KEY, 2048, LAMP, 1.0, device=torch.device("cpu"))
    s_ref = gen.generate_stratified_reference(KEY, 2048, LAMP, 1.0)
    assert torch.equal(s.orig, s_ref.orig) and torch.equal(s.dir, s_ref.dir)
    r = gen.generate_reference(1023, LAMP, 1.0, 12345, 2**31 - 7)
    r_ref = gen.generate_reference_reference(1023, LAMP, 1.0, 12345, 2**31 - 7)
    assert torch.equal(r.orig, r_ref.orig) and torch.equal(r.dir, r_ref.dir)
    nat = gen.generate_native(KEY, 1000, LAMP, 1.0)
    n = 1000
    normals = torch.nn.functional.normalize(torch.from_numpy(
        np.random.default_rng(0).normal(size=(8, 3)).astype(np.float32)), dim=1)
    hit = torch.from_numpy(np.random.default_rng(1).integers(-1, 8, n).astype(np.int32))
    bo, bd, alive = bounce_rays(KEY, nat.orig, nat.dir, torch.ones(n), hit, normals, torch.full((8,), 0.5),
                                torch.ones(n, dtype=torch.bool))
    assert bo.shape == bd.shape == (n, 3) and bool(alive.any())
    assert [launched(e) for e in samplers] == before


def test_uniform_on_cuda_reaches_its_launcher(on_card):
    before = launched("threefry_uniform_launch")
    u = rng.uniform(KEY, (4, 202, 1), "cuda", minval=0.0, maxval=2.0 * np.pi)
    assert u.shape == (4, 202, 1) and u.dtype == torch.float32
    assert launched("threefry_uniform_launch") == before + 1
    [(name, device, args)] = on_card
    assert name == "threefry_uniform_launch" and device.type == "cuda"
    _check_signature(name, args)
    k0, k1, lo, scale, n = args[:5]
    assert (k0, k1) == tuple(int(w) for w in KEY) and n == 4 * 202
    assert lo == 0.0 and scale == float(np.float32(2.0 * np.pi))
    assert args[5].value == u.data_ptr()
    rng.uniform(KEY, 0, "cuda")  # nothing to draw: no launch
    assert launched("threefry_uniform_launch") == before + 1 and len(on_card) == 1


def test_generate_stratified_on_cuda_reaches_its_launcher(on_card):
    before = launched("generate_stratified_launch")
    rays = gen.generate_stratified(KEY, 3 * 4096, LAMP, 0.7, packet=4096, height_bands=4, device="cuda:0")
    assert rays.orig.shape == rays.dir.shape == (3 * 4096, 3)
    assert launched("generate_stratified_launch") == before + 1
    [(name, device, args)] = on_card
    assert name == "generate_stratified_launch" and device.type == "cuda"
    _check_signature(name, args)
    assert list(args[:6]) == [int(w) for w in rng.split(KEY, 3).reshape(-1)]
    assert tuple(args[6:11]) == (3 * 4096, 4096, *gen._stratum_grid(3, height_bands=4))
    assert tuple(args[11:15]) == tuple(float(np.float32(v)) for v in (*LAMP, 0.7))
    assert (args[15].value, args[16].value) == (rays.orig.data_ptr(), rays.dir.data_ptr())
    with pytest.raises(ValueError, match="whole number of packets"):
        gen.generate_stratified(KEY, 1000, LAMP, 1.0, device="cuda")


@pytest.mark.parametrize("start", [0, 2**31 - 5, -3])
def test_generate_reference_on_cuda_reaches_its_launcher(on_card, start):
    before = launched("generate_reference_launch")
    lamp = (-2.5, -1.2, -3.75)
    rays = gen.generate_reference(1023, lamp, 1.0, 3458748736, start, device="cuda")
    assert rays.orig.shape == rays.dir.shape == (1023, 3)
    assert launched("generate_reference_launch") == before + 1
    [(name, device, args)] = on_card
    assert name == "generate_reference_launch"
    _check_signature(name, args)
    x, y, z = (np.float32(v) for v in lamp)
    assert args[:2] == (1023, start & 0xFFFFFFFF)
    # rng.photon_seeds' f32 terms, then the lamp, the rod and the rounds
    assert args[2:6] == (float(x * np.float32(13)), float(y * np.float32(7)), float(z * np.float32(11)),
                         float(np.float32(3458748736 >> 15)))
    assert args[6:11] == (float(x), float(y), float(z), 1.0, gen.REJECTION_ROUNDS)


def test_native_sampler_on_cuda_draws_through_k1(monkeypatch):
    """generate_native's three draws go through the kernel's launcher, with
    the bounds of their jax.random.uniform calls."""
    plain = rng.uniform_reference
    calls = []

    def launcher(key, shape, device, lo, hi):
        calls.append((tuple(int(w) for w in key), shape, device.type, lo, hi))
        return plain(key, shape, "cpu", lo, hi)

    monkeypatch.setattr(rng, "_uniform_kernel", launcher)
    monkeypatch.setattr(rng, "uniform_reference", _must_not_run("uniform_reference"))
    gen.generate_native(KEY, 1000, LAMP, 1.0, device="cuda")
    keys = [tuple(int(w) for w in k) for k in rng.split(KEY, 3)]
    assert calls == [(keys[0], (1000,), "cuda", 0.0, 1.0), (keys[1], (1000,), "cuda", -1.0, 1.0),
                     (keys[2], (1000,), "cuda", 0.0, np.float32(2.0 * np.pi))]


@pytest.mark.parametrize("kernel", ["uniform", "stratified", "reference"])
def test_a_failing_launch_raises(on_card, monkeypatch, kernel):
    """No fallback: a launch the card refuses raises, the plain version is
    not run in its place, and nothing is counted."""
    monkeypatch.setattr(_build, "call", lambda name, device, *args: 700)  # the card's error
    call, entry = {
        "uniform": (lambda: rng.uniform(KEY, 1023, "cuda"), "threefry_uniform_launch"),
        "stratified": (lambda: gen.generate_stratified(KEY, 2048, LAMP, 1.0, device="cuda"),
                       "generate_stratified_launch"),
        "reference": (lambda: gen.generate_reference(1023, LAMP, 1.0, 5, 0, device="cuda"),
                      "generate_reference_launch"),
    }[kernel]
    before = launched(entry)
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        call()
    assert launched(entry) == before


def test_launch_raises_on_a_cuda_error(monkeypatch):
    """`_build.launch` passes the stream last and raises on a non-zero
    return of the C entry point."""
    seen = []

    def entry(*args):
        seen.append(args)
        return entry.rc

    monkeypatch.setattr(_build, "load", lambda: types.SimpleNamespace(threefry_uniform_launch=entry))
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device: types.SimpleNamespace(cuda_stream=1234))
    entry.rc = 0
    before = launched("threefry_uniform_launch")
    _build.launch("threefry_uniform_launch", torch.device("cuda"), 1, 2)
    assert seen[0][:2] == (1, 2) and seen[0][2].value == 1234
    assert launched("threefry_uniform_launch") == before + 1
    entry.rc = 700
    with pytest.raises(RuntimeError, match="threefry_uniform_launch failed with CUDA error 700"):
        _build.launch("threefry_uniform_launch", torch.device("cuda"), 1, 2)
    assert launched("threefry_uniform_launch") == before + 1  # a refused launch is not counted


def test_other_devices_and_sizes_are_refused(on_card):
    with pytest.raises(ValueError, match="cpu or cuda"):
        rng.uniform(KEY, 8, "meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gen.generate_stratified(KEY, 1024, LAMP, 1.0, device="meta")
    with pytest.raises(ValueError, match="cpu or cuda"):
        gen.generate_reference(8, LAMP, 1.0, device="meta")
    with pytest.raises(ValueError, match="fewer than 2\\^31"):
        rng.uniform(KEY, (1 << 16, 1 << 15), "cuda")
    assert on_card == []
