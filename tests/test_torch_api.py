"""The port's package surface against the JAX package's.

Every name that an `__init__.py` of uvtrace/ re-exports (uvtrace,
uvtrace.geometry, uvtrace.io, uvtrace.bvh, uvtrace.ops) has a counterpart of
the same name and kind (class, function or module) in the same place of
uvtrace_torch/. The names come from the JAX files' import statements, read
with ast, so a name added there without its port fails here. And importing
the port, with every name and the entry-point modules, pulls in neither jax
nor the JAX package, and builds or loads no kernel.
"""

import ast
import importlib
import inspect
import os
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
PACKAGES = ("uvtrace", "uvtrace.geometry", "uvtrace.io", "uvtrace.bvh", "uvtrace.ops")


def _reexports(package: str) -> list[str]:
    """The names `package`'s __init__.py imports, in order."""
    path = os.path.join(ROOT, *package.split("."), "__init__.py")
    tree = ast.parse(open(path).read())
    return [a.asname or a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names]


CASES = [(package, name) for package in PACKAGES for name in _reexports(package)]


def _kind(obj) -> str:
    if inspect.ismodule(obj):
        return "module"
    if inspect.isclass(obj):
        return "class"
    if inspect.isfunction(obj):
        return "function"
    return type(obj).__name__


@pytest.mark.parametrize("package,name", CASES, ids=[f"{p}.{n}" for p, n in CASES])
def test_port_reexports_the_jax_name(package, name):
    jax_obj = getattr(importlib.import_module(package), name)
    port_package = "uvtrace_torch" + package[len("uvtrace"):]
    port_obj = getattr(importlib.import_module(port_package), name, None)
    assert port_obj is not None, f"{port_package} lacks {name}"
    assert _kind(port_obj) == _kind(jax_obj)
    if inspect.ismodule(jax_obj):
        assert port_obj.__name__ == "uvtrace_torch" + jax_obj.__name__[len("uvtrace"):]
    else:
        assert port_obj.__name__ == jax_obj.__name__
        assert port_obj.__module__.startswith("uvtrace_torch.")


def test_port_imports_no_jax_and_no_kernel():
    """A fresh interpreter imports every re-exported name, the CLI, the bench
    and the entry points: no jax, no module of the JAX package, no kernel
    library (uvtrace_torch._build builds and loads on first use)."""
    imports = "\n".join(f"from uvtrace_torch{p[len('uvtrace'):]} import {', '.join(_reexports(p))}"
                        for p in PACKAGES)
    code = f"""
import sys
{imports}
import uvtrace_torch.cli, uvtrace_torch.bench, uvtrace_torch.entry
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "jaxlib"))
             or m == "uvtrace" or m.startswith("uvtrace.") or m == "uvtrace_torch._build")
print(repr(bad))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
