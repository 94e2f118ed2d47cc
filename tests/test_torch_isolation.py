"""The port stands alone: ``orion_tpu_torch`` and ``chip_smoke.py`` import
neither JAX (``jax``, ``jaxlib``, ``optax``) nor any module of the JAX
package ``orion_tpu`` — matched as the exact module or a dotted prefix, so
``orion_tpu_torch`` itself does not count."""

import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "optax", "orion_tpu")


def _port_files():
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for base, _dirs, files in os.walk(os.path.join(ROOT, "orion_tpu_torch")):
        out.extend(os.path.join(base, f) for f in files if f.endswith(".py"))
    return sorted(out)


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _imports(path):
    with open(path) as handle:
        tree = ast.parse(handle.read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield node.args[0].value


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = sorted({name for name in _imports(path) if _forbidden(name)})
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def test_forbidden_prefix_is_exact():
    assert _forbidden("orion_tpu") and _forbidden("orion_tpu.algo.gp")
    assert _forbidden("jax.numpy") and _forbidden("optax")
    assert not _forbidden("orion_tpu_torch") and not _forbidden("orion_tpu_torch.ops")
    assert not _forbidden("jaxtyping")


def test_importing_every_port_module_loads_no_jax():
    """In a fresh interpreter (this one has JAX loaded by the conftest)."""
    modules = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(".__init__")
        for p in _port_files() if not p.endswith("chip_smoke.py")
    )
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
