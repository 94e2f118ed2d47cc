"""The port stands alone: ``orion_tpu_torch`` and ``chip_smoke.py`` import
neither JAX (``jax``, ``jaxlib``, ``optax``) nor any module of the JAX
package ``orion_tpu`` — matched as the exact module or a dotted prefix, so
``orion_tpu_torch`` itself does not count.  The telemetry plane's modules
are also checked by name, and for importing without side effects."""

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


def test_opening_a_reference_pickled_db_loads_no_jax(tmp_path):
    """A ``pickled`` file that ``orion_tpu`` wrote holds its classes; the
    port opens it (``convert.storage_from_jax``) and resumes its experiment
    in a fresh interpreter without loading ``orion_tpu`` or JAX."""
    from test_torch_storage import write_reference_db

    path = str(tmp_path / "ref.pkl")
    experiments, trial_docs = write_reference_db(path)
    code = (
        "import sys\n"
        "from orion_tpu_torch.convert import storage_from_jax\n"
        "from orion_tpu_torch.core.experiment import build_experiment\n"
        f"storage = storage_from_jax({path!r})\n"
        "exp = build_experiment(storage, 'resume', priors=dict(storage.fetch_experiments({})"
        "[0]['priors']))\n"
        f"assert exp.id == {experiments[0]['_id']!r}\n"
        f"assert len(exp.fetch_trials()) == {len(trial_docs)}\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


TELEMETRY_PLANE = ("telemetry", "tracing", "metrics", "health", "cli.metrics", "cli.trace",
                   "cli.flight_record")


def test_telemetry_plane_stands_alone():
    """The telemetry plane's modules are among the checked files, and in a
    fresh interpreter importing them (and the worker loop that starts the
    metrics server) loads neither JAX nor ``orion_tpu`` and starts no
    thread: the server starts with a worker loop, never at import."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in TELEMETRY_PLANE:
        assert os.path.join("orion_tpu_torch", *name.split(".")) + ".py" in files
    modules = [f"orion_tpu_torch.{name}" for name in TELEMETRY_PLANE]
    modules.append("orion_tpu_torch.core.worker")
    code = (
        "import importlib, sys, threading\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from orion_tpu_torch.telemetry import TELEMETRY\n"
        "from orion_tpu_torch.health import FLIGHT\n"
        "assert not TELEMETRY.enabled and not FLIGHT.enabled\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items()
           if k not in ("ORION_TPU_TELEMETRY", "ORION_TPU_FLIGHT", "ORION_TPU_METRICS_PORT")}
    env["PYTHONPATH"] = ROOT
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
