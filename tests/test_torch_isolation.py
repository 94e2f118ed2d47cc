"""The port stands alone: ``orion_tpu_torch`` and ``chip_smoke.py`` import
neither JAX (``jax``, ``jaxlib``, ``optax``) nor any module of the JAX
package ``orion_tpu`` — matched as the exact module or a dotted prefix, so
``orion_tpu_torch`` itself does not count.  The telemetry plane's, the
network plane's, the day-2 operations', the device plane's, the
doctor's and sanitizer's, the suggest gateway's, the static analysis' and
the benchmark library's modules are also checked by name, and for
importing without side effects."""

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


NETWORK_PLANE = ("storage.netdb", "storage.shard", "storage.migrate_ids", "cli.db",
                 "cli.info", "cli.setup_cmd", "cli.test_db_cmd")


def test_network_plane_stands_alone():
    """The network storage, the router, the id migrator and the ``db`` and
    ``info`` commands are among the checked files, and in a fresh
    interpreter importing them loads neither JAX nor ``orion_tpu`` and
    starts no thread and no server."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in NETWORK_PLANE:
        assert os.path.join("orion_tpu_torch", *name.split(".")) + ".py" in files
    modules = [f"orion_tpu_torch.{name}" for name in NETWORK_PLANE]
    code = (
        "import importlib, sys, threading\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


DAY2_PLANE = ("storage.faults", "storage.rebalance", "storage.drain", "storage.backup",
              "storage.soak", "testing")


def test_day2_operations_stand_alone():
    """The fault harness, the rebalancer, the drainer, backup and restore,
    the soak harness and the shipped test harness are among the checked
    files, and in a fresh interpreter importing them loads neither JAX nor
    ``orion_tpu``, starts no thread, server or proxy, leaves telemetry off
    and the storage singleton unset; the only registration is
    ``dumbalgo`` in the port's algorithm registry."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in DAY2_PLANE:
        assert os.path.join("orion_tpu_torch", *name.split(".")) + ".py" in files
    modules = [f"orion_tpu_torch.{name}" for name in DAY2_PLANE]
    code = (
        "import importlib, sys, threading\n"
        "from orion_tpu_torch.algo.base import algo_registry\n"
        "import orion_tpu_torch.algo.base as base\n"
        "base._import_builtins()\n"
        "before = set(algo_registry.names())\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "from orion_tpu_torch.telemetry import TELEMETRY\n"
        "from orion_tpu_torch.health import FLIGHT\n"
        "import orion_tpu_torch.storage.base as storage_base\n"
        "assert not TELEMETRY.enabled and not FLIGHT.enabled\n"
        "assert storage_base._storage_singleton is None\n"
        "assert set(algo_registry.names()) - before == {'dumbalgo'}\n"
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


DEVICE_PLANE = ("algo.step_graphs", "algo.prewarm", "algo.tpu_bo", "algo.asha_bo",
                "compiler_plane", "devmem", "hostbudget", "utils.jit_cache", "utils.flatten",
                "cli.profile", "cli.top")


def test_device_plane_stands_alone():
    """The step graphs, the prewarmer, the compiler plane, the memory
    sampler, the host budget, the build cache, ``flatten`` and the
    ``profile`` and ``top`` commands are among the checked files, and in a
    fresh interpreter importing them loads neither JAX nor ``orion_tpu``,
    starts no thread (the prewarmer starts its threads on an observe, never
    at import), initializes no CUDA and captures nothing."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in DEVICE_PLANE:
        assert os.path.join("orion_tpu_torch", *name.split(".")) + ".py" in files
    modules = [f"orion_tpu_torch.{name}" for name in DEVICE_PLANE]
    code = (
        "import importlib, sys, threading\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "import torch\n"
        "from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert STEP_GRAPHS.entries() == [] and STEP_GRAPHS.pool is None\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


DIAGNOSIS = ("analysis", "analysis.sanitizer", "analysis.engine", "analysis.lock_rules",
             "diagnosis", "diagnosis.trend", "diagnosis.engine", "diagnosis.snapshot",
             "diagnosis.rules_system", "diagnosis.rules_storage", "diagnosis.rules_gp",
             "diagnosis.rules_compiler", "diagnosis.watch", "cli.doctor", "cli.tsan")


def test_diagnosis_and_sanitizer_stand_alone():
    """The doctor's and the sanitizer's modules are among the checked
    files, and in a fresh interpreter importing them loads neither JAX nor
    ``orion_tpu``, starts no thread, leaves ``threading`` unpatched (the
    sanitizer is off unless ``ORION_TPU_TSAN`` asks) and initializes no
    CUDA."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in DIAGNOSIS:
        base = os.path.join("orion_tpu_torch", *name.split("."))
        assert base + ".py" in files or os.path.join(base, "__init__.py") in files, name
    modules = [f"orion_tpu_torch.{name}" for name in DIAGNOSIS]
    code = (
        "import importlib, sys, threading\n"
        "real = threading.Lock, threading.Event, threading.Thread.start\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "import torch\n"
        "from orion_tpu_torch.analysis.sanitizer import TSAN\n"
        "assert not TSAN.enabled\n"
        "assert (threading.Lock, threading.Event, threading.Thread.start) == real\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    env.pop("ORION_TPU_TSAN", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


SERVE_PLANE = ("serve", "serve.protocol", "serve.coalesce", "serve.fleet", "serve.gateway",
               "serve.client", "cli.serve")


def test_serve_plane_stands_alone():
    """The suggest gateway's modules and the ``serve`` command are among
    the checked files, and in a fresh interpreter importing them loads
    neither JAX nor ``orion_tpu`` (not even its JAX-free
    ``orion_tpu.serve.protocol``), starts no thread (the gateway's threads
    start with a ``GatewayServer``), initializes no CUDA and captures
    nothing."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in SERVE_PLANE:
        base = os.path.join("orion_tpu_torch", *name.split("."))
        assert base + ".py" in files or os.path.join(base, "__init__.py") in files, name
    modules = [f"orion_tpu_torch.{name}" for name in SERVE_PLANE]
    code = (
        "import importlib, sys, threading\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "import torch\n"
        "from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS\n"
        "assert threading.active_count() == 1, threading.enumerate()\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert STEP_GRAPHS.entries() == []\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


STATIC_ANALYSIS = ("analysis.engine", "analysis.jit_rules", "analysis.lock_rules",
                   "analysis.perf_rules", "analysis.storage_rules", "analysis.telemetry_rules",
                   "cli.lint", "cli.docgen")


def test_static_analysis_stands_alone():
    """The rule families and the ``lint`` and ``docgen`` commands are among
    the checked files, and in a fresh interpreter importing the rules and
    linting a fixture with every family loads neither JAX nor
    ``orion_tpu`` (not even its JAX-free ``orion_tpu.analysis``) nor
    torch: the lint reads source, it never imports what it checks."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in STATIC_ANALYSIS:
        base = os.path.join("orion_tpu_torch", *name.split("."))
        assert base + ".py" in files or os.path.join(base, "__init__.py") in files, name
    modules = [f"orion_tpu_torch.{name}" for name in STATIC_ANALYSIS if "cli" not in name]
    fixture = os.path.join(ROOT, "tests", "fixtures", "torch_lint", "capture_rules_cases.py")
    code = (
        "import importlib, sys\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "from orion_tpu_torch.analysis import run_lint\n"
        f"assert run_lint([{fixture!r}])\n"
        "assert 'torch' not in sys.modules\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


BENCHMARK_LIBRARY = ("benchmarks", "benchmarks.runner", "benchmarks.gram_bench",
                     "benchmarks.suggest_bench", "benchmarks.host_profile")


def test_benchmarks_stand_alone():
    """The benchmark library's modules are among the checked files, and in
    a fresh interpreter where importing ``jax`` or any ``orion_tpu`` module
    raises, they import, initialize no CUDA and capture nothing: the
    runner, the micro-benchmarks and the profiler need only the port."""
    files = {os.path.relpath(p, ROOT) for p in _port_files()}
    for name in BENCHMARK_LIBRARY:
        base = os.path.join("orion_tpu_torch", *name.split("."))
        assert base + ".py" in files or os.path.join(base, "__init__.py") in files, name
    modules = [f"orion_tpu_torch.{name}" for name in BENCHMARK_LIBRARY]
    code = (
        "import importlib, importlib.abc, sys\n"
        f"FORBIDDEN = {FORBIDDEN!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if any(name == f or name.startswith(f + '.') for f in FORBIDDEN):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for name in {modules!r}:\n"
        "    importlib.import_module(name)\n"
        "import torch\n"
        "from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS\n"
        "from orion_tpu_torch.benchmarks.runner import PRESETS\n"
        "assert len(PRESETS) == 11\n"
        "assert not torch.cuda.is_initialized()\n"
        "assert STEP_GRAPHS.entries() == []\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


#: Files outside the package that run on the port alone: its examples, the
#: third-party plugin fixture and the quadratic box its tests hunt.
STANDALONE_FILES = (
    os.path.join("examples", "torch_mnist_lenet.py"),
    os.path.join("examples", "torch_fidelity_sweep.py"),
    os.path.join("tests", "fixtures", "torch_gd_plugin", "orion_tpu_torch_gd.py"),
    os.path.join("tests", "fixtures", "torch_black_box.py"),
)


@pytest.mark.parametrize("path", STANDALONE_FILES)
def test_examples_and_plugin_fixture_import_no_jax_or_reference(path):
    bad = sorted({name for name in _imports(os.path.join(ROOT, path)) if _forbidden(name)})
    assert not bad, f"{path} imports {bad}"


def test_examples_and_plugin_fixture_load_without_jax():
    """In a fresh interpreter where importing ``jax`` or any ``orion_tpu``
    module raises, every one of those files loads as a module (the scripts'
    ``main`` stays behind its ``__main__`` guard)."""
    paths = [os.path.join(ROOT, p) for p in STANDALONE_FILES]
    code = (
        "import importlib.abc, importlib.util, sys\n"
        f"FORBIDDEN = {FORBIDDEN!r}\n"
        "class Block(importlib.abc.MetaPathFinder):\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if any(name == f or name.startswith(f + '.') for f in FORBIDDEN):\n"
        "            raise ImportError(f'blocked: {name}')\n"
        "        return None\n"
        "sys.meta_path.insert(0, Block())\n"
        f"for i, path in enumerate({paths!r}):\n"
        "    spec = importlib.util.spec_from_file_location(f'standalone_{i}', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in FORBIDDEN)\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
