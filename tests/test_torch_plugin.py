"""Third-party algorithm plugins of the port, proven as the reference proves
its own (``tests/functional/test_demo.py``, the pip-installed
``gd_plugin``): the fixture package ``tests/fixtures/torch_gd_plugin`` is
pip-installed from a copy into an isolated ``--target`` directory, found
only through its ``orion_tpu_torch.algo`` entry point in a fresh
interpreter, and its gradient descent converges a CLI hunt of the port on
the quadratic demo box (optimum 23.4 at x=34.56)."""

import os
import shutil
import subprocess
import sys

import pytest

from orion_tpu_torch.storage.base import create_storage

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FIXTURE = os.path.join(HERE, "fixtures", "torch_gd_plugin")
BLACK_BOX = os.path.join(HERE, "fixtures", "torch_black_box.py")


@pytest.fixture(scope="module")
def site(tmp_path_factory):
    """The fixture package installed from a copy (an in-place build would
    write ``build/`` and egg-info into the checkout) into a ``--target``
    directory."""
    tmp = tmp_path_factory.mktemp("torch_gd_plugin")
    copy = str(tmp / "src")
    shutil.copytree(FIXTURE, copy)
    target = tmp / "site"
    subprocess.run(
        [sys.executable, "-m", "pip", "install", "-q", "--no-deps", "--no-build-isolation",
         "--target", str(target), copy],
        check=True, timeout=240,
    )
    return str(target)


def _env(site):
    return dict(os.environ, PYTHONPATH=os.pathsep.join([site, ROOT]))


def test_plugin_is_found_only_through_its_entry_point(site, tmp_path):
    """In a fresh interpreter the registry loads the class from the entry
    point: the module is not imported before the lookup, and without the
    install the name is unknown."""
    code = (
        "import sys\n"
        "from orion_tpu_torch.algo.base import algo_registry, create_algo\n"
        "from orion_tpu_torch.space.dsl import build_space\n"
        "assert 'orion_tpu_torch_gd' not in sys.modules\n"
        "cls = algo_registry.get('gradient_descent')\n"
        "print(cls.__module__, cls.__name__)\n"
        "algo = create_algo(build_space({'x': 'uniform(-50, 50)'}),\n"
        "                   {'gradient_descent': {'learning_rate': 0.3}}, seed=1, device='cpu')\n"
        "print(algo.configuration)\n"
    )
    found = subprocess.run([sys.executable, "-c", code], env=_env(site), cwd=str(tmp_path),
                           capture_output=True, text=True, timeout=120)
    assert found.returncode == 0, found.stderr[-2000:]
    lines = found.stdout.splitlines()
    assert lines[0] == "orion_tpu_torch_gd GradientDescent"
    assert lines[1] == "{'gradientdescent': {'learning_rate': 0.3, 'seed': 1}}"
    missing = subprocess.run([sys.executable, "-c", code], env=_env(str(tmp_path / "none")),
                             cwd=str(tmp_path), capture_output=True, text=True, timeout=120)
    assert missing.returncode != 0
    assert "Unknown algo 'gradient_descent'" in missing.stderr


def test_pip_installed_plugin_algorithm_end_to_end(site, tmp_path):
    """A real ``orion_tpu_torch.cli hunt`` with the plugin, on the CPU."""
    conf = tmp_path / "conf.yaml"
    conf.write_text(
        "algorithms: {gradient_descent: {learning_rate: 0.3}}\n"
        "strategy: NoParallelStrategy\n"
    )
    db = str(tmp_path / "db.pkl")
    out = subprocess.run(
        [sys.executable, "-m", "orion_tpu_torch.cli", "hunt", "-n", "gd-plugin",
         "-c", str(conf), "--storage-path", db, "--max-trials", "25",
         "--worker-trials", "25", "--device", "cpu", BLACK_BOX, "-x~uniform(-50,50)"],
        env=_env(site), cwd=str(tmp_path), capture_output=True, text=True, timeout=600,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    storage = create_storage({"type": "pickled", "path": db})
    exp = storage.fetch_experiments({"name": "gd-plugin"})[0]
    assert exp["algorithms"] == {"gradient_descent": {"learning_rate": 0.3}}
    values = [
        t.objective.value
        for t in storage.fetch_trials(uid=exp["_id"])
        if t.status == "completed" and t.objective
    ]
    assert len(values) == 25
    # x_{k+1} = x_k - 0.3 * 2(x_k - 34.56): |x - 34.56| shrinks 0.4x per
    # step, so 24 descent steps from anywhere in [-50, 50] land far below
    # 1e-4 above the optimum.
    assert 23.4 - 1e-9 <= min(values) < 23.4 + 1e-4
