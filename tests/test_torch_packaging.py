"""The port as a user installs it: ``pip install`` of the tree ships the
kernel's CUDA source (``pyproject.toml``'s package data), and the
installed copy builds its library under ``$XDG_CACHE_HOME/orion_tpu_torch``
while the checkout keeps ``build/orion_tpu_torch``.  ``chip_smoke.py``'s
``installed`` phase copies the tree the way these tests do, so the files it
copies must be the files pip installs."""

import json
import os
import subprocess
import sys

import pytest

import chip_smoke
from orion_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GRAM_CU = os.path.join("orion_tpu_torch", "ops", "csrc", "gram.cu")


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """A copy of the tree (``chip_smoke.copy_install_tree``) pip-installed
    into a ``--target`` directory: (site, files copied)."""
    tmp = tmp_path_factory.mktemp("install")
    src = tmp / "src"
    src.mkdir()
    copied = chip_smoke.copy_install_tree(str(src))
    site = tmp / "site"
    subprocess.run(
        [sys.executable, "-m", "pip", "install", "-q", "--no-deps", "--no-build-isolation",
         "--target", str(site), str(src)],
        check=True, timeout=240,
    )
    return str(site), copied


def test_pip_install_ships_the_kernel_source(installed):
    site, _copied = installed
    with open(os.path.join(site, GRAM_CU), "rb") as got, \
            open(os.path.join(ROOT, GRAM_CU), "rb") as want:
        assert got.read() == want.read()
    assert os.path.exists(os.path.join(site, "bin", "orion-tpu-torch"))


def test_chip_smoke_copies_what_pip_installs(installed):
    """Every file the phase copies under ``orion_tpu_torch/`` is installed,
    and pip installs nothing else there but bytecode."""
    site, copied = installed
    package = os.path.join(site, "orion_tpu_torch")
    pip_files = {f for f in chip_smoke.tree_files(package)
                 if "__pycache__" not in f.split(os.sep)}
    copied_files = {os.path.relpath(f, "orion_tpu_torch") for f in copied
                    if f.startswith("orion_tpu_torch" + os.sep)}
    assert copied_files == pip_files
    assert set(copied) - {os.path.join("orion_tpu_torch", f) for f in copied_files} == {
        "pyproject.toml", "README.md"}
    assert os.path.join("ops", "csrc", "gram.cu") in pip_files


def _build_paths(site, env, cwd):
    code = (
        "import json, orion_tpu_torch\n"
        "from orion_tpu_torch.ops import _build\n"
        "print(json.dumps([orion_tpu_torch.__file__, _build.BUILD_DIR,"
        " _build.library_path('gram')]))\n"
    )
    env = {**{k: v for k, v in os.environ.items() if k != "XDG_CACHE_HOME"}, **env,
           "PYTHONPATH": site}
    proc = subprocess.run([sys.executable, "-c", code], env=env, cwd=cwd,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    return json.loads(proc.stdout)


def test_installed_copy_builds_under_the_cache(installed, tmp_path):
    site, _copied = installed
    cache = str(tmp_path / "cache")
    module, build_dir, library = _build_paths(site, {"XDG_CACHE_HOME": cache}, str(tmp_path))
    assert module == os.path.join(site, "orion_tpu_torch", "__init__.py")
    assert build_dir == os.path.join(cache, "orion_tpu_torch")
    assert library.startswith(build_dir + os.sep) and library.endswith("libgram.so")
    assert not library.startswith(os.path.dirname(site) + os.sep)
    # The key is the hash of source and flags: the same as the checkout's.
    assert os.path.basename(os.path.dirname(library)) == \
        os.path.basename(os.path.dirname(_build.library_path("gram")))


def test_installed_copy_defaults_to_the_home_cache(installed, tmp_path):
    site, _copied = installed
    home = str(tmp_path / "home")
    _module, build_dir, _library = _build_paths(site, {"HOME": home}, str(tmp_path))
    assert build_dir == os.path.join(home, ".cache", "orion_tpu_torch")


def test_checkout_still_builds_under_its_build_directory(monkeypatch):
    build_dir = os.path.join(ROOT, "build", "orion_tpu_torch")
    assert _build.default_build_dir() == build_dir
    monkeypatch.setenv("XDG_CACHE_HOME", os.path.join(ROOT, "no-such-cache"))
    assert _build.default_build_dir() == build_dir
    monkeypatch.setattr(_build, "BUILD_DIR", build_dir)
    assert _build.library_path("gram").startswith(build_dir + os.sep)


@pytest.mark.parametrize("names_package", [True, False])
def test_build_directory_rule(tmp_path, monkeypatch, names_package):
    """A package whose parent holds a ``pyproject.toml`` naming it builds
    beside it; any other builds into the cache."""
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "cache"))
    root = tmp_path / "tree"
    (root / "orion_tpu_torch").mkdir(parents=True)
    (root / "pyproject.toml").write_text(
        'include = ["orion_tpu_torch*"]\n' if names_package else 'name = "other"\n')
    got = _build.default_build_dir(str(root / "orion_tpu_torch"))
    want = (root / "build" / "orion_tpu_torch" if names_package
            else tmp_path / "cache" / "orion_tpu_torch")
    assert got == str(want)
    assert _build.default_build_dir(str(tmp_path / "site" / "orion_tpu_torch")) == \
        str(tmp_path / "cache" / "orion_tpu_torch")


def test_missing_source_and_failed_nvcc_raise(tmp_path, monkeypatch):
    """No fallback to the plain version: a source that is not there, or an
    ``nvcc`` that fails, raises out of ``build``."""
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(FileNotFoundError):
        _build.build("no_such_kernel")
    fake = tmp_path / "cuda" / "bin"
    fake.mkdir(parents=True)
    (fake / "nvcc").write_text("#!/bin/sh\necho 'nvcc: refused' >&2\nexit 3\n")
    (fake / "nvcc").chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    with pytest.raises(RuntimeError, match="nvcc failed to build gram.cu"):
        _build.build("gram")
    assert not os.path.exists(_build.library_path("gram"))
