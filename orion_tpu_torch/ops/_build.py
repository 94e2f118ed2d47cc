"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
library with a plain C interface, loaded with :mod:`ctypes`.  The output
lives in a directory keyed by a hash of the source and the flags, so an
edited kernel is rebuilt and an unchanged one is reused.  Where the
package runs from a checkout (its parent directory holds the
``pyproject.toml`` that names it), that is under ``build/orion_tpu_torch/``
at the checkout's root (listed in ``.gitignore``); an installed package
builds into ``$XDG_CACHE_HOME/orion_tpu_torch`` (``~/.cache/orion_tpu_torch``
by default), since a system's ``site-packages`` is not the user's to write.
The sources ship with the package (``pyproject.toml``'s package data).
Nothing here builds at import time: the CPU tests import every module of
the port on machines without ``nvcc``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_PACKAGE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PACKAGE, "ops", "csrc")


def default_build_dir(package=_PACKAGE):
    """The build directory of the package at ``package``: the checkout's
    ``build/orion_tpu_torch`` when the package's parent holds the
    ``pyproject.toml`` that names it, else the user's cache."""
    root = os.path.dirname(package)
    try:
        with open(os.path.join(root, "pyproject.toml")) as handle:
            checkout = os.path.basename(package) in handle.read()
    except OSError:
        checkout = False
    if checkout:
        return os.path.join(root, "build", "orion_tpu_torch")
    cache = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(cache, "orion_tpu_torch")


BUILD_DIR = default_build_dir()

#: ``-Xptxas -v`` writes each kernel's register and spill report into the
#: build log (``<library>.log``).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded = {}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH,
    else ``/usr/local/cuda/bin/nvcc``."""
    home = os.environ.get("CUDA_HOME")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def library_path(name):
    """Where ``csrc/<name>.cu`` builds to: keyed by source and flags."""
    with open(os.path.join(_CSRC, f"{name}.cu"), "rb") as handle:
        digest = hashlib.sha256(handle.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, digest[:16], f"lib{name}.so")


def build(name):
    """Compile ``csrc/<name>.cu`` unless its library exists; returns the
    library's path, with nvcc's output (ptxas' register report included)
    beside it in ``<path>.log``.  A failed build raises with nvcc's
    output.  The library is written to a temporary name and renamed into place, so a
    concurrent or interrupted build never leaves a partial file behind."""
    target = library_path(name)
    if os.path.exists(target):
        return target
    os.makedirs(os.path.dirname(target), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(target))
    os.close(fd)
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(_CSRC, f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        os.unlink(tmp)
        raise RuntimeError(f"cannot run nvcc ({cmd[0]}): {exc}") from exc
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed to build {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    with open(target + ".log", "w") as handle:
        handle.write(proc.stdout + proc.stderr)
    os.replace(tmp, target)
    return target


def load(name):
    """The loaded :class:`ctypes.CDLL` of ``csrc/<name>.cu``, built on
    first use and cached for the life of the process.  The lock is taken
    only to build and load: a loaded library is returned without it, so a
    launch made under another lock (a round under the step-graph lock)
    takes none of this module's."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            lib = ctypes.CDLL(build(name))
            _loaded[name] = lib
        return lib
