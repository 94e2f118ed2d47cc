"""A ``torch.distributed`` cohort of the port (``orion_tpu_torch.parallel``),
as the reference's ``tests/unit/test_parallel.py`` forms a
``jax.distributed`` one.

Setup: two processes on ``gloo``, each with 4 logical CPU slots, so the
cohort's mesh has 8 slots; a free localhost port for the rendezvous.
Pass: a cross-rank gather of an (8, 2) array, each rank holding only its
own rows, sums to 72.0 in both ranks; ``tpu_bo`` with ``use_mesh=True``
(the reference's two-process configuration: 3 dimensions, 8 observations,
4 random points, a 256-candidate pool, 5 fit steps) suggests the same rows
in both ranks, equal to a one-process 8-slot run's; a second
``init_distributed`` in a live cohort changes nothing.
"""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import torch

from orion_tpu_torch.algo.base import create_algo
from orion_tpu_torch.space.dsl import build_space

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = {"n_init": 4, "n_candidates": 256, "fit_steps": 5, "use_mesh": True}

_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from orion_tpu_torch.algo import sharding
from orion_tpu_torch.parallel import device_mesh, init_distributed, shard_candidates

rank, port, config = int(sys.argv[1]), sys.argv[2], json.loads(sys.argv[3])
init_distributed(coordinator=f"localhost:{port}", num_processes=2, process_id=rank,
                 local_device_ids=[0, 1, 2, 3], device="cpu")
mesh = device_mesh(device="cpu")
init_distributed(coordinator=f"localhost:{port}", num_processes=2, process_id=rank,
                 local_device_ids=[0, 1, 2, 3], device="cpu")
assert device_mesh(device="cpu") is mesh and (mesh.size, len(mesh.slots)) == (8, 4)
assert (mesh.rank, mesh.world, mesh.first_slot) == (rank, 2, 4 * rank)

# Each rank fills only the rows of its own slots: the sum counts the other
# rank's rows only if they crossed the process boundary.
rows = np.zeros((8, 2), np.float32)
for r in range(4 * rank, 4 * rank + 4):
    rows[r] = 1 + r
full = sharding.gather_candidates(shard_candidates(torch.from_numpy(rows), mesh))
print("PSUM", float(full.sum()), flush=True)

from orion_tpu_torch.algo.base import create_algo
from orion_tpu_torch.space.dsl import build_space

space = build_space({f"x{i}": "uniform(0, 1)" for i in range(3)})
algo = create_algo(space, {"tpu_bo": config}, seed=0, device="cpu")
x = np.random.default_rng(0).uniform(size=(8, 3))
algo.observe([{f"x{i}": float(v) for i, v in enumerate(r)} for r in x],
             [{"objective": float(v)} for v in np.random.default_rng(0).normal(size=8)])
out = algo.suggest(4)
print("RESULT", json.dumps([[p[k] for k in sorted(p)] for p in out]), flush=True)
print("HEALTH", json.dumps(algo.health_record()["mesh_devices"]), flush=True)
dist.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _one_process_rows():
    space = build_space({f"x{i}": "uniform(0, 1)" for i in range(3)})
    algo = create_algo(space, {"tpu_bo": dict(CONFIG, n_devices=8)}, seed=0, device="cpu")
    x = np.random.default_rng(0).uniform(size=(8, 3))
    algo.observe([{f"x{i}": float(v) for i, v in enumerate(r)} for r in x],
                 [{"objective": float(v)} for v in np.random.default_rng(0).normal(size=8)])
    return [[p[k] for k in sorted(p)] for p in algo.suggest(4)]


def test_two_process_cohort_sums_across_ranks_and_suggests_the_same_rows():
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _RANK, str(rank), str(port),
                               json.dumps(CONFIG)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for rank in (0, 1)]
    try:
        results = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    lines = []
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
        lines.append({ln.split(" ", 1)[0]: ln.split(" ", 1)[1] for ln in out.splitlines()
                      if ln.startswith(("PSUM", "RESULT", "HEALTH"))})
    assert float(lines[0]["PSUM"]) == float(lines[1]["PSUM"]) == 72.0
    assert lines[0]["RESULT"] == lines[1]["RESULT"]
    assert json.loads(lines[0]["RESULT"]) == _one_process_rows()
    assert lines[0]["HEALTH"] == lines[1]["HEALTH"] == "8"


def test_without_a_cohort_the_mesh_is_this_process():
    from orion_tpu_torch.algo.sharding import cohort, get_mesh

    assert cohort() is None
    mesh = get_mesh(8, device="cpu")
    assert (mesh.rank, mesh.world, mesh.size, len(mesh.slots)) == (0, 1, 8, 8)
    assert torch.device("cpu") == mesh.lead
