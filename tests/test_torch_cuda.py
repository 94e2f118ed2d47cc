"""The port's CUDA kernels on the card (marked ``cuda``; they skip without
one).  This file imports no JAX, so the machine with the card, which has
none, runs it without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import json
import time

import pytest
import torch

from orion_tpu_torch.ops import gram
from orion_tpu_torch.ops.gram import fused_gram, fused_gram_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import orion_tpu_torch.device  # noqa: F401  (TF32 off)

    return torch.device("cuda")


def _inputs(device, m, n, d, seed=0):
    gen = torch.Generator(device=device).manual_seed(seed)
    xa = torch.rand((m, d), generator=gen, device=device)
    xb = torch.rand((n, d), generator=gen, device=device)
    ils = 0.5 + 2.5 * torch.rand((d,), generator=gen, device=device)
    return xa, xb, ils, torch.tensor(1.7, device=device)


# (m, n, d) and the launch plan's path for it: (resident b, float4 stores).
SHAPES = [
    ((16384, 256, 6), (True, True)),  # the main path
    ((300, 70, 6), (True, False)),  # ragged on every axis
    ((513, 129, 130), (False, False)),  # chunked over d, ragged
    ((8192, 512, 50), (False, True)),  # chunked, b 100 KB
    ((16384, 257, 6), (True, False)),  # n odd
    ((1, 1, 1), (True, False)),
    ((64, 4, 6), (True, True)),  # a single tile
    ((100000, 256, 6), (True, True)),  # many tiles per persistent block
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["matern52", "rbf"])
@pytest.mark.parametrize("shape,path", SHAPES, ids=["x".join(map(str, s)) for s, _ in SHAPES])
def test_fused_gram_kernel_matches_plain_version(cuda, kind, shape, path):
    """The sm_90a kernel against its plain version (atol 1e-5 * amplitude,
    as chip_smoke.py) on the launch plan's path for the shape, with one
    launch counted."""
    m, n, d = shape
    plan = gram._launch_plan(m, n, d, True)
    assert (plan.resident, plan.vec) == path
    xa, xb, ils, amp = _inputs(cuda, m, n, d)
    before = gram.fused_gram.launches
    got = fused_gram(xa, xb, ils, amp, kind=kind)
    assert gram.fused_gram.launches == before + 1
    want = fused_gram_reference(xa, xb, ils, amp, kind=kind)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * 1.7


@pytest.mark.cuda
def test_fused_gram_is_one_launch_per_call(cuda):
    """One call: one count, and one device kernel -- the sm_90a kernel,
    no scaling or copy before or after it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    xa, xb, ils, amp = _inputs(cuda, 16384, 256, 6)
    fused_gram(xa, xb, ils, amp)  # build and load outside the profile
    torch.cuda.synchronize()
    before = gram.fused_gram.launches
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fused_gram(xa, xb, ils, amp)
        torch.cuda.synchronize()
    assert gram.fused_gram.launches == before + 1
    # The launch's profiler range may be mirrored on the device's timeline.
    kernels = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
               and not e.name.startswith(gram.PROFILE_RANGE + " ")]
    assert len(kernels) == 1 and "gram_kernel" in kernels[0], kernels


@pytest.mark.cuda
def test_fused_gram_launch_sits_in_a_range_named_with_its_dims(cuda, tmp_path):
    """Under the profiler a launch is wrapped in ``"fused_gram MxNxD"``: the
    exported trace holds one such range and one kernel for one call."""
    import json

    from torch.profiler import ProfilerActivity, profile

    xa, xb, ils, amp = _inputs(cuda, 16384, 256, 6)
    fused_gram(xa, xb, ils, amp)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fused_gram(xa, xb, ils, amp)
        torch.cuda.synchronize()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    ranges = [e["name"] for e in events if e.get("cat") == "user_annotation"
              and e.get("name", "").startswith(gram.PROFILE_RANGE + " ")]
    kernels = [e for e in events if e.get("cat") == "kernel" and "gram_kernel" in e["name"]]
    assert ranges == ["fused_gram 16384x256x6"] and len(kernels) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,d", [(16384, 256, 6), (300, 70, 6), (513, 129, 130),
                                   (8192, 512, 50)])
def test_fused_gram_scales_in_the_kernel_as_the_wrapper_did(cuda, m, n, d):
    """The kernel's scaled element is the one f32 product ``x * inv_ls``, so
    scaling inside it gives exactly what pre-scaled inputs with unit
    lengthscales give."""
    xa, xb, ils, amp = _inputs(cuda, m, n, d)
    got = fused_gram(xa, xb, ils, amp)
    pre = fused_gram(xa * ils, xb * ils, torch.ones_like(ils), amp)
    torch.cuda.synchronize()
    assert torch.equal(got, pre)


@pytest.mark.cuda
def test_fused_gram_unaligned_output_takes_scalar_stores(cuda):
    """An output 4 bytes off 16-byte alignment with n % 4 == 0 takes the
    scalar path; the kernel refuses a float4 plan for it."""
    m, n, d = 1000, 256, 6
    xa, xb, ils, amp = _inputs(cuda, m, n, d)
    out = torch.full((m * n + 1,), float("nan"), device=cuda)[1:].view(m, n)
    assert out.data_ptr() % 16 != 0
    lib = gram._lib()

    def launch(plan):
        return lib.orion_fused_gram_f32(
            xa.data_ptr(), xb.data_ptr(), ils.data_ptr(), amp.data_ptr(), out.data_ptr(),
            m, n, d, 0, *plan, torch.cuda.current_stream().cuda_stream)

    plan = gram._launch_plan(m, n, d, False)
    assert not plan.vec
    assert launch(plan._replace(vec=True)) != 0  # refused, nothing launched
    assert launch(plan) == 0
    want = fused_gram_reference(xa, xb, ils, amp)
    torch.cuda.synchronize()
    assert float((out - want).abs().max()) <= 1e-5 * 1.7


@pytest.mark.cuda
def test_fused_gram_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.rand((8, 3), device=cuda)
    with pytest.raises(TypeError):
        fused_gram(x.double(), x.double(), torch.ones(3, device=cuda).double(),
                   torch.tensor(1.0, device=cuda).double())
    with pytest.raises(ValueError, match="devices"):
        fused_gram(x, x.cpu(), torch.ones(3, device=cuda), torch.tensor(1.0, device=cuda))


@pytest.mark.cuda
def test_asha_bo_round_launches_fused_gram_on_the_chunked_path(cuda, monkeypatch):
    """One model round of ``asha_bo`` at the ``asha_bo-ackley50`` preset
    (Ackley-50D plus the fidelity column, 8192 candidates, 512 observed)
    runs its 8192 x 512 x 51 EI cross-gram in the kernel's chunked path,
    and never in the plain version."""
    import numpy as np

    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.benchmarks.functions import ackley
    from orion_tpu_torch.space.dsl import build_space

    assert not gram._launch_plan(8192, 512, 51, True).resident
    priors = {f"x{i:02d}": "uniform(0, 1)" for i in range(50)}
    priors["budget"] = "fidelity(1, 256, 4)"
    config = {"asha_bo": {"n_init": 128, "n_candidates": 8192, "fit_steps": 30,
                          "refit_steps": 10, "local_frac": 0.8, "trust_region": True,
                          "y_transform": "copula", "tr_perturb_dims": 12, "num_brackets": 3}}
    space = build_space(priors)
    algo = create_algo(space, config, seed=0, device=cuda)
    params = algo.suggest(512)  # random: fewer than n_init observed
    cube = space.params_to_cube(params)
    algo.observe(params, [{"objective": float(v)} for v in ackley(torch.from_numpy(cube))])

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(gram, "fused_gram_reference", plain)
    before = gram.fused_gram.launches
    params = algo.suggest(512)
    assert gram.fused_gram.launches > before
    assert algo._hist.fit_view()[0].shape == (512, 51)
    cube = space.params_to_cube(params)
    assert cube.shape == (512, 50) and np.isfinite(cube).all()


HUNT_ALGO = {"tpu_bo": {"n_init": 16, "n_candidates": 16384, "fit_steps": 40,
                        "local_frac": 0.3}}


@pytest.mark.cuda
def test_optimize_gp_round_at_q1024_launches_fused_gram_at_the_main_shape(cuda, monkeypatch):
    """``optimize(tpu_bo)`` at q=1024 on ``memory`` storage: round 1 is
    random, round 2 a GP round whose EI ranking runs the 16384 x 256 x 6
    cross-gram in the kernel (the trust region fits the 256 nearest of
    1024 observed), never in the plain version; ``batch_eval`` gets the
    rows as a float32 tensor on the card."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import optimize
    from orion_tpu_torch.storage.base import create_storage

    shapes, seen = [], []
    plan = gram._launch_plan

    def recording_plan(m, n, d, aligned):
        shapes.append((m, n, d))
        return plan(m, n, d, aligned)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    def batch_eval(x):
        seen.append((x.device.type, x.dtype, tuple(x.shape)))
        return hartmann6(x)

    monkeypatch.setattr(gram, "_launch_plan", recording_plan)
    monkeypatch.setattr(gram, "fused_gram_reference", plain)
    before = gram.fused_gram.launches
    stats = optimize(None, {f"x{i}": "uniform(0, 1)" for i in range(6)}, max_trials=2048,
                     batch_size=1024, algorithm=HUNT_ALGO, seed=0, batch_eval=batch_eval,
                     storage=create_storage({"type": "memory"}))
    assert stats["trials_completed"] == 2048
    assert gram.fused_gram.launches - before == len(shapes) >= 1
    assert (16384, 256, 6) in shapes
    assert seen == [("cuda", torch.float32, (1024, 6))] * 2


@pytest.mark.cuda
def test_naive_copy_generator_hand_off_on_cuda(cuda):
    """With trials in flight, the producer's naive copy observes the lies
    and suggests; the real algorithm's ``cuda`` generators take the naive
    copy's states (copies, not the objects) and its history holds no lie."""
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.storage.base import create_storage

    storage = create_storage({"type": "memory"})
    exp = build_experiment(storage, "handoff", priors={"x0": "uniform(0, 1)",
                                                       "x1": "uniform(0, 1)"},
                           algorithms={"tpu_bo": {"n_init": 4, "n_candidates": 1024,
                                                  "fit_steps": 5}})
    client = ExperimentClient(exp.instantiate(seed=0))
    first = client.suggest(8)
    client.observe_all(first[:6], [float(t.params["x0"]) for t in first[:6]])
    real = client.producer.algorithm
    assert real.model_generator.device.type == "cuda"
    before = real.model_generator.get_state().clone()
    assert len(client.suggest(4)) == 4
    naive = client.producer.naive_algorithm
    after = real.model_generator.get_state()
    assert not torch.equal(before, after)
    assert torch.equal(after, naive.model_generator.get_state())
    assert real.model_generator is not naive.model_generator
    assert torch.equal(real.generator.get_state(), naive.generator.get_state())
    assert real.generator is not naive.generator
    assert real._hist.count == 6 and naive._hist.count == 8
    assert real._hist._x.data_ptr() != naive._hist._x.data_ptr()
    assert float(real._hist.fit_view()[2].sum()) == 6.0


_CLI_BOX = """import argparse

from orion_tpu_torch.client import report_results

parser = argparse.ArgumentParser()
for i in range(6):
    parser.add_argument(f"-x{i}", type=float, required=True)
args = vars(parser.parse_args())
report_results([{"name": "objective", "type": "objective",
                 "value": sum((v - 0.3) ** 2 for v in args.values())}])
"""


def _cli_experiment_with_history(tmp_path, n_completed=256):
    """``orion-tpu-torch init-only`` of a six-dimensional experiment on
    SQLite whose ``tpu_bo`` runs the main path's config, then
    ``n_completed`` random trials completed through the library, so that
    the hunt's first round is a GP round.  Returns the storage path."""
    import numpy as np
    import yaml

    from orion_tpu_torch.cli import main
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.core.trial import Result, Trial
    from orion_tpu_torch.storage.base import create_storage

    script, conf = tmp_path / "box.py", tmp_path / "bo.yaml"
    script.write_text(_CLI_BOX)
    conf.write_text(yaml.safe_dump({"algorithms": {"tpu_bo": dict(HUNT_ALGO["tpu_bo"],
                                                                  seed=0)}}))
    db = str(tmp_path / "cli.sqlite")
    assert main(["init-only", "-n", "cli", "--storage-path", db, "-c", str(conf), str(script),
                 *[f"-x{i}~uniform(0, 1)" for i in range(6)]]) == 0
    exp = build_experiment(create_storage({"type": "sqlite", "path": db}), "cli")
    rows = np.random.default_rng(0).uniform(size=(n_completed, 6))
    exp.register_trials([Trial(params={f"/x{i}": float(r[i]) for i in range(6)})
                         for r in rows])
    trials = exp.reserve_trials(n_completed)
    exp.update_completed_trials([
        (t, [Result("objective", "objective", sum((v - 0.3) ** 2 for v in t.params.values()))])
        for t in trials])
    assert exp.storage.count_completed_trials(exp.id) == n_completed
    return db


@pytest.mark.cuda
@pytest.mark.parametrize("profile", [False, True], ids=["plain", "profile"])
def test_cli_hunt_gp_round_launches_fused_gram_at_the_main_shape(cuda, tmp_path, monkeypatch,
                                                                 profile):
    """``orion-tpu-torch hunt`` in process on SQLite, ``--device`` left at
    its ``cuda`` default, over 256 completed trials: the first round is a
    GP round of 1024 whose EI ranking runs the 16384 x 256 x 6 cross-gram
    in the kernel, never in the plain version.  With ``--profile DIR`` the
    worker's trace holds the kernel inside the ``hunt.workon`` span."""
    import json
    import os

    from orion_tpu_torch.cli import main

    db = _cli_experiment_with_history(tmp_path)
    shapes = []
    plan = gram._launch_plan

    def recording_plan(m, n, d, aligned):
        shapes.append((m, n, d))
        return plan(m, n, d, aligned)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(gram, "_launch_plan", recording_plan)
    monkeypatch.setattr(gram, "fused_gram_reference", plain)
    before = gram.fused_gram.launches
    prof = tmp_path / "prof"
    extra = ["--profile", str(prof)] if profile else []
    assert main(["hunt", "-n", "cli", "--storage-path", db, "--pool-size", "1024",
                 "--max-trials", "257", *extra]) == 0
    assert gram.fused_gram.launches - before == len(shapes) >= 1
    assert (16384, 256, 6) in shapes
    if profile:
        with open(prof / f"trace-{os.getpid()}.json") as handle:
            events = json.load(handle)["traceEvents"]
        [loop] = [e for e in events
                  if e.get("name") == "hunt.workon" and e.get("cat") == "user_annotation"]
        kernels = [e for e in events if e.get("cat") == "kernel"
                   and "gram_kernel" in e.get("name", "")]
        assert len(kernels) == len(shapes)
        assert all(loop["ts"] <= e["ts"] <= loop["ts"] + loop["dur"] for e in kernels)


@pytest.mark.cuda
def test_branched_hunt_first_round_is_a_gp_round_on_the_card(cuda, tmp_path, monkeypatch):
    """EVC on the card: ``orion-tpu-torch hunt`` resumed with ``x0``
    narrowed to [0, 0.5] branches version 2, whose producer observes the
    parent's completed trials inside the new prior through the EVC tree;
    so its first round is a GP round that runs the 16384 x 256 x 6
    cross-gram in the kernel, and every row lies in the narrowed prior."""
    from orion_tpu_torch.cli import main
    from orion_tpu_torch.storage.base import create_storage

    db = _cli_experiment_with_history(tmp_path, n_completed=640)
    shapes = []
    plan = gram._launch_plan

    def recording_plan(m, n, d, aligned):
        shapes.append((m, n, d))
        return plan(m, n, d, aligned)

    def plain(*args, **kwargs):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(gram, "_launch_plan", recording_plan)
    monkeypatch.setattr(gram, "fused_gram_reference", plain)
    before = gram.fused_gram.launches
    priors = [f"-x{i}~uniform(0, {0.5 if i == 0 else 1})" for i in range(6)]
    assert main(["hunt", "-n", "cli", "--storage-path", db, "--pool-size", "1024",
                 "--max-trials", "4", str(tmp_path / "box.py"), *priors]) == 0
    assert gram.fused_gram.launches - before == len(shapes) >= 1
    assert (16384, 256, 6) in shapes
    storage = create_storage({"type": "sqlite", "path": db})
    exps = {e["version"]: e for e in storage.fetch_experiments({"name": "cli"})}
    assert exps[2]["refers"]["parent_id"] == exps[1]["_id"]
    trials = storage.fetch_trials(uid=exps[2]["_id"])
    assert len(trials) == 1024 and all(t.params["/x0"] <= 0.5 for t in trials)
    assert sum(t.status == "completed" for t in trials) == 4


@pytest.fixture
def telemetry_off_after():
    """The port's registry and flight recorder, reset and off after the
    test (process-wide globals)."""
    from orion_tpu_torch.health import FLIGHT
    from orion_tpu_torch.telemetry import TELEMETRY

    yield TELEMETRY, FLIGHT
    for owner in (TELEMETRY, FLIGHT):
        owner.disable()
    TELEMETRY.reset()
    FLIGHT.clear()


@pytest.mark.cuda
@pytest.mark.parametrize("first", ["off", "on"])
def test_main_path_rows_equal_with_telemetry_on_and_off(cuda, telemetry_off_after, first):
    """The main path's round (130 observed, q=1024, 16384 candidates): a
    third copy captures the round's signature first (its warm-up round is
    eager); then two copies of one algorithm, one suggesting with telemetry
    off, the other with it on, in either order, replay it and give equal
    rows (exact, and equal to the eager round's), and the on round books
    one ``suggest_step.dispatch`` span of ``{"q": 1024, "n": 256}`` with a
    ``fused_gram`` launch."""
    import copy

    import numpy as np

    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.space.dsl import build_space

    telemetry, flight = telemetry_off_after
    space = build_space({f"x{i}": "uniform(0, 1)" for i in range(6)})
    algo = create_algo(space, {"tpu_bo": {"n_init": 16, "n_candidates": 16384,
                                          "fit_steps": 40, "local_frac": 0.3}},
                       seed=3, device=cuda)
    x = np.random.default_rng(3).uniform(size=(130, 6)).astype(np.float32)
    y = hartmann6(torch.from_numpy(x)).numpy()
    algo.observe([{f"x{i}": float(r[i]) for i in range(6)} for r in x],
                 [{"objective": float(v)} for v in y])
    twin = copy.deepcopy(algo)
    rows = {"eager": copy.deepcopy(algo).suggest_batch(1024).cube}
    for mode in ((first, "on" if first == "off" else "off")):
        target = algo if mode == "off" else twin
        for owner in (telemetry, flight):
            owner.enabled = mode == "on"
        before = gram.fused_gram.launches
        rows[mode] = target.suggest_batch(1024).cube
        torch.cuda.synchronize()
        assert gram.fused_gram.launches == before + 1
        telemetry.disable()
        flight.disable()
    assert np.array_equal(rows["off"], rows["on"])
    assert np.array_equal(rows["off"], rows["eager"])
    spans = telemetry.drain_spans()
    assert [(s["name"], s["args"]) for s in spans] == [
        ("suggest_step.dispatch", {"q": 1024, "n": 256})]


def _cuda_apps():
    """The pids ``nvidia-smi`` lists as holding a CUDA context (from the
    host's pid namespace: in a container they need not match ours)."""
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return sorted(int(line) for line in out.split() if line.strip().isdigit())


def _nvidia_files(pid):
    """The ``/dev/nvidia*`` files process ``pid`` holds open or mapped: CUDA
    opens them when a process first calls into it (importing torch maps
    ``libcuda`` but opens none)."""
    import os

    found = set()
    for fd in os.listdir(f"/proc/{pid}/fd"):
        try:
            target = os.readlink(f"/proc/{pid}/fd/{fd}")
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            found.add(target)
    with open(f"/proc/{pid}/maps") as handle:
        found.update(line.split()[-1] for line in handle if "/dev/nvidia" in line)
    return sorted(found)


@pytest.mark.cuda
def test_db_serve_process_never_initializes_cuda(cuda, tmp_path):
    """``orion-tpu-torch db serve`` is a host process: after it served
    writes, reads and a batch it holds no ``/dev/nvidia*`` file (this
    process, which holds a context, does), and ``nvidia-smi`` lists no more
    compute apps than before it started."""
    import os
    import signal
    import subprocess
    import sys

    from orion_tpu_torch.storage.base import create_storage

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.zeros(1, device=cuda)
    torch.cuda.synchronize()
    assert _nvidia_files(os.getpid())
    apps_before = _cuda_apps()
    proc = subprocess.Popen(
        [sys.executable, "-m", "orion_tpu_torch.cli", "db", "serve", "--host", "127.0.0.1",
         "--port", "0", "--no-auth", "--persist", str(tmp_path / "net.sqlite")],
        env=dict(os.environ, PYTHONPATH=root, PYTHONUNBUFFERED="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "listening on" in line, line
        address = line.split("listening on ")[1].split(" ")[0]
        storage = create_storage({"type": "network", "address": address})
        storage.db.write("trials", [{"_id": f"t{i}", "experiment": "e"} for i in range(8)])
        storage.db.apply_batch([("count", ["trials", {}], {})])
        assert storage.db.count("trials") == 8
        assert _nvidia_files(proc.pid) == []
        apps = _cuda_apps()
        assert proc.pid not in apps and len(apps) == len(apps_before)
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=30) == 0


@pytest.mark.cuda
def test_network_store_gp_round_launches_fused_gram_at_the_main_shape(cuda, monkeypatch):
    """``optimize(tpu_bo)`` at q=1024 over a ``network`` store (a server in
    this process): the GP round's EI ranking launches the kernel once, at
    16384 x 256 x 6, and each round's lies and completions ride the wire."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import optimize
    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.storage.netdb import DBServer

    shapes = []
    plan = gram._launch_plan

    def recording_plan(m, n, d, aligned):
        shapes.append((m, n, d))
        return plan(m, n, d, aligned)

    monkeypatch.setattr(gram, "_launch_plan", recording_plan)
    server = DBServer(port=0, secret="s")
    host, port = server.serve_background()
    try:
        storage = create_storage({"type": "network", "host": host, "port": port,
                                  "secret": "s"})
        before = gram.fused_gram.launches
        stats = optimize(None, {f"x{i}": "uniform(0, 1)" for i in range(6)},
                         max_trials=2048, batch_size=1024, algorithm=HUNT_ALGO, seed=0,
                         batch_eval=hartmann6, storage=storage)
        assert stats["trials_completed"] == 2048
        assert gram.fused_gram.launches - before == 1 and shapes == [(16384, 256, 6)]
        assert storage.db.wire_requests > 0
        assert server.db.count("trials", {"status": "completed"}) == 2048
    finally:
        server.shutdown()
        server.server_close()


@pytest.mark.cuda
def test_rebalanced_experiment_resumes_tpu_bo_with_a_gp_round(cuda, monkeypatch):
    """A q=1024 ``optimize(tpu_bo)`` experiment on a three-shard plane of
    servers in this process moves to a fourth shard (``Rebalancer``): its
    documents byte-identical on the destination, the source copy and the
    placement override gone, the destination's audit clean.  Resumed
    through a fresh four-shard router, its next round is a GP round that
    launches the kernel at 16384 x 256 x 6."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import optimize
    from orion_tpu_torch.storage.audit import audit_storage
    from orion_tpu_torch.storage.base import DocumentStorage, create_storage
    from orion_tpu_torch.storage.documents import dumps_canonical
    from orion_tpu_torch.storage.netdb import DBServer
    from orion_tpu_torch.storage.rebalance import Rebalancer
    from orion_tpu_torch.storage.shard import PLACEMENT_COLLECTION, HashRing

    shapes = []
    plan = gram._launch_plan

    def recording_plan(m, n, d, aligned):
        shapes.append((m, n, d))
        return plan(m, n, d, aligned)

    monkeypatch.setattr(gram, "_launch_plan", recording_plan)
    started = []

    def serve():
        server = DBServer(port=0)
        server.serve_background()
        started.append(server)
        return "%s:%s" % server.address

    def stanza(addresses):
        return {"type": "network", "shards": [{"address": a} for a in addresses]}

    priors = {f"x{i}": "uniform(0, 1)" for i in range(6)}
    try:
        three = [serve() for _ in range(3)]
        storage = create_storage(stanza(three))
        stats = optimize(None, priors, max_trials=1024, batch_size=1024, algorithm=HUNT_ALGO,
                         seed=0, batch_eval=hartmann6, storage=storage, name="day2")
        assert stats["trials_completed"] == 1024
        [exp] = storage.fetch_experiments({"name": "day2"})
        src = HashRing(three).lookup(exp["_id"])
        tried = []
        for _ in range(40):  # each new address re-rolls the four-shard ring
            four = three + [serve()]
            tried.append(four[-1])
            if HashRing(four).lookup(exp["_id"]) != src:
                break
        dst = HashRing(four).lookup(exp["_id"])
        assert dst != src, (exp["_id"], three, tried)
        before = sorted(dumps_canonical(d) for d in storage.db.read(
            "trials", {"experiment": exp["_id"]}))
        storage = create_storage(stanza(four))
        router = storage.db
        rebalancer = Rebalancer(router, fence_grace=0)
        moves = rebalancer.run().moves
        assert [(m.exp_id, m.src_index, m.dst_index) for m in moves] == [(exp["_id"], src, dst)]
        conns = dict(router.shard_connections())
        assert sorted(dumps_canonical(d) for d in conns[dst].read(
            "trials", {"experiment": exp["_id"]})) == before
        assert conns[src].read("trials", {"experiment": exp["_id"]}) == []
        assert all(c.read(PLACEMENT_COLLECTION, {}) == [] for c in conns.values())
        assert all(r.ok for r in audit_storage(DocumentStorage(conns[dst]), lost_timeout=3600.0))
        launches = gram.fused_gram.launches
        shapes.clear()
        storage = create_storage(stanza(four))  # a router with no placement cached
        stats = optimize(None, priors, max_trials=2048, batch_size=1024, algorithm=HUNT_ALGO,
                         seed=0, batch_eval=hartmann6, storage=storage, name="day2")
        assert stats["trials_completed"] == 2048
        assert gram.fused_gram.launches - launches == len(shapes) >= 1, shapes
        assert set(shapes) == {(16384, 256, 6)}, shapes
        assert conns[dst].count("trials", {"experiment": exp["_id"], "status": "completed"}) \
            == 2048
    finally:
        for server in started:
            server.shutdown()
            server.server_close()


# --- the captured round (orion_tpu_torch/algo/step_graphs.py) -------------------

MAIN_ALGO = {"tpu_bo": {"n_init": 16, "n_candidates": 16384, "fit_steps": 40,
                        "local_frac": 0.3, "prewarm": False}}
ASHA_BO_ALGO = {"asha_bo": {"n_init": 128, "n_candidates": 8192, "fit_steps": 30,
                            "refit_steps": 10, "local_frac": 0.8, "trust_region": True,
                            "y_transform": "copula", "tr_perturb_dims": 12,
                            "num_brackets": 3}}


def _main_path_algo(device, seed=3, config=MAIN_ALGO, n_obs=130, width=6):
    """``tpu_bo`` at the main path's configuration with ``n_obs`` observed
    Hartmann6 points (130: a 256-row fit buffer)."""
    import numpy as np

    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.space.dsl import build_space

    space = build_space({f"x{i}": "uniform(0, 1)" for i in range(width)})
    algo = create_algo(space, config, seed=seed, device=device)
    x = np.random.default_rng(seed).uniform(size=(n_obs, width)).astype(np.float32)
    y = hartmann6(torch.from_numpy(x[:, :6])).numpy()
    algo.observe_arrays(x, y)
    return algo


def _asha_bo_algo(device):
    """``asha_bo`` at the ``asha_bo-ackley50`` preset after its random round
    of 512 (a 512-row fit buffer of 51 columns)."""
    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.benchmarks.functions import ackley
    from orion_tpu_torch.space.dsl import build_space

    priors = {f"x{i:02d}": "uniform(0, 1)" for i in range(50)}
    priors["budget"] = "fidelity(1, 256, 4)"
    space = build_space(priors)
    algo = create_algo(space, ASHA_BO_ALGO, seed=0, device=device)
    params = algo.suggest(512)
    cube = space.params_to_cube(params)
    algo.observe(params, [{"objective": float(v)} for v in ackley(torch.from_numpy(cube))])
    return algo


def _ms(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tpu_bo", "asha_bo"])
def test_replayed_round_is_bitwise_the_eager_round(cuda, path):
    """The main path's round at q=1024 and ``asha_bo``'s at the preset:
    rows, health and GP state of a replay equal (bitwise) those of
    ``_suggest_step`` run eagerly on the same plan, and so do the miss's
    (the warm-up round's).  Prints the eager and the replayed round's
    ms."""
    from orion_tpu_torch.algo import tpu_bo as tbo
    from orion_tpu_torch.algo.step_graphs import StepGraphs

    if path == "tpu_bo":
        plan = _main_path_algo(cuda).fused_step_plan(1024)
    else:
        plan = _asha_bo_algo(cuda)._gp_plan(512)
    graphs = StepGraphs()

    def through_graphs():
        return graphs.run(tbo._suggest_step, plan.signature, plan.arrays, plan.statics)

    (eager_rows, eager_state), eager_ms = _ms(lambda: tbo._suggest_step(*plan.arrays,
                                                                         **plan.statics))
    ((rows, state), entry, missed), miss_ms = _ms(through_graphs)
    assert missed and entry.graph is not None
    results = [(rows, state)]
    replay_ms = []
    for _ in range(3):
        ((rows, state), _entry, missed), ms = _ms(through_graphs)
        assert not missed
        results.append((rows, state))
        replay_ms.append(ms)
    for rows, state in results:
        assert torch.equal(rows, eager_rows)
        assert torch.equal(state.health, eager_state.health)
        for got, want in zip(state.hypers, eager_state.hypers):
            assert torch.equal(got, want)
        assert torch.equal(state.chol, eager_state.chol)
        assert torch.equal(state.alpha, eager_state.alpha)
    print(json.dumps({"path": path, "eager_ms": eager_ms, "miss_ms": miss_ms,
                      "capture_ms": entry.capture_ms, "instantiate_ms": entry.instantiate_ms,
                      "graph_nodes": entry.graph_nodes, "replay_ms": replay_ms,
                      "pool_bytes": entry.pool_bytes}))


def _signature_plans(device):
    """One plan per signature that ``chip_smoke.py`` reaches: the main
    path (q=1024, cold and warm), the regret scenario's fit buckets at
    q=16, ``asha_bo``'s fit buckets at the preset, and the q buckets 8 to
    1024 at the main path's 256-row buffer."""
    from orion_tpu_torch.algo.gp.gp import init_hypers
    from orion_tpu_torch.algo.tpu_bo import make_fused_plan

    gen = torch.Generator(device=device).manual_seed(0)

    def plan(m, width, num, warm, **kw):
        x = torch.rand((m, width), generator=gen, device=device)
        y = torch.rand((m,), generator=gen, device=device)
        mask = (torch.arange(m, device=device) < (m * 3) // 4).to(torch.float32)
        best_x = x[0, :width - kw.get("fixed_tail_cols", 0)].clone()
        state = None
        if warm:
            class Warm:
                hypers = init_hypers(width, device=device)
            state = Warm()
        return make_fused_plan(gen, x, y, mask, best_x, state, num, tr_length=0.8, **kw)

    main = dict(n_candidates=16384, kernel="matern52", acq="thompson", fit_steps=40,
                local_frac=0.3, local_sigma=0.1, beta=2.0, trust_region=True,
                y_transform="copula")
    asha = dict(n_candidates=8192, kernel="matern52", acq="thompson", fit_steps=30,
                refit_steps=10, local_frac=0.8, local_sigma=0.125, beta=2.0,
                trust_region=True, tr_perturb_dims=12, y_transform="copula",
                fixed_tail_cols=1)
    plans = [plan(256, 6, 1024, False, **main), plan(256, 6, 1024, True, **main)]
    plans += [plan(m, 6, 16, m > 64, **main) for m in (64, 128, 256)]
    plans += [plan(m, 51, 512, m > 128, **asha) for m in (128, 256, 512)]
    plans += [plan(256, 6, q, True, **main) for q in (8, 16, 32, 64, 128, 256, 512)]
    unique = {}
    for p in plans:
        unique.setdefault(p.signature, p)
    return list(unique.values())


@pytest.mark.cuda
def test_shared_pool_holds_at_most_one_and_a_half_of_the_largest_signature(cuda):
    """Every signature ``chip_smoke.py`` reaches, captured into ONE pool,
    holds at most 1.5x the largest signature's pool measured alone (each
    in a fresh pool).  Prints both numbers."""
    import gc

    from orion_tpu_torch.algo import tpu_bo as tbo
    from orion_tpu_torch.algo.step_graphs import POOL_BOUND, StepGraphs

    plans = _signature_plans(cuda)
    alone = {}
    for plan in plans:
        graphs = StepGraphs()
        graphs.run(tbo._suggest_step, plan.signature, plan.arrays, plan.statics)
        alone[plan.signature] = graphs.pool_bytes()
        del graphs
        gc.collect()
        torch.cuda.empty_cache()
    shared = StepGraphs()
    for plan in plans:
        shared.run(tbo._suggest_step, plan.signature, plan.arrays, plan.statics)
    for plan in plans:  # replays in another order than the captures
        shared.run(tbo._suggest_step, plan.signature, plan.arrays, plan.statics)
    largest = max(alone.values())
    print(json.dumps({"signatures": len(plans), "shared_pool_bytes": shared.pool_bytes(),
                      "largest_alone_bytes": largest,
                      "alone_bytes": sorted(alone.values())}))
    assert shared.captured_count() == len(plans)
    assert shared.pool_bytes() <= POOL_BOUND * largest


def _capture_line(graphs, plan):
    """Capture ``plan`` into ``graphs``: its line (no entry outlives it)."""
    from orion_tpu_torch.algo import tpu_bo as tbo

    t0 = time.perf_counter()
    _, entry, missed = graphs.run(tbo._suggest_step, plan.signature, plan.arrays, plan.statics)
    assert missed
    return {"q": plan.statics["q"], "ms": (time.perf_counter() - t0) * 1e3,
            "pool_bytes": entry.pool_bytes, "grew_bytes": entry.grew_bytes,
            "alone_bytes": entry.alone_bytes, "cache_pool_bytes": graphs.pool_bytes(),
            "fresh_pools": graphs.fresh_pools, "alone_captures": graphs.alone_captures,
            "stranded_bytes": graphs.stranded_bytes}


def _ascending_q_captures(graphs, plans):
    """Capture ``plans`` in order into ``graphs``: one line a capture."""
    return [_capture_line(graphs, plan) for plan in plans]


@pytest.mark.cuda
def test_ascending_q_captures_start_a_fresh_pool_and_stay_under_the_bound(cuda, monkeypatch):
    """The q buckets 8 ... 1024 at the main path's 256-row buffer, captured
    smallest first (``chip_smoke.py``'s ``diagnosis`` (b) order): with the
    fresh-pool rule off, the shared pool passes 1.5x the q=1024 signature's
    pool alone (each q doubling made a segment the next cannot reuse); with
    it on, the cache's pools and every graph pool of the process stay
    under, a given-up pool is handed back to the device, and the entries
    left replay bitwise as their eager rounds.  Prints each capture's ms,
    pool bytes, growth and footprint measured alone."""
    import gc

    from orion_tpu_torch.algo import step_graphs
    from orion_tpu_torch.algo import tpu_bo as tbo
    from orion_tpu_torch.algo.step_graphs import POOL_BOUND, StepGraphs, graph_pool_bytes

    plans = sorted((p for p in _signature_plans(cuda)
                    if p.signature[0][0] == 256 and p.signature[0][1] == 6),
                   key=lambda p: p.statics["q"])
    plans = list({p.statics["q"]: p for p in plans}.values())
    assert [p.statics["q"] for p in plans] == [8, 16, 32, 64, 128, 256, 512, 1024]

    def fresh(run):
        graphs = StepGraphs()
        out = run(graphs)
        pool = graphs.pool_bytes()
        return graphs, out, pool

    def release(graphs):
        graphs.reset()
        gc.collect()
        torch.cuda.empty_cache()

    gc.collect()
    torch.cuda.empty_cache()
    before = graph_pool_bytes()  # earlier tests' live graphs
    graphs, _, alone = fresh(lambda g: _ascending_q_captures(g, plans[-1:]))
    release(graphs)
    with monkeypatch.context() as patch:
        patch.setattr(step_graphs, "POOL_BOUND", float("inf"))
        graphs, without_rule, pool_without = fresh(lambda g: _ascending_q_captures(g, plans))
    release(graphs)
    graphs, with_rule, pool_with = fresh(lambda g: _ascending_q_captures(g, plans))
    gc.collect()
    torch.cuda.empty_cache()  # the dead graphs' pools: only live ones stay
    process = graph_pool_bytes() - before
    print(json.dumps({"largest_alone_bytes": alone, "without_rule": without_rule,
                      "pool_without_rule": pool_without, "with_rule": with_rule,
                      "pool_with_rule": pool_with, "process_graph_pool_bytes": process,
                      "ratio_without": pool_without / alone, "ratio_with": pool_with / alone,
                      "process_ratio": process / alone}))
    assert pool_without > POOL_BOUND * alone
    assert max(pool_with, process) <= POOL_BOUND * alone and graphs.fresh_pools >= 1
    assert all(line["stranded_bytes"] == 0 for line in with_rule) and process == pool_with
    assert 1024 in [entry.statics["q"] for _dev, _sig, entry in graphs.entries()]
    last = plans[-1]
    (rows, state), _entry, missed = graphs.run(tbo._suggest_step, last.signature, last.arrays,
                                               last.statics)
    eager_rows, eager_state = tbo._suggest_step(*last.arrays, **last.statics)
    assert not missed and torch.equal(rows, eager_rows)
    assert torch.equal(state.alpha.view(torch.int32), eager_state.alpha.view(torch.int32))
    release(graphs)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["host read", "python number"])
def test_planted_capture_case_and_its_twin_behave_as_lint_predicts(cuda, case):
    """One planted case of ``tests/fixtures/torch_lint/capture_cases.py``
    and its safe twin: the lint flags the case and not the twin; on the
    card the case fails to capture (JIT001) or replays a stale value
    (JIT003), and the twin captures and replays equal to its eager run."""
    import importlib.util
    import inspect
    import os

    from orion_tpu_torch.analysis import run_lint

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures", "torch_lint",
                        "capture_cases.py")
    spec = importlib.util.spec_from_file_location("capture_cases", path)
    cases = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cases)
    rule, _name, flagged_site, flagged_body, safe_site, safe_body = next(
        c for c in cases.CASES if c[1] == case)
    diagnostics = run_lint([path], select=["JIT"])

    def linted(*fns):
        spans = []
        for fn in fns:
            lines, first = inspect.getsourcelines(fn)
            spans.append(range(first, first + len(lines)))
        return any(d.rule_id == rule and any(d.line in span for span in spans)
                   for d in diagnostics)

    captured, fresh = cases.card_verdict(flagged_site, flagged_body, cuda)
    safe_captured, safe_fresh = cases.card_verdict(safe_site, safe_body, cuda)
    print(json.dumps({"rule": rule, "case": case, "flagged": [captured, fresh],
                      "safe": [safe_captured, safe_fresh]}))
    assert linted(flagged_site, flagged_body) and not linted(safe_site, safe_body)
    assert not (captured and fresh)
    assert captured == (rule == "JIT003")
    assert safe_captured and safe_fresh


@pytest.mark.cuda
def test_replayed_rounds_count_one_fused_gram_launch_each(cuda, monkeypatch, tmp_path):
    """Rounds of one algorithm at the main path: each counts one
    ``fused_gram`` launch at 16384 x 256 x 6 in ``fused_gram.launches`` and
    in the launch-plan hook, the first (warm-up and capture) and the
    replays alike; under ``torch.profiler`` the replayed rounds' kernels
    carry the kernel's name and each sits in its ``fused_gram MxNxD``
    range."""
    from torch.profiler import ProfilerActivity, profile

    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS

    shapes = []
    plan = gram._launch_plan

    def recording_plan(m, n, d, aligned):
        shapes.append((m, n, d))
        return plan(m, n, d, aligned)

    monkeypatch.setattr(gram, "_launch_plan", recording_plan)
    algo = _main_path_algo(cuda, seed=4)
    rounds = 4
    before = gram.fused_gram.launches
    for _ in range(rounds):
        algo.suggest_batch(1024)
    torch.cuda.synchronize()
    assert gram.fused_gram.launches - before == len(shapes) == rounds
    assert set(shapes) == {(16384, 256, 6)}
    signature = algo.fused_step_plan(1024).signature
    assert STEP_GRAPHS.has(cuda, signature)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(rounds):
            algo.suggest_batch(1024)
        torch.cuda.synchronize()
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as handle:
        events = json.load(handle)["traceEvents"]
    kernels = [e for e in events if e.get("cat") == "kernel"
               and "gram_kernel" in e.get("name", "")]
    ranges = [e for e in events if e.get("cat") == "user_annotation"
              and e.get("name") == f"{gram.PROFILE_RANGE} 16384x256x6"]
    assert len(kernels) == len(ranges) == rounds
    assert gram.fused_gram.launches - before == 2 * rounds


@pytest.mark.cuda
def test_failed_capture_raises_out_of_suggest(cuda, monkeypatch):
    """A capture that fails (here: a device synchronization inside the
    captured round) raises out of ``suggest``, with no eager result, and
    leaves no entry behind."""
    from orion_tpu_torch.algo import tpu_bo as tbo
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS

    ei = tbo.expected_improvement

    def syncing(*args, **kwargs):
        if torch.cuda.is_current_stream_capturing():
            torch.cuda.synchronize()
        return ei(*args, **kwargs)

    monkeypatch.setattr(tbo, "expected_improvement", syncing)
    config = {"tpu_bo": {"n_init": 16, "n_candidates": 1024, "fit_steps": 3,
                         "local_frac": 0.25, "prewarm": False}}
    algo = _main_path_algo(cuda, seed=5, config=config, n_obs=40)
    signature = algo.fused_step_plan(32).signature
    with pytest.raises(Exception):
        algo.suggest_batch(32)
    assert not STEP_GRAPHS.has(cuda, signature)
    monkeypatch.setattr(tbo, "expected_improvement", ei)
    assert algo.suggest_batch(32).cube.shape == (32, 6)
    assert STEP_GRAPHS.has(cuda, signature)


@pytest.mark.cuda
@pytest.mark.parametrize("fail", [False, True], ids=["prewarmed", "failed-prewarm"])
def test_bucket_crossing_after_a_prewarm(cuda, monkeypatch, telemetry_off_after, fail):
    """A history crossing 64 -> 128 with ``prewarm=True``: a prewarm that
    succeeded leaves the crossing round no synchronous recapture; one that
    failed is counted as finished and failed, and the crossing round then
    captures synchronously, attributed ``fit_bucket 64→128``."""
    from orion_tpu_torch.algo import tpu_bo as tbo
    from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY

    telemetry, _flight = telemetry_off_after
    telemetry.enabled = True
    COMPILE_REGISTRY.reset()
    if fail:
        def broken(*args, **kwargs):
            raise RuntimeError("prewarm capture made to fail")

        monkeypatch.setattr(tbo, "prewarm_suggest_step", broken)
    # A candidate count of each case's own: the step graphs are process-wide,
    # so the other case must not have captured this one's signatures.
    config = {"tpu_bo": {"n_init": 16, "n_candidates": 2048 + 8 * int(fail), "fit_steps": 4,
                         "local_frac": 0.25, "prewarm": True}}
    algo = _main_path_algo(cuda, seed=6, config=config, n_obs=40, width=6)
    for _ in range(2):  # 40 -> 56 (the prewarm starts at 48 of 64) -> 72
        rows = algo.suggest_batch(16).cube
        algo.observe_arrays(rows, rows.sum(axis=1))
        algo._prewarmer.wait()
    assert algo._hist.fit_view()[0].shape[0] == 128
    assert algo._prewarmer.completed_count() == 1
    assert algo._prewarmer.failed_count() == int(fail)
    before = [e for e in COMPILE_REGISTRY.entries() if e.kind == "recapture"]
    assert algo.suggest_batch(16).cube.shape == (16, 6)
    after = [e for e in COMPILE_REGISTRY.entries() if e.kind == "recapture"]
    new = after[len(before):]
    if fail:
        assert [e.fields["fit_bucket"] for e in new] == [128]
    else:
        assert new == []
        assert [e.kind for e in COMPILE_REGISTRY.entries()].count("prewarm") == 1


@pytest.mark.cuda
def test_tsan_round_with_the_prewarmer_racing_on_the_card(cuda, telemetry_off_after):
    """Under the port's runtime sanitizer, ``tpu_bo`` on the card crosses
    64 -> 128 with ``prewarm=True`` and nobody waiting for the prewarm: the
    prewarmer's capture thread and the rounds contend for the step-graph
    lock, and both touch the annotated cache, pool, compiler plane and
    registry.  No race, no lock-order cycle, no observed lock edge the
    static lock graph of ``orion_tpu_torch/`` lacks (the kernel library is
    loaded before the step-graph lock is taken); every round, and every
    prewarm's warm-up round, launches ``fused_gram``."""
    import os

    from orion_tpu_torch.analysis.sanitizer import TSAN, cross_check_static

    telemetry, _flight = telemetry_off_after
    telemetry.enabled = True
    # A candidate count of its own: no other test captured these signatures.
    # 32768 candidates reach fused_gram's route at a 64-row fit buffer.
    config = {"tpu_bo": {"n_init": 16, "n_candidates": 32768 + 24, "fit_steps": 4,
                         "local_frac": 0.25, "prewarm": True}}
    TSAN.enable(seed=0)
    try:
        algo = _main_path_algo(cuda, seed=7, config=config, n_obs=40, width=6)
        before = gram.fused_gram.launches
        for _ in range(4):  # 40 -> 56 (the prewarm starts at 48 of 64) -> ... -> 104
            rows = algo.suggest_batch(16).cube
            algo.observe_arrays(rows, rows.sum(axis=1))
        algo._prewarmer.wait()
        launches = gram.fused_gram.launches - before
    finally:
        report = TSAN.disable()
    assert report.violation_count() == 0, report.format_human()
    package = os.path.dirname(os.path.dirname(os.path.abspath(gram.__file__)))
    assert cross_check_static(report.edges, [package]) == {
        "unmodeled_edges": [], "confirmed_static_cycles": []}
    prewarms = algo._prewarmer.completed_count()
    assert prewarms >= 1 and algo._prewarmer.failed_count() == 0
    assert launches == 4 + prewarms
    cells = {c.split("#")[0] for c in report.cells}
    assert {"StepGraphs._entries", "StepGraphs._pool", "BucketPrewarmer._threads",
            "CompileRegistry._entries", "Telemetry._metrics"} <= cells
    assert report.locks["StepGraphs.lock"] >= 1


@pytest.mark.cuda
def test_width_3_coalesced_round_is_three_standalone_rounds(cuda, monkeypatch):
    """Three tenants at the main path's configuration (q=1024, 130
    observed): one coalesced dispatch (``orion_tpu_torch.serve``) gives
    each tenant the rows and GPState leaves bit for bit equal to its round
    run alone, and launches ``fused_gram`` three times (a tenant each),
    every one at 16384 x 256 x 6.  The cache starts empty, so the first
    tenant's round captures the signature and the launch plan is read."""
    import copy

    from torch.utils import _pytree as pytree

    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
    from orion_tpu_torch.algo.tpu_bo import run_fused_plan
    from orion_tpu_torch.serve.coalesce import run_coalesced_plans

    shapes = []
    plan = gram._launch_plan

    def recording_plan(m, n, d, aligned):
        shapes.append((m, n, d))
        return plan(m, n, d, aligned)

    monkeypatch.setattr(gram, "_launch_plan", recording_plan)
    alone = [_main_path_algo(cuda, seed=seed) for seed in (20, 21, 22)]
    twins = [copy.deepcopy(algo) for algo in alone]
    STEP_GRAPHS.reset()
    before = gram.fused_gram.launches
    coalesced = run_coalesced_plans([algo.fused_step_plan(1024) for algo in twins])
    torch.cuda.synchronize()
    assert gram.fused_gram.launches - before == 3
    assert set(shapes) == {(16384, 256, 6)}
    assert len(STEP_GRAPHS.entries()) == 1
    for algo, (rows, state) in zip(alone, coalesced):
        want_rows, want_state = run_fused_plan(algo.fused_step_plan(1024))
        assert torch.equal(rows, want_rows)
        for got, want in zip(pytree.tree_leaves(state), pytree.tree_leaves(want_state)):
            if torch.is_tensor(got):  # bit for bit: a NaN equals the same NaN
                assert torch.equal(got.view(torch.int32), want.view(torch.int32))
            else:
                assert got == want


@pytest.mark.cuda
def test_serve_hunt_worker_never_initializes_cuda(cuda, tmp_path):
    """A ``hunt`` worker whose config has a ``serve:`` section, over a
    gateway in this process on the card: its GP rounds run on the gateway,
    and while it runs and after, the worker process holds no
    ``/dev/nvidia*`` file and ``nvidia-smi`` lists no compute app beyond
    those before it started."""
    import os
    import subprocess
    import sys

    import yaml

    from orion_tpu_torch.serve.gateway import GatewayServer

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    torch.zeros(1, device=cuda)
    torch.cuda.synchronize()
    gateway = GatewayServer(window=0.01, device=cuda)
    host, port = gateway.serve_background()
    script, conf = tmp_path / "box.py", tmp_path / "serve.yaml"
    script.write_text(_CLI_BOX)
    conf.write_text(yaml.safe_dump({
        "algorithms": {"tpu_bo": {"n_init": 8, "n_candidates": 512, "fit_steps": 4,
                                  "seed": 0}},
        "serve": {"address": f"{host}:{port}"}}))
    apps_before = _cuda_apps()
    proc = subprocess.Popen(
        [sys.executable, "-m", "orion_tpu_torch.cli", "hunt", "-n", "served", "-c", str(conf),
         "--storage-path", str(tmp_path / "db.sqlite"), "--pool-size", "8", "--max-trials",
         "32", str(script), *[f"-x{i}~uniform(0, 1)" for i in range(6)]],
        env=dict(os.environ, PYTHONPATH=root), cwd=str(tmp_path),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    seen, apps = set(), []
    try:
        while proc.poll() is None:
            try:
                seen.update(_nvidia_files(proc.pid))
            except (FileNotFoundError, ProcessLookupError):
                pass
            apps.append(len(_cuda_apps()))
            time.sleep(0.2)
        err = proc.stderr.read()
        stats = gateway.stats_snapshot()
    finally:
        if proc.poll() is None:
            proc.kill()
        gateway.shutdown()
        gateway.server_close()
    assert proc.returncode == 0, err[-3000:]
    assert seen == set()
    assert max(apps, default=0) <= len(apps_before)
    [tenant] = stats["per_tenant"].values()
    assert tenant["n_observed"] >= 24 and stats["dispatches"] >= 4


# --- the multi-device mesh --------------------------------------------------------


def _mesh_bits(state):
    from torch.utils import _pytree as pytree

    return [leaf.view(torch.int32) if leaf.dtype == torch.float32 else leaf
            for leaf in pytree.tree_leaves(state) if torch.is_tensor(leaf)]


def _same_state(got, want):
    return all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(_mesh_bits(got), _mesh_bits(want)))


def _mesh_config(n_devices):
    return {"tpu_bo": dict(MAIN_ALGO["tpu_bo"], use_mesh=True, n_devices=n_devices)}


def _needs_cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} cards")


@pytest.mark.cuda
def test_four_logical_slots_round_is_the_unsharded_round(cuda, monkeypatch):
    """The main path's round on 4 logical slots of one card (``cuda:0``)
    against no mesh: the capture round and a replay give the same rows and
    fit bitwise and the health within rtol 1e-6; the replayed sharded
    round launches ``fused_gram`` once a slot at 4096 x 256 x 6, and the
    placement is a quarter a slot."""
    card = torch.device("cuda", 0)
    shapes = []
    plan = gram._launch_plan
    monkeypatch.setattr(gram, "_launch_plan",
                        lambda m, n, d, aligned: shapes.append((m, n, d)) or plan(m, n, d, aligned))
    meshed = _main_path_algo(card, seed=5, config=_mesh_config(4))
    plain = _main_path_algo(card, seed=5)
    for replay in (False, True):
        del shapes[:]
        before = gram.fused_gram.launches
        rows = meshed.suggest_batch(1024).cube
        torch.cuda.synchronize()
        if replay:
            assert gram.fused_gram.launches - before == 4
            assert shapes == [(4096, 256, 6)] * 4
        want = plain.suggest_batch(1024).cube
        assert (rows == want).all()
        for a, b in zip([meshed._gp_state.chol, meshed._gp_state.alpha, *meshed._gp_state.hypers],
                        [plain._gp_state.chol, plain._gp_state.alpha, *plain._gp_state.hypers]):
            assert torch.equal(a, b)
        torch.testing.assert_close(meshed._gp_state.health, plain._gp_state.health,
                                   rtol=1e-6, atol=0)
        for algo in (meshed, plain):
            algo.observe_arrays(rows[:16], rows[:16, 0])
    record = meshed.health_record()
    assert (record["mesh_devices"], record["mesh_util_min_frac"],
            record["mesh_util_max_frac"]) == (4, 0.25, 0.25)


@pytest.mark.cuda
def test_tenant_parallel_lanes_on_logical_slots_are_their_rounds_alone(cuda):
    """Four sharded tenants coalesced over 4 logical slots (tenant-parallel:
    each lane unsharded on its slot) against each tenant's sharded round
    alone: rows and GPState bitwise, one launch a lane."""
    import copy

    from orion_tpu_torch.algo.tpu_bo import run_fused_plan
    from orion_tpu_torch.serve.coalesce import LAST_STACK_PLACEMENT, run_coalesced_plans

    card = torch.device("cuda", 0)
    tenants = [_main_path_algo(card, seed=30 + i, config=_mesh_config(4)) for i in range(4)]
    twins = [copy.deepcopy(t) for t in tenants]
    alone = [run_fused_plan(t.fused_step_plan(1024)) for t in twins]
    before = gram.fused_gram.launches
    coalesced = run_coalesced_plans([t.fused_step_plan(1024) for t in tenants])
    torch.cuda.synchronize()
    assert gram.fused_gram.launches - before == 4
    assert LAST_STACK_PLACEMENT["tenant_parallel"] is True
    for (rows, state), (want_rows, want_state) in zip(coalesced, alone):
        assert torch.equal(rows, want_rows) and _same_state(state, want_state)


@pytest.mark.cuda
def test_mesh_over_distinct_cards_is_the_unsharded_round(cuda):
    """``device="cuda"`` with ``n_devices=2``: the pool's chunks on two
    cards, scored there against copies of the state, the reductions back
    on ``cuda:0``; the round runs eagerly (no graph) and equals the
    unsharded round's rows and fit."""
    _needs_cards(2)
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS

    meshed = _main_path_algo(cuda, seed=6, config=_mesh_config(2))
    plain = _main_path_algo(cuda, seed=6)
    assert meshed._mesh.slots == (torch.device("cuda", 0), torch.device("cuda", 1))
    assert not meshed._mesh.one_device
    for _ in range(2):
        rows = meshed.suggest_batch(1024).cube
        assert (rows == plain.suggest_batch(1024).cube).all()
        for a, b in zip(meshed._gp_state.hypers, plain._gp_state.hypers):
            assert torch.equal(a, b)
        for algo in (meshed, plain):
            algo.observe_arrays(rows[:16], rows[:16, 0])
    entries = [e for _dev, sig, e in STEP_GRAPHS.entries() if "mesh" in dict(sig[1])
               and "cuda:0,cuda:1" in dict(sig[1])["mesh"]]
    assert entries and all(e.graph is None for e in entries)
    assert meshed.health_record()["mesh_util_max_frac"] == 0.5


@pytest.mark.cuda
def test_tenant_parallel_lanes_over_distinct_cards(cuda):
    """Four tenants sharded over two cards, coalesced: lanes 1 and 3 run on
    ``cuda:1`` in that card's own graph pool, and every tenant gets its
    round alone back on ``cuda:0``, bitwise."""
    _needs_cards(2)
    import copy

    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
    from orion_tpu_torch.algo.tpu_bo import run_fused_plan
    from orion_tpu_torch.serve.coalesce import run_coalesced_plans

    tenants = [_main_path_algo(cuda, seed=40 + i, config=_mesh_config(2)) for i in range(4)]
    twins = [copy.deepcopy(t) for t in tenants]
    alone = [run_fused_plan(t.fused_step_plan(1024)) for t in twins]
    coalesced = run_coalesced_plans([t.fused_step_plan(1024) for t in tenants])
    for (rows, state), (want_rows, want_state) in zip(coalesced, alone):
        assert rows.device == torch.device("cuda", 0)
        assert torch.equal(rows, want_rows) and _same_state(state, want_state)
    assert STEP_GRAPHS.pool_bytes("cuda:1") > 0
    assert STEP_GRAPHS.pool_bytes() == STEP_GRAPHS.pool_bytes("cuda:0") + \
        STEP_GRAPHS.pool_bytes("cuda:1")


_NCCL_RANK = r"""
import json, sys
import numpy as np
import torch
import torch.distributed as dist
from orion_tpu_torch.algo import sharding
from orion_tpu_torch.parallel import device_mesh, init_distributed, shard_candidates

rank, port = int(sys.argv[1]), sys.argv[2]
init_distributed(coordinator=f"localhost:{port}", num_processes=2, process_id=rank,
                 local_device_ids=[rank])
mesh = device_mesh()
rows = np.zeros((8, 2), np.float32)
for r in range(4 * rank, 4 * rank + 4):
    rows[r] = 1 + r
card = torch.device("cuda", rank)
full = sharding.gather_candidates(shard_candidates(torch.from_numpy(rows).to(card), mesh))
print("PSUM", float(full.sum()), flush=True)
from orion_tpu_torch.algo.base import create_algo
from orion_tpu_torch.space.dsl import build_space
space = build_space({f"x{i}": "uniform(0, 1)" for i in range(3)})
algo = create_algo(space, {"tpu_bo": {"n_init": 4, "n_candidates": 256, "fit_steps": 5,
                                      "use_mesh": True}}, seed=0, device=card)
x = np.random.default_rng(0).uniform(size=(8, 3))
algo.observe([{f"x{i}": float(v) for i, v in enumerate(r)} for r in x],
             [{"objective": float(v)} for v in np.random.default_rng(0).normal(size=8)])
print("RESULT", json.dumps([[p[k] for k in sorted(p)] for p in algo.suggest(4)]), flush=True)
dist.destroy_process_group()
"""


@pytest.mark.cuda
def test_nccl_cohort_of_two_cards(cuda):
    """Two processes, one card each, on ``nccl``: a cross-rank gather sums
    to 72.0 in both, and ``tpu_bo`` with the cohort's mesh suggests the same
    rows in both."""
    _needs_cards(2)
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", _NCCL_RANK, str(rank), str(port)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for rank in (0, 1)]
    try:
        results = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    lines = []
    for p, (out, err) in zip(procs, results):
        assert p.returncode == 0, err[-3000:]
        lines.append({ln.split(" ", 1)[0]: ln.split(" ", 1)[1] for ln in out.splitlines()
                      if ln.startswith(("PSUM", "RESULT"))})
    assert float(lines[0]["PSUM"]) == float(lines[1]["PSUM"]) == 72.0
    assert lines[0]["RESULT"] == lines[1]["RESULT"]


@pytest.mark.cuda
def test_benchmarks_time_the_kernel_and_the_replayed_round_on_the_card(cuda):
    """``run_gram_bench`` at one shape: the kernel launched, within 1e-5 of
    the plain path, CUDA-event times and the card's name in the row;
    ``device_seconds("hartmann6-q1024")``: a positive replay time, with
    ``fused_gram`` launched at the round's 16384 x 256 x 6 cross-gram in
    every replay, and the process's step graphs left untouched."""
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
    from orion_tpu_torch.benchmarks.gram_bench import run_gram_bench
    from orion_tpu_torch.benchmarks.suggest_bench import device_seconds

    before = gram.fused_gram.launches
    (row,) = run_gram_bench(device=cuda, shapes=[(16384, 256, 50)], reps=3)
    assert gram.fused_gram.launches > before
    assert row["backend"] == "cuda" and row["device"] == torch.cuda.get_device_name(0)
    assert row["max_abs_err"] <= 1e-5 and 0 < row["kernel_ms"] < row["plain_ms"]
    assert 0 < row["bound_share"] <= 1.0

    signatures = [(dev, sig) for dev, sig, _entry in STEP_GRAPHS.entries()]
    shapes, plan = [], gram._launch_plan

    def counting(m, n, d, aligned):
        shapes.append((m, n, d))
        return plan(m, n, d, aligned)

    gram._launch_plan = counting
    try:
        seconds = device_seconds("hartmann6-q1024", reps=2, k_hi=2, device=cuda)
    finally:
        gram._launch_plan = plan
    assert 0 < seconds < 1.0
    # The capture records its launch; each of the 2 x 2 replays counts one.
    assert shapes.count((16384, 256, 6)) >= 4, shapes
    assert [(dev, sig) for dev, sig, _entry in STEP_GRAPHS.entries()] == signatures


@pytest.mark.cuda
@pytest.mark.parametrize("act", ["relu", "tanh", "gelu"])
def test_lenet_example_training_steps_on_the_card_equal_the_cpu_run(cuda, act):
    """``examples/torch_mnist_lenet.py``: from the same weights and batches,
    four SGD steps and the forward pass on the card equal the CPU run within
    1e-4 (TF32 off: float32 matmuls on both sides)."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "examples", "torch_mnist_lenet.py")
    spec = importlib.util.spec_from_file_location("torch_mnist_lenet_example", path)
    lenet = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lenet)
    x, y = lenet.synthetic_mnist()
    xs, ys = torch.from_numpy(x), torch.from_numpy(y).long()
    on_cpu = lenet.init_params(2, seed=0, device="cpu")
    on_card = {k: v.to(cuda) for k, v in on_cpu.items()}
    fn = lenet.ACTS[act]
    for i in range(0, 4 * 128, 128):
        on_cpu = lenet.sgd_step(on_cpu, xs[i:i + 128], ys[i:i + 128], 0.05, fn)
        on_card = lenet.sgd_step(on_card, xs[i:i + 128].to(cuda), ys[i:i + 128].to(cuda),
                                 0.05, fn)
    for name, value in on_cpu.items():
        assert on_card[name].device.type == "cuda"
        torch.testing.assert_close(on_card[name].cpu(), value, atol=1e-4, rtol=0)
    torch.testing.assert_close(lenet.forward(on_card, xs[1536:].to(cuda), fn).cpu(),
                               lenet.forward(on_cpu, xs[1536:], fn), atol=1e-4, rtol=0)
    assert 0.0 <= lenet.train_eval(0.05, 128, 1, act, epochs=1, device=cuda) <= 1.0
