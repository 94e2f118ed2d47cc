"""The port's CUDA kernels on the card (marked ``cuda``; they skip without
one).  This file imports no JAX, so the machine with the card, which has
none, runs it without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

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
    and suggests; the real algorithm's ``cuda`` generator takes the naive
    copy's state (a copy, not the object) and its history holds no lie."""
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
    assert real.generator.device.type == "cuda"
    before = real.generator.get_state().clone()
    assert len(client.suggest(4)) == 4
    naive = client.producer.naive_algorithm
    after = real.generator.get_state()
    assert not torch.equal(before, after)
    assert torch.equal(after, naive.generator.get_state())
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
    """The main path's round (130 observed, q=1024, 16384 candidates): two
    copies of one algorithm, one suggesting with telemetry off, the other
    with it on, in either order, give equal rows (exact), and the on round
    books one ``suggest_step.dispatch`` span of ``{"q": 1024, "n": 256}``
    with a ``fused_gram`` launch."""
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
    rows = {}
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
        for _ in range(40):  # each new address re-rolls the four-shard ring
            four = three + [serve()]
            if HashRing(four).lookup(exp["_id"]) != src:
                break
        dst = HashRing(four).lookup(exp["_id"])
        assert dst != src
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
        # Another seed: with seed 0 again the new instance's first draws are
        # the random round's points, and their duplicates send the producer
        # back for another round.
        stats = optimize(None, priors, max_trials=2048, batch_size=1024, algorithm=HUNT_ALGO,
                         seed=1, batch_eval=hartmann6, storage=storage, name="day2")
        assert stats["trials_completed"] == 2048
        assert gram.fused_gram.launches - launches == len(shapes) >= 1, shapes
        assert set(shapes) == {(16384, 256, 6)}, shapes
        assert conns[dst].count("trials", {"experiment": exp["_id"], "status": "completed"}) \
            == 2048
    finally:
        for server in started:
            server.shutdown()
            server.server_close()
