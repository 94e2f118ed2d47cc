"""The port's suggest gateway (``orion_tpu_torch.serve``) on the CPU: the
counterpart of each test in ``tests/unit/test_serve.py``, with every
gateway and standalone algorithm on ``device="cpu"``.

THE differential pin: M experiments served through one coalescing gateway
produce bit-identical suggestion streams to the same experiments run
standalone with matched seeds (``tpu_bo`` and ``asha_bo``).  Plus the
coalescer's unit contract, naive-clone semantics, tenancy (quota
backpressure, LRU eviction, reply-cache idempotency, observe dedup,
fair-share interleave), persist-restart and fleet-failover stream
continuity, re-attach replay; then what is the port's own: the wire
against a reference gateway, the ``serve`` command, the fleet probe of
``info``/``top``, and a ``hunt`` worker that reaches the gateway through a
``serve:`` section without calling into CUDA.
"""

import copy
import threading
import time

import numpy as np
import pytest

from orion_tpu_torch.algo.base import create_algo as _create_algo
from orion_tpu_torch.core.producer import _advance_rng
from orion_tpu_torch.serve.client import GatewayClient, RemoteAlgorithm
from orion_tpu_torch.serve.gateway import GatewayServer as _GatewayServer
from orion_tpu_torch.serve.gateway import _fair_chunks
from orion_tpu_torch.space.dsl import build_space


def create_algo(space, config, seed=None):
    return _create_algo(space, config, seed=seed, device="cpu")


def GatewayServer(**kwargs):
    return _GatewayServer(device="cpu", **kwargs)

#: One shared config for every GP-driving test in this module, so the
#: fused-step jit signatures (and their compiles) amortize across tests.
PRIORS = {f"x{i}": "uniform(0, 1)" for i in range(3)}
ALGO_CFG = {"tpu_bo": {"n_init": 4, "n_candidates": 64, "fit_steps": 4}}
Q = 4


def _objective(params):
    return float(sum((v - 0.3) ** 2 for v in params.values()))


def _drive(algo, rounds, barrier=None):
    """suggest/observe rounds through the public algorithm API; returns the
    per-round params streams."""
    streams = []
    for _ in range(rounds):
        if barrier is not None:
            barrier.wait(timeout=60)
        params = algo.suggest(Q)
        streams.append(params)
        algo.observe(params, [{"objective": _objective(p)} for p in params])
    return streams


@pytest.fixture
def gateway():
    server = GatewayServer(window=0.25, max_width=8)
    server.serve_background()
    yield server
    server.shutdown()
    server.server_close()


def _remote(gateway, tenant, seed, **client_kw):
    host, port = gateway.address
    client = GatewayClient(host=host, port=port, **client_kw)
    return RemoteAlgorithm(
        build_space(PRIORS), PRIORS, ALGO_CFG, client, tenant, seed=seed
    )


# --- the coalescer unit contract ---------------------------------------------


def test_coalesced_dispatch_bit_identical_to_standalone():
    """Stacked dispatch == per-tenant standalone dispatch, bitwise
    — rows AND the GPState carried into the next round's warm fit — with a
    non-pow-2 group (3 plans pad to 4: the padding lane must be inert)."""
    from orion_tpu_torch.algo.tpu_bo import run_fused_plan
    from orion_tpu_torch.serve.coalesce import run_coalesced_plans

    algos_a, algos_b = [], []
    rng = np.random.default_rng(7)
    for seed in (0, 1, 2):
        for bucket in (algos_a, algos_b):
            bucket.append(create_algo(build_space(PRIORS), ALGO_CFG, seed=seed))
    X = rng.uniform(size=(6, 3)).astype(np.float32)
    y = rng.uniform(size=(6,)).astype(np.float32)
    for algo in algos_a + algos_b:
        algo.observe_arrays(X, y.astype(np.float64))

    reference = [
        run_fused_plan(algo.fused_step_plan(Q)) for algo in algos_a
    ]
    coalesced = run_coalesced_plans(
        [algo.fused_step_plan(Q) for algo in algos_b]
    )
    for (rows_ref, state_ref), (rows_co, state_co) in zip(
        reference, coalesced
    ):
        assert np.array_equal(rows_ref.numpy(), rows_co.numpy())
        assert np.array_equal(
            state_ref.hypers.log_lengthscales.numpy(),
            state_co.hypers.log_lengthscales.numpy(),
        )
        assert np.array_equal(
            state_ref.alpha.numpy(), state_co.alpha.numpy()
        )


def test_coalesce_rejects_mixed_signatures():
    from orion_tpu_torch.serve.coalesce import run_coalesced_plans

    rng = np.random.default_rng(3)
    small = create_algo(build_space(PRIORS), ALGO_CFG, seed=0)
    big = create_algo(
        build_space(PRIORS),
        {"tpu_bo": {**ALGO_CFG["tpu_bo"], "n_candidates": 128}},
        seed=0,
    )
    X = rng.uniform(size=(6, 3)).astype(np.float32)
    y = rng.uniform(size=(6,)).astype(np.float64)
    for algo in (small, big):
        algo.observe_arrays(X, y)
    with pytest.raises(ValueError, match="signatures"):
        run_coalesced_plans([small.fused_step_plan(Q), big.fused_step_plan(Q)])


def test_fair_chunks_round_robin_across_tenants():
    class _Job:
        def __init__(self, tenant_name):
            self.tenant = type("T", (), {"name": tenant_name})()
            self.width = None

    jobs = [_Job("a"), _Job("a"), _Job("a"), _Job("b"), _Job("c")]
    chunks = _fair_chunks(jobs, max_width=3)
    # Round-robin: the first (widest) dispatch serves one request per
    # tenant; tenant a's backlog rides the second.
    assert [j.tenant.name for j in chunks[0]] == ["a", "b", "c"]
    assert [j.tenant.name for j in chunks[1]] == ["a", "a"]
    assert all(j.width == 3 for j in chunks[0])
    assert all(j.width == 2 for j in chunks[1])


# --- THE differential: served == standalone ----------------------------------


def test_gateway_streams_bit_identical_to_standalone(gateway):
    """M tenants, concurrent barrier-synced rounds through one gateway
    (coalescing verifiably happened) == the same seeds run standalone."""
    rounds, seeds = 4, (0, 1)
    reference = {
        seed: _drive(create_algo(build_space(PRIORS), ALGO_CFG, seed=seed), rounds)
        for seed in seeds
    }
    barrier = threading.Barrier(len(seeds))
    out, errors = {}, []

    def worker(seed):
        try:
            out[seed] = _drive(
                _remote(gateway, f"diff-{seed}", seed), rounds, barrier
            )
        except Exception as exc:  # surfaced after join
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(s,)) for s in seeds]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
    assert not errors, errors
    for seed in seeds:
        assert out[seed] == reference[seed], (
            f"served stream diverged from standalone for seed {seed}"
        )
    stats = gateway.stats_snapshot()
    assert stats["max_width"] >= 2, stats["widths"]
    assert stats["dispatches"] < stats["suggests"]
    assert stats["dispatches_per_suggest"] < 1.0


#: asha_bo leg of the differential: a fidelity dimension, rung promotions
#: riding ahead of the GP plan, and the promotion-stash demux on the
#: gateway side.  n_init == q == 8 makes round 1 random init and every
#: later round promote 8//3 = 2 — so GP rounds carry a stash AND fresh
#: points, the exact shape the coalescer must keep bit-stable.
ASHA_PRIORS = {
    **{f"x{i}": "uniform(0, 1)" for i in range(3)},
    "epochs": "fidelity(1, 9, 3)",
}
ASHA_CFG = {"asha_bo": {"n_init": 8, "n_candidates": 64, "fit_steps": 4}}
ASHA_Q = 8


def _drive_asha(algo, rounds, barrier=None):
    streams = []
    for _ in range(rounds):
        if barrier is not None:
            barrier.wait(timeout=60)
        params = algo.suggest(ASHA_Q)
        streams.append(params)
        algo.observe(
            params,
            [
                {"objective": _objective(
                    {k: v for k, v in p.items() if k.startswith("x")}
                )}
                for p in params
            ],
        )
    return streams


def test_asha_bo_served_streams_bit_identical_and_coalesce(gateway):
    """Two asha_bo tenants through one gateway == standalone, with rung
    promotions crossing the wire, and their GP rounds still coalescing
    (width >= 2) — promotions ride the reply, never a separate dispatch."""
    rounds, seeds = 3, (0, 1)
    reference = {
        seed: _drive_asha(
            create_algo(build_space(ASHA_PRIORS), ASHA_CFG, seed=seed), rounds
        )
        for seed in seeds
    }
    # Promotions actually happened standalone — the differential is not
    # vacuously comparing pure-init streams.
    fidelities = {
        p["epochs"] for stream in reference.values() for r in stream for p in r
    }
    assert len(fidelities) > 1, "no rung promotions in the reference run"

    barrier = threading.Barrier(len(seeds))
    out, errors = {}, []

    def worker(seed):
        try:
            host, port = gateway.address
            remote = RemoteAlgorithm(
                build_space(ASHA_PRIORS), ASHA_PRIORS, ASHA_CFG,
                GatewayClient(host=host, port=port),
                f"asha-diff-{seed}", seed=seed,
            )
            out[seed] = _drive_asha(remote, rounds, barrier)
        except Exception as exc:  # surfaced after join
            errors.append(exc)
            barrier.abort()

    threads = [threading.Thread(target=worker, args=(s,)) for s in seeds]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(timeout=300)
    assert not errors, errors
    for seed in seeds:
        assert out[seed] == reference[seed], (
            f"served asha_bo stream diverged from standalone for seed {seed}"
        )
    stats = gateway.stats_snapshot()
    assert stats["max_width"] >= 2, stats["widths"]


def test_naive_suggest_mirrors_producer_semantics(gateway):
    """The producer's naive-clone round through the gateway == the same
    sequence run locally: deepcopy, observe lies on the copy, suggest from
    it (twice — one clone epoch, one server-side rebuild), sync the RNG
    stream back to the real instance."""
    seed, rounds = 5, 2
    local = create_algo(build_space(PRIORS), ALGO_CFG, seed=seed)
    remote = _remote(gateway, "naive-mirror", seed)

    # Warm both with an identical observed history.
    rng = np.random.default_rng(11)
    X = rng.uniform(size=(5, 3)).astype(np.float32)
    params = [
        {f"x{i}": float(row[i]) for i in range(3)} for row in X
    ]
    results = [{"objective": float(v)} for v in rng.uniform(size=5)]
    local.observe(params, results)
    remote.observe(params, results)

    lie_params = [{f"x{i}": 0.5 for i in range(3)}]
    lie_results = [{"objective": 0.25}]
    for _ in range(rounds):
        local_naive = copy.deepcopy(local)
        local_naive.observe(lie_params, lie_results)
        remote_naive = copy.deepcopy(remote)
        remote_naive.observe(lie_params, lie_results)
        # Two suggests per round: the second must come from the SAME
        # conditioned copy server-side (one rebuild per clone epoch).
        for _ in range(2):
            expect = local_naive.suggest(Q)
            _advance_rng(local, local_naive)
            got = remote_naive.suggest(Q)
            assert got == expect
    per_tenant = gateway.stats_snapshot()["per_tenant"]["naive-mirror"]
    # Lies never polluted the real tenant: only the initial batch counts.
    assert per_tenant["n_observed"] == 5


# --- tenancy: idempotency, quotas, eviction, persist --------------------------


def _attach_raw(client, tenant, seed=0, quotas=None):
    return client.request(
        "attach",
        {
            "tenant": tenant,
            "algo": ALGO_CFG,
            "priors": PRIORS,
            "seed": seed,
            "quotas": quotas or {},
        },
    )


def test_suggest_reply_cache_makes_reask_idempotent(gateway):
    host, port = gateway.address
    client = GatewayClient(host=host, port=port)
    _attach_raw(client, "idem")
    first = client.request(
        "suggest", {"tenant": "idem", "num": 3, "req_id": "r:1"}
    )
    again = client.request(
        "suggest", {"tenant": "idem", "num": 3, "req_id": "r:1"}
    )
    assert again["cube"] == first["cube"]
    fresh = client.request(
        "suggest", {"tenant": "idem", "num": 3, "req_id": "r:2"}
    )
    assert fresh["cube"] != first["cube"]
    stats = gateway.stats_snapshot()
    # The re-ask was served from the reply cache: 3 suggests, 2 dispatches.
    assert stats["per_tenant"]["idem"]["suggests"] == 3
    assert stats["dispatches"] == 2


def test_observe_dedup_converges_on_obs_id(gateway):
    host, port = gateway.address
    client = GatewayClient(host=host, port=port)
    _attach_raw(client, "dedup")
    payload = {
        "tenant": "dedup",
        "obs_id": "o:1",
        "params": [{f"x{i}": 0.25 for i in range(3)}],
        "objectives": [1.5],
        "cube": [[0.25, 0.25, 0.25]],
    }
    first = client.request("observe", payload)
    assert first["applied"] is True and first["n_observed"] == 1
    resend = client.request("observe", payload)
    assert resend["applied"] is False and resend["n_observed"] == 1


def test_quota_backpressure_refused_then_honored():
    """A tenant over its max_inflight quota gets RETRY-AFTER; the client
    honors the hint and converges once the in-flight suggest drains."""
    server = GatewayServer(window=1.0, max_width=4, max_inflight=1)
    host, port = server.serve_background()
    try:
        setup = GatewayClient(host=host, port=port)
        _attach_raw(setup, "busy", quotas={"max_inflight": 1})
        results, errors = {}, []

        def ask(name, delay):
            try:
                time.sleep(delay)
                client = GatewayClient(host=host, port=port)
                results[name] = (
                    client.request(
                        "suggest",
                        {"tenant": "busy", "num": 2, "req_id": f"{name}:1"},
                    ),
                    client.backpressure_honored,
                )
            except Exception as exc:
                errors.append(exc)

        threads = [
            threading.Thread(target=ask, args=("first", 0.0)),
            # Lands while `first` is still sitting in the 1s coalescing
            # window — the quota refuses it at admission.
            threading.Thread(target=ask, args=("second", 0.3)),
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=60)
        assert not errors, errors
        assert results["first"][0]["cube"] is not None
        assert results["second"][0]["cube"] is not None
        assert results["second"][1] >= 1, "second ask never saw backpressure"
        assert server.stats_snapshot()["backpressure"] >= 1
    finally:
        server.shutdown()
        server.server_close()


def test_attach_overflow_evicts_lru_idle_tenant():
    server = GatewayServer(window=0.01, max_tenants=2)
    host, port = server.serve_background()
    try:
        client = GatewayClient(host=host, port=port)
        _attach_raw(client, "old")
        _attach_raw(client, "mid")
        # Touch `old` so `mid` becomes the LRU victim.
        client.request("suggest", {"tenant": "old", "num": 1, "req_id": "a"})
        _attach_raw(client, "new")
        stats = server.stats_snapshot()
        assert stats["evictions"] == 1
        assert set(stats["per_tenant"]) == {"old", "new"}
        from orion_tpu_torch.serve.protocol import UnknownTenantError

        with pytest.raises(UnknownTenantError):
            client.request("suggest", {"tenant": "mid", "num": 1, "req_id": "b"})
    finally:
        server.shutdown()
        server.server_close()


def test_persist_restart_resumes_identical_stream(tmp_path):
    """A --persist gateway restarted mid-run continues the EXACT suggestion
    stream (state_dict snapshots carry history, trust region AND the RNG
    stream) — no client replay, no fork."""
    rounds = 3
    reference = _drive(
        create_algo(build_space(PRIORS), ALGO_CFG, seed=9), rounds
    )
    snapshot = str(tmp_path / "gateway.pkl")
    server = GatewayServer(window=0.01, persist=snapshot)
    host, port = server.serve_background()
    algo = _remote_at(host, port, "persist-exp", 9)
    streams = _drive(algo, 2)
    server.shutdown()
    server.server_close()

    server2 = GatewayServer(host=host, port=port, window=0.01, persist=snapshot)
    server2.serve_background()
    try:
        attach = _attach_raw(
            GatewayClient(host=host, port=port), "persist-exp", seed=9
        )
        assert attach["created"] is False, "persisted tenant was lost"
        assert attach["n_observed"] == 2 * Q
        streams += _drive(algo, rounds - 2)
    finally:
        server2.shutdown()
        server2.server_close()
    assert streams == reference


def _remote_at(host, port, tenant, seed):
    client = GatewayClient(host=host, port=port)
    return RemoteAlgorithm(
        build_space(PRIORS), PRIORS, ALGO_CFG, client, tenant, seed=seed
    )


def test_fleet_kill_owner_second_gateway_resumes_bit_identical(tmp_path):
    """The fleet twin of the persist-restart pin: kill the ring-owner
    gateway mid-run and the client fails over to the SURVIVING member,
    which restores the tenant from the shared per-tenant store and
    continues the EXACT suggestion stream — zero lost observations, no
    fork, no client-visible divergence from an uninterrupted run."""
    import socket

    from orion_tpu_torch.serve.client import parse_address
    from orion_tpu_torch.serve.fleet import FleetRouter, FleetState, ring_key

    rounds = 4
    reference = _drive(
        create_algo(build_space(PRIORS), ALGO_CFG, seed=11), rounds
    )

    def _free_port():
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        return port

    store = str(tmp_path / "fleet-store")
    ports = (_free_port(), _free_port())
    members = [f"127.0.0.1:{port}" for port in ports]
    gateways = [
        GatewayServer(
            host="127.0.0.1", port=port, window=0.01, max_width=8,
            fleet=members, advertise=member, persist=store,
        )
        for port, member in zip(ports, members)
    ]
    for gw in gateways:
        gw.serve_background()

    tenant = "fleet-exp"
    owner = FleetState(members).owner(ring_key(tenant))
    victim, survivor = (
        (gateways[0], gateways[1])
        if owner == members[0]
        else (gateways[1], gateways[0])
    )

    retry = {"max_attempts": 6, "deadline": 20.0, "base_delay": 0.05}

    def _factory(address):
        host, port = parse_address(address)
        return GatewayClient(
            host=host, port=port, retry=dict(retry), timeout=20.0
        )

    router = FleetRouter(members, _factory)
    client = router.client(router.resolve(ring_key(tenant))[0])
    algo = RemoteAlgorithm(
        build_space(PRIORS), PRIORS, ALGO_CFG, client, tenant, seed=11,
        router=router,
    )
    try:
        streams = _drive(algo, 2)
        # Simulated crash: no farewell snapshot — durability must come
        # from the sync persist-before-reply-release path alone.
        victim.kill()
        streams += _drive(algo, rounds - 2)
        assert streams == reference
        assert router.failovers >= 1
        per_tenant = survivor.stats_snapshot()["per_tenant"][tenant]
        # All four rounds landed exactly once: two served by the victim
        # (restored from its synced store snapshot), two by the survivor.
        assert per_tenant["n_observed"] == rounds * Q
    finally:
        router.close()
        survivor.shutdown()
        survivor.server_close()


def test_reattach_replays_observation_log(gateway):
    """An evicted/forgotten tenant is rebuilt transparently: the adapter
    re-attaches and replays its client-side observe log, then the original
    ask proceeds — the restart-without-persist contract."""
    algo = _remote(gateway, "replay-exp", seed=3)
    streams = _drive(algo, 2)
    assert len(streams) == 2
    # Forcibly forget the tenant (an eviction's client-visible signature).
    host, port = gateway.address
    GatewayClient(host=host, port=port).request(
        "detach", {"tenant": "replay-exp"}
    )
    more = _drive(algo, 1)
    assert len(more[0]) == Q
    per_tenant = gateway.stats_snapshot()["per_tenant"]["replay-exp"]
    # Both pre-detach observe batches were replayed into the fresh tenant,
    # then the post-detach round observed its own batch on top.
    assert per_tenant["n_observed"] == 3 * Q


def test_bad_op_and_oversized_q_are_fatal(gateway):
    from orion_tpu_torch.serve.protocol import GatewayError

    host, port = gateway.address
    client = GatewayClient(host=host, port=port)
    with pytest.raises(GatewayError):
        client.request("frobnicate", {})
    _attach_raw(client, "caps", quotas={"max_q": 8})
    with pytest.raises(GatewayError, match="max_q"):
        client.request("suggest", {"tenant": "caps", "num": 64, "req_id": "x"})


def test_stale_persisted_tenant_catches_up_without_double_observe(tmp_path):
    """A gateway killed between persist intervals restores a STALE tenant
    (missing the last batches).  The client's attach detects it is behind
    its replay log and replays; the persisted applied-id ledger dedups the
    already-snapshotted batches — the tenant converges to the full history
    with no double-observation."""
    import shutil

    snapshot = str(tmp_path / "stale.pkl")
    server = GatewayServer(window=0.01, persist=snapshot)
    host, port = server.serve_background()
    algo = _remote_at(host, port, "stale-exp", 4)
    _drive(algo, 2)
    # Capture the persist state at 2 rounds, let a third round land, then
    # "crash" by restoring the stale snapshot before the restart.
    server._write_snapshot()
    shutil.copy(snapshot, snapshot + ".stale")
    _drive(algo, 1)
    server.shutdown()
    server.server_close()
    shutil.copy(snapshot + ".stale", snapshot)

    server2 = GatewayServer(host=host, port=port, window=0.01, persist=snapshot)
    server2.serve_background()
    try:
        restored = server2._tenants["stale-exp"]
        assert restored.algo.n_observed == 2 * Q  # stale, missing round 3
        # Any next op re-attaches (the tenant EXISTS, but is behind the
        # client log) and replays; the ledger dedups rounds 1-2.
        algo._shared["attached"] = False
        _drive(algo, 1)
        per_tenant = server2.stats_snapshot()["per_tenant"]["stale-exp"]
        assert per_tenant["n_observed"] == 4 * Q  # 3 replayed + 1 new round
    finally:
        server2.shutdown()
        server2.server_close()


# --- the port's own: wire, commands, isolation from the card ------------------


@pytest.fixture
def both_gateways():
    """One gateway of each package, side by side (the reference's on JAX's
    CPU backend)."""
    from orion_tpu.serve.gateway import GatewayServer as RefGatewayServer

    servers = [GatewayServer(window=0.01, max_q=8), RefGatewayServer(window=0.01, max_q=8)]
    for server in servers:
        server.serve_background()
    yield servers
    for server in servers:
        server.shutdown()
        server.server_close()


def test_port_client_reads_the_same_reply_lines_from_either_gateway(both_gateways):
    """The port's ``GatewayClient`` and the reference's send the same
    request lines to a port and a reference gateway: ``ping``, ``attach``,
    a suggest refused for an unknown tenant and one refused over ``max_q``
    get equal replies, four ways."""
    from orion_tpu.serve.client import GatewayClient as RefGatewayClient
    from orion_tpu.serve.protocol import dumps_line as ref_dumps_line
    from orion_tpu_torch.serve.protocol import dumps_line

    requests = [
        {"op": "ping"},
        {"op": "attach", "tenant": "wire", "algo": {"random": {}},
         "priors": {"x0": "uniform(0, 1)"}, "seed": 0},
        {"op": "suggest", "tenant": "nobody", "num": 1, "req_id": "r:1"},
        {"op": "suggest", "tenant": "wire", "num": 64, "req_id": "r:2"},
    ]
    replies = []
    for client_cls, dumps in ((GatewayClient, dumps_line), (RefGatewayClient, ref_dumps_line)):
        for server in both_gateways:
            client = client_cls(*server.address)
            assert [dumps(r) for r in requests] == [ref_dumps_line(r) for r in requests]
            replies.append([client._exchange_once(r["op"], dumps(r)) for r in requests])
            client.close()
        # The second client re-attaches the same tenant: not created again.
        requests[1] = dict(requests[1], tenant=f"wire{len(replies)}")
    port, ref, ref_client_port, ref_client_ref = replies
    assert port == ref == ref_client_port == ref_client_ref
    assert port[0] == {"ok": True, "result": "pong"}
    assert port[1]["result"]["created"] is True
    assert port[2]["error"] == "UnknownTenant"
    assert port[3]["error"] == "GatewayError" and "max_q=8" in port[3]["message"]


def test_remote_algorithm_drives_either_gateway(both_gateways):
    """A port ``RemoteAlgorithm`` attaches, suggests and observes through a
    reference gateway as through the port's (random search: the rows
    come from each package's own stream)."""
    for server in both_gateways:
        client = GatewayClient(*server.address)
        algo = RemoteAlgorithm(build_space(PRIORS), PRIORS, {"random": {}}, client,
                               "cross", seed=0)
        params = algo.suggest(3)
        assert len(params) == 3 and all(0 <= p["x0"] <= 1 for p in params)
        algo.observe(params, [{"objective": 1.0}] * 3)
        assert client.stats()["per_tenant"]["cross"]["n_observed"] == 3
        client.close()


def test_fleet_probe_line_is_the_references(both_gateways):
    """``describe_serve_fleet`` (the ``info --all`` / ``top --all`` header)
    of each package over each live gateway: one line, equal."""
    from orion_tpu.cli.base import describe_serve_fleet as ref_describe
    from orion_tpu_torch.cli.base import describe_serve_fleet

    for server in both_gateways:
        config = {"address": "%s:%d" % server.address}
        line = describe_serve_fleet(config)
        assert line == ref_describe(config)
        assert line == f"serve: 1 gateway(s) [g0={config['address']} t:0 q:0] epoch=0"


def test_serve_command_needs_a_card_or_cpu_and_a_secret(monkeypatch, capsys):
    """``orion-tpu-torch serve`` exits 1 where no card is present and
    ``--device cpu`` was not given, and (like the reference) without
    ``--secret-file`` or ``--no-auth``."""
    import torch

    from orion_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["serve", "--port", "0", "--no-auth"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
    assert main(["serve", "--port", "0", "--device", "cpu"]) == 1
    assert "refusing to serve without authentication" in capsys.readouterr().err


def test_serve_command_serves_until_sigint(tmp_path):
    """``orion-tpu-torch serve --device cpu`` as a process: it prints its
    address, answers a tenant, and on SIGINT writes its ``--persist``
    snapshot and exits 0."""
    import os
    import signal
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    persist = tmp_path / "gateway.pkl"
    proc = subprocess.Popen(
        [sys.executable, "-m", "orion_tpu_torch.cli", "serve", "--device", "cpu", "--host",
         "127.0.0.1", "--port", "0", "--no-auth", "--persist", str(persist)],
        env=dict(os.environ, PYTHONPATH=root, PYTHONUNBUFFERED="1"),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        line = proc.stdout.readline()
        assert "suggest gateway listening on" in line and "device=cpu" in line, line
        host, port = line.split("listening on ")[1].split(" ")[0].split(":")
        algo = RemoteAlgorithm(build_space(PRIORS), PRIORS, ALGO_CFG,
                               GatewayClient(host, int(port)), "cmd", seed=0)
        params = algo.suggest(Q)
        algo.observe(params, [{"objective": _objective(p)} for p in params])
    finally:
        proc.send_signal(signal.SIGINT)
        assert proc.wait(timeout=60) == 0
    assert persist.exists()


def test_hunt_worker_through_the_gateway_never_calls_into_cuda(tmp_path, monkeypatch, capsys):
    """``Experiment.instantiate`` with a ``serve:`` section builds a
    ``RemoteAlgorithm``, and a ``hunt`` worker over it (``--device`` left at
    its ``cuda`` default) completes its trials without one call into
    ``torch.cuda``'s driver entry points: the gateway (here on the CPU in
    this process) runs the rounds."""
    import torch
    import yaml

    from orion_tpu_torch.cli import main
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.storage.base import create_storage

    from torch_parity import isolated_telemetry

    gateway = GatewayServer(window=0.01)
    host, port = gateway.serve_background()
    script, conf = tmp_path / "box.py", tmp_path / "serve.yaml"
    script.write_text(
        "from orion_tpu_torch.client import report_results\n"
        "import sys\n"
        "x = float(sys.argv[sys.argv.index('-x0') + 1])\n"
        "report_results([{'name': 'o', 'type': 'objective', 'value': (x - 0.3) ** 2}])\n")
    # Telemetry on, as an operator runs it: the metrics flush samples device
    # memory and the compiler plane's capacity, which must not probe a card.
    conf.write_text(yaml.safe_dump({"algorithms": ALGO_CFG, "telemetry": True,
                                    "serve": {"address": f"{host}:{port}"}}))

    calls = []

    def refuse(name):
        def call(*_args, **_kwargs):
            # Recorded, then raised: observability code swallows exceptions.
            calls.append(name)
            raise AssertionError(f"a served worker called torch.cuda.{name}")

        return call

    for name in ("is_available", "_lazy_init", "device_count", "init", "current_device",
                 "get_device_properties", "memory_stats", "mem_get_info", "synchronize"):
        monkeypatch.setattr(torch.cuda, name, refuse(name))
    db = str(tmp_path / "db.sqlite")
    try:
        with isolated_telemetry():
            rc = main(["hunt", "-n", "served", "-c", str(conf), "--storage-path", db,
                       "--pool-size", str(Q), "--max-trials", "12", str(script),
                       "-x0~uniform(0, 1)", "-x1~uniform(0, 1)", "-x2~uniform(0, 1)"])
        stats = gateway.stats_snapshot()
        experiment = build_experiment(create_storage({"type": "sqlite", "path": db}),
                                      "served")
        experiment.serve_config = {"address": f"{host}:{port}"}
        experiment.instantiate(seed=1)  # device=None: the card, were it local
        remote = experiment.algorithm
    finally:
        gateway.shutdown()
        gateway.server_close()
    assert calls == []
    assert rc == 0, capsys.readouterr().err
    assert "trials completed: 12" in capsys.readouterr().out
    [worker] = [t for name, t in stats["per_tenant"].items() if name.startswith("served-v1@")]
    assert worker["n_observed"] >= 8 and stats["dispatches"] >= 3
    assert isinstance(remote, RemoteAlgorithm) and remote.device.type == "cpu"
