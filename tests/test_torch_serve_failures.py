"""The port gateway's failure paths on the CPU (the counterpart of
``tests/unit/test_serve_failures.py``), driven through the port's
byte-level ``FaultProxy``, plus the three serve rules of the doctor
provoked through real gateways.

The contracts:

- **gateway restart mid-suggest**: the reply is lost AND the gateway that
  computed it dies; the client reconnects (landing on the replacement
  gateway), re-attaches, replays its observation log, re-asks — and the
  worker registers EXACTLY one set of trials.
- **observe reply lost**: the applied-but-unknowable resend converges on
  the client-minted obs_id (no double-observation server-side).
- **backpressure honored**: a RETRY-AFTER refusal makes the client wait at
  least the hinted delay before the policy re-asks, and the ask converges.
- **the doctor reads the gateway**: DX005 fires on a full admission queue,
  DX007 on a fleet whose tenants all land on one member, DX008 on a
  handoff held fenced past its bar.
"""

import threading
import time

import numpy as np
import pytest

from orion_tpu_torch.serve.client import GatewayClient, RemoteAlgorithm
from orion_tpu_torch.serve.gateway import GatewayServer as _GatewayServer
from orion_tpu_torch.space.dsl import build_space
from orion_tpu_torch.storage.faults import FaultProxy

PRIORS = {f"x{i}": "uniform(0, 1)" for i in range(3)}
ALGO_CFG = {"tpu_bo": {"n_init": 4, "n_candidates": 64, "fit_steps": 4}}
Q = 4

#: Snappy client policy for fault tests: enough attempts to ride out a
#: restart, short backoffs so the suite stays fast.
RETRY = {"max_attempts": 10, "base_delay": 0.05, "max_delay": 0.5,
         "deadline": 60.0}


def GatewayServer(**kwargs):
    """The port's gateway on the CPU (the card is the default)."""
    return _GatewayServer(device="cpu", **kwargs)


def _remote_via(proxy_addr, tenant, seed=0):
    host, port = proxy_addr
    client = GatewayClient(host=host, port=port, retry=RETRY, idle_probe=0.2)
    return RemoteAlgorithm(
        build_space(PRIORS), PRIORS, ALGO_CFG, client, tenant, seed=seed
    )


def _observe_round(algo, rng, n=Q):
    X = rng.uniform(size=(n, 3)).astype(np.float32)
    params = [{f"x{i}": float(row[i]) for i in range(3)} for row in X]
    algo.observe(params, [{"objective": float(v)} for v in rng.uniform(size=n)])
    return params


def test_gateway_restart_mid_suggest_registers_exactly_one_batch(tmp_path):
    """drop_reply on the suggest + kill/replace the gateway underneath the
    retry: the re-ask lands on the fresh gateway, UnknownTenant triggers
    re-attach + replay, and the driving ExperimentClient ends the round
    with EXACTLY q registered trials."""
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.storage.base import create_storage

    server = GatewayServer(window=0.01)
    host, port = server.address
    server.serve_background()
    proxy = FaultProxy(host, port)
    proxy_addr = proxy.serve_background()
    replacement_box = []
    try:
        storage = create_storage({"type": "memory"})
        experiment = build_experiment(
            storage,
            "restart-exp",
            priors=PRIORS,
            algorithms=ALGO_CFG,
            pool_size=Q,
            metadata={"user": "t"},
        )
        experiment.serve_config = {
            "address": f"{proxy_addr[0]}:{proxy_addr[1]}",
            "retry": RETRY,
        }
        experiment.instantiate(seed=2, device="cpu")
        client = ExperimentClient(experiment, device="cpu")

        # One clean round first, so the restart also has observes to replay.
        trials = client.suggest(Q)
        client.observe_all(trials, [0.5] * len(trials))

        # Restart the gateway as soon as the armed drop_reply fires: the
        # in-flight suggest's reply is eaten AND the gateway that computed
        # it is gone before the retry lands.
        restarted = threading.Event()

        def restart_when_fired():
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if proxy.faults_fired.get("drop_reply"):
                    break
                time.sleep(0.005)
            server.shutdown()
            server.server_close()
            replacement = GatewayServer(host=host, port=port, window=0.01)
            replacement.serve_background()
            replacement_box.append(replacement)
            restarted.set()

        restarter = threading.Thread(target=restart_when_fired, daemon=True)
        restarter.start()
        proxy.fail_next("drop_reply")
        trials = client.suggest(Q)
        restarter.join(timeout=60)
        assert restarted.is_set(), "restart thread never saw the fault fire"
        assert proxy.faults_fired.get("drop_reply") == 1
        assert len(trials) == Q
        # EXACTLY one set registered for the round: q reserved by us, and
        # the storage holds the two rounds' worth of trials, no doubled
        # batch from the re-ask.
        all_trials = storage.fetch_trials(uid=experiment.id)
        assert len(all_trials) == 2 * Q
    finally:
        proxy.stop()
        for replacement in replacement_box:
            replacement.shutdown()
            replacement.server_close()


def test_fleet_kill_mid_suggest_fails_over_exactly_once(tmp_path):
    """The fleet twin of the restart-mid-suggest pin: the owner gateway's
    suggest reply is eaten by the proxy AND the owner is killed before the
    re-ask lands.  The router marks the owner down, fails over to the
    surviving member (takeover attach + replay), and the round converges
    with EXACTLY one observed batch — bit-identical to an uninterrupted
    standalone run (the sync persist-before-reply-release path snapshotted
    the post-suggest state, reply cache included, before the doomed reply
    ever left the dispatcher)."""
    import socket

    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.serve.client import parse_address
    from orion_tpu_torch.serve.fleet import FleetRouter, FleetState, ring_key

    def _free_port():
        sock = socket.socket()
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
        sock.close()
        return port

    def _drive(algo, rounds):
        streams = []
        for _ in range(rounds):
            params = algo.suggest(Q)
            streams.append(params)
            algo.observe(
                params,
                [
                    {"objective": float(sum(v * v for v in p.values()))}
                    for p in params
                ],
            )
        return streams

    rounds = 2
    reference = _drive(
        create_algo(build_space(PRIORS), ALGO_CFG, seed=6, device="cpu"), rounds
    )

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

    tenant = "fleet-fault-exp"
    owner = FleetState(members).owner(ring_key(tenant))
    victim, survivor = (
        (gateways[0], gateways[1])
        if owner == members[0]
        else (gateways[1], gateways[0])
    )
    proxy = FaultProxy(*parse_address(owner))
    proxy_addr = proxy.serve_background()

    class _ProxiedClient(GatewayClient):
        """Connects through the FaultProxy but reports the ring address,
        so the router's mark_down() hits the right member."""

        def __init__(self, ring_address, **kw):
            super().__init__(host=proxy_addr[0], port=proxy_addr[1], **kw)
            self._ring_address = ring_address

        @property
        def address(self):
            return self._ring_address

    def _factory(address):
        host, port = parse_address(address)
        if address == owner:
            # Slow first backoff: the dropped reply breaks the connection
            # immediately, and the re-ask must NOT race the kill thread
            # onto the still-alive victim (whose reply cache would answer
            # without any failover happening).
            return _ProxiedClient(
                address,
                retry={"max_attempts": 3, "deadline": 6.0,
                       "base_delay": 0.75, "max_delay": 1.0},
                timeout=20.0,
            )
        return GatewayClient(
            host=host, port=port, timeout=20.0,
            retry={"max_attempts": 4, "deadline": 10.0, "base_delay": 0.05},
        )

    router = FleetRouter(members, _factory)
    client = router.client(router.resolve(ring_key(tenant))[0])
    algo = RemoteAlgorithm(
        build_space(PRIORS), PRIORS, ALGO_CFG, client, tenant, seed=6,
        router=router,
    )
    try:
        streams = _drive(algo, 1)  # clean round: replay material

        killed = threading.Event()

        def kill_when_fired():
            deadline = time.monotonic() + 30
            while time.monotonic() < deadline:
                if proxy.faults_fired.get("drop_reply"):
                    break
                time.sleep(0.005)
            victim.kill()
            killed.set()

        killer = threading.Thread(target=kill_when_fired, daemon=True)
        killer.start()
        proxy.fail_next("drop_reply")
        streams += _drive(algo, 1)
        killer.join(timeout=60)
        assert killed.is_set(), "kill thread never saw the fault fire"
        assert proxy.faults_fired.get("drop_reply") == 1
        assert streams == reference
        assert router.failovers >= 1
        per_tenant = survivor.stats_snapshot()["per_tenant"][tenant]
        # EXACTLY one batch per round: the eaten reply's round was NOT
        # double-observed by the re-ask on the survivor.
        assert per_tenant["n_observed"] == rounds * Q
    finally:
        proxy.stop()
        router.close()
        survivor.shutdown()
        survivor.server_close()


def test_observe_reply_lost_resend_converges(tmp_path):
    server = GatewayServer(window=0.01)
    host, port = server.address
    server.serve_background()
    proxy = FaultProxy(host, port)
    proxy_addr = proxy.serve_background()
    try:
        rng = np.random.default_rng(0)
        algo = _remote_via(proxy_addr, "obs-exp")
        _observe_round(algo, rng)  # clean batch
        proxy.fail_next("drop_reply")
        _observe_round(algo, rng)  # applied, reply eaten, resent, deduped
        assert proxy.faults_fired.get("drop_reply") == 1
        stats = GatewayClient(host=host, port=port).stats()
        # Converged: the gateway-side algorithm saw each batch ONCE.
        assert stats["per_tenant"]["obs-exp"]["n_observed"] == 2 * Q
        assert algo.n_observed == 2 * Q
    finally:
        proxy.stop()
        server.shutdown()
        server.server_close()


def test_backpressure_reply_honored_before_retry(tmp_path):
    """A full admission queue answers RETRY-AFTER; the client sleeps at
    least the hint before the policy re-asks, and the op then converges."""
    server = GatewayServer(window=1.0, max_inflight=1)
    host, port = server.address
    server.serve_background()
    proxy = FaultProxy(host, port)
    proxy_addr = proxy.serve_background()
    try:
        setup = GatewayClient(host=proxy_addr[0], port=proxy_addr[1])
        setup.request(
            "attach",
            {"tenant": "bp-exp", "algo": ALGO_CFG, "priors": PRIORS, "seed": 0},
        )
        results = {}
        errors = []

        def ask(name, delay):
            try:
                time.sleep(delay)
                client = GatewayClient(
                    host=proxy_addr[0], port=proxy_addr[1], retry=RETRY
                )
                t0 = time.monotonic()
                reply = client.request(
                    "suggest",
                    {"tenant": "bp-exp", "num": 2, "req_id": f"{name}:1"},
                )
                results[name] = (
                    reply, client.backpressure_honored, time.monotonic() - t0
                )
            except Exception as exc:  # surfaced after join
                errors.append(exc)

        threads = [
            threading.Thread(target=ask, args=("a", 0.0), daemon=True),
            # Lands while `a` sits in the 1s coalescing window: over the
            # max_inflight=1 quota -> RETRY-AFTER.
            threading.Thread(target=ask, args=("b", 0.3), daemon=True),
        ]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(timeout=90)
        assert not errors, errors
        assert results["a"][0]["cube"] is not None
        reply_b, honored_b, elapsed_b = results["b"]
        assert reply_b["cube"] is not None
        assert honored_b >= 1, "b never saw the backpressure refusal"
        # Honored: b waited at least the gateway's retry_after hint
        # (4 * window) on top of its own policy backoff.
        assert elapsed_b >= 4 * server.window
        assert server.stats_snapshot()["backpressure"] >= 1
    finally:
        proxy.stop()
        server.shutdown()
        server.server_close()


# --- the doctor reads the gateway ---------------------------------------------


def _fired(rule):
    """``rule``'s findings over this process's registry (the gateways run in
    this process, so their gauges and counters are its own)."""
    from orion_tpu_torch.diagnosis import local_snapshot, run_rules

    return [f for f in run_rules(local_snapshot(), rules=[rule]).findings
            if f.rule_id == rule.id]


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_dx005_fires_on_a_full_admission_queue():
    """A gateway whose admission queue holds one request, a busy tenant
    asking for GP rounds and 24 clients knocking at once: the queue-full
    RETRY-AFTER replies push ``serve.backpressure`` past DX005's bar."""
    from orion_tpu_torch.diagnosis.rules_system import ServeQueueSaturation
    from orion_tpu_torch.serve.protocol import dumps_line

    from torch_parity import isolated_telemetry

    with isolated_telemetry() as (telemetry, _flight, _rt, _rf):
        assert _fired(ServeQueueSaturation()) == []
        server = GatewayServer(window=0.05, pending_limit=1)
        host, port = server.serve_background()
        stop, refused = threading.Event(), []
        try:
            busy = _remote_via((host, port), "busy")
            _observe_round(busy, np.random.default_rng(1))

            def knock(i):
                client = GatewayClient(host=host, port=port)
                line = dumps_line({"op": "observe", "tenant": f"knock{i}", "obs_id": "o",
                                   "params": [], "objectives": []})
                while not stop.is_set():
                    reply = client._exchange_once("observe", line)
                    if reply.get("error") == "RetryAfter":
                        refused.append(reply["message"])
                client.close()

            threads = [threading.Thread(target=knock, args=(i,), daemon=True)
                       for i in range(24)]
            for thread in threads:
                thread.start()
            deadline = time.monotonic() + 60
            while len(refused) < ServeQueueSaturation.BACKPRESSURE and time.monotonic() < deadline:
                busy.suggest(Q)
            stop.set()
            for thread in threads:
                thread.join(timeout=30)
        finally:
            stop.set()
            server.shutdown()
            server.server_close()
        assert any("queue full" in message for message in refused)
        assert telemetry.counter_value("serve.backpressure") >= ServeQueueSaturation.BACKPRESSURE
        [finding] = _fired(ServeQueueSaturation())
        assert finding.subject == "backpressure" and finding.severity == "warn"


def test_dx007_fires_when_every_tenant_lands_on_one_member(tmp_path):
    """Two fleet gateways and eight tenants the ring places on the first:
    the members' ``serve.fleet.tenants.g<i>`` gauges read 8 and 0."""
    from orion_tpu_torch.diagnosis.rules_system import FleetTenantSkew
    from orion_tpu_torch.serve.fleet import FleetState, ring_key

    from torch_parity import isolated_telemetry

    members = [f"127.0.0.1:{_free_port()}" for _ in range(2)]
    owner = FleetState(members).addresses[0]
    names = [n for n in (f"skew{i}" for i in range(64))
             if FleetState(members).owner(ring_key(n)) == owner][:8]
    with isolated_telemetry() as (telemetry, _flight, _rt, _rf):
        gateways = [GatewayServer(host="127.0.0.1", port=int(m.split(":")[1]), window=0.01,
                                  fleet=members, advertise=m) for m in members]
        for gateway in gateways:
            gateway.serve_background()
        try:
            home = GatewayClient(*owner.split(":"))
            for name in names:
                home.request("attach", {"tenant": name, "algo": {"random": {}},
                                        "priors": PRIORS, "seed": 0})
            other = [m for m in members if m != owner][0]
            from orion_tpu_torch.serve.protocol import WrongGatewayError

            # One op through the other member's dispatcher: it publishes its
            # own (empty) count, and refuses the tenant it does not own.
            with pytest.raises(WrongGatewayError):
                GatewayClient(*other.split(":")).request(
                    "observe", {"tenant": names[0], "params": [], "objectives": []})
            gauges = telemetry.snapshot()["gauges"]
        finally:
            for gateway in gateways:
                gateway.shutdown()
                gateway.server_close()
        assert sorted(v for k, v in gauges.items()
                      if k.startswith("serve.fleet.tenants.g")) == [0.0, 8.0]
        [finding] = _fired(FleetTenantSkew())
        assert finding.value == 8.0


def test_dx008_fires_on_a_handoff_held_fenced_past_its_bar():
    """A fleet membership change hands a tenant to a member that accepts
    the connection and never answers: the tenant stays fenced, and once
    the fence is older than the rule's bar (here a quarter second on the
    rule instance, not the 30 s default) the gateway's own
    ``serve.fleet.fenced_age_s`` gauge makes DX008 fire.  Closing the hung
    member fails the push: the tenant is unfenced and kept."""
    import socket

    from orion_tpu_torch.diagnosis.rules_system import HandoffStuck

    from torch_parity import isolated_telemetry

    hung = socket.socket()
    hung.bind(("127.0.0.1", 0))
    hung.listen(8)
    hung_member = "127.0.0.1:%d" % hung.getsockname()[1]
    port = _free_port()
    me = f"127.0.0.1:{port}"
    rule = HandoffStuck()
    rule.TTL_S = 0.25
    with isolated_telemetry() as (telemetry, _flight, _rt, _rf):
        server = GatewayServer(host="127.0.0.1", port=port, window=0.01,
                               fleet=[me, hung_member], advertise=me)
        server.serve_background()
        reply = {}
        try:
            from orion_tpu_torch.serve.fleet import FleetState, ring_key

            name = next(n for n in (f"fence{i}" for i in range(64))
                        if FleetState([me, hung_member]).owner(ring_key(n)) == me)
            client = GatewayClient("127.0.0.1", port, timeout=120)
            client.request("attach", {"tenant": name, "algo": {"random": {}},
                                      "priors": PRIORS, "seed": 0})
            mover = threading.Thread(target=lambda: reply.update(client.request(
                "fleet_set", {"addresses": [hung_member], "epoch": 2})), daemon=True)
            mover.start()
            deadline = time.monotonic() + 30
            while server.fleet_snapshot()["fenced"] != 1 and time.monotonic() < deadline:
                time.sleep(0.02)
            time.sleep(0.5)
            # The dispatcher is inside the push; this is the publish it runs
            # after every cycle.
            server._publish_fleet_gauges()
            age = telemetry.gauge_value("serve.fleet.fenced_age_s")
            findings = _fired(rule)
            hung.close()
            mover.join(timeout=120)
        finally:
            hung.close()
            server.shutdown()
            server.server_close()
        assert age >= 0.5 and [f.value for f in findings] == [age]
        assert reply["failed"] == [name] and server.stats_snapshot()["handoff_failures"] == 1
        assert server.fleet_snapshot()["fenced"] == 0
