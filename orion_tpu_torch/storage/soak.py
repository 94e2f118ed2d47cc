"""Thousand-worker soak harness for the sharded control plane (port of
``orion_tpu/storage/soak.py``).

The shared load generator behind the port's soak tests, shipped in the
package so operators can soak their own topology the same way.  Two
pieces:

- :class:`SoakTopology` — an in-process N-shard x R-replica deployment of
  REAL :class:`~orion_tpu_torch.storage.netdb.DBServer`\\ s: every primary
  replicates to its replicas and sits behind a
  :class:`~orion_tpu_torch.storage.faults.FaultProxy`, so partitions
  (blackhole windows), reconnect storms (``drop_all``) and shard
  kill/restart (persisted primary restarted on the same port) exercise
  the REAL wire paths — client reconnects, replication resync, replica
  failover — not mocks.

- :func:`drive_soak` — N simulated workers (threads sharing a pool of
  routers, the way real worker processes share nothing) each register,
  reserve and complete trials through the full ``DocumentStorage``
  protocol while a seeded chaos controller runs storms/partitions/
  restarts on a fixed cycle.  The pass bar, asserted by the callers:

  * the run completes inside its deadline,
  * ZERO lost observations — every registered trial ends completed with
    an objective, counted through the router AND as the sum of direct
    per-shard reads (the two views must agree),
  * ``orion-tpu-torch audit --all`` comes back clean through the router
    and on every shard individually,
  * replica failover and degraded-mode shard loss actually happened
    (``storage.shard.failovers`` / reconnects moved).
"""

import logging
import os
import threading
import time

from orion_tpu_torch.core.trial import Result, Trial
from orion_tpu_torch.storage.audit import audit_storage
from orion_tpu_torch.storage.base import DocumentStorage
from orion_tpu_torch.storage.faults import FaultProxy
from orion_tpu_torch.storage.netdb import DBServer
from orion_tpu_torch.storage.retry import is_transient
from orion_tpu_torch.storage.shard import ShardedNetworkDB
from orion_tpu_torch.utils.exceptions import DuplicateKeyError

log = logging.getLogger(__name__)

#: DocumentStorage retry knobs for soak runs: enough deadline to ride out
#: a blackhole window plus a shard restart, tight backoff so the run
#: stays fast.
SOAK_RETRY = {
    "max_attempts": 10,
    "base_delay": 0.01,
    "max_delay": 0.5,
    "deadline": 60.0,
}


class _ShardDeployment:
    """One shard's processes: R replicas, a replicating primary (persisted,
    so a restart is lossless), and the fault proxy clients dial through."""

    def __init__(self, index, replicas, persist_dir, secret=None,
                 client_timeout=5.0, quorum=0):
        self.index = index
        self.secret = secret
        self.client_timeout = client_timeout
        self.quorum = quorum
        self.persist = (
            os.path.join(persist_dir, f"shard{index}.pkl") if persist_dir else None
        )
        self.replica_servers = []
        for _ in range(replicas):
            # Replicas carry the quorum floor too: the one a promotion
            # elects becomes a primary and must keep enforcing it.
            server = DBServer(port=0, secret=secret, replica=True, quorum=quorum)
            server.serve_background()
            self.replica_servers.append(server)
        self.primary_host = "127.0.0.1"
        self.primary_port = 0
        self.primary = self._start_primary(port=0)
        self.primary_host, self.primary_port = self.primary.address
        self.primary.serve_background()
        self.proxy = FaultProxy(self.primary_host, self.primary_port)
        self.proxy.serve_background()
        self.restarts = 0
        self.killed = False
        self._make_db = None

    def _start_primary(self, port):
        return DBServer(
            host="127.0.0.1",
            port=port,
            persist=self.persist,
            persist_interval=0.05,
            secret=self.secret,
            replicate_to=[s.address for s in self.replica_servers if s is not None],
            quorum=self.quorum,
        )

    def serve_spec(self):
        """The router-facing spec: the primary THROUGH its proxy, replicas
        direct (partitions target the write path; replica loss is its own
        chaos action)."""
        return {
            "host": self.proxy.address[0],
            "port": self.proxy.address[1],
            "replicas": [s.address for s in self.replica_servers if s is not None],
            "secret": self.secret,
        }

    def restart_primary(self):
        """Shard kill/restart: the primary shuts down (final durable
        snapshot), every live connection drops, and a fresh server comes
        back on the SAME port from the persisted state — its pushers
        re-probe the replicas and resume (or snapshot-resync) the
        stream."""
        port = self.primary_port
        self.primary.shutdown()
        self.primary.server_close()
        deadline = time.monotonic() + 10.0
        while True:
            try:
                self.primary = self._start_primary(port=port)
                break
            except OSError:  # port not yet released
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        if self._make_db is not None:
            # Faults survive the restart: the schedule keeps counting ops
            # on the reborn primary (a restart silently un-wrapping the
            # store made short runs' "every fault class fired" assertions
            # hash-placement-flaky — a lightly loaded shard could restart
            # before its first plan index).
            self.primary.db = self._make_db(self.primary.db)
        self.primary.serve_background()
        self.restarts += 1

    def kill_replica(self, replica_index=0):
        """Replica loss: reads that picked it fail over to the primary."""
        server = self.replica_servers[replica_index]
        if server is None:
            return
        server.shutdown()
        server.server_close()
        self.replica_servers[replica_index] = None

    def wait_replicated(self, timeout=10.0):
        """Block until at least one live replica has acknowledged the
        primary's full position.  Replication is ASYNCHRONOUS — a primary
        killed with an unreplicated tail loses that tail by design; the
        zero-lost promotion scenario is 'the most-caught-up replica holds
        everything', which this wait establishes deterministically."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            status = self.primary.replication_status()
            want = status["seq"]
            acked = [
                link["acked_seq"]
                for link in status["links"]
                if link["acked_seq"] is not None
            ]
            if not want or (acked and max(acked) >= want):
                return True
            time.sleep(0.02)
        return False

    def kill_primary(self, wait_catchup=True):
        """PERMANENT primary loss — no restart, no graceful flush: the
        automatic-promotion scenario.  Routers that keep writing must
        elect the most-caught-up replica themselves (no human in the
        loop)."""
        import socketserver as _socketserver

        if wait_catchup:
            self.wait_replicated()
        primary = self.primary
        primary._stop_flusher.set()
        for link in primary._repl_links:
            link.stop(flush=False)
        if getattr(primary, "_serving", False):
            _socketserver.ThreadingTCPServer.shutdown(primary)
        primary.close_connections()
        primary.server_close()
        self.killed = True

    def install_faults(self, make_db):
        """Wrap the primary's store (e.g. in a seeded
        :class:`~orion_tpu_torch.storage.faults.FaultyDB`) — BEFORE any client
        connects, so every handler sees the wrapped store.  The wrapper is
        re-applied across :meth:`restart_primary` (a fresh wrapper around
        the reborn store, driven by the SAME schedule — the op count and
        fault budget carry across the restart)."""
        self._make_db = make_db
        self.primary.db = make_db(self.primary.db)

    def stop(self):
        self.proxy.stop()
        for server in ([] if self.killed else [self.primary]) + self.replica_servers:
            if server is None:
                continue
            server.shutdown()
            server.server_close()


class SoakTopology:
    """An in-process sharded, replicated deployment under fault control."""

    def __init__(self, n_shards=3, replicas=2, persist_dir=None, secret=None,
                 quorum=0):
        self.replicas = replicas
        self.persist_dir = persist_dir
        self.secret = secret
        self.quorum = quorum
        self.shards = [
            _ShardDeployment(i, replicas, persist_dir, secret=secret,
                             quorum=quorum)
            for i in range(n_shards)
        ]

    def specs(self):
        return [shard.serve_spec() for shard in self.shards]

    def add_shard(self, replicas=None):
        """Grow the topology by one shard (the rebalance-mid-soak leg):
        the new deployment starts empty; `db rebalance` moves ~1/N of the
        experiments onto it once routers adopt the new spec list."""
        shard = _ShardDeployment(
            len(self.shards),
            self.replicas if replicas is None else replicas,
            self.persist_dir,
            secret=self.secret,
            quorum=self.quorum,
        )
        self.shards.append(shard)
        return shard

    def make_router(self, **kwargs):
        kwargs.setdefault("timeout", 5.0)
        kwargs.setdefault("reconnect_jitter", 0.05)
        # Soak runs compress time: a dead primary should promote within a
        # couple of op retries, not the production-grade 1.5s window.
        kwargs.setdefault("promote_after", 0.4)
        return ShardedNetworkDB(self.specs(), **kwargs)

    def drop_all(self):
        """Reconnect storm: every proxied primary connection dies at once."""
        for shard in self.shards:
            shard.proxy.drop_all()

    def partition(self, shard_index, seconds):
        """Blackhole one shard's primary for a window (ops on it stall and
        ride the retry/deadline policy; other shards proceed — the
        degraded-mode contract)."""
        proxy = self.shards[shard_index].proxy
        proxy.set_blackhole(True)
        try:
            time.sleep(seconds)
        finally:
            proxy.set_blackhole(False)
            proxy.drop_all()  # blackholed sockets are dead weight; drop them

    def stop(self):
        for shard in self.shards:
            shard.stop()


def _spread_names(router, n_experiments, n_shards):
    """Deterministic soak experiment names, greedily SPREAD across the
    ring: shard identities carry per-run ephemeral ports, so the fixed
    ``soak-{e}`` names can (rarely) all hash onto one shard — and an
    all-on-the-victim draw starves the chaos legs' signals (no traffic
    ever touches a killed replica, so the replica-failover gate can
    never fire).  Per slot, the candidate whose ring home currently
    holds the fewest experiments wins; pure function of the ring, so
    every caller agrees on placement.  Returns ``(names, loads)`` —
    the per-shard counts are the placement truth, computed ONCE."""
    from orion_tpu_torch.core.experiment import experiment_id

    names = []
    loads = {index: 0 for index in range(n_shards)}
    for e in range(n_experiments):
        candidates = [f"soak-{e}"] + [
            f"soak-{e}-{suffix}" for suffix in "abcdefghijk"
        ]
        best_name, best_home = None, None
        for name in candidates:
            home = router.shard_for(experiment_id(name, 1, "soak"))
            if best_home is None or loads[home] < loads[best_home]:
                best_name, best_home = name, home
        names.append(best_name)
        loads[best_home] += 1
    return names, loads


def soak_experiment_names(router, n_experiments, n_shards):
    """The spread names alone — what ``drive_soak`` creates."""
    names, _loads = _spread_names(router, n_experiments, n_shards)
    return names


def busiest_shard(topology, router, n_experiments):
    """Shard index the ring gave the most soak experiments — the
    kill-primary chaos legs target it, so promotion must heal a shard
    under live write load, never an idle corner.  Reads the load map the
    name spreading already computed (one placement truth, not two)."""
    _names, loads = _spread_names(router, n_experiments, len(topology.shards))
    return max(loads, key=lambda index: loads[index])


def grow_and_rebalance(topology, storages, fence_grace=0.3,
                       placement_ttl=0.2, max_grows=5):
    """The rebalance-mid-soak hook body (one scenario for every caller):
    grow the topology until the ring diff actually moves something —
    shard identities carry randomly assigned ports, so a tiny experiment
    set can (rarely) hash entirely onto the survivors and each extra
    shard re-rolls the draw — retarget every live router in place, then
    run the migrator to completion.  Returns
    ``{"planned": <plan summary>, "n_shards": N, "executed": True}``."""
    from orion_tpu_torch.storage.rebalance import Rebalancer

    outcome = {}
    admin = None
    plan = None
    try:
        for _ in range(max_grows):
            topology.add_shard()
            specs = topology.specs()
            for storage in storages:
                storage.db.set_topology(specs)
            if admin is not None:
                admin.close()
            admin = topology.make_router(
                replica_reads=False, placement_ttl=placement_ttl
            )
            plan = Rebalancer(admin, fence_grace=fence_grace).plan()
            if plan.moves:
                break
        outcome["planned"] = plan.summary()
        outcome["n_shards"] = len(topology.shards)
        Rebalancer(admin, fence_grace=fence_grace).run(plan)
        outcome["executed"] = True
    finally:
        if admin is not None:
            admin.close()
    return outcome


def drain_and_remove(topology, storages, fence_grace=0.3,
                     placement_ttl=0.2, drain_index=None):
    """The drain-mid-soak hook body (one scenario for every caller): drain
    one shard — the one holding the most experiments unless
    ``drain_index`` says otherwise, so removal always runs under live
    data — through the crash-resumable migrator (storage/drain.py),
    verify zero experiments remain on it, retarget every live router to
    the surviving topology, then stop the drained deployment.  Returns
    ``{"planned": <plan summary>, "ring_share": f, "residual": 0,
    "drained_index": i, "n_shards": N, "executed": True}``."""
    from orion_tpu_torch.storage.drain import Drainer

    outcome = {}
    admin = topology.make_router(
        replica_reads=False, placement_ttl=placement_ttl
    )
    try:
        if drain_index is None:
            loads = {
                index: len(conn.read("experiments", {}))
                for index, conn in admin.shard_connections()
            }
            drain_index = max(loads, key=lambda index: loads[index])
        drainer = Drainer(admin, drain_index, fence_grace=fence_grace)
        plan = drainer.plan()
        outcome["planned"] = plan.summary()
        outcome["ring_share"] = drainer.ring_share()
        outcome["drained_index"] = drain_index
        drainer.run(plan)
        outcome["residual"] = len(drainer.residual_experiments())
        # Only now does the shard leave the topology: survivors' ring ==
        # the drainer's destination ring (same identities, same vnodes),
        # so placement doesn't shift again.
        drained = topology.shards.pop(drain_index)
        specs = topology.specs()
        for storage in storages:
            storage.db.set_topology(specs)
        drained.stop()
        outcome["n_shards"] = len(topology.shards)
        outcome["executed"] = True
    finally:
        admin.close()
    return outcome


class ReplicaProvisioner:
    """A fresh empty replica server per request — the soak/test stand-in
    for a real fleet's machine allocator, handed to the router as its
    ``replica_provisioner``.  Tracks what it started so the caller can
    stop them."""

    def __init__(self, secret=None, quorum=0):
        self.secret = secret
        self.quorum = quorum
        self.servers = []
        self._lock = threading.Lock()

    def __call__(self, shard_index):
        server = DBServer(
            port=0, secret=self.secret, replica=True, quorum=self.quorum
        )
        server.serve_background()
        with self._lock:
            self.servers.append(server)
        return "%s:%s" % server.address

    def stop(self):
        with self._lock:
            servers, self.servers = list(self.servers), []
        for server in servers:
            server.shutdown()
            server.server_close()


class SoakResult:
    """Outcome of one :func:`drive_soak` run."""

    def __init__(self):
        self.registered = 0
        self.completed = 0
        self.completed_per_shard = {}
        self.router_reports = []
        self.shard_reports = {}
        self.worker_errors = 0
        self.duration_s = 0.0
        self.failovers = 0
        self.replica_stale_reads = 0
        self.reconnects = 0
        self.restarts = 0
        self.promotions = 0
        self.primary_kills = 0

    @property
    def audits_clean(self):
        reports = list(self.router_reports)
        for shard_reports in self.shard_reports.values():
            reports.extend(shard_reports)
        return bool(reports) and all(r.ok for r in reports)

    @property
    def lost_observations(self):
        return self.registered - self.completed

    def summary(self):
        return {
            "registered": self.registered,
            "completed": self.completed,
            "lost_observations": self.lost_observations,
            "completed_per_shard": dict(self.completed_per_shard),
            "audits_clean": self.audits_clean,
            "worker_errors": self.worker_errors,
            "failovers": self.failovers,
            "replica_stale_reads": self.replica_stale_reads,
            "reconnects": self.reconnects,
            "shard_restarts": self.restarts,
            "promotions": self.promotions,
            "primary_kills": self.primary_kills,
            "duration_s": round(self.duration_s, 3),
        }


def _chaos_loop(topology, stop, period=1.0, partition_s=0.4, kill_replica=True):
    """The seeded chaos cycle: storm -> partition a shard -> restart a
    shard -> (once) kill a replica, round-robin over shards until the
    workers finish.  Deterministic ORDER; wall-clock timing is whatever
    the run's load makes it."""
    cycle = 0
    killed = False
    while not stop.wait(period):
        action = cycle % 3
        shard_index = cycle % len(topology.shards)
        try:
            if action == 0:
                topology.drop_all()
            elif action == 1:
                topology.partition(shard_index, partition_s)
            else:
                topology.shards[shard_index].restart_primary()
                if kill_replica and not killed and topology.shards and (
                    topology.shards[0].replica_servers
                ):
                    # Once per run: lose a replica outright, so the read
                    # path's failover-to-primary leg provably fires.
                    topology.shards[0].kill_replica(0)
                    killed = True
        except Exception:  # pragma: no cover - chaos must not kill the run
            log.exception("chaos action %d failed", action)
        cycle += 1


def drive_soak(
    topology,
    n_workers=1000,
    n_experiments=24,
    trials_per_worker=3,
    n_routers=32,
    retry=None,
    chaos=True,
    chaos_period=1.0,
    deadline=600.0,
    mid_hook=None,
):
    """Drive ``n_workers`` simulated workers against ``topology``.

    Workers are threads sharing ``n_routers`` router-backed storages (real
    worker fleets share nothing; a router per thread would need
    ``n_workers x n_shards`` sockets, so groups of workers share one the
    way threads inside one worker process share its storage).  Each worker
    registers its own UNIQUE trials on its assigned experiment, reserves
    whatever is pending, and completes what it reserved, riding the
    unified retry policy through whatever the chaos controller is doing.
    A convergence sweep then completes any trial a mid-chaos worker
    abandoned, and the invariant audit runs through the router AND on
    every shard directly.

    ``chaos=True`` runs the periodic controller (storms, partitions,
    restarts on a cycle — the long-soak shape); ``mid_hook`` instead (or
    additionally) runs ONE scripted chaos action at a deterministic
    point: every worker rendezvouses at its halfway trial and exactly one
    thread executes the hook (e.g. a shard restart) while the rest hold —
    in-flight state guaranteed, no timing luck.  Short tier-1 runs use
    ``mid_hook``; wall-clock soaks use the periodic controller.
    """
    from orion_tpu_torch.core.experiment import experiment_id

    stop_at = time.monotonic() + deadline
    t0 = time.monotonic()
    result = SoakResult()
    retry = dict(SOAK_RETRY) if retry is None else retry
    storages = [
        DocumentStorage(topology.make_router(), retry=retry)
        for _ in range(min(n_routers, n_workers))
    ]

    # --- experiments ---------------------------------------------------------
    exp_ids = []
    names = soak_experiment_names(
        storages[0].db, n_experiments, len(topology.shards)
    )
    for e, name in enumerate(names):
        config = {
            "_id": experiment_id(name, 1, "soak"),
            "name": name,
            "version": 1,
            "metadata": {"user": "soak"},
            "max_trials": float("inf"),
        }
        try:
            storages[e % len(storages)].create_experiment(config)
        except DuplicateKeyError:
            pass  # re-run against a persisted topology
        exp_ids.append(config["_id"])

    def check_deadline():
        if time.monotonic() >= stop_at:
            raise TimeoutError(f"soak failed to converge within {deadline}s")

    # --- workers -------------------------------------------------------------
    errors_lock = threading.Lock()
    barrier = None
    if mid_hook is not None:
        # A hook declaring a parameter receives the live router-backed
        # storages — the rebalance-mid-soak leg retargets their topology
        # in place while every worker holds at the barrier.
        import inspect

        try:
            hook_params = list(inspect.signature(mid_hook).parameters)
        except (TypeError, ValueError):  # pragma: no cover - builtins
            hook_params = []

        def hook_action():
            try:
                if hook_params:
                    mid_hook(storages)
                else:
                    mid_hook()
            except Exception:  # pragma: no cover - chaos must not kill the run
                log.exception("mid-run chaos hook failed")

        barrier = threading.Barrier(n_workers, action=hook_action)

    def worker(w):
        storage = storages[w % len(storages)]
        exp_id = exp_ids[w % len(exp_ids)]
        half = max(1, trials_per_worker // 2)
        for i in range(trials_per_worker):
            if barrier is not None and i == half:
                try:
                    barrier.wait(timeout=max(1.0, deadline / 2))
                except threading.BrokenBarrierError:
                    pass  # a worker died/timed out; the rest proceed
            # Unique parameter point per (worker, slot): trial ids are
            # md5(experiment, params), so registration is convergent under
            # resends and the zero-lost-observations count is exact.
            value = (w * trials_per_worker + i + 1) / (
                n_workers * trials_per_worker + 2
            )
            trial = Trial(experiment=exp_id, params={"/x": value})
            while True:
                if time.monotonic() >= stop_at:
                    return
                try:
                    try:
                        storage.register_trial(trial)
                    except DuplicateKeyError:
                        pass  # an earlier (reply-lost) attempt applied
                    claimed = storage.reserve_trials(exp_id, 1)
                    for got in claimed:
                        storage.update_completed_trial(
                            got,
                            [Result("obj", "objective", float(got.params["/x"]))],
                        )
                    # The status poll every real worker loop runs (the
                    # is_done check) — THE hot read the replica tier
                    # exists to serve, and what exercises staleness
                    # failover under chaos.
                    storage.count_completed_trials(exp_id)
                    break
                except Exception as exc:
                    if not is_transient(exc):
                        raise
                    with errors_lock:
                        result.worker_errors += 1
                    time.sleep(0.02)

    chaos_stop = threading.Event()
    chaos_thread = None
    if chaos:
        chaos_thread = threading.Thread(
            target=_chaos_loop,
            args=(topology, chaos_stop),
            kwargs={"period": chaos_period},
            daemon=True,
        )
        chaos_thread.start()
    threads = [
        threading.Thread(target=worker, args=(w,), daemon=True)
        for w in range(n_workers)
    ]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join(max(0.0, stop_at - time.monotonic()) + 5.0)
    chaos_stop.set()
    if chaos_thread is not None:
        chaos_thread.join(timeout=10.0)
    check_deadline()

    # --- convergence sweep ---------------------------------------------------
    # Complete anything a mid-chaos worker abandoned (reserved when its
    # thread hit the deadline, or registered but never claimed).  This is
    # the production lost-trial story: reservations are recoverable state,
    # never lost data.  The sweep AND the verification below read with
    # replica_reads OFF: replicas promise per-router read-your-writes, not
    # fleet-wide freshness — a replica caught up to THIS router's writes
    # can still trail another router's, and verification wants the
    # authoritative answer, not an eventually-consistent one.
    sweep_router = topology.make_router(replica_reads=False)
    # A permanently killed primary is likely already healed by the worker
    # routers' elections, but THIS fresh router still dials the dead
    # address: poke each killed shard until its failure detector adopts
    # the promoted replica — BEFORE DocumentStorage's index setup fans
    # out to every shard.
    for position, deployment in enumerate(topology.shards):
        if not deployment.killed:
            continue
        poke_deadline = time.monotonic() + 15.0
        while time.monotonic() < poke_deadline:
            check_deadline()
            try:
                sweep_router._shard_read(
                    sweep_router._shards[position], "count", "experiments"
                )
                break
            except Exception:
                time.sleep(0.1)
    sweep_storage = DocumentStorage(sweep_router, retry=retry)
    storages.append(sweep_storage)
    for exp_id in exp_ids:
        while True:
            check_deadline()
            try:
                pending = sweep_storage.fetch_noncompleted_trials(exp_id)
                if not pending:
                    break
                for trial in pending:
                    try:
                        sweep_storage.update_completed_trial(
                            trial,
                            [Result("obj", "objective", float(trial.params["/x"]))],
                        )
                    except Exception as exc:
                        if not is_transient(exc):
                            raise
            except Exception as exc:
                if not is_transient(exc):
                    raise
                time.sleep(0.05)

    # --- settle + verify -----------------------------------------------------
    router = sweep_storage.db
    expected = n_workers * trials_per_worker
    result.registered = expected
    # Through the router (replica reads allowed; staleness failover keeps
    # the answer fresh).
    result.completed = sum(
        sweep_storage.count_completed_trials(exp_id) for exp_id in exp_ids
    )
    result.router_reports = audit_storage(sweep_storage, lost_timeout=3600.0)
    # Directly on every shard: the router view must be the sum of its
    # parts, and every shard must audit clean ON ITS OWN.
    for index, conn in router.shard_connections():
        direct = DocumentStorage(conn, retry=retry)
        result.shard_reports[index] = audit_storage(direct, lost_timeout=3600.0)
        result.completed_per_shard[index] = sum(
            direct.count_completed_trials(r.experiment_id)
            for r in result.shard_reports[index]
        )
    # Health counters summed over EVERY router the workers used (each
    # tracks its own shards' connections).
    result.failovers = sum(s.db.failovers for s in storages)
    result.replica_stale_reads = sum(s.db.replica_stale_reads for s in storages)
    result.reconnects = sum(s.db.reconnects for s in storages)
    result.restarts = sum(s.restarts for s in topology.shards)
    result.promotions = sum(s.db.promotions for s in storages)
    result.primary_kills = sum(1 for s in topology.shards if s.killed)
    result.duration_s = time.monotonic() - t0
    for storage in storages:
        storage.db.close()
    return result
