"""Layered configuration resolution (port of ``orion_tpu/config.py``: the same
defaults, layers and precedence, so both packages resolve one command line
to one config).

Capability parity: reference `src/orion/core/io/resolve_config.py` +
`io/config.py` — precedence **defaults < environment < config file < command
line**, with the worker knobs (`heartbeat`, `max_broken`, `max_idle_time`)
and storage selection (`ORION_DB_TYPE` / `ORION_DB_ADDRESS` env overrides)
of the reference's global Configuration object.

``telemetry``, ``metrics_port`` and ``doctor_interval`` resolve as in the
reference (the CLI layers them onto the process, ``cli/base.py``).
"""

import os

import yaml


def user_config_path():
    """``~/.config/orion_tpu/config.yaml`` (XDG_CONFIG_HOME honored)."""
    base = os.environ.get(
        "XDG_CONFIG_HOME", os.path.join(os.path.expanduser("~"), ".config")
    )
    return os.path.join(base, "orion_tpu", "config.yaml")


def normalize_sections(cfg):
    """Accept sectioned config-file spellings alongside the canonical
    top-level keys, instead of silently ignoring them (a config whose
    `algorithms:` sits under an `experiment:` section otherwise runs
    RANDOM search without a word).  Applied to EVERY file layer — the
    user-level config.yaml is exactly where reference users keep their
    `database:` section:

    - ``experiment:`` — everything inside is hoisted to top level;
      explicit top-level keys win (shallow: the top-level value replaces
      the sectioned one whole);
    - ``producer: strategy:`` — the reference's spelling for the parallel
      strategy (`tests/functional/algos/asha_config.yaml` layout);
    - ``database:`` — the reference's storage section; create_storage
      already understands the reference's type aliases (pickleddb,
      ephemeraldb)."""
    cfg = dict(cfg)
    nested = cfg.pop("experiment", None)
    if isinstance(nested, dict):
        cfg = {**nested, **cfg}
    producer = cfg.pop("producer", None)
    if isinstance(producer, dict) and "strategy" in producer:
        cfg.setdefault("strategy", producer["strategy"])
    database = cfg.pop("database", None)
    if isinstance(database, dict):
        cfg.setdefault("storage", database)
    return cfg


def _user_file_config():
    path = user_config_path()
    if not os.path.exists(path):
        return {}
    try:
        with open(path) as handle:
            return normalize_sections(yaml.safe_load(handle) or {})
    except Exception:  # pragma: no cover - malformed user config
        return {}


DEFAULTS = {
    "name": None,
    "version": None,
    # Per-experiment knobs default to None here: a value present at resolve
    # time is indistinguishable from a user choice and would override the
    # stored experiment's own settings on resume.  Creation-time defaults
    # live in Experiment.__init__ (max_trials=inf, max_broken=3, pool_size=1).
    "max_trials": None,
    "max_broken": None,
    "pool_size": None,
    "worker_trials": None,
    "working_dir": None,
    # algorithms/strategy defaults are applied at experiment CREATION inside
    # build_experiment, not here: a default injected at resolve time would be
    # indistinguishable from a user choice, and resuming a tpe experiment
    # without a config file would wrongly branch it back to random.
    "algorithms": None,
    "strategy": None,
    "heartbeat": 120.0,
    "max_idle_time": 60.0,
    # Producer speculative-pipeline depth: how many rounds the producer
    # keeps in flight on the device while host work (storage commit,
    # codec) runs underneath.  None = unset (the ORION_TPU_PIPELINE_DEPTH env var,
    # then the depth-1 pre-ring default, apply).  Worker-level knob, never
    # stored experiment identity.
    "pipeline_depth": None,
    "user_script_config": "config",
    # storage.retry holds the unified retry-policy knobs (max_attempts,
    # base_delay, max_delay, multiplier, jitter, deadline — the
    # RetryPolicy defaults apply for any omitted key; docs/robustness.md);
    # `retry: false` disables storage-level retries entirely.
    # A network storage section may also carry the sharded-topology stanza
    # (docs/multi_node.md): `shards:` — a list of "host:port" strings or
    # {address|host/port, replicas: [...]} dicts (consistent-hash routing
    # on experiment id, read-replica fan-out) — plus the router knobs
    # `vnodes`, `replica_reads`, `shard_retry`, `reconnect_jitter`.  The
    # ORION_DB_SHARDS env var carries the replica-less spelling, and
    # ORION_DB_SECRET_FILE / ORION_DB_SECRET the shared secret.
    # storage.quorum is the SERVER-side replication-ack floor (`db serve
    # --quorum N`): synchronous collections (experiments/trials/placement)
    # acknowledge a write only after N replicas confirmed it;
    # telemetry/health stay async.
    "storage": {"type": "pickled", "path": "orion_tpu_db.pkl", "retry": {}},
    # Framework telemetry (orion_tpu_torch.telemetry): None = leave the
    # ORION_TPU_TELEMETRY env decision alone; true/false switches the
    # registry and the flight recorder together (cli/base.py).
    "telemetry": None,
    # Worker /metrics + /healthz port (orion_tpu_torch.metrics); None = no
    # server.  Resolved to ORION_TPU_METRICS_PORT so that `hunt
    # --n-workers` children inherit it.
    "metrics_port": None,
    # Self-diagnosis watchdog (orion_tpu_torch.diagnosis): a positive
    # number of seconds makes every workon loop run the doctor rule
    # catalog at that interval, publishing findings as flight.alert events
    # + doctor.findings.* gauges; None = no watchdog.  Resolved to
    # ORION_TPU_DOCTOR_INTERVAL so that `hunt --n-workers` children
    # inherit it.
    "doctor_interval": None,
    # Suggest gateway (orion_tpu_torch.serve): a worker-level knob, never
    # part of the stored experiment identity.  None = local algorithm
    # instance (the default); {"address": "host:port", optional "retry":
    # {...}, "quotas": {"max_inflight": n, "max_q": n}, "timeout": s} =
    # drive this experiment's suggest/observe through the shared gateway
    # (the ORION_SERVE_ADDRESS env var sets the address alone).  A fleet is
    # the same section with "addresses": [host:port, ...] (env:
    # ORION_SERVE_ADDRESSES, comma-separated): tenants are placed on
    # members by consistent hash.
    "serve": None,
}


def _env_config():
    out = {}
    storage = {}
    db_type = os.getenv("ORION_DB_TYPE")
    if db_type:
        storage["type"] = db_type
    shards = os.getenv("ORION_DB_SHARDS")
    if shards:
        # Sharded control plane (storage/shard.py): a comma-separated list
        # of primary host:port addresses; per-shard replicas need the
        # config-file `shards:` stanza (see docs/multi_node.md).
        storage.setdefault("type", "network")
        storage["shards"] = [s.strip() for s in shards.split(",") if s.strip()]
    address = os.getenv("ORION_DB_ADDRESS")
    if address:
        if db_type in ("network", "netdb"):
            # Parse host[:port] here so the normal merge precedence applies —
            # a path-fallback downstream would lose to host/port keys merged
            # in from the user config file.
            host, _, port = address.partition(":")
            storage["host"] = host
            if port:
                storage["port"] = int(port)
        else:
            storage["path"] = address
    if storage:
        out["storage"] = storage
    serve_address = os.getenv("ORION_SERVE_ADDRESS")
    if serve_address:
        out["serve"] = {"address": serve_address}
    serve_addresses = os.getenv("ORION_SERVE_ADDRESSES")
    if serve_addresses:
        # Fleet membership: comma-separated member list.  Wins over the
        # single-address spelling when both are set (the list is the more
        # specific deployment statement).
        out.setdefault("serve", {})["addresses"] = [
            s.strip() for s in serve_addresses.split(",") if s.strip()
        ]
    # Explicit coercions — the DEFAULTS values are None, so their type can't
    # be used to coerce, and a string max_trials would poison comparisons.
    for key, cast in (("max_trials", float), ("pool_size", int), ("max_broken", int)):
        env = os.getenv(f"ORION_{key.upper()}")
        if env:
            out[key] = cast(env)
    return out


def merge_configs(*configs):
    """Deep merge, later wins; None values never override (reference
    `resolve_config.py:195-246`)."""
    out = {}
    for config in configs:
        for key, value in (config or {}).items():
            if value is None:
                continue
            if isinstance(value, dict) and isinstance(out.get(key), dict):
                out[key] = merge_configs(out[key], value)
            else:
                out[key] = value
    return out


def resolve_config(file_config=None, cmd_config=None, storage_override=None):
    """defaults < user config file < env < -c config file < cmdline."""
    config = merge_configs(
        DEFAULTS,
        _user_file_config(),
        _env_config(),
        normalize_sections(file_config or {}),
        cmd_config,
    )
    if storage_override:
        config["storage"] = storage_override
    return config
