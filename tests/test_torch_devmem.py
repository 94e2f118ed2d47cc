"""The device-memory sampler (``orion_tpu_torch/devmem.py``), the history
registries it reads, the build cache (``utils/jit_cache.py``), the host
budget (``hostbudget.py``) and ``utils/flatten.py``, each against its
``orion_tpu`` twin where one exists.

The allocator statistics of a card are injected through
``devmem.device_stats``: on the CPU the sampler publishes no device gauge,
as the reference publishes none for a backend without ``memory_stats``."""

import copy
import os

import numpy as np
import pytest
from torch_parity import isolated_telemetry

from orion_tpu import hostbudget as ref_hostbudget
from orion_tpu.utils import flatten as ref_flatten
from orion_tpu.utils import unflatten as ref_unflatten
from orion_tpu_torch import devmem, hostbudget
from orion_tpu_torch.algo.history import DeviceHistory, HostHistory, history_memory_stats
from orion_tpu_torch.ops import _build
from orion_tpu_torch.utils import flatten, unflatten
from orion_tpu_torch.utils.jit_cache import enable_persistent_compilation_cache

STATS = {
    0: {"allocated_bytes.all.current": 1_000, "active.all.current": 3,
        "reserved_bytes.all.current": 4_096, "allocated_bytes.all.peak": 2_000},
    1: {"allocated_bytes.all.current": 500, "active.all.current": 1,
        "reserved_bytes.all.current": 2_048, "allocated_bytes.all.peak": 700},
}


@pytest.fixture
def telemetry():
    from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY

    with isolated_telemetry() as owners:
        yield owners[0]
    COMPILE_REGISTRY.reset()


def test_sampler_is_a_noop_with_telemetry_off():
    with isolated_telemetry(enabled=False) as (telemetry, *_):
        assert devmem.sample_memory(force=True) is False
        assert telemetry.snapshot()["gauges"] == {}


def test_sampler_publishes_the_allocator_gauges(telemetry, monkeypatch):
    monkeypatch.setattr(devmem, "device_stats", lambda: STATS)
    hist = DeviceHistory(3, device="cpu")
    hist.append(np.ones((5, 3), np.float32), np.ones(5, np.float32))
    assert devmem.sample_memory(force=True) is True
    gauge = telemetry.gauge_value
    assert gauge("memory.device_live_bytes") == 1_500
    assert gauge("memory.device_live_arrays") == 4
    assert gauge("memory.device_bytes_in_use") == 6_144
    assert gauge("memory.device_peak_bytes") == 2_700
    assert gauge("memory.device_live_bytes.d0") == 1_000
    assert gauge("memory.device_live_bytes.d1") == 500
    assert gauge("memory.history_device_bytes.b64") >= 64 * 5 * 4
    assert gauge("memory.fused_cache_entries") is not None
    assert gauge("memory.prewarm_started") is not None
    # A card that held bytes once and holds none now reads 0.
    monkeypatch.setattr(devmem, "device_stats", lambda: {0: STATS[0]})
    devmem.sample_memory(force=True)
    assert gauge("memory.device_live_bytes.d1") == 0


def test_without_a_card_no_device_gauge_is_published(telemetry):
    assert devmem.device_stats() == {}
    devmem.sample_memory(force=True)
    gauges = telemetry.snapshot()["gauges"]
    assert not [name for name in gauges if name.startswith("memory.device_")]
    assert "memory.history_count" in gauges


def test_sampler_rate_limit_and_force(telemetry, monkeypatch):
    monkeypatch.setattr(devmem, "_last_sample", 0.0)
    assert devmem.sample_memory() is True
    assert devmem.sample_memory() is False  # inside SAMPLE_INTERVAL
    assert devmem.sample_memory(force=True) is True


def test_outgrown_bucket_gauges_are_zeroed(telemetry):
    hist = DeviceHistory(2, device="cpu")
    hist.append(np.ones((10, 2), np.float32), np.ones(10, np.float32))
    devmem.sample_memory(force=True)
    assert telemetry.gauge_value("memory.history_device_bytes.b64") > 0
    hist.append(np.ones((100, 2), np.float32), np.ones(100, np.float32))
    others = [h for h in _live_histories() if h.cap == 64]
    devmem.sample_memory(force=True)
    if not others:
        assert telemetry.gauge_value("memory.history_device_bytes.b64") == 0
    assert telemetry.gauge_value("memory.history_device_bytes.b128") > 0


def _live_histories():
    from orion_tpu_torch.algo import history

    with history._registry_lock:
        return list(history._device_histories)


def test_history_stats_count_a_clone_once():
    before = history_memory_stats()
    hist = DeviceHistory(4, device="cpu")
    hist.append(np.ones((3, 4), np.float32), np.ones(3, np.float32))
    host = HostHistory(4)
    host.append(np.ones((3, 4), np.float32), np.ones(3, np.float32))
    clone, host_clone = copy.deepcopy(hist), copy.deepcopy(host)
    after = history_memory_stats()
    assert after["device_count"] == before["device_count"] + 1
    assert after["device_bytes"] - before["device_bytes"] == 64 * (4 + 1 + 1) * 4
    assert after["host_bytes"] - before["host_bytes"] == 64 * 4 * 4 + 64 * 4
    del clone, host_clone


def test_producer_flush_samples_memory_and_stamps_health(telemetry, monkeypatch):
    """The producer's metrics flush publishes the gauges, and the health
    record carries the ``mem_bytes`` stamp, as in the reference."""
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.storage.base import create_storage

    monkeypatch.setattr(devmem, "device_stats", lambda: STATS)
    # The flush's sample is rate-limited; one forced sample publishes the
    # gauge the health records stamp.
    devmem.sample_memory(force=True)
    storage = create_storage({"type": "memory"})
    exp = build_experiment(storage, "mem", priors={"x": "uniform(0, 1)"}, max_trials=16,
                           algorithms={"tpu_bo": {"n_init": 4, "n_candidates": 64,
                                                  "fit_steps": 2}})
    client = ExperimentClient(exp.instantiate(seed=0, device="cpu"))
    for _ in range(3):
        trials = client.suggest(4)
        client.observe_all(trials, [float(t.params["x"]) for t in trials])
    client.producer._flush_timings(force_metrics=True)
    health = storage.fetch_health(client.experiment)
    assert health and health[-1]["mem_bytes"] == 1_500.0
    [metrics] = storage.fetch_metrics(client.experiment)
    assert metrics["gauges"]["memory.device_live_bytes"] == 1_500


def test_metrics_scrape_refreshes_the_memory_gauges(telemetry, monkeypatch):
    from orion_tpu_torch.metrics import MetricsServer

    monkeypatch.setattr(devmem, "device_stats", lambda: STATS)
    server = MetricsServer(port=0)
    server.start()
    port = server.port
    try:
        import urllib.request

        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as reply:
            body = reply.read().decode()
    finally:
        server.stop()
    assert "orion_tpu_memory_device_live_bytes 1500" in body


# --- the build cache, the host budget and flatten ----------------------------


def test_build_cache_reports_the_kernel_build_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "default"))
    monkeypatch.delenv("ORION_TPU_JIT_CACHE", raising=False)
    assert enable_persistent_compilation_cache() == str(tmp_path / "default")
    assert os.path.isdir(tmp_path / "default")
    monkeypatch.setenv("ORION_TPU_JIT_CACHE", "1")
    assert enable_persistent_compilation_cache() == str(tmp_path / "default")


def test_build_cache_off_switch_and_custom_dir(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path / "default"))
    monkeypatch.setenv("ORION_TPU_JIT_CACHE", "off")
    assert enable_persistent_compilation_cache() is None
    custom = str(tmp_path / "cache")
    monkeypatch.setenv("ORION_TPU_JIT_CACHE", custom)
    assert enable_persistent_compilation_cache() == os.path.join(custom, "orion_tpu_torch")
    assert _build.library_path("gram").startswith(os.path.join(custom, "orion_tpu_torch"))


@pytest.mark.parametrize("raw", [None, "2.0", "0.5", "garbage", " 3 "])
def test_host_budget_matches_the_reference(monkeypatch, raw):
    if raw is None:
        monkeypatch.delenv(hostbudget.ENV_VAR, raising=False)
    else:
        monkeypatch.setenv(hostbudget.ENV_VAR, raw)
    assert hostbudget.ENV_VAR == ref_hostbudget.ENV_VAR
    assert hostbudget.host_budget_factor() == ref_hostbudget.host_budget_factor()
    assert hostbudget.round_budget_factor() == ref_hostbudget.round_budget_factor()


NESTED = [
    {},
    {"a": 1},
    {"a": {"b": {"c": 2}, "d": [1, 2]}, "e": None},
    {"x": {}, "y": {"z": {"w": "v"}}, "p.q": 3},
    {"space": {"lr": "loguniform(1e-5, 1)", "opt": {"momentum": "uniform(0, 1)"}}},
]


@pytest.mark.parametrize("nested", NESTED)
def test_flatten_matches_the_reference(nested):
    flat = flatten(nested)
    assert flat == ref_flatten(nested)
    assert unflatten(flat) == ref_unflatten(flat)
    assert flatten(nested, prefix="root.") == ref_flatten(nested, prefix="root.")
