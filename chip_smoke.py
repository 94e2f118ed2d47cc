#!/usr/bin/env python3
"""Drive the PyTorch port (``orion_tpu_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--fleet-off-first]

Phases, one JSON line each (any failure raises and the script exits
non-zero; nothing is caught and passed over):

1. ``device``: the card, its power limit, torch/CUDA and nvcc versions.
2. ``build``: every CUDA source of the port compiled by nvcc for sm_90a,
   all at once (one nvcc per source), with ptxas' register report.
3. kernel checks: each kernel against its plain PyTorch version on the card
   at the main path's shape and the others of ``CASES`` (fails above
   1e-5 * max(1, amplitude)), with CUDA-event times, the card's bound, the
   achieved bytes/s and share of that bound, and ``fill_ms``: one
   ``fill_`` of an output of the same size, the card's practical floor for
   writing that many bytes in one launch (a yardstick only).
4. ``main_path``: the headline round through the public API, at full width
   -- Hartmann6, 130 observed, ``tpu_bo`` with 16384 candidates, 40 fit
   steps, local_frac 0.3, trust region, RFF-Thompson, Matern-5/2, copula --
   the signature's first ``suggest(1024)`` (an eager warm-up round, the
   CUDA-graph capture and its instantiation; reported apart with the
   capture's ms and graph nodes), then 5 rounds of observe-16 +
   ``suggest(1024)``, each a replay of that graph, with every kernel's
   launch count zeroed just before and read just after.
5. ``profile``: two more rounds under ``torch.profiler``: one eager
   (``_suggest_step`` called directly), whose ``suggest.*`` spans give each
   stage's host and device ms, and one replayed, whose trace gives the
   round's device busy time and idle share as the main path runs it;
   launches and the top ops of each.
6. ``regret``: the regret gate's scenario (``BENCH_REGRET_BASELINE.json``)
   through the port, seeds 0-4, judged by the port's copy of the gate.
7. ``algorithms``: every other algorithm of the registry on the card, each
   at its benchmark preset (``algo_runs()``, read from the port's
   ``benchmarks.runner.PRESETS``), in a plain loop of
   ``suggest(batch)``, host evaluation and ``observe`` until the trial
   budget or ``is_done``; one JSON line per run with its trials, rounds,
   wall time, median suggest ms, suggestions/s and final simple regret
   (beside the reference's median regret where ``BENCH_SEEDS.json`` has the
   preset).  It checks that every row decodes inside the space, that no
   round repeats a point, that ``asha_bo`` on Ackley-50D launched
   ``fused_gram`` on its chunked path (8192 x 512 x 51), and that each
   ``asha_bo`` seed ends below regret 20.0; one ``asha_bo`` round eager and
   one replayed are profiled as in 5.
8. ``hunt``: the library entry point, ``optimize()``, through the producer
   and storage at the main path's full width -- Hartmann6, ``tpu_bo`` as in
   4., q=1024, 4 rounds (one random, three GP) -- once on ``pickled`` storage
   and once on ``memory``, each a JSON line with the per-round median ms of
   the producer's suggest, register and observe, of its sync with storage,
   reserve, ``batch_eval`` and completion, the round, suggestions/s and the
   final regret, beside the plain loop's round of 4.; ``fused_gram`` zeroed
   before each run and launched at least once per GP round (at 16384 x 256
   x 6).  Then two worker processes run ``ExperimentClient`` loops at
   q=1024 on one ``pickled`` file, 6144 trials, each keeping one batch in
   evaluation while it asks for the next, so that from the third round on
   each producer lies about the batches in flight: no trial reserved
   twice, each completed once, ids unique.  Last the regret gate's
   scenario through ``optimize()``, judged by the port's gate.
9. ``cli``: ``orion-tpu-torch hunt`` over a pure-Python Hartmann6 user
   script (one subprocess a trial) with the main path's ``tpu_bo``.  First
   one worker in this process on SQLite, ``--pool-size 1024``, 32 trials
   past a history of 1024 completed through the library (its first round a
   GP round), the kernel's launch shapes counted over the call (a launch at
   16384 x 256 x 6), with each trial's subprocess, reservation, completion
   and status reads timed.  Then ``--n-workers 8 --profile`` as a subprocess on a
   fresh SQLite file, 1088 trials: no trial run twice (the script logs
   each execution), lies registered, the kernel counted in the workers'
   profiler traces, with each worker's device busy time and idle share.
   Last the regret gate's scenario through the CLI on ``pickled``, the
   five seeds at once, judged by the port's gate.  Every objective the
   script reported must equal the port's Hartmann6 on the card.
10. ``evc``: experiment version control through the CLI on the ``cli``
   phase's one-worker store.  ``hunt -n cli`` again with ``x0 ~ uniform(0,
   0.5)`` branches version 2 (a prior change), then with ``x1`` narrowed as
   well version 3; each runs 32 trials of its own at ``--pool-size 1024``.
   Each child's producer fetches its ancestors' trials through the EVC
   tree, adapted hop by hop, so its first round is a GP round (a
   ``fused_gram`` launch at 16384 x 256 x 6).  Checks the ``refers`` chain,
   the adapted trial counts against the stored params, each child's rows
   inside its prior and their objectives, ``audit --all`` clean and the tree
   ``list`` prints; reports the tree fetch, suggest and GP round ms,
   trials/s and the audit ms.  Then a NaN and an infinite objective through
   the port's ``SQLiteDB`` on this host's SQLite.
11. ``telemetry``: the telemetry plane (``telemetry.py``, ``metrics.py``,
   ``tracing.py``, the flight recorder of ``health.py``).  (a) The main
   path's ``tpu_bo`` (130 observed, q=1024) for 6 rounds with
   ``TELEMETRY``/``FLIGHT`` off and 6 on, alternating, each pair drawn from
   one copy of the algorithm: their rows must be equal; the median round ms
   of each and their ratio, the ``suggest_step.dispatch`` spans.  (b)
   ``orion-tpu-torch hunt --n-workers 4 --profile`` on a SQLite file
   seeded through the library with 256 completed trials and 384 pending
   (a random round partly run: the workers run them out, then each pays
   its own GP round), 16 trials past them (the ``cli`` phase's script and
   unseeded ``tpu_bo``, ``--pool-size 1024``), twice: with ``telemetry:
   false``, and with
   ``telemetry: true`` and a free ``metrics_port``, on first unless
   ``--fleet-off-first`` is given.  While the telemetry run goes,
   ``/metrics`` (Prometheus text, a growing ``storage_sqlite_txn``
   histogram) and ``/healthz`` are scraped; then ``metrics`` (four
   snapshots merged, completions equal to the trials the workers ran),
   ``trace`` (a
   Chrome trace with ``producer.round`` on four tracks, storage spans
   parented inside them, ``suggest_step.dispatch``), ``trace --attribute``
   and ``flight-record``.  In each run the kernel's launches and their
   (m, n, d) are read from the workers' profiler traces (the wrapper's
   ``fused_gram MxNxD`` range around each launch): at least one at 16384 x
   256 x 6.  Trials/s of both runs, beside the ``cli`` phase's eight
   workers.  (c) A single-worker hunt with telemetry
   on, interrupted by SIGINT: its crash dump holds ``producer.round``
   events; ``audit --flight-out`` on a copy of (b)'s store with one
   violation planted exits 1 and dumps an ``audit.violation`` event.
12. ``network``: networked and sharded storage through ``orion-tpu-torch db
   serve`` processes (host processes: each is checked to hold no
   ``/dev/nvidia*`` file and not to add to ``nvidia-smi``'s compute apps),
   the ``cli`` phase's script and unseeded ``tpu_bo`` at ``--pool-size
   1024``, traced with ``--profile``, ``telemetry: true``.  (a) One server
   with ``--persist`` SQLite and ``--secret-file``; ``hunt --n-workers 4``
   through ``ORION_DB_TYPE=network``, ``ORION_DB_ADDRESS`` and
   ``ORION_DB_SECRET_FILE``, 64 trials past a history of 256 completed
   through the library (so that the workers' first rounds are GP rounds):
   completed equal to the distinct executions (none twice), every
   completion read back from the server and, after its clean shutdown,
   from its SQLite file; ``audit``, ``trace --distributed`` holding the
   server's ``netdb.apply`` spans; trials/s beside the ``telemetry``
   fleet's four workers on SQLite.  (b) Two
   primaries, each replicating to one replica with ``--quorum 1``, a
   ``shards:`` stanza; two experiments the ring places on different
   shards (checked against ``db ring``), hunted at once by two workers
   each, 64 trials each past a history of 256: every completion on the
   shard's primary and on
   its replica once their seqs are equal; ``db status --json`` (primaries,
   quorum 1, lag 0), ``audit --all`` with the topology line, ``metrics``
   with the router's ``storage.shard.*`` counters.  (c) ``db dump`` of one
   experiment's shard primary, ``db load`` into a fresh SQLite file (its
   trial documents equal to the primary's), ``db copy``, ``db
   migrate-ids`` on the copy and a clean ``audit``, ``info``.  Each
   experiment's workers launch the kernel at 16384 x 256 x 6 (their
   traces).
13. ``day2``: the day-2 storage operations on (b)'s plane, restarted from
   its SQLite files (the primaries on their ports, so the ring is the
   same), with three experiments of 256 completed trials and none pending
   (a resumed worker's first round is then a GP round; (b)'s experiments
   keep about a round of registered trials nobody ran) and four with a few.
   Every server and admin command (``db ring``, ``rebalance``, ``drain``,
   ``backup``, ``restore``) is a host process, checked as in 12.; each
   admin command's migrator steps are timed by wrapping them.  (a) A third
   primary with one replica on a port the grown ring moves a third of the
   experiments for (none of (b)'s two): ``db ring --diff`` lists
   the ring's moves, ``db rebalance`` moves them, each moved trial
   document equal on the destination, the source copy and the override
   gone, ``audit --all`` clean; the moved 256-trial experiment resumed for
   one GP round.  (b) Two workers hunt a 256-trial experiment on the old
   stanza while ``db drain``, started with them, empties its shard (which
   holds one of (b)'s experiments too).  The drain's first copy waits
   until the store shows the workers' first GP round registered, and the
   workers' trials wait (the user script polls a file) until the drain has
   fenced the experiment, so on a host of any speed their GP rounds
   register during the drain and they complete trials after the flip (the
   ``moved`` override routes them);
   the fence window, the placement states polled every 25 ms and the
   workers' ``storage.retries``; ``db drain --dry-run`` shows nothing
   resident; the survivor stanza rolled out, the drained shard's servers
   stopped, one worker resumes.  No observation lost: completions through
   the router equal those on the shards and the distinct executions, each
   on the destination's primary and replica; ``audit --all`` clean.  (c)
   ``db backup --out`` (each shard's ``seq`` and ``epoch`` in the
   manifest) and ``db restore --src`` onto three fresh primaries: counts
   equal to the manifest's, trial documents equal by id, auto-id rows by
   content, ``audit --all`` clean; the untouched 256-trial experiment
   resumed there for one GP round.  Each resumed GP round launches the
   kernel at 16384 x 256 x 6 (the workers' traces).
14. ``device_plane``: (a) the main path's round at q=1024 and ``asha_bo``'s
   at its preset, eager against replayed on the same plan (the same
   injected draws): rows, health and GP hypers bitwise equal, the ms of
   each; (b) a history crossing 128 -> 256 at the main path's width,
   without the prewarmer (q=64: one synchronous recapture, attributed
   ``fit_bucket 128→256``) and with it (q=32: none, and the prewarm's
   capture ms); (c) the shared graph pool's bytes after every signature
   this process captured, against 1.5x the largest of the three heaviest
   signatures' pools, each captured alone in a fresh pool; (d) a worker
   process writes a store with telemetry on (q=1024, speculative suggest),
   and ``profile --json``, ``top --json`` and ``info`` over it show the
   capture table, the worker's captures, memory and host/device ratio, the
   ratio line and the health records' ``mem_bytes``.
15. ``diagnosis``: the doctor and the runtime sanitizer at the main path's
   width (``tpu_bo``, 16384 candidates, q=1024).  (a) One ``hunt`` worker
   with ``doctor_interval: 2``, telemetry and a free ``metrics_port``, 32
   trials past a history of 256: while it runs ``/healthz`` carries a
   ``doctor`` block, ``/metrics`` the ``orion_tpu_doctor_findings`` family
   with declared severities only, and watchdog passes over its store are
   timed here; then ``doctor --json`` exits 0 with no critical finding,
   ``info`` prints a doctor line, ``top --json`` has a doctor block.  (b)
   ``tpu_bo`` through an ``ExperimentClient`` on SQLite in this process,
   telemetry on, each GP round at the next q bucket (8 ... 1024, again):
   every round pays a CUDA-graph capture the compiler plane books as a
   recapture, until DX001's bars hold (10 rounds, recaptures at least
   half of them): ``run_rules(local_snapshot())`` holds DX001 critical and
   ``doctor --json`` over the store exits 1 naming it; the recaptures'
   ms, and each entry's pool bytes and growth after them, the shared pool
   held to ``POOL_BOUND`` times its largest signature alone, and so is
   every graph pool of the process after a ``gc`` and ``empty_cache``
   (the captures come smallest first, the order that fragments a pool
   most; a capture over the bound is measured alone, and its own pool
   replaces the shared one when the shared one is still over).  (c) ``orion-tpu-torch tsan
   -- hunt --n-workers 2`` with telemetry, the watchdog and the prewarmer
   on, 32 trials past a history of 256: the merged report of every
   process (workers and user scripts) holds no race, no lock-order cycle
   and no LCK003 finding; the instrumented locks and annotated accesses
   counted; each GP round the store's spans book launched ``fused_gram``
   (the workers' traces).
16. ``serve``: the suggest gateway (``orion_tpu_torch.serve``) at the main
   path's width.  (a) One ``GatewayServer(device="cuda", max_width=8)`` in
   this process, eight ``tpu_bo`` tenants (the main path's config and
   130-point history, seeds 0-7) in threads, four barriered rounds of
   ``suggest(1024)`` and an observe of the rows' Hartmann6 values; then the
   same through a gateway of ``max_width=1``: every tenant's rows and
   GPState of every round bitwise equal, each coalesced round one dispatch
   of width 8 (eight standalone replays, ``fused_gram`` launched 8 times a
   round at 16384 x 256 x 6), suggestions/s of both gateways, the
   plan-prep cache's hit and miss cost, and the step graphs holding one
   signature, the standalone round's, with the pool no larger after the
   coalesced rounds than after the ones served alone; the process-wide
   pool before the phase reset the cache, and every graph pool of the
   process then, each held to ``POOL_BOUND`` times the main signature's
   pool alone, are printed beside it.  (b)
   ``orion-tpu-torch serve --persist`` as a subprocess on the card; two
   ``hunt`` workers of two experiments on one SQLite store with a
   ``serve:`` section, 16 trials each past a history of 256: trials/s, no
   ``/dev/nvidia*`` file in either worker and no compute app added while
   they run, ``info`` (one experiment and ``--all``: the serve fields and
   the fleet line) and ``top --json``'s serve fields, ``doctor`` exit 0
   with DX005, DX007 and DX008 silent.  (c) A tenant's round through that
   gateway, SIGINT and a restart from its ``--persist`` file on the same
   port: the next q=1024 round bitwise equal to a gateway never stopped.
17. ``lint``: the static analysis held against the card.  (a) ``run_lint``
   over ``orion_tpu_torch`` and this script with the capture rules
   (``JIT``) and ``PERF003``, in this process: zero findings, its rule
   count and ms.  (b) Every planted case of
   ``tests/fixtures/torch_lint/capture_cases.py`` (a host read, an index by
   a 0-d tensor, a branch on a tensor value, a Python number in a tensor
   slot, each beside a safe twin) linted and captured with
   ``torch.cuda.graph``: a case the lint flags must fail to capture
   (JIT001, JIT002) or replay a stale value (JIT003), a safe twin must
   capture and replay equal to its eager run on new inputs; one line a
   case with both verdicts.  (c) Under
   ``torch.cuda.set_sync_debug_mode("warn")``, first a planted ``.item()``,
   which must be recorded with its frame, then one eager
   ``_suggest_step`` at the main path's width (after one unobserved
   warm-up round): the Python frames of every sync, none inside a
   function the capture rules treat as captured; the syncs and any other
   warning counted.
18. ``mesh``: the multi-device mesh (``orion_tpu_torch.algo.sharding``)
   on 4 logical slots of the card, the main path's configuration.  (a) A
   1-slot mesh against no mesh, the capture round and a replay: rows, GP
   fit and health bitwise.  (b) 4 slots against no mesh, the capture round
   and 3 replays: rows and fit bitwise, health within rtol 1e-6;
   ``fused_gram`` launched 4 times a sharded round at 4096 x 256 x 6
   (zeroed just before the round, read just after), each slot's chunk of a
   pool held against the plain version; placement fractions of 0.25; eager
   and replayed ms of both arms beside the card's name and power limit.
   (c) ``asha_bo``, ``tpe`` and ``bohb`` at their presets on 4 slots
   against unsharded, in lockstep: equal suggestions each round, a round
   scored over the slots in each.  (d) Eight sharded ``tpu_bo`` tenants
   coalesced tenant-parallel (lane i on slot i % 4) against the same
   tenants served alone: rows and GPState bitwise.  (e) Doctor rule DX006
   silent on the sharded round's health and on the gateway's fields of
   (d), firing on the same record with its placement collapsed onto one
   slot.  Logical slots measure the code path, not a speed-up from more
   cards.
19. ``benchmarks``: the benchmark library (``orion_tpu_torch/benchmarks``)
   on the card.  (a) ``gram_bench.run_gram_bench`` at its 7 shapes, both
   kinds: the plain path (``kernel_matrix``) against ``fused_gram`` with
   CUDA-graph event times (the harness the kernel checks use), every row
   within 1e-5 * max(1, amplitude), each row's kernel ms, plain ms, speedup
   and share of the card's bound.  (b) ``suggest_bench.run_suggest_bench``
   at its 3 shapes, ``fused_gram``'s launches and their (m, n, d) counted
   over each: at least one a timed round at the shape's cross-gram; device,
   wall, host and public-API ms, FLOPs (a lower bound), the pool footprint,
   and ``hartmann6-q1024``'s device ms beside the main path's replayed
   round.  (c) ``runner.main`` over ``BENCH_PRESETS`` at their full
   budgets, each line's regret beside the reference's median from
   ``BENCH_SEEDS.json``; ``thompson-rosenbrock20`` launches ``fused_gram``.
   (d) ``host_profile.main`` on ``asha-ackley50`` at 512 trials: the result
   and a non-empty tottime table.
20. ``installed``: the port as a user installs it, outside this checkout.
   ``pyproject.toml``, ``README.md`` and ``orion_tpu_torch/`` are copied
   into a temporary directory and ``pip install --no-deps
   --no-build-isolation --target <tmp>/site``-ed, with the plugin fixture
   ``tests/fixtures/torch_gd_plugin`` beside them.  (1) In this process:
   ``ops/csrc/gram.cu`` shipped, and the installed ``_build`` (loaded by
   its path) builds it from a cold ``XDG_CACHE_HOME`` into that cache,
   the ``nvcc`` seconds timed.  Then at once, each a fresh interpreter with
   ``PYTHONPATH`` the ``site`` alone, ``XDG_CACHE_HOME`` the temporary
   cache and its working directory outside the checkout: a probe checks
   that ``orion_tpu_torch`` is imported from ``site``, that it loads the
   cache's library and that ``fused_gram`` matches its plain version at
   16384 x 256 x 6 within 1e-5 * max(1, amplitude); (2) the installed
   ``orion-tpu-torch hunt`` of ``tpu_bo`` at q=1024 (the ``cli`` phase's
   script and config) on two stores seeded with 256 completed trials, 16
   trials each: two GP rounds, ``fused_gram`` launched at 16384 x 256 x 6
   in each (the workers' profiler traces); (3) the installed plugin,
   found through its ``orion_tpu_torch.algo`` entry point, hunts the
   quadratic box 25 trials to within 1e-4 of its optimum 23.4; (4) the
   LeNet example (``examples/torch_mnist_lenet.py``) hunts 3 trials,
   training on the card.  One JSON line a part (seconds, ``nvcc``
   seconds, launches, trials); nothing new under the checkout's
   ``build/`` or under ``site``'s parent, and one library in the cache.
21. The ``{"kernels": [...]}`` line, the card's name and power limit, and
   last the ``{"ok": true, "device": ...}`` line.

Without a CUDA device it exits with code 1 before printing any result.
"""

import bisect
import collections
import contextlib
import io
import json
import multiprocessing
import os
import queue
import re
import shutil
import signal
import socket
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

#: fused_gram shapes (m, n, d): the main path's first, then one for each
#: path of the kernel's launch plan and the edges: n odd (scalar stores), a
#: single element, a single tile, and 100000 rows (many tiles per block);
#: last the asha_bo path's EI cross-gram (chunked).
ASHA_BO_SHAPE = (8192, 512, 51)
CASES = [(16384, 256, 6), (16384, 1024, 6), (4096, 256, 8), (8192, 512, 50),
         (300, 70, 6), (513, 129, 130), (16384, 257, 6), (1, 1, 1), (64, 4, 6),
         (100000, 256, 6), ASHA_BO_SHAPE]
KINDS = ("matern52", "rbf")

Q = 1024
N_HISTORY = 130
ROUNDS = 5
ALGO = {"n_init": 16, "n_candidates": 16384, "fit_steps": 40, "local_frac": 0.3,
        "prewarm": False}
GLOBAL_MIN = -3.32237  # Hartmann6


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def emit(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def smi_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return proc.stdout.strip().splitlines()[0]


def phase_device():
    from orion_tpu_torch.ops import _build

    nvcc = subprocess.run([_build.nvcc_path(), "--version"], capture_output=True, text=True,
                          timeout=60, check=True).stdout.strip().splitlines()[-1]
    emit("device", smi=smi_line(), name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
         nvcc=nvcc, python=sys.version.split()[0])


def phase_build():
    """Compile every ``csrc/*.cu`` at once, one nvcc each.  ``cached`` names
    the sources whose library this checkout already held (not rebuilt)."""
    from concurrent.futures import ThreadPoolExecutor

    from orion_tpu_torch.ops import _build

    sources = sorted(f[:-3] for f in os.listdir(_build._CSRC) if f.endswith(".cu"))
    cached = [s for s in sources if os.path.exists(_build.library_path(s))]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        paths = list(pool.map(_build.build, sources))
    seconds = time.perf_counter() - t0
    ptxas = {}
    for name, path in zip(sources, paths):
        with open(path + ".log") as handle:
            ptxas[name] = [line.strip() for line in handle
                           if "registers" in line or "spill" in line]
    emit("build", seconds=seconds, sources=sources, cached=cached, ptxas=ptxas)


def check_fused_gram(device):
    from orion_tpu_torch.benchmarks.gram_bench import eager_ms, gram_bound, gram_bytes, graph_ms
    from orion_tpu_torch.ops.gram import fused_gram, fused_gram_reference

    gen = torch.Generator(device=device).manual_seed(0)
    cases = []
    for m, n, d in CASES:
        for kind in KINDS:
            xa = torch.rand((m, d), generator=gen, device=device)
            xb = torch.rand((n, d), generator=gen, device=device)
            ils = 0.5 + 2.5 * torch.rand((d,), generator=gen, device=device)
            amp = 0.2 + 2.8 * torch.rand((), generator=gen, device=device)
            got = fused_gram(xa, xb, ils, amp, kind=kind)
            want = fused_gram_reference(xa, xb, ils, amp, kind=kind)
            torch.cuda.synchronize()
            err = float((got - want).abs().max())
            limit = 1e-5 * max(1.0, float(amp))
            if not err <= limit:
                raise AssertionError(f"fused_gram {kind} {(m, n, d)}: max_abs_err {err} > {limit}")
            bound_ms, bound_by = gram_bound(m, n, d)
            kernel_ms = graph_ms(lambda: fused_gram(xa, xb, ils, amp, kind=kind))
            cases.append({
                "m": m, "n": n, "d": d, "kind": kind, "max_abs_err": err, "tolerance": limit,
                "ms": kernel_ms, "kernel_ms": kernel_ms,
                "gbytes_per_s": gram_bytes(m, n, d) / (kernel_ms * 1e-3) / 1e9,
                "bound_share": bound_ms / kernel_ms,
                "fill_ms": graph_ms(lambda: torch.empty((m, n), device=device).fill_(1.0)),
                "plain_ms": graph_ms(lambda: fused_gram_reference(xa, xb, ils, amp, kind=kind)),
                "eager_ms": eager_ms(lambda: fused_gram(xa, xb, ils, amp, kind=kind)),
                "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            })
    emit("kernel_checks", kernel="fused_gram", cases=cases)
    return cases


def _hartmann6(x):
    from orion_tpu_torch.benchmarks.functions import hartmann6

    return hartmann6(torch.from_numpy(np.asarray(x, np.float32))).numpy()


def _observe(algo, x, y):
    algo.observe([{f"x{i}": float(r[i]) for i in range(6)} for r in x],
                 [{"objective": float(v)} for v in y])


def _make_algo(seed, device, **overrides):
    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.space.dsl import build_space

    space = build_space({f"x{i}": "uniform(0, 1)" for i in range(6)})
    return create_algo(space, {"tpu_bo": dict(ALGO, **overrides)}, seed=seed, device=device)


def phase_main_path(device, q=Q, rounds=ROUNDS, **overrides):
    """bench.py's throughput recipe through the port; returns the launch
    counts of the timed rounds."""
    from orion_tpu_torch.health import DEVICE_HEALTH_FIELDS
    from orion_tpu_torch.ops.gram import fused_gram

    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS

    rng = np.random.default_rng(0)
    algo = _make_algo(0, device, **overrides)
    x = rng.uniform(size=(N_HISTORY, 6)).astype(np.float32)
    _observe(algo, x, _hartmann6(x))
    captured = len(STEP_GRAPHS.entries())
    t0 = time.perf_counter()
    # The signature's first round: an eager warm-up round (the first fit at
    # pad 256, the kernel's load), the capture and the instantiation.
    algo.suggest(q)
    warmup_ms = (time.perf_counter() - t0) * 1e3
    new = [entry for _dev, _sig, entry in STEP_GRAPHS.entries()[captured:]]
    if len(new) != 1 or new[0].graph is None:
        raise AssertionError(f"the main path's first round captured {len(new)} graphs")
    capture = {"capture_ms": new[0].capture_ms, "instantiate_ms": new[0].instantiate_ms,
               "graph_nodes": new[0].graph_nodes, "pool_bytes": new[0].pool_bytes,
               "launches_in_graph": len(new[0].launches)}
    times = []
    fused_gram.launches = 0
    for _ in range(rounds):
        xn = rng.uniform(size=(16, 6)).astype(np.float32)
        _observe(algo, xn, _hartmann6(xn))
        t0 = time.perf_counter()
        batch = algo.suggest_batch(q)
        _sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
        cube = batch.cube
        if cube.shape != (q, 6) or not np.isfinite(cube).all():
            raise AssertionError(f"bad rows: shape {cube.shape}")
        if not ((cube >= 0).all() and (cube <= 1).all()):
            raise AssertionError("rows outside the unit cube")
        health = algo.health_record()
        if not all(np.isfinite(health[f]) for f in DEVICE_HEALTH_FIELDS):
            raise AssertionError(f"non-finite health: {health}")
    launches = {"fused_gram": fused_gram.launches}
    if launches["fused_gram"] < rounds:
        raise AssertionError(f"fused_gram launched {launches['fused_gram']} times "
                             f"in {rounds} rounds")
    if len(STEP_GRAPHS.entries()) != captured + 1:
        raise AssertionError("a timed main-path round captured a new signature")
    median = statistics.median(times)
    emit("main_path", q=q, rounds=rounds, round_ms=times, median_round_ms=median,
         suggestions_per_s=q / (median / 1e3), warmup_ms=warmup_ms, capture=capture,
         launches=launches,
         unique_rows=int(len({tuple(r) for r in cube})),
         health={f: health[f] for f in DEVICE_HEALTH_FIELDS})
    return algo, launches, median


def profile_round(round_fn, device, check_stages=True):
    """One call of ``round_fn`` under the profiler: kernels launched,
    the device's busy time (the union of its kernel intervals) against the
    call's wall time, each ``suggest.*`` stage's host and device ms (the
    ``record_function`` spans of the algorithms' suggest paths and
    ``_suggest_step``; a kernel counts for the span it starts in), and the
    ops that take the most device and host time.  ``idle_share`` is None
    when the trace holds no device events.  ``check_stages=False`` for a replayed
    round: a CUDA graph runs no Python, so it has no ``suggest.*`` span but
    the draws'."""
    from torch.autograd import DeviceType
    from torch.autograd.profiler import profile

    from orion_tpu_torch.ops.gram import PROFILE_RANGE

    _sync(device)
    # The kineto profiler torch.profiler wraps, as hunt --profile drives it
    # (compiler_plane.profiler_capture): the wrapper imports torch._inductor.
    card = "cuda" if torch.device(device).type == "cuda" else None
    with profile(use_device=card, use_kineto=True) as prof:
        t0 = time.perf_counter()
        round_fn()
        _sync(device)
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.function_events
    # Device-side copies of the spans (and of ``fused_gram``'s launch range)
    # cover the gaps between their kernels: leave them out of the busy time.
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == DeviceType.CUDA
                     and not e.name.startswith(("suggest.", PROFILE_RANGE + " ")))
    busy_us, end = 0.0, float("-inf")
    for start, stop in kernels:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    # A stage's device time is that of the kernels that start inside its
    # span.  Not the profiler's per-op tree: the backward passes run on
    # autograd's device thread, outside the main thread's spans.
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                   if e.device_type == DeviceType.CPU and e.name.startswith("suggest."))
    stages = {name: [0.0, 0.0] for _, _, name in spans}
    stages["outside_spans"] = [None, 0.0]
    for start, stop, name in spans:
        stages[name][0] += (stop - start) / 1e3
    starts = [span[0] for span in spans]
    for start, stop in kernels:
        i = bisect.bisect_right(starts, start) - 1
        inside = i >= 0 and start < spans[i][1]
        stages[spans[i][2] if inside else "outside_spans"][1] += (stop - start) / 1e3
    required = ("suggest.draws", "suggest.fit_gp", "suggest.candidates", "suggest.polish",
                "suggest.acquire", "suggest.ei_rank", "suggest.select")
    for name in required if check_stages else required[:1]:
        if name not in stages:
            raise AssertionError(f"the profiled round recorded no {name} span")
    averages = prof.key_averages()

    def top(attr):
        rows = sorted(averages, key=lambda e: getattr(e, attr), reverse=True)[:12]
        return [[e.key, e.count, getattr(e, attr) / 1e3] for e in rows]

    return dict(wall_ms=wall_ms, device_events=len(kernels), device_busy_ms=busy_us / 1e3,
                idle_share=(1.0 - busy_us / 1e3 / wall_ms) if kernels else None,
                stage_host_device_ms=stages,
                top_self_device_ms=top("self_device_time_total"),
                top_self_cpu_ms=top("self_cpu_time_total"))


def eager_round(algo, plan_fn):
    """One round of ``algo`` run eagerly: ``_suggest_step`` called on the
    plan ``plan_fn`` builds, as a signature's first (warm-up) round runs;
    the state goes back to the algorithm as a suggest's would."""
    from orion_tpu_torch.algo import tpu_bo as tbo

    plan = plan_fn()
    rows, state = tbo._suggest_step(*plan.arrays, **plan.statics)
    algo._gp_state = state
    return rows[:plan.num].cpu()


def replayed(algo, plan_fn):
    """Whether the round ``plan_fn`` would build is captured already (the
    next suggest replays it).  The model stream is put back after."""
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS

    state = algo.model_generator.get_state()
    try:
        plan = plan_fn()
    finally:
        algo.model_generator.set_state(state)
    return STEP_GRAPHS.has(algo.device, plan.signature)


def phase_profile(algo, q=Q):
    """Two more main-path rounds under the profiler (:func:`profile_round`):
    one eager (``_suggest_step`` called directly), whose ``suggest.*``
    spans give the per-stage breakdown, and one replayed, whose trace gives
    the round's device idle share as the main path runs it."""
    rng = np.random.default_rng(1)
    xn = rng.uniform(size=(16, 6)).astype(np.float32)
    _observe(algo, xn, _hartmann6(xn))
    plan_fn = lambda: algo.fused_step_plan(q)  # noqa: E731
    emit("profile", q=q, round="eager",
         **profile_round(lambda: eager_round(algo, plan_fn), algo.device))
    emit("profile", q=q, round="replay", replayed=replayed(algo, plan_fn),
         **profile_round(lambda: algo.suggest_batch(q), algo.device, check_stages=False))


def regret_curve(seed, device, budget=192, q=16, n_init=16, algo_kwargs=None):
    """bench.py's ``run_regret_curve`` through the port."""
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(size=(n_init, 6)).astype(np.float32)
    y0 = _hartmann6(x0)
    algo = _make_algo(seed, device, **(algo_kwargs or {}))
    _observe(algo, x0, y0)
    best, n_evals = float(np.min(y0)), len(y0)
    curve = [best - GLOBAL_MIN]
    while n_evals < budget:
        step_q = min(q, budget - n_evals)
        params = algo.suggest(step_q)
        xn = np.asarray([[p[f"x{i}"] for i in range(6)] for p in params], np.float32)
        yn = _hartmann6(xn)
        _observe(algo, xn, yn)
        best = min(best, float(np.min(yn)))
        n_evals += step_q
        curve.append(best - GLOBAL_MIN)
    return curve


def phase_regret(device):
    from orion_tpu_torch.benchmarks.regret_gate import evaluate_regret_gate, load_baseline

    path = os.path.join(ROOT, "BENCH_REGRET_BASELINE.json")
    with open(path) as handle:
        config = json.load(handle)["config"]
    baseline = load_baseline(path)
    kwargs = dict(config["algo"]["tpu_bo"])
    curves = [regret_curve(seed, device, budget=config["budget"], q=config["q"],
                           n_init=config["n_init"], algo_kwargs=kwargs)
              for seed in range(len(baseline))]
    verdict = evaluate_regret_gate(curves, baseline)
    emit("regret", final=[c[-1] for c in curves],
         baseline_final=[c[-1] for c in baseline], gate=verdict)
    if not verdict["pass"]:
        raise AssertionError("regret gate failed against BENCH_REGRET_BASELINE.json")


def _preset_run(name, seeds=(0,)):
    """The ``algorithms`` row of the port's benchmark preset ``name``
    (``orion_tpu_torch.benchmarks.runner.PRESETS``)."""
    from orion_tpu_torch.benchmarks.runner import PRESETS

    preset = PRESETS[name]
    algorithm = preset["algorithm"]
    if not isinstance(algorithm, dict):
        algorithm = {algorithm: {}}
    return (name, preset["priors"], preset["fn"], algorithm, preset["max_trials"],
            preset["batch_size"], seeds)


def algo_runs():
    """The ``algorithms`` phase: (run, priors, function, algorithm config,
    trials, batch, seeds).  A run named like a benchmark preset is that
    preset and reads its reference regret from ``BENCH_SEEDS.json``;
    ``grid-branin``, ``tpe-hartmann6`` and ``hyperband-ackley50`` have no
    preset and keep their own rows."""
    from orion_tpu_torch.benchmarks.runner import _ackley50_priors, _uniform_priors

    return [
        _preset_run("random-branin"),
        ("grid-branin", _uniform_priors(2), "branin", {"grid_search": {"n_values": 14}}, 200,
         50, (0,)),
        ("tpe-hartmann6", _uniform_priors(6), "hartmann6", {"tpe": {}}, 192, 16, (0,)),
        _preset_run("cmaes-rosenbrock20"),
        _preset_run("de-rosenbrock20"),
        _preset_run("asha-ackley50"),
        ("hyperband-ackley50", _ackley50_priors(), "ackley50", {"hyperband": {}}, 4096, 512,
         (0,)),
        _preset_run("bohb-ackley50"),
        _preset_run("asha_bo-ackley50", seeds=(0, 1)),
    ]


#: Each asha_bo-ackley50 seed must end below this regret: plain ASHA sits at
#: 20.35-20.70 on this preset, the reference asha_bo's worst of 15 seeds at
#: 18.93 (``BENCH_SEEDS.json``).
ASHA_BO_REGRET_LIMIT = 20.0


def _reference_regret(preset):
    """The reference's median regret for ``preset``: its latest row in
    ``BENCH_SEEDS.json`` (one JSON object per line), or None."""
    row = None
    with open(os.path.join(ROOT, "BENCH_SEEDS.json")) as handle:
        for line in handle:
            entry = json.loads(line)
            if entry.get("preset") == preset:
                row = entry
    if row is None:
        return None
    return {"regret_median": row["regret_median"], "seeds": row["seeds"],
            "sweep": row["sweep"]}


def run_algorithm(device, priors, fn_name, config, max_trials, batch, seed):
    """One run through the public API: ``suggest(batch)``, evaluate on the
    host, ``observe``, until ``max_trials`` or ``is_done``.  Checks every
    row against the space and each round for repeated points."""
    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.benchmarks.functions import BENCHMARKS
    from orion_tpu_torch.space.dsl import build_space

    spec = BENCHMARKS[fn_name]
    space = build_space(priors)
    fid = space.fidelity
    algo = create_algo(space, config, seed=seed, device=device)
    n_done, best, suggest_ms = 0, float("inf"), []
    t0 = time.perf_counter()
    while n_done < max_trials and not algo.is_done:
        t1 = time.perf_counter()
        params = algo.suggest(min(batch, max_trials - n_done))
        _sync(device)
        suggest_ms.append((time.perf_counter() - t1) * 1e3)
        if params is None:
            break
        points = [dict(p) for p in params]
        bad = [p for p in points if not space.contains_point(p)]
        if bad:
            raise AssertionError(f"{config}: {len(bad)} rows outside the space, e.g. {bad[0]}")
        keys = [tuple(v for k, v in sorted(p.items()) if fid is None or k != fid.name)
                for p in points]
        if len(set(keys)) != len(keys):
            raise AssertionError(f"{config}: a round repeats a point")
        cube = space.params_to_cube(params)
        values = spec["fn"](torch.from_numpy(cube)).numpy()
        if not np.isfinite(values).all():
            raise AssertionError(f"{config}: non-finite objective")
        algo.observe(params, [{"objective": float(v)} for v in values])
        best = min(best, float(values.min()))
        n_done += len(points)
    wall = time.perf_counter() - t0
    return algo, {"trials": n_done, "rounds": len(suggest_ms), "wall_s": wall,
                  "median_suggest_ms": statistics.median(suggest_ms),
                  "suggestions_per_s": n_done / wall, "regret": best - spec["optimum"],
                  "is_done": bool(algo.is_done)}


def phase_algorithms(device, runs=None):
    """Every run of ``runs`` (default :func:`algo_runs`); returns
    ``fused_gram``'s launches over the asha_bo runs (zeroed just before
    each, read just after).  After the first asha_bo run, one more model
    round of 512 fresh points runs under the profiler
    (:func:`profile_round`)."""
    from orion_tpu_torch.ops import gram

    plan = gram._launch_plan(*ASHA_BO_SHAPE, True)
    if plan.resident:
        raise AssertionError(f"{ASHA_BO_SHAPE} is expected on the chunked path: {plan}")
    asha_bo_launches = 0
    for name, priors, fn_name, config, max_trials, batch, seeds in runs or algo_runs():
        reference = _reference_regret(name)
        for seed in seeds:
            gram.fused_gram.launches = 0
            algo, out = run_algorithm(device, priors, fn_name, config, max_trials, batch,
                                      seed)
            launches = gram.fused_gram.launches
            emit("algorithms", run=name, seed=seed, config=config, batch=batch,
                 **out, fused_gram_launches=launches, reference=reference)
            if "asha_bo" in config:
                asha_bo_launches += launches
                if launches == 0:
                    raise AssertionError(f"{name} seed {seed}: fused_gram never launched")
                if not out["regret"] < ASHA_BO_REGRET_LIMIT:
                    raise AssertionError(f"{name} seed {seed}: regret {out['regret']} "
                                         f">= {ASHA_BO_REGRET_LIMIT}")
                if seed == seeds[0]:
                    plan_fn = lambda: algo._gp_plan(batch)  # noqa: E731
                    emit("profile", run=name, q=batch, round="eager",
                         **profile_round(lambda: eager_round(algo, plan_fn), device))
                    algo._sample_new(batch)  # captures this signature if it is new
                    emit("profile", run=name, q=batch, round="replay",
                         replayed=replayed(algo, plan_fn),
                         **profile_round(lambda: algo._sample_new(batch), device,
                                         check_stages=False))
    return asha_bo_launches


#: The ``hunt`` phase: the main path's algorithm through ``optimize()``.
HUNT_ALGO = {"tpu_bo": {"n_init": 16, "n_candidates": 16384, "fit_steps": 40,
                        "local_frac": 0.3}}
HUNT_ROUNDS = 4
HUNT_PRIORS = {f"x{i}": "uniform(0, 1)" for i in range(6)}
MAIN_SHAPE = (16384, 256, 6)
WORKERS = 2
WORKER_ROUNDS = 3  # 2 workers x 3 rounds x 1024 = 6144 trials


def _median(values):
    return statistics.median(values) if values else None


def _timed(fn, samples):
    """``fn`` recording ``(start, wall ms)`` of each call into ``samples``."""
    def wrapper(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            samples.append((t0, (time.perf_counter() - t0) * 1e3))
    return wrapper


def _per_round(samples, edges):
    """The ms of ``samples`` summed per round, round ``k`` being the calls
    that start between ``edges[k]`` and ``edges[k + 1]``."""
    out = [0.0] * (len(edges) - 1)
    for start, ms in samples:
        k = bisect.bisect_right(edges, start) - 1
        if 0 <= k < len(out):
            out[k] += ms
    return out


class _LaunchShapes:
    """Counts the (m, n, d) of every ``fused_gram`` launch plan while
    active (the plan is made just before each launch)."""

    def __enter__(self):
        from orion_tpu_torch.ops import gram

        self.shapes = collections.Counter()
        self._plan = gram._launch_plan

        def plan(m, n, d, aligned):
            self.shapes[(m, n, d)] += 1
            return self._plan(m, n, d, aligned)

        gram._launch_plan = plan
        return self

    def __exit__(self, *exc):
        from orion_tpu_torch.ops import gram

        gram._launch_plan = self._plan


def run_hunt(device, storage, q=Q, rounds=HUNT_ROUNDS, algo=HUNT_ALGO, name="hunt"):
    """``optimize(tpu_bo)`` on ``storage``: ``rounds`` rounds of ``q`` on
    Hartmann6, ``batch_eval`` on the card.  Returns its timings, launches
    and checks as a dict."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import optimize
    from orion_tpu_torch.ops import gram

    samples = {"sync": [], "reserve": [], "batch_eval": [], "complete": []}
    storage.fetch_update_view = _timed(storage.fetch_update_view, samples["sync"])
    storage.reserve_trials = _timed(storage.reserve_trials, samples["reserve"])
    storage.update_completed_trials = _timed(storage.update_completed_trials,
                                             samples["complete"])
    ends, best = [], []

    def batch_eval(x):
        t0 = time.perf_counter()
        values = hartmann6(x)
        best.append(float(values.min()))  # one copy; also the sync
        samples["batch_eval"].append((t0, (time.perf_counter() - t0) * 1e3))
        if x.device.type != device.type or tuple(x.shape) != (q, 6):
            raise AssertionError(f"batch_eval got {x.device} {tuple(x.shape)}")
        ends.append(time.perf_counter())
        return values

    gram.fused_gram.launches = 0
    with _LaunchShapes() as launch_shapes:
        t0 = time.perf_counter()
        stats = optimize(None, HUNT_PRIORS, max_trials=rounds * q, batch_size=q,
                         algorithm=algo, seed=0, storage=storage, name=name,
                         batch_eval=batch_eval)
        wall_s = time.perf_counter() - t0
    launches = gram.fused_gram.launches
    exp_id = storage.fetch_experiments({"name": name})[0]["_id"]
    trials = storage.fetch_trials(uid=exp_id)
    values = [t.objective.value for t in trials if t.objective is not None]
    if not (stats["trials_completed"] == len(trials) == len(values) == rounds * q):
        raise AssertionError(f"{name}: {stats['trials_completed']} completed of "
                             f"{len(trials)} trials, expected {rounds * q}")
    if len({t.id for t in trials}) != len(trials) or not np.isfinite(values).all():
        raise AssertionError(f"{name}: repeated ids or non-finite objectives")
    if any(not 0.0 <= v <= 1.0 for t in trials for v in t.params.values()):
        raise AssertionError(f"{name}: a point outside the space")
    gp_rounds = rounds - 1  # round 1 is random: fewer than n_init observed
    if launches < gp_rounds or launch_shapes.shapes[MAIN_SHAPE] < gp_rounds:
        raise AssertionError(f"{name}: fused_gram launched {launches} times "
                             f"({dict(launch_shapes.shapes)}) in {gp_rounds} GP rounds")
    timings = collections.defaultdict(list)
    for doc in storage.fetch_timings(exp_id):
        timings[doc["op"]].append(doc["duration"] * 1e3)
    # Round k runs from the end of batch_eval k - 1 (the start of the run
    # for the first) to the end of batch_eval k: completion of the previous
    # round, the producer's sync with storage (``fetch_update_view``), its
    # observe, naive copy, suggest and register, reserve, and batch_eval.
    edges = [t0] + ends
    round_ms = list(np.diff(edges) * 1e3)
    # GP rounds only: the producer's suggest and register of rounds 2-5, its
    # observe of rounds 1-4's results (made at the start of rounds 2-5).
    gp = {"suggest": timings["suggest"][1:], "register": timings["register"][1:],
          "observe": timings["observe"]}
    gp.update({op: _per_round(samples[op], edges)[1:] for op in samples})
    return {
        "trials": len(trials), "gp_rounds": gp_rounds, "wall_s": wall_s,
        "round_ms": round_ms, "median_gp_round_ms": _median(round_ms[1:]),
        "suggestions_per_s": q / (_median(round_ms[1:]) / 1e3),
        "median_ms": {op: _median(v) for op, v in gp.items()},
        "samples_ms": gp, "regret": min(best) - GLOBAL_MIN,
        "fused_gram_launches": launches,
        "launch_shapes": {"x".join(map(str, k)): v for k, v in launch_shapes.shapes.items()},
    }


def _hunt_worker(path, seed, rounds, q, barrier, results, device=None, algo=HUNT_ALGO):
    """One worker process: an ``ExperimentClient`` loop at ``q`` on the
    ``pickled`` file at ``path`` that keeps one batch in evaluation while
    it asks for the next, completing a batch only once every worker has
    reserved its next one (``barrier``).  From its third round on, each
    producer so fits the GP to the completed batches and lies about the
    batches in flight, its own and the other worker's."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.utils.exceptions import WaitingForTrials

    import orion_tpu_torch.device  # noqa: F401  (precision switches)

    storage = create_storage({"type": "pickled", "path": path})
    exp = build_experiment(storage, "workers", priors=HUNT_PRIORS,
                           max_trials=WORKERS * rounds * q, algorithms=algo,
                           pool_size=q).instantiate(seed=seed, device=device)
    client = ExperimentClient(exp)
    space = exp.space
    reserved, completed, suggest_ms, held, waits = [], [], [], None, 0

    def complete(trials):
        cube = torch.as_tensor(space.params_to_cube([t.params for t in trials]),
                               device=exp.algorithm.device)
        client.observe_all(trials, hartmann6(cube).cpu().numpy().tolist())
        completed.extend(t.id for t in trials)

    gram.fused_gram.launches = 0
    for _ in range(rounds):
        t0 = time.perf_counter()
        while True:
            try:
                trials = client.suggest(q)
                break
            except WaitingForTrials:
                # The other worker reserved the batch this one had just
                # registered, before this one reserved it: the client's
                # signal to ask again, which produces a fresh batch.
                waits += 1
                if waits > 2 * rounds:
                    raise
        suggest_ms.append((time.perf_counter() - t0) * 1e3)
        reserved.extend(t.id for t in trials)
        barrier.wait(timeout=300)
        if held is not None:
            complete(held)
        held = trials
    complete(held)
    results.put({"seed": seed, "reserved": reserved, "completed": completed,
                 "suggest_ms": suggest_ms, "waits": waits,
                 "fused_gram_launches": gram.fused_gram.launches,
                 "observed": exp.algorithm.n_observed})


def run_workers(tmp_dir, q=Q, rounds=WORKER_ROUNDS, workers=WORKERS, device=None,
                algo=HUNT_ALGO):
    """``workers`` spawned processes on one ``pickled`` file (their
    algorithms on ``device``, ``None`` meaning ``cuda``); checks that no
    trial was reserved twice and each was completed once."""
    from orion_tpu_torch.storage.base import create_storage

    path = os.path.join(tmp_dir, "workers.pkl")
    ctx = multiprocessing.get_context("spawn")
    barrier, results = ctx.Barrier(workers), ctx.Queue()
    procs = [ctx.Process(target=_hunt_worker,
                         args=(path, seed, rounds, q, barrier, results, device, algo))
             for seed in range(workers)]
    t0 = time.perf_counter()
    for proc in procs:
        proc.start()
    out = []
    try:
        while len(out) < len(procs):
            try:
                out.append(results.get(timeout=5))
            except queue.Empty:
                failed = [p.exitcode for p in procs if p.exitcode not in (None, 0)]
                if failed or time.perf_counter() - t0 > 600:
                    raise AssertionError(f"workers failed or hung: exit codes {failed}")
        for proc in procs:
            proc.join(timeout=120)
            if proc.exitcode != 0:
                raise AssertionError(f"worker exited with {proc.exitcode}")
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.terminate()
                proc.join()
    wall_s = time.perf_counter() - t0
    storage = create_storage({"type": "pickled", "path": path})
    exp_id = storage.fetch_experiments({"name": "workers"})[0]["_id"]
    trials = storage.fetch_trials(uid=exp_id)
    reserved = [tid for r in out for tid in r["reserved"]]
    completed = [tid for r in out for tid in r["completed"]]
    total = workers * rounds * q
    ids = [t.id for t in trials]
    out = {"workers": workers, "q": q, "rounds_each": rounds, "trials": len(ids),
           "lies": len(storage.fetch_lies(exp_id)), "wall_s": wall_s,
           "fused_gram_launches": sum(r["fused_gram_launches"] for r in out),
           "per_worker": [{k: r[k] for k in ("seed", "suggest_ms", "waits",
                                             "fused_gram_launches", "observed")}
                          for r in out],
           "reserved": len(reserved), "reserved_distinct": len(set(reserved)),
           "completed": len(completed), "completed_distinct": len(set(completed)),
           "statuses": sorted({t.status for t in trials})}
    emit("hunt", run="workers", storage="pickled", **out)
    if not (len(reserved) == len(set(reserved)) == len(completed) == len(set(completed))
            == len(ids) == len(set(ids)) == total and set(reserved) == set(ids)):
        raise AssertionError(f"workers: {len(reserved)} reserved ({len(set(reserved))} "
                             f"distinct), {len(completed)} completed, {len(ids)} trials "
                             f"({len(set(ids))} ids), expected {total}")
    if out["statuses"] != ["completed"]:
        raise AssertionError(f"workers: statuses {out['statuses']}")
    if out["lies"] == 0 or out["fused_gram_launches"] < workers:
        raise AssertionError("workers: no lie registered or no GP round launched fused_gram")
    return out


def regret_curve_optimize(seed, budget, q, algo_kwargs):
    """The regret gate's scenario through ``optimize()``: the incumbent's
    regret after each round (the first round is the random initial design
    of ``n_init`` points)."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import optimize

    curve, best = [], float("inf")

    def batch_eval(x):
        nonlocal best
        values = hartmann6(x)
        best = min(best, float(values.min()))
        curve.append(best - GLOBAL_MIN)
        return values

    optimize(None, HUNT_PRIORS, max_trials=budget, batch_size=q,
             algorithm={"tpu_bo": algo_kwargs}, seed=seed, batch_eval=batch_eval)
    return curve


def phase_hunt(device, plain_round_ms):
    """The library path through the producer and storage: both backends,
    two workers, the regret gate through ``optimize()``.  Returns
    ``fused_gram``'s launches over all of it (zeroed before each run, read
    after it)."""
    from orion_tpu_torch.benchmarks.regret_gate import evaluate_regret_gate, load_baseline
    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.storage.base import create_storage

    launches = 0
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        for backend in ("pickled", "memory"):
            storage = create_storage({"type": backend, "path": os.path.join(tmp, "hunt.pkl")})
            out = run_hunt(device, storage)
            launches += out["fused_gram_launches"]
            emit("hunt", storage=backend, q=Q, plain_round_ms=plain_round_ms, **out)
        launches += run_workers(tmp)["fused_gram_launches"]
    path = os.path.join(ROOT, "BENCH_REGRET_BASELINE.json")
    with open(path) as handle:
        config = json.load(handle)["config"]
    baseline = load_baseline(path)
    gram.fused_gram.launches = 0
    curves = [regret_curve_optimize(seed, config["budget"], config["q"],
                                    dict(config["algo"]["tpu_bo"]))
              for seed in range(len(baseline))]
    launches += gram.fused_gram.launches
    verdict = evaluate_regret_gate(curves, baseline)
    emit("hunt", run="regret", final=[c[-1] for c in curves],
         baseline_final=[c[-1] for c in baseline], gate=verdict,
         fused_gram_launches=gram.fused_gram.launches)
    if not verdict["pass"]:
        raise AssertionError("regret gate through optimize() failed against "
                             "BENCH_REGRET_BASELINE.json")
    return launches


#: The ``cli`` phase: the main path's algorithm through ``orion-tpu-torch
#: hunt`` over a user script, one trial a subprocess.
CLI_PRIORS = [f"-x{i}~uniform(0, 1)" for i in range(6)]
CLI_ALGO = {"n_init": 16, "n_candidates": 16384, "fit_steps": 40, "local_frac": 0.3, "seed": 0}
CLI_Q = 1024
CLI_TRIALS = 32  # past a seeded history of CLI_HISTORY: one GP round, 32 of it consumed
#: The one-worker hunt's history, completed through the library: as many as
#: its trials were before the depth cut, so that the ``evc`` children's first
#: rounds still fit 256 rows of family history (``MAIN_SHAPE``).
CLI_HISTORY = 1024
CLI_WORKERS = 8
CLI_WORKER_TRIALS = 1088
#: The kernel's name in a profiler trace (``ops/csrc/gram.cu``).
GRAM_KERNEL = "gram_kernel"

#: The user script: executable, started as ``python -S`` (on the card's host
#: the interpreter's ``site`` start-up costs most of a trial's process:
#: ``interpreter_start_ms`` in the ``cli`` line) and importing only the
#: client.
USER_SCRIPT = r"""#!%s -S
# Hartmann6 on [0, 1]^6 as the user script of `orion-tpu-torch hunt`, in pure
# Python: a trial's process imports neither numpy nor torch.  Arguments are
# `-x0 V ... -x5 V [--log PATH [--hold-after N --hold-seconds S]]`; `--log`
# appends the trial's id to PATH, one line an execution; with `--hold-after`,
# the first trial to start after N others writes its id to PATH.held and
# runs S seconds longer.  With HARTMANN6_HOLD_WHILE=FILE in the environment,
# a trial waits while FILE exists (at most 600 s) before it reports.
import math
import os
import sys
import time

from orion_tpu_torch.client import report_results

ALPHA = %r
A = %r
P = %r

args = dict(zip(sys.argv[1::2], sys.argv[2::2]))
x = [float(args[f"-x{i}"]) for i in range(6)]
y = -sum(ALPHA[j] * math.exp(-sum(A[j][k] * (x[k] - 1e-4 * P[j][k]) ** 2 for k in range(6)))
         for j in range(4))
if "--log" in args:
    with open(args["--log"], "a") as handle:
        handle.write(os.environ["ORION_TRIAL_ID"] + "\n")
if "--hold-after" in args:
    with open(args["--log"]) as handle:
        started = sum(1 for _ in handle)
    if started > int(args["--hold-after"]):
        try:
            held = os.open(args["--log"] + ".held", os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            held = None
        if held is not None:
            os.write(held, os.environ["ORION_TRIAL_ID"].encode())
            os.close(held)
            time.sleep(float(args["--hold-seconds"]))
hold = os.environ.get("HARTMANN6_HOLD_WHILE")
deadline = time.time() + 600.0
while hold and os.path.exists(hold) and time.time() < deadline:
    time.sleep(0.05)
report_results([{"name": "objective", "type": "objective", "value": y}])
"""


def write_cli_files(tmp, algo=CLI_ALGO, name="cli"):
    """The user script and a ``-c`` YAML holding ``algo`` as ``tpu_bo``'s
    config; returns their paths."""
    import yaml

    from orion_tpu_torch.benchmarks import functions

    script = os.path.join(tmp, "hartmann6.py")
    if not os.path.exists(script):
        with open(script, "w") as handle:
            handle.write(USER_SCRIPT % (sys.executable, functions._H6_ALPHA, functions._H6_A,
                                        functions._H6_P))
        os.chmod(script, 0o755)
    config = os.path.join(tmp, f"{name}.yaml")
    with open(config, "w") as handle:
        yaml.safe_dump({"algorithms": {"tpu_bo": dict(algo)}}, handle)
    return script, config


def _trial_rows(trials):
    """(n, 6) float32 rows and (n,) objectives of completed trials."""
    trials = [t for t in trials if t.status == "completed"]
    rows = np.asarray([[t.params[f"/x{i}"] for i in range(6)] for t in trials], np.float32)
    return trials, rows, np.asarray([t.objective.value for t in trials], np.float64)


def check_cli_trials(name, trials, expected, device):
    """At least ``expected`` completed trials, unique ids, every parameter
    in [0, 1], and each objective the user script reported equal to the
    port's Hartmann6 on the card at the trial's point (atol 1e-5: float64
    in the script, float32 here)."""
    from orion_tpu_torch.benchmarks.functions import hartmann6

    done, rows, values = _trial_rows(trials)
    if len(done) < expected:
        raise AssertionError(f"{name}: {len(done)} completed trials, expected {expected}")
    if len({t.id for t in trials}) != len(trials):
        raise AssertionError(f"{name}: repeated trial ids")
    if not ((rows >= 0.0) & (rows <= 1.0)).all():
        raise AssertionError(f"{name}: a point outside the space")
    want = hartmann6(torch.from_numpy(rows).to(device)).cpu().numpy()
    err = float(np.abs(want - values).max())
    if not err <= 1e-5:
        raise AssertionError(f"{name}: objectives differ from hartmann6 by {err}")
    return done, values, err


def _fetch_trials(storage, name):
    [exp] = storage.fetch_experiments({"name": name})
    return exp["_id"], storage.fetch_trials(uid=exp["_id"])


def run_cli_hunt(tmp, device, q=CLI_Q, max_trials=CLI_TRIALS, algo=CLI_ALGO,
                 history=CLI_HISTORY):
    """``orion-tpu-torch hunt`` in this process, one worker, on SQLite:
    ``max_trials`` trials of the user script at ``--pool-size q`` past a
    history of ``history`` completed through the library
    (:func:`seed_history`), so that its first round is a GP round; the
    kernel's launch shapes counted over the whole call.  Each trial's
    consumption (working dir, files, subprocess, results) and within it the
    subprocess, its reservation and completion and the loop's status reads
    are timed by wrapping their calls."""
    from orion_tpu_torch import cli
    from orion_tpu_torch.core.consumer import Consumer
    from orion_tpu_torch.core.experiment import Experiment
    from orion_tpu_torch.core.producer import Producer
    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.storage.base import DocumentStorage, create_storage

    script, config = write_cli_files(tmp, algo)
    db = os.path.join(tmp, "cli.sqlite")
    seed_history(create_storage({"type": "sqlite", "path": db}), "cli",
                 ["-c", config, "--storage-path", db], script, None, device, completed=history)
    samples = {"consume": [], "trial_process": [], "reserve": [], "complete": [], "status": [],
               "produce": []}
    patches = [(Consumer, "consume", "consume"), (Consumer, "_execute_process", "trial_process"),
               (DocumentStorage, "reserve_trial", "reserve"),
               (DocumentStorage, "update_completed_trial", "complete"),
               (Producer, "produce", "produce")]
    saved = [(cls, attr, cls.__dict__[attr]) for cls, attr, _ in patches]
    saved += [(Experiment, attr, Experiment.__dict__[attr]) for attr in ("is_done", "is_broken")]
    for cls, attr, key in patches:
        setattr(cls, attr, _timed(getattr(cls, attr), samples[key]))
    for attr in ("is_done", "is_broken"):
        setattr(Experiment, attr, property(_timed(Experiment.__dict__[attr].fget,
                                                  samples["status"])))
    gram.fused_gram.launches = 0
    try:
        with _LaunchShapes() as launch_shapes:
            t0 = time.perf_counter()
            rc = cli.main(["hunt", "-n", "cli", "-c", config, "--storage-path", db,
                           "--pool-size", str(q), "--max-trials", str(history + max_trials),
                           "--device", device.type, script, *CLI_PRIORS])
            wall_s = time.perf_counter() - t0
    finally:
        for cls, attr, value in saved:
            setattr(cls, attr, value)
    launches = gram.fused_gram.launches
    if rc != 0:
        raise AssertionError(f"cli hunt: exit code {rc}")
    storage = create_storage({"type": "sqlite", "path": db})
    exp_id, trials = _fetch_trials(storage, "cli")
    done, values, err = check_cli_trials("cli hunt", trials, history + max_trials, device)
    if launches < 1 or launch_shapes.shapes[MAIN_SHAPE] < 1:
        raise AssertionError(f"cli hunt: fused_gram launched {launches} times "
                             f"({dict(launch_shapes.shapes)})")
    suggest_ms = [doc["duration"] * 1e3 for doc in storage.fetch_timings(exp_id)
                  if doc["op"] == "suggest"]
    produce_ms = [ms for _, ms in samples["produce"]]
    return {
        "trials": len(trials), "completed": len(done), "wall_s": wall_s,
        "trials_per_s": (len(done) - history) / wall_s,
        "median_ms_per_trial": {k: _median([ms for _, ms in samples[k]])
                                for k in ("consume", "trial_process", "reserve", "complete")},
        "median_status_ms_per_trial": 2 * _median([ms for _, ms in samples["status"]]),
        "calls": {k: len(v) for k, v in samples.items()},
        "history": history, "produce_ms": produce_ms, "gp_round_ms": produce_ms,
        "producer_suggest_ms": suggest_ms,
        "regret": float(values.min()) - GLOBAL_MIN, "objective_max_abs_err": err,
        "fused_gram_launches": launches,
        "launch_shapes": {"x".join(map(str, k)): v for k, v in launch_shapes.shapes.items()},
    }


#: The traces ``read_traces`` read and the seconds it spent, over the run.
TRACE_READS = {"traces": 0, "seconds": 0.0}
#: The fields of a Chrome trace's complete event, in the order the profiler
#: writes them, for the two categories the trace checks read.
_TRACE_EVENT = re.compile(
    r'"cat": "(kernel|user_annotation)",\s*"name": "((?:[^"\\]|\\.)*)",\s*"pid": [^,]*,'
    r'\s*"tid": [^,]*,\s*"ts": ([-0-9.e+]+),\s*"dur": ([-0-9.e+]+)')
_TRACE_CATEGORIES = ("kernel", "user_annotation")


def json_trace_events(text):
    """``(cat, name, ts, dur)`` of every kernel and user_annotation event of
    a Chrome trace, by parsing the whole JSON."""
    return [(e["cat"], e["name"], e["ts"], e["dur"]) for e in json.loads(text)["traceEvents"]
            if e.get("cat") in _TRACE_CATEGORIES]


def trace_events(path):
    """:func:`json_trace_events` of the trace at ``path``, found by a scan
    for those two categories: a worker's trace holds ~100,000 events a GP
    round, tens of MB, and the kernels and ranges are a tenth of them.  The
    scan is held to the number of times each category occurs in the text;
    where they differ (another writer's field order), the whole JSON is
    parsed instead."""
    with open(path) as handle:
        text = handle.read()
    events = [(cat, json.loads(f'"{name}"') if "\\" in name else name, float(ts), float(dur))
              for cat, name, ts, dur in _TRACE_EVENT.findall(text)]
    found = collections.Counter(event[0] for event in events)
    if all(found[cat] == text.count(f'"cat": "{cat}"') for cat in _TRACE_CATEGORIES):
        return events
    return json_trace_events(text)


def read_worker_trace(path):
    """From one ``hunt --profile`` trace: the ``gram.cu`` kernel's launches
    and the (m, n, d) of each, read from the profiler range the wrapper
    opens around every launch (``"fused_gram MxNxD"``), every kernel's
    count, the device's busy ms (the union of the kernel intervals) and its
    idle share over the worker's loop (the host-side ``hunt.workon``
    span).  Raises unless every kernel launch has its range."""
    from orion_tpu_torch.ops.gram import PROFILE_RANGE

    events = trace_events(path)
    kernels = sorted((ts, ts + dur) for cat, _name, ts, dur in events if cat == "kernel")
    gram_launches = sum(1 for cat, name, _ts, _dur in events
                        if cat == "kernel" and GRAM_KERNEL in name)
    shapes = collections.Counter(
        name[len(PROFILE_RANGE) + 1:] for cat, name, _ts, _dur in events
        if cat == "user_annotation" and name.startswith(PROFILE_RANGE + " "))
    if sum(shapes.values()) != gram_launches:
        raise AssertionError(f"{path}: {gram_launches} {GRAM_KERNEL} launches, "
                             f"{sum(shapes.values())} {PROFILE_RANGE} ranges {dict(shapes)}")
    loops = [dur for cat, name, _ts, dur in events
             if cat == "user_annotation" and name == "hunt.workon"]
    if len(loops) != 1:
        raise AssertionError(f"{path}: {len(loops)} hunt.workon spans")
    busy_us, end = 0.0, float("-inf")
    for start, stop in kernels:
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    loop_ms = loops[0] / 1e3
    return {"fused_gram_launches": gram_launches, "launch_shapes": dict(shapes),
            "kernels": len(kernels),
            "loop_ms": loop_ms, "device_busy_ms": busy_us / 1e3,
            "idle_share": 1.0 - busy_us / 1e3 / loop_ms}


def _cli_command(*args):
    return [sys.executable, "-m", "orion_tpu_torch.cli", "hunt", *args]


def run_cohort(commands, timeout, env=None):
    """Run each ``(argv, cwd)`` of ``commands`` at once, each in a session of
    its own, with ``env`` added to the environment; wait for all.  Any
    process still running at ``timeout`` (or after a failure here) is killed
    with everything it started.  Returns the wall seconds; raises on a
    nonzero exit code."""
    env = {**os.environ, "PYTHONPATH": ROOT, **(env or {})}
    procs = [subprocess.Popen(argv, env=env, cwd=cwd, stdout=subprocess.DEVNULL,
                              stderr=subprocess.PIPE, text=True, start_new_session=True)
             for argv, cwd in commands]
    t0 = time.perf_counter()
    try:
        errors = [proc.communicate(timeout=max(1.0, timeout - (time.perf_counter() - t0)))[1]
                  for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    wall_s = time.perf_counter() - t0
    failed = [(proc.returncode, err[-3000:]) for proc, err in zip(procs, errors)
              if proc.returncode != 0]
    if failed:
        raise AssertionError(f"cli: exit codes and stderr {failed}")
    return wall_s


def read_traces(prof):
    """:func:`read_worker_trace` of every trace in ``prof``, with its pid;
    ``TRACE_READS`` adds up the traces read and the seconds it took."""
    t0 = time.perf_counter()
    names = sorted(f for f in os.listdir(prof) if f.startswith("trace-"))
    rows = [dict(pid=int(f[6:-5]), **read_worker_trace(os.path.join(prof, f))) for f in names]
    TRACE_READS["traces"] += len(names)
    TRACE_READS["seconds"] += time.perf_counter() - t0
    return rows


def run_cli_workers(tmp, device, workers=CLI_WORKERS, max_trials=CLI_WORKER_TRIALS, q=CLI_Q,
                    algo=CLI_ALGO, timeout=600, hold_s=5.0):
    """``python3 -m orion_tpu_torch.cli hunt --n-workers W --profile DIR`` on
    a fresh SQLite file: checks that no trial ran twice (the user script
    logs each execution's trial id), that every completed trial ran, and
    that a GP round lied about a trial another worker held: one of the
    random round's last five trials runs ``hold_s`` seconds longer, so the
    workers that find the queue empty meanwhile lie about it.  Counts the
    kernel in the workers' traces.  The config has no seed: processes that
    share one suggest the same points, and their producers spin on
    duplicate keys."""
    from orion_tpu_torch.storage.base import create_storage

    run_dir = os.path.join(tmp, "workers")
    os.makedirs(run_dir)
    unseeded = {k: v for k, v in algo.items() if k != "seed"}
    script, config = write_cli_files(run_dir, unseeded)
    db, log = os.path.join(run_dir, "workers.sqlite"), os.path.join(run_dir, "executions.log")
    prof = os.path.join(run_dir, "profile")
    wall_s = run_cohort([(_cli_command(
        "-n", "cli-workers", "-c", config, "--storage-path", db, "--pool-size", str(q),
        "--max-trials", str(max_trials), "--n-workers", str(workers), "--profile", prof,
        "--device", device.type, script, *CLI_PRIORS, "--log", log,
        "--hold-after", str(q - 5), "--hold-seconds", str(hold_s)), run_dir)], timeout)
    storage = create_storage({"type": "sqlite", "path": db})
    exp_id, trials = _fetch_trials(storage, "cli-workers")
    done, values, err = check_cli_trials("cli workers", trials, max_trials, device)
    with open(log) as handle:
        executed = handle.read().split()
    lies = storage.fetch_lies(exp_id)
    with open(log + ".held") as handle:
        held_id = handle.read()
    held = next(t for t in trials if t.id == held_id)
    per_worker = read_traces(prof)
    launches = sum(w["fused_gram_launches"] for w in per_worker)
    suggest_ms = [doc["duration"] * 1e3 for doc in storage.fetch_timings(exp_id)
                  if doc["op"] == "suggest"]
    out = {"workers": workers, "q": q, "trials": len(trials), "completed": len(done),
           "executed": len(executed), "executed_distinct": len(set(executed)),
           "lies": len(lies), "held_trial_lied_about": any(t.params == held.params for t in lies),
           "wall_s": wall_s, "trials_per_s": len(done) / wall_s,
           "statuses": dict(collections.Counter(t.status for t in trials)),
           "producer_suggest_ms": suggest_ms,
           "regret": float(values.min()) - GLOBAL_MIN, "fused_gram_launches": launches,
           "per_worker": per_worker}
    if len(executed) != len(set(executed)):
        raise AssertionError(f"cli workers: {len(executed)} executions of "
                             f"{len(set(executed))} distinct trials")
    if not {t.id for t in done} <= set(executed):
        raise AssertionError("cli workers: a completed trial never ran")
    if len(per_worker) != workers or not out["held_trial_lied_about"] or launches < 1:
        raise AssertionError(f"cli workers: {len(per_worker)} traces, {len(lies)} lies "
                             f"(held trial among them: {out['held_trial_lied_about']}), "
                             f"{launches} fused_gram launches")
    return out


def run_cli_regret(tmp, device, seeds=None, timeout=600):
    """The regret gate's scenario through ``orion-tpu-torch hunt`` on the
    default backend (``pickled``, in each run's working directory):
    ``--pool-size q``, budget ``--max-trials``, the seed in the YAML; the
    seeds run at once, one process each, traced (``--profile``) to count
    the kernel's launches.  A curve is the incumbent's regret after each
    ``q`` trials in submit order."""
    from orion_tpu_torch.benchmarks.regret_gate import evaluate_regret_gate, load_baseline
    from orion_tpu_torch.storage.base import create_storage

    path = os.path.join(ROOT, "BENCH_REGRET_BASELINE.json")
    with open(path) as handle:
        config = json.load(handle)["config"]
    baseline = load_baseline(path)
    budget, q = config["budget"], config["q"]
    seeds = list(seeds if seeds is not None else range(len(baseline)))
    commands, run_dirs = [], []
    for seed in seeds:
        run_dir = os.path.join(tmp, f"regret-{seed}")
        os.makedirs(run_dir)
        script, cfg = write_cli_files(run_dir, dict(config["algo"]["tpu_bo"], seed=seed))
        commands.append((_cli_command("-n", "regret", "-c", cfg, "--pool-size", str(q),
                                      "--max-trials", str(budget), "--device", device.type,
                                      "--profile", os.path.join(run_dir, "profile"),
                                      script, *CLI_PRIORS), run_dir))
        run_dirs.append(run_dir)
    wall_s = run_cohort(commands, timeout)
    curves, launches = [], 0
    for seed, run_dir in zip(seeds, run_dirs):
        storage = create_storage({"type": "pickled",
                                  "path": os.path.join(run_dir, "orion_tpu_db.pkl")})
        _, trials = _fetch_trials(storage, "regret")
        trials.sort(key=lambda t: (t.submit_time or 0.0, t.id))
        done, values, _ = check_cli_trials(f"cli regret seed {seed}", trials, budget, device)
        curves.append([float(values[: k + q].min()) - GLOBAL_MIN
                       for k in range(0, budget, q)])
        launches += sum(w["fused_gram_launches"]
                        for w in read_traces(os.path.join(run_dir, "profile")))
    verdict = evaluate_regret_gate(curves, baseline)
    return curves, baseline, verdict, launches, wall_s


def interpreter_start_ms(runs=10):
    """Median wall ms of starting this interpreter to run nothing, with its
    ``site`` start-up and with ``-S``: the floor of a trial's process."""
    def median_ms(argv):
        times = []
        for _ in range(runs):
            t0 = time.perf_counter()
            subprocess.run(argv, check=True, timeout=60)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    return {"site": median_ms([sys.executable, "-c", "pass"]),
            "no_site": median_ms([sys.executable, "-S", "-c", "pass"])}


def phase_cli(device, tmp):
    """The CLI worker path: one worker in process, ``CLI_WORKERS`` workers as
    a subprocess, the regret gate through the CLI.  The one-worker hunt's
    store stays in ``tmp`` for the ``evc`` phase.  Returns ``fused_gram``'s
    launches in each run and the eight workers' trials/s."""
    one = run_cli_hunt(tmp, device)
    emit("cli", run="hunt", storage="sqlite", q=CLI_Q,
         interpreter_start_ms=interpreter_start_ms(), **one)
    many = run_cli_workers(tmp, device)
    emit("cli", run="workers", storage="sqlite", **many)
    curves, baseline, verdict, regret_launches, wall_s = run_cli_regret(tmp, device)
    emit("cli", run="regret", storage="pickled", wall_s=wall_s, final=[c[-1] for c in curves],
         baseline_final=[c[-1] for c in baseline], gate=verdict,
         fused_gram_launches=regret_launches)
    if not verdict["pass"]:
        raise AssertionError("regret gate through the CLI failed against "
                             "BENCH_REGRET_BASELINE.json")
    return ({"hunt": one["fused_gram_launches"], "workers": many["fused_gram_launches"],
             "regret": regret_launches}, many["trials_per_s"])


#: The ``evc`` phase: the ``cli`` phase's one-worker hunt (v1) resumed twice
#: with a narrower prior, each branching a child that runs ``EVC_TRIALS``
#: trials of its own: v2 with ``x0 ~ uniform(0, 0.5)``, v3 with ``x1`` too.
EVC_NARROWED = (0, 1)
EVC_TRIALS = 32
EVC_TREE = "cli-v1\n└── cli-v2\n    └── cli-v3\n"


def _cli_output(argv):
    """``orion-tpu-torch`` in this process: (exit code, stdout, wall ms)."""
    import contextlib
    import io

    from orion_tpu_torch import cli

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    return rc, out.getvalue(), (time.perf_counter() - t0) * 1e3


def run_evc_chain(tmp, device, q=CLI_Q, max_trials=EVC_TRIALS, narrowed=EVC_NARROWED,
                  algo=CLI_ALGO):
    """``orion-tpu-torch hunt -n cli`` on the ``cli`` phase's SQLite store,
    once for each dimension of ``narrowed``, each time with that prior
    narrowed to [0, 0.5] as well: every call branches a child of the last
    version, whose producer fetches the family's trials through the EVC tree
    (adapted hop by hop) before its first suggest.  Checks the ``refers``
    chain; that each child's first tree fetch held exactly the ancestors'
    trials inside the child's prior (counted here from the stored params);
    that its first round was a GP round (a ``fused_gram`` launch at the main
    path's shape, no random round); that its rows lie in its prior and its
    objectives are Hartmann6's; then ``audit --all`` and ``list``."""
    from orion_tpu_torch.core.producer import Producer
    from orion_tpu_torch.evc.experiment import TreeTrialsFetcher
    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.storage.base import create_storage

    script, config = write_cli_files(tmp, algo)
    db = os.path.join(tmp, "cli.sqlite")
    fetch, produce = TreeTrialsFetcher.__dict__["fetch"], Producer.__dict__["produce"]
    fetches, produced = [], []

    def counted_fetch(self):
        t0 = time.perf_counter()
        trials = fetch(self)
        family = [t for t in trials if t.experiment != self.node_id]
        fetches.append({"ms": (time.perf_counter() - t0) * 1e3, "trials": len(trials),
                        "family": len(family),
                        "family_completed": sum(t.status == "completed" for t in family)})
        return trials

    bounds, generations = {}, []
    for version, dim in enumerate(narrowed, start=2):
        bounds[dim] = 0.5
        priors = [f"-x{i}~uniform(0, {bounds.get(i, 1)})" for i in range(6)]
        fetches.clear()
        produced.clear()
        TreeTrialsFetcher.fetch = counted_fetch
        Producer.produce = _timed(produce, produced)
        gram.fused_gram.launches = 0
        try:
            with _LaunchShapes() as launch_shapes:
                t0 = time.perf_counter()
                rc, _, _ = _cli_output(["hunt", "-n", "cli", "-c", config, "--storage-path", db,
                                        "--pool-size", str(q), "--max-trials", str(max_trials),
                                        "--device", device.type, script, *priors])
                wall_s = time.perf_counter() - t0
        finally:
            TreeTrialsFetcher.fetch, Producer.produce = fetch, produce
        launches = gram.fused_gram.launches
        if rc != 0:
            raise AssertionError(f"evc v{version}: exit code {rc}")
        storage = create_storage({"type": "sqlite", "path": db})
        exps = {e["version"]: e for e in storage.fetch_experiments({"name": "cli"})}
        child, parent, root = exps[version], exps[version - 1], exps[1]
        if (child["refers"].get("parent_id") != parent["_id"]
                or child["refers"].get("root_id") != root["_id"]):
            raise AssertionError(f"evc v{version}: refers {child['refers']}")
        trials = storage.fetch_trials(uid=child["_id"])
        done, values, err = check_cli_trials(f"evc v{version}", trials, max_trials, device)
        if any(t.params[f"/x{i}"] > hi for t in trials for i, hi in bounds.items()):
            raise AssertionError(f"evc v{version}: a row outside the prior {bounds}")
        ancestors = [t for v in range(1, version) for t in storage.fetch_trials(uid=exps[v]["_id"])]
        inside = [t for t in ancestors
                  if all(0.0 <= t.params[f"/x{i}"] <= hi for i, hi in bounds.items())]
        first = fetches[0] if fetches else {}
        if first.get("family") != len(inside) or first.get("trials") != len(inside):
            raise AssertionError(f"evc v{version}: first tree fetch {first}, expected "
                                 f"{len(inside)} adapted ancestor trials and none of its own")
        if launches < 1 or launch_shapes.shapes[MAIN_SHAPE] < 1:
            raise AssertionError(f"evc v{version}: first round not a GP round: fused_gram "
                                 f"launched {launches} times ({dict(launch_shapes.shapes)})")
        suggest_ms = [doc["duration"] * 1e3 for doc in storage.fetch_timings(child["_id"])
                      if doc["op"] == "suggest"]
        generations.append({
            "version": version, "priors": priors, "wall_s": wall_s,
            "trials": len(trials), "completed": len(done), "trials_per_s": len(done) / wall_s,
            "family_trials_observed": first["family"],
            "family_completed_observed": first["family_completed"],
            "tree_fetch_ms": [f["ms"] for f in fetches],
            "median_tree_fetch_ms": _median([f["ms"] for f in fetches]),
            "producer_suggest_ms": suggest_ms, "median_suggest_ms": _median(suggest_ms),
            "gp_round_ms": produced[0][1], "produce_ms": [ms for _, ms in produced],
            "regret": float(values.min()) - GLOBAL_MIN, "objective_max_abs_err": err,
            "fused_gram_launches": launches,
            "launch_shapes": {"x".join(map(str, k)): v for k, v in launch_shapes.shapes.items()},
        })
    rc, report, audit_ms = _cli_output(["audit", "--all", "--storage-path", db])
    if rc != 0 or "violation(s)" in report:
        raise AssertionError(f"evc: audit --all exited {rc}:\n{report}")
    rc, tree, list_ms = _cli_output(["list", "--storage-path", db])
    if rc != 0 or tree != EVC_TREE:
        raise AssertionError(f"evc: list exited {rc} and printed {tree!r}")
    return {"generations": generations, "audit_ms": audit_ms, "audit": report.splitlines(),
            "list_ms": list_ms, "list": tree.splitlines()}


def check_sqlite_non_finite(tmp):
    """On this host's SQLite: a trial holding NaN, and a reservation claim
    completing another with an infinite objective, through the port's
    ``SQLiteDB`` with its partial field indexes; the worker loop's count
    reads the field index and ``json_valid`` rejects NaN, as the indexes
    assume on every SQLite."""
    import sqlite3

    from orion_tpu_torch.storage import sqlitedb

    db = sqlitedb.SQLiteDB(os.path.join(tmp, "non-finite.sqlite"))
    doc = {"_id": "a", "experiment": "e", "status": "reserved", "results": []}
    db.write("trials", dict(doc))
    db.write("trials", dict(doc, _id="b", results=[
        {"name": "o", "type": "objective", "value": float("nan")}]))
    done = db.read_and_write("trials", {"experiment": "e", "status": "reserved"}, {
        "$set": {"status": "completed",
                 "results": [{"name": "o", "type": "objective", "value": float("inf")}]}})
    completed = db.count("trials", {"experiment": "e", "status": "completed"})
    conn = db._conn()
    nonstandard = conn.execute(
        f"SELECT COUNT(*) FROM docs WHERE NOT {sqlitedb._VALID_JSON}").fetchone()[0]
    clauses, params = db._sql_prefilter({"experiment": "e", "status": "completed"})
    plan = conn.execute("EXPLAIN QUERY PLAN SELECT COUNT(*) FROM docs WHERE collection = ? AND "
                        + " AND ".join([sqlitedb._VALID_JSON, *clauses]),
                        ("trials", *params)).fetchall()[0][-1]
    json_valid_nan = conn.execute("SELECT json_valid('[NaN]')").fetchone()[0]
    out = {"sqlite": sqlite3.sqlite_version, "json_valid_nan": json_valid_nan,
           "completed": completed, "nonstandard_docs": nonstandard, "count_plan": plan}
    if (done["_id"] != "a" or completed != 1 or nonstandard != 2 or json_valid_nan != 0
            or "docs_valid_experiment_status" not in plan):
        raise AssertionError(f"sqlite non-finite check: {out}")
    return out


def phase_evc(device, tmp):
    """EVC branching through the CLI on the ``cli`` phase's store, and the
    SQLite non-finite check.  Returns ``fused_gram``'s launches."""
    chain = run_evc_chain(tmp, device)
    emit("evc", storage="sqlite", q=CLI_Q, sqlite_non_finite=check_sqlite_non_finite(tmp),
         **chain)
    return sum(g["fused_gram_launches"] for g in chain["generations"])


#: The ``telemetry`` phase: (a) main-path rounds with the registry off and
#: on, alternating; (b) a four-worker CLI hunt with ``telemetry: true`` and
#: a ``/metrics`` port; (c) the flight recorder's dumps.
TELEMETRY_ROUNDS = 6
TELEMETRY_WORKERS = 4
TELEMETRY_TRIALS = 16  # past the seeded history and its pending trials
#: The fleets' store holds ``HISTORY`` completed trials and this many left
#: pending, as a random round partly run: the workers run them out, then
#: every worker finds the queue empty at once and pays its own GP round.
#: Enough that the three spawned workers start before they are gone.
TELEMETRY_PENDING = 384
PROM_LINE = re.compile(
    r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{([a-zA-Z_][a-zA-Z0-9_]*="(\\.|[^"\\])*",?)*\})? '
    r'(-?[0-9.eE+-]+|\+Inf|-Inf|NaN)$')


def run_telemetry_cost(device, q=Q, rounds=TELEMETRY_ROUNDS):
    """The main path's ``tpu_bo`` (130 observed, q=1024) for ``2 * rounds``
    rounds, one of each pair with ``TELEMETRY``/``FLIGHT`` off, the other on,
    alternating which goes first: both draw from one copy of the algorithm
    (its generator state included), so their rows must be equal.  Returns
    the median round ms of each, their ratio, the ``suggest_step.dispatch``
    spans, and the kernel's launches over the rounds."""
    import copy

    from orion_tpu_torch.health import FLIGHT
    from orion_tpu_torch.ops.gram import fused_gram
    from orion_tpu_torch.telemetry import TELEMETRY

    rng = np.random.default_rng(1)
    algo = _make_algo(1, device)
    x = rng.uniform(size=(N_HISTORY, 6)).astype(np.float32)
    _observe(algo, x, _hartmann6(x))
    algo.suggest(q)  # warm-up
    TELEMETRY.reset()
    FLIGHT.clear()
    times = {"off": [], "on": []}
    fused_gram.launches = 0
    try:
        for k in range(rounds):
            xn = rng.uniform(size=(16, 6)).astype(np.float32)
            _observe(algo, xn, _hartmann6(xn))
            twin = copy.deepcopy(algo)
            rows = {}
            for mode in (("off", "on") if k % 2 == 0 else ("on", "off")):
                target = algo if mode == "off" else twin
                if mode == "on":
                    TELEMETRY.enable()
                    FLIGHT.enable()
                _sync(device)
                t0 = time.perf_counter()
                rows[mode] = target.suggest_batch(q).cube
                _sync(device)
                times[mode].append((time.perf_counter() - t0) * 1e3)
                TELEMETRY.disable()
                FLIGHT.disable()
            if not np.array_equal(rows["off"], rows["on"]):
                raise AssertionError(f"telemetry: round {k} rows differ with telemetry on "
                                     f"({int((rows['off'] != rows['on']).any(1).sum())} rows)")
    finally:
        TELEMETRY.disable()
        FLIGHT.disable()
    launches = fused_gram.launches
    spans = [s for s in TELEMETRY.iter_spans() if s["name"] == "suggest_step.dispatch"]
    TELEMETRY.reset()
    if len(spans) != rounds or launches < 2 * rounds:
        raise AssertionError(f"telemetry: {len(spans)} dispatch spans over {rounds} rounds on, "
                             f"fused_gram launched {launches} times in {2 * rounds} rounds")
    off, on = statistics.median(times["off"]), statistics.median(times["on"])
    return {"q": q, "rounds_each": rounds, "round_ms": times, "median_round_ms_off": off,
            "median_round_ms_on": on, "on_over_off": on / off, "rows_equal": True,
            "dispatch_spans": len(spans),
            "median_dispatch_ms": statistics.median(s["dur"] * 1e3 for s in spans),
            "dispatch_args": spans[0].get("args"), "fused_gram_launches": launches}


def _free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _http_get(port, path):
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=5) as resp:
        return resp.status, resp.headers.get("Content-Type"), resp.read().decode()


def parse_exposition(text):
    """Prometheus text exposition (0.0.4) -> ``{sample name with labels:
    value}``; raises on a line that is neither a ``# TYPE`` line nor a
    sample."""
    samples = {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            if len(line.split()) != 4:
                raise AssertionError(f"bad TYPE line {line!r}")
            continue
        if not PROM_LINE.match(line):
            raise AssertionError(f"not Prometheus text: {line!r}")
        name, value = line.rsplit(" ", 1)
        samples[name] = float(value)
    return samples


def _scrape(port, until, period=2.0):
    """Scrape ``/metrics`` and ``/healthz`` every ``period`` s while
    ``until()`` is false; a refused connection (the worker's server not up
    yet) is skipped.  Returns ``(t, txn count, samples, healthz)`` per
    scrape."""
    scrapes = []
    t0 = time.perf_counter()
    while not until():
        try:
            status, ctype, text = _http_get(port, "/metrics")
            hstatus, _, health = _http_get(port, "/healthz")
        except OSError:
            time.sleep(0.2)
            continue
        if status != 200 or hstatus != 200 or "version=0.0.4" not in (ctype or ""):
            raise AssertionError(f"telemetry: /metrics {status} {ctype}, /healthz {hstatus}")
        samples = parse_exposition(text)
        scrapes.append((time.perf_counter() - t0,
                        samples.get("orion_tpu_storage_sqlite_txn_seconds_count", 0.0),
                        len(samples), json.loads(health)))
        time.sleep(period)
    return scrapes


def run_fleet(tmp, device, telemetry, workers=TELEMETRY_WORKERS, max_trials=TELEMETRY_TRIALS,
              q=CLI_Q, algo=CLI_ALGO, timeout=400, pending=TELEMETRY_PENDING):
    """``hunt --n-workers 4 --profile`` on a SQLite file seeded with
    ``HISTORY`` completed trials and ``pending`` more left to run
    (:func:`seed_history`, the experiment created with the algorithm's YAML
    alone), ``max_trials`` past them, with ``telemetry:`` on or off in the
    config; on, with a free ``metrics_port`` that is scraped while the hunt
    runs.  Checks the trials, and reads ``fused_gram``'s launches and their
    shapes from the workers' traces: at least one at ``MAIN_SHAPE``."""
    import threading

    import yaml

    from orion_tpu_torch.storage.base import create_storage

    run_dir = os.path.join(tmp, "telemetry" if telemetry else "telemetry-off")
    os.makedirs(run_dir)
    unseeded = {k: v for k, v in algo.items() if k != "seed"}
    script, algo_config = write_cli_files(run_dir, unseeded)
    port = _free_port() if telemetry else None
    config = os.path.join(run_dir, "telemetry.yaml")
    with open(config, "w") as handle:
        yaml.safe_dump({"telemetry": telemetry, "algorithms": {"tpu_bo": unseeded},
                        **({"metrics_port": port} if telemetry else {})}, handle)
    db, prof = os.path.join(run_dir, "telemetry.sqlite"), os.path.join(run_dir, "profile")
    history = seed_history(create_storage({"type": "sqlite", "path": db}), "tel",
                           ["-c", algo_config, "--storage-path", db], script, None, device,
                           pending=pending)
    total = HISTORY + pending + max_trials
    done_event, result = threading.Event(), {}

    def hunt():
        try:
            result["wall_s"] = run_cohort([(_cli_command(
                "-n", "tel", "-c", config, "--storage-path", db, "--pool-size", str(q),
                "--max-trials", str(total), "--n-workers", str(workers), "--profile", prof,
                "--device", device.type, script, *CLI_PRIORS), run_dir)], timeout)
        except BaseException as exc:  # re-raised below, in the phase's thread
            result["error"] = exc
        finally:
            done_event.set()

    thread = threading.Thread(target=hunt)
    thread.start()
    scrapes = _scrape(port, done_event.is_set) if telemetry else []
    thread.join()
    if "error" in result:
        raise result["error"]
    storage = create_storage({"type": "sqlite", "path": db})
    exp_id, trials = _fetch_trials(storage, "tel")
    done, values, err = check_cli_trials(f"telemetry fleet ({'on' if telemetry else 'off'})",
                                         trials, total, device)
    per_worker = read_traces(prof)
    shapes = collections.Counter()
    for w in per_worker:
        shapes.update(w["launch_shapes"])
    main = "x".join(map(str, MAIN_SHAPE))
    if len(per_worker) != workers or shapes[main] < 1:
        raise AssertionError(f"telemetry fleet: {len(per_worker)} traces, fused_gram launched "
                             f"at {dict(shapes)} (none at {main})")
    return {"telemetry": telemetry, "db": db, "storage": storage, "exp_id": exp_id,
            "trials": trials, "done": done, "values": values, "err": err,
            "ran": [t for t in done if t.id not in history],
            "wall_s": result["wall_s"], "scrapes": scrapes, "per_worker": per_worker,
            "launches": sum(w["fused_gram_launches"] for w in per_worker),
            "launch_shapes": dict(shapes), "unseeded": unseeded, "run_dir": run_dir}


def run_telemetry_fleet(tmp, device, off_first=False, workers=TELEMETRY_WORKERS,
                        max_trials=TELEMETRY_TRIALS):
    """:func:`run_fleet` with telemetry off and on, in the order
    ``off_first`` says; then over the telemetry run's store, ``metrics``,
    ``trace`` (Chrome and ``--attribute``) and ``flight-record``, each
    checked."""
    from orion_tpu_torch.algo.gp.kernels import _FUSED_MIN_WORK
    from orion_tpu_torch.storage.base import DocumentStorage

    runs = {}
    for telemetry in ((False, True) if off_first else (True, False)):
        runs[telemetry] = run_fleet(tmp, device, telemetry, workers, max_trials)
    on, off = runs[True], runs[False]
    scrapes, run_dir, storage, exp_id = on["scrapes"], on["run_dir"], on["storage"], on["exp_id"]
    # The workers' own completions: the seeded history's went through the
    # library, outside every worker's registry.
    done = on["ran"]
    cmd = ["--storage-path", on["db"], "-n", "tel"]

    rc, body, metrics_ms = _cli_output(["metrics", *cmd])
    merged = parse_exposition(body)
    docs = storage.fetch_metrics(exp_id)
    completions = merged.get("orion_tpu_storage_sqlite_update_completed_trial_seconds_count")
    reserves = merged.get("orion_tpu_storage_sqlite_reserve_trial_seconds_count", 0.0)
    if rc != 0 or len(docs) != workers or completions != len(done) or reserves < len(done):
        raise AssertionError(f"telemetry: metrics exited {rc} over {len(docs)} snapshots, "
                             f"{completions} completions and {reserves} reservations for "
                             f"{len(done)} completed trials")

    chrome = os.path.join(run_dir, "trace.json")
    rc, out, trace_ms = _cli_output(["trace", *cmd, "--out", chrome])
    with open(chrome) as handle:
        events = json.load(handle)["traceEvents"]
    spans = storage.fetch_spans(exp_id)
    rounds = [e for e in events if e.get("name") == "producer.round" and e.get("ph") == "X"]
    round_ids = {s["span_id"] for s in spans if s["name"] == "producer.round"}
    nested = [s for s in spans if s["name"].startswith("storage.")
              and s.get("parent_span_id") in round_ids]
    contained = sum(
        1 for e in events if e.get("ph") == "X" and e["name"].startswith("storage.")
        and any(r["pid"] == e["pid"] and r["ts"] <= e["ts"]
                and e["ts"] + e["dur"] <= r["ts"] + r["dur"] for r in rounds))
    # A GP round books suggest_step.capture when it captured its signature
    # (each worker's first), suggest_step.dispatch when it replayed.
    dispatch = [s for s in spans if s["name"] in ("suggest_step.dispatch",
                                                  "suggest_step.capture")]
    if (rc != 0 or len({e["pid"] for e in rounds}) != workers or not nested or not contained
            or not dispatch):
        raise AssertionError(f"telemetry: trace exited {rc}: producer.round on "
                             f"{len({e['pid'] for e in rounds})} pids, {len(nested)} storage "
                             f"spans parented in a round ({contained} contained), "
                             f"{len(dispatch)} suggest_step.dispatch")
    rc, table, _ = _cli_output(["trace", *cmd, "--out", os.path.join(run_dir, "t2.json"),
                                "--attribute"])
    if rc != 0 or "producer.round" not in table or "mean of" not in table:
        raise AssertionError(f"telemetry: trace --attribute exited {rc}:\n{table}")

    flight = os.path.join(run_dir, "flight.jsonl")
    rc, _, _ = _cli_output(["flight-record", *cmd, "--out", flight])
    with open(flight) as handle:
        lines = [json.loads(line) for line in handle]
    kinds = collections.Counter(e.get("kind") for e in lines[1:])
    if rc != 0 or lines[0].get("type") != "flight-record" or not kinds["producer.round"]:
        raise AssertionError(f"telemetry: flight-record exited {rc}, events {dict(kinds)}")

    # The pool's cross-gram is n_candidates x (rows of the GP's buffer) x d:
    # the round span's ``n`` names the buffer, and each GP round whose work
    # reaches the fused route launches the kernel once.
    d = MAIN_SHAPE[2]
    fused = [s for s in dispatch
             if on["unseeded"]["n_candidates"] * s["args"]["n"] * d >= _FUSED_MIN_WORK]
    # Below the cap nothing was pruned, so every GP round's span is here.
    pruned = len(spans) >= int(DocumentStorage.SPANS_CAP * 0.9)
    launches = on["launches"]
    if launches < len(fused) or (not pruned and launches != len(fused)):
        raise AssertionError(f"telemetry: fused_gram launched {launches} times in the traces "
                             f"({on['launch_shapes']}), {len(fused)} GP rounds on the fused "
                             "route by their dispatch spans")
    names = collections.Counter(s["name"] for s in spans)

    def rate(run):
        return len(run["ran"]) / run["wall_s"]

    return {
        "workers": workers, "q": CLI_Q, "history": HISTORY, "pending": TELEMETRY_PENDING,
        "trials": len(on["trials"]), "completed": len(done),
        "order": ["off", "on"] if off_first else ["on", "off"],
        "wall_s": on["wall_s"], "trials_per_s": rate(on),
        "off": {"trials": len(off["trials"]), "completed": len(off["ran"]),
                "wall_s": off["wall_s"], "trials_per_s": rate(off),
                "regret": float(off["values"].min()) - GLOBAL_MIN,
                "fused_gram_launches": off["launches"], "launch_shapes": off["launch_shapes"],
                "per_worker": off["per_worker"]},
        "on_over_off_trials_per_s": rate(on) / rate(off),
        "regret": float(on["values"].min()) - GLOBAL_MIN, "objective_max_abs_err": on["err"],
        "scrapes": [{"t_s": t, "sqlite_txn_count": c, "samples": n} for t, c, n, _ in scrapes],
        "merged_snapshots": len(docs), "completions": completions, "reservations": reserves,
        "metrics_ms": metrics_ms, "trace_ms": trace_ms,
        "stored_spans": len(spans), "pruned": pruned, "spans_by_name": dict(names.most_common(12)),
        "round_pids": len({e["pid"] for e in rounds}), "storage_spans_in_rounds": len(nested),
        "dispatch_spans": len(dispatch), "dispatch_n": sorted({s["args"]["n"] for s in dispatch}),
        "dispatch_fused_rounds": len(fused),
        "flight_events": dict(kinds),
        "merged": {k: merged[k] for k in sorted(merged) if k.endswith(("_total", "_count"))},
        "fused_gram_launches": launches,
        "launch_shapes": on["launch_shapes"],
        "per_worker": on["per_worker"],
    }


def run_telemetry_dumps(tmp, device, fleet_db, algo=CLI_ALGO, timeout=120):
    """A single-worker ``hunt`` with ``telemetry: true`` interrupted by
    SIGINT mid-run must leave ``flight-<name>-<pid>.jsonl`` holding
    ``producer.round`` events; ``audit --flight-out`` on a copy of the
    fleet's store with one completed trial's results removed must exit 1
    and write a dump holding an ``audit.violation`` event."""
    import signal
    import sqlite3

    import yaml

    from orion_tpu_torch.storage.base import create_storage

    run_dir = os.path.join(tmp, "sigint")
    os.makedirs(run_dir)
    script, _ = write_cli_files(run_dir, algo)
    config = os.path.join(run_dir, "sigint.yaml")
    with open(config, "w") as handle:
        yaml.safe_dump({"telemetry": True, "algorithms": {"tpu_bo": dict(algo)}}, handle)
    db = os.path.join(run_dir, "sigint.sqlite")
    proc = subprocess.Popen(_cli_command(
        "-n", "sig", "-c", config, "--storage-path", db, "--pool-size", "64",
        "--max-trials", "100000", "--device", device.type, script, *CLI_PRIORS),
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=run_dir, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True, start_new_session=True)
    t0 = time.perf_counter()
    try:
        completed = 0
        while completed < 80:
            if proc.poll() is not None or time.perf_counter() - t0 > timeout:
                raise AssertionError(f"telemetry: the interrupted hunt ended early "
                                     f"({proc.poll()}) or never ran 80 trials")
            time.sleep(0.5)
            if os.path.exists(db):
                completed = create_storage({"type": "sqlite", "path": db}).db.count(
                    "trials", {"status": "completed"})
        os.kill(proc.pid, signal.SIGINT)
        _, err = proc.communicate(timeout=60)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    dump = os.path.join(run_dir, f"flight-sig-{proc.pid}.jsonl")
    if not os.path.exists(dump):
        raise AssertionError(f"telemetry: no crash dump after SIGINT (exit {proc.returncode}): "
                             f"{err[-2000:]}")
    with open(dump) as handle:
        crash = [json.loads(line) for line in handle]
    crash_kinds = collections.Counter(e.get("kind") for e in crash[1:])
    if crash[0].get("reason") != "crash" or not crash_kinds["producer.round"]:
        raise AssertionError(f"telemetry: crash dump {crash[0]} with {dict(crash_kinds)}")

    copy_db = os.path.join(run_dir, "audit-copy.sqlite")
    src, dst = sqlite3.connect(fleet_db), sqlite3.connect(copy_db)
    src.backup(dst)
    src.close()
    dst.close()
    storage = create_storage({"type": "sqlite", "path": copy_db})
    [exp] = storage.fetch_experiments({"name": "tel"})
    victim = storage.db.read("trials", {"experiment": exp["_id"], "status": "completed"})[0]
    storage.db.write("trials", {"results": []}, query={"_id": victim["_id"]})
    flight = os.path.join(run_dir, "audit-flight.jsonl")
    rc, report, audit_ms = _cli_output(["audit", "-n", "tel", "--storage-path", copy_db,
                                        "--flight-out", flight])
    with open(flight) as handle:
        audit_lines = [json.loads(line) for line in handle]
    violations = [e for e in audit_lines[1:] if e.get("kind") == "audit.violation"]
    if rc == 0 or audit_lines[0].get("reason") != "audit-failure" or not violations:
        raise AssertionError(f"telemetry: audit --flight-out exited {rc}, "
                             f"{len(violations)} violation events:\n{report}")
    return {"sigint": {"exit_code": proc.returncode, "completed_before": completed,
                       "dump_events": dict(crash_kinds)},
            "audit": {"exit_code": rc, "ms": audit_ms, "violations": len(violations),
                      "first": violations[0]["args"]}}


def phase_telemetry(device, tmp, cli_workers_trials_per_s, fleet_off_first=False):
    """The telemetry plane: its cost on the main path, a four-worker hunt
    with it off and on, and its dumps.  Returns ``fused_gram``'s launches
    and the four workers' trials/s with telemetry on."""
    cost = run_telemetry_cost(device)
    emit("telemetry", run="cost", **cost)
    fleet = run_telemetry_fleet(tmp, device, off_first=fleet_off_first)
    emit("telemetry", run="fleet", storage="sqlite",
         cli_eight_workers_trials_per_s=cli_workers_trials_per_s, **fleet)
    dumps = run_telemetry_dumps(tmp, device, os.path.join(tmp, "telemetry", "telemetry.sqlite"))
    emit("telemetry", run="dumps", **dumps)
    return ({"cost": cost["fused_gram_launches"], "fleet": fleet["fused_gram_launches"],
             "fleet_off": fleet["off"]["fused_gram_launches"]}, fleet["trials_per_s"])


#: The ``network`` phase: workers over ``orion-tpu-torch db serve`` (one
#: server, then a replicated two-shard plane), the main path's width.
NETWORK_WORKERS = 4
NETWORK_TRIALS = 64  # past the seeded HISTORY
SHARD_WORKERS = 2
SHARD_TRIALS = 64  # past the seeded HISTORY
#: A synchronous write waits this long for its replica's ack: a GP round
#: registers q=1024 documents carrying their lineage (~37 MB), which the
#: replica decodes and applies in seconds (the server's default is 2.0).
QUORUM_TIMEOUT_S = 60.0


@contextlib.contextmanager
def _environ(**values):
    """``os.environ`` with ``values`` set for the block (the in-process CLI
    commands read the ``ORION_DB_*`` storage variables)."""
    saved = {key: os.environ.get(key) for key in values}
    os.environ.update(values)
    try:
        yield
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value


def compute_apps():
    """The pids ``nvidia-smi --query-compute-apps`` lists.  They come from
    the host's pid namespace: inside a container they need not match
    ``os.getpid()``."""
    out = subprocess.run(["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    return sorted(int(p) for p in out.split() if p.strip().isdigit())


def nvidia_files(pid):
    """The ``/dev/nvidia*`` files process ``pid`` holds open or mapped."""
    found = set()
    fd_dir = f"/proc/{pid}/fd"
    for fd in os.listdir(fd_dir):
        try:
            target = os.readlink(os.path.join(fd_dir, fd))
        except OSError:
            continue
        if target.startswith("/dev/nvidia"):
            found.add(target)
    with open(f"/proc/{pid}/maps") as handle:
        found.update(line.split()[-1] for line in handle if "/dev/nvidia" in line)
    return sorted(found)


class DBServers:
    """``python3 -m orion_tpu_torch.cli db serve --host 127.0.0.1 --port 0
    ...`` processes, each in a session of its own with the package root on
    its ``PYTHONPATH`` and its output in ``<name>.log`` under ``run_dir``.
    Leaving the block stops each with SIGINT (a clean shutdown, exit 0) and
    kills whatever is left; a server that exits otherwise fails the
    phase."""

    def __init__(self, run_dir, device):
        self.run_dir = run_dir
        self.procs = {}
        # This process holds a context before the count is taken: it is the
        # positive control of check_host_only.
        torch.zeros(1, device=device)
        _sync(device)
        self.apps_before = compute_apps()

    def __enter__(self):
        return self

    def start(self, *servers, timeout=120):
        """Start servers side by side, each given as ``(name, args)``;
        returns their ``host:port`` from their listening lines (the OS
        picks free ports)."""
        logs = {}
        for name, args in servers:
            logs[name] = os.path.join(self.run_dir, f"{name}.log")
            with open(logs[name], "w") as handle:
                self.procs[name] = subprocess.Popen(
                    [sys.executable, "-m", "orion_tpu_torch.cli", "db", "serve", "--host",
                     "127.0.0.1", "--port", "0", *args],
                    env=dict(os.environ, PYTHONPATH=ROOT, PYTHONUNBUFFERED="1",
                             ORION_TPU_TELEMETRY="1"),
                    cwd=self.run_dir, stdout=handle, stderr=subprocess.STDOUT,
                    start_new_session=True)
        t0, addresses = time.perf_counter(), {}
        while len(addresses) < len(servers):
            for name, _ in servers:
                with open(logs[name]) as handle:
                    text = handle.read()
                match = re.search(r"listening on (\S+) ", text)
                if match:
                    addresses[name] = match.group(1)
                elif self.procs[name].poll() is not None or time.perf_counter() - t0 > timeout:
                    raise AssertionError(f"network: server {name} did not start "
                                         f"(exit {self.procs[name].poll()}):\n{text[-3000:]}")
            time.sleep(0.1)
        return [addresses[name] for name, _ in servers]

    def pids(self):
        return {name: proc.pid for name, proc in self.procs.items()}

    def stop(self, *names):
        """Stop the named servers as leaving the block does (SIGINT, a
        clean exit 0)."""
        for name in names:
            proc = self.procs.pop(name)
            proc.send_signal(signal.SIGINT)
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                os.killpg(proc.pid, 9)
                proc.wait()
                rc = None
            if rc != 0:
                raise AssertionError(f"network: server {name} did not stop cleanly ({rc})")

    def check_host_only(self):
        """No server ever initialized CUDA: none holds a ``/dev/nvidia*``
        file open or mapped (CUDA opens them at a process's first call
        into it; importing torch maps ``libcuda`` but opens none),
        while this process, which holds a context, does; ``nvidia-smi``
        lists as many compute apps as before the servers started, and none
        of their pids.  Returns what ``nvidia-smi`` listed."""
        if not nvidia_files(os.getpid()):
            raise AssertionError("network: this process holds a CUDA context, yet no "
                                 "/dev/nvidia* file shows in its /proc entries")
        apps = compute_apps()
        for name, pid in self.pids().items():
            files = nvidia_files(pid)
            if files or pid in apps:
                raise AssertionError(f"network: server {name} (pid {pid}) initialized CUDA "
                                     f"({files}; compute apps {apps})")
        if len(apps) != len(self.apps_before):
            raise AssertionError(f"network: {len(apps)} compute apps with the servers up, "
                                 f"{len(self.apps_before)} before they started")
        return apps

    def __exit__(self, *exc_info):
        failed = []
        for proc in self.procs.values():
            if proc.poll() is None:
                proc.send_signal(signal.SIGINT)
        for name, proc in self.procs.items():
            try:
                rc = proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                rc = None
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
            if rc != 0:
                failed.append((name, rc))
        if failed and exc_info[0] is None:
            raise AssertionError(f"network: servers did not stop cleanly: {failed}")
        return False


def _secret_file(run_dir):
    import secrets

    path = os.path.join(run_dir, "net.secret")
    with open(path, "w") as handle:
        handle.write(secrets.token_hex(32) + "\n")
    return path


def _wire_ms(storage, exp_id, backend):
    """Per-trial p50 ms of the workers' reservation and completion over the
    wire, and of one wire round trip, from their merged telemetry."""
    from orion_tpu_torch.telemetry import histogram_percentile, merge_snapshots

    histograms = merge_snapshots(storage.fetch_metrics(exp_id)).get("histograms") or {}
    out = {}
    for key, name in (("reserve", f"storage.{backend}.reserve_trial"),
                      ("complete", f"storage.{backend}.update_completed_trial"),
                      ("rtt", "storage.network.rtt")):
        hist = histograms.get(name)
        if hist and hist.get("count"):
            out[key] = {"p50_ms": histogram_percentile(hist, 50) * 1e3,
                        "p99_ms": histogram_percentile(hist, 99) * 1e3,
                        "count": hist["count"]}
    return out


#: Completed trials an experiment of the ``network`` and ``day2`` fleets
#: starts from: a 256-row history and none pending, so the workers' first
#: rounds are GP rounds at ``MAIN_SHAPE`` (without it each fleet first runs
#: a random round of 1024 trials through the script).
HISTORY = 256


def seed_history(storage, name, init_args, script, log, device, completed=HISTORY, seed=0,
                 pending=0):
    """``init-only -n NAME INIT_ARGS`` with the user arguments a later
    ``hunt`` passes (the script, the priors and ``--log LOG`` if given), so
    that it resumes the experiment, then ``completed`` random trials
    registered and completed through the library on ``storage``: Hartmann6
    at their points; then ``pending`` more random trials registered and
    left for the workers, as a random round partly run would leave them.
    Returns the completed trials' ids."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.core.trial import Result, Trial

    user_args = [script, *CLI_PRIORS, *(["--log", log] if log else [])]
    rc, out, _ = _cli_output(["init-only", "-n", name, *init_args, *user_args])
    if rc != 0:
        raise AssertionError(f"init-only {name} exited {rc}: {out}")
    exp = build_experiment(storage, name)
    rows = np.random.default_rng(seed).uniform(size=(completed, 6)).astype(np.float32)
    values = hartmann6(torch.from_numpy(rows).to(device)).cpu().numpy()
    exp.register_trials([Trial(params={f"/x{i}": float(r[i]) for i in range(6)})
                         for r in rows])
    by_point = {tuple(float(v) for v in r): float(y) for r, y in zip(rows, values)}
    while storage.count_completed_trials(exp.id) < completed:
        trials = exp.reserve_trials(completed)
        exp.update_completed_trials([
            (t, [Result("objective", "objective",
                        by_point[tuple(t.params[f"/x{i}"] for i in range(6))])])
            for t in trials])
    history = {t.id for t in exp.fetch_trials()}
    if len(history) != completed:
        raise AssertionError(f"{name}: {len(history)} trials beside a history of {completed}")
    if pending:
        rows = np.random.default_rng(seed + 1).uniform(size=(pending, 6)).astype(np.float32)
        exp.register_trials([Trial(params={f"/x{i}": float(r[i]) for i in range(6)})
                             for r in rows])
    return history


def _check_fleet(name, storage, log, prof, max_trials, device, history):
    """A hunt's trials in ``storage``, ``max_trials`` past the seeded
    ``history``: the objectives, no trial run twice (the user script logs
    each execution), completed past the history equal to the distinct
    executions, and the kernel launched at ``MAIN_SHAPE`` in the workers'
    traces."""
    exp_id, trials = _fetch_trials(storage, name)
    done, values, err = check_cli_trials(f"network {name}", trials, len(history) + max_trials,
                                         device)
    done = [t for t in done if t.id not in history]
    with open(log) as handle:
        executed = handle.read().split()
    if len(executed) != len(set(executed)):
        raise AssertionError(f"network {name}: {len(executed)} executions of "
                             f"{len(set(executed))} distinct trials")
    if {t.id for t in done} != set(executed):
        raise AssertionError(f"network {name}: {len(done)} completed trials against "
                             f"{len(set(executed))} executed")
    per_worker = read_traces(prof)
    shapes = collections.Counter()
    for worker in per_worker:
        shapes.update(worker["launch_shapes"])
    main = "x".join(map(str, MAIN_SHAPE))
    if shapes[main] < 1:
        raise AssertionError(f"network {name}: fused_gram launched at {dict(shapes)} "
                             f"(none at {main})")
    return {"exp_id": exp_id, "trials": trials, "done": done, "values": values, "err": err,
            "executed": executed, "per_worker": per_worker, "launch_shapes": dict(shapes),
            "launches": sum(w["fused_gram_launches"] for w in per_worker)}


def run_network_server(tmp, device, workers=NETWORK_WORKERS, max_trials=NETWORK_TRIALS,
                       q=CLI_Q, algo=CLI_ALGO, timeout=400):
    """(a) ``db serve`` with ``--persist`` SQLite and a secret file; ``hunt
    --n-workers 4 --profile`` with ``telemetry: true`` through
    ``ORION_DB_TYPE=network``, ``ORION_DB_ADDRESS`` and
    ``ORION_DB_SECRET_FILE``; then every completion read back from the
    server, ``audit`` and ``trace --distributed`` (server spans joined),
    and after the server's clean shutdown from its SQLite file."""
    import yaml

    from orion_tpu_torch.storage.base import create_storage

    run_dir = os.path.join(tmp, "network")
    os.makedirs(run_dir)
    secret = _secret_file(run_dir)
    persist = os.path.join(run_dir, "net.sqlite")
    unseeded = {k: v for k, v in algo.items() if k != "seed"}
    script, _ = write_cli_files(run_dir, unseeded)
    config = os.path.join(run_dir, "net.yaml")
    with open(config, "w") as handle:
        yaml.safe_dump({"telemetry": True, "algorithms": {"tpu_bo": unseeded}}, handle)
    log, prof = os.path.join(run_dir, "executions.log"), os.path.join(run_dir, "profile")
    with DBServers(run_dir, device) as servers:
        [address] = servers.start(("server", ["--persist", persist, "--secret-file", secret]))
        env = {"ORION_DB_TYPE": "network", "ORION_DB_ADDRESS": address,
               "ORION_DB_SECRET_FILE": secret}
        storage = create_storage({"type": "network", "address": address,
                                  "secret_file": secret})
        with _environ(**env):
            history = seed_history(storage, "net", ["-c", config], script, log, device)
        wall_s = run_cohort([(_cli_command(
            "-n", "net", "-c", config, "--pool-size", str(q), "--max-trials",
            str(HISTORY + max_trials), "--n-workers", str(workers), "--profile", prof,
            "--device", device.type, script, *CLI_PRIORS, "--log", log), run_dir)], timeout,
            env=env)
        t0 = time.perf_counter()
        fleet = _check_fleet("net", storage, log, prof, max_trials, device, history)
        check_ms = (time.perf_counter() - t0) * 1e3
        served = {d["_id"] for d in storage.db.read(
            "trials", {"experiment": fleet["exp_id"], "status": "completed"},
            projection={"_id": 1})} - history
        if served != set(fleet["executed"]):
            raise AssertionError(f"network: {len(served)} completions read back from the "
                                 f"server, {len(set(fleet['executed']))} acknowledged")
        with _environ(**env):
            audit_rc, audit_out, audit_ms = _cli_output(["audit", "-n", "net"])
            chrome = os.path.join(run_dir, "trace.json")
            trace_rc, _, trace_ms = _cli_output(["trace", "-n", "net", "--distributed",
                                                 "--out", chrome])
        with open(chrome) as handle:
            events = json.load(handle)["traceEvents"]
        server_spans = collections.Counter(
            (e.get("args") or {}).get("op") for e in events if e.get("name") == "netdb.apply")
        if audit_rc != 0 or trace_rc != 0 or not server_spans:
            raise AssertionError(f"network: audit exited {audit_rc}, trace --distributed "
                                 f"{trace_rc} with {dict(server_spans)} server spans:\n"
                                 f"{audit_out}")
        wire = _wire_ms(storage, fleet["exp_id"], "network")
        compute_apps = servers.check_host_only()
        server_pids = servers.pids()
    t0 = time.perf_counter()
    durable = {d["_id"] for d in create_storage({"type": "sqlite", "path": persist}).db.read(
        "trials", {"experiment": fleet["exp_id"], "status": "completed"},
        projection={"_id": 1})} - history
    durable_ms = (time.perf_counter() - t0) * 1e3
    if durable != served:
        raise AssertionError(f"network: {len(durable)} completions in the server's SQLite "
                             f"file after shutdown, {len(served)} served")
    return {"workers": workers, "q": q, "trials": len(fleet["trials"]),
            "completed": len(fleet["done"]), "executed": len(fleet["executed"]),
            "executed_distinct": len(set(fleet["executed"])), "read_back": len(served),
            "durable": len(durable), "wall_s": wall_s,
            "trials_per_s": len(fleet["done"]) / wall_s,
            "regret": float(fleet["values"].min()) - GLOBAL_MIN,
            "objective_max_abs_err": fleet["err"], "wire_ms_per_trial": wire,
            "check_ms": check_ms, "audit_ms": audit_ms, "trace_ms": trace_ms,
            "durable_ms": durable_ms,
            "server_spans_by_op": dict(server_spans), "server_pids": server_pids,
            "compute_apps": compute_apps, "fused_gram_launches": fleet["launches"],
            "launch_shapes": fleet["launch_shapes"], "per_worker": fleet["per_worker"]}


def _shard_names(primaries, count=2):
    """``count`` experiment names the ring puts on different shards (the
    CLI's experiment ids: name, version 1, this user)."""
    from orion_tpu_torch.cli.base import _default_user
    from orion_tpu_torch.core.experiment import experiment_id
    from orion_tpu_torch.storage.shard import HashRing

    ring, names, taken = HashRing(primaries), [], set()
    for k in range(1000):
        name = f"plane-{k}"
        index = ring.lookup(experiment_id(name, 1, _default_user()))
        if index not in taken:
            taken.add(index)
            names.append((name, index))
        if len(names) == count:
            return names
    raise AssertionError("network: no names on distinct shards")


def _seq(address, secret):
    from orion_tpu_torch.storage.netdb import NetworkDB

    host, _, port = address.rpartition(":")
    client = NetworkDB(host=host, port=int(port), secret=secret, timeout=30.0)
    try:
        return client, client._call("seq")
    except BaseException:
        client.close()
        raise


def _wait_replicated(primary, replica, secret, tag, timeout=120):
    """``(primary client, replica client, seq)`` once the replica's seq
    equals the primary's; the caller closes the clients."""
    p_client, p_seq = _seq(primary, secret)
    r_client, r_seq = _seq(replica, secret)
    t0 = time.perf_counter()
    while r_seq["seq"] != p_seq["seq"]:
        if time.perf_counter() - t0 > timeout:
            raise AssertionError(f"{tag}: replica at {r_seq} behind primary {p_seq}")
        time.sleep(0.2)
        p_seq, r_seq = p_client._call("seq"), r_client._call("seq")
    return p_client, r_client, p_seq["seq"]


def run_network_shards(tmp, device, workers=SHARD_WORKERS, max_trials=SHARD_TRIALS, q=CLI_Q,
                       algo=CLI_ALGO, timeout=600):
    """(b) Two primaries persisted to SQLite, each replicating to one
    replica with ``--quorum 1``; a ``shards:`` stanza in the hunts' config;
    two experiments that ``db ring`` places on different shards, hunted at
    once by two workers each.  Each experiment's completions read back from
    its shard's primary and, once the replica's seq equals the primary's,
    from the replica; ``db status --json`` (both roles, lag 0, quorum 1),
    ``audit --all`` with the topology line, ``metrics`` (the router's stale
    reads and failovers)."""
    import yaml

    from orion_tpu_torch.storage.base import create_storage

    run_dir = os.path.join(tmp, "shards")
    os.makedirs(run_dir)
    secret_path = _secret_file(run_dir)
    with open(secret_path) as handle:
        secret = handle.read().strip()
    unseeded = {k: v for k, v in algo.items() if k != "seed"}
    script, _ = write_cli_files(run_dir, unseeded)
    quorum = ["--quorum", "1", "--quorum-timeout", str(QUORUM_TIMEOUT_S),
              "--secret-file", secret_path]
    with DBServers(run_dir, device) as servers:
        replicas = servers.start(*[
            (f"replica{i}", ["--replica", "--persist",
                             os.path.join(run_dir, f"replica{i}.sqlite"), *quorum])
            for i in range(2)])
        primaries = servers.start(*[
            (f"primary{i}", ["--replicate-to", replicas[i], "--persist",
                             os.path.join(run_dir, f"primary{i}.sqlite"), *quorum])
            for i in range(2)])
        storage_config = {"type": "network", "secret_file": secret_path,
                          "shards": [{"address": p, "replicas": [r]}
                                     for p, r in zip(primaries, replicas)]}
        config = os.path.join(run_dir, "plane.yaml")
        with open(config, "w") as handle:
            yaml.safe_dump({"telemetry": True, "storage": storage_config,
                            "algorithms": {"tpu_bo": unseeded}}, handle)
        names = _shard_names(primaries)
        storage = create_storage(storage_config)
        histories = {name: seed_history(storage, name, ["-c", config], script,
                                        os.path.join(run_dir, f"executions-{name}.log"),
                                        device, seed=k)
                     for k, (name, _) in enumerate(names)}
        commands = []
        for name, _ in names:
            commands.append((_cli_command(
                "-n", name, "-c", config, "--pool-size", str(q), "--max-trials",
                str(HISTORY + max_trials), "--n-workers", str(workers), "--profile",
                os.path.join(run_dir, f"profile-{name}"), "--device", device.type, script,
                *CLI_PRIORS, "--log", os.path.join(run_dir, f"executions-{name}.log")),
                run_dir))
        wall_s = run_cohort(commands, timeout)
        ring_rc, ring_out, _ = _cli_output(["db", "ring", "-c", config])
        router = storage.db
        per_experiment = {}
        for name, index in names:
            fleet = _check_fleet(name, storage, os.path.join(run_dir, f"executions-{name}.log"),
                                 os.path.join(run_dir, f"profile-{name}"), max_trials, device,
                                 histories[name])
            placed = re.search(rf"  {name} v1 \(\S+\) -> shard (\d+)", ring_out)
            if router.shard_for(fleet["exp_id"]) != index or not placed \
                    or int(placed.group(1)) != index:
                raise AssertionError(f"network: {name} not on shard {index}:\n{ring_out}")
            acknowledged = set(fleet["executed"])
            primary, replica, seq = _wait_replicated(primaries[index], replicas[index], secret,
                                                     f"network {name}")
            read_back = {}
            for role, client in (("primary", primary), ("replica", replica)):
                read_back[role] = {d["_id"] for d in client.read(
                    "trials", {"experiment": fleet["exp_id"], "status": "completed"},
                    projection={"_id": 1})} - histories[name]
                client.close()
            if read_back["primary"] != acknowledged or read_back["replica"] != acknowledged:
                raise AssertionError(
                    f"network {name}: {len(acknowledged)} acknowledged completions, "
                    f"{len(read_back['primary'])} on the primary, "
                    f"{len(read_back['replica'])} on the replica")
            rc, body, _ = _cli_output(["metrics", "-n", name, "-c", config])
            merged = parse_exposition(body)
            shard_counters = {k: v for k, v in merged.items() if "storage_shard_" in k
                              and k.endswith("_total")}
            per_experiment[name] = {
                "shard": index, "trials": len(fleet["trials"]),
                "completed": len(fleet["done"]), "executed": len(fleet["executed"]),
                "executed_distinct": len(acknowledged),
                "read_back_primary": len(read_back["primary"]),
                "read_back_replica": len(read_back["replica"]), "seq": seq,
                "regret": float(fleet["values"].min()) - GLOBAL_MIN,
                "objective_max_abs_err": fleet["err"],
                "wire_ms_per_trial": _wire_ms(storage, fleet["exp_id"], "shard"),
                "metrics_rc": rc, "shard_counters": shard_counters,
                "fused_gram_launches": fleet["launches"],
                "launch_shapes": fleet["launch_shapes"], "per_worker": fleet["per_worker"]}
            if rc != 0 or not any("replica_stale_reads" in k for k in shard_counters) \
                    or not any("failovers" in k for k in shard_counters):
                raise AssertionError(f"network {name}: metrics exited {rc}, shard counters "
                                     f"{shard_counters}")
        t0 = time.perf_counter()
        while True:
            status_rc, status_out, _ = _cli_output(["db", "status", "--json", "-c", config])
            shards = json.loads(status_out)["shards"]
            lags = [r.get("lag") for s in shards for r in s.get("replicas", ())]
            if lags == [0, 0] or time.perf_counter() - t0 > 60:
                break
            time.sleep(0.5)
        if (status_rc != 0 or [s.get("role") for s in shards] != ["primary", "primary"]
                or [s.get("quorum") for s in shards] != [1, 1] or lags != [0, 0]):
            raise AssertionError(f"network: db status {status_rc}: {status_out}")
        audit_rc, audit_out, audit_ms = _cli_output(["audit", "--all", "-c", config])
        if audit_rc != 0 or not audit_out.startswith("storage: 2 shard(s) ["):
            raise AssertionError(f"network: audit --all exited {audit_rc}:\n{audit_out}")
        admin = run_network_admin(run_dir, names[0][0], primaries[names[0][1]], secret_path)
        compute_apps = servers.check_host_only()
        server_pids = servers.pids()
    done = sum(e["completed"] for e in per_experiment.values())
    return {"shards": 2, "replicas_per_shard": 1, "quorum": 1,
            "quorum_timeout_s": QUORUM_TIMEOUT_S, "workers_per_experiment": workers, "q": q,
            "wall_s": wall_s, "trials_per_s": done / wall_s, "experiments": per_experiment,
            "status": shards, "audit_ms": audit_ms,
            "audit_topology": audit_out.splitlines()[0], "server_pids": server_pids,
            "compute_apps": compute_apps,
            "fused_gram_launches": sum(e["fused_gram_launches"]
                                       for e in per_experiment.values()),
            "plane": {"dir": run_dir, "secret": secret_path, "primaries": primaries,
                      "names": [name for name, _ in names], "script": script,
                      "algo": unseeded}}, admin


def run_network_admin(plane_dir, name, address, secret_path):
    """(c) ``db dump`` of the shard primary that holds experiment ``name``
    (the only one there), ``db load`` into a fresh SQLite file, its trial
    documents equal to the primary's in canonical form; ``db copy`` of that
    file, ``db migrate-ids`` on the copy and a clean ``audit``; ``info``
    prints its sections."""
    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.storage.documents import dumps_canonical

    run_dir = os.path.join(plane_dir, "admin")
    os.makedirs(run_dir)
    dump, loaded = os.path.join(run_dir, "dump.jsonl"), os.path.join(run_dir, "loaded.sqlite")
    copied = os.path.join(run_dir, "copied.sqlite")
    timings = {}
    with _environ(ORION_DB_SECRET_FILE=secret_path):
        for key, argv in (("dump", ["db", "dump", "--src", address, "--out", dump]),
                          ("load", ["db", "load", "--src", dump, "--dst", loaded]),
                          ("copy", ["db", "copy", "--src", loaded, "--dst", copied]),
                          ("migrate_ids", ["db", "migrate-ids", "--storage-path", copied])):
            rc, out, timings[key] = _cli_output(argv)
            if rc != 0:
                raise AssertionError(f"network: {' '.join(argv[:2])} exited {rc}:\n{out}")
        primary = create_storage({"type": "network", "address": address})
        original = sorted(dumps_canonical(d) for d in primary.db.read("trials"))
    reloaded = sorted(dumps_canonical(d) for d in create_storage(
        {"type": "sqlite", "path": loaded}).db.read("trials"))
    if original != reloaded or not original:
        raise AssertionError(f"network: {len(reloaded)} trial documents loaded of "
                             f"{len(original)} on the primary, or they differ")
    storage = create_storage({"type": "sqlite", "path": copied})
    [exp] = storage.fetch_experiments({})
    migrated = storage.db.read("trials", {"experiment": exp["_id"]})
    old_ids = {json.loads(d)["_id"] for d in original}
    audit_rc, audit_out, timings["audit"] = _cli_output(["audit", "-n", name,
                                                         "--storage-path", copied])
    info_rc, info_out, timings["info"] = _cli_output(["info", "-n", name,
                                                      "--storage-path", copied])
    sections = re.findall(r"\n([A-Z][\w -]+)\n=+\n", info_out)
    if (exp["name"] != name or exp.get("id_scheme") != "cube_hash"
            or old_ids & {d["_id"] for d in migrated} or len(migrated) != len(original)
            or audit_rc != 0 or info_rc != 0 or "Stats" not in sections):
        raise AssertionError(f"network: migrate-ids left scheme {exp.get('id_scheme')}, "
                             f"{len(migrated)} trials; audit {audit_rc}: {audit_out}; "
                             f"info {info_rc}: {sections}")
    return {"experiment": name, "trial_documents": len(original),
            "dump_bytes": os.path.getsize(dump), "id_scheme": exp["id_scheme"],
            "info_sections": sections, "ms": timings}


def phase_network(device, tmp, telemetry_trials_per_s):
    """Networked and sharded storage: workers over one server, over a
    replicated two-shard plane, and the ``db`` administration commands.
    Returns ``fused_gram``'s launches in each run, and the two-shard
    plane's files, addresses and experiments for the ``day2`` phase."""
    server = run_network_server(tmp, device)
    emit("network", run="server", storage="network+sqlite",
         telemetry_four_workers_sqlite_trials_per_s=telemetry_trials_per_s, **server)
    plane, admin = run_network_shards(tmp, device)
    files = plane.pop("plane")
    emit("network", run="shards", storage="2 shards x (primary + replica), sqlite", **plane)
    emit("network", run="admin", **admin)
    return {"server": server["fused_gram_launches"], "shards": plane["fused_gram_launches"]}, files


#: The ``day2`` phase: beside the three experiments it resumes (each with a
#: ``HISTORY``), experiments with a few completed trials each, so that the
#: grown ring's plan moves a share of experiments comparable with 1/3.
DAY2_FILLERS = 4
DAY2_FILLER_TRIALS = 8
#: Trials the live drain's two workers run past the history.
DAY2_LIVE_TRIALS = 64
#: Seconds the live drain's workers start after the drain (0 here;
#: ``tests/torch_chip_legs.py drain`` sets 40 to stand for a slow host, whose
#: workers register their first GP round that much later).
DAY2_WORKERS_LATE_S = 0.0
#: A resumed hunt's budget past the completed trials.
DAY2_RESUME_TRIALS = 4
#: The hunts' storage retry policy: a fenced experiment's ops fail with a
#: transient error for the whole fence window (the placement TTL's grace,
#: then the delta copy, the verify and the flip), and the policy rides
#: through it.
DAY2_RETRY = {"max_attempts": 1000, "base_delay": 0.05, "max_delay": 1.0, "deadline": 120.0}
#: The live drain's placement documents are read this often.
PLACEMENT_POLL_S = 0.025

#: ``python3 -c ADMIN_WRAPPER REPORT ARGV...``: ``orion-tpu-torch ARGV`` with
#: the migrator's steps timed (wall clock, by wrapping the methods), then
#: the process's own ``/dev/nvidia*`` files, its exit code and the timings
#: written to REPORT as JSON.
ADMIN_WRAPPER = r"""
import json, os, runpy, sys, time
report, argv = sys.argv[1], sys.argv[2:]
from orion_tpu_torch.storage import drain, rebalance
calls = []

def timed(name, fn):
    def wrapper(self, *args, **kwargs):
        t0 = time.time()
        try:
            return fn(self, *args, **kwargs)
        finally:
            move = args[0] if args else None
            calls.append({"call": name, "state": args[1] if name == "_set_placement" else None,
                          "experiment": getattr(move, "exp_id", None), "t0": t0,
                          "t1": time.time()})
    return wrapper

for cls, names in ((rebalance.Rebalancer, ("plan", "run", "_copy", "_verify", "_set_placement",
                                           "_delete_source", "_drop_placement")),
                   (drain.Drainer, ("plan",))):
    for name in names:
        setattr(cls, name, timed(name, cls.__dict__[name]))
gate = os.environ.get("DRAIN_COPY_GATE")
if gate:
    # The first copy waits while the gate file exists (at most 600 s).
    copy = rebalance.Rebalancer._copy

    def gated(self, *args, **kwargs):
        t0 = time.time()
        while os.path.exists(gate) and time.time() < t0 + 600.0:
            time.sleep(0.05)
        calls.append({"call": "gate", "state": None, "experiment": None, "t0": t0,
                      "t1": time.time()})
        rebalance.Rebalancer._copy = copy
        return copy(self, *args, **kwargs)

    rebalance.Rebalancer._copy = gated
sys.argv = ["orion-tpu-torch", *argv]
rc = 0
try:
    runpy.run_module("orion_tpu_torch.cli", run_name="__main__", alter_sys=True)
except SystemExit as exc:
    rc = exc.code if isinstance(exc.code, int) else (0 if exc.code is None else 1)
files = set()
for fd in os.listdir("/proc/self/fd"):
    try:
        target = os.readlink(os.path.join("/proc/self/fd", fd))
    except OSError:
        continue
    if target.startswith("/dev/nvidia"):
        files.add(target)
with open("/proc/self/maps") as handle:
    files.update(line.split()[-1] for line in handle if "/dev/nvidia" in line)
with open(report, "w") as handle:
    json.dump({"rc": rc, "pid": os.getpid(), "nvidia_files": sorted(files), "calls": calls},
              handle)
sys.exit(rc)
"""


def run_admin(run_dir, tag, argv, apps_before, apps_allowed=0, timeout=600, env=None):
    """``orion-tpu-torch ARGV`` as a host process through ``ADMIN_WRAPPER``,
    its output in ``TAG.out``: its ``/dev/nvidia*`` files are read from
    ``/proc`` every 0.1 s while it runs and reported by the process itself
    at its end, and ``nvidia-smi``'s compute apps every second; the command
    fails the phase if it held such a file or if the apps ever outnumber
    ``apps_before`` by more than ``apps_allowed`` (the hunt workers running
    beside it).  ``env`` is added to its environment.  Returns (exit code,
    output, report, wall ms, most apps seen)."""
    report = os.path.join(run_dir, f"{tag}.report.json")
    out_path = os.path.join(run_dir, f"{tag}.out")
    seen, most_apps, last_smi = set(), 0, None
    with open(out_path, "w") as out:
        proc = subprocess.Popen([sys.executable, "-c", ADMIN_WRAPPER, report, *argv],
                                env=dict(os.environ, PYTHONPATH=ROOT, **(env or {})),
                                cwd=run_dir, stdout=out,
                                stderr=subprocess.STDOUT, start_new_session=True)
        t0 = time.perf_counter()
        try:
            while proc.poll() is None:
                now = time.perf_counter()
                if now - t0 > timeout:
                    raise AssertionError(f"day2: {' '.join(argv[:2])} ran past {timeout} s")
                try:
                    seen.update(nvidia_files(proc.pid))
                except OSError:
                    pass  # it exited between poll() and the read
                if last_smi is None or now - last_smi >= 1.0:
                    most_apps, last_smi = max(most_apps, len(compute_apps())), now
                time.sleep(0.1)
        finally:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with open(out_path) as handle:
        text = handle.read()
    if not os.path.exists(report):
        raise AssertionError(f"day2: {' '.join(argv[:2])} wrote no report "
                             f"(exit {proc.returncode}):\n{text[-3000:]}")
    with open(report) as handle:
        report = json.load(handle)
    seen.update(report["nvidia_files"])
    if seen or most_apps > len(apps_before) + apps_allowed:
        raise AssertionError(f"day2: {' '.join(argv[:2])} (pid {proc.pid}) initialized CUDA: "
                             f"{sorted(seen)}; {most_apps} compute apps against "
                             f"{len(apps_before)} + {apps_allowed}")
    return proc.returncode, text, report, wall_ms, most_apps


def migrator_ms(report):
    """Per moved experiment, from an admin report's timed calls: the first
    copy (while pinned), the fence window (fenced written -> moved written),
    the delta copy and the verify inside it, and the source's deletion."""
    per = collections.defaultdict(dict)
    for call in report["calls"]:
        exp, ms = call["experiment"], (call["t1"] - call["t0"]) * 1e3
        if exp is None:
            continue
        row = per[exp]
        if call["call"] == "_set_placement":
            row[f"{call['state']}_at"] = call["t1"]
            row[f"set_{call['state']}_ms"] = ms
        elif call["call"] == "_copy":
            row["copy_ms" if "copy_ms" not in row else "delta_copy_ms"] = ms
        elif call["call"] == "_verify":
            row["verify_ms"] = ms
        elif call["call"] == "_delete_source":
            row["delete_ms"] = ms
    for row in per.values():
        if "fenced_at" in row and "moved_at" in row:
            row["fence_window_ms"] = (row["moved_at"] - row["fenced_at"]) * 1e3
    runs = [c for c in report["calls"] if c["call"] == "run"]
    return dict(per), ((runs[0]["t1"] - runs[0]["t0"]) * 1e3 if runs else None)


def _stanza(primaries, replicas, secret_path):
    return {"type": "network", "secret_file": secret_path, "retry": dict(DAY2_RETRY),
            "shards": [{"address": p, **({"replicas": [r]} if r else {})}
                       for p, r in zip(primaries, replicas)]}


def _day2_config(run_dir, name, stanza, algo):
    import yaml

    path = os.path.join(run_dir, f"{name}.yaml")
    with open(path, "w") as handle:
        yaml.safe_dump({"telemetry": True, "storage": stanza,
                        "algorithms": {"tpu_bo": dict(algo)}}, handle)
    return path


def _exp_id(name):
    from orion_tpu_torch.cli.base import _default_user
    from orion_tpu_torch.core.experiment import experiment_id

    return experiment_id(name, 1, _default_user())


def _pick_port(old_ring, identities, big, taken):
    """A free port for the new shard's primary whose ring moves none of
    ``big`` (the ``network`` plane's experiments, ~110 MB each: moving one
    costs about a minute, which the drain spends instead)."""
    import random

    from orion_tpu_torch.storage.shard import HashRing

    rng = random.Random(0)
    for _ in range(2000):
        port = rng.randrange(20000, 60000)
        if port in taken:
            continue
        ring = HashRing(identities + [f"127.0.0.1:{port}"])
        if all(ring.lookup(e) == old_ring.lookup(e) for e in big):
            try:
                with socket.socket() as sock:
                    sock.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port, ring
    raise AssertionError("day2: no port leaves the network experiments in place")


def _pick_name(prefix, accept):
    for k in range(10000):
        name = f"{prefix}-{k}"
        if accept(_exp_id(name)):
            return name
    raise AssertionError(f"day2: no name for {prefix}")


def _hunt(run_dir, tag, name, config, max_trials, workers, device, q, timeout, profile=True,
          env=None):
    """``hunt --n-workers W [--profile]`` resuming ``name`` in ``run_dir``
    (its ``--log`` file as at creation), ``env`` added to its environment;
    returns (wall s, profile dir)."""
    script = os.path.join(run_dir, "hartmann6.py")
    prof = os.path.join(run_dir, f"profile-{tag}")
    wall_s = run_cohort([(_cli_command(
        "-n", name, "-c", config, "--pool-size", str(q), "--max-trials", str(max_trials),
        "--n-workers", str(workers), *(["--profile", prof] if profile else []), "--device",
        device.type, script, *CLI_PRIORS, "--log",
        os.path.join(run_dir, f"executions-{name}.log")), run_dir)], timeout, env=env)
    return wall_s, prof


def _resumed(tag, prof):
    """The resumed workers' launches from their traces: at least one at
    ``MAIN_SHAPE``."""
    per_worker = read_traces(prof)
    shapes = collections.Counter()
    for worker in per_worker:
        shapes.update(worker["launch_shapes"])
    main = "x".join(map(str, MAIN_SHAPE))
    if shapes[main] < 1:
        raise AssertionError(f"day2 {tag}: fused_gram launched at {dict(shapes)} "
                             f"(none at {main})")
    return {"fused_gram_launches": sum(w["fused_gram_launches"] for w in per_worker),
            "launch_shapes": dict(shapes), "per_worker": per_worker}


def _canonical_trials(conn, exp_id):
    from orion_tpu_torch.storage.documents import dumps_canonical

    return {d["_id"]: dumps_canonical(d) for d in conn.read("trials", {"experiment": exp_id})}


def _audit_all(config, tag):
    rc, out, ms = _cli_output(["audit", "--all", "-c", config])
    if rc != 0:
        raise AssertionError(f"day2 {tag}: audit --all exited {rc}:\n{out}")
    return ms, out.splitlines()[0]


def _completions(storage, exp_id):
    return {d["_id"] for d in storage.db.read(
        "trials", {"experiment": exp_id, "status": "completed"}, projection={"_id": 1})}


def run_day2_grow(ctx):
    """(a) A third primary with one replica, on a port the grown ring moves
    a third of the experiments for (none of the ``network`` ones); the
    stanza rolled out; ``db ring --diff`` (its plan equal to the ring's,
    its move fraction near 1/3) and ``db rebalance``; every moved experiment's trial documents on
    the destination equal to the source's, the source copy and the
    placement override gone, ``audit --all`` clean; then the moved
    ``day2`` experiment resumed for one GP round."""
    from orion_tpu_torch.storage.base import create_storage

    servers, run_dir = ctx["servers"], ctx["run_dir"]
    replica = servers.start(("replica2", ["--replica", "--persist",
                                          os.path.join(run_dir, "replica2.sqlite"),
                                          *ctx["quorum"]]))[0]
    primary = servers.start(("primary2", ["--port", str(ctx["port"]), "--replicate-to",
                                          replica, "--persist",
                                          os.path.join(run_dir, "primary2.sqlite"),
                                          *ctx["quorum"]]))[0]
    ctx["primaries"].append(primary)
    ctx["replicas"].append(replica)
    stanza = _stanza(ctx["primaries"], ctx["replicas"], ctx["secret_path"])
    config = _day2_config(run_dir, "grown", stanza, ctx["algo"])
    ctx["grown"] = config
    old = create_storage(_stanza(ctx["primaries"][:2], ctx["replicas"][:2], ctx["secret_path"]))
    ring = ctx["ring"]
    expected = sorted((e, old.db.shard_for(e), ring.lookup(e)) for e in ctx["exp_ids"]
                      if ring.lookup(e) != old.db.shard_for(e))
    before = {e: _canonical_trials(dict(old.db.shard_connections())[src], e)
              for e, src, _ in expected}
    old.db.close()
    rc, diff_out, _, diff_ms, _ = run_admin(run_dir, "ring-diff", ["db", "ring", "--diff",
                                                                   "-c", config],
                                            ctx["apps_before"])
    plan = re.search(r"rebalance plan: (\d+) of (\d+) experiment\(s\) move \(([\d.]+)%\)",
                     diff_out)
    listed = sorted((m.group(1), int(m.group(2)), int(m.group(3))) for m in re.finditer(
        r"\((\w+)\) shard (\d+) -> (\d+)", diff_out))
    fraction = len(expected) / len(ctx["exp_ids"])
    if rc != 0 or not plan or listed != expected or abs(fraction - 1 / 3) > 1 / 6:
        raise AssertionError(f"day2 grow: ring --diff exited {rc}, listed {listed} against "
                             f"the ring's {expected} (fraction {fraction}):\n{diff_out}")
    rc, out, report, rebalance_ms, apps = run_admin(run_dir, "rebalance",
                                                    ["db", "rebalance", "-c", config],
                                                    ctx["apps_before"])
    if rc != 0 or "placement == ring again" not in out:
        raise AssertionError(f"day2 grow: db rebalance exited {rc}:\n{out}")
    storage = create_storage(stanza)
    conns = dict(storage.db.shard_connections())
    for e, src, dst in expected:
        if _canonical_trials(conns[dst], e) != before[e] or not before[e]:
            raise AssertionError(f"day2 grow: {e}'s {len(before[e])} trial documents differ "
                                 f"on shard {dst}")
        if conns[src].count("trials", {"experiment": e}) or conns[src].count(
                "experiments", {"_id": e}):
            raise AssertionError(f"day2 grow: {e} still on its source shard {src}")
    overrides = sum(len(c.read("_placement", {})) for c in conns.values())
    audit_ms, topology = _audit_all(config, "grow")
    if overrides:
        raise AssertionError(f"day2 grow: {overrides} placement overrides left")
    name = ctx["moved"]
    completed = storage.count_completed_trials(_exp_id(name))
    wall_s, prof = _hunt(run_dir, "grow", name, config, completed + DAY2_RESUME_TRIALS, 1,
                         ctx["device"], ctx["q"], ctx["timeout"])
    after = storage.count_completed_trials(_exp_id(name))
    if after < completed + DAY2_RESUME_TRIALS or storage.db.shard_for(_exp_id(name)) != 2:
        raise AssertionError(f"day2 grow: {name} at {after} completions after the resume")
    storage.db.close()
    moves, run_ms = migrator_ms(report)
    return {"new_shard": {"primary": primary, "replica": replica},
            "plan": {"moves": len(expected), "experiments": len(ctx["exp_ids"]),
                     "move_fraction": fraction, "printed": plan.group(0)},
            "moved": [{"experiment": e, "src": src, "dst": dst,
                       "trial_documents": len(before[e]), **moves.get(e, {})}
                      for e, src, dst in expected],
            "ring_diff_ms": diff_ms, "rebalance_ms": rebalance_ms, "migrator_run_ms": run_ms,
            "compute_apps_seen": apps, "audit_ms": audit_ms, "audit_topology": topology,
            "resumed": {"experiment": name, "completed_before": completed,
                        "completed_after": after, "wall_s": wall_s,
                        **_resumed("grow", prof)}}


def _poll_placements(address, secret, stop, seen):
    """Every ``PLACEMENT_POLL_S``, the drained shard's placement documents:
    the wall time each (experiment, state) was first seen."""
    from orion_tpu_torch.storage.netdb import NetworkDB

    host, _, port = address.rpartition(":")
    client = NetworkDB(host=host, port=int(port), secret=secret, timeout=30.0)
    try:
        while not stop.is_set():
            now = time.time()
            for doc in client.read("_placement", {}):
                seen.setdefault((doc["experiment"], doc["state"]), now)
            stop.wait(PLACEMENT_POLL_S)
    finally:
        client.close()


def _drain_gates(address, secret, exp_id, history, gate, hold, seen, stop, opened):
    """The live drain's two gates, released from the store's side: ``gate``
    (the drain's first copy waits while it exists) goes once the drained
    shard holds more of ``exp_id``'s trials than its ``history`` (the
    workers' first GP round registered), ``hold`` (the workers' trials wait
    while it exists) once the poller has seen the experiment fenced.
    ``opened`` gets the wall time of each release."""
    from orion_tpu_torch.storage.netdb import NetworkDB

    host, _, port = address.rpartition(":")
    client = NetworkDB(host=host, port=int(port), secret=secret, timeout=30.0)
    try:
        while not stop.is_set() and os.path.exists(hold):
            if os.path.exists(gate):
                if client.count("trials", {"experiment": exp_id}) > history:
                    opened["gate"] = time.time()
                    os.remove(gate)
            elif (exp_id, "fenced") in seen:
                opened["hold"] = time.time()
                os.remove(hold)
            stop.wait(PLACEMENT_POLL_S)
    finally:
        client.close()


def run_day2_drain(ctx):
    """(b) Two workers hunt the live ``day2`` experiment while ``db drain``
    empties its shard (which also holds a ``network`` experiment), with
    the old stanza: the ``moved`` override on the drained shard routes them
    after the flip.  The drain starts with the workers, and two gates tie
    the overlap to the store, not to the host's speed: the drain's first
    copy waits until the workers' first GP round has registered, and every
    trial of the workers waits (its script polls a file) until the drain
    has fenced the experiment, so the GP round registers while the drain
    runs and trials complete after the flip.  Then ``db drain --dry-run``
    (nothing resident), the survivor stanza rolled out and the drained
    shard's servers stopped, and one worker resuming the hunt.  No
    observation lost: completions through the router equal the sum of
    direct per-shard reads and the distinct executions the script logged;
    each completion on the destination's primary and replica; ``audit
    --all`` clean; the fence window and the workers' ``storage.retries``."""
    import threading

    from orion_tpu_torch.storage.base import create_storage

    servers, run_dir, secret = ctx["servers"], ctx["run_dir"], ctx["secret"]
    name, index = ctx["live"], ctx["drained"]
    exp_id = _exp_id(name)
    gate, hold = os.path.join(run_dir, "drain.gate"), os.path.join(run_dir, "drain.hold")
    for path in (gate, hold):
        open(path, "w").close()
    stop, seen, result, opened = threading.Event(), {}, {}, {}
    poller = threading.Thread(target=_poll_placements,
                              args=(ctx["primaries"][index], secret, stop, seen))
    gates = threading.Thread(target=_drain_gates, args=(
        ctx["primaries"][index], secret, exp_id, len(ctx["history"][name]), gate, hold, seen,
        stop, opened))
    poller.start()
    gates.start()

    def hunt():
        try:
            time.sleep(DAY2_WORKERS_LATE_S)
            result["wall_s"], result["prof"] = _hunt(
                run_dir, "drain", name, ctx["grown"], HISTORY + DAY2_LIVE_TRIALS, 2,
                ctx["device"], ctx["q"], ctx["timeout"], env={"HARTMANN6_HOLD_WHILE": hold})
        except BaseException as exc:  # re-raised below, in the phase's thread
            result["error"] = exc

    workers = threading.Thread(target=hunt)
    t0 = time.time()
    workers.start()
    try:
        drain_started = time.time()
        rc, out, report, drain_ms, apps = run_admin(
            run_dir, "drain", ["db", "drain", str(index), "-c", ctx["grown"]],
            ctx["apps_before"], apps_allowed=2, env={"DRAIN_COPY_GATE": gate})
        drained_at = time.time()
    finally:
        # Whatever happened, nothing may wait on a gate past here.
        for path in (gate, hold):
            if os.path.exists(path):
                os.remove(path)
        workers.join()
        stop.set()
        poller.join()
        gates.join()
    if "error" in result:
        raise result["error"]
    if rc != 0 or f"shard {index} drained" not in out:
        raise AssertionError(f"day2 drain: db drain exited {rc}:\n{out}")
    rc, dry, _, dry_ms, _ = run_admin(run_dir, "drain-dry-run",
                                      ["db", "drain", str(index), "--dry-run", "-c",
                                       ctx["grown"]], ctx["apps_before"])
    dry_moves = dry.splitlines()[1:]
    if rc != 0 or not dry_moves or not all(line.endswith(" [moved]") for line in dry_moves):
        raise AssertionError(f"day2 drain: the dry run after the drain shows residents:\n{dry}")
    resident = create_storage({"type": "network", "address": ctx["primaries"][index],
                               "secret_file": ctx["secret_path"]})
    if resident.db.read("experiments", {}):
        raise AssertionError("day2 drain: experiments left on the drained shard")
    resident.db.close()
    survivors = [i for i in range(3) if i != index]
    ctx["primaries"] = [ctx["primaries"][i] for i in survivors]
    ctx["replicas"] = [ctx["replicas"][i] for i in survivors]
    stanza = _stanza(ctx["primaries"], ctx["replicas"], ctx["secret_path"])
    config = _day2_config(run_dir, "survivors", stanza, ctx["algo"])
    ctx["survivors"] = config
    servers.check_host_only()
    servers.stop(f"primary{index}", f"replica{index}")
    storage = create_storage(stanza)
    live = _resumed("drain", result["prof"])
    trials = storage.fetch_trials(uid=exp_id)
    submitted = sorted(t.submit_time for t in trials if t.submit_time and t.submit_time > t0)
    completed = storage.count_completed_trials(exp_id)
    wall_s, _ = _hunt(run_dir, "drain-resume", name, config, completed + DAY2_RESUME_TRIALS,
                      1, ctx["device"], ctx["q"], ctx["timeout"], profile=False)
    with open(os.path.join(run_dir, f"executions-{name}.log")) as handle:
        executed = set(handle.read().split())
    routed = _completions(storage, exp_id) - ctx["history"][name]
    direct, replicated = set(), {}
    for position, i in enumerate(survivors):
        primary, replica, seq = _wait_replicated(ctx["primaries"][position],
                                                 ctx["replicas"][position], secret,
                                                 "day2 drain")
        on_primary = {d["_id"] for d in primary.read(
            "trials", {"experiment": exp_id, "status": "completed"}, projection={"_id": 1})}
        on_replica = {d["_id"] for d in replica.read(
            "trials", {"experiment": exp_id, "status": "completed"}, projection={"_id": 1})}
        primary.close()
        replica.close()
        direct |= on_primary
        if on_primary:
            replicated[i] = {"primary": len(on_primary), "replica": len(on_replica),
                             "seq": seq, "equal": on_primary == on_replica}
    direct -= ctx["history"][name]
    if not (routed == direct == executed) or not replicated or not all(
            r["equal"] for r in replicated.values()):
        raise AssertionError(f"day2 drain: {len(routed)} completions through the router, "
                             f"{len(direct)} on the shards, {len(executed)} executed; "
                             f"replicas {replicated}")
    rc, body, _ = _cli_output(["metrics", "-n", name, "-c", config])
    merged = parse_exposition(body)
    retries = {k: v for k, v in merged.items() if "retr" in k or "gave_up" in k}
    audit_ms, topology = _audit_all(config, "drain")
    moves, run_ms = migrator_ms(report)
    live_move = moves.get(exp_id, {})
    states = {f"{state}_seen_at": at - t0 for (e, state), at in seen.items() if e == exp_id}
    ends = sorted(t.end_time for t in trials if t.status == "completed" and t.end_time
                  and t.end_time > t0)
    fenced, moved = live_move.get("fenced_at"), live_move.get("moved_at")
    if (not fenced or not moved or not ends or ends[-1] <= moved or not submitted
            or not drain_started <= submitted[0] <= drained_at):
        raise AssertionError(f"day2 drain: the workers did not hunt across the drain "
                             f"(drain {drain_started - t0:.1f}-{drained_at - t0:.1f} s, "
                             f"their GP rounds registered at {[s - t0 for s in submitted[:1]]}, "
                             f"fenced {fenced}, moved {moved}, last completion "
                             f"{ends[-1] if ends else None})")
    storage.db.close()
    return {"experiment": name, "drained_shard": index, "plan": out.splitlines()[0],
            "drain_ms": drain_ms, "migrator_run_ms": run_ms, "dry_run_ms": dry_ms,
            "moves": [{"experiment": e, **m} for e, m in moves.items()],
            "fence_window_ms": live_move.get("fence_window_ms"),
            "placement_polled": states, "workers_wall_s": result["wall_s"],
            "drain_window_s": [drain_started - t0, drained_at - t0],
            "migrator_started_s": min(call["t0"] for call in report["calls"]) - t0,
            "gates_opened_s": {k: v - t0 for k, v in opened.items()},
            "gp_round_registered_s": [submitted[0] - t0, submitted[-1] - t0],
            "trials_ended_before_fence": sum(1 for e in ends if e < fenced),
            "trials_ended_in_fence": sum(1 for e in ends if fenced <= e < moved),
            "trials_ended_after_flip": sum(1 for e in ends if e >= moved),
            "completed_new": len(routed), "executed_distinct": len(executed),
            "replicated": replicated, "worker_retries": retries,
            "compute_apps_seen": apps, "audit_ms": audit_ms, "audit_topology": topology,
            "live": live, "resumed": {"wall_s": wall_s, "completed_before": completed,
                                      "completed_after": storage.count_completed_trials(
                                          exp_id)}}


def run_day2_restore(ctx):
    """(c) ``db backup --out`` of the survivor plane (each shard's ``seq``
    and ``epoch`` in the manifest), ``db restore --src`` into a fresh plane
    of three primaries persisted to SQLite; its counts equal to the
    manifest's, its trial documents equal by id to the backup's and its
    auto-id rows by content, ``audit --all`` clean; then the untouched
    ``day2`` experiment resumed there for one GP round."""
    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.storage.documents import dumps_canonical

    servers, run_dir = ctx["servers"], ctx["run_dir"]
    out_dir = os.path.join(run_dir, "backup")
    rc, out, _, backup_ms, _ = run_admin(run_dir, "backup",
                                         ["db", "backup", "--out", out_dir, "-c",
                                          ctx["survivors"]], ctx["apps_before"])
    with open(os.path.join(out_dir, "manifest.json")) as handle:
        manifest = json.load(handle)
    if rc != 0 or len(manifest["shards"]) != 2 or not all(
            isinstance(e.get("seq"), int) and e["seq"] > 0 and isinstance(e.get("epoch"), int)
            for e in manifest["shards"]):
        raise AssertionError(f"day2 restore: db backup exited {rc}, manifest "
                             f"{manifest['shards']}:\n{out}")
    fresh = servers.start(*[(f"fresh{i}", ["--persist", os.path.join(run_dir,
                                                                     f"fresh{i}.sqlite"),
                                           "--secret-file", ctx["secret_path"]])
                            for i in range(3)])
    stanza = _stanza(fresh, [None] * 3, ctx["secret_path"])
    config = _day2_config(run_dir, "fresh", stanza, ctx["algo"])
    rc, out, _, restore_ms, _ = run_admin(run_dir, "restore",
                                          ["db", "restore", "--src", out_dir, "-c", config],
                                          ctx["apps_before"])
    if rc != 0 or "restored " not in out:
        raise AssertionError(f"day2 restore: db restore exited {rc}:\n{out}")
    t0 = time.perf_counter()
    want, want_auto = {}, collections.Counter()
    expected = collections.Counter()
    for entry in manifest["shards"]:
        with open(os.path.join(out_dir, entry["file"])) as handle:
            collections_ = json.load(handle)["collections"]
        for collection, docs in collections_.items():
            if collection in ("_replmeta", "_placement"):
                continue
            expected[collection] += len(docs)
            if collection == "trials":
                want.update((d["_id"], dumps_canonical(d)) for d in docs)
            elif collection in ("telemetry", "metrics", "spans", "health"):
                want_auto.update(dumps_canonical({k: v for k, v in d.items() if k != "_id"})
                                 for d in docs)
    storage = create_storage(stanza)
    got, got_auto, counts = {}, collections.Counter(), collections.Counter()
    for _, conn in storage.db.shard_connections():
        for collection in expected:
            docs = conn.read(collection, {})
            counts[collection] += len(docs)
            if collection == "trials":
                got.update((d["_id"], dumps_canonical(d)) for d in docs)
            elif collection in ("telemetry", "metrics", "spans", "health"):
                got_auto.update(dumps_canonical({k: v for k, v in d.items() if k != "_id"})
                                for d in docs)
    compare_ms = (time.perf_counter() - t0) * 1e3
    if counts != expected or got != want or got_auto != want_auto:
        raise AssertionError(f"day2 restore: counts {dict(counts)} against the manifest's "
                             f"{dict(expected)}; trials equal {got == want}, auto-id rows "
                             f"equal {got_auto == want_auto}")
    audit_ms, topology = _audit_all(config, "restore")
    name = ctx["restored"]
    completed = storage.count_completed_trials(_exp_id(name))
    wall_s, prof = _hunt(run_dir, "restore", name, config, completed + DAY2_RESUME_TRIALS, 1,
                         ctx["device"], ctx["q"], ctx["timeout"])
    after = storage.count_completed_trials(_exp_id(name))
    storage.db.close()
    if after < completed + DAY2_RESUME_TRIALS:
        raise AssertionError(f"day2 restore: {name} at {after} completions after the resume")
    return {"backup_ms": backup_ms, "restore_ms": restore_ms, "compare_ms": compare_ms,
            "manifest": [{k: e[k] for k in ("index", "address", "seq", "epoch", "docs")}
                         for e in manifest["shards"]],
            "backup_bytes": sum(os.path.getsize(os.path.join(out_dir, f))
                                for f in os.listdir(out_dir)),
            "restored_counts": dict(counts), "fresh_shards": len(fresh),
            "audit_ms": audit_ms, "audit_topology": topology,
            "resumed": {"experiment": name, "completed_before": completed,
                        "completed_after": after, "wall_s": wall_s,
                        **_resumed("restore", prof)}}


def phase_day2(device, tmp, plane, q=CLI_Q, timeout=600):
    """The day-2 storage operations on the ``network`` phase's replicated
    two-shard plane, restarted from its SQLite files (primaries on their
    ports, so the ring is the same): (a) grow and rebalance, (b) a live
    drain, (c) backup and restore onto another shard count, each followed
    by resumed hunts.  Every server and admin command is a host process.
    Returns ``fused_gram``'s launches in each run."""
    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.storage.shard import HashRing

    run_dir = os.path.join(tmp, "day2")
    os.makedirs(run_dir)
    shutil.copy(plane["script"], os.path.join(run_dir, "hartmann6.py"))
    with open(plane["secret"]) as handle:
        secret = handle.read().strip()
    quorum = ["--quorum", "1", "--quorum-timeout", str(QUORUM_TIMEOUT_S), "--secret-file",
              plane["secret"]]
    with DBServers(run_dir, device) as servers:
        replicas = servers.start(*[(f"replica{i}", ["--replica", "--persist", os.path.join(
            plane["dir"], f"replica{i}.sqlite"), *quorum]) for i in range(2)])
        primaries = servers.start(*[(f"primary{i}", [
            "--port", plane["primaries"][i].rpartition(":")[2], "--replicate-to", replicas[i],
            "--persist", os.path.join(plane["dir"], f"primary{i}.sqlite"), *quorum])
            for i in range(2)])
        if primaries != plane["primaries"]:
            raise AssertionError(f"day2: primaries restarted at {primaries}")
        old_ring = HashRing(primaries)
        big = [_exp_id(name) for name in plane["names"]]
        port, ring = _pick_port(old_ring, primaries, big,
                                {int(a.rpartition(":")[2]) for a in primaries + replicas})
        stays_on = old_ring.lookup(big[0])
        names = {
            "moved": _pick_name("day2-grow", lambda e: ring.lookup(e) != old_ring.lookup(e)),
            "live": _pick_name("day2-live", lambda e: ring.lookup(e) == old_ring.lookup(e)
                               == stays_on),
            "restored": _pick_name("day2-restore",
                                   lambda e: ring.lookup(e) == old_ring.lookup(e)),
        }
        # Two fillers the grown ring moves and two it leaves: with the moved
        # day2 experiment, a third of the nine experiments move.
        fillers = {True: [], False: []}
        for k in range(10000):
            e = _exp_id(f"day2-filler-{k}")
            moves = ring.lookup(e) != old_ring.lookup(e)
            if len(fillers[moves]) < DAY2_FILLERS // 2:
                fillers[moves].append(f"day2-filler-{k}")
            if len(fillers[True]) + len(fillers[False]) == DAY2_FILLERS:
                break
        fillers = fillers[True] + fillers[False]
        stanza = _stanza(primaries, replicas, plane["secret"])
        config = _day2_config(run_dir, "plane", stanza, plane["algo"])
        storage = create_storage(stanza)
        t0 = time.perf_counter()
        history = {}
        for seed, (name, completed) in enumerate(
                [(names[k], HISTORY) for k in ("moved", "live", "restored")]
                + [(f, DAY2_FILLER_TRIALS) for f in fillers]):
            history[name] = seed_history(
                storage, name, ["-c", config], os.path.join(run_dir, "hartmann6.py"),
                os.path.join(run_dir, f"executions-{name}.log"), device, completed, seed)
        setup_ms = (time.perf_counter() - t0) * 1e3
        storage.db.close()
        ctx = {"servers": servers, "run_dir": run_dir, "secret": secret,
               "secret_path": plane["secret"], "quorum": quorum, "primaries": list(primaries),
               "replicas": list(replicas), "algo": plane["algo"], "port": port, "ring": ring,
               "exp_ids": big + [_exp_id(n) for n in list(names.values()) + fillers],
               "history": history, "device": device, "q": q, "timeout": timeout,
               "apps_before": servers.apps_before, "drained": stays_on, **names}
        grow = run_day2_grow(ctx)
        emit("day2", run="grow", setup_ms=setup_ms, **grow)
        drain = run_day2_drain(ctx)
        emit("day2", run="drain", **drain)
        restore = run_day2_restore(ctx)
        emit("day2", run="restore", **restore)
        servers.check_host_only()
    return {"grow": grow["resumed"]["fused_gram_launches"],
            "drain": drain["live"]["fused_gram_launches"],
            "restore": restore["resumed"]["fused_gram_launches"]}


def _plan_equal(got, want):
    """Rows, health and GP hypers of two ``(rows, state)`` results, bitwise."""
    rows, state = got
    want_rows, want_state = want
    return (torch.equal(rows, want_rows) and torch.equal(state.health, want_state.health)
            and all(torch.equal(a, b) for a, b in zip(state.hypers, want_state.hypers)))


def run_eager_against_replay(algo, plan_fn, label):
    """(a) One plan of ``algo`` run eagerly and through the step graphs
    (captured already by an earlier phase, else captured now), then
    replayed twice: rows and health bitwise equal, with each one's ms."""
    from orion_tpu_torch.algo import tpu_bo as tbo
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS

    plan = plan_fn()

    def timed(fn):
        _sync(algo.device)
        t0 = time.perf_counter()
        out = fn()
        _sync(algo.device)
        return out, (time.perf_counter() - t0) * 1e3

    eager, eager_ms = timed(lambda: tbo._suggest_step(*plan.arrays, **plan.statics))
    captured_before = STEP_GRAPHS.has(algo.device, plan.signature)
    outs, ms = [], []
    for _ in range(3):
        (out, _entry, _missed), t = timed(lambda: STEP_GRAPHS.run(
            tbo._suggest_step, plan.signature, plan.arrays, plan.statics))
        outs.append(out)
        ms.append(t)
    equal = [_plan_equal(out, eager) for out in outs]
    if not all(equal):
        raise AssertionError(f"{label}: a replayed round differs from the eager one: {equal}")
    return {"path": label, "q": plan.statics["q"], "fit_bucket": plan.arrays[1].shape[0],
            "captured_before": captured_before, "eager_ms": eager_ms, "graph_ms": ms,
            "bitwise_equal": True}


def run_bucket_crossing(device, prewarm, q):
    """(b) A history crossing 128 -> 256 at the main path's width: 90
    observed, a round at 128, ten more (the prewarm starts at 96 of 128),
    a round, forty more, the crossing round at 256.  Returns the
    synchronous recaptures the crossing round paid with their attribution,
    and the prewarm's capture ms."""
    from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY
    from orion_tpu_torch.telemetry import TELEMETRY

    algo = _make_algo(11, device, prewarm=prewarm)
    rng = np.random.default_rng(11)
    was = TELEMETRY.enabled
    TELEMETRY.enabled = True
    try:
        for n_new, suggest in ((90, True), (10, True), (40, False)):
            x = rng.uniform(size=(n_new, 6)).astype(np.float32)
            _observe(algo, x, _hartmann6(x))
            algo._prewarmer.wait()
            if suggest:
                algo.suggest(q)
        if algo._hist.fit_view()[0].shape[0] != 256:
            raise AssertionError("the crossing round does not fit at 256 rows")
        TELEMETRY.drain_spans()
        t0 = time.perf_counter()
        algo.suggest(q)
        _sync(device)
        crossing_ms = (time.perf_counter() - t0) * 1e3
        spans = TELEMETRY.drain_spans()
        warmed = [e for e in COMPILE_REGISTRY.entries()
                  if e.kind == "prewarm" and e.fields["fit_bucket"] == 256
                  and e.fields["q"] == str(q)]
    finally:
        TELEMETRY.enabled = was
    recaptures = [s["args"]["changed"] for s in spans
                  if s["name"] == "cuda_graph.capture" and s["args"]["kind"] == "recapture"]
    return {"prewarm": prewarm, "q": q, "crossing_round_ms": crossing_ms,
            "recaptures": len(recaptures), "attribution": recaptures,
            "prewarm_capture_ms": warmed[-1].seconds * 1e3 if warmed else None,
            "prewarm_failed": algo._prewarmer.failed_count()}


def run_pool_bound(device):
    """(c) The shared pool's bytes after every signature this process
    captured, against the pools of the heaviest signatures (largest q x
    candidates) captured alone, each in a fresh pool from its own static
    inputs.  Measuring a subset alone can only lower the largest single
    pool, which makes the bound stricter, never looser."""
    import gc

    from orion_tpu_torch.algo import tpu_bo as tbo
    from orion_tpu_torch.algo.step_graphs import (
        POOL_BOUND, STEP_GRAPHS, StepGraphs, graph_pool_bytes)
    from torch.utils import _pytree as pytree

    entries = [(sig, entry) for dev, sig, entry in STEP_GRAPHS.entries()
               if entry.graph is not None]
    gc.collect()
    torch.cuda.empty_cache()  # the dead graphs' pools: only live ones stay
    shared, process = STEP_GRAPHS.pool_bytes(), graph_pool_bytes()
    heavy = sorted(entries, key=lambda se: -int(se[1].statics["q"])
                   * int(se[1].statics["n_candidates"]))[:3]
    alone = []
    for sig, entry in heavy:
        graphs = StepGraphs()
        arrays = pytree.tree_unflatten([t.clone() if torch.is_tensor(t) else t
                                        for t in entry.static_in], entry.in_spec)
        graphs.run(tbo._suggest_step, sig, arrays, entry.statics)
        alone.append({"fit_bucket": sig[0][0], "width": sig[0][1], "q": entry.statics["q"],
                      "pool_bytes": graphs.pool_bytes()})
        graphs.reset()
        del graphs, arrays
    largest = max(a["pool_bytes"] for a in alone)
    out = {"signatures": len(entries), "shared_pool_bytes": shared,
           "process_graph_pool_bytes": process, "largest_alone_bytes": largest,
           "alone": alone, "ratio": shared / largest, "process_ratio": process / largest,
           "bound": POOL_BOUND, "fresh_pools": STEP_GRAPHS.fresh_pools,
           "alone_captures": STEP_GRAPHS.alone_captures,
           "stranded_bytes": STEP_GRAPHS.stranded_bytes}
    if max(shared, process) > POOL_BOUND * largest:
        raise AssertionError(f"the graph pools hold {shared} bytes (the step graphs') and "
                             f"{process} (the process's), over {POOL_BOUND} x the largest "
                             f"signature's {largest}")
    return out


def _device_plane_worker(path):
    """A worker process writing the ``device_plane`` store: an
    ``ExperimentClient`` loop with telemetry and the flight recorder on, at
    the main path's width (q=1024, three rounds: one random, two GP) with
    speculative suggest,
    so the producer books the device windows the host/device ratio reads;
    the last flush forced, as a ``hunt`` worker's is.  Its first GP round
    is this process's first capture."""
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.health import FLIGHT
    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.telemetry import TELEMETRY

    import orion_tpu_torch.device  # noqa: F401  (precision switches)

    TELEMETRY.enabled = FLIGHT.enabled = True
    storage = create_storage({"type": "sqlite", "path": path})
    exp = build_experiment(storage, "device_plane", priors=HUNT_PRIORS, max_trials=3072,
                           algorithms={"tpu_bo": dict(ALGO, speculative_suggest=True)},
                           pool_size=Q).instantiate(seed=0)
    client = ExperimentClient(exp)
    while not client.is_done:
        trials = client.suggest(Q)
        cube = torch.as_tensor(exp.space.params_to_cube([t.params for t in trials]),
                               device=exp.algorithm.device)
        client.observe_all(trials, hartmann6(cube).cpu().numpy().tolist())
    client.producer._flush_timings(force_metrics=True)


def run_device_plane_commands(device, tmp):
    """(d) ``profile``, ``top --json`` and ``info`` on the store one worker
    process wrote (:func:`_device_plane_worker`), run in this process."""
    import io

    from orion_tpu_torch.cli import main as cli_main
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.storage.base import create_storage

    path = os.path.join(tmp, "device_plane.sqlite")
    proc = multiprocessing.get_context("spawn").Process(target=_device_plane_worker,
                                                        args=(path,))
    t0 = time.perf_counter()
    proc.start()
    proc.join(300)
    if proc.exitcode != 0:
        proc.kill()
        raise AssertionError(f"the device-plane worker exited {proc.exitcode}")
    worker_s = time.perf_counter() - t0

    def run(*argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = cli_main(list(argv))
        return rc, out.getvalue()

    base = ["-n", "device_plane", "--storage-path", path]
    rc_profile, profile = run("profile", *base, "--json")
    rc_top, top = run("top", *base, "--json")
    rc_info, info = run("info", *base)
    profile, top = json.loads(profile), json.loads(top)
    storage = create_storage({"type": "sqlite", "path": path})
    health = storage.fetch_health(build_experiment(storage, "device_plane",
                                                   priors=HUNT_PRIORS))
    [worker] = top["workers"].values()
    out = {"worker_s": worker_s, "profile_captures": profile["compiles"],
           "profile_retraces": profile["retraces"], "profile_counters": profile["counters"],
           "profile_gauges": profile["gauges"],
           "top_worker": {k: worker[k] for k in ("rounds", "compiles", "retraces", "mem_mb",
                                                 "host_device_ratio")},
           "info_compiler": [line for line in info.splitlines()
                             if line.startswith(("captures:", "capture time", "HBM:"))],
           "info_ratio": [line for line in info.splitlines()
                          if line.startswith("host/device ratio")],
           "health_mem_bytes": [d.get("mem_bytes") for d in health]}
    if not (rc_profile == rc_top == rc_info == 0 and out["profile_captures"]
            and worker["compiles"] and out["info_ratio"] and any(out["health_mem_bytes"])
            and [line for line in out["info_compiler"] if line.startswith("HBM: plan max")]):
        raise AssertionError(f"device-plane commands: {out}")
    return out


def phase_device_plane(device, tmp):
    """The device plane: (a) eager against replayed rounds, (b) a bucket
    crossing with and without the prewarmer, (c) the shared pool's bound,
    (d) the commands over a telemetry store.  Returns ``fused_gram``'s
    launches over the phase (zeroed just before, read just after)."""
    from orion_tpu_torch.ops import gram

    gram.fused_gram.launches = 0
    main_algo = _make_algo(0, device)
    x = np.random.default_rng(0).uniform(size=(N_HISTORY, 6)).astype(np.float32)
    _observe(main_algo, x, _hartmann6(x))
    emit("device_plane", part="eager_vs_replay", **run_eager_against_replay(
        main_algo, lambda: main_algo.fused_step_plan(Q), "tpu_bo"))
    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.benchmarks.functions import BENCHMARKS
    from orion_tpu_torch.benchmarks.runner import PRESETS
    from orion_tpu_torch.space.dsl import build_space

    preset = PRESETS["asha_bo-ackley50"]
    space = build_space(preset["priors"])
    asha = create_algo(space, preset["algorithm"], seed=0, device=device)
    params = asha.suggest(512)
    cube = space.params_to_cube(params)
    values = BENCHMARKS["ackley50"]["fn"](torch.from_numpy(cube)).numpy()
    asha.observe(params, [{"objective": float(v)} for v in values])
    emit("device_plane", part="eager_vs_replay", **run_eager_against_replay(
        asha, lambda: asha._gp_plan(512), "asha_bo"))
    # Without the prewarmer first (q=64), then with it (q=32): the crossing
    # round of each run is a signature no earlier run captured.
    off = run_bucket_crossing(device, prewarm=False, q=64)
    on = run_bucket_crossing(device, prewarm=True, q=32)
    emit("device_plane", part="crossing", runs=[off, on])
    if (off["attribution"] != ["fit_bucket 128→256"] or on["recaptures"] != 0
            or on["prewarm_capture_ms"] is None):
        raise AssertionError(f"bucket crossing: {off} {on}")
    emit("device_plane", part="pool", **run_pool_bound(device))
    emit("device_plane", part="commands", **run_device_plane_commands(device, tmp))
    return gram.fused_gram.launches


#: The ``diagnosis`` phase: the doctor over what the card's rounds produce
#: and the runtime sanitizer over the device plane's threads, at the main
#: path's width (``tpu_bo``, 16384 candidates, q=1024).
DIAGNOSIS_TRIALS = 32  # past the seeded HISTORY: one GP round at q=1024
DOCTOR_INTERVAL = 2.0  # seconds between the hunt worker's watchdog passes
#: (b)'s q of each round after the random one: every q bucket in turn, so
#: that each round has a signature no earlier round had (the fit bucket
#: grows between the cycles).
FORK_QS = (8, 16, 32, 64, 128, 256, 512, 1024)
#: (b)'s first, random, round: 72 points put the GP rounds at a 128-row fit
#: buffer or more, where every round's pool cross-gram is ``fused_gram``'s.
FORK_FIRST_Q = 72
FORK_MAX_ROUNDS = 20
DOCTOR_SEVERITIES = ("info", "warn", "critical")


def _doctor_samples(text):
    """``orion_tpu_doctor_findings`` samples of one exposition:
    ``[(rule, severity, value)]``."""
    out = []
    for name, value in parse_exposition(text).items():
        match = re.match(r'^orion_tpu_doctor_findings\{rule="([^"]+)",severity="([^"]+)"\}$',
                         name)
        if match:
            out.append((match.group(1), match.group(2), value))
    return out


def _seeded_store(run_dir, name, device, algo):
    """The user script, a SQLite file with ``HISTORY`` completed trials of
    ``name`` (:func:`seed_history`) and the executions log; returns them
    with the history's ids."""
    script, algo_config = write_cli_files(run_dir, algo)
    db, log = os.path.join(run_dir, f"{name}.sqlite"), os.path.join(run_dir, f"{name}.log")
    from orion_tpu_torch.storage.base import create_storage

    storage = create_storage({"type": "sqlite", "path": db})
    history = seed_history(storage, name, ["-c", algo_config, "--storage-path", db], script,
                           log, device)
    return script, db, log, storage, history


def _gp_rounds(storage, exp_id, n_candidates):
    """The GP rounds the store's spans book (a capture or a replay each),
    those on ``fused_gram``'s route apart."""
    from orion_tpu_torch.algo.gp.kernels import _FUSED_MIN_WORK

    rounds = [s for s in storage.fetch_spans(exp_id)
              if s["name"] in ("suggest_step.dispatch", "suggest_step.capture")]
    fused = [s for s in rounds
             if n_candidates * s["args"]["n"] * MAIN_SHAPE[2] >= _FUSED_MIN_WORK]
    return rounds, fused


def run_diagnosis_healthy(run_dir, device, q=CLI_Q, max_trials=DIAGNOSIS_TRIALS,
                          algo=CLI_ALGO, timeout=300):
    """(a) One ``hunt`` worker with ``doctor_interval:``, telemetry and a
    free ``metrics_port``, ``max_trials`` past a seeded history: while it
    runs, ``/healthz`` must carry a ``doctor`` block and ``/metrics`` the
    ``orion_tpu_doctor_findings`` family with declared severities only, and
    this process times watchdog passes over the same store; after it,
    ``doctor --json`` exits 0 with no critical finding, ``info`` prints a
    doctor line and ``top --json`` has a doctor block.  The worker's GP
    rounds launch ``fused_gram`` at the main shape (its trace)."""
    import threading

    import yaml

    from orion_tpu_torch.core.experiment import ExperimentView, build_experiment
    from orion_tpu_torch.diagnosis.watch import DoctorWatchdog

    script, db, log, storage, history = _seeded_store(run_dir, "doc", device, algo)
    port = _free_port()
    config = os.path.join(run_dir, "doctor.yaml")
    with open(config, "w") as handle:
        yaml.safe_dump({"telemetry": True, "metrics_port": port,
                        "doctor_interval": DOCTOR_INTERVAL,
                        "algorithms": {"tpu_bo": dict(algo)}}, handle)
    prof = os.path.join(run_dir, "doctor-profile")
    done_event, result = threading.Event(), {}

    def hunt():
        try:
            result["wall_s"] = run_cohort([(_cli_command(
                "-n", "doc", "-c", config, "--storage-path", db, "--pool-size", str(q),
                "--max-trials", str(HISTORY + max_trials), "--profile", prof,
                "--device", device.type, script, *CLI_PRIORS, "--log", log), run_dir)], timeout)
        except BaseException as exc:  # re-raised below, in the phase's thread
            result["error"] = exc
        finally:
            done_event.set()

    experiment = ExperimentView(build_experiment(storage, "doc"))
    watchdog = DoctorWatchdog(experiment, DOCTOR_INTERVAL)
    healthz, samples, pass_ms = [], [], []
    thread = threading.Thread(target=hunt)
    thread.start()
    while not done_event.is_set():
        t0 = time.perf_counter()
        watchdog.tick()
        pass_ms.append((time.perf_counter() - t0) * 1e3)
        try:
            healthz.append(json.loads(_http_get(port, "/healthz")[2]))
            samples.append(_doctor_samples(_http_get(port, "/metrics")[2]))
        except OSError:  # the worker's server not up yet, or gone
            pass
        done_event.wait(1.0)
    thread.join()
    if "error" in result:
        raise result["error"]
    fleet = _check_fleet("doc", storage, log, prof, max_trials, device, history)
    rc, body, doctor_ms = _cli_output(["doctor", "-n", "doc", "--storage-path", db, "--json"])
    report = json.loads(body)
    rc_info, info, _ = _cli_output(["info", "-n", "doc", "--storage-path", db])
    rc_top, top, _ = _cli_output(["top", "-n", "doc", "--storage-path", db, "--json"])
    doctor_line = [line for line in info.splitlines() if line.startswith("doctor:")]
    blocks = [h["doctor"] for h in healthz if "doctor" in h]
    published = [s for s in samples if s]
    severities = {sev for sample in published for _, sev, _ in sample}
    out = {"trials": len(fleet["trials"]), "completed": len(fleet["done"]),
           "wall_s": result["wall_s"], "doctor_exit": rc, "doctor_ms": doctor_ms,
           "status": report["status"], "critical": report["critical"],
           "findings": [(f["rule"], f["severity"], f.get("value")) for f in report["findings"]],
           "watchdog_pass_ms": pass_ms, "median_watchdog_pass_ms": _median(pass_ms),
           "healthz_doctor": blocks[-1] if blocks else None, "scrapes": len(healthz),
           "findings_samples": len(published[-1]) if published else 0,
           "severities": sorted(severities), "info_doctor": doctor_line,
           "top_doctor": json.loads(top).get("doctor") if rc_top == 0 else None,
           "fused_gram_launches": fleet["launches"], "launch_shapes": fleet["launch_shapes"]}
    if (rc != 0 or report["critical"] or not blocks or not published
            or not severities <= set(DOCTOR_SEVERITIES) or rc_info != 0 or not doctor_line
            or out["top_doctor"] is None):
        raise AssertionError(f"diagnosis (a): {out}")
    return out


def run_diagnosis_fork(run_dir, device, qs=FORK_QS, max_rounds=FORK_MAX_ROUNDS):
    """(b) ``tpu_bo`` at the main path's configuration through an
    ``ExperimentClient`` on SQLite in this process, telemetry on, each GP
    round at the next q bucket of ``qs`` (a signature no earlier round
    had), until the round count and the recaptures pass DX001's bars:
    ``run_rules(local_snapshot())`` must then hold DX001 as critical, and
    ``doctor --json`` over the store exit 1 naming it.  The captures come
    in ascending q, the order that fragments a shared pool most: the pool
    after them is held to ``POOL_BOUND`` times the largest signature it
    holds, captured alone (:func:`run_pool_bound`, which raises), and each
    entry's pool bytes, growth and footprint measured alone are reported
    with the step graphs' alone captures, fresh pools and stranded
    bytes."""
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS
    from orion_tpu_torch.benchmarks.functions import hartmann6
    from orion_tpu_torch.client.experiment import ExperimentClient
    from orion_tpu_torch.compiler_plane import COMPILE_REGISTRY
    from orion_tpu_torch.core.experiment import build_experiment
    from orion_tpu_torch.diagnosis import local_snapshot, run_rules
    from orion_tpu_torch.diagnosis.rules_system import RecaptureStorm
    from orion_tpu_torch.health import FLIGHT
    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.storage.base import create_storage
    from orion_tpu_torch.telemetry import TELEMETRY

    was = TELEMETRY.enabled, FLIGHT.enabled
    TELEMETRY.reset()
    FLIGHT.clear()
    COMPILE_REGISTRY.reset()
    STEP_GRAPHS.reset()
    TELEMETRY.enabled = FLIGHT.enabled = True
    try:
        db = os.path.join(run_dir, "fork.sqlite")
        storage = create_storage({"type": "sqlite", "path": db})
        exp = build_experiment(storage, "fork", priors=HUNT_PRIORS, max_trials=100000,
                               pool_size=8, algorithms={"tpu_bo": dict(ALGO)}
                               ).instantiate(seed=0, device=device)
        client = ExperimentClient(exp)
        rounds = []
        for i in range(max_rounds + 1):
            q = FORK_FIRST_Q if i == 0 else qs[(i - 1) % len(qs)]
            t0 = time.perf_counter()
            trials = client.suggest(q)
            cube = torch.as_tensor(exp.space.params_to_cube([t.params for t in trials]),
                                   device=exp.algorithm.device)
            client.observe_all(trials, hartmann6(cube).cpu().numpy().tolist())
            rounds.append({"q": q, "ms": (time.perf_counter() - t0) * 1e3})
            counters = TELEMETRY.snapshot()["counters"]
            recaptures = counters.get("cuda_graph.recaptures", 0)
            if (len(rounds) >= RecaptureStorm.MIN_ROUNDS and recaptures >= max(
                    RecaptureStorm.MIN_RETRACES, RecaptureStorm.RETRACES_PER_ROUND * len(rounds))):
                break
        client.producer._flush_timings(force_metrics=True)
        snapshot = local_snapshot()
        report = run_rules(snapshot)
        entries = [e for e in COMPILE_REGISTRY.entries() if e.kind == "recapture"]
        captures = [{"fit_bucket": sig[0][0], "q": e.statics["q"], "pool_bytes": e.pool_bytes,
                     "grew_bytes": e.grew_bytes, "alone_bytes": e.alone_bytes}
                    for _dev, sig, e in STEP_GRAPHS.entries() if e.graph is not None]
        launches = gram.fused_gram.launches
        pool = run_pool_bound(device)
        gram.fused_gram.launches = launches  # the signatures alone: a measurement's launches
        health = storage.fetch_health(exp)
    finally:
        TELEMETRY.reset()
        FLIGHT.clear()
        TELEMETRY.enabled, FLIGHT.enabled = was
    rc, body, doctor_ms = _cli_output(["doctor", "-n", "fork", "--storage-path", db, "--json"])
    stored = json.loads(body)
    local = [(f.rule_id, f.severity, f.value) for f in report.findings]
    result = {"rounds": rounds, "producer_rounds": snapshot.rounds(),
              "health_records": len(health), "recaptures": len(entries),
              "recapture_ms": [round(e.seconds * 1e3, 3) for e in entries],
              "recapture_signatures": [f"fit_bucket={e.fields['fit_bucket']} q={e.fields['q']}"
                                       for e in entries],
              "pool_bytes": pool["shared_pool_bytes"], "pool": pool,
              "pool_entries": captures, "local_findings": local,
              "doctor_exit": rc, "doctor_ms": doctor_ms,
              "stored_findings": [(f["rule"], f["severity"], f.get("value"))
                                  for f in stored["findings"]]}
    if (("DX001", "critical") not in [(r, s) for r, s, _ in local] or rc != 1
            or "DX001" not in [r for r, _, _ in result["stored_findings"]]
            or len(health) < RecaptureStorm.MIN_ROUNDS - 1):
        raise AssertionError(f"diagnosis (b): {result}")
    return result


def run_diagnosis_tsan(run_dir, device, q=CLI_Q, max_trials=DIAGNOSIS_TRIALS, workers=2,
                       algo=CLI_ALGO, timeout=400):
    """(c) ``orion-tpu-torch tsan -- hunt --n-workers 2`` with telemetry,
    the watchdog and the prewarmer on, ``max_trials`` past a seeded
    history at q=1024: every process of the run (the workers and each
    trial's user script) merges into one report, which must hold no race,
    no lock-order cycle and no LCK003 finding; each GP round the store's
    spans book launched ``fused_gram`` (the workers' traces)."""
    import yaml

    algo = dict(algo, prewarm=True)
    script, db, log, storage, history = _seeded_store(run_dir, "tsan", device, algo)
    config = os.path.join(run_dir, "tsan.yaml")
    with open(config, "w") as handle:
        yaml.safe_dump({"telemetry": True, "doctor_interval": DOCTOR_INTERVAL,
                        "algorithms": {"tpu_bo": algo}}, handle)
    prof, report_path = os.path.join(run_dir, "tsan-profile"), os.path.join(run_dir, "tsan.json")
    argv = [sys.executable, "-m", "orion_tpu_torch.cli", "tsan", "--seed", "0", "--format",
            "json", "--out", report_path, "--", *_cli_command(
                "-n", "tsan", "-c", config, "--storage-path", db, "--pool-size", str(q),
                "--max-trials", str(HISTORY + max_trials), "--n-workers", str(workers),
                "--profile", prof, "--device", device.type, script, *CLI_PRIORS, "--log", log)]
    proc = subprocess.Popen(argv, env=dict(os.environ, PYTHONPATH=ROOT), cwd=run_dir,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    t0 = time.perf_counter()
    try:
        _, err = proc.communicate(timeout=timeout)
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, 9)
            proc.wait()
    wall_s = time.perf_counter() - t0
    with open(report_path) as handle:
        report = json.load(handle)
    fleet = _check_fleet("tsan", storage, log, prof, max_trials, device, history)
    rounds, fused = _gp_rounds(storage, fleet["exp_id"], algo["n_candidates"])
    check = report.get("cross_check") or {}
    out = {"workers": workers, "q": q, "trials": len(fleet["trials"]),
           "completed": len(fleet["done"]), "wall_s": wall_s, "exit_code": proc.returncode,
           "processes": report.get("processes"), "races": report["races"],
           "lock_order_cycles": report["lock_order_cycles"], "edges": len(report["edges"]),
           "switches": report["switches"], "instrumented_locks": sum(report["locks"].values()),
           "lock_ids": len(report["locks"]), "annotated_accesses": report["accesses"],
           "annotated_cells": len(report["cells"]),
           "cross_check": {k: len(v) for k, v in check.items()},
           "lck003": check.get("lck003"), "gp_rounds": len(rounds), "fused_rounds": len(fused),
           "fused_gram_launches": fleet["launches"], "launch_shapes": fleet["launch_shapes"]}
    if (proc.returncode != 0 or report["races"] or report["lock_order_cycles"]
            or check.get("lck003") or check.get("confirmed_static_cycles")
            or fleet["launches"] != len(fused) or not fused):
        raise AssertionError(f"diagnosis (c): {out}\n{err[-3000:]}")
    return out


def phase_diagnosis(device, tmp):
    """The doctor and the sanitizer on the card: (a) a healthy hunt worker
    with its watchdog, (b) a provoked signature fork, DX001 from the card's
    own recaptures, (c) ``tsan`` over a two-worker hunt.  Returns
    ``fused_gram``'s launches in each leg."""
    from orion_tpu_torch.ops import gram

    run_dir = os.path.join(tmp, "diagnosis")
    os.makedirs(run_dir)
    healthy = run_diagnosis_healthy(run_dir, device)
    emit("diagnosis", leg="healthy", **healthy)
    gram.fused_gram.launches = 0
    fork = run_diagnosis_fork(run_dir, device)
    fork_launches = gram.fused_gram.launches
    emit("diagnosis", leg="fork", fused_gram_launches=fork_launches, **fork)
    if fork_launches != fork["recaptures"]:
        raise AssertionError(f"diagnosis (b): {fork_launches} fused_gram launches in "
                             f"{fork['recaptures']} GP rounds")
    tsan = run_diagnosis_tsan(run_dir, device)
    emit("diagnosis", leg="tsan", **tsan)
    return {"healthy": healthy["fused_gram_launches"], "fork": fork_launches,
            "tsan": tsan["fused_gram_launches"]}


#: The ``serve`` phase: the suggest gateway at the main path's width.
SERVE_TENANTS = 8  # (a)'s tenants: one dispatch of width 8
SERVE_ROUNDS = 4
SERVE_WINDOW = 0.25  # seconds the dispatcher waits for the other tenants
SERVE_TRIALS = 16  # (b)'s trials past each experiment's seeded HISTORY
SERVE_DX = ("DX005", "DX007", "DX008")


def _rows_of(params):
    return np.asarray([[p[f"x{i}"] for i in range(6)] for p in params], dtype=np.float32)


def _bitwise_equal(a, b):
    """Two tensors bit for bit (a NaN equals the same NaN; ``torch.equal``
    calls any NaN unequal, and a failed Cholesky leaves NaNs in a state)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


def _state_leaves(state):
    """A GPState's tensor leaves, copied to the host."""
    from torch.utils import _pytree as pytree

    return [leaf.detach().cpu().clone() for leaf in pytree.tree_leaves(state)
            if torch.is_tensor(leaf)]


def _serve_tenant(gateway, seed, rounds, barrier, out, name):
    """One tenant of (a): a ``RemoteAlgorithm`` on ``gateway`` (in this
    process) with the main path's seeded history, then ``rounds`` of a
    barriered ``suggest(Q)`` and an observe of its rows' Hartmann6 values;
    after each suggest, the tenant's GPState as the gateway holds it."""
    from orion_tpu_torch.serve.client import GatewayClient, RemoteAlgorithm
    from orion_tpu_torch.space.dsl import build_space

    try:
        host, port = gateway.address
        algo = RemoteAlgorithm(build_space(HUNT_PRIORS), HUNT_PRIORS, {"tpu_bo": dict(ALGO)},
                               GatewayClient(host=host, port=port, timeout=600), name,
                               seed=seed)
        x = np.random.default_rng(seed).uniform(size=(N_HISTORY, 6)).astype(np.float32)
        _observe(algo, x, _hartmann6(x))
        record = out[seed] = {"rows": [], "states": [], "ms": [], "start": []}
        for _ in range(rounds):
            barrier.wait(timeout=900)
            record["start"].append(time.perf_counter())
            rows = _rows_of(algo.suggest(Q))
            record["ms"].append((time.perf_counter() - record["start"][-1]) * 1e3)
            record["rows"].append(rows)
            record["states"].append(_state_leaves(gateway._tenants[name].algo._gp_state))
            _observe(algo, rows, _hartmann6(rows))
    except BaseException as exc:  # re-raised by the phase, after the join
        out.setdefault("errors", []).append(exc)
        barrier.abort()


def run_serve_gateway(device, max_width, tenants=SERVE_TENANTS, rounds=SERVE_ROUNDS):
    """One in-process ``GatewayServer(device, max_width)`` and ``tenants``
    tenants of seeds 0.. driven by :func:`_serve_tenant` in threads; returns
    their records, the gateway's stats, each round's wall ms (first start to
    last reply) and the ``fused_gram`` launches over the rounds."""
    import threading

    from orion_tpu_torch.ops import gram
    from orion_tpu_torch.serve.gateway import GatewayServer

    gateway = GatewayServer(window=SERVE_WINDOW, max_width=max_width, device=device)
    gateway.serve_background()
    out, barrier = {}, threading.Barrier(tenants)
    try:
        gram.fused_gram.launches = 0
        threads = [threading.Thread(target=_serve_tenant,
                                    args=(gateway, seed, rounds, barrier, out, f"t{seed}"))
                   for seed in range(tenants)]
        for thread in threads:
            thread.start()
        for thread in threads:
            thread.join(1800)
        launches = gram.fused_gram.launches
        if out.get("errors"):
            raise out["errors"][0]
        stats = gateway.stats_snapshot()
    finally:
        gateway.shutdown()
        gateway.server_close()
    walls = [max(out[s]["start"][r] + out[s]["ms"][r] / 1e3 for s in range(tenants))
             - min(out[s]["start"][r] for s in range(tenants)) for r in range(rounds)]
    return {"records": out, "stats": stats, "round_ms": [w * 1e3 for w in walls],
            "launches": launches}


def run_serve_coalesced(device):
    """(a) Eight tenants through one gateway of ``max_width=8``, then the
    same seeds through one of ``max_width=1`` (each served alone): rows and
    GPState of every tenant and round bitwise equal, one dispatch of width
    8 per round launching ``fused_gram`` once a tenant, the step graphs
    holding only the standalone round's signature (launched at the main
    shape) and the pool no larger after the coalesced gateway than after
    the one served alone.  The plan-prep cache's hit and miss cost over
    both gateways' rounds (the whole of ``make_fused_plan``, its draws
    included)."""
    from orion_tpu_torch.algo import tpu_bo as tbo
    from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS

    tbo.reset_plan_prep_stats()
    coalesced = run_serve_gateway(device, max_width=SERVE_TENANTS)
    pool_coalesced = STEP_GRAPHS.pool_bytes()
    alone = run_serve_gateway(device, max_width=1)
    pool_alone = STEP_GRAPHS.pool_bytes()
    equal_rows = [[bool(np.array_equal(coalesced["records"][s]["rows"][r],
                                       alone["records"][s]["rows"][r]))
                   for r in range(SERVE_ROUNDS)] for s in range(SERVE_TENANTS)]
    equal_states = [[all(_bitwise_equal(a, b) for a, b in zip(
        coalesced["records"][s]["states"][r], alone["records"][s]["states"][r]))
        for r in range(SERVE_ROUNDS)] for s in range(SERVE_TENANTS)]
    signatures = [{"q": e.statics["q"], "capture_ms": e.capture_ms,
                   "instantiate_ms": e.instantiate_ms, "graph_nodes": e.graph_nodes,
                   "pool_bytes": e.pool_bytes, "launches_in_graph": len(e.launches),
                   "launch_shapes": sorted({"x".join(map(str, launch[:3]))
                                            for launch in e.launches})}
                  for _dev, _sig, e in STEP_GRAPHS.entries() if e.graph is not None]
    suggestions = SERVE_TENANTS * Q

    def rate(run):
        return {"first_round_ms": run["round_ms"][0], "round_ms": run["round_ms"],
                "suggestions_per_s": suggestions * (SERVE_ROUNDS - 1)
                / (sum(run["round_ms"][1:]) / 1e3)}

    out = {"tenants": SERVE_TENANTS, "rounds": SERVE_ROUNDS, "q": Q,
           "widths": coalesced["stats"]["widths"], "alone_widths": alone["stats"]["widths"],
           "dispatches": coalesced["stats"]["dispatches"],
           "alone_dispatches": alone["stats"]["dispatches"],
           "signatures": signatures, "pool_bytes_coalesced": pool_coalesced,
           "pool_bytes_alone": pool_alone, "plan_prep": tbo.plan_prep_stats(),
           "coalesced": rate(coalesced), "alone": rate(alone),
           "rows_equal": equal_rows, "states_equal": equal_states,
           "fused_gram_launches": coalesced["launches"],
           "alone_fused_gram_launches": alone["launches"]}
    main = "x".join(map(str, MAIN_SHAPE))
    if (coalesced["stats"]["widths"] != {str(SERVE_TENANTS): SERVE_ROUNDS}
            or alone["stats"]["widths"] != {"1": SERVE_TENANTS * SERVE_ROUNDS}
            or not all(map(all, equal_rows)) or not all(map(all, equal_states))
            or len(signatures) != 1 or signatures[0]["launch_shapes"] != [main]
            or pool_coalesced != pool_alone
            or coalesced["launches"] != SERVE_TENANTS * SERVE_ROUNDS
            or alone["launches"] != SERVE_TENANTS * SERVE_ROUNDS):
        raise AssertionError(f"serve (a): {out}")
    return out


class _ServeProcess:
    """``orion-tpu-torch serve`` as a subprocess (its own session): started
    on ``port`` with ``--persist``, stopped by SIGINT (its final snapshot)
    or killed with its session on the way out."""

    def __init__(self, run_dir, port, persist):
        self.argv = [sys.executable, "-m", "orion_tpu_torch.cli", "serve", "--host",
                     "127.0.0.1", "--port", str(port), "--no-auth", "--window-ms",
                     str(SERVE_WINDOW * 1e3), "--persist", persist]
        self.run_dir, self.address, self.proc, self.starts = run_dir, ("127.0.0.1", port), \
            None, 0
        self.t0 = None

    def launch(self):
        self.starts += 1
        log = open(os.path.join(self.run_dir, f"gateway-{self.starts}.log"), "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(self.argv, env=dict(os.environ, PYTHONPATH=ROOT,
                                                         PYTHONUNBUFFERED="1"),
                                     cwd=self.run_dir, stdout=subprocess.PIPE, stderr=log,
                                     text=True, start_new_session=True)
        log.close()

    def ready(self, timeout=300):
        """Wait for the listening line; returns the ms since the launch."""
        import select

        ready, _, _ = select.select([self.proc.stdout], [], [], timeout)
        line = self.proc.stdout.readline() if ready else ""
        if "listening on" not in line:
            self.kill()
            raise AssertionError(f"serve: the gateway did not start: {line!r}")
        return (time.perf_counter() - self.t0) * 1e3

    def start(self, timeout=300):
        self.launch()
        return self.ready(timeout)

    def stop(self, timeout=120):
        self.proc.send_signal(signal.SIGINT)
        rc = self.proc.wait(timeout)
        if rc != 0:
            raise AssertionError(f"serve: the gateway exited {rc} on SIGINT")

    def kill(self):
        if self.proc is not None and self.proc.poll() is None:
            os.killpg(self.proc.pid, 9)
            self.proc.wait()


def _watch_workers(procs, timeout):
    """Wait for ``procs``, sampling each one's ``/dev/nvidia*`` files every
    0.2 s while it runs and ``nvidia-smi``'s compute apps every 2 s; returns
    the files seen per worker and the most compute apps seen."""
    seen = {proc.pid: set() for proc in procs}
    most_apps, last_apps, t0 = 0, 0.0, time.perf_counter()
    while any(proc.poll() is None for proc in procs):
        if time.perf_counter() - t0 > timeout:
            raise AssertionError("serve (b): the workers outlived their time limit")
        for proc in procs:
            if proc.poll() is None:
                try:
                    seen[proc.pid].update(nvidia_files(proc.pid))
                except (FileNotFoundError, ProcessLookupError):
                    pass
        if time.perf_counter() - last_apps >= 2.0:
            most_apps, last_apps = max(most_apps, len(compute_apps())), time.perf_counter()
        time.sleep(0.2)
    return {pid: sorted(files) for pid, files in seen.items()}, most_apps


def run_serve_workers(run_dir, device, gateway, max_trials=SERVE_TRIALS, q=CLI_Q,
                      algo=CLI_ALGO, timeout=600):
    """(b) Two ``hunt`` workers of two experiments on one SQLite store, each
    ``max_trials`` past a history of ``HISTORY`` completed through the
    library, with a ``serve:`` section naming the subprocess ``gateway``
    and telemetry on: the GP rounds run on the gateway; no worker process
    opens a ``/dev/nvidia*`` file or adds to the compute apps; ``info``
    (one experiment and ``--all``) and ``top --json`` show the serve
    fields, and ``doctor`` over the store exits 0 with DX005, DX007 and
    DX008 silent."""
    import yaml

    from orion_tpu_torch.serve.client import GatewayClient
    from orion_tpu_torch.storage.base import create_storage

    script, _ = write_cli_files(run_dir, algo, name="serve-plain")
    config = os.path.join(run_dir, "serve.yaml")
    address = "%s:%d" % gateway.address
    with open(config, "w") as handle:
        yaml.safe_dump({"telemetry": True, "algorithms": {"tpu_bo": dict(algo)},
                        "serve": {"address": address, "timeout": 300}}, handle)
    db = os.path.join(run_dir, "serve.sqlite")
    storage = create_storage({"type": "sqlite", "path": db})
    names, logs, histories = ("serve-a", "serve-b"), {}, {}
    for seed, name in enumerate(names):
        logs[name] = os.path.join(run_dir, f"{name}.log")
        histories[name] = seed_history(storage, name, ["-c", config, "--storage-path", db],
                                       script, logs[name], device, completed=HISTORY,
                                       seed=seed)
    # The gateway creates its CUDA context with its first device work: one
    # random round of a throwaway tenant before counting, so the count
    # holds this process and the gateway, and a worker's context would add
    # to it.
    warm = GatewayClient(*gateway.address, timeout=300)
    warm.request("attach", {"tenant": "warm", "algo": {"random": {}}, "priors": HUNT_PRIORS,
                            "seed": 0})
    warm.request("suggest", {"tenant": "warm", "num": 1, "req_id": "warm:1"})
    warm.request("detach", {"tenant": "warm"})
    apps_before = len(compute_apps())
    env = dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(_cli_command(
        "-n", name, "-c", config, "--storage-path", db, "--pool-size", str(q),
        "--max-trials", str(HISTORY + max_trials), script, *CLI_PRIORS, "--log", logs[name]),
        env=env, cwd=run_dir, stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True,
        start_new_session=True) for name in names]
    try:
        files, most_apps = _watch_workers(procs, timeout)
        errors = [proc.stderr.read() for proc in procs]
    finally:
        for proc in procs:
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    wall_s = time.perf_counter() - t0
    failed = [(proc.returncode, err[-3000:]) for proc, err in zip(procs, errors)
              if proc.returncode != 0]
    if failed:
        raise AssertionError(f"serve (b): exit codes and stderr {failed}")
    completed = {}
    for name in names:
        _exp_id, trials = _fetch_trials(storage, name)
        done, _values, _err = check_cli_trials(f"serve {name}", trials,
                                               HISTORY + max_trials, device)
        with open(logs[name]) as handle:
            executed = handle.read().split()
        if len(executed) != len(set(executed)):
            raise AssertionError(f"serve {name}: a trial ran twice")
        completed[name] = len([t for t in done if t.id not in histories[name]])
    stats = warm.stats()
    warm.close()
    rc_info, info, _ = _cli_output(["info", "-n", names[0], "--storage-path", db])
    rc_all, info_all, _ = _cli_output(["info", "--all", "-c", config, "--storage-path", db])
    rc_top, top, _ = _cli_output(["top", "-n", names[0], "--storage-path", db, "--json"])
    serve_lines = [line for line in info.splitlines() if "serve_width" in line]
    fleet_line = [line for line in info_all.splitlines() if line.startswith("serve: ")]
    top_serve = [{k: (w.get("health") or {}).get(k)
                  for k in ("serve_width", "serve_queue_depth", "serve_tenants")}
                 for w in json.loads(top)["workers"].values()] if rc_top == 0 else None
    doctors = {}
    for name in names:
        rc, body, ms = _cli_output(["doctor", "-n", name, "--storage-path", db, "--json"])
        report = json.loads(body)
        doctors[name] = {"exit": rc, "ms": ms, "status": report["status"],
                         "findings": [(f["rule"], f["severity"]) for f in report["findings"]]}
    out = {"workers": len(names), "max_trials": max_trials, "q": q, "wall_s": wall_s,
           "completed": completed, "trials_per_s": sum(completed.values()) / wall_s,
           "nvidia_files": files, "compute_apps_before": apps_before,
           "compute_apps_most": most_apps, "gateway_widths": stats["widths"],
           "gateway_dispatches": stats["dispatches"], "gateway_tenants": stats["tenants"],
           "info_serve": serve_lines[-1:], "info_fleet": fleet_line, "top_serve": top_serve,
           "doctor": doctors}
    if (any(files.values()) or most_apps > apps_before
            or any(n < max_trials for n in completed.values())
            or rc_info != 0 or rc_all != 0 or not serve_lines or not fleet_line
            or not top_serve or not any(w["serve_width"] for w in top_serve)
            or any(d["exit"] != 0 or {r for r, _ in d["findings"]} & set(SERVE_DX)
                   for d in doctors.values())):
        raise AssertionError(f"serve (b): {out}")
    return out


def _persist_tenant(address, name, seed, rounds):
    """A ``RemoteAlgorithm`` of the main path's config and seeded history
    on ``address``: ``rounds`` rounds of ``suggest(Q)`` and observe; returns
    the tenant and each round's rows."""
    from orion_tpu_torch.serve.client import GatewayClient, RemoteAlgorithm
    from orion_tpu_torch.space.dsl import build_space

    algo = RemoteAlgorithm(build_space(HUNT_PRIORS), HUNT_PRIORS, {"tpu_bo": dict(ALGO)},
                           GatewayClient(*address, timeout=600), name, seed=seed)
    x = np.random.default_rng(seed).uniform(size=(N_HISTORY, 6)).astype(np.float32)
    _observe(algo, x, _hartmann6(x))
    return algo, [_round(algo) for _ in range(rounds)]


def _round(algo):
    rows = _rows_of(algo.suggest(Q))
    _observe(algo, rows, _hartmann6(rows))
    return rows


def run_serve_persist(device, gateway, seed=3):
    """(c) A tenant's round through the subprocess gateway; SIGINT (its
    final snapshot), a restart with the same ``--persist`` file on the same
    port; the tenant's next q=1024 round bitwise equal to that of a gateway
    in this process never stopped."""
    from orion_tpu_torch.serve.gateway import GatewayServer

    algo, rows = _persist_tenant(gateway.address, "persist", seed, 1)
    t0 = time.perf_counter()
    gateway.stop()
    restart_ms = gateway.start()
    after = _round(algo)
    down_ms = (time.perf_counter() - t0) * 1e3
    stats = algo._client.stats()["per_tenant"]["persist"]
    never = GatewayServer(window=0.01, device=device)
    never.serve_background()
    try:
        _, want = _persist_tenant(never.address, "persist", seed, 2)
    finally:
        never.shutdown()
        never.server_close()
    out = {"restart_ms": restart_ms, "restart_to_round_ms": down_ms,
           "first_round_equal": bool(np.array_equal(rows[0], want[0])),
           "round_after_restart_equal": bool(np.array_equal(after, want[1])),
           "n_observed": stats["n_observed"], "reconnects": algo._client.reconnects}
    if (not out["first_round_equal"] or not out["round_after_restart_equal"]
            or stats["n_observed"] != N_HISTORY + 2 * Q):
        raise AssertionError(f"serve (c): {out}")
    return out


def phase_serve(device, tmp):
    """The suggest gateway on the card: (a) eight tenants coalesced into one
    dispatch against the same tenants served alone, (b) two ``hunt``
    workers through an ``orion-tpu-torch serve`` subprocess (launched
    first, so that its start-up overlaps (a)), (c) that gateway restarted
    from its ``--persist`` file.  Returns ``fused_gram``'s launches in this
    process over the phase (zeroed just before, read just after; the
    subprocess gateway's own are not counted here).

    The step graphs' cache starts empty (``STEP_GRAPHS.reset()``, as
    ``diagnosis`` (b) resets it), so (a)'s pool check covers the phase's
    own signatures.  The process-wide pool before the reset (in the whole
    script, what ``diagnosis`` (b)'s fork of ten signatures left) is held
    to ``POOL_BOUND`` times the main signature's pool alone (the phase's
    first capture, into the emptied pool), and printed with (a)'s line."""
    import gc

    from orion_tpu_torch.algo.step_graphs import POOL_BOUND, STEP_GRAPHS, graph_pool_bytes
    from orion_tpu_torch.ops import gram

    run_dir = os.path.join(tmp, "serve")
    os.makedirs(run_dir)
    gc.collect()
    torch.cuda.empty_cache()  # the dead graphs' pools: only live ones stay
    process_pool = {"signatures": len(STEP_GRAPHS.entries()),
                    "pool_bytes": STEP_GRAPHS.pool_bytes(),
                    "process_graph_pool_bytes": graph_pool_bytes()}
    STEP_GRAPHS.reset()
    launches = {}
    gateway = _ServeProcess(run_dir, _free_port(), os.path.join(run_dir, "gateway.pkl"))
    try:
        gateway.launch()
        coalesced = run_serve_coalesced(device)
        launches["coalesced"] = coalesced["fused_gram_launches"]
        launches["alone"] = coalesced["alone_fused_gram_launches"]
        main_alone = coalesced["signatures"][0]["pool_bytes"]
        process_pool["over_main_signature_alone"] = process_pool["pool_bytes"] / main_alone
        process_pool["process_over_main_signature_alone"] = (
            process_pool["process_graph_pool_bytes"] / main_alone)
        emit("serve", leg="coalesced", process_pool_before_reset=process_pool, **coalesced)
        if max(process_pool["over_main_signature_alone"],
               process_pool["process_over_main_signature_alone"]) > POOL_BOUND:
            raise AssertionError(f"serve: the process-wide pool before the reset, "
                                 f"{process_pool}, is over {POOL_BOUND} x the main signature's")
        gateway.ready()
        workers = run_serve_workers(run_dir, device, gateway)
        emit("serve", leg="workers", **workers)
        gram.fused_gram.launches = 0
        persist = run_serve_persist(device, gateway)
        launches["persist"] = gram.fused_gram.launches
        emit("serve", leg="persist", **persist)
    finally:
        gateway.kill()
    return launches


#: The ``lint`` phase's planted capture cases.
CAPTURE_CASES = os.path.join("tests", "fixtures", "torch_lint", "capture_cases.py")


def _load_by_path(path):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        os.path.splitext(os.path.basename(path))[0], path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _span(fn):
    import inspect

    lines, first = inspect.getsourcelines(fn)
    return range(first, first + len(lines))


def run_lint_static():
    """(a) The capture rules and PERF003 over the port and this script."""
    from orion_tpu_torch.analysis import default_rules, run_lint

    select = ["JIT", "PERF003"]
    t0 = time.perf_counter()
    diagnostics = run_lint([os.path.join(ROOT, "orion_tpu_torch"), os.path.abspath(__file__)],
                           select=select)
    ms = (time.perf_counter() - t0) * 1e3
    rules = [r.id for r in default_rules() if any(r.id.startswith(p) for p in select)]
    out = {"rules": rules, "findings": [d.format() for d in diagnostics], "ms": ms}
    if diagnostics:
        raise AssertionError(f"lint (a): {out}")
    return out


def _lint_agrees(line):
    """Whether a planted case's lint verdict and card verdict agree: the
    flagged side is flagged and the safe one not; a flagged JIT003 case
    captures and replays stale, any other flagged case fails to capture; a
    safe twin captures and replays fresh."""
    if line["flagged"] != (line["side"] == "flagged"):
        return False
    if not line["flagged"]:
        return line["captured"] and line["fresh"]
    if line["rule"] == "JIT003":
        return line["captured"] and not line["fresh"]
    return not line["captured"]


def run_lint_cases(device):
    """(b) Each planted case linted, then captured on the card: the two
    verdicts must agree (a flagged case fails to capture or replays a
    stale value; a safe twin captures and replays fresh)."""
    from orion_tpu_torch.analysis import run_lint

    path = os.path.join(ROOT, CAPTURE_CASES)
    cases = _load_by_path(path)
    t0 = time.perf_counter()
    diagnostics = run_lint([path], select=["JIT"])
    lint_ms = (time.perf_counter() - t0) * 1e3
    lines = []
    for rule, name, flagged_site, flagged_body, safe_site, safe_body in cases.CASES:
        for side, site, body in (("flagged", flagged_site, flagged_body),
                                 ("safe", safe_site, safe_body)):
            spans = (_span(site), _span(body))
            linted = any(d.rule_id == rule and any(d.line in span for span in spans)
                         for d in diagnostics)
            captured, fresh = cases.card_verdict(site, body, device)
            lines.append({"rule": rule, "case": name, "side": side, "flagged": linted,
                          "captured": captured, "fresh": fresh})
    for line in lines:
        emit("lint", part="case", **line)
    bad = [line for line in lines if not _lint_agrees(line)]
    if bad:
        raise AssertionError(f"lint (b): lint and card disagree: {bad}")
    return {"cases": len(lines), "lint_ms": lint_ms}


def _planted_sync(device):
    """A host read the sync debug mode must report: (c)'s witness."""
    return torch.ones(1, device=device).sum().item()


def run_lint_syncs(device):
    """(c) Under ``set_sync_debug_mode("warn")``: first a planted
    ``.item()`` (:func:`_planted_sync`), which must be recorded with its
    frame, then one eager ``_suggest_step`` at the main path's width,
    after one unobserved warm-up round: every sync's Python frames; none
    may lie inside a function the capture rules treat as captured.
    Returns the counts and ``fused_gram``'s launches over the observed
    round."""
    import traceback
    import warnings

    from orion_tpu_torch.algo import tpu_bo as tbo
    from orion_tpu_torch.analysis.jit_rules import captured_spans
    from orion_tpu_torch.ops.gram import fused_gram

    rng = np.random.default_rng(0)
    algo = _make_algo(0, device)
    x = rng.uniform(size=(N_HISTORY, 6)).astype(np.float32)
    _observe(algo, x, _hartmann6(x))
    plan = algo.fused_step_plan(Q)
    tbo._suggest_step(*plan.arrays, **plan.statics)  # warm-up: lazy handles, the kernel's load
    _sync(device)
    spans = captured_spans([os.path.join(ROOT, "orion_tpu_torch")])
    syncs, others = [], []

    def record(message, category, filename, lineno, file=None, line=None):
        text = str(message).splitlines()[0]
        if "called a synchronizing" not in text:  # not the mode's notice: counted apart
            others.append(f"{category.__name__}: {text[:160]}")
            return
        syncs.append({"message": text[:160],
                      "frames": [(os.path.realpath(f.filename), f.lineno, f.name)
                                 for f in traceback.extract_stack()[:-1]]})

    def observed(fn):
        with warnings.catch_warnings():
            warnings.simplefilter("always")
            warnings.showwarning = record
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")

    observed(lambda: _planted_sync(device))
    here = os.path.realpath(__file__)
    planted = [s for s in syncs if any(frame[0] == here and frame[2] == "_planted_sync"
                                       for frame in s["frames"])]
    if not planted:
        raise AssertionError(f"lint (c): the planted .item() was not recorded: {syncs} {others}")
    syncs.clear()
    fused_gram.launches = 0
    t0 = time.perf_counter()
    rows, _state = observed(lambda: tbo._suggest_step(*plan.arrays, **plan.statics))
    _sync(device)
    ms = (time.perf_counter() - t0) * 1e3
    launches = fused_gram.launches
    inside = [(s["message"], frame) for s in syncs for frame in s["frames"]
              if any(frame[0] == path and first <= frame[1] <= last
                     for path, _name, first, last in spans)]
    out = {"planted_syncs": len(planted), "planted_message": planted[0]["message"],
           "syncs": len(syncs), "in_captured": len(inside), "other_warnings": others,
           "captured_functions": len(spans), "round_ms": ms, "rows": list(rows.shape),
           "fused_gram_launches": launches,
           "sync_messages": sorted({s["message"] for s in syncs})}
    if inside or tuple(rows.shape) != (Q, 6) or not torch.isfinite(rows).all() or not launches:
        raise AssertionError(f"lint (c): {out} {inside[:5]}")
    return out, launches


def phase_lint(device):
    """The static analysis against the card: (a), (b), (c) above.  Returns
    ``fused_gram``'s launches in (c)'s observed round."""
    emit("lint", part="static", **run_lint_static())
    emit("lint", part="cases", **run_lint_cases(device))
    syncs, launches = run_lint_syncs(device)
    emit("lint", part="syncs", **syncs)
    return launches


#: The ``mesh`` phase: logical slots on one card (``get_mesh`` with a card
#: index); the main path's configuration sharded over MESH_SLOTS slots.
MESH_SLOTS = 4
MESH_ROUNDS = 3  # replayed rounds of each arm, alternating
MESH_TENANTS = 8
MESH_SHAPE = (ALGO["n_candidates"] // MESH_SLOTS, 256, 6)


def mesh_algo_runs():
    """(run, priors, function, algorithm config, batch, rounds): each round
    of the sharded algorithm against the unsharded one in lockstep;
    ``asha_bo`` and ``bohb`` at their ackley50 presets' priors, config and
    batch, ``tpe`` (no preset) at the ``algorithms`` phase's row."""
    from orion_tpu_torch.benchmarks.runner import _uniform_priors

    def preset(name, rounds):
        _run, priors, fn_name, config, _trials, batch, _seeds = _preset_run(f"{name}-ackley50")
        return (name, priors, fn_name, config, batch, rounds)

    return [preset("asha_bo", 2), ("tpe", _uniform_priors(6), "hartmann6", {"tpe": {}}, 16, 3),
            preset("bohb", 2)]


def _mesh_algo(card, n_slots, seed):
    """The main path's ``tpu_bo`` (sharded over ``n_slots`` logical slots of
    ``card``, or unsharded for None) with a seeded history of N_HISTORY."""
    kw = {} if n_slots is None else {"use_mesh": True, "n_devices": n_slots}
    algo = _make_algo(seed, card, **kw)
    x = np.random.default_rng(seed).uniform(size=(N_HISTORY, 6)).astype(np.float32)
    _observe(algo, x, _hartmann6(x))
    return algo


def _health_close(got, want, rtol):
    """Every numeric health field of ``want`` in ``got`` within ``rtol``;
    returns (all bitwise, largest relative difference)."""
    worst, bitwise = 0.0, True
    for key, value in want.items():
        if not isinstance(value, (int, float)) or isinstance(value, bool):
            continue
        other = got[key]
        bitwise = bitwise and np.float32(other).tobytes() == np.float32(value).tobytes()
        if value != other:
            worst = max(worst, abs(other - value) / max(abs(value), 1e-30))
    if worst > rtol:
        raise AssertionError(f"mesh: health differs by {worst} > {rtol}: {got} {want}")
    return bitwise, worst


def _fit_equal(a, b):
    """The fitted part of two GPStates (factor, weights, MLL, hypers) bitwise."""
    return all(_bitwise_equal(x, y) for x, y in zip([a.chol, a.alpha, a.mll, *a.hypers],
                                                     [b.chol, b.alpha, b.mll, *b.hypers]))


def _mesh_round(meshed, plain, rng, label):
    """One suggest(Q) of each arm, each with ``fused_gram`` zeroed just
    before and read just after, then the same 16 new observations: rows
    and fit bitwise, health within rtol 1e-6.  Returns each arm's wall ms,
    launches and launch shapes, and the health comparison."""
    from orion_tpu_torch.ops.gram import fused_gram

    out = {"ms": [], "launches": [], "shapes": [], "cubes": []}
    for algo in (meshed, plain):
        fused_gram.launches = 0
        with _LaunchShapes() as seen:
            _sync(algo.device)
            t0 = time.perf_counter()
            batch = algo.suggest_batch(Q)
            _sync(algo.device)
        out["ms"].append((time.perf_counter() - t0) * 1e3)
        out["launches"].append(fused_gram.launches)
        out["shapes"].append(seen.shapes)
        out["cubes"].append(batch.cube)
    if not np.array_equal(*out.pop("cubes")):
        raise AssertionError(f"mesh {label}: rows differ from the unsharded round")
    if not _fit_equal(meshed._gp_state, plain._gp_state):
        raise AssertionError(f"mesh {label}: the GP fit differs from the unsharded round's")
    out["health_bitwise"], out["health_max_rel"] = _health_close(
        meshed.health_record(), plain.health_record(), 1e-6)
    x = rng.uniform(size=(16, 6)).astype(np.float32)
    for algo in (meshed, plain):
        _observe(algo, x, _hartmann6(x))
    return out


def run_mesh_one_slot(card):
    """(a) A 1-slot mesh against no mesh: the signature's first round (an
    eager warm-up round and the capture) and a replay, rows, fit and health
    bitwise."""
    meshed, plain = _mesh_algo(card, 1, seed=0), _mesh_algo(card, None, seed=0)
    rng = np.random.default_rng(10)
    rounds = [_mesh_round(meshed, plain, rng, "(a)") for _ in range(2)]
    if not all(r["health_bitwise"] for r in rounds):
        raise AssertionError(f"mesh (a): health not bitwise: {rounds}")
    return {"rounds": len(rounds), "round_ms": [r["ms"] for r in rounds],
            "health_bitwise": True, "mesh_devices": meshed.health_record()["mesh_devices"]}


def run_mesh_slots(card):
    """(b) MESH_SLOTS logical slots against no mesh: the first round (the
    capture) and MESH_ROUNDS replays, rows and fit bitwise, health within
    rtol 1e-6; in each replayed sharded round ``fused_gram`` launched
    MESH_SLOTS times at MESH_SHAPE; each slot's chunk of a pool against the
    plain version; the placement fractions; eager and replayed ms of both
    arms.  Returns the line, the sharded rounds' launches and the chunk's
    kernel case."""
    from orion_tpu_torch.algo import sharding
    from orion_tpu_torch.benchmarks.gram_bench import gram_bound, graph_ms
    from orion_tpu_torch.ops.gram import fused_gram, fused_gram_reference

    meshed, plain = _mesh_algo(card, MESH_SLOTS, seed=1), _mesh_algo(card, None, seed=1)
    rng = np.random.default_rng(11)
    first = _mesh_round(meshed, plain, rng, "(b)")
    replays = [_mesh_round(meshed, plain, rng, "(b)") for _ in range(MESH_ROUNDS)]
    launches = sum(r["launches"][0] for r in replays)
    shapes = sum((r["shapes"][0] for r in replays), collections.Counter())
    if launches != MESH_SLOTS * MESH_ROUNDS or set(shapes) != {MESH_SHAPE}:
        raise AssertionError(f"mesh (b): fused_gram launched {launches} times at "
                             f"{dict(shapes)} in {MESH_ROUNDS} sharded rounds")
    health = meshed.health_record()
    fractions = (health["mesh_util_min_frac"], health["mesh_util_max_frac"])
    if fractions != (1 / MESH_SLOTS, 1 / MESH_SLOTS):
        raise AssertionError(f"mesh (b): placement fractions {fractions}")
    # Each slot's chunk of a pool against the plain version (not counted).
    state = meshed._gp_state
    inv, amp = torch.exp(-state.hypers.log_lengthscales), torch.exp(state.hypers.log_amplitude)
    gen = torch.Generator(device=card).manual_seed(2)
    pool = sharding.shard_candidates(
        torch.rand((ALGO["n_candidates"], 6), generator=gen, device=card), meshed._mesh)
    errs = []
    for chunk in pool.shards:
        got, want = fused_gram(chunk, state.x, inv, amp), fused_gram_reference(
            chunk, state.x, inv, amp)
        errs.append(float((got - want).abs().max()))
    limit = 1e-5 * max(1.0, float(amp))
    if not max(errs) <= limit:
        raise AssertionError(f"mesh (b): a chunk's fused_gram differs by {errs} > {limit}")
    chunk = pool.shards[0]
    bound_ms, bound_by = gram_bound(*MESH_SHAPE)
    kernel_ms = graph_ms(lambda: fused_gram(chunk, state.x, inv, amp))
    case = {"m": MESH_SHAPE[0], "n": MESH_SHAPE[1], "d": MESH_SHAPE[2],
            "max_abs_err": max(errs), "tolerance": limit, "ms": kernel_ms,
            "plain_ms": graph_ms(lambda: fused_gram_reference(chunk, state.x, inv, amp)),
            "bound_ms": bound_ms, "bound_by": bound_by, "bound_share": bound_ms / kernel_ms}
    eager = {"mesh": [], "plain": []}
    for _ in range(MESH_ROUNDS):
        for label, algo in (("mesh", meshed), ("plain", plain)):
            _sync(card)
            t0 = time.perf_counter()
            eager_round(algo, lambda algo=algo: algo.fused_step_plan(Q))
            _sync(card)
            eager[label].append((time.perf_counter() - t0) * 1e3)
    replayed = {"mesh": [r["ms"][0] for r in replays], "plain": [r["ms"][1] for r in replays]}
    rounds = [first] + replays
    return {"slots": MESH_SLOTS, "first_round_ms": first["ms"], "replayed_ms": replayed,
            "median_replayed_ms": {k: statistics.median(v) for k, v in replayed.items()},
            "eager_ms": eager,
            "median_eager_ms": {k: statistics.median(v) for k, v in eager.items()},
            "health_bitwise": all(r["health_bitwise"] for r in rounds),
            "health_max_rel": max(r["health_max_rel"] for r in rounds),
            "launches_per_round": launches / MESH_ROUNDS,
            "launch_shapes": {"x".join(map(str, k)): v for k, v in shapes.items()},
            "placement": fractions, "chunk_case": case, "smi": smi_line()}, launches, case


def run_mesh_algorithms(card, runs=None):
    """(c) ``asha_bo``, ``tpe`` and ``bohb`` sharded over MESH_SLOTS slots
    against the unsharded algorithm, in lockstep from one seed: every
    round's suggestions equal, the GP fit bitwise and the health within
    rtol 1e-6 where there is one.  A round is sharded where it scored a
    pool over the slots: ``fused_gram`` launched once a slot (``asha_bo``,
    zeroed just before the sharded arm's round and read just after) or the
    mesh's placement written (the KDE rounds); each run needs one."""
    from orion_tpu_torch.algo.base import create_algo
    from orion_tpu_torch.benchmarks.functions import BENCHMARKS
    from orion_tpu_torch.ops.gram import fused_gram
    from orion_tpu_torch.space.dsl import build_space

    out, launches = {}, 0
    for name, priors, fn_name, config, batch, rounds in runs or mesh_algo_runs():
        space = build_space(priors)
        (algo_name, cfg), = config.items()
        meshed = create_algo(space, {algo_name: dict(cfg, use_mesh=True,
                                                     n_devices=MESH_SLOTS)},
                             seed=0, device=card)
        plain = create_algo(space, config, seed=0, device=card)
        record = {"rounds": rounds, "ms": [], "sharded": [], "health_max_rel": 0.0}
        for _ in range(rounds):
            fused_gram.launches = 0
            meshed._mesh.last_placement = None
            _sync(card)
            t0 = time.perf_counter()
            got = meshed.suggest(batch)
            _sync(card)
            record["ms"].append((time.perf_counter() - t0) * 1e3)
            launched = fused_gram.launches
            launches += launched
            record["sharded"].append(launched >= MESH_SLOTS if algo_name == "asha_bo"
                                     else meshed._mesh.last_placement is not None)
            if got != plain.suggest(batch):
                raise AssertionError(f"mesh (c) {name}: suggestions differ from unsharded")
            health_m, health_p = meshed.health_record() or {}, plain.health_record() or {}
            if health_m.get("mesh_devices") != MESH_SLOTS:
                raise AssertionError(f"mesh (c) {name}: health {health_m}")
            if getattr(plain, "_gp_state", None) is not None:
                if not _fit_equal(meshed._gp_state, plain._gp_state):
                    raise AssertionError(f"mesh (c) {name}: the GP fit differs")
                record["health_max_rel"] = max(record["health_max_rel"],
                                               _health_close(health_m, health_p, 1e-6)[1])
            values = BENCHMARKS[fn_name]["fn"](torch.from_numpy(space.params_to_cube(got)))
            results = [{"objective": float(v)} for v in values.numpy()]
            meshed.observe(got, results)
            plain.observe(got, results)
        if not any(record["sharded"]):
            raise AssertionError(f"mesh (c) {name}: no round scored over the slots: {record}")
        out[name] = record
    return out, launches


def run_mesh_tenants(card):
    """(d) MESH_TENANTS ``tpu_bo`` tenants sharded over MESH_SLOTS slots,
    coalesced (tenant-parallel: lane i on slot i % n) against the same
    tenants served alone (each its sharded round): rows and GPState
    bitwise; ``fused_gram`` once a lane at the whole pool, against once a
    slot per tenant alone."""
    import copy

    from orion_tpu_torch.algo.tpu_bo import run_fused_plan
    from orion_tpu_torch.ops.gram import fused_gram
    from orion_tpu_torch.serve.coalesce import LAST_STACK_PLACEMENT, run_coalesced_plans

    tenants = [_mesh_algo(card, MESH_SLOTS, seed=20 + i) for i in range(MESH_TENANTS)]
    twins = [copy.deepcopy(algo) for algo in tenants]
    fused_gram.launches = 0
    _sync(card)
    t0 = time.perf_counter()
    alone = [run_fused_plan(algo.fused_step_plan(Q)) for algo in twins]
    _sync(card)
    alone_ms, alone_launches = (time.perf_counter() - t0) * 1e3, fused_gram.launches
    fused_gram.launches = 0
    t0 = time.perf_counter()
    coalesced = run_coalesced_plans([algo.fused_step_plan(Q) for algo in tenants])
    _sync(card)
    coalesced_ms, coalesced_launches = (time.perf_counter() - t0) * 1e3, fused_gram.launches
    placement = dict(LAST_STACK_PLACEMENT)
    for i, ((rows, state), (want_rows, want_state)) in enumerate(zip(coalesced, alone)):
        if not _bitwise_equal(rows, want_rows) or not all(
                _bitwise_equal(a, b) for a, b in zip(_state_leaves(state),
                                                    _state_leaves(want_state))):
            raise AssertionError(f"mesh (d): tenant {i} differs from its round alone")
    if (not placement.get("tenant_parallel") or coalesced_launches != MESH_TENANTS
            or alone_launches != MESH_TENANTS * MESH_SLOTS
            or placement["util_max_frac"] != 1 / MESH_SLOTS):
        raise AssertionError(f"mesh (d): placement {placement}, launches "
                             f"{coalesced_launches} coalesced, {alone_launches} alone")
    return {"tenants": MESH_TENANTS, "placement": placement, "alone_ms": alone_ms,
            "coalesced_ms": coalesced_ms, "coalesced_launches": coalesced_launches,
            "alone_launches": alone_launches, "bitwise_equal": True}, (
        coalesced_launches + alone_launches)


def run_mesh_dx006(card):
    """(e) Doctor rule DX006 over two snapshots of a sharded round's health:
    the round as it ran (silent) and the same record with its placement
    collapsed onto one slot (fires); and the gateway's ``serve_mesh_*``
    fields of (d)'s dispatch (silent)."""
    from orion_tpu_torch.algo import sharding
    from orion_tpu_torch.diagnosis import Snapshot, run_rules
    from orion_tpu_torch.serve.coalesce import LAST_STACK_PLACEMENT

    meshed = _mesh_algo(card, MESH_SLOTS, seed=1)
    meshed.suggest_batch(Q)
    healthy = meshed.health_record()
    placed = meshed._mesh.last_placement
    collapsed = dict(healthy, **sharding.mesh_health_fields(
        meshed._mesh, sharding.Placement((sum(placed),) + (0,) * (len(placed) - 1))))
    serve = dict(healthy, serve_mesh_devices=LAST_STACK_PLACEMENT["devices"],
                 serve_mesh_util_min_frac=LAST_STACK_PLACEMENT["util_min_frac"],
                 serve_mesh_util_max_frac=LAST_STACK_PLACEMENT["util_max_frac"])

    def dx006(record):
        return [f.message for f in run_rules(Snapshot(health=[record])).findings
                if f.rule_id == "DX006"]

    out = {"healthy": dx006(healthy), "collapsed": dx006(collapsed), "serve": dx006(serve),
           "healthy_max_frac": healthy["mesh_util_max_frac"],
           "collapsed_max_frac": collapsed["mesh_util_max_frac"]}
    if out["healthy"] or out["serve"] or len(out["collapsed"]) != 1:
        raise AssertionError(f"mesh (e): DX006 {out}")
    return out


def phase_mesh(device):
    """The multi-device mesh on MESH_SLOTS logical slots of the card: (a)
    to (e) above.  One card measures the code path (chunking, the
    cross-shard reductions, the gather, ``fused_gram`` at the chunk's
    shape), not a speed-up from more cards.  Returns ``fused_gram``'s
    launches by run and the chunk's kernel case."""
    card = torch.device("cuda", torch.device(device).index or torch.cuda.current_device())
    emit("mesh", run="one_slot", **run_mesh_one_slot(card))
    slots, slot_launches, case = run_mesh_slots(card)
    emit("mesh", run="slots", **slots)
    algos, algo_launches = run_mesh_algorithms(card)
    emit("mesh", run="algorithms", **algos)
    tenants, tenant_launches = run_mesh_tenants(card)
    emit("mesh", run="tenants", **tenants)
    emit("mesh", run="dx006", **run_mesh_dx006(card))
    return {"slots": slot_launches, "asha_bo": algo_launches,
            "tenants": tenant_launches}, case


#: The ``benchmarks`` phase.  (c): presets through ``runner.main`` at their
#: full budgets, the two no other phase runs through the port first;
#: ``BENCH_GRAM_PRESETS`` must launch ``fused_gram``.  (d): ``host_profile``'s
#: arguments (its default preset at a quarter of its default budget).
BENCH_PRESETS = ("mixed-lenet", "thompson-rosenbrock20", "tpu_bo-hartmann6",
                 "turbo-rosenbrock20", "asha-ackley50-q4096")
BENCH_GRAM_PRESETS = ("thompson-rosenbrock20",)
PROFILE_ARGV = ["asha-ackley50", "--trials", "512", "--batch", "512", "--top", "15"]
#: Each bench row's columns that its line prints.
GRAM_COLUMNS = ("kind", "m", "n", "d", "kernel_ms", "plain_ms", "speedup", "bound_ms",
                "bound_by", "bound_share", "max_abs_err")


def _quiet(fn, *args, **kwargs):
    """``fn``'s result and what it printed (the benches print their own
    rows; this script prints its phase lines)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        result = fn(*args, **kwargs)
    return result, out.getvalue()


def run_bench_gram(device):
    """(a) ``run_gram_bench`` at its 7 shapes, both kinds: every row within
    1e-5 * max(1, amplitude) of the plain path (amplitude 1)."""
    from orion_tpu_torch.benchmarks.gram_bench import SHAPES, run_gram_bench

    rows = []
    for kind in KINDS:
        rows += _quiet(run_gram_bench, kind=kind, device=device)[0]
    # The bench's amplitude is 1: the bar is 1e-5 * max(1, amplitude).
    bad = [row for row in rows if not row["max_abs_err"] <= 1e-5]
    if bad or len(rows) != len(KINDS) * len(SHAPES):
        raise AssertionError(f"benchmarks (a): {len(rows)} rows, over the tolerance: {bad}")
    return {"rows": [{k: row[k] for k in GRAM_COLUMNS} for row in rows],
            "device": rows[0]["device"], "smi": smi_line()}


def run_bench_suggest(device, main_round_ms):
    """(b) ``run_suggest_bench`` shape by shape, ``fused_gram``'s launches
    zeroed just before and read just after each, with their (m, n, d): at
    least one a timed round at the shape's cross-gram (candidates x fit
    buffer x d).  Returns the rows and the launches by shape."""
    from orion_tpu_torch.benchmarks import suggest_bench
    from orion_tpu_torch.ops.gram import fused_gram

    rows, launches = [], {}
    for name, cfg in suggest_bench.SHAPES.items():
        fused_gram.launches = 0
        with _LaunchShapes() as seen:
            (row,), _ = _quiet(suggest_bench.run_suggest_bench, shapes=[name], device=device)
        launches[name] = fused_gram.launches
        cross = (cfg["n_candidates"], 1 << (cfg["n_obs"] - 1).bit_length(), cfg["d"])
        # The warm-up round, 8 samples of _K_HI replays and 8 wall rounds.
        timed = 1 + 8 * (suggest_bench._K_HI + 1)
        if seen.shapes[cross] < timed:
            raise AssertionError(f"benchmarks (b) {name}: fused_gram at {cross} "
                                 f"{seen.shapes[cross]} times, under {timed} rounds: "
                                 f"{dict(seen.shapes)}")
        row.update(fused_gram_launches=launches[name], timed_rounds=timed,
                   launch_shapes={"x".join(map(str, k)): v for k, v in seen.shapes.items()})
        if name == "hartmann6-q1024":
            row["main_path_replayed_round_ms"] = main_round_ms
        rows.append(row)
    return rows, launches


def run_bench_presets(device, presets=BENCH_PRESETS):
    """(c) ``runner.main`` over ``presets``, one at a time, ``fused_gram``
    zeroed just before and read just after each: every trial of the budget
    run (or the algorithm done), a finite regret beside the reference's
    median from ``BENCH_SEEDS.json``."""
    from orion_tpu_torch.benchmarks import runner
    from orion_tpu_torch.ops.gram import fused_gram

    rows, launches = [], {}
    for name in presets:
        fused_gram.launches = 0
        _, printed = _quiet(runner.main, [name, "--device", device.type])
        launches[name] = fused_gram.launches
        (row,) = [json.loads(line) for line in printed.splitlines()]
        budget = runner.PRESETS[name]["max_trials"]
        if not (row["trials"] == budget and np.isfinite(row["simple_regret"])):
            raise AssertionError(f"benchmarks (c) {name}: {row} against a budget of {budget}")
        if name in BENCH_GRAM_PRESETS and launches[name] < 1:
            raise AssertionError(f"benchmarks (c) {name}: fused_gram never launched")
        rows.append(dict(row, budget=budget, fused_gram_launches=launches[name],
                         reference=_reference_regret(name)))
    return rows, launches


def run_bench_profile(device, argv=PROFILE_ARGV):
    """(d) ``host_profile.main``: its result dict and a non-empty tottime
    table."""
    import ast

    from orion_tpu_torch.benchmarks import host_profile
    from orion_tpu_torch.ops.gram import fused_gram

    fused_gram.launches = 0
    _, printed = _quiet(host_profile.main, argv + ["--device", device.type])
    first, rest = printed.split("\n", 1)
    header = rest.index("tottime")
    table = [line.strip() for line in rest[header:].splitlines()[1:] if line.strip()]
    if not table:
        raise AssertionError(f"benchmarks (d): no tottime rows in {printed!r}")
    return {"argv": argv, "result": ast.literal_eval(first), "table_rows": len(table),
            "top": table[:8]}, fused_gram.launches


def phase_benchmarks(device, main_round_ms):
    """The benchmark library (``orion_tpu_torch/benchmarks``) on the card:
    (a) to (d) above.  Returns ``fused_gram``'s launches by part (those of
    (a) compare the kernel with its plain version and are not counted)."""
    emit("benchmarks", part="gram", **run_bench_gram(device))
    rows, suggest_launches = run_bench_suggest(device, main_round_ms)
    for row in rows:
        emit("benchmarks", part="suggest", **row)
    rows, preset_launches = run_bench_presets(device)
    for row in rows:
        emit("benchmarks", part="runner", **row)
    profile, profile_launches = run_bench_profile(device)
    emit("benchmarks", part="host_profile", **profile)
    return {"suggest_bench": suggest_launches, "runner": preset_launches,
            "host_profile": profile_launches}


#: The ``installed`` phase: what an install of the port is built from, the
#: trials of each part.
INSTALL_TREE = ("pyproject.toml", "README.md", "orion_tpu_torch")
INSTALLED_EXPERIMENTS = ("installed-a", "installed-b")  # one GP round each
INSTALLED_TRIALS = 16  # past each experiment's seeded HISTORY
PLUGIN_FIXTURE = os.path.join("tests", "fixtures", "torch_gd_plugin")
PLUGIN_BOX = os.path.join("tests", "fixtures", "torch_black_box.py")
PLUGIN_TRIALS = 25
LENET_EXAMPLE = os.path.join("examples", "torch_mnist_lenet.py")
LENET_TRIALS = 3
LENET_PRIORS = ["--lr~loguniform(1e-3, 1e-1)", "--batch-size~uniform(64, 256, discrete=True)",
                "--width~uniform(1, 2, discrete=True)", "--act~choices(['relu', 'tanh'])"]
#: Run by the installed package in a fresh interpreter: where it was
#: imported from, where it builds, the library it loaded, and ``fused_gram``
#: at the main path's shape against its plain version.
INSTALLED_PROBE = """
import json, sys
import torch
import orion_tpu_torch
import orion_tpu_torch.device
from orion_tpu_torch.ops import _build, gram

device = torch.device(sys.argv[1])
m, n, d = (int(v) for v in sys.argv[2:5])
gen = torch.Generator(device=device).manual_seed(0)
xa = torch.rand((m, d), generator=gen, device=device)
xb = torch.rand((n, d), generator=gen, device=device)
ils = 0.5 + 2.5 * torch.rand((d,), generator=gen, device=device)
amp = 0.2 + 2.8 * torch.rand((), generator=gen, device=device)
got = gram.fused_gram(xa, xb, ils, amp)
want = gram.fused_gram_reference(xa, xb, ils, amp)
loaded = _build._loaded.get("gram")
print(json.dumps({"file": orion_tpu_torch.__file__, "build_dir": _build.BUILD_DIR,
                  "library": _build.library_path("gram"),
                  "loaded": loaded._name if loaded is not None else None,
                  "check_launches": gram.fused_gram.launches,
                  "max_abs_err": float((got - want).abs().max()), "amplitude": float(amp)}))
"""


def tree_files(path):
    """Every file under ``path``, relative to it (an empty set if absent)."""
    out = set()
    for base, _dirs, files in os.walk(path):
        out.update(os.path.relpath(os.path.join(base, f), path) for f in files)
    return out


def copy_install_tree(dst, root=ROOT):
    """Copy ``INSTALL_TREE`` (no bytecode) from the checkout into ``dst``;
    returns the files copied, relative to ``dst``."""
    ignore = shutil.ignore_patterns("__pycache__", "*.pyc")
    for name in INSTALL_TREE:
        src = os.path.join(root, name)
        if os.path.isdir(src):
            shutil.copytree(src, os.path.join(dst, name), ignore=ignore)
        else:
            shutil.copy2(src, os.path.join(dst, name))
    return sorted(tree_files(dst))


def pip_install(source, site):
    """``pip install --no-deps --no-build-isolation --target site source``,
    with no bytecode prefix: its compiled modules go beside the sources in
    ``site``, not into this checkout's cache.  Returns the seconds."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPYCACHEPREFIX"}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "pip", "install", "-q", "--no-deps",
                           "--no-build-isolation", "--target", site, source],
                          env=env, capture_output=True, text=True, timeout=240)
    if proc.returncode != 0:
        raise AssertionError(f"installed: pip install {source} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    return time.perf_counter() - t0


def load_installed_build(site, cache):
    """The installed copy's ``ops/_build.py``, loaded in this process by its
    path as it would load with ``XDG_CACHE_HOME=cache`` (no bytecode
    written)."""
    import importlib.util

    path = os.path.join(site, "orion_tpu_torch", "ops", "_build.py")
    spec = importlib.util.spec_from_file_location("installed_orion_tpu_torch_build", path)
    module = importlib.util.module_from_spec(spec)
    with _environ(XDG_CACHE_HOME=cache):
        dont_write, sys.dont_write_bytecode = sys.dont_write_bytecode, True
        try:
            spec.loader.exec_module(module)
        finally:
            sys.dont_write_bytecode = dont_write
    return module


def run_processes(procs, env, timeout):
    """Start every ``(name, argv, cwd)`` at once, each in a session of its
    own with ``env`` as its whole environment and its output in
    ``cwd/<name>.out`` and ``.err``; wait for all.  Returns each one's
    seconds and standard output; raises on a nonzero exit code.  A process
    still running at ``timeout`` (or after a failure here) is killed with
    everything it started."""
    started, ended, running = {}, {}, {}
    try:
        for name, argv, cwd in procs:
            with open(os.path.join(cwd, f"{name}.out"), "w") as out, \
                    open(os.path.join(cwd, f"{name}.err"), "w") as err:
                started[name] = time.perf_counter()
                running[name] = subprocess.Popen(argv, env=env, cwd=cwd, stdout=out,
                                                 stderr=err, start_new_session=True)
        t0 = time.perf_counter()
        while len(ended) < len(running) and time.perf_counter() - t0 < timeout:
            for name, proc in running.items():
                if name not in ended and proc.poll() is not None:
                    ended[name] = time.perf_counter()
            time.sleep(0.05)
    finally:
        for proc in running.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    out = {}
    for name, _argv, cwd in procs:
        with open(os.path.join(cwd, f"{name}.out")) as handle:
            stdout = handle.read()
        with open(os.path.join(cwd, f"{name}.err")) as handle:
            stderr = handle.read()
        if name not in ended or running[name].returncode != 0:
            raise AssertionError(f"installed: {name} exited {running[name].returncode} "
                                 f"(timeout {timeout} s): {stderr[-3000:]}")
        out[name] = (ended[name] - started[name], stdout)
    return out


def install_port(inst):
    """The set-up: ``INSTALL_TREE`` and the plugin fixture copied under
    ``inst`` and both pip-installed into ``inst/site``."""
    src, plugin, site = (os.path.join(inst, name) for name in ("src", "gd_plugin", "site"))
    os.makedirs(src)
    copied = copy_install_tree(src)
    shutil.copytree(os.path.join(ROOT, PLUGIN_FIXTURE), plugin)
    port_s = pip_install(src, site)
    plugin_s = pip_install(plugin, site)
    installed = tree_files(os.path.join(site, "orion_tpu_torch"))
    wanted = {os.path.relpath(f, "orion_tpu_torch") for f in copied
              if f.startswith("orion_tpu_torch" + os.sep)}
    missing = sorted(wanted - installed)
    if missing:
        raise AssertionError(f"installed: pip left out {missing}")
    return site, {"pip_s": port_s, "plugin_pip_s": plugin_s, "copied": len(copied),
                  "package_files": len(wanted)}


def run_installed_site(site, cache, device):
    """Phase 1, in this process: the kernel source shipped, and the installed
    ``_build`` builds ``gram`` from it into the cache, from cold."""
    source = os.path.join(site, "orion_tpu_torch", "ops", "csrc", "gram.cu")
    with open(source, "rb") as handle, \
            open(os.path.join(ROOT, "orion_tpu_torch", "ops", "csrc", "gram.cu"), "rb") as ours:
        if handle.read() != ours.read():
            raise AssertionError(f"installed: {source} differs from the checkout's")
    build = load_installed_build(site, cache)
    library = build.library_path("gram")
    if build.BUILD_DIR != os.path.join(cache, "orion_tpu_torch") or \
            not library.startswith(cache + os.sep):
        raise AssertionError(f"installed: builds into {build.BUILD_DIR}, not under {cache}")
    if os.path.exists(library):
        raise AssertionError(f"installed: {library} exists before the first build")
    nvcc_s = None
    if device.type == "cuda":
        t0 = time.perf_counter()
        built = build.build("gram")
        nvcc_s = time.perf_counter() - t0
        if built != library or not os.path.exists(library):
            raise AssertionError(f"installed: built {built}, expected {library}")
    return {"source": source, "build_dir": build.BUILD_DIR, "library": library,
            "nvcc_s": nvcc_s}


def _installed_hunts(runs, device):
    """Phase 2's stores: one SQLite file a GP round, each with a history of
    ``HISTORY`` completed through the library, so that the installed
    worker's first round is a GP round."""
    hunts = []
    for name in INSTALLED_EXPERIMENTS:
        run_dir = os.path.join(runs, name)
        os.makedirs(run_dir)
        script, db, log, storage, history = _seeded_store(run_dir, name, device, CLI_ALGO)
        prof = os.path.join(run_dir, "profile")
        argv = ["hunt", "-n", name, "-c", os.path.join(run_dir, "cli.yaml"), "--storage-path",
                db, "--pool-size", str(CLI_Q), "--max-trials", str(HISTORY + INSTALLED_TRIALS),
                "--device", device.type, "--profile", prof, script, *CLI_PRIORS, "--log", log]
        hunts.append((name, run_dir, argv, storage, log, prof, history))
    return hunts


def _check_installed_hunt(name, storage, log, prof, history, device):
    exp_id, trials = _fetch_trials(storage, name)
    done, values, err = check_cli_trials(f"installed {name}", trials,
                                         HISTORY + INSTALLED_TRIALS, device)
    with open(log) as handle:
        executed = handle.read().split()
    fresh = {t.id for t in done} - history
    if len(executed) != len(set(executed)) or fresh != set(executed):
        raise AssertionError(f"installed {name}: {len(executed)} executions for "
                             f"{len(fresh)} completed trials past the history")
    [worker] = read_traces(prof)
    main = "x".join(map(str, MAIN_SHAPE))
    if worker["launch_shapes"].get(main, 0) < 1:
        raise AssertionError(f"installed {name}: fused_gram launched at "
                             f"{worker['launch_shapes']} (none at {main})")
    return {"trials": len(fresh), "launches": worker["fused_gram_launches"],
            "launch_shapes": worker["launch_shapes"], "device_busy_ms": worker["device_busy_ms"],
            "idle_share": worker["idle_share"], "objective_max_abs_err": err}


def _plugin_run(runs, device):
    run_dir = os.path.join(runs, "plugin")
    os.makedirs(run_dir)
    conf = os.path.join(run_dir, "conf.yaml")
    with open(conf, "w") as handle:
        handle.write("algorithms: {gradient_descent: {learning_rate: 0.3}}\n"
                     "strategy: NoParallelStrategy\n")
    box = shutil.copy(os.path.join(ROOT, PLUGIN_BOX), run_dir)
    db = os.path.join(run_dir, "db.pkl")
    return run_dir, db, ["hunt", "-n", "gd-plugin", "-c", conf, "--storage-path", db,
                         "--max-trials", str(PLUGIN_TRIALS), "--worker-trials",
                         str(PLUGIN_TRIALS), "--device", device.type, box, "-x~uniform(-50,50)"]


def _check_plugin(db):
    from orion_tpu_torch.storage.base import create_storage

    storage = create_storage({"type": "pickled", "path": db})
    [exp] = storage.fetch_experiments({"name": "gd-plugin"})
    values = [t.objective.value for t in storage.fetch_trials(uid=exp["_id"])
              if t.status == "completed" and t.objective]
    if exp["algorithms"] != {"gradient_descent": {"learning_rate": 0.3}}:
        raise AssertionError(f"installed plugin: stored {exp['algorithms']}")
    if len(values) != PLUGIN_TRIALS or not 23.4 - 1e-9 <= min(values) < 23.4 + 1e-4:
        raise AssertionError(f"installed plugin: {len(values)} trials, best {min(values)}")
    return {"trials": len(values), "best": min(values)}


def _lenet_run(runs, device):
    run_dir = os.path.join(runs, "lenet")
    os.makedirs(run_dir)
    script = shutil.copy(os.path.join(ROOT, LENET_EXAMPLE), run_dir)
    db = os.path.join(run_dir, "db.pkl")
    return run_dir, db, ["hunt", "-n", "lenet", "--storage-path", db, "--max-trials",
                         str(LENET_TRIALS), "--worker-trials", str(LENET_TRIALS), "--device",
                         device.type, script, "--device", device.type, *LENET_PRIORS]


def _check_lenet(db):
    from orion_tpu_torch.storage.base import create_storage

    storage = create_storage({"type": "pickled", "path": db})
    [exp] = storage.fetch_experiments({"name": "lenet"})
    done = [t for t in storage.fetch_trials(uid=exp["_id"]) if t.status == "completed"]
    errors = [t.objective.value for t in done]
    if len(done) != LENET_TRIALS or not all(0.0 <= e <= 1.0 for e in errors):
        raise AssertionError(f"installed lenet: {len(done)} trials, errors {errors}")
    return {"trials": len(done), "validation_errors": errors}


def phase_installed(device, timeout=600):
    """The port as a user installs it, outside this checkout: set-up, then
    (1) in this process, the shipped source built by the installed
    ``_build`` into a temporary ``XDG_CACHE_HOME``; then at once, each a
    fresh interpreter with ``PYTHONPATH`` the ``site`` alone and its working
    directory outside the checkout: the package probed (``INSTALLED_PROBE``),
    (2) the installed ``orion-tpu-torch hunt`` of ``tpu_bo`` at q=1024 on
    two seeded stores, one GP round each, (3) the installed plugin's hunt,
    (4) the LeNet example's hunt.  Nothing may appear under this checkout's
    ``build/`` or under ``site``'s parent.  Returns ``fused_gram``'s
    launches in (2)."""
    inst = tempfile.mkdtemp(prefix="orion-tpu-torch-install-")
    runs = tempfile.mkdtemp(prefix="orion-tpu-torch-installed-")
    try:
        t0 = time.perf_counter()
        site, setup = install_port(inst)
        emit("installed", part="setup", seconds=time.perf_counter() - t0, nvcc_s=None,
             launches=0, trials=0, site=site, **setup)
        checkout_build = tree_files(os.path.join(ROOT, "build"))
        site_parent = tree_files(inst)
        cache = os.path.join(runs, "cache")

        t0 = time.perf_counter()
        built = run_installed_site(site, cache, device)
        emit("installed", part="site", seconds=time.perf_counter() - t0, launches=0, trials=0,
             **built)

        built_at = os.stat(built["library"]).st_mtime_ns if device.type == "cuda" else None
        hunts = _installed_hunts(runs, device)
        plugin_dir, plugin_db, plugin_argv = _plugin_run(runs, device)
        lenet_dir, lenet_db, lenet_argv = _lenet_run(runs, device)
        command = os.path.join(site, "bin", "orion-tpu-torch")
        procs = [("probe", [sys.executable, "-c", INSTALLED_PROBE, device.type,
                            *map(str, MAIN_SHAPE)], runs)]
        procs += [(name, [command, *argv], run_dir) for name, run_dir, argv, *_ in hunts]
        procs += [("plugin", [command, *plugin_argv], plugin_dir),
                  ("lenet", [command, *lenet_argv], lenet_dir)]
        env = {**os.environ, "PYTHONPATH": site, "XDG_CACHE_HOME": cache,
               "PYTHONDONTWRITEBYTECODE": "1"}
        t0 = time.perf_counter()
        ran = run_processes(procs, env, timeout)
        wall_s = time.perf_counter() - t0

        probe = json.loads(ran["probe"][1].strip().splitlines()[-1])
        limit = 1e-5 * max(1.0, probe["amplitude"])
        if not probe["file"].startswith(os.path.join(site, "orion_tpu_torch") + os.sep):
            raise AssertionError(f"installed: imported {probe['file']}, not from {site}")
        if probe["loaded"] != built["library"] or probe["check_launches"] != 1 \
                or not probe["max_abs_err"] <= limit:
            raise AssertionError(f"installed: probe {probe} (library {built['library']}, "
                                 f"tolerance {limit})")
        emit("installed", part="probe", seconds=ran["probe"][0], nvcc_s=0.0, launches=0,
             trials=0, shape=list(MAIN_SHAPE), tolerance=limit, **probe)
        launches = {}
        for name, _run_dir, _argv, storage, log, prof, history in hunts:
            row = _check_installed_hunt(name, storage, log, prof, history, device)
            launches[name] = row["launches"]
            emit("installed", part="hunt", experiment=name, seconds=ran[name][0], nvcc_s=0.0,
                 q=CLI_Q, history=HISTORY, **row)
        emit("installed", part="plugin", seconds=ran["plugin"][0], nvcc_s=0.0, launches=0,
             **_check_plugin(plugin_db))
        emit("installed", part="lenet", seconds=ran["lenet"][0], nvcc_s=0.0, launches=0,
             **_check_lenet(lenet_db))

        libraries = sorted(f for f in tree_files(cache) if f.endswith(".so"))
        new_build = sorted(tree_files(os.path.join(ROOT, "build")) - checkout_build)
        new_parent = sorted(tree_files(inst) - site_parent)
        emit("installed", part="files", cohort_s=wall_s, cache_libraries=libraries,
             new_in_checkout_build=new_build, new_under_site_parent=new_parent)
        if len(libraries) != 1 or new_build or new_parent:
            raise AssertionError("installed: a library built outside the cache, or a file "
                                 "written into the checkout or beside the site")
        if built_at is not None and os.stat(built["library"]).st_mtime_ns != built_at:
            raise AssertionError("installed: the cache's library was built again")
        return launches
    finally:
        shutil.rmtree(inst, ignore_errors=True)
        shutil.rmtree(runs, ignore_errors=True)


#: Compiled bytecode of the modules this script's processes import.  Where
#: the environment sets ``PYTHONDONTWRITEBYTECODE``, without a cache every
#: process (a cohort's worker, a server, an admin command) compiles torch's
#: modules from source again.
PYCACHE = os.path.join(ROOT, "build", "pycache")
WARM_IMPORTS = """
import importlib, pkgutil
import numpy, torch, torch.autograd.profiler, torch.distributed, torch.utils.flop_counter
import orion_tpu_torch
for module in pkgutil.walk_packages(orion_tpu_torch.__path__, "orion_tpu_torch."):
    importlib.import_module(module.name)
"""


def warm_bytecode():
    """Start one process that imports what this script's processes import,
    with bytecode writing on, into ``PYCACHE``; point this process and
    every process it starts later at that cache.  They only read it (a
    module not compiled there yet compiles in memory, as before).  Returns
    the warming process."""
    env = {**os.environ, "PYTHONPATH": ROOT, "PYTHONPYCACHEPREFIX": PYCACHE,
           "PYTHONDONTWRITEBYTECODE": ""}
    proc = subprocess.Popen([sys.executable, "-c", WARM_IMPORTS], env=env, cwd=ROOT,
                            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL,
                            start_new_session=True)
    os.environ["PYTHONPYCACHEPREFIX"] = PYCACHE
    sys.pycache_prefix = PYCACHE
    return proc


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    warm = warm_bytecode()
    try:
        return run_phases()
    finally:
        if warm.poll() is None:
            warm.kill()
        warm.wait()


def run_phases():
    import orion_tpu_torch.device  # noqa: F401  (precision switches)

    device = torch.device("cuda")
    seconds = {}

    def run(name, fn, *args, **kwargs):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        seconds[name] = time.perf_counter() - t0
        return out

    run("device", phase_device)
    run("build", phase_build)
    cases = run("kernel_checks", check_fused_gram, device)
    algo, launches, plain_round_ms = run("main_path", phase_main_path, device)
    run("profile", phase_profile, algo)
    run("regret", phase_regret, device)
    asha_bo_launches = run("algorithms", phase_algorithms, device)
    hunt_launches = run("hunt", phase_hunt, device, plain_round_ms)
    with tempfile.TemporaryDirectory(dir=os.path.join(ROOT, "build")) as tmp:
        cli_launches, cli_workers_trials_per_s = run("cli", phase_cli, device, tmp)
        evc_launches = run("evc", phase_evc, device, tmp)
        telemetry_launches, telemetry_trials_per_s = run(
            "telemetry", phase_telemetry, device, tmp, cli_workers_trials_per_s,
            fleet_off_first="--fleet-off-first" in sys.argv[1:])
        network_launches, plane = run("network", phase_network, device, tmp,
                                      telemetry_trials_per_s)
        day2_launches = run("day2", phase_day2, device, tmp, plane)
        device_plane_launches = run("device_plane", phase_device_plane, device, tmp)
        diagnosis_launches = run("diagnosis", phase_diagnosis, device, tmp)
        serve_launches = run("serve", phase_serve, device, tmp)
    lint_launches = run("lint", phase_lint, device)
    mesh_launches, mesh_case = run("mesh", phase_mesh, device)
    bench_launches = run("benchmarks", phase_benchmarks, device, plain_round_ms)
    installed_launches = run("installed", phase_installed, device)
    bench_total = sum(sum(v.values()) if isinstance(v, dict) else v
                      for v in bench_launches.values())
    emit("seconds", **seconds, phases=sum(seconds.values()))
    emit("trace_reads", **TRACE_READS)

    def case(shape):
        return next(c for c in cases if (c["m"], c["n"], c["d"]) == shape
                    and c["kind"] == "matern52")

    main_case, asha_bo_case = case(CASES[0]), case(ASHA_BO_SHAPE)
    kernels = [{
        "name": "fused_gram",
        "route": "cuda",
        "source": "orion_tpu_torch/ops/csrc/gram.cu",
        "replaces": "orion_tpu/ops/gram.py:68",
        "launches": (launches["fused_gram"] + asha_bo_launches + hunt_launches
                     + sum(cli_launches.values()) + evc_launches
                     + sum(telemetry_launches.values()) + sum(network_launches.values())
                     + sum(day2_launches.values()) + device_plane_launches
                     + sum(diagnosis_launches.values()) + sum(serve_launches.values())
                     + lint_launches + sum(mesh_launches.values()) + bench_total
                     + sum(installed_launches.values())),
        "launches_by_path": {"main_path": launches["fused_gram"], "asha_bo": asha_bo_launches,
                             "hunt": hunt_launches, "cli": sum(cli_launches.values()),
                             "cli_runs": cli_launches, "evc": evc_launches,
                             "telemetry": sum(telemetry_launches.values()),
                             "telemetry_runs": telemetry_launches,
                             "network": sum(network_launches.values()),
                             "network_runs": network_launches,
                             "day2": sum(day2_launches.values()), "day2_runs": day2_launches,
                             "device_plane": device_plane_launches,
                             "diagnosis": sum(diagnosis_launches.values()),
                             "diagnosis_runs": diagnosis_launches,
                             "serve": sum(serve_launches.values()),
                             "serve_runs": serve_launches, "lint": lint_launches,
                             "mesh": sum(mesh_launches.values()),
                             "mesh_runs": mesh_launches, "benchmarks": bench_total,
                             "benchmarks_runs": bench_launches,
                             "installed": sum(installed_launches.values()),
                             "installed_runs": installed_launches},
        "max_abs_err": max(c["max_abs_err"] for c in cases),
        "ms": main_case["ms"],
        "kernel_ms": main_case["kernel_ms"],
        "plain_ms": main_case["plain_ms"],
        "bound_ms": main_case["bound_ms"],
        "bound_by": main_case["bound_by"],
        "bound_share": main_case["bound_share"],
        "fill_ms": main_case["fill_ms"],
        "library_ms": None,
        "shape": list(CASES[0]),
        "asha_bo_case": {k: asha_bo_case[k] for k in ("m", "n", "d", "max_abs_err", "ms",
                                                       "plain_ms", "bound_ms", "bound_by",
                                                       "bound_share")},
        "mesh_case": mesh_case,
        "cases": cases,
    }]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
