"""The compiler plane: a process-wide registry of CUDA-graph captures (port
of ``orion_tpu/compiler_plane.py``).

The reference records every XLA compilation of its jitted suggest step.  The
port's counterpart of a jit-cache entry is a captured CUDA graph
(:mod:`orion_tpu_torch.algo.step_graphs`), one per step signature, so this
registry records captures:

- :class:`CompileRegistry` keeps, for every capture, the full signature (a
  flat field dict — ``fit_bucket``, ``width``, ``q``, every static), the
  capture and instantiate wall times, the graph's node count where the torch
  build exposes it, and the shared graph pool's bytes after the capture.  A
  ``cuda_graph.capture`` span carries the signature in its args.  FLOPs are
  counted only on a cold path (:meth:`CompileRegistry.analyze_all`), by
  ``torch.utils.flop_counter.FlopCounterMode`` over one eager round: they
  count the matmul-family ops that mode knows (matmul, triangular solve is
  not among them), and are labelled so.
- **Recapture attribution**: a synchronous capture that a suggest paid is
  diffed against the nearest prior signature of its family, and a flight
  ``cuda_graph.recapture`` event (mirrored into the spans channel as
  ``flight.cuda_graph.recapture``) names the changed statics —
  ``fit_bucket 64→128``, ``q 256→512``, ``fit_steps 40→10``.  A prewarm
  records the signature it captured, so an attributed recapture also says
  whether a prewarm should have covered it
  (``cuda_graph.recaptures.prewarm_covered``).

Names, against the reference's:

=================================  =========================================
reference                          port
=================================  =========================================
``jax.compile`` (span)             ``cuda_graph.capture``
``jax.compiles``                   ``cuda_graph.captures``
``jax.retraces``                   ``cuda_graph.recaptures``
``jax.retraces.attributed``        ``cuda_graph.recaptures.attributed``
``jax.retraces.prewarm_covered``   ``cuda_graph.recaptures.prewarm_covered``
``jax.prewarms``                   ``cuda_graph.prewarms``
``jax.prewarm.compile`` (span)     ``cuda_graph.prewarm.capture``
flight ``jax.retrace``             flight ``cuda_graph.recapture``
flight ``jax.prewarm``             flight ``cuda_graph.prewarm``
``jax.suggest_step.compile``       ``suggest_step.capture``
entry kinds compile / retrace      capture / recapture
``compiler.compile_ms_total``      ``compiler.capture_ms_total``
=================================  =========================================

The ``compiler.hbm_*`` gauges keep their names: the H100's memory is HBM3.
The card's capacity comes from ``torch.cuda.get_device_properties``, never
from a table.  Every ``record_*`` mutator returns at once when telemetry is
off.
"""

import os
import sys
import threading
from contextlib import contextmanager

from orion_tpu_torch.analysis.sanitizer import TSAN
from orion_tpu_torch.health import FLIGHT
from orion_tpu_torch.telemetry import TELEMETRY

#: Diff rendering order: the fields operators reason about first (the
#: pow-2 buckets and the warm flag) lead; everything else is alphabetical.
_FIELD_PRIORITY = ("fit_bucket", "width", "q", "warm", "fit_steps")

#: What :meth:`CompileRegistry.analyze_all`'s ``flops`` counts.
FLOPS_LABEL = "torch FlopCounterMode over one eager round (matmul-family ops)"


def signature_fields(shape, statics):
    """Flatten a fused-plan signature — the ``(x.shape, statics)`` pair the
    prewarmer keys on — into the registry's field dict: ``fit_bucket`` and
    ``width`` from the fit buffer's shape, every static stringified exactly
    as the plan signature does (``str(v)``)."""
    fields = {"fit_bucket": int(shape[0]), "width": int(shape[1])}
    items = statics.items() if isinstance(statics, dict) else statics
    for key, value in items:
        fields[str(key)] = value if isinstance(value, str) else str(value)
    return fields


def fields_from_plan_signature(signature):
    """Field dict from a :class:`FusedPlan`'s ``signature``
    (``(tuple(x.shape), tuple(sorted((k, str(v)) ...)))``)."""
    shape, items = signature
    return signature_fields(shape, items)


def _field_order(key):
    try:
        return (_FIELD_PRIORITY.index(key), key)
    except ValueError:
        return (len(_FIELD_PRIORITY), key)


def diff_fields(old, new):
    """``["fit_bucket 64→128", ...]`` — every field differing between two
    signature field dicts, priority fields first."""
    changed = []
    for key in sorted(set(old) | set(new), key=_field_order):
        a, b = old.get(key), new.get(key)
        if a != b:
            changed.append(f"{key} {a}→{b}")
    return changed


def format_fields(fields):
    """One-line signature rendering for span args and tables."""
    return " ".join(f"{k}={fields[k]}" for k in sorted(fields, key=_field_order))


def _q_of(fields):
    try:
        return int(fields.get("q"))
    except (TypeError, ValueError):
        return 0


def _fields_key(fields):
    return tuple(sorted(fields.items()))


def device_hbm_capacity(device=None):
    """The card's memory in bytes (``total_memory`` of its properties), or
    None on a process that has not initialized CUDA: observability never
    brings the driver up by itself."""
    import torch

    # is_initialized first: is_available would call into the driver of a
    # process (a gateway's worker) that never touched the card.
    if not torch.cuda.is_initialized():
        return None
    try:
        index = torch.device(device).index if device is not None else None
        return int(torch.cuda.get_device_properties(
            index if index is not None else torch.cuda.current_device()).total_memory)
    except Exception:
        return None


def predict_hbm_bound_q(fields, hbm_bytes, capacity):
    """Predicted q at which this plan's footprint fills the card: the round's
    dominant buffers (candidate scores, the q-batch of draws) scale about
    linearly in q at a fixed history bucket, so ``q · capacity /
    hbm_bytes``.  None when any input is unknown."""
    if not hbm_bytes or not capacity:
        return None
    try:
        q = int(fields.get("q"))
    except (TypeError, ValueError):
        return None
    if q <= 0:
        return None
    return int(q * float(capacity) / float(hbm_bytes))


class _Entry:
    """One recorded capture: family, signature fields, wall seconds, what
    the capture measured (``stats``) and the lazy FLOP count."""

    __slots__ = ("family", "fields", "seconds", "kind", "analysis_fn", "cost", "stats")

    def __init__(self, family, fields, seconds, kind, analysis_fn, stats=None):
        self.family = family
        self.fields = dict(fields)
        self.seconds = seconds
        self.kind = kind
        self.analysis_fn = analysis_fn
        self.cost = None
        self.stats = dict(stats or {})

    def as_dict(self):
        cost = self.cost or {}
        stats = self.stats
        return {
            "family": self.family,
            "kind": self.kind,
            "signature": format_fields(self.fields),
            "capture_ms": (
                round(self.seconds * 1e3, 3) if self.seconds is not None else None
            ),
            "instantiate_ms": stats.get("instantiate_ms"),
            "graph_nodes": stats.get("graph_nodes"),
            "pool_bytes": stats.get("pool_bytes"),
            "flops": cost.get("flops"),
            "hbm_bytes": stats.get("hbm_bytes"),
        }


class CompileRegistry:
    """Process-wide record of captures, keyed by plan family (the port has
    one: ``fused_plan``, the GP suggest round).  Thread-safe: prewarm
    captures record from their background threads."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = []
        self._warmed = {}
        self._cost_cache = {}
        self._retraces = 0
        self._attributed = 0
        self._prewarm_covered = 0

    # --- recording -------------------------------------------------------
    def record_compile(self, family, fields, seconds=None, kind="capture",
                       analysis_fn=None, stats=None):
        """Book one capture: the ``cuda_graph.captures`` counter and a
        ``cuda_graph.capture`` span with the signature in its args.  Returns
        the entry, or None when telemetry is off."""
        if not TELEMETRY.enabled:
            return None
        entry = _Entry(family, fields, seconds, kind, analysis_fn, stats)
        with self._lock:
            TSAN.write("CompileRegistry._entries", self)
            self._entries.append(entry)
        TELEMETRY.count("cuda_graph.captures")
        TELEMETRY.record_span(
            "cuda_graph.capture",
            duration=seconds or 0.0,
            args={"family": family, "kind": kind, "signature": format_fields(entry.fields)},
        )
        return entry

    def record_prewarm(self, family, fields, seconds=None, analysis_fn=None, stats=None):
        """Book a background prewarm capture AND remember its signature: a
        later recapture at this exact signature is a prewarm bug."""
        if not TELEMETRY.enabled:
            return None
        entry = self.record_compile(family, fields, seconds=seconds, kind="prewarm",
                                    analysis_fn=analysis_fn, stats=stats)
        if entry is not None:
            with self._lock:
                TSAN.write("CompileRegistry._entries", self)
                self._warmed.setdefault(family, set()).add(_fields_key(entry.fields))
        return entry

    def record_retrace(self, family, fields, seconds=None, analysis_fn=None, stats=None):
        """Book a synchronous recapture WITH attribution.

        Diffs ``fields`` against the nearest prior signature of the family
        (fewest differing fields; ties go to the most recent), emits the
        flight ``cuda_graph.recapture`` event naming the changed statics,
        counts ``cuda_graph.recaptures.attributed`` and, when a completed
        prewarm recorded this exact signature,
        ``cuda_graph.recaptures.prewarm_covered``.  Returns the attribution
        dict."""
        if not TELEMETRY.enabled:
            return None
        entry = _Entry(family, fields, seconds, "recapture", analysis_fn, stats)
        with self._lock:
            TSAN.write("CompileRegistry._entries", self)
            nearest = None
            nearest_diff = None
            for prior in reversed(self._entries):
                if prior.family != family:
                    continue
                candidate = diff_fields(prior.fields, entry.fields)
                if nearest_diff is None or len(candidate) < len(nearest_diff):
                    nearest, nearest_diff = prior, candidate
                    if not candidate:
                        break
            covered = _fields_key(entry.fields) in self._warmed.get(family, ())
            self._entries.append(entry)
            self._retraces += 1
            self._attributed += 1
            if covered:
                self._prewarm_covered += 1
        if nearest is None:
            changed = [f"first {family} signature (cold start)"]
        elif not nearest_diff:
            changed = ["identical signature (graph cache evicted or bypassed)"]
        else:
            changed = nearest_diff
        TELEMETRY.count("cuda_graph.recaptures.attributed")
        if covered:
            TELEMETRY.count("cuda_graph.recaptures.prewarm_covered")
        TELEMETRY.count("cuda_graph.captures")
        TELEMETRY.record_span(
            "cuda_graph.capture",
            duration=seconds or 0.0,
            args={
                "family": family,
                "kind": "recapture",
                "signature": format_fields(entry.fields),
                "changed": "; ".join(changed),
            },
        )
        if FLIGHT.enabled:
            FLIGHT.record(
                "cuda_graph.recapture",
                args={
                    "family": family,
                    "changed": "; ".join(changed),
                    "covered_by_prewarm": covered,
                    "signature": format_fields(entry.fields),
                },
            )
        return {
            "family": family,
            "changed": changed,
            "covered_by_prewarm": covered,
            "against": dict(nearest.fields) if nearest is not None else None,
        }

    # --- cold-path analysis ----------------------------------------------
    def analyze_all(self, families=None, limit=None):
        """Run the pending FLOP counts — each one an eager round under
        ``FlopCounterMode``, which is why this runs only from cold paths
        (``profile``, tests).  Deduplicates by exact signature and returns
        ``{"analyzed", "skipped"}`` so a caller that bounds the work
        (``limit``) can report the cap."""
        with self._lock:
            TSAN.read("CompileRegistry._entries", self)
            pending = [
                e for e in self._entries
                if e.analysis_fn is not None and (families is None or e.family in families)
            ]
        analyzed = skipped = 0
        done = set()
        for entry in pending:
            fields_key = _fields_key(entry.fields)
            key = (entry.family, fields_key)
            if key in done:
                continue
            done.add(key)
            with self._lock:
                cached = self._cost_cache.get(key)
            if cached is None:
                if limit is not None and analyzed >= limit:
                    skipped += 1
                    continue
                try:
                    # Outside the lock: a whole eager round.
                    cached = entry.analysis_fn()
                except Exception:  # analysis must never break a caller
                    cached = None
                analyzed += 1
                if cached is not None:
                    with self._lock:
                        self._cost_cache[key] = cached
            self._apply_cost(entry.family, fields_key, cached)
        self.publish_gauges()
        return {"analyzed": analyzed, "skipped": skipped}

    def _apply_cost(self, family, key, cost):
        with self._lock:
            TSAN.write("CompileRegistry._entries", self)
            for entry in self._entries:
                if entry.family == family and _fields_key(entry.fields) == key:
                    entry.cost = cost

    # --- surfacing --------------------------------------------------------
    def publish_gauges(self):
        """Refresh the ``compiler.*`` gauges from the entries (no capture,
        no round: safe on every ``/metrics`` scrape)."""
        if not TELEMETRY.enabled:
            return
        summary = self.summary()
        for gauge, key in (
            ("compiler.capture_ms_total", "compile_ms_total"),
            ("compiler.hbm_bytes_max", "plan_hbm_bytes_max"),
            ("compiler.hbm_capacity_bytes", "hbm_capacity_bytes"),
            ("compiler.hbm_bound_q", "hbm_bound_q"),
        ):
            if summary[key] is not None:
                TELEMETRY.set_gauge(gauge, summary[key])

    def entries(self, family=None):
        with self._lock:
            TSAN.read("CompileRegistry._entries", self)
            return [e for e in self._entries if family is None or e.family == family]

    def summary(self):
        """The JSON-able digest: totals and the per-plan table, which
        ``profile``'s local block renders."""
        with self._lock:
            TSAN.read("CompileRegistry._entries", self)
            entries = list(self._entries)
            retraces = self._retraces
            attributed = self._attributed
            covered = self._prewarm_covered
        per_plan = [e.as_dict() for e in entries]
        seconds = [e.seconds for e in entries if e.seconds is not None]
        sized = [e for e in entries if e.stats.get("hbm_bytes")]
        hbm = [e.stats["hbm_bytes"] for e in sized]
        capacity = device_hbm_capacity()
        # One pool serves every capture: a small-q round's footprint is the
        # pool the largest round sized, so only the largest-q round's
        # footprint extrapolates in q.
        largest = max(sized, key=lambda e: _q_of(e.fields), default=None)
        bound_q = (predict_hbm_bound_q(largest.fields, largest.stats["hbm_bytes"], capacity)
                   if largest is not None else None)
        return {
            "compiles": len(entries),
            "compile_ms_total": round(sum(seconds) * 1e3, 3) if seconds else None,
            "retraces": retraces,
            "retraces_attributed": attributed,
            "retraces_prewarm_covered": covered,
            "plan_hbm_bytes_max": max(hbm) if hbm else None,
            "hbm_capacity_bytes": capacity,
            "hbm_bound_q": bound_q,
            "flops_label": FLOPS_LABEL,
            "per_plan": per_plan,
        }

    def reset(self):
        """Tests only — the registry is process-wide state."""
        with self._lock:
            TSAN.write("CompileRegistry._entries", self)
            self._entries = []
            self._warmed = {}
            self._cost_cache = {}
            self._retraces = 0
            self._attributed = 0
            self._prewarm_covered = 0


#: THE process-wide registry.
COMPILE_REGISTRY = CompileRegistry()


@contextmanager
def profiler_capture(directory, device=None, span=None):
    """One shared profiler capture (kineto: CPU ops and, on a card, CUDA
    kernels): ``hunt --profile`` wraps each worker's loop in it
    (``span="hunt.workon"``, the loop's extent in the trace), ``profile
    --capture DIR`` its analysis pass.  Writes ``DIR/trace-<pid>.json`` (a
    Chrome trace) also when the body raises — the trace of a failed run is
    the one most worth reading — and prints the same line for both.
    ``device`` resolves as every entry point's does
    (:func:`orion_tpu_torch.device.resolve_device`): None means ``cuda``
    and raises where no card is present, so a host without one never
    writes a CPU-only trace in place of the card's.

    The profiler is the kineto one that ``torch.profiler.profile`` wraps,
    driven directly, with the same trace: the wrapper's start reads one
    flag of ``torch._inductor``, and importing that (``torch._dynamo``,
    sympy) takes a fresh worker process seconds before its loop starts."""
    from torch.autograd.profiler import profile, record_function

    from orion_tpu_torch.device import resolve_device

    device = resolve_device(device)
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"trace-{os.getpid()}.json")
    prof = profile(use_device="cuda" if device.type == "cuda" else None, use_kineto=True)
    try:
        with prof:
            if span is None:
                yield path
            else:
                with record_function(span):
                    yield path
    finally:
        prof.export_chrome_trace(path)
        print(f"profile: wrote {path}", file=sys.stderr)
