"""Trial entity: the unit of optimization work (port of
``orion_tpu/core/trial.py``, host code copied as it is: the ids must be
the reference's, bit for bit, so that the port resumes an experiment the
reference created).

Capability parity: reference `src/orion/core/worker/trial.py` (status machine
``new -> reserved -> completed | interrupted | broken | suspended``, nested
Param/Result values, md5 identity over params+experiment+lie flag, single-
objective accessors).  Host-only code — trials are the coordination currency
between workers; device code never sees them (it sees the flat arrays the
Space codec produces from their params).
"""

import hashlib
import time
from dataclasses import dataclass


ALL_STATUSES = (
    "new",
    "reserved",
    "suspended",
    "completed",
    "interrupted",
    "broken",
)

#: Trial identity schemes an experiment may select (``id_scheme`` config
#: field, default ``"md5"`` so every pre-existing experiment resumes
#: unchanged).  ``cube_hash`` hashes the canonical cube-row bytes instead
#: of assembling a params repr per trial — same uniqueness contract (the
#: storage unique index on ``_id``), ~an order of magnitude cheaper per
#: point.  `orion-tpu db migrate-ids` rewrites an existing experiment
#: from one scheme to the other (docs/multi_node.md).
ID_SCHEMES = ("md5", "cube_hash")

#: Statuses a worker may atomically reserve from (reference `legacy.py:253-273`).
RESERVABLE_STATUSES = ("new", "suspended", "interrupted")

#: Statuses meaning the trial will make no further progress.
STOPPED_STATUSES = ("completed", "interrupted", "broken")

RESULT_TYPES = ("objective", "constraint", "gradient", "statistic", "lie")
PARAM_TYPES = ("integer", "real", "categorical", "fidelity")


_PLAIN_SCALARS = frozenset((str, int, float, bool, type(None)))


def _canonical(value):
    """Print-independent canonical form of a param value for hashing.

    ``repr`` of numpy arrays is truncated by print options, so distinct large
    arrays would collide; normalize array-likes to full nested lists first.
    Plain python scalars (the overwhelmingly common case — one call per param
    per trial-id computation) shortcut straight to ``repr``, which is exactly
    what the general path returns for them, so stored trial ids are unchanged.
    """
    if type(value) in _PLAIN_SCALARS:
        return repr(value)
    try:
        import numpy as np

        if isinstance(value, np.ndarray):
            return repr(value.tolist())
        if isinstance(value, np.generic):
            return repr(value.item())
    except ImportError:  # pragma: no cover
        pass
    if isinstance(value, (list, tuple)):
        # Keep list/tuple distinguishable while canonicalizing elements.
        inner = ",".join(_canonical(v) for v in value)
        return ("[%s]" if isinstance(value, list) else "(%s)") % inner
    return repr(value)


def validate_status(status):
    if status is not None and status not in ALL_STATUSES:
        raise ValueError(f"Invalid trial status {status!r}; one of {ALL_STATUSES}")
    return status


@dataclass
class Result:
    """One reported value: ``{"name", "type", "value"}``."""

    name: str
    type: str
    value: object

    def __post_init__(self):
        if self.type not in RESULT_TYPES:
            raise ValueError(f"Invalid result type {self.type!r}; one of {RESULT_TYPES}")

    def to_dict(self):
        return {"name": self.name, "type": self.type, "value": self.value}


class Trial:
    """A single evaluation of the user's black box at one point of the space."""

    __slots__ = (
        "experiment",
        "_status",
        "params",
        "results",
        "worker",
        "submit_time",
        "start_time",
        "end_time",
        "heartbeat",
        "working_dir",
        "parents",
        "_id_override",
    )

    def __init__(
        self,
        experiment=None,
        status="new",
        params=None,
        results=None,
        worker=None,
        submit_time=None,
        start_time=None,
        end_time=None,
        heartbeat=None,
        working_dir=None,
        parents=None,
        _id=None,
        **_ignored,
    ):
        self.experiment = experiment
        self._status = validate_status(status) or "new"
        self.params = dict(params or {})
        self.results = [r if isinstance(r, Result) else Result(**r) for r in (results or [])]
        self.worker = worker
        self.submit_time = submit_time
        self.start_time = start_time
        self.end_time = end_time
        self.heartbeat = heartbeat
        self.working_dir = working_dir
        self.parents = list(parents or [])
        self._id_override = _id

    # --- status machine ---------------------------------------------------
    @property
    def status(self):
        return self._status

    @status.setter
    def status(self, value):
        self._status = validate_status(value)

    @property
    def is_stopped(self):
        return self._status in STOPPED_STATUSES

    # --- identity ---------------------------------------------------------
    @property
    def id(self):
        """Deterministic md5 identity (reference `trial.py:293-309`).

        Hash of experiment + sorted params (+ a lie marker), so the same point
        registered twice collides on the storage unique index — which is how
        duplicate suggestions are detected across concurrent producers.
        """
        if self._id_override is not None:
            return self._id_override
        return self.compute_id(self.experiment, self.params, lie=bool(self.lie))

    @staticmethod
    def compute_id(experiment, params, lie=False):
        payload = repr(
            (
                str(experiment),
                sorted((str(k), _canonical(v)) for k, v in params.items()),
                bool(lie),
            )
        )
        return hashlib.md5(payload.encode("utf-8")).hexdigest()

    @property
    def hash_params(self):
        """Identity of the parameter point alone (used for cross-status dedup)."""
        return Trial.compute_id(self.experiment, self.params, lie=False)

    # --- results accessors (single-objective, reference `trial.py:311-333`) ---
    def _fetch_one(self, rtype):
        for result in self.results:
            if result.type == rtype:
                return result
        return None

    @property
    def objective(self):
        return self._fetch_one("objective")

    @property
    def lie(self):
        return self._fetch_one("lie")

    @property
    def gradient(self):
        return self._fetch_one("gradient")

    @property
    def constraints(self):
        return [r for r in self.results if r.type == "constraint"]

    @property
    def statistics(self):
        return [r for r in self.results if r.type == "statistic"]

    # --- serialization ------------------------------------------------------
    def to_dict(self):
        return {
            "_id": self.id,
            "experiment": self.experiment,
            "status": self._status,
            "params": dict(self.params),
            "results": [r.to_dict() for r in self.results],
            "worker": self.worker,
            "submit_time": self.submit_time,
            "start_time": self.start_time,
            "end_time": self.end_time,
            "heartbeat": self.heartbeat,
            "working_dir": self.working_dir,
            "parents": list(self.parents),
        }

    @classmethod
    def from_dict(cls, doc):
        doc = dict(doc)
        doc.pop("exp_working_dir", None)
        return cls(**doc)

    # --- misc ---------------------------------------------------------------
    @property
    def duration(self):
        if self.start_time is None:
            return 0.0
        end = self.end_time if self.end_time is not None else time.time()
        return end - self.start_time

    def params_repr(self, sep=","):
        return sep.join(f"{k}:{v}" for k, v in sorted(self.params.items()))

    def __eq__(self, other):
        return isinstance(other, Trial) and self.id == other.id

    def __hash__(self):
        return hash(self.id)

    def __repr__(self):
        return (
            f"Trial(experiment={self.experiment!r}, status={self._status!r}, "
            f"params={self.params_repr()})"
        )


def compute_batch_ids(experiment, params_rows, lie=False):
    """Vectorized :meth:`Trial.compute_id` over a whole q-round.

    Bit-identical md5s by construction: ``repr`` of the canonical tuple is
    assembled directly from per-part ``repr`` calls (``repr((a, [b, c], d))``
    IS ``"(" + repr(a) + ", [" + repr(b) + ", " + repr(c) + "], " + repr(d)
    + ")"``), with the experiment prefix, the sorted key order, and each
    key's own ``repr`` hoisted out of the per-row work — the per-trial
    ``sorted()`` + generator-tuple build was the single largest host cost
    of a q=1024 registration round.  Rows whose keys differ from the first
    row's (or are not name-sortable the way ``sorted`` on (str(k), value)
    pairs orders them) fall back to :meth:`Trial.compute_id` — correctness
    never depends on the fast path applying.

    Pinned differentially against ``Trial.compute_id`` in
    tests/unit/test_trial_batch.py.
    """
    n = len(params_rows)
    if n == 0:
        return []
    first = params_rows[0]
    keys = list(first)
    fast = all(type(k) is str for k in keys)
    if fast:
        order = sorted(keys)
        key_reprs = [repr(k) for k in order]
        prefix = f"({str(experiment)!r}, ["
        suffix = "], True)" if lie else "], False)"
        key_set = frozenset(order)
    ids = []
    md5 = hashlib.md5
    # lint: disable=PERF001 -- the md5 identity is per-trial by contract
    # (it IS the storage unique index); everything row-invariant (sort
    # order, key reprs, experiment prefix) is hoisted above, leaving one
    # string assembly + hash per row.
    for params in params_rows:
        if fast and params.keys() == key_set:
            parts = ", ".join(
                f"({kr}, {_canonical(params[k])!r})"
                for k, kr in zip(order, key_reprs)
            )
            ids.append(md5((prefix + parts + suffix).encode("utf-8")).hexdigest())
        else:
            ids.append(Trial.compute_id(experiment, params, lie=lie))
    return ids


def compute_cube_ids(experiment, cube_rows, lie=False):
    """Byte-hash trial identity (``id_scheme: "cube_hash"``): one 16-byte
    blake2b per row over ``experiment-prefix | canonical cube-row bytes |
    lie marker``.

    The cube rows MUST come from the canonical params→cube codec
    (``Space.params_to_cube`` — one vectorized encode pass per q-round),
    never from a raw suggestion cube: decode→re-encode is the id's
    canonical form, so the identity is a pure function of the params a
    consumer can always recompute.  Rows canonicalize to contiguous
    little-endian float32 (``<f4``) so the digest is platform-independent;
    the per-row work is one hasher copy + one memoryview slice — no string
    assembly, no repr, which is the entire speedup over the md5 scheme
    (gated ≥ 4× at q=1024 in ``bench.py --smoke``).
    """
    import numpy as np

    rows = np.ascontiguousarray(np.asarray(cube_rows, dtype="<f4"))
    if rows.ndim == 1:
        rows = rows.reshape(1, -1)
    n, width = rows.shape
    if n == 0:
        return []
    base = hashlib.blake2b(
        str(experiment).encode("utf-8") + (b"|L" if lie else b"|P"),
        digest_size=16,
    )
    stride = width * 4
    view = memoryview(rows).cast("B")
    ids = []
    # The identity is per-trial by contract (it IS the storage unique
    # index); everything row-invariant (experiment prefix, lie marker) is
    # folded into the copied base hasher, leaving one update + hexdigest
    # per row.
    for start in range(0, n * stride, stride):
        h = base.copy()
        h.update(view[start:start + stride])
        ids.append(h.hexdigest())
    return ids


def compute_scheme_ids(experiment, params_rows, lie=False, id_scheme="md5",
                       space=None):
    """Batch ids under the experiment's selected ``id_scheme``.

    ``cube_hash`` needs the experiment's :class:`~orion_tpu_torch.space.space
    .Space` to encode params to canonical cube rows; without one — or for
    rows the codec cannot encode (params outside the space: legacy docs,
    plugin-injected points) — the md5 scheme answers instead, so
    correctness never depends on the fast scheme applying.  The fallback
    is deterministic per point (the same params always fail the encode the
    same way), which keeps the duplicate-detection contract intact.
    """
    if id_scheme == "cube_hash" and space is not None and len(params_rows):
        try:
            cube = space.params_to_cube(params_rows)
        except Exception:
            pass
        else:
            return compute_cube_ids(experiment, cube, lie=lie)
    return compute_batch_ids(experiment, params_rows, lie=lie)


class TrialBatch:
    """One q-round of trials in columnar form — the storage-document edge.

    Wraps the round's param rows (a lazy
    :class:`~orion_tpu_torch.space.params.ParamBatch` or a plain dict list) and
    builds the q storage documents in ONE pass (:meth:`to_docs`), ids
    included, instead of q :class:`Trial` constructions + ``to_dict``
    round trips.  Real ``Trial`` objects exist only behind :meth:`trials`,
    for the plugin-compat boundary (the producer's speculative
    lie-conditioning, loop-fallback storage protocols) — they carry the
    precomputed ids, so materializing them never re-pays the md5.
    """

    __slots__ = ("params", "experiment", "parents", "submit_time", "ids",
                 "_trials")

    def __init__(self, params):
        self.params = params
        self.experiment = None
        self.parents = []
        self.submit_time = None
        self.ids = None
        self._trials = None

    def __len__(self):
        return len(self.params)

    def prepare(self, experiment, parents=(), submit_time=None,
                id_scheme="md5", space=None):
        """Stamp the identity fields and freeze the ids (the columnar twin
        of ``Experiment.prepare_trials``): after this, callers may key
        caches or dispatch device work against the real ids BEFORE the
        storage commit.  ``id_scheme``/``space`` select the experiment's
        identity scheme (:func:`compute_scheme_ids`); the default is the
        historical md5 so direct callers are unchanged."""
        self.experiment = experiment
        self.parents = list(parents)
        self.submit_time = time.time() if submit_time is None else submit_time
        self.ids = compute_scheme_ids(
            experiment, self.params, id_scheme=id_scheme, space=space
        )
        self._trials = None
        return self

    @property
    def prepared(self):
        return self.ids is not None

    def to_docs(self):
        """The q raw trial documents, key-for-key what ``Trial.to_dict``
        emits for a freshly prepared trial — fed straight to the storage
        batch primitive (``apply_batch``).  Backends copy/serialize on
        write, so handing out the live param row dicts is safe."""
        experiment = self.experiment
        submit_time = self.submit_time
        parents = list(self.parents)
        # the storage-document edge: one JSON doc
        # per trial IS the output shape; everything inside is O(1) per row.
        return [
            {
                "_id": _id,
                "experiment": experiment,
                "status": "new",
                "params": params,
                "results": [],
                "worker": None,
                "submit_time": submit_time,
                "start_time": None,
                "end_time": None,
                "heartbeat": None,
                "working_dir": None,
                "parents": parents,
            }
            for _id, params in zip(self.ids, self.params)
        ]

    def trials(self):
        """Materialized :class:`Trial` views (cached) — the plugin-compat
        boundary.  Ids ride along as overrides; no md5 is recomputed."""
        if self._trials is None:
            ids = self.ids or [None] * len(self.params)
            # plugin-compat boundary: per-point
            # Trial objects only materialize for per-point plugin APIs.
            self._trials = [
                Trial(
                    experiment=self.experiment,
                    params=params,
                    submit_time=self.submit_time,
                    parents=self.parents,
                    _id=_id,
                )
                for _id, params in zip(ids, self.params)
            ]
        return self._trials

    def trial_at(self, index):
        return self.trials()[index]
