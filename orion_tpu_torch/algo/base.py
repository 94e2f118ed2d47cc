"""Algorithm interface (port of ``orion_tpu/algo/base.py``).

Algorithms speak **flat unit-cube arrays**: ``suggest`` produces a
``(num, D)`` tensor in [0,1]^D on the algorithm's device, and the framework
decodes it to structured params with the Space's host codec; ``observe``
receives the encoded rows plus an objective vector.

The reference threads a JAX PRNGKey through its state and derives each
purpose's draws from it by ``split`` and ``fold_in``.  Here each instance
owns two ``torch.Generator`` streams on its device, both seeded from its
seed: :attr:`BaseAlgorithm.generator` for the random rounds and the
algorithms' own draws, and :attr:`BaseAlgorithm.model_generator` for the
model rounds of the GP algorithms (their candidate pools and acquisition
draws).  Without the split, a fresh instance at the same seed would draw its
first GP candidates from the very numbers its random round was made of, and
propose the points it had already observed.  ``state_dict`` carries both
streams' states, so a restored instance continues them.  The two packages'
streams differ, and their checkpoints' RNG fields cannot be exchanged
(``orion_tpu_torch.convert`` maps the rest across).
"""

import copy
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from orion_tpu_torch.device import resolve_device
from orion_tpu_torch.space.space import Space
from orion_tpu_torch.utils.registry import Registry

algo_registry = Registry("algo")


class SuggestionBatch(NamedTuple):
    """One suggest round in columnar form.

    ``params`` is the storage-document edge: the per-point dicts trials are
    registered from (a lazy :class:`~orion_tpu_torch.space.params.ParamBatch`).
    ``cube`` is the raw ``(n, D)`` unit-cube rows (host numpy), or None for
    algorithms that never had a cube.
    """

    params: list
    cube: Optional[np.ndarray]


def _effective_share(cls):
    """Union of ``_share_by_ref`` / ``_share_dicts`` over the MRO, cached on
    the class itself."""
    cached = cls.__dict__.get("__effective_share__")
    if cached is not None:
        return cached
    ref, dicts = set(), set()
    for klass in cls.__mro__:
        ref.update(klass.__dict__.get("_share_by_ref", ()))
        dicts.update(klass.__dict__.get("_share_dicts", ()))
    out = (frozenset(ref), frozenset(dicts))
    cls.__effective_share__ = out
    return out


def model_seed(seed):
    """The model stream's seed for an instance seeded with ``seed``: derived
    from it by a hash, as the reference folds a purpose into a key."""
    state = np.random.SeedSequence([int(seed) % 2**63, 1]).generate_state(1, np.uint64)
    return int(state[0] % 2**63)


def _copy_generator(gen):
    clone = torch.Generator(device=gen.device)
    clone.set_state(gen.get_state())
    return clone


class BaseAlgorithm:
    """Base class for optimization algorithms.

    Subclasses implement ``_suggest_cube(num)`` returning a ``(num, D)``
    unit-cube tensor (or None to opt out this round) and may override
    ``observe_arrays``.
    """

    requires_fidelity = False

    # True for algorithms whose `_suggest_cube` returns a tensor whose
    # device work may still be running (CUDA launches are asynchronous):
    # a caller may split suggestion into dispatch_suggest/finalize_suggest.
    supports_async_suggest = False

    # True ONLY when suggestions do not depend on observations at all.
    speculation_safe = False

    # True when observe() actually consumes the columnar ``cube`` rows.
    uses_observe_cube = True

    # Fields a deepcopy shares instead of copying (unioned over the MRO):
    # - _share_by_ref: immutable-by-rebinding values (Space, fitted GP state);
    # - _share_dicts: dicts whose values follow that discipline but which
    #   are mutated by key assignment — shallow-copied.
    _share_by_ref = ("space",)
    _share_dicts = ()

    def __deepcopy__(self, memo):
        cls = type(self)
        share_ref, share_dicts = _effective_share(cls)
        clone = cls.__new__(cls)
        memo[id(self)] = clone
        for key, value in self.__dict__.items():
            if key in share_ref:
                setattr(clone, key, value)
            elif key in share_dicts:
                setattr(clone, key, dict(value))
            elif isinstance(value, torch.Generator):
                setattr(clone, key, _copy_generator(value))
            else:
                setattr(clone, key, copy.deepcopy(value, memo))
        return clone

    def __init__(self, space, seed=None, device=None, **params):
        if not isinstance(space, Space):
            raise TypeError(f"space must be a Space, got {type(space)}")
        self.space = space
        self.device = resolve_device(device)
        self._params = dict(params)
        self._seed = seed
        self._generator = torch.Generator(device=self.device)
        self._model_generator = torch.Generator(device=self.device)
        if seed is None:
            # Each unseeded instance gets its own stream: concurrent workers
            # sharing a fixed default seed would all suggest the same points.
            seed = int.from_bytes(os.urandom(4), "little")
        self._seed_streams(seed)
        self._n_observed = 0

    # --- RNG ---------------------------------------------------------------
    def _seed_streams(self, seed):
        self._generator.manual_seed(int(seed))
        self._model_generator.manual_seed(model_seed(seed))

    def seed_rng(self, seed):
        """Reset the algorithm's random streams."""
        self._seed = seed
        self._seed_streams(seed)

    @property
    def generator(self):
        """The random rounds' ``torch.Generator`` (on :attr:`device`)."""
        return self._generator

    @property
    def model_generator(self):
        """The model rounds' ``torch.Generator`` (on :attr:`device`)."""
        return self._model_generator

    # --- state -------------------------------------------------------------
    def state_dict(self):
        """Serializable snapshot; captures everything ``set_state`` needs to
        resume identically, the generator's state included."""
        return {
            "rng_state": self._generator.get_state().tolist(),
            "model_rng_state": self._model_generator.get_state().tolist(),
            "n_observed": self._n_observed,
        }

    def set_state(self, state):
        """Restore :meth:`state_dict` output.  A state without
        ``rng_state`` (one converted from ``orion_tpu``) reseeds both
        streams from its ``seed``."""
        if "rng_state" in state:
            self._generator.set_state(torch.tensor(state["rng_state"], dtype=torch.uint8))
            if "model_rng_state" in state:
                self._model_generator.set_state(
                    torch.tensor(state["model_rng_state"], dtype=torch.uint8))
        else:
            self._seed_streams(state["seed"])
        self._n_observed = state["n_observed"]

    # --- core contract -----------------------------------------------------
    def _materialize_batch(self, cube):
        """Decode a cube to a :class:`SuggestionBatch`: ONE bulk
        device->host copy, then the host codec."""
        if torch.is_tensor(cube):
            cube = cube.detach().to("cpu")
        cube = np.asarray(cube, dtype=np.float32)
        arrays = self.space.decode_flat_np(cube)
        params = self.space.arrays_to_params(
            arrays, fidelity_value=self._fidelity_for_new()
        )
        return SuggestionBatch(params, cube)

    def suggest(self, num=1):
        """Return ``num`` new points as a list of param dicts, or None to
        signal a temporary opt-out.  Does not route through
        :meth:`suggest_batch`, so an override delegating to
        ``super().suggest()`` cannot recurse."""
        cube = self._suggest_cube(num)
        if cube is None:
            return None
        return self._materialize_batch(cube).params

    def suggest_batch(self, num=1):
        """Columnar twin of :meth:`suggest`: a :class:`SuggestionBatch`
        (params + the raw cube rows) or None on opt-out.  Algorithms that
        override ``suggest`` itself are routed through their override and
        yield ``cube=None``."""
        if type(self).suggest is not BaseAlgorithm.suggest:
            params = self.suggest(num)
            return SuggestionBatch(params, None) if params is not None else None
        cube = self._suggest_cube(num)
        if cube is None:
            return None
        return self._materialize_batch(cube)

    def _suggest_cube(self, num):
        raise NotImplementedError

    # --- asynchronous suggestion (device-overlap path) ----------------------
    def dispatch_suggest(self, num=1):
        """Start the device work for ``num`` suggestions WITHOUT copying the
        result to the host.  Returns an opaque handle for
        :meth:`finalize_suggest`, or None (opt-out / unsupported)."""
        if not self.supports_async_suggest:
            return None
        cube = self._suggest_cube(num)
        if cube is None:
            return None
        return (num, cube)

    def finalize_suggest(self, handle):
        """Force a :meth:`dispatch_suggest` handle to concrete params."""
        num, cube = handle
        return self._materialize_batch(cube[:num]).params

    def finalize_suggest_batch(self, handle):
        """Columnar finalize of a :meth:`dispatch_suggest` handle.  Plugins
        that override ``finalize_suggest`` are routed through it and yield
        ``cube=None``."""
        if type(self).finalize_suggest is not BaseAlgorithm.finalize_suggest:
            return SuggestionBatch(self.finalize_suggest(handle), None)
        num, cube = handle
        return self._materialize_batch(cube[:num])

    def _fidelity_for_new(self):
        """Fidelity assigned to fresh points (max budget)."""
        fid = self.space.fidelity
        return fid.high if fid is not None else None

    def observe(self, params_list, results, cube=None):
        """Feed evaluated points back.

        ``results`` is a list of dicts with at least ``objective``.  The
        points are encoded to the unit cube and forwarded to
        :meth:`observe_arrays`.  ``cube``: pre-encoded rows for
        ``params_list``, exactly as ``Space.params_to_cube`` gives them.
        """
        if not params_list:
            return
        if cube is None:
            cube = self.space.params_to_cube(params_list)
        else:
            cube = np.asarray(cube, dtype=np.float32)
            if cube.shape[0] != len(params_list):
                raise ValueError(
                    f"cube has {cube.shape[0]} rows for "
                    f"{len(params_list)} params"
                )
        objectives = np.asarray(
            [float(r["objective"]) for r in results], dtype=np.float64
        )
        fidelities = None
        fid = self.space.fidelity
        if fid is not None:
            from orion_tpu_torch.space.params import ParamBatch

            if isinstance(params_list, ParamBatch) and params_list.has_column(fid.name):
                col = params_list.column(fid.name)
            else:
                col = [p[fid.name] for p in params_list]
            fidelities = np.asarray(col, dtype=np.int64)
        self.observe_arrays(cube, objectives, params_list=params_list, fidelities=fidelities)
        self._n_observed += len(params_list)

    def observe_arrays(self, cube, objectives, params_list=None, fidelities=None):
        """Device-facing observation hook; default is stateless."""

    def register_suggestion(self, params):
        """Called after a suggested point is registered as a trial."""

    def health_record(self):
        """One optimization-health snapshot dict, or None (the default)."""
        return None

    @property
    def n_observed(self):
        return self._n_observed

    @property
    def is_done(self):
        return False

    def score(self, params):  # pragma: no cover - default
        return 0

    def judge(self, params, measurements):  # pragma: no cover - default
        return None

    @property
    def should_suspend(self):  # pragma: no cover - default
        return False

    @property
    def configuration(self):
        """Dict form used for storage/EVC comparison."""
        name = type(self).__name__.lower()
        cfg = dict(self._params)
        if self._seed is not None:
            cfg["seed"] = self._seed
        return {name: cfg}


#: Modules of the port that register algorithms: every name of the
#: reference's registry.
_BUILTIN_MODULES = (
    "random_search",
    "asha",
    "asha_bo",
    "bohb",
    "cmaes",
    "de",
    "hyperband",
    "grid_search",
    "tpe",
    "tpu_bo",
)


def _import_builtins():
    import importlib

    for mod in _BUILTIN_MODULES:
        importlib.import_module(f"orion_tpu_torch.algo.{mod}")


def create_algo(space, config=None, seed=None, device=None):
    """Instantiate an algorithm from config.

    ``config`` is either a name string (``"random"``, the default) or a
    one-key dict ``{"tpu_bo": {...kwargs}}``.  ``device=None`` means ``cuda``, and raises
    where no card is present; pass ``device="cpu"`` to run on the CPU.
    Unknown names raise with the available choices listed.
    """
    _import_builtins()
    # Every instantiation path funnels through here, as in the reference:
    # settle the kernel build directory (ORION_TPU_JIT_CACHE) before the
    # first build.
    from orion_tpu_torch.utils.jit_cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()
    config = config or "random"
    if isinstance(config, str):
        name, kwargs = config, {}
    elif isinstance(config, dict):
        if len(config) != 1:
            raise ValueError(f"Algorithm config must have exactly one key: {config}")
        name, kwargs = next(iter(config.items()))
        kwargs = dict(kwargs or {})
    else:
        raise TypeError(f"Bad algorithm config {config!r}")
    if seed is not None:
        kwargs.setdefault("seed", seed)
    kwargs.setdefault("device", device)
    return algo_registry.create(name, space, **kwargs)
