"""Third-party algorithm plugin fixture for ``orion_tpu_torch``.

A package outside the port that registers an algorithm through the
``orion_tpu_torch.algo`` entry point.  The plugin tests install it from a
copy into an isolated ``--target`` directory and find it only through that
entry point, in a fresh interpreter, then converge it on the quadratic demo
box (``tests/fixtures/torch_black_box.py``).

Written against the port's plugin contract: the constructor takes the
``device`` that ``create_algo`` passes, and random draws come from
``self.generator`` (a ``torch.Generator`` on the algorithm's device, saved
and restored by ``state_dict``/``set_state``) through ``Space.sample``.
"""

from orion_tpu_torch.algo.base import BaseAlgorithm


class GradientDescent(BaseAlgorithm):
    """Toy steepest descent driven by the trial's reported ``gradient``
    result (the quadratic demo box reports one next to its objective)."""

    def __init__(self, space, seed=None, device=None, learning_rate=0.1):
        super().__init__(space, seed=seed, device=device, learning_rate=learning_rate)
        self.learning_rate = float(learning_rate)
        self._point = None  # last observed params (user space)
        self._grad = None  # its gradient, aligned with sorted param names

    def suggest(self, num=1):
        if self._point is None or self._grad is None:
            return list(self.space.sample(self.generator, n=num))
        names = [d.name for d in self.space.opt_dims]
        lows_highs = dict(zip(names, self.space.interval()))
        step = {}
        for name, grad in zip(names, self._grad):
            low, high = lows_highs[name]
            value = self._point[name] - self.learning_rate * grad
            step[name] = min(max(value, low), high)
        extra = list(self.space.sample(self.generator, n=num - 1)) if num > 1 else []
        return [step] + extra

    def observe(self, params_list, results):
        for params, result in zip(params_list, results):
            grad = result.get("gradient")
            if grad is None:
                continue  # lies / gradient-less results steer nothing
            self._point = dict(params)
            self._grad = [float(g) for g in grad]
        self._n_observed += len(params_list)

    def state_dict(self):
        out = super().state_dict()
        out["point"] = self._point
        out["grad"] = self._grad
        return out

    def set_state(self, state):
        super().set_state(state)
        self._point = state["point"]
        self._grad = state["grad"]
