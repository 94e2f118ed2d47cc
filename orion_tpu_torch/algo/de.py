"""Differential evolution on the device (port of ``orion_tpu/algo/de.py``):
rand/1/bin or best/1/bin proposals, crowding replacement.

A proposal batch -- base selection, differential mutation with per-vector
F dither, binomial crossover, boundary reflection -- is one pass of gathers
and arithmetic over the population (:func:`_de_propose`, a function of its
random draws :class:`DEDraws`).  Observations integrate by crowding: each
replaces the NEAREST population member iff it improves on it, so any point
(own proposal, another worker's, a lie) integrates through one rule.
"""

from typing import NamedTuple

import numpy as np
import torch

from orion_tpu_torch.algo.base import BaseAlgorithm, algo_registry
from orion_tpu_torch.algo.sampling import reflect_unit


class DEDraws(NamedTuple):
    """The random arrays of one :func:`_de_propose` call for ``num`` rows."""

    offset: torch.Tensor  # () int in [0, P): first target member
    r1: torch.Tensor  # (num,) int in [0, P-1): shifted past the target
    r2: torch.Tensor
    r3: torch.Tensor
    F: torch.Tensor  # (num, 1) differential weight in [f_lo, f_hi)
    cross: torch.Tensor  # (num, d) bool, True with probability cr
    jrand: torch.Tensor  # (num,) int in [0, d): the forced mutant coordinate


def sample_de_draws(generator, P, num, d, f_lo, f_hi, cr, device):
    kw = dict(generator=generator, device=device)
    return DEDraws(
        offset=torch.randint(0, P, (), **kw),
        r1=torch.randint(0, P - 1, (num,), **kw),
        r2=torch.randint(0, P - 1, (num,), **kw),
        r3=torch.randint(0, P - 1, (num,), **kw),
        F=f_lo + (f_hi - f_lo) * torch.rand((num, 1), dtype=torch.float32, **kw),
        cross=torch.rand((num, d), dtype=torch.float32, **kw) < cr,
        jrand=torch.randint(0, d, (num,), **kw),
    )


def _de_propose(draws, pop, fit, mutation):
    """One batch of trial vectors from the (P, d) population.  Targets cycle
    through the population from ``draws.offset``; r1/r2/r3 are distinct
    from the target by the shift trick (an r2 == r3 collision is rare and
    harmless: the mutant degenerates to the base)."""
    P, d = pop.shape
    num = draws.r1.shape[0]
    dev = pop.device
    target = (torch.arange(num, device=dev) + draws.offset.long()) % P

    def pick(r):
        r = r.long()
        return r + (r >= target).long()

    r1, r2, r3 = pick(draws.r1), pick(draws.r2), pick(draws.r3)
    if mutation == "best1":
        base = pop[torch.argmin(fit)][None, :]
    else:  # rand/1
        base = pop[r1]
    v = base + draws.F * (pop[r2] - pop[r3])
    # Binomial crossover with one forced mutant coordinate per vector.
    forced = torch.arange(d, device=dev)[None, :] == draws.jrand.long()[:, None]
    u = torch.where(draws.cross | forced, v, pop[target])
    return reflect_unit(u)


@algo_registry.register("de")
class DifferentialEvolution(BaseAlgorithm):
    """Differential evolution with crowding replacement.

    ``popsize`` (default ``min(max(16, 5·d), 128)``): the first ``popsize``
    observations seed the population.  ``f_lo``/``f_hi``: dither range of
    F.  ``cr``: crossover rate.  ``mutation``: ``"rand1"`` or ``"best1"``.
    ``tol_pop``: ``is_done`` once every member lies within it of the best
    (clamped to 1e-6, the float32 resolution crowding can reach)."""

    supports_async_suggest = True

    def __init__(
        self,
        space,
        seed=None,
        popsize=None,
        f_lo=0.5,
        f_hi=1.0,
        cr=0.9,
        mutation="rand1",
        tol_pop=1e-6,
        device=None,
    ):
        d = space.n_cols
        if popsize is None:
            popsize = min(max(16, 5 * d), 128)
        popsize = max(int(popsize), 4)
        if mutation not in ("rand1", "best1"):
            raise ValueError(f"mutation must be 'rand1' or 'best1', got {mutation!r}")
        super().__init__(
            space, seed=seed, device=device, popsize=popsize, f_lo=f_lo, f_hi=f_hi, cr=cr,
            mutation=mutation, tol_pop=tol_pop,
        )
        self.popsize = popsize
        self.f_lo = float(f_lo)
        self.f_hi = float(f_hi)
        self.cr = float(cr)
        self.mutation = mutation
        self.tol_pop = max(float(tol_pop), 1e-6)
        self._pop = np.zeros((popsize, d), dtype=np.float32)
        self._fit = np.zeros((popsize,), dtype=np.float32)
        self._n_filled = 0

    # --- suggestion ---------------------------------------------------------
    def _suggest_cube(self, num):
        d = self.space.n_cols
        if self._n_filled < self.popsize:
            # Population still seeding: propose prior samples.
            return torch.rand((int(num), d), generator=self._generator, device=self.device)
        draws = sample_de_draws(self._generator, self.popsize, int(num), d, self.f_lo,
                                self.f_hi, self.cr, self.device)
        pop = torch.from_numpy(self._pop.copy()).to(self.device)
        fit = torch.from_numpy(self._fit.copy()).to(self.device)
        return _de_propose(draws, pop, fit, self.mutation)

    # --- observation --------------------------------------------------------
    def observe_arrays(self, cube, objectives, params_list=None, fidelities=None):
        # Drop non-finite rows instead of clamping them: a clamped lie would
        # enter the population with a fabricated fitness and persist.
        cube = np.asarray(cube, dtype=np.float32)
        # Filter on the incoming float64 values (a cast first would turn
        # large finite objectives into inf), then clip into float32 range.
        objectives = np.asarray(objectives, dtype=np.float64)
        finite = np.isfinite(objectives)
        if not finite.all():
            cube, objectives = cube[finite], objectives[finite]
        if objectives.size == 0:
            return
        f32_max = float(np.finfo(np.float32).max)
        objectives = np.clip(objectives, -f32_max, f32_max).astype(np.float32)
        for row, y in zip(cube, objectives):
            if self._n_filled < self.popsize:
                self._pop[self._n_filled] = row
                self._fit[self._n_filled] = y
                self._n_filled += 1
                continue
            # Crowding, sequential on purpose: an accepted replacement
            # changes the neighbourhoods later rows compete in.
            j = int(np.argmin(((self._pop - row[None, :]) ** 2).sum(axis=1)))
            if y < self._fit[j]:
                self._pop[j] = row
                self._fit[j] = y

    # --- lifecycle ----------------------------------------------------------
    @property
    def is_done(self):
        """Population collapse: every member within ``tol_pop`` of the best."""
        if self._n_filled < self.popsize:
            return False
        spread = np.abs(self._pop - self._pop[np.argmin(self._fit)][None, :]).max()
        return float(spread) <= self.tol_pop

    # --- state --------------------------------------------------------------
    def state_dict(self):
        out = super().state_dict()
        out["pop"] = self._pop.tolist()
        out["fit"] = self._fit.tolist()
        out["n_filled"] = self._n_filled
        return out

    def set_state(self, state):
        super().set_state(state)
        d = self.space.n_cols
        self._pop = np.asarray(state["pop"], dtype=np.float32).reshape(-1, d)
        self._fit = np.asarray(state["fit"], dtype=np.float32)
        self._n_filled = int(state["n_filled"])
        # The restored arrays ARE the population: popsize follows them.
        if self._pop.shape[0] != self._fit.shape[0]:
            raise ValueError(
                "inconsistent DE state: pop has "
                f"{self._pop.shape[0]} rows but fit has {self._fit.shape[0]}"
            )
        self.popsize = self._pop.shape[0]
