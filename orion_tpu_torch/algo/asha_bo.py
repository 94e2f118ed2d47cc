"""ASHA-BO: multi-fidelity Bayesian optimization under ASHA scheduling
(port of ``orion_tpu/algo/asha_bo.py``).

ASHA's bracket/rung machinery is inherited unchanged (host side).  New
bottom-rung points come from a GP fit on every observation at every
fidelity, with the fidelity as one extra input column
s = log(fid/low) / log(high/low) in [0, 1]; candidates are scored at s = 1
(``fixed_tail_cols=1``), so points are picked by their predicted
full-budget value.  A model round is the port's GP-BO step
(:func:`orion_tpu_torch.algo.tpu_bo._suggest_step`), built as a
:class:`~orion_tpu_torch.algo.tpu_bo.FusedPlan` by :meth:`ASHABO._gp_plan`
(warm hypers from the last fit or the cold start, ``refit_steps`` when
warm, the pow-2 q bucket, ``local_sigma`` quantised to a power of 2, the
local GP on the ``tr_local_m`` nearest observations once the history
outgrows it) and run by
:func:`~orion_tpu_torch.algo.tpu_bo.run_fused_plan`: a CUDA graph captured
once per signature.  At the ``asha_bo-ackley50`` preset its EI ranking runs
the ``fused_gram`` kernel on the 8192 x 512 x 51 cross-gram.  ``prewarm``
captures the next history bucket's round ahead of the crossing, as in
``tpu_bo``.

The serve gateway's hooks (``fused_step_plan``, ``consume_fused_step``,
``finish_fused_rows`` and the ``suggest`` override that serves a stash of
promotions first) split a round into its plan, the device round the
gateway may dispatch with other tenants', and the host's bracket assignment,
drawing from both streams in :meth:`suggest`'s order.  ``use_mesh=True``
shards each model round's candidate pool over ``n_devices`` slots, as in
``tpu_bo`` (the mesh rides in the plan's statics).
"""

import numpy as np
import torch

from orion_tpu_torch.algo.asha import ASHA
from orion_tpu_torch.algo.base import algo_registry
from orion_tpu_torch.algo.history import DeviceHistory, HostHistory, _next_pow2
from orion_tpu_torch.algo.prewarm import DEFAULT_PREWARM_FILL, BucketPrewarmer
from orion_tpu_torch.algo.sampling import clamp_objectives
from orion_tpu_torch.algo.tpu_bo import (
    make_fused_plan,
    maybe_prewarm_fused_step,
    mesh_record,
    run_fused_plan,
    tr_update_batch,
)
from orion_tpu_torch.parallel import device_mesh


@algo_registry.register("asha_bo")
class ASHABO(ASHA):
    """ASHA scheduling + fidelity-aware GP sampling.

    Parameters beyond ASHA's: ``n_init`` random bottom-rung points before
    the GP engages; the GP-BO knobs as in ``tpu_bo``."""

    # Unlike plain ASHA, observe() feeds the cube rows to the GP history.
    uses_observe_cube = True

    def __init__(
        self,
        space,
        seed=None,
        num_rungs=None,
        num_brackets=1,
        reduction_factor=None,
        n_init=32,
        n_candidates=8192,
        kernel="matern52",
        acq="thompson",
        fit_steps=40,
        refit_steps=None,
        beta=2.0,
        local_frac=0.5,
        local_sigma=0.1,
        y_transform="none",
        trust_region=False,
        tr_length_init=0.4,
        tr_length_min=0.5**7,
        tr_length_max=0.8,
        tr_succ_tol=3,
        tr_fail_tol=2,
        tr_improve_tol=1e-3,
        tr_local_m=512,
        tr_perturb_dims=20,
        tr_update_every=None,
        prewarm=True,
        prewarm_fill=DEFAULT_PREWARM_FILL,
        n_devices=None,
        use_mesh=False,
        device=None,
    ):
        super().__init__(
            space,
            seed=seed,
            num_rungs=num_rungs,
            num_brackets=num_brackets,
            reduction_factor=reduction_factor,
            device=device,
        )
        self._params.update(
            n_init=n_init, n_candidates=n_candidates, kernel=kernel, acq=acq,
            fit_steps=fit_steps, refit_steps=refit_steps, beta=beta,
            local_frac=local_frac, local_sigma=local_sigma,
            y_transform=y_transform, trust_region=trust_region,
            tr_length_init=tr_length_init, tr_length_min=tr_length_min,
            tr_length_max=tr_length_max, tr_succ_tol=tr_succ_tol,
            tr_fail_tol=tr_fail_tol, tr_improve_tol=tr_improve_tol,
            tr_local_m=tr_local_m, tr_perturb_dims=tr_perturb_dims,
            tr_update_every=tr_update_every, prewarm=prewarm,
            prewarm_fill=prewarm_fill,
        )
        self.n_init = n_init
        self.n_candidates = n_candidates
        self.kernel = kernel
        self.acq = acq
        self.fit_steps = fit_steps
        # None: warm refits also use fit_steps.
        self.refit_steps = refit_steps
        self.beta = beta
        self.local_frac = local_frac
        self.local_sigma = local_sigma
        self.y_transform = y_transform
        self.trust_region = trust_region
        self.tr_length_init = tr_length_init
        self.tr_length_min = tr_length_min
        self.tr_length_max = tr_length_max
        self.tr_succ_tol = tr_succ_tol
        self.tr_fail_tol = tr_fail_tol
        self.tr_improve_tol = tr_improve_tol
        self.tr_local_m = tr_local_m
        self.tr_perturb_dims = tr_perturb_dims
        self.tr_update_every = tr_update_every
        self.prewarm = bool(prewarm)
        self.prewarm_fill = float(prewarm_fill)
        self._prewarmer = BucketPrewarmer()
        self._last_q_bucket = None
        # The candidate mesh of the fused round (as TPUBO's).
        self.use_mesh = use_mesh
        self._mesh = device_mesh(n_devices, device=self.device) if use_mesh else None
        self._tr_length = tr_length_init
        self._tr_succ = 0
        self._tr_fail = 0
        fid = space.fidelity
        self._log_low = float(np.log(max(fid.low, 1)))
        self._log_span = float(max(np.log(max(fid.high, 1)) - self._log_low, 1e-9))
        d = space.n_cols
        # Augmented rows [x | s] with objectives y, on the host (incumbent
        # tracking) and on the device (the GP's input buffers).
        self._host = HostHistory(d + 1)
        self._hist = DeviceHistory(d + 1, device=self.device)
        self._gp_state = None
        # Best observation at the highest observed fidelity tier, tracked
        # incrementally (a full rescan only when a new top tier appears).
        self._s_top = -np.inf
        self._top_best_idx = -1
        self._top_best_y = np.inf
        # Local radius around the incumbent: expands while improving,
        # shrinks when stalled.
        self._sigma = local_sigma
        self._best_seen = np.inf
        # A gateway round's carry (see `fused_step_plan`): the promotions it
        # already consumed and the bracket uniforms drawn after them and
        # before the plan's draws; `finish_fused_rows` consumes both.
        self._pending_promoted = None
        self._pending_bracket_u = None

    # The fitted GP state is immutable-by-rebinding; `_hist` and `_host`
    # implement copy-on-write in their own __deepcopy__; the prewarmer's
    # threads and the cached mesh are shared, as in tpu_bo.
    _share_by_ref = ("space", "_gp_state", "_mesh", "_prewarmer")

    # Views over the augmented host history.
    @property
    def _mf_x(self):
        return self._host.x[:, : self.space.n_cols]

    @property
    def _mf_s(self):
        return self._host.x[:, self.space.n_cols]

    @property
    def _mf_y(self):
        return self._host.y

    # --- observation ---------------------------------------------------------
    def _fid_norm(self, fidelity):
        return (np.log(max(float(fidelity), 1.0)) - self._log_low) / self._log_span

    def observe(self, params_list, results, cube=None):
        super().observe(params_list, results)  # rung bookkeeping
        valid, valid_idx, svals, yvals = [], [], [], []
        for i, (params, result) in enumerate(zip(params_list, results)):
            objective = result.get("objective")
            if objective is None:
                continue
            valid.append(params)
            valid_idx.append(i)
            svals.append(self._fid_norm(params.get(self.fidelity_name, 1)))
            yvals.append(float(objective))
        if not valid:
            return
        y = clamp_objectives(np.asarray(yvals, dtype=np.float64), self._mf_y)
        if y is None:
            return
        if cube is not None:
            rows = np.asarray(cube, dtype=np.float32)[valid_idx]
        else:
            rows = self.space.params_to_cube(valid)
        rows32 = np.asarray(rows, dtype=np.float32)
        s32 = np.asarray(svals, dtype=np.float32)
        y32 = y.astype(np.float32)
        prev_count = self._host.count
        aug = np.concatenate([rows32, s32[:, None]], axis=1)
        self._host.append(aug, y32)
        self._hist.append(aug, y32)
        self._update_top_tier(prev_count, s32, y32)
        prev_best = self._best_seen
        batch_best = float(np.min(y))
        if batch_best < self._best_seen - 1e-9:
            self._best_seen = batch_best
            self._sigma = min(self._sigma * 1.5, 0.4)
        else:
            self._sigma = max(self._sigma * 0.7, 0.005)
        # Trust-region bookkeeping on model rounds only, ONE update per
        # observe round by default: a rung batch mixes fidelities, and
        # chunk-wise accounting over mixed budgets thrashes the box.
        if self.trust_region and prev_count >= self.n_init:
            self._tr_length, self._tr_succ, self._tr_fail, _ = tr_update_batch(
                self._tr_length, self._tr_succ, self._tr_fail,
                prev_best, y, chunk=self.tr_update_every or max(1, len(y)),
                succ_tol=self.tr_succ_tol, fail_tol=self.tr_fail_tol,
                length_init=self.tr_length_init,
                length_min=self.tr_length_min,
                length_max=self.tr_length_max,
                improve_tol=self.tr_improve_tol,
            )
        # Last, after the sigma and box updates: local_sigma is a static of
        # the round, and a warm before the update would capture a stale
        # signature.
        self._maybe_prewarm(batch=len(y32))

    def _update_top_tier(self, prev_count, s32, y32):
        """Incremental best-at-top-fidelity-tier tracking: a batch that
        RAISES the top tier triggers one full rescan, anything else updates
        from the batch."""
        batch_top = float(np.max(s32))
        if batch_top > self._s_top + 1e-9:
            self._s_top = batch_top
            s_all, y_all = self._mf_s, self._mf_y
            pool = np.nonzero(s_all >= self._s_top - 1e-6)[0]
            at = pool[int(np.argmin(y_all[pool]))]
            self._top_best_idx = int(at)
            self._top_best_y = float(y_all[at])
            return
        in_tier = np.nonzero(s32 >= self._s_top - 1e-6)[0]
        if in_tier.size:
            at = in_tier[int(np.argmin(y32[in_tier]))]
            # Strict <: ties keep the earliest index.
            if float(y32[at]) < self._top_best_y:
                self._top_best_y = float(y32[at])
                self._top_best_idx = prev_count + int(at)

    # --- model-based sampling -----------------------------------------------
    def _maybe_prewarm(self, batch=0):
        # The fidelity rides along as the fixed context column
        # (fixed_tail_cols in _step_kw).
        maybe_prewarm_fused_step(self, batch=batch)

    def _step_kw(self):
        kw = dict(
            n_candidates=self.n_candidates, kernel=self.kernel, acq=self.acq,
            fit_steps=self.fit_steps, refit_steps=self.refit_steps,
            local_frac=self.local_frac,
            # A power of 2: a static of the round that changes the
            # candidates; a freely varying value would recapture each round.
            local_sigma=float(2.0 ** round(np.log2(self._sigma))), beta=self.beta,
            trust_region=self.trust_region, tr_length=self._tr_length,
            tr_perturb_dims=self.tr_perturb_dims, y_transform=self.y_transform,
            fixed_tail_cols=1,
        )
        if self._mesh is not None:
            kw["mesh"] = self._mesh
        return kw

    def _gp_plan(self, num):
        """This round's fidelity-augmented GP acquisition as a
        :class:`~orion_tpu_torch.algo.tpu_bo.FusedPlan`."""
        n = self._host.count
        self._last_q_bucket = _next_pow2(num, floor=8)
        # The trust box centres on the global incumbent (the s-lengthscale
        # decides how far to trust low fidelities); without it, on the best
        # observation at the top fidelity tier.
        best_row = self._host.best_idx if self.trust_region else self._top_best_idx
        d = self.space.n_cols
        if self.trust_region and n > self.tr_local_m:
            # Local GP on the nearest observations (x-distance, the s column
            # ignored), gathered on the device.
            x_dev, y_dev, mask_dev, _ = self._hist.local_view(
                self._host.x[best_row], self.tr_local_m, dist_cols=d
            )
        else:
            x_dev, y_dev, mask_dev, _ = self._hist.fit_view()
        best_x = torch.from_numpy(self._host.x[best_row, :d].copy()).to(self.device)
        step_kw = self._step_kw()
        tr_length = step_kw.pop("tr_length")
        return make_fused_plan(
            self.model_generator, x_dev, y_dev, mask_dev, best_x, self._gp_state, num,
            tr_length=tr_length, **step_kw,
        )

    def _new_cube(self, num):
        if self._host.count < self.n_init:
            return super()._new_cube(num)
        rows, state = run_fused_plan(self._gp_plan(num))
        self._gp_state = state
        return rows

    # --- the serve gateway's hooks -------------------------------------------
    def suggest(self, num=1):
        # A gateway round that fell back to the plain path after consuming
        # its promotions (a promotions-only round, or a failed dispatch)
        # serves that stash first: `_promote_one` already reserved those
        # next-rung slots.  The stash is exactly what `suggest` would have
        # emitted first, so the stream is the standalone one.
        stash, self._pending_promoted = self._pending_promoted, None
        self._pending_bracket_u = None
        if not stash:
            return super().suggest(num)
        out = list(stash)
        while len(out) < num:
            promoted = self._promote_one()
            if promoted is None:
                break
            out.append(promoted)
        remaining = num - len(out)
        if remaining:
            out.extend(self._sample_new(remaining))
        return out or None

    def fused_step_plan(self, num):
        """This round's GP part as a plan, or None when there is no device
        work (the random-init phase, or a promotions-only round).  In
        :meth:`suggest`'s order: the pending promotions are consumed into a
        stash, then the bracket uniforms of the fresh points are drawn
        (the random stream), then the plan's draws (the model stream).
        Consuming, as ``tpu_bo``'s: the holder runs the plan and hands its
        rows to :meth:`finish_fused_rows`."""
        if self._host.count < self.n_init:
            return None
        promoted = self._pending_promoted or []
        while len(promoted) < num:
            point = self._promote_one()
            if point is None:
                break
            promoted.append(point)
        self._pending_promoted = promoted
        remaining = num - len(promoted)
        if remaining <= 0:
            return None
        self._pending_bracket_u = torch.rand((remaining,), generator=self._generator,
                                             device=self.device)
        return self._gp_plan(remaining)

    def consume_fused_step(self, state):
        """Take the GPState a plan's round produced."""
        self._gp_state = state

    def finish_fused_rows(self, rows):
        """The gateway's demux: the round's cube rows become full params
        through the same bracket assignment, fidelity stamp and rung
        pre-registration as :meth:`_sample_new`, behind the round's stashed
        promotions, where :meth:`suggest` puts them."""
        bracket_u, self._pending_bracket_u = self._pending_bracket_u, None
        promoted, self._pending_promoted = self._pending_promoted, None
        if bracket_u is None:
            raise RuntimeError("finish_fused_rows without a pending fused_step_plan")
        return list(promoted or ()) + self._assign_new_points(rows, bracket_u)

    # --- health --------------------------------------------------------------
    def health_record(self):
        """ASHA's rung occupancy plus the GP side: incumbent over the
        augmented history, trust-region box, and the device fields the last
        step packed into its GPState."""
        from orion_tpu_torch.health import unpack_device_health

        record = super().health_record()
        record.update(
            tr_length=float(self._tr_length),
            tr_succ=int(self._tr_succ),
            tr_fail=int(self._tr_fail),
        )
        if self._host.count:
            record["best_y"] = float(self._host.best_y)
            record["n_obs"] = int(self._host.count)
        if self._mesh is not None:
            record.update(mesh_record(self._mesh))
        state = self._gp_state
        if state is not None and state.health is not None:
            record.update(unpack_device_health(state.health))
        return record

    # --- state ---------------------------------------------------------------
    def state_dict(self):
        out = super().state_dict()
        out["mf_x"] = self._mf_x.tolist()
        out["mf_s"] = self._mf_s.tolist()
        out["mf_y"] = self._mf_y.tolist()
        out["sigma"] = self._sigma
        out["best_seen"] = None if np.isinf(self._best_seen) else self._best_seen
        out["tr"] = [self._tr_length, self._tr_succ, self._tr_fail]
        return out

    def set_state(self, state):
        super().set_state(state)
        d = self.space.n_cols
        mf_x = np.asarray(state.get("mf_x", []), dtype=np.float32).reshape(-1, d)
        mf_s = np.asarray(state.get("mf_s", []), dtype=np.float32)
        mf_y = np.asarray(state.get("mf_y", []), dtype=np.float32)
        aug = np.concatenate([mf_x, mf_s[:, None]], axis=1)
        self._host = HostHistory.from_host(aug, mf_y)
        self._hist = DeviceHistory.from_host(aug, mf_y, device=self.device)
        self._s_top = -np.inf
        self._top_best_idx = -1
        self._top_best_y = np.inf
        if mf_s.size:
            self._update_top_tier(0, mf_s, mf_y)
        self._sigma = state.get("sigma", self.local_sigma)
        best = state.get("best_seen")
        self._best_seen = np.inf if best is None else float(best)
        tr = state.get("tr")
        if tr is not None:
            self._tr_length, self._tr_succ, self._tr_fail = tr[0], int(tr[1]), int(tr[2])
        self._gp_state = None
