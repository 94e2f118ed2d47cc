"""Capture-rule fixture: what a capture records, and what it may not do.

``_suggest_step`` is captured by name (``FUSED_STEP_REGISTRY``); its
positional parameters are tensors, its keyword-only ones statics.  Every
function it reaches is captured too.  ``host_side`` is reached by nothing
captured and may sync freely.  ``# expect:`` marks each finding.
"""

import numpy as np
import torch

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from orion_tpu_torch.algo import sharding
from orion_tpu_torch.algo.sharding import Mesh, get_mesh


def _score(state, candidates, *, kind):
    if kind == "matern52":  # a static: quiet
        return candidates @ state
    return candidates.sum(dim=1)


def _pick(values, candidates):
    idx = torch.argmin(values)
    first = candidates[idx]  # expect: JIT001
    kept = torch.index_select(candidates, 0, idx[None])[0]
    best = values.min()
    shifted = candidates[best + 1]  # expect: JIT001
    rows = candidates[torch.argsort(values)[:4]]
    return first, kept, shifted, rows


def _syncs(x, mask):
    a = x.cpu()  # expect: JIT001
    b = x.tolist()  # expect: JIT001
    torch.cuda.synchronize()  # expect: JIT001
    c = float(x[0])  # expect: JIT001
    d = np.asarray(x)  # expect: JIT001
    e = torch.nonzero(mask)  # expect: JIT001
    f = x.masked_select(mask > 0)  # expect: JIT001
    g = torch.unique(x)  # expect: JIT001
    h = torch.tensor([1.0, 2.0], device=x.device)  # expect: JIT001
    i = x.to("cpu")  # expect: JIT001
    j = int(x.shape[0])
    k = torch.full((), 1.0, device=x.device)
    return a, b, c, d, e, f, g, h, i, j, k


def _suggest_step(draws, x, y, mask, tr_length=None, *, q, acq, trust_region=False,
                  fixed_tail_cols=0, kind="matern52"):
    d_free = x.shape[1] - fixed_tail_cols
    if trust_region:  # a static: quiet
        x = x * 2.0
    if fixed_tail_cols:  # a static: quiet
        x = x[:, :d_free]
    if acq == "joint_thompson":  # a static: quiet
        q = q + 1
    if tr_length is None:  # a None test: quiet
        tr_length = torch.full((), 0.8, device=x.device)
    if y.shape[0] > 4 and x.ndim == 2:  # shapes: quiet
        y = y + 1.0
    if y.sum() > 0:  # expect: JIT002
        y = y - 1.0
    while mask.any():  # expect: JIT002
        mask = mask * 0.0
    assert (x >= 0).all()  # expect: JIT002
    z = y if tr_length > 0 else -y  # expect: JIT002
    scores = _score(draws, x, kind=kind)
    _syncs(x, mask)
    mesh = DeviceMesh("cuda", [0])  # expect: JIT004
    return _pick(scores, x), z, mesh, q


def host_side(x):
    """Reached by nothing captured: host reads are fine here."""
    if x.sum() > 0:
        return x.sum().item()
    return float(x[0])


def make_fused_plan(x):
    """A declared hot path, not captured: no mesh per call."""
    return init_device_mesh("cuda", (1,)), x  # expect: JIT004


def run_coalesced_plans(plans):
    """A declared hot path: the port's mesh class built per call is flagged,
    the cached constructor is quiet."""
    fresh = Mesh(["cuda:0"] * 4, ("candidates",), (4,))  # expect: JIT004
    qualified = sharding.Mesh(["cpu"] * 2, ("tenants",), (2,))  # expect: JIT004
    return fresh, qualified, get_mesh(4, device="cuda:0"), plans
