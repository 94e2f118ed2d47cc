"""Capture hazards held against the card: one small function per JIT001,
JIT002 and JIT003 pattern, each beside a safe twin.

``orion-tpu-torch lint`` flags the hazards statically; ``chip_smoke.py``'s
``lint`` phase (and a ``cuda`` test) captures every case with
``torch.cuda.graph`` through :func:`card_verdict` and requires the card to
agree with the lint: a flagged JIT001/JIT002 case fails to capture, a
flagged JIT003 case captures but replays a stale value, and every safe
twin captures and replays equal to its eager run on new inputs.

``CASES``: ``(rule, name, flagged site, flagged body, safe site, safe
body)``.  A site records its body into a graph through :func:`capture`
(the capture helper the lint resolves); a body takes ``(x, factor)``, a
1-d float32 tensor and a 0-d one.  The ``# expect:`` annotations are the
lint's findings line by line (tests hold both directions).
"""

import torch


def capture(graph, pool, fn, *args):
    """Record ``fn(*args)`` into ``graph`` (allocating from ``pool``)."""
    with torch.cuda.graph(graph, pool=pool):  # expect: PERF003
        return fn(*args)


# --- JIT001: a host read ------------------------------------------------------
def scaled_by_item(x, factor):
    return x * x.sum().item()  # expect: JIT001


def scaled_by_size(x, factor):
    return x * x.shape[0]


def capture_scaled_by_item(graph, pool, x, factor):
    return capture(graph, pool, scaled_by_item, x, factor)


def capture_scaled_by_size(graph, pool, x, factor):
    return capture(graph, pool, scaled_by_size, x, factor)


# --- JIT001: indexing by a 0-d tensor -----------------------------------------
def pick_argmax(x, factor):
    best = torch.argmax(x)
    return x[best] * factor  # expect: JIT001


def pick_argmax_index_select(x, factor):
    best = torch.argmax(x)
    return torch.index_select(x, 0, best[None])[0] * factor


def capture_pick_argmax(graph, pool, x, factor):
    return capture(graph, pool, pick_argmax, x, factor)


def capture_pick_argmax_index_select(graph, pool, x, factor):
    return capture(graph, pool, pick_argmax_index_select, x, factor)


# --- JIT002: a branch on a tensor value ---------------------------------------
def doubled_if_positive(x, factor):
    if x.sum() > 0:  # expect: JIT002
        return x * 2.0
    return x


def doubled_if_wide(x, factor):
    if x.shape[0] > 4:
        return x * 2.0
    return x


def capture_doubled_if_positive(graph, pool, x, factor):
    return capture(graph, pool, doubled_if_positive, x, factor)


def capture_doubled_if_wide(graph, pool, x, factor):
    return capture(graph, pool, doubled_if_wide, x, factor)


# --- JIT003: a Python number in a tensor slot ---------------------------------
def scaled(x, factor):
    return x * factor


def capture_scaled_by_number(graph, pool, x, factor):
    return capture(graph, pool, scaled, x, 2.0)  # expect: JIT003


def capture_scaled_by_tensor(graph, pool, x, factor):
    return capture(graph, pool, scaled, x, factor)


CASES = [
    ("JIT001", "host read", capture_scaled_by_item, scaled_by_item,
     capture_scaled_by_size, scaled_by_size),
    ("JIT001", "0-d index", capture_pick_argmax, pick_argmax,
     capture_pick_argmax_index_select, pick_argmax_index_select),
    ("JIT002", "tensor branch", capture_doubled_if_positive, doubled_if_positive,
     capture_doubled_if_wide, doubled_if_wide),
    ("JIT003", "python number", capture_scaled_by_number, scaled,
     capture_scaled_by_tensor, scaled),
]


def card_verdict(site, body, device, n=64, seed=0):
    """``(captured, fresh)`` of one site on the card: whether its capture
    succeeded, and whether the replay after new inputs (another ``x``,
    ``factor`` 3.0 in place of 2.0) equals ``body`` run eagerly on them.
    A failed capture's pool is released from the allocator's routing."""
    gen = torch.Generator(device=device).manual_seed(seed)
    x = torch.rand(n, generator=gen, device=device) - 0.25
    factor = torch.full((), 2.0, device=device)
    body(x, factor)  # eager warm-up on the capture's inputs
    torch.cuda.synchronize(device)
    graph = torch.cuda.CUDAGraph()  # expect: PERF003
    pool = torch.cuda.graph_pool_handle()
    try:
        out = site(graph, pool, x, factor)
    except RuntimeError:
        try:
            torch._C._cuda_endAllocateToPool(torch.device(device).index or 0, pool)
        except RuntimeError:  # the failed capture already ended it
            pass
        torch.cuda.synchronize(device)
        return False, False
    x.copy_(torch.rand(n, generator=gen, device=device) - 0.25)
    factor.fill_(3.0)
    graph.replay()
    want = body(x, factor)
    torch.cuda.synchronize(device)
    return True, bool(torch.equal(out, want))
