"""Capture-site fixture: what a capture site hands a captured function.

``STEP_GRAPHS.run``/``.prewarm`` capture their ``fn``; a call inside a
``torch.cuda.graph`` block is captured; a capture helper's argument is
captured at each of its call sites.  ``# expect:`` marks each finding.
"""

import torch

from orion_tpu_torch.algo.step_graphs import STEP_GRAPHS


def step(x, tr, *, q):
    return x * tr + q


def helper_body(x, scale):
    return x * scale.item()  # expect: JIT001


def graph_body(x, scale):
    return x[torch.argmax(scale)]  # expect: JIT001


def run_round(x, tr_length, signature, q):
    tr = torch.full((), float(tr_length), device=x.device)
    arrays = (x, tr)
    statics = {"q": q}
    return STEP_GRAPHS.run(step, signature, arrays, statics)


def run_round_stale(x, tr_length, signature, q):
    tr = float(tr_length)
    return STEP_GRAPHS.run(step, signature, (x, tr), {"q": q})  # expect: JIT003


def prewarm_forked(x, tr_length, signature):
    arrays = (x, torch.full((), 0.5, device=x.device))
    statics = dict(q=tr_length.item())  # expect: JIT003
    return STEP_GRAPHS.prewarm(step, signature, arrays, statics)


def record(graph, fn, *args):
    with torch.cuda.graph(graph):  # expect: PERF003
        return fn(*args)


def record_twice(graph, fn, x):
    return record(graph, fn, x, x)


def capture_sites(x, scale):
    graph = torch.cuda.CUDAGraph()  # expect: PERF003
    record(graph, helper_body, x, scale)
    record(graph, helper_body, x, 0.5)  # expect: JIT003
    record_twice(graph, graph_body, x)
    with torch.cuda.graph(graph):  # expect: PERF003
        graph_body(x, 3)  # expect: JIT003
        graph_body(x, scale)
    return graph
