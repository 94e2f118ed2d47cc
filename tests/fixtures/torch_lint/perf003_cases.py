"""PERF003 fixture: the compiler plane's cold introspection outside it.
(The file's basename is no cold module; ``# expect:`` marks each finding.)"""

import torch
from torch.utils.flop_counter import FlopCounterMode


def count_flops(fn, x):
    with FlopCounterMode(display=False) as counter:  # expect: PERF003
        fn(x)
    return counter.get_total_flops()


def pool_bytes():
    return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot())  # expect: PERF003


def raw_snapshot():
    return torch.cuda.memory._snapshot()  # expect: PERF003


def capture(fn, x):
    graph = torch.cuda.CUDAGraph()  # expect: PERF003
    graph.capture_begin()  # expect: PERF003
    fn(x)
    graph.capture_end()
    graph.debug_dump("graph.dot")  # expect: PERF003
    return graph


def replay(graph, stats):
    graph.replay()
    return stats.graph(1), torch.cuda.memory_stats()


def cold_sweep(fn, x):
    # lint: disable=PERF003 -- a deliberate sweep, run only by the profile command
    with FlopCounterMode(display=False):
        fn(x)
