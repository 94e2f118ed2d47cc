"""Plain-path-against-kernel micro-benchmark of ``fused_gram`` (port of
``orion_tpu/benchmarks/gram_bench.py``).

:func:`orion_tpu_torch.ops.gram.fused_gram` is meant to beat the plain
PyTorch path (:func:`orion_tpu_torch.algo.gp.kernels.kernel_matrix`: a
matmul and an elementwise epilogue over the (m, n) intermediate) once that
intermediate is large; this bench measures both on the card, so the
``_FUSED_MIN_WORK`` crossover in ``algo/gp/kernels.py`` rests on data.
Run::

    python -m orion_tpu_torch.benchmarks.runner --op gram [--kind rbf]

One JSON line per shape, numerical parity first.  On the card each time is
the median CUDA-event ms of one call inside a CUDA graph of back-to-back
calls (:func:`graph_ms`): no host launch cost and no dispatch cost to
subtract, so the reference's two-chain-length subtraction has nothing to
cancel here.  On a CUDA tensor the kernel launches or the bench raises:
no column is skipped and nothing falls back.  On the CPU (only where the
caller names it) the times are the median ``perf_counter`` ms of one call
of each path (the kernel's path there is its plain version), and the row's
``backend`` says ``cpu``; ``bound_share`` is then None, since the bound
is the card's.

This module also holds the timing harness and the card's bound that
``chip_smoke.py``'s kernel checks use, so the two time the kernel alike.

Row keys, against the reference's:

==================  ==================================================
reference           port
==================  ==================================================
``xla_ms``          ``plain_ms`` (``kernel_matrix``)
``pallas_ms``       ``kernel_ms`` (``fused_gram``)
``speedup``         ``speedup`` (``plain_ms / kernel_ms``)
``max_abs_err``     ``max_abs_err`` (kernel against the plain path)
``backend``         ``backend`` (``cuda`` or ``cpu``)
``note``            (none: nothing is skipped)
(none)              ``device`` (the card's name), ``bound_ms``,
                    ``bound_by``, ``bound_share`` (``bound_ms /
                    kernel_ms``)
==================  ==================================================
"""

import json
import statistics
import time

import numpy as np
import torch

from orion_tpu_torch.algo.gp.kernels import kernel_matrix
from orion_tpu_torch.device import resolve_device
from orion_tpu_torch.ops.gram import fused_gram

#: H100 SXM published peaks (NVIDIA's H100 data sheet, dense rates): HBM3
#: bandwidth, and the float32 rate outside the tensor cores (the port runs
#: float32 with TF32 off, ``orion_tpu_torch/device.py``).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

SHAPES = [
    # (m candidates, n observations, d dims)
    (4096, 256, 8),
    (8192, 256, 8),
    (8192, 1024, 8),
    (8192, 1024, 50),
    (16384, 256, 50),
    (16384, 1024, 50),
    (16384, 1024, 128),
]


def graph_ms(fn, calls=20, reps=15):
    """Median device ms of one ``fn()`` call: ``calls`` calls captured in a
    CUDA graph (no host launch overhead), each output kept alive so every
    call writes fresh memory (no L2 reuse), timed by CUDA events over
    ``reps`` replays after a warm-up."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    # lint: disable=PERF003 -- the benches' timing harness captures the
    # timed calls to time them without launch overhead; no round runs it.
    graph = torch.cuda.CUDAGraph()
    keep = []
    # lint: disable=PERF003 -- the same timing harness's capture.
    with torch.cuda.graph(graph):
        for _ in range(calls):
            keep.append(fn())
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    del graph, keep
    return statistics.median(times)


def eager_ms(fn, reps=30):
    """Median CUDA-event ms of one eager call (host launch cost included)."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps=8):
    """Median ``perf_counter`` ms of one call (the CPU's reading)."""
    fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def gram_bytes(m, n, d):
    """Bytes ``fused_gram`` must move: each input read once, the output
    written once."""
    return 4 * (m * d + n * d + d + 1 + m * n)


def gram_bound(m, n, d):
    """Least time for ``fused_gram`` on an H100: its bytes at 3.35 TB/s,
    against its float32 operations (2d for the cross term, 2 per norm, ~20
    for the epilogue) at 67 TFLOP/s.  Returns ``(ms, "bytes" or
    "operations")``."""
    nbytes = gram_bytes(m, n, d)
    flops = m * n * (2 * d + 4 + 20)
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, flops / PEAK_F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def run_gram_bench(kind="matern52", reps=8, device=None, shapes=None):
    """Both paths at each of ``shapes`` (default :data:`SHAPES`) on
    ``device`` (``None`` means ``cuda``); the inputs are the reference's
    numpy draws (seed 0, the unused ``v`` included, so each shape sees the
    reference's inputs).  Prints and returns one row a shape."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    name = torch.cuda.get_device_name(dev) if on_card else "cpu"
    rng = np.random.default_rng(0)
    rows = []
    for m, n, d in SHAPES if shapes is None else shapes:
        xa = torch.as_tensor(rng.uniform(size=(m, d)), dtype=torch.float32, device=dev)
        xb = torch.as_tensor(rng.uniform(size=(n, d)), dtype=torch.float32, device=dev)
        rng.normal(size=(n,))  # the reference's chain vector, drawn to keep its stream
        inv_ls = torch.full((d,), 2.0, dtype=torch.float32, device=dev)
        amp = torch.full((), 1.0, dtype=torch.float32, device=dev)

        def plain():
            return kernel_matrix(kind, xa, xb, inv_ls, amp)

        def kernel():
            return fused_gram(xa, xb, inv_ls, amp, kind=kind)

        # Numerical parity first: a fast wrong kernel is worthless.
        err = float((kernel() - plain()).abs().max())
        timer = graph_ms if on_card else host_ms
        plain_ms, kernel_ms = timer(plain, reps=reps), timer(kernel, reps=reps)
        bound_ms, bound_by = gram_bound(m, n, d)
        row = {
            "op": "gram", "kind": kind, "m": m, "n": n, "d": d,
            "backend": dev.type, "device": name,
            "plain_ms": plain_ms, "kernel_ms": kernel_ms,
            "speedup": plain_ms / kernel_ms, "max_abs_err": err,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / kernel_ms if on_card else None,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    return rows
