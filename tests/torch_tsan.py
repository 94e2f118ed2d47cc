"""The ``torch_tsan`` pytest marker's fixture: a test marked
``@pytest.mark.torch_tsan`` runs under the port's runtime concurrency
sanitizer (``orion_tpu_torch.analysis.sanitizer``: instrumented lock and
event shims, vector-clock race detection, the seeded interleaving
explorer) and FAILS if the run observed any data race or lock-order cycle.

The suite's own ``tsan`` marker (``tests/conftest.py``) enables the
reference's sanitizer; both patch ``threading.Lock``, so the two are never
enabled at once in one process and port tests use this marker only.  A
test module opts in by importing the fixture::

    from torch_tsan import torch_tsan_marked  # noqa: F401

Marked tests must not enable or disable the sanitizer themselves (the
fixture owns it); tests that exercise the sanitizer's own machinery stay
unmarked.  The marker's ``seed`` keyword pins the explorer's seed.
"""

import sys

import pytest


@pytest.fixture(autouse=True)
def torch_tsan_marked(request):
    marker = request.node.get_closest_marker("torch_tsan")
    if marker is None:
        yield
        return
    from orion_tpu_torch.analysis.sanitizer import TSAN

    if TSAN.enabled:
        # The whole process is already instrumented (`orion-tpu-torch tsan
        # -- pytest ...`): the outer owner collects and reports at exit.
        yield
        return
    reference = sys.modules.get("orion_tpu.analysis.sanitizer")
    assert reference is None or not reference.TSAN.enabled, (
        "the reference's sanitizer is on: never enable both")
    TSAN.enable(seed=int(marker.kwargs.get("seed", 0)))
    try:
        yield
    finally:
        report = TSAN.disable()
    assert report.violation_count() == 0, (
        "tsan violations in a torch_tsan-marked test:\n" + report.format_human()
    )
