"""The port's CUDA kernels on the card (marked ``cuda``; they skip without
one).  This file imports no JAX, so the machine with the card, which has
none, runs it without the suite's conftest:

    python3 -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import pytest
import torch

from orion_tpu_torch.ops import gram
from orion_tpu_torch.ops.gram import fused_gram, fused_gram_reference


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import orion_tpu_torch.device  # noqa: F401  (TF32 off)

    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["matern52", "rbf"])
@pytest.mark.parametrize("m,n,d", [(16384, 256, 6), (300, 70, 6), (513, 129, 130)])
def test_fused_gram_kernel_matches_plain_version(cuda, kind, m, n, d):
    """The sm_90a kernel against its plain version (atol 1e-5 * amplitude,
    as chip_smoke.py), with one launch counted."""
    gen = torch.Generator(device=cuda).manual_seed(0)
    xa = torch.rand((m, d), generator=gen, device=cuda)
    xb = torch.rand((n, d), generator=gen, device=cuda)
    ils = 0.5 + 2.5 * torch.rand((d,), generator=gen, device=cuda)
    amp = torch.tensor(1.7, device=cuda)
    before = gram.fused_gram.launches
    got = fused_gram(xa, xb, ils, amp, kind=kind)
    assert gram.fused_gram.launches == before + 1
    want = fused_gram_reference(xa, xb, ils, amp, kind=kind)
    torch.cuda.synchronize()
    assert float((got - want).abs().max()) <= 1e-5 * 1.7


@pytest.mark.cuda
def test_fused_gram_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.rand((8, 3), device=cuda)
    with pytest.raises(TypeError):
        fused_gram(x.double(), x.double(), torch.ones(3, device=cuda).double(),
                   torch.tensor(1.0, device=cuda).double())
    with pytest.raises(ValueError, match="devices"):
        fused_gram(x, x.cpu(), torch.ones(3, device=cuda), torch.tensor(1.0, device=cuda))
