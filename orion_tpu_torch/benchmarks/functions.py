"""Analytic black-box functions as batched tensor ops: (n, d) -> (n,).

Port of ``orion_tpu/benchmarks/functions.py``: Branin 2D, Hartmann6,
Rosenbrock-nD, Ackley-nD.  Each takes points in the **unit cube** and
scales them to its canonical domain, as the algorithms see the space.
"""

import math

import torch

_H6_ALPHA = [1.0, 1.2, 3.0, 3.2]
_H6_A = [
    [10, 3, 17, 3.5, 1.7, 8],
    [0.05, 10, 17, 0.1, 8, 14],
    [3, 3.5, 1.7, 10, 17, 8],
    [17, 8, 0.05, 10, 0.1, 14],
]
_H6_P = [
    [1312, 1696, 5569, 124, 8283, 5886],
    [2329, 4135, 8307, 3736, 1004, 9991],
    [2348, 1451, 3522, 2883, 3047, 6650],
    [4047, 8828, 8732, 5743, 1091, 381],
]


def branin(u):
    """Branin-Hoo on [-5, 10] x [0, 15]; global min 0.397887."""
    x = -5.0 + u[:, 0] * 15.0
    y = u[:, 1] * 15.0
    a, b, c = 1.0, 5.1 / (4 * math.pi**2), 5.0 / math.pi
    r, s, t = 6.0, 10.0, 1.0 / (8 * math.pi)
    return a * (y - b * x**2 + c * x - r) ** 2 + s * (1 - t) * torch.cos(x) + s


def hartmann6(u):
    """Hartmann-6 on [0,1]^6; global min -3.32237."""
    alpha = torch.tensor(_H6_ALPHA, dtype=u.dtype, device=u.device)
    a = torch.tensor(_H6_A, dtype=u.dtype, device=u.device)
    p = 1e-4 * torch.tensor(_H6_P, dtype=u.dtype, device=u.device)
    diff = u[:, None, :] - p[None, :, :]
    inner = torch.sum(a[None, :, :] * diff**2, dim=-1)
    return -torch.sum(alpha[None, :] * torch.exp(-inner), dim=-1)


def rosenbrock(u, low=-5.0, high=10.0):
    """Rosenbrock-nD; global min 0 at x=1."""
    x = low + u * (high - low)
    return torch.sum(
        100.0 * (x[:, 1:] - x[:, :-1] ** 2) ** 2 + (1.0 - x[:, :-1]) ** 2, dim=1
    )


def ackley(u, low=-32.768, high=32.768):
    """Ackley-nD; global min 0 at origin."""
    x = low + u * (high - low)
    d = x.shape[1]
    term1 = -20.0 * torch.exp(-0.2 * torch.sqrt(torch.sum(x**2, dim=1) / d))
    term2 = -torch.exp(torch.sum(torch.cos(2 * math.pi * x), dim=1) / d)
    return term1 + term2 + 20.0 + math.e


BENCHMARKS = {
    "branin": {"fn": branin, "dims": 2, "optimum": 0.397887},
    "hartmann6": {"fn": hartmann6, "dims": 6, "optimum": -3.32237},
    "rosenbrock20": {"fn": rosenbrock, "dims": 20, "optimum": 0.0},
    "ackley50": {"fn": ackley, "dims": 50, "optimum": 0.0},
}
