"""Helpers of the call-tree fixture, in another module."""

import torch

from capture_tree_more import rank as reexported


def fit(x, y, *, steps):
    for _ in range(steps):  # a static: quiet
        x = x - 0.1 * (x - y)
    return _finish(x)


def _finish(state):
    if state.isnan().any():  # expect: JIT002
        return torch.zeros_like(state)
    return state


def acquire(state):
    return state.max().item()  # expect: JIT001


def unreached(state):
    return state.max().item()
