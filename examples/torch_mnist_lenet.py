#!/usr/bin/env python
"""Mixed Real/Integer/Categorical tuning example on the PyTorch port.

The counterpart of ``examples/mnist_lenet.py`` for ``orion_tpu_torch``:
it tunes a LeNet-style classifier over learning rate (real, log scale),
batch size (integer), width multiplier (integer) and activation
(categorical).  The model is the same small MLP-conv hybrid, trained by
plain SGD on the same synthetic MNIST-shaped data (the same numpy seed),
written in torch with explicit generators.  It trains on ``--device``,
``cuda`` unless told otherwise, and fails where no card is present rather
than falling back to the CPU.

Run under the framework:

    orion-tpu-torch hunt -n lenet --storage-path db.pkl --max-trials 20 \\
        examples/torch_mnist_lenet.py \\
        --lr~'loguniform(1e-4, 1e-1)' \\
        --batch-size~'uniform(32, 256, discrete=True)' \\
        --width~'uniform(1, 4, discrete=True)' \\
        --act~"choices(['relu', 'tanh', 'gelu'])"

Add ``--device cpu`` after the script's path to train on the CPU.
"""

import argparse
import math

import numpy as np
import torch
import torch.nn.functional as F

from orion_tpu_torch.client import report_objective
from orion_tpu_torch.device import resolve_device

# jax.nn.gelu's default is the tanh approximation.
ACTS = {"relu": torch.relu, "tanh": torch.tanh,
        "gelu": lambda x: F.gelu(x, approximate="tanh")}


def synthetic_mnist(n=2048, seed=0):
    """Deterministic MNIST-shaped stand-in (28x28 images, 10 classes)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, 28 * 28)).astype(np.float32)
    w_true = rng.normal(size=(28 * 28, 10)).astype(np.float32)
    y = np.argmax(x @ w_true + 0.5 * rng.normal(size=(n, 10)), axis=1)
    return x, y.astype(np.int32)


def init_params(width, seed=0, device="cpu"):
    """The model's weights: normal draws from a generator seeded ``seed``
    on ``device``, scaled as the JAX example scales its own."""
    hidden = 32 * width
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    return {
        "w1": torch.randn((784, hidden), generator=gen, device=device) * (1.0 / 28.0),
        "b1": torch.zeros(hidden, device=device),
        "w2": torch.randn((hidden, 10), generator=gen, device=device) / math.sqrt(hidden),
        "b2": torch.zeros(10, device=device),
    }


def forward(params, xb, act):
    h = act(xb @ params["w1"] + params["b1"])
    return h @ params["w2"] + params["b2"]


def loss_fn(params, xb, yb, act):
    logp = torch.log_softmax(forward(params, xb, act), dim=1)
    return -logp[torch.arange(len(yb), device=yb.device), yb].mean()


def sgd_step(params, xb, yb, lr, act):
    """One plain SGD step: new parameters, the old ones untouched."""
    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
    grads = torch.autograd.grad(loss_fn(leaves, xb, yb, act), list(leaves.values()))
    with torch.no_grad():
        return {k: v - lr * g for (k, v), g in zip(leaves.items(), grads)}


def train_eval(lr, batch_size, width, act_name, epochs=3, seed=0, device="cuda"):
    device = resolve_device(device)
    x, y = synthetic_mnist()
    n_train = len(x) * 3 // 4
    act = ACTS[act_name]
    params = init_params(width, seed, device)
    xs = torch.from_numpy(x).to(device)
    ys = torch.from_numpy(y).long().to(device)
    for _epoch in range(epochs):
        for i in range(0, n_train, batch_size):
            end = min(i + batch_size, n_train)
            params = sgd_step(params, xs[i:end], ys[i:end], lr, act)
    with torch.no_grad():
        logits = forward(params, xs[n_train:], act)
        acc = float((logits.argmax(dim=1) == ys[n_train:]).float().mean())
    return 1.0 - acc  # minimize validation error


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--lr", type=float, required=True)
    parser.add_argument("--batch-size", type=int, required=True)
    parser.add_argument("--width", type=int, required=True)
    parser.add_argument("--act", required=True)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args()
    error = train_eval(args.lr, args.batch_size, args.width, args.act, device=args.device)
    report_objective(error)


if __name__ == "__main__":
    main()
