"""The port's showcase scripts (``examples/torch_*.py``) through real hunts
of ``orion_tpu_torch.cli``, with the arguments and assertions of the
reference's ``tests/functional/test_examples.py``; and the torch LeNet
held to the JAX example's own functions on the same numpy parameters and
batch (atol 1e-5, float32 on both sides)."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from orion_tpu_torch.cli import main as cli_main
from orion_tpu_torch.storage.base import create_storage

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")


def _load(name):
    spec = importlib.util.spec_from_file_location(f"example_{name}",
                                                  os.path.join(EXAMPLES, f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _completed(path, name):
    storage = create_storage({"type": "pickled", "path": path})
    [exp] = storage.fetch_experiments({"name": name})
    return [
        t for t in storage.fetch_trials(uid=exp["_id"]) if t.status == "completed"
    ]


def test_torch_mnist_lenet_example_end_to_end(tmp_path):
    """Mixed Real/Integer/Categorical space, real (synthetic-data) training
    in the trial subprocess, on the CPU (``--device cpu`` for the hunt's
    algorithm and for the script)."""
    db = str(tmp_path / "db.pkl")
    rc = cli_main(
        ["hunt", "-n", "lenet-example", "--storage-path", db,
         "--max-trials", "3", "--worker-trials", "3", "--device", "cpu",
         os.path.join(EXAMPLES, "torch_mnist_lenet.py"), "--device", "cpu",
         "--lr~loguniform(1e-3, 1e-1)",
         "--batch-size~uniform(64, 256, discrete=True)",
         "--width~uniform(1, 2, discrete=True)",
         "--act~choices(['relu', 'tanh'])"]
    )
    assert rc == 0
    completed = _completed(db, "lenet-example")
    assert len(completed) == 3
    for trial in completed:
        assert 0.0 <= trial.objective.value <= 1.0  # a validation error rate
        assert trial.params["/act"] in ("relu", "tanh")
        assert trial.params["/batch-size"] == int(trial.params["/batch-size"])


def test_torch_fidelity_sweep_example_end_to_end(tmp_path):
    """Multi-fidelity ladder through ASHA: low-epoch evaluations dominate
    and at least one configuration is promoted to a higher budget."""
    db = str(tmp_path / "db.pkl")
    config = tmp_path / "conf.yaml"
    config.write_text("algorithms: {asha: {num_brackets: 2}}\n")
    rc = cli_main(
        ["hunt", "-n", "fid-example", "-c", str(config), "--storage-path", db,
         "--max-trials", "16", "--worker-trials", "16", "--device", "cpu",
         os.path.join(EXAMPLES, "torch_fidelity_sweep.py"),
         "--lr~loguniform(1e-4, 1e-1)",
         "--width~uniform(16, 256, discrete=True)",
         "--epochs~fidelity(1, 9, 3)"]
    )
    assert rc == 0
    completed = _completed(db, "fid-example")
    assert len(completed) >= 4
    epochs = sorted({t.params["/epochs"] for t in completed})
    assert set(epochs).issubset({1, 3, 9}) and len(epochs) >= 2
    by_point = {}
    for t in completed:
        by_point.setdefault((t.params["/lr"], t.params["/width"]), []).append(
            t.params["/epochs"]
        )
    assert any(len(v) > 1 for v in by_point.values())  # a real promotion


def test_fidelity_sweep_losses_equal_the_reference_example():
    ref, port = _load("fidelity_sweep"), _load("torch_fidelity_sweep")
    for lr, width, epochs in [(1e-4, 16, 1), (3e-3, 96, 3), (0.1, 256, 9)]:
        assert (port.noisy_validation_loss(lr, width, epochs)
                == ref.noisy_validation_loss(lr, width, epochs))


def _nested(module, name, **free):
    """A function defined inside the JAX example's ``train_eval``, rebuilt
    from its code object with ``free`` as its closure: the example keeps
    its forward pass, loss and step there."""
    code = next(c for c in module.train_eval.__code__.co_consts
                if isinstance(c, types.CodeType) and c.co_name == name)
    closure = tuple(types.CellType(free[var]) for var in code.co_freevars)
    return types.FunctionType(code, vars(module), name, None, closure)


@pytest.mark.parametrize("act", ["relu", "tanh", "gelu"])
@pytest.mark.parametrize("width", [1, 2])
def test_lenet_forward_and_sgd_step_match_the_jax_example(act, width):
    import jax.numpy as jnp

    ref, port = _load("mnist_lenet"), _load("torch_mnist_lenet")
    x, y = port.synthetic_mnist()
    x_ref, y_ref = ref.synthetic_mnist()
    np.testing.assert_array_equal(x, x_ref)
    np.testing.assert_array_equal(y, y_ref)
    hidden, lr = 32 * width, 0.05
    rng = np.random.default_rng(width)
    params = {
        "w1": (rng.normal(size=(784, hidden)) / 28.0).astype(np.float32),
        "b1": (0.1 * rng.normal(size=hidden)).astype(np.float32),
        "w2": (rng.normal(size=(hidden, 10)) / np.sqrt(hidden)).astype(np.float32),
        "b2": (0.1 * rng.normal(size=10)).astype(np.float32),
    }
    xb, yb = x[:128], y[:128]

    forward = _nested(ref, "forward", act=ref.ACTS[act])
    loss_fn = _nested(ref, "loss_fn", forward=forward)
    step = _nested(ref, "step", loss_fn=loss_fn, lr=lr)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    want_logits = np.asarray(forward(jparams, jnp.asarray(xb)))
    want_params = {k: np.asarray(v) for k, v in
                   step(jparams, jnp.asarray(xb), jnp.asarray(yb)).items()}

    tparams = {k: torch.from_numpy(v) for k, v in params.items()}
    txb, tyb = torch.from_numpy(xb), torch.from_numpy(yb).long()
    got_logits = port.forward(tparams, txb, port.ACTS[act]).numpy()
    got_params = port.sgd_step(tparams, txb, tyb, lr, port.ACTS[act])
    np.testing.assert_allclose(got_logits, want_logits, atol=1e-5, rtol=0)
    for name, want in want_params.items():
        np.testing.assert_allclose(got_params[name].numpy(), want, atol=1e-5, rtol=0,
                                   err_msg=name)
    # The step moved the weights, and left its input untouched.
    assert not np.array_equal(got_params["w2"].numpy(), params["w2"])
    np.testing.assert_array_equal(tparams["w2"].numpy(), params["w2"])


def test_lenet_init_draws_from_an_explicit_generator():
    port = _load("torch_mnist_lenet")
    a, b = port.init_params(2, seed=3), port.init_params(2, seed=3)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert a["w1"].shape == (784, 64) and a["w2"].shape == (64, 10)
    assert not torch.equal(a["w1"], port.init_params(2, seed=4)["w1"])


def test_lenet_example_refuses_cuda_without_a_card(monkeypatch):
    port = _load("torch_mnist_lenet")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.train_eval(0.01, 64, 1, "relu")
