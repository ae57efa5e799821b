"""Port parity for the paper's two examples: a few AdamW steps of
``repro_torch.examples.train_mnist_swm.train_one`` and
``repro_torch.examples.lstm_asr.train_one`` from JAX-initialised params,
their per-step losses against the same steps of the reference examples
(``examples/train_mnist_swm.py`` and ``examples/lstm_asr.py``: model,
data, loss and AdamW schedule copied from them here, since their
``train_one`` returns no losses).

Tolerances: both sides are f32 and sum in other orders (XLA vs ATen, the
JAX ``freq`` impl vs the port's kernel-path plain version), so a loss
agrees to ~1e-6 relative; after AdamW steps the params carry those
differences forward. ``quant_bits=12`` rounds every activation and weight
to a 1/256 grid, where a 1e-7 difference can move one value by a whole
quantum, so the MLP's losses are held to 1e-4 relative, the LSTM's (no
quantisation, 24 steps of recurrence) to 2e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import TrainConfig
from repro.data.pipeline import synthetic_images, synthetic_speech
from repro.models.paper_models import SWMLSTMASR, SWMMLP
from repro.nn.module import init_params, param_count
from repro.optim.optimizers import adamw_init, adamw_update
from repro_torch import convert
from repro_torch.examples import lstm_asr, train_mnist_swm
from test_torch_decoder_family import fast_jit
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

STEPS = 3
MLP_TOL = 1e-4
LSTM_TOL = 2e-5


def _reference_losses(model, tcfg, batch, steps):
    """The reference examples' jitted AdamW step, its losses per step."""
    params = fast_jit(lambda: init_params(model.specs(), 0))()
    opt = adamw_init(params, tcfg)

    @fast_jit
    def step(params, opt, i, x, y):
        def loss(p):
            lp = jax.nn.log_softmax(model(p, x))
            return -jnp.take_along_axis(lp, y[..., None], -1).mean()
        l, g = jax.value_and_grad(loss)(params)
        params, opt = adamw_update(params, g, opt, i, tcfg)
        return params, opt, l

    first = jax.tree.map(np.asarray, params)
    losses = []
    for i in range(steps):
        x, y = batch(i)
        params, opt, l = step(params, opt, jnp.asarray(i), jnp.asarray(x),
                              jnp.asarray(y))
        losses.append(float(l))
    return first, losses


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b) / np.abs(b)))


@pytest.mark.parametrize("k", [8])
def test_mnist_example_matches_reference(k):
    model = SWMMLP(dims=(784, 256, 256, 10), block_size=k,
                   quant_bits=12 if k else 0)
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=10,
                       total_steps=STEPS, weight_decay=0.0)

    def batch(i):
        x, y = synthetic_images(128, i)
        return x.reshape(128, -1), y

    params, ref = _reference_losses(model, tcfg, batch, STEPS)
    acc, n, losses = train_mnist_swm.train_one(
        k, STEPS, device="cpu", params=convert.tree_from_reference(
            params, device="cpu"))
    assert n == param_count(model.specs())
    assert 0.0 <= acc <= 1.0
    assert _rel(losses, ref) <= MLP_TOL, (losses, ref)


def test_lstm_example_matches_reference():
    model = SWMLSTMASR(d_cell=256, d_proj=128, block_size=8)
    tcfg = TrainConfig(learning_rate=8e-3, warmup_steps=10,
                       total_steps=STEPS, weight_decay=0.0)
    params, ref = _reference_losses(
        model, tcfg, lambda i: synthetic_speech(16, 24, 153, i), STEPS)
    acc, n, losses = lstm_asr.train_one(
        8, STEPS, device="cpu", params=convert.tree_from_reference(
            params, device="cpu"))
    assert n == param_count(model.specs())
    assert 0.0 <= acc <= 1.0
    assert _rel(losses, ref) <= LSTM_TOL, (losses, ref)


def test_examples_run_from_their_command_lines(capsys):
    rows = train_mnist_swm.main(["--device", "cpu", "--steps", "2",
                                 "--block-sizes", "16"])
    assert [r[0] for r in rows] == [16]
    assert "reduction" in capsys.readouterr().out
