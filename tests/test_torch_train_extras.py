"""Port parity for two training extras: the refusal of a batch that
``microbatch`` does not divide (both packages refuse it; the port with a
``ValueError`` naming the batch and the slice count, its launcher letting
it through), and the torch quickstart (``repro_torch.examples.quickstart``,
the ``dft`` impl with ``count_params``) against the reference's
``examples/quickstart.py`` model, schedule and data on the same
JAX-initialised params.

Tolerance: the quickstart is f32 on both sides, summed in other orders
(XLA vs ATen) through 4 layers, the loss and AdamW, so each step's loss
agrees to ``LOSS_TOL`` as the train-step parity tests hold it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jq
from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.base import SWMConfig as JSWM
from repro.configs.base import TrainConfig as JTrain
from repro.launch.specs import count_params as jcount_params
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.examples import quickstart
from repro_torch.launch import train as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.train.loop import init_train_state, make_train_step
from test_torch_decoder_family import fast_jit
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

LOSS_TOL = 1e-5
STEPS = 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


# ---------------------------------------------------------------------------
# Uneven microbatches
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    swm = dict(block_size=8, impl="paper")
    jcfg = dataclasses.replace(jq.SMOKE, swm=JSWM(**swm))
    tcfg = dataclasses.replace(tq.SMOKE, swm=TSWM(**swm))
    jm = JLM(jcfg)
    jparams = fast_jit(lambda: jinit(jm.specs(), 0))()
    return jcfg, tcfg, jm, jparams


def _tokens(B):
    return SyntheticLM(vocab=tq.SMOKE.vocab, seq_len=16,
                       batch=B).batch_np(0)["tokens"]


@pytest.mark.parametrize("B", [10, 6])
def test_uneven_microbatch_is_refused_by_both(smoke, B):
    jcfg, tcfg, jm, jparams = smoke
    jtc = JTrain(microbatch=4)
    jstep = jax.jit(jmake_step(jm, jcfg, jtc))
    with pytest.raises(TypeError, match="reshape"):
        jstep(jinit_state(jparams, jtc), {"tokens": jnp.asarray(_tokens(B))})
    ttc = TTrain(microbatch=4)
    state = init_train_state(
        convert.from_reference(tcfg, jax.tree.map(np.asarray, jparams),
                               device="cpu"), ttc)
    step = make_train_step(build_model(tcfg, device="cpu"), tcfg, ttc)
    before = [t.clone() for t in jax.tree.leaves(state["params"])]
    with pytest.raises(ValueError, match=rf"batch {B} .*microbatch=4"):
        step(state, {"tokens": torch.from_numpy(_tokens(B))})
    assert state["step"] == 0
    assert all(torch.equal(a, b) for a, b in
               zip(before, jax.tree.leaves(state["params"])))


def test_launcher_lets_the_refusal_through():
    with pytest.raises(ValueError, match="batch 10 .*microbatch=4"):
        tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                      "--seq", "8", "--batch", "10", "--microbatch", "4",
                      "--device", "cpu"])


# ---------------------------------------------------------------------------
# The quickstart
# ---------------------------------------------------------------------------

# the reference's examples/quickstart.py config and train settings
JCONFIG = JModelConfig(
    name="quickstart-swm-lm",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab=512,
    swm=JSWM(block_size=16, impl="dft"),
    remat="none", param_dtype="float32", compute_dtype="float32",
)


def test_quickstart_config_and_counts_are_the_reference_s():
    for f in dataclasses.fields(JCONFIG):
        got, ref = getattr(quickstart.CONFIG, f.name), getattr(JCONFIG,
                                                               f.name)
        if f.name == "swm":
            assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        elif f.name not in ("param_dtype", "compute_dtype", "norm_dtype"):
            assert got == ref, f.name
        else:
            assert str(got) == str(ref), f.name
    assert quickstart.count_params(quickstart.CONFIG) == jcount_params(
        JCONFIG)


def test_quickstart_losses_match_reference(capsys):
    tcfg = JTrain(learning_rate=3e-3, warmup_steps=20, total_steps=STEPS,
                  z_loss=0.0)
    jm = JLM(JCONFIG)
    jparams = fast_jit(lambda: jinit(jm.specs(), 0))()
    step = fast_jit(jmake_step(jm, JCONFIG, tcfg))
    state = jinit_state(jparams, tcfg)
    data = SyntheticLM(vocab=JCONFIG.vocab, seq_len=quickstart.SEQ,
                       batch=quickstart.BATCH)
    ref = []
    for s in range(STEPS):
        state, m = step(state, {"tokens": jnp.asarray(
            data.batch_np(s)["tokens"])})
        ref.append(float(m["loss"]))
    counts, losses = quickstart.run(
        STEPS, device="cpu",
        params=convert.from_reference(quickstart.CONFIG,
                                      jax.tree.map(np.asarray, jparams),
                                      device="cpu"))
    assert counts["compression"] > 1
    for a, b in zip(losses, ref):
        assert _rel(a, b) <= LOSS_TOL
    out = capsys.readouterr().out
    assert out.splitlines()[0].startswith(f"params: {counts['stored']:,}")


def test_quickstart_main_runs_on_cpu(capsys):
    counts, losses = quickstart.main(["--device", "cpu", "--steps", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    lines = capsys.readouterr().out.splitlines()
    assert [l.split()[1] for l in lines if l.startswith("step")] == ["0",
                                                                     "1"]
    assert lines[-1].startswith("done")
