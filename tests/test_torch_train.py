"""Port parity: training (repro_torch.train, optim, data, launch.train)
against the JAX reference on the same numpy inputs and JAX-initialized
params: losses and optimizers on one numpy tree, the synthetic data
streams, and 3 steps of ``make_train_step`` on the qwen3 smoke config
(f32) with the kernel impl — the reference's Pallas kernels in interpret
mode, the port's kernels' plain versions on the CPU."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jq
from repro.configs.base import SWMConfig as JSWM
from repro.configs.base import TrainConfig as JTrain
from repro.data import pipeline as jdata
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro.optim import optimizers as jopt
from repro.train import losses as jlosses
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.data import pipeline as tdata
from repro_torch.launch import train as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import tree_leaves
from repro_torch.optim import optimizers as topt
from repro_torch.train import losses as tlosses
from repro_torch.train.loop import (init_train_state, make_grad_step,
                                    make_loss_fn, make_train_step,
                                    value_and_grad)
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # fp32 vs fp32 (tests/test_conformance.py REL_TOL)
# 3 train steps of the f32 smoke model: both sides sum in other orders
# (kernel vs plain version, XLA vs ATen reductions) through 3 layers, the
# loss and its backward
LOSS_TOL = 1e-5
LEAF_TOL = 1e-4
SEQ, BATCH = 16, 4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# ---------------------------------------------------------------------------
# Losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk,z_loss,masked", [(4, 0.0, False),
                                                 (5, 1e-4, True),
                                                 (512, 1e-4, False)])
def test_chunked_cross_entropy_and_grads_match_reference(chunk, z_loss,
                                                         masked):
    B, S, D, V = 2, 11, 8, 32          # S not a multiple of the chunk
    h, table = _rand((B, S, D), 1), _rand((V, D), 2)
    labels = np.random.default_rng(3).integers(0, V, (B, S)).astype(np.int32)
    mask = (np.random.default_rng(4).random((B, S)) < 0.7).astype(
        np.float32) if masked else None

    def fj(h, t):
        return jlosses.chunked_cross_entropy(
            h, t, jnp.asarray(labels),
            None if mask is None else jnp.asarray(mask), z_loss=z_loss,
            chunk=chunk)[0]

    lj, gj = jax.value_and_grad(fj, argnums=(0, 1))(jnp.asarray(h),
                                                   jnp.asarray(table))
    ht, tt = _t(h, True), _t(table, True)
    lt, metrics = tlosses.chunked_cross_entropy(
        ht, tt, torch.from_numpy(labels),
        None if mask is None else torch.from_numpy(mask), z_loss=z_loss,
        chunk=chunk)
    gt = torch.autograd.grad(lt, [ht, tt])
    assert _rel(lt.detach(), lj) <= LOSS_TOL
    assert float(metrics["tokens"]) == (B * S if mask is None
                                        else max(mask.sum(), 1.0))
    for a, b in zip(gt, gj):
        assert _rel(a, b) <= REL_TOL


def test_softmax_cross_entropy_matches_reference():
    logits = _rand((3, 5, 17), 5)
    labels = np.random.default_rng(6).integers(0, 17, (3, 5)).astype(
        np.int32)
    mask = (np.arange(15).reshape(3, 5) % 3 != 0).astype(np.float32)
    lj, mj = jlosses.softmax_cross_entropy(jnp.asarray(logits),
                                           jnp.asarray(labels),
                                           jnp.asarray(mask), z_loss=1e-3)
    lt, mt = tlosses.softmax_cross_entropy(_t(logits),
                                           torch.from_numpy(labels),
                                           _t(mask), z_loss=1e-3)
    assert _rel(lt, lj) <= LOSS_TOL
    assert float(mt["tokens"]) == float(mj["tokens"])


# ---------------------------------------------------------------------------
# Optimizers on one numpy tree
# ---------------------------------------------------------------------------


def _tree(seed):
    return {"blk": {"w": _rand((3, 4, 5), seed), "b": _rand((7,), seed + 1)},
            "emb": {"table": _rand((6, 4), seed + 2)}}


def _jtree(tree):
    return jax.tree.map(jnp.asarray, tree)


def _ttree(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _assert_trees_close(got, ref, tol):
    for a, b in zip(tree_leaves(got), jax.tree.leaves(ref)):
        assert _rel(a, b) <= tol


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_optimizer_steps_match_reference(opt):
    tcfg = TTrain(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    jcfg = JTrain(learning_rate=1e-2, warmup_steps=2, total_steps=10)
    params = _tree(0)
    jp, tp = _jtree(params), _ttree(params)
    jinit_o = jopt.adafactor_init if opt == "adafactor" else jopt.adamw_init
    tinit_o = topt.adafactor_init if opt == "adafactor" else topt.adamw_init
    jo, to = jinit_o(jp, jcfg), tinit_o(tp, tcfg)
    for step in range(4):
        grads = _tree(10 + step)
        jg, gnorm_j = jopt.clip_by_global_norm(_jtree(grads), 1.0)
        tg, gnorm_t = topt.clip_by_global_norm(_ttree(grads), 1.0)
        assert _rel(gnorm_t, gnorm_j) <= REL_TOL
        assert _rel(topt.global_norm(tg), jopt.global_norm(jg)) <= REL_TOL
        jupd = jopt.adafactor_update if opt == "adafactor" \
            else jopt.adamw_update
        tupd = topt.adafactor_update if opt == "adafactor" \
            else topt.adamw_update
        jp, jo = jupd(jp, jg, jo, jnp.asarray(step, jnp.int32), jcfg)
        tp, to = tupd(tp, tg, to, step, tcfg)
        _assert_trees_close(tp, jp, REL_TOL)
        _assert_trees_close(to, jo, REL_TOL)
    for step in (0, 1, 2, 5, 10, 20):
        assert float(topt.lr_schedule(tcfg, step)) == pytest.approx(
            float(jopt.lr_schedule(jcfg, jnp.asarray(step))), rel=1e-6)


# ---------------------------------------------------------------------------
# Synthetic data
# ---------------------------------------------------------------------------


def test_synthetic_streams_identical_to_reference():
    for step in (0, 3):
        jb = jdata.SyntheticLM(vocab=97, seq_len=12, batch=3,
                               seed=5).batch_np(step)
        tb = tdata.SyntheticLM(vocab=97, seq_len=12, batch=3,
                               seed=5).batch_np(step)
        assert np.array_equal(jb["tokens"], tb["tokens"])
        assert jb["tokens"].dtype == tb["tokens"].dtype
    for a, b in zip(jdata.synthetic_images(4, 2, seed=1),
                    tdata.synthetic_images(4, 2, seed=1)):
        assert np.array_equal(a, b) and a.dtype == b.dtype
    for a, b in zip(jdata.synthetic_speech(2, 5, 6, 3, seed=2),
                    tdata.synthetic_speech(2, 5, 6, 3, seed=2)):
        assert np.array_equal(a, b) and a.dtype == b.dtype


# ---------------------------------------------------------------------------
# The qwen3 smoke model, 3 train steps
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def smoke():
    jcfg = dataclasses.replace(jq.SMOKE, swm=JSWM(block_size=8,
                                                  impl="pallas"))
    tcfg = dataclasses.replace(tq.SMOKE, swm=TSWM(block_size=8,
                                                  impl="pallas"))
    jm = JLM(jcfg)
    jparams = jax.jit(lambda: jinit(jm.specs(), 0))()
    data = tdata.SyntheticLM(vocab=tcfg.vocab, seq_len=SEQ, batch=BATCH)
    return jcfg, tcfg, jm, jparams, data


def _port_params(tcfg, jparams):
    return convert.from_reference(tcfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")


def _tokens(data, step):
    return {"tokens": torch.from_numpy(data.batch_np(step)["tokens"])}


def test_smoke_train_steps_match_reference(smoke):
    """Per-step loss and grad norm, and every leaf after 3 steps."""
    jcfg, tcfg, jm, jparams, data = smoke
    train = dict(z_loss=1e-4, warmup_steps=2)
    jstate = jinit_state(jparams, JTrain(**train))
    jstep = jax.jit(jmake_step(jm, jcfg, JTrain(**train)))
    model = build_model(tcfg, device="cpu")
    state = init_train_state(_port_params(tcfg, jparams), TTrain(**train))
    step = make_train_step(model, tcfg, TTrain(**train))
    for i in range(3):
        jstate, jm_ = jstep(jstate, {"tokens": jnp.asarray(
            data.batch_np(i)["tokens"])})
        state, m = step(state, _tokens(data, i))
        assert np.isfinite(float(m["loss"]))
        assert _rel(m["loss"], jm_["loss"]) <= LOSS_TOL
        assert _rel(m["grad_norm"], jm_["grad_norm"]) <= LOSS_TOL
    assert state["step"] == 3
    ref = jax.tree.map(np.asarray, jstate["params"])
    got = convert.to_reference(tcfg, state["params"])
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert _rel(a, b) <= LEAF_TOL


def test_microbatch_equals_full_batch(smoke):
    _, tcfg, _, jparams, data = smoke
    out = {}
    for mb in (0, 2):
        tc = TTrain(microbatch=mb, warmup_steps=1)
        state = init_train_state(_port_params(tcfg, jparams), tc)
        step = make_train_step(build_model(tcfg, device="cpu"), tcfg, tc)
        for i in range(2):
            state, m = step(state, _tokens(data, i))
        out[mb] = (m, state["params"])
    for key in ("loss", "grad_norm", "ce"):
        assert _rel(out[2][0][key], out[0][0][key]) <= LOSS_TOL
    for a, b in zip(tree_leaves(out[2][1]), tree_leaves(out[0][1])):
        assert _rel(a.detach(), b.detach()) <= LEAF_TOL


def test_remat_gives_the_same_grads(smoke):
    _, tcfg, _, jparams, data = smoke
    grads = {}
    for remat in ("none", "block"):
        cfg = dataclasses.replace(tcfg, remat=remat)
        tc = TTrain()
        params = _port_params(cfg, jparams)
        init_train_state(params, tc)
        loss_fn = make_loss_fn(build_model(cfg, device="cpu"), cfg, tc)
        (_, _), grads[remat] = value_and_grad(loss_fn, params,
                                              _tokens(data, 0), has_aux=True)
    for a, b in zip(tree_leaves(grads["block"]), tree_leaves(grads["none"])):
        assert torch.equal(a, b)


def test_grad_step_matches_reference():
    """SGD over a bare loss through a circulant Linear (kernel impl, odd
    block grid): two steps of ``make_grad_step`` on both sides."""
    from repro.nn.linear import Linear as JLinear
    from repro.train.loop import make_grad_step as jmake_grad_step
    from repro_torch.nn.linear import Linear as TLinear
    from repro_torch.nn.module import load_tree

    p, q, k = 3, 7, 8
    jl = JLinear(in_dim=q * k, out_dim=p * k, family="ffn",
                 swm=JSWM(block_size=k, impl="pallas"), dtype="float32")
    tl = TLinear(q * k, p * k, family="ffn",
                 swm=TSWM(block_size=k, impl="pallas"), dtype="float32")
    params = jax.tree.map(np.asarray, jinit(jl.specs(), 0))
    batch = {"x": _rand((4, q * k), 2), "y": _rand((4, p * k), 3)}

    def tloss(params, b):
        load_tree(tl, params)
        return ((tl(b["x"]) - b["y"]) ** 2).mean()

    jstep = jmake_grad_step(
        lambda params, b: ((jl(params, b["x"]) - b["y"]) ** 2).mean())
    tstep = make_grad_step(tloss)
    jp = _jtree(params)
    tp = init_train_state(_ttree(params), TTrain())["params"]
    for _ in range(2):
        jp, jloss = jstep(jp, _jtree(batch))
        tp, tloss_ = tstep(tp, _ttree(batch))
        assert _rel(tloss_, jloss) <= LOSS_TOL
    assert _rel(tp["w"].detach(), jp["w"]) <= REL_TOL


def test_train_step_audit_passes_on_a_clone(smoke):
    """``audit_args`` on the smoke model with the ``freq`` impl: the
    default rules (DenseFallbackDot) pass, and the audited step ran on a
    clone: the state's tensors are unchanged."""
    _, tcfg, _, jparams, data = smoke
    tcfg = dataclasses.replace(tcfg, swm=TSWM(block_size=8, impl="freq"))
    model = build_model(tcfg, device="cpu")
    state = init_train_state(_port_params(tcfg, jparams), TTrain())
    before = [t.detach().clone() for t in tree_leaves(state["params"])]
    step = make_train_step(model, tcfg, TTrain(),
                           audit_args=(state, _tokens(data, 0)))
    assert state["step"] == 0
    for a, b in zip(tree_leaves(state["params"]), before):
        assert torch.equal(a.detach(), b)
    state, m = step(state, _tokens(data, 0))
    assert torch.isfinite(m["loss"])


def test_train_step_audit_on_the_kernel_impl_flags_freq_weights(smoke):
    """On the kernel impl the default rules add NoFFT, and both packages
    fire it: their training forward transforms each time-domain table
    (``freq_weights``' rfft) every step."""
    from repro.analysis.contracts import StructuralContractError as JErr
    from repro_torch.analysis.contracts import StructuralContractError

    jcfg, tcfg, jm, jparams, data = smoke
    batch = _tokens(data, 0)
    with pytest.raises(JErr, match="NoFFT"):
        jmake_step(jm, jcfg, JTrain(), audit_args=(
            jinit_state(jparams, JTrain()),
            {"tokens": jnp.asarray(batch["tokens"].numpy())}))
    state = init_train_state(_port_params(tcfg, jparams), TTrain())
    with pytest.raises(StructuralContractError, match="NoFFT") as ei:
        make_train_step(build_model(tcfg, device="cpu"), tcfg, TTrain(),
                        audit_args=(state, batch))
    assert "kernels/block_circulant/ops.py" in str(ei.value)


def test_grad_step_audit_names_the_bad_line():
    """A bad ``audit_args`` loss (a weight fft and a dense matmul) raises
    ``StructuralContractError`` with this file's line for each."""
    from repro_torch.analysis.contracts import StructuralContractError

    def bad_loss(params, batch):
        wf = torch.fft.rfft(params["w"], dim=-1)        # planted: fft
        y = batch["x"] @ params["w"].reshape(8, 8)      # planted: dense
        return wf.abs().sum() + y.square().mean()

    params = {"w": torch.randn(2, 4, 8, requires_grad=True)}
    batch = {"x": torch.randn(3, 8)}
    with pytest.raises(StructuralContractError) as ei:
        make_grad_step(bad_loss, audit_args=(params, batch))
    msg = str(ei.value)
    lines = {n for n, line in enumerate(open(__file__), 1)
             if "# planted:" in line and "lines =" not in line}
    assert "grad_step: NoFFT" in msg and "NoDenseDotGeneral" in msg
    for n in lines:
        assert f"test_torch_train.py:{n}" in msg


def test_train_launcher_runs_on_cpu(capsys):
    tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "2",
                  "--seq", "16", "--batch", "2", "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.split()[3])) for l in lines)
