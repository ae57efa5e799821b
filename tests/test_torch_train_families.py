"""Port parity: training of every arch of the registry at its smoke config,
the reference's ``tests/test_models_smoke.py::test_arch_train_step`` held
against the JAX package: both packages load one JAX-initialized param
tree, take 2 steps of ``make_train_step`` (AdamW) on the same seeded
batches, and the per-step loss and grad norm and every leaf afterwards
must agree. Batches follow ``launch.specs.batch_specs``: tokens, a vlm's
``img`` prefix, an enc-dec model's ``frames`` (bf16, as the specs say).

Every arch takes the kernel impl (``impl="pallas"``): the reference's
Pallas kernels in interpret mode, the port's kernels' plain versions on
the CPU; the MoE archs' experts go through the grouped Functions'
backward. This file holds the dense, vlm, enc-dec and RWKV archs;
``tests/test_torch_train_moe.py`` the MoE ones (qwen3-moe, arctic, jamba),
so test workers take the two apart. Also: the vlm's loss covers the text
positions only, and the enc-dec model's per-layer recompute
(``remat="block"``) gives the same grads as ``"none"``.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SWMConfig as JSWM
from repro.configs.base import TrainConfig as JTrain
from repro.configs.registry import get_smoke as jget_smoke
from repro.launch.specs import build_model as jbuild_model
from repro.nn.module import init_params as jinit
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_loss_fn as jmake_loss_fn
from repro.train.loop import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.configs.registry import ARCHS, get_smoke
from repro_torch.launch.specs import batch_specs, build_model
from repro_torch.nn.module import tree_leaves
from repro_torch.train import losses as tlosses
from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                    make_train_step, value_and_grad)
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

# the tolerances of tests/test_torch_train.py: 2 train steps of an f32
# smoke model, both sides summing in other orders (kernel vs plain
# version, XLA vs ATen reductions) through every layer, the loss and its
# backward
LOSS_TOL = 1e-5
LEAF_TOL = 1e-4
SEQ, BATCH, STEPS = 16, 2, 2
TRAIN = dict(z_loss=1e-4, warmup_steps=1, learning_rate=1e-3)
MOE_ARCHS = ("arctic-480b", "jamba-v0.1-52b", "qwen3-moe-235b-a22b")
HERE = tuple(a for a in sorted(ARCHS) if a not in MOE_ARCHS)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _cfgs(arch, impl="pallas", **over):
    jcfg = dataclasses.replace(jget_smoke(arch), swm=JSWM(
        block_size=8, impl=impl), **over)
    tcfg = dataclasses.replace(get_smoke(arch), swm=TSWM(
        block_size=8, impl=impl), **over)
    return jcfg, tcfg


def _batches(tcfg):
    """STEPS seeded batches in ``batch_specs``' shapes and dtypes, as
    (port tensors, reference arrays): tokens from numpy seed 10 + step,
    float inputs standard normal from seed 20 + step, rounded to their
    dtype once and handed to both packages."""
    specs = batch_specs(tcfg, ShapeConfig("smoke", SEQ, BATCH, "train"))
    out = []
    for step in range(STEPS):
        tb, jb = {}, {}
        for name, (shape, dtype) in specs.items():
            if name == "tokens":
                a = np.random.default_rng(10 + step).integers(
                    0, tcfg.vocab, shape).astype(np.int32)
                tb[name], jb[name] = torch.from_numpy(a), jnp.asarray(a)
            else:
                a = np.random.default_rng(20 + step).standard_normal(shape)
                t = torch.from_numpy(a.astype(np.float32)).to(dtype)
                tb[name] = t
                jb[name] = jnp.asarray(t.float().numpy()).astype(
                    jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32)
        out.append((tb, jb))
    return out


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    """The JAX-initialized params of ``arch``'s smoke model (seed 0), made
    once per arch: neither ``remat`` nor ``impl`` changes a param."""
    jm = jbuild_model(_cfgs(arch)[0])
    return jax.jit(lambda: jinit(jm.specs(), 0))()


def _params(arch, **over):
    jcfg, tcfg = _cfgs(arch, **over)
    return jcfg, tcfg, jbuild_model(jcfg), _jparams(arch)


def _port_params(tcfg, jparams):
    return convert.from_reference(tcfg, jax.tree.map(np.asarray, jparams),
                                  device="cpu")


@pytest.fixture(scope="module", params=HERE)
def arch(request):
    return request.param


def test_train_steps_match_reference(arch):
    """Per-step loss and grad norm, and every leaf after STEPS steps."""
    _check_train_steps(arch)


def _check_train_steps(arch, impl="pallas"):
    jcfg, tcfg, jm, jparams = _params(arch, impl=impl)
    jstate = jinit_state(jparams, JTrain(**TRAIN))
    jstep = jax.jit(jmake_step(jm, jcfg, JTrain(**TRAIN)))
    model = build_model(tcfg, device="cpu")
    state = init_train_state(_port_params(tcfg, jparams), TTrain(**TRAIN))
    step = make_train_step(model, tcfg, TTrain(**TRAIN))
    for tb, jb in _batches(tcfg):
        jstate, jmet = jstep(jstate, jb)
        state, m = step(state, tb)
        assert np.isfinite(float(m["loss"]))
        assert _rel(m["loss"], jmet["loss"]) <= LOSS_TOL       # 1e-5
        assert _rel(m["grad_norm"], jmet["grad_norm"]) <= LOSS_TOL
        assert _rel(m["aux"], jmet["aux"]) <= LOSS_TOL
    assert state["step"] == STEPS
    ref = jax.tree.map(np.asarray, jstate["params"])
    got = convert.to_reference(tcfg, state["params"])
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert _rel(a, b) <= LEAF_TOL                          # 1e-4


def test_vlm_loss_covers_the_text_positions_only():
    """paligemma's loss with an image prefix is the chunked cross-entropy
    of the hidden states after the prefix against the next tokens: the
    same value from the model's own forward, cut by hand, and the same as
    the reference's."""
    jcfg, tcfg, jm, jparams = _params("paligemma-3b")
    tb, jb = _batches(tcfg)[0]
    model = build_model(tcfg, device="cpu")
    params = _port_params(tcfg, jparams)
    init_train_state(params, TTrain(**TRAIN))
    loss_fn = make_loss_fn(model, tcfg, TTrain(**TRAIN))
    with torch.no_grad():
        loss, metrics = loss_fn(params, tb)
        tokens = tb["tokens"]
        hidden, _ = model.forward_hidden(tokens[:, :-1],
                                         img_embeds=tb["img"])
        n_img = tb["img"].shape[1]
        assert hidden.shape[1] == n_img + SEQ
        ce, _ = tlosses.chunked_cross_entropy(
            hidden[:, n_img:], model.output_table(), tokens[:, 1:],
            z_loss=TRAIN["z_loss"])
    assert float(metrics["tokens"]) == BATCH * SEQ
    assert torch.equal(metrics["ce"], ce)
    jloss, _ = jmake_loss_fn(jm, jcfg, JTrain(**TRAIN))(jparams, jb)
    assert _rel(loss, jloss) <= LOSS_TOL
    # text only: without the image the same tokens give another loss
    with torch.no_grad():
        text_only, _ = loss_fn(params, {"tokens": tokens})
    assert not torch.equal(text_only, loss)


def test_encdec_remat_gives_the_same_grads():
    """seamless-m4t's per-layer recompute (``remat="block"``, encoder and
    decoder stacks) changes no value: the same loss and grads, bit for
    bit, as ``remat="none"``."""
    out = {}
    for remat in ("none", "block"):
        _, tcfg, _, jparams = _params("seamless-m4t-medium", remat=remat)
        params = _port_params(tcfg, jparams)
        init_train_state(params, TTrain(**TRAIN))
        loss_fn = make_loss_fn(build_model(tcfg, device="cpu"), tcfg,
                               TTrain(**TRAIN))
        out[remat] = value_and_grad(loss_fn, params, _batches(tcfg)[0][0],
                                    has_aux=True)
    (lb, _), gb = out["block"]
    (ln, _), gn = out["none"]
    assert torch.equal(lb, ln)
    for a, b in zip(tree_leaves(gb), tree_leaves(gn)):
        assert torch.equal(a, b)


def test_encdec_batch_without_frames_names_them():
    _, tcfg, _, jparams = _params("seamless-m4t-medium")
    params = _port_params(tcfg, jparams)
    loss_fn = make_loss_fn(build_model(tcfg, device="cpu"), tcfg, TTrain())
    with pytest.raises(KeyError, match="frames"):
        loss_fn(params, {"tokens": _batches(tcfg)[0][0]["tokens"]})
