"""Port parity for three repaired faults, each against the JAX package.

* A ``BaseException`` that is not an ``Exception`` (here ``Halt``) raised
  at a prefill or a decode launch kills the engine in both packages: the
  step raises ``EngineFatalError`` from it, the next ``step()`` raises
  ``EngineFatalError``, and a ``Supervisor`` over the port's engine heals
  it (streams equal to a fault-free run).
* Adafactor on a repeated layer group: three steps of qwen3's 3-layer
  smoke model (one layer repeated 3 times, stacked in the reference) from
  one numpy tree, params and the moments carried across by
  ``convert.opt_to_reference`` held to rel 1e-5 (f32), with the relative
  update clip binding on a stacked leaf in at least one step (asserted).
  :func:`reference_adafactor` is also the oracle of the two-rank
  Adafactor step in ``tests/test_torch_dist.py``.

The multi-rank MoE routing repair is tested in ``tests/test_torch_dist.py``
(``VARIANTS["moe"]``).
"""

import dataclasses
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jq
from repro.configs.base import ModelConfig as JCfg, SWMConfig as JSWM
from repro.configs.base import TrainConfig as JTrain
from repro.models.decoder import HybridDecoderLM as JLM
from repro.optim import optimizers as jopt
from repro.serve import engine as jeng
from repro.train import loop as jloop
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import ModelConfig as TCfg, SWMConfig as TSWM
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.serve import engine as teng, supervisor as tsup
from repro_torch.train.loop import init_train_state, make_train_step
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL = 1e-5


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


# ---------------------------------------------------------------------------
# A BaseException at a launch is engine-fatal
# ---------------------------------------------------------------------------

FIELDS = dict(name="halt", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
              head_dim=16, d_ff=64, vocab=48, remat="none",
              param_dtype="float32", compute_dtype="float32")


class Halt(BaseException):
    """Not an ``Exception``: what a bare ``except Exception`` lets by."""


class HaltAt:
    """Raises :class:`Halt` once, before launch ``at`` of ``kind``."""

    def __init__(self, kind, at):
        self.key, self.fired = (kind, at), False

    def on_step(self, step):
        pass

    def on_launch(self, kind, index):
        if not self.fired and (kind, index) == self.key:
            self.fired = True
            raise Halt(f"{kind} launch {index}")


@pytest.fixture(scope="module")
def engines():
    jcfg = JCfg(**FIELDS, swm=JSWM(block_size=8, impl="dft"))
    tcfg = TCfg(**FIELDS, swm=TSWM(block_size=8, impl="dft"))
    tparams = init_params(build_model(tcfg, device="cpu").specs(), 0,
                          device="cpu")
    ref = convert.to_reference(tcfg, tparams)
    jm, jparams = JLM(jcfg), jax.tree.map(jnp.asarray, ref)

    def jengine(**kw):
        return jeng.ServeEngine(jm, jcfg, jparams, batch=2, cache_len=32,
                                **kw)

    def tengine(**kw):
        return teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg,
                                convert.from_reference(tcfg, ref, "cpu"),
                                batch=2, cache_len=32, **kw)

    return ((jeng, jengine), (teng, tengine))


def _reqs(mod):
    rng = np.random.default_rng(3)
    return [mod.Request(rng.integers(0, 48, size=5).astype(np.int32),
                        max_new=4) for _ in range(3)]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_base_exception_at_launch_kills_both_engines(engines, kind):
    for mod, make in engines:
        eng = make(fault_injector=HaltAt(kind, 1))
        for r in _reqs(mod):
            eng.submit(r)
        with pytest.raises(mod.EngineFatalError) as ei:
            for _ in range(50):
                eng.step()
        assert isinstance(ei.value.__cause__, Halt)
        assert "Halt" in str(ei.value)
        with pytest.raises(mod.EngineFatalError):
            eng.step()


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_supervisor_heals_a_base_exception(engines, kind):
    _, make = engines[1]
    base = make().generate(_reqs(teng))
    with tempfile.TemporaryDirectory() as snap:
        inj = HaltAt(kind, 1)
        sup = tsup.Supervisor(lambda: make(fault_injector=inj,
                                           snapshot_dir=snap,
                                           snapshot_every=1))
        rids = [sup.submit(r) for r in _reqs(teng)]
        out = sup.drain(rids)
        assert sup.restarts == 1 and inj.fired
        assert [out[r] for r in rids] == base


# ---------------------------------------------------------------------------
# Adafactor over a repeated layer group
# ---------------------------------------------------------------------------

STEPS, BATCH, SEQ = 3, 4, 16
AF_TRAIN = dict(learning_rate=3e-2, warmup_steps=1, total_steps=10)


def _af_cfgs():
    return (dataclasses.replace(jq.SMOKE, optimizer="adafactor"),
            dataclasses.replace(tq.SMOKE, optimizer="adafactor"))


def _af_batches(cfg, steps=STEPS, batch=BATCH, seq=SEQ):
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch)
    return [data.batch_np(i)["tokens"] for i in range(steps)]


def reference_adafactor(jcfg, tcfg_kw, params_ref, batches):
    """The reference's Adafactor steps (``make_train_step``'s body, step
    by step) from a reference-layout numpy tree. Returns (params, opt,
    the largest relative-update RMS of a leaf stacked over layers, per
    step)."""
    jm = JLM(jcfg)
    jt = JTrain(**tcfg_kw)
    loss_fn = jloop.make_loss_fn(jm, jcfg, jt)
    grad_fn = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))
    params = jax.tree.map(jnp.asarray, params_ref)
    opt = jopt.adafactor_init(params, jt)
    rms = []
    for step, tokens in enumerate(batches):
        _, grads = grad_fn(params, {"tokens": jnp.asarray(tokens)})
        grads, _ = jopt.clip_by_global_norm(grads, jt.grad_clip)
        rms.append(max(_stacked_rms(params, grads, opt, step, jt)))
        params, opt = jopt.adafactor_update(
            params, grads, opt, jnp.asarray(step, jnp.int32), jt)
    return (jax.tree.map(np.asarray, params), jax.tree.map(np.asarray, opt),
            rms)


def _stacked_rms(params, grads, opt, step, jt):
    """The update RMS the reference clips by, for each leaf of a stacked
    group (a leading layer axis), before this step's update."""
    t = float(step) + 1.0
    beta2 = 1.0 - t ** -0.8
    eps = 1e-30
    out = []
    for path, g in jax.tree_util.tree_leaves_with_path(grads):
        if not any(getattr(k, "key", "").startswith("group") for k in path):
            continue
        vr = _at(opt["vr"], path)
        vc = _at(opt["vc"], path)
        g2 = np.square(np.asarray(g, np.float64)) + eps
        if g.ndim >= 2:
            vr_n = beta2 * vr + (1 - beta2) * g2.mean(-1)
            vc_n = beta2 * vc + (1 - beta2) * g2.mean(-2)
            denom = (vr_n[..., :, None] * vc_n[..., None, :]
                     / np.maximum(vr_n.mean(-1)[..., None, None], eps))
            upd = np.asarray(g) / np.sqrt(denom + eps)
        else:
            upd = np.asarray(g) / np.sqrt(beta2 * vr + (1 - beta2) * g2
                                          + eps)
        out.append(float(np.sqrt(np.mean(np.square(upd)) + eps)))
    return out


def _at(tree, path):
    for k in path:
        tree = tree[k.key]
    return np.asarray(tree, np.float64)


def port_adafactor(tcfg, params_ref, batches):
    """The port's train step (Adafactor with ``layer_stacks``) from a
    reference-layout numpy tree; (params, opt) in the reference layout."""
    model = build_model(tcfg, device="cpu")
    tt = TTrain(**AF_TRAIN)
    step = make_train_step(model, tcfg, tt)
    state = init_train_state(convert.from_reference(tcfg, params_ref, "cpu"),
                             tt, "adafactor",
                             stacks=convert.layer_stacks(tcfg))
    for tokens in batches:
        state, _ = step(state, {"tokens": torch.from_numpy(tokens)})
    return (convert.to_reference(tcfg, state["params"]),
            convert.opt_to_reference(tcfg, state["opt"]), state)


def _assert_close(got, want):
    flat_g = jax.tree_util.tree_leaves_with_path(got)
    flat_w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(flat_g) == len(flat_w)
    for path, a in flat_g:
        b = flat_w[path]
        assert np.shape(a) == np.shape(b), path
        assert _rel(a, b) <= REL, (path, _rel(a, b))


def test_adafactor_stacked_group_matches_reference():
    jcfg, tcfg = _af_cfgs()
    assert len(convert.layer_stacks(tcfg)) == 1      # one 3-layer stack
    tparams = init_params(build_model(tcfg, device="cpu").specs(), 0,
                          device="cpu")
    ref = convert.to_reference(tcfg, tparams)
    batches = _af_batches(tcfg)
    jp, jo, rms = reference_adafactor(jcfg, AF_TRAIN, ref, batches)
    # the clip binds on a stacked leaf, so the RMS's span matters
    assert max(rms) > 1.0, rms
    tp, to, state = port_adafactor(tcfg, ref, batches)
    _assert_close(tp, jp)
    _assert_close(to, jo)
    # the stack's norm scales: vr one entry per layer, vc one (d,)
    norm = jo["vr"]["group0"]["l0"]["ln1"]["scale"]
    assert norm.shape == (tcfg.n_layers,)
    assert jo["vc"]["group0"]["l0"]["ln1"]["scale"].shape == (
        tcfg.d_model,)
    # and back: the reference's state carried into the port's layout
    back = convert.opt_from_reference(tcfg, jo, "cpu")
    for k in ("vr", "vc"):
        for a, b in zip(jax.tree.leaves(back[k]),
                        jax.tree.leaves(state["opt"][k])):
            assert tuple(a.shape) == tuple(b.shape)
            assert _rel(a.numpy(), b.numpy()) <= REL


def test_adafactor_state_made_without_stacks_is_refused():
    _, tcfg = _af_cfgs()
    model = build_model(tcfg, device="cpu")
    tt = TTrain(**AF_TRAIN)
    state = init_train_state(init_params(model.specs(), 0, device="cpu"),
                             tt, "adafactor")
    tokens = torch.from_numpy(_af_batches(tcfg, steps=1)[0])
    with pytest.raises(ValueError, match="stacks="):
        make_train_step(model, tcfg, tt)(state, {"tokens": tokens})
