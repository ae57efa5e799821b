"""Port parity: ``repro_torch.nn.scan.chunked_time_scan`` against the JAX
package's ``chunked_time_scan`` (and ``lax.scan``) on the same numpy
inputs: a decaying matrix recurrence with a per-step output, at lengths
below, at and past the chunk, with a ragged tail; its per-chunk recompute
(grads equal to the plain loop's bit for bit and to the reference's, full
chunks run twice and the tail once); and the jamba and rwkv6 smoke mixers
past 256 steps, where their scans recompute, against the reference's
grads, nested inside the layer-level recompute too."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_52b as jj
from repro.configs import rwkv6_7b as jr
from repro.configs.base import SWMConfig as JSWM
from repro.nn.module import init_params as jinit
from repro.nn.rwkv import RWKV6TimeMix as JTimeMix
from repro.nn.scan import chunked_time_scan as jscan
from repro.nn.ssm import Mamba as JMamba
from repro_torch.configs import jamba_52b as tj
from repro_torch.configs import rwkv6_7b as tr
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.specs import build_model
from repro_torch.nn import scan as scan_mod
from repro_torch.nn.module import (init_params, load_tree, tree_leaves,
                                   tree_map)
from repro_torch.nn.rwkv import RWKV6TimeMix as TTimeMix
from repro_torch.nn.scan import chunked_time_scan as tscan
from repro_torch.nn.ssm import Mamba as TMamba
from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                    value_and_grad)
from test_torch_decoder_family import fast_jit
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5
# a mixer's grads past 256 steps: its projections, conv or token shift and
# an f32 recurrence over 300 steps, in other summation orders on the two
# sides (the port's plain kernel versions, the reference's XLA freq impl)
MIXER_TOL = 1e-4


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((2, 3, 4)).astype(np.float32)
    decay = rng.uniform(0.5, 1.0, (T, 2, 3, 1)).astype(np.float32)
    u = rng.standard_normal((T, 2, 3, 4)).astype(np.float32)
    valid = rng.uniform(size=(T, 2)) > 0.3
    return h0, decay, u, valid


def _step(lib):
    def step(h, t):
        d, u, m = t
        h_new = d * h + u
        h_new = lib.where(m[:, None, None], h_new, h)
        return h_new, (h_new * u).sum(-1)
    return step


@pytest.mark.parametrize("T,chunk", [(1, 4), (5, 4), (8, 4), (11, 4),
                                     (7, 256)])
def test_scan_matches_reference(T, chunk):
    h0, decay, u, valid = _inputs(T)
    jh, jys = jscan(_step(jnp), jnp.asarray(h0),
                    tuple(jnp.asarray(a) for a in (decay, u, valid)),
                    chunk=chunk, remat=True)
    th, tys = tscan(_step(torch), torch.from_numpy(h0),
                    tuple(torch.from_numpy(a) for a in (decay, u, valid)),
                    chunk=chunk, remat=True)
    assert tys.shape == (T, 2, 3)
    assert _rel(th.numpy(), jh) <= REL_TOL
    assert _rel(tys.numpy(), jys) <= REL_TOL


def test_scan_chunk_and_remat_change_nothing():
    """``chunk`` and ``remat`` change no value: with a gradient recorded
    (pytest runs with grad mode on) or not, every setting gives the same
    carry and outputs, bit for bit."""
    h0, decay, u, valid = _inputs(9, seed=1)
    xs = tuple(torch.from_numpy(a) for a in (decay, u, valid))
    ref = tscan(_step(torch), torch.from_numpy(h0), xs)
    for chunk, remat in ((1, False), (4, True), (9, False), (512, True)):
        got = tscan(_step(torch), torch.from_numpy(h0), xs, chunk=chunk,
                    remat=remat)
        assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    with torch.no_grad():
        got = tscan(_step(torch), torch.from_numpy(h0), xs, chunk=4)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


def _counting(lib):
    step, calls = _step(lib), []

    def counted(h, t):
        calls.append(1)
        return step(h, t)
    return counted, calls


@pytest.mark.parametrize("T", [300, 515])
def test_scan_recompute_grads_equal_plain_loop_and_reference(T):
    h0, decay, u, valid = _inputs(T, seed=2)
    ct = np.random.default_rng(3).standard_normal((T, 2, 3)).astype(
        np.float32)

    def jloss(h0, decay, u):
        h, ys = jscan(_step(jnp), h0, (decay, u, jnp.asarray(valid)),
                      chunk=256, remat=True)
        return (h ** 2).sum() + (ys * ct).sum()

    ref = jax.grad(jloss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (h0, decay, u)))
    grads = {}
    for remat in (False, True):
        leaves = [torch.tensor(a, requires_grad=True)
                  for a in (h0, decay, u)]
        step, calls = _counting(torch)
        h, ys = tscan(step, leaves[0], (leaves[1], leaves[2],
                                        torch.from_numpy(valid)),
                      chunk=256, remat=remat)
        assert len(calls) == T
        ((h ** 2).sum() + (ys * torch.from_numpy(ct)).sum()).backward()
        full = (T // 256) * 256
        # the full chunks run again in the backward, the tail never
        assert len(calls) == (T + full if remat else T)
        grads[remat] = [a.grad for a in leaves]
    for a, b, r in zip(grads[True], grads[False], ref):
        assert torch.equal(a, b)
        assert _rel(a.numpy(), r) <= REL_TOL


def test_scan_recompute_only_under_grad():
    h0, decay, u, valid = _inputs(300, seed=4)
    step, calls = _counting(torch)
    xs = tuple(torch.from_numpy(a) for a in (decay, u, valid))
    with torch.no_grad():
        h, ys = tscan(step, torch.from_numpy(h0), xs, chunk=256, remat=True)
    assert h.grad_fn is None and len(calls) == 300


# ---------------------------------------------------------------------------
# The mixers past 256 steps
# ---------------------------------------------------------------------------

S_LONG = 300
MIXERS = {"jamba": (jj.SMOKE, tj.SMOKE, JMamba, TMamba),
          "rwkv6": (jr.SMOKE, tr.SMOKE, JTimeMix, TTimeMix)}


@pytest.mark.parametrize("arch", sorted(MIXERS))
def test_mixer_grads_past_256_steps_match_reference(arch, monkeypatch):
    jsmoke, tsmoke, jcls, tcls = MIXERS[arch]
    jcfg = dataclasses.replace(jsmoke, swm=JSWM(block_size=8, impl="freq"))
    tcfg = dataclasses.replace(tsmoke, swm=TSWM(block_size=8,
                                                impl="pallas"))
    jm, tm = jcls(jcfg), tcls(tcfg)
    jparams = fast_jit(lambda: jinit(jm.specs(), 0))()
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, S_LONG, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((2, S_LONG, jcfg.d_model)).astype(np.float32)
    jg = fast_jit(jax.grad(lambda p, x: (jm(p, x)[0] * ct).sum(),
                           argnums=(0, 1)))(jparams, jnp.asarray(x))
    seen = []
    real = scan_mod.chunked_time_scan

    def spy(*a, **kw):
        seen.append((kw["chunk"], kw["remat"]))
        return real(*a, **kw)

    monkeypatch.setattr(f"{tm.__module__}.chunked_time_scan", spy)
    tp = jax.tree.map(lambda a: torch.tensor(np.asarray(a),
                                             requires_grad=True), jparams)
    load_tree(tm, tp)
    xt = torch.tensor(x, requires_grad=True)
    (tm(xt)[0] * torch.from_numpy(ct)).sum().backward()
    assert seen == [(256, True)]
    assert _rel(xt.grad.numpy(), jg[1]) <= MIXER_TOL
    for got, ref in zip(jax.tree.leaves(jax.tree.map(lambda t: t.grad, tp)),
                        jax.tree.leaves(jg[0])):
        assert _rel(got.numpy(), ref) <= MIXER_TOL


def test_scan_recompute_nests_in_layer_recompute():
    """The jamba smoke model past 256 steps: the scans' per-chunk
    recompute inside each layer's (``remat="block"``) gives the grads of
    the plain run, bit for bit."""
    cfg0 = dataclasses.replace(tj.SMOKE, swm=TSWM(block_size=8,
                                                  impl="pallas"))
    tokens = SyntheticLM(vocab=cfg0.vocab, seq_len=S_LONG,
                         batch=1).batch_np(0)["tokens"]
    params = init_params(build_model(cfg0, device="cpu").specs(), 0,
                         device="cpu")
    grads = {}
    for remat in ("none", "block"):
        cfg = dataclasses.replace(cfg0, remat=remat)
        model = build_model(cfg, device="cpu")
        p = tree_map(lambda t: t.clone(), params)
        init_train_state(p, TTrain())
        loss_fn = make_loss_fn(model, cfg, TTrain())
        _, grads[remat] = value_and_grad(
            loss_fn, p, {"tokens": torch.from_numpy(tokens)}, has_aux=True)
    for a, b in zip(tree_leaves(grads["block"]), tree_leaves(grads["none"])):
        assert torch.equal(a, b)
