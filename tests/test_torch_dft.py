"""Port parity for the ``dft`` impl and the rest of ``core/circulant.py``:
``block_circulant_apply(impl="dft")`` (karatsuba on and off) forward and
both grads against ``jax.grad`` of the JAX package's, the shared-DFT pair
(``block_circulant_apply_pair``) and SwiGLU's fused gate/up pair, the
bookkeeping helpers (``dense_to_blocks_lstsq``, ``dense_flops``,
``swm_flops``, ``launch.specs.count_params`` over every registry config),
and one qwen3 smoke train step with ``impl="dft"``, all on the same numpy
inputs and JAX-initialised params.

Tolerances: in f32 both sides sum in other orders (XLA vs ATen), so
values and grads agree to ``REL_TOL`` (the reference's conformance
tolerance). In bf16 both round the same intermediates (x̂, ŵ, ŷ, the
adjoints) to bf16 at the same places and accumulate in f32; a different
f32 summation order can still flip one bf16 rounding of an intermediate,
which moves a result by at most about one bf16 ulp of the largest
magnitude: ``BF16_TOL = 2^-7``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jq
from repro.configs.base import SWMConfig as JSWM
from repro.configs.base import TrainConfig as JTrain
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_smoke as jget_smoke
from repro.core import circulant as J
from repro.launch.specs import count_params as jcount_params
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.ffn import SwiGLU as JSwiGLU
from repro.nn.module import init_params as jinit
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.core import circulant as T
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.specs import build_model, count_params
from repro_torch.nn import ffn as tffn
from repro_torch.nn.module import load_tree
from repro_torch.train.loop import init_train_state, make_train_step
from test_torch_decoder_family import fast_jit
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # tests/test_conformance.py REL_TOL
BF16_TOL = 2.0 ** -7
# one f32 train step of the 3-layer smoke model: both sides sum in other
# orders through the layers, the loss and its backward
LOSS_TOL = 1e-5
LEAF_TOL = 1e-4

DTYPES = {"f32": (jnp.float32, torch.float32, REL_TOL),
          "bf16": (jnp.bfloat16, torch.bfloat16, BF16_TOL)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _np(t):
    return t.detach().float().numpy()


def _jnp(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


def _inputs(N, p, q, k, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, q * k)).astype(np.float32)
    w = (rng.standard_normal((p, q, k)) / np.sqrt(q * k)).astype(np.float32)
    return x, w


# (N, p, q, k): even and odd k, ragged grids, and qwen3-0.6b's k = 128
SHAPES = [(6, 3, 4, 8), (5, 2, 3, 7), (33, 4, 6, 16), (64, 8, 8, 128)]


@pytest.mark.parametrize("N,p,q,k", SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("karatsuba", [False, True])
def test_dft_apply_and_grads_match_reference(N, p, q, k, dtype, karatsuba):
    jdt, tdt, tol = DTYPES[dtype]
    x, w = _inputs(N, p, q, k, seed=N + k)
    ct = np.random.default_rng(1).standard_normal((N, p * k)).astype(
        np.float32)

    def f(x, w):
        y = J.block_circulant_apply(x, w, impl="dft", karatsuba=karatsuba)
        return (y.astype(jnp.float32) * ct).sum()

    xj, wj = jnp.asarray(x, jdt), jnp.asarray(w, jdt)
    yj = J.block_circulant_apply(xj, wj, impl="dft", karatsuba=karatsuba)
    gxj, gwj = jax.grad(f, argnums=(0, 1))(xj, wj)

    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    wt = torch.from_numpy(w).to(tdt).requires_grad_()
    yt = T.block_circulant_apply(xt, wt, impl="dft", karatsuba=karatsuba)
    (yt.float() * torch.from_numpy(ct)).sum().backward()
    assert yt.dtype == xt.grad.dtype == wt.grad.dtype == tdt
    assert yt.shape == (N, p * k)
    assert _rel(_np(yt), _jnp(yj)) <= tol
    assert _rel(_np(xt.grad), _jnp(gxj)) <= tol
    assert _rel(_np(wt.grad), _jnp(gwj)) <= tol


def test_dft_matvec_takes_leading_axes_and_compute_dtype():
    x, w = _inputs(12, 3, 4, 8, seed=3)
    x3 = x.reshape(3, 4, -1)
    yj = J.block_circulant_matvec_dft(jnp.asarray(x3), jnp.asarray(w),
                                      compute_dtype=jnp.bfloat16)
    yt = T.block_circulant_matvec_dft(torch.from_numpy(x3),
                                      torch.from_numpy(w),
                                      compute_dtype=torch.bfloat16)
    assert yt.shape == (3, 4, 24) and yt.dtype == torch.bfloat16
    assert _rel(_np(yt), _jnp(yj)) <= BF16_TOL


def test_dft_backward_keeps_only_x_and_w():
    x, w = _inputs(6, 3, 4, 8, seed=4)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    saved = []

    def pack(t):
        saved.append(tuple(t.shape))
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        T.block_circulant_apply(xt, wt, impl="dft")
    assert saved == [tuple(xt.shape), tuple(wt.shape)]


def test_freq_shmap_names_the_distribution_layer():
    # freq_shmap is the freq path on this rank's rows (the distribution
    # layer's eager data parallelism hands each rank only its rows)
    x, w = _inputs(2, 1, 1, 8, seed=5)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    assert torch.equal(T.block_circulant_apply(xt, wt, impl="freq_shmap"),
                       T.block_circulant_apply(xt, wt, impl="freq"))
    with pytest.raises(ValueError, match="unknown impl"):
        T.block_circulant_apply(torch.from_numpy(x), torch.from_numpy(w),
                                impl="nope")


# ---------------------------------------------------------------------------
# The shared-DFT pair and SwiGLU's fused gate/up
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_pair_matches_reference(dtype):
    jdt, tdt, tol = DTYPES[dtype]
    N, p, q, k = 10, 4, 3, 8
    x, w1 = _inputs(N, p, q, k, seed=6)
    _, w2 = _inputs(N, p, q, k, seed=7)
    rng = np.random.default_rng(8)
    c1, c2 = (rng.standard_normal((N, p * k)).astype(np.float32)
              for _ in range(2))

    def f(x, w1, w2):
        y1, y2 = J.block_circulant_apply_pair(x, w1, w2)
        return ((y1.astype(jnp.float32) * c1).sum()
                + (y2.astype(jnp.float32) * c2).sum())

    args = [jnp.asarray(a, jdt) for a in (x, w1, w2)]
    yj = J.block_circulant_apply_pair(*args)
    gj = jax.grad(f, argnums=(0, 1, 2))(*args)
    ts = [torch.from_numpy(a).to(tdt).requires_grad_() for a in (x, w1, w2)]
    yt = T.block_circulant_apply_pair(*ts)
    ((yt[0].float() * torch.from_numpy(c1)).sum()
     + (yt[1].float() * torch.from_numpy(c2)).sum()).backward()
    for a, b in zip(yt, yj):
        assert _rel(_np(a), _jnp(b)) <= tol
    for a, b in zip(ts, gj):
        assert _rel(_np(a.grad), _jnp(b)) <= tol


def _leaves(params):
    return jax.tree.map(lambda a: torch.tensor(a, requires_grad=True),
                        params)


def _swiglu_pair(swm_kw, d=32, f=64, dtype="float32"):
    j = JSwiGLU(d_model=d, d_ff=f, swm=JSWM(**swm_kw), dtype=dtype)
    t = tffn.SwiGLU(d, f, swm=TSWM(**swm_kw), dtype=dtype)
    params = jax.tree.map(np.asarray, jinit(j.specs(), 0))
    return j, t, params


@pytest.mark.parametrize("karatsuba", [False, True])
def test_swiglu_fused_pair_matches_reference(monkeypatch, karatsuba):
    swm = dict(block_size=8, impl="dft", karatsuba=karatsuba)
    j, t, params = _swiglu_pair(swm)
    x = np.random.default_rng(9).standard_normal((2, 5, 32)).astype(
        np.float32)
    ct = np.random.default_rng(10).standard_normal((2, 5, 32)).astype(
        np.float32)
    yj, gj = jax.value_and_grad(
        lambda p, x: (j(p, x) * ct).sum(), argnums=(0, 1))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    calls = []
    real = tffn.block_circulant_apply_pair
    monkeypatch.setattr(tffn, "block_circulant_apply_pair",
                        lambda *a: calls.append(1) or real(*a))
    tp = _leaves(params)
    load_tree(t, tp)
    xt = torch.from_numpy(x).requires_grad_()
    loss = (t(xt) * torch.from_numpy(ct)).sum()
    loss.backward()
    assert calls == [1]
    assert _rel(loss.detach(), yj) <= REL_TOL
    assert _rel(_np(xt.grad), gj[1]) <= REL_TOL
    for name in ("wi", "wu", "wo"):
        assert _rel(_np(tp[name]["w"].grad), gj[0][name]["w"]) <= REL_TOL


def test_swiglu_pair_equals_per_linear_path():
    """The pair shares x's transform and nothing else: the same values
    and grads, bit for bit, as the gate and up Linears apart."""
    _, t, params = _swiglu_pair(dict(block_size=8, impl="dft"))
    x = np.random.default_rng(11).standard_normal((3, 32)).astype(np.float32)
    out = []
    for fused in (True, False):
        tp = _leaves(params)
        load_tree(t, tp)
        xt = torch.from_numpy(x).requires_grad_()
        if fused:
            y = t(xt)
        else:
            m = t._modules
            y = m["wo"](torch.nn.functional.silu(m["wi"](xt)) * m["wu"](xt))
        y.square().sum().backward()
        out.append([y.detach(), xt.grad] + [tp[n]["w"].grad
                                            for n in ("wi", "wu", "wo")])
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.parametrize("case", ["freq", "experts", "frozen", "dense_up"])
def test_swiglu_takes_the_pair_only_where_the_reference_does(monkeypatch,
                                                             case):
    calls = []
    monkeypatch.setattr(tffn, "block_circulant_apply_pair",
                        lambda *a: calls.append(1))
    swm = TSWM(block_size=8, impl="freq" if case == "freq" else "dft")
    kw = {"expert_dims": (2,)} if case == "experts" else {}
    t = tffn.SwiGLU(16, 32, swm=swm, dtype="float32", **kw)
    if case == "dense_up":
        t._modules["wu"].swm = TSWM(block_size=8, impl="dft",
                                    targets=("attn",))
    gen = torch.Generator().manual_seed(0)
    tree = {n: {"w": torch.randn(t._modules[n].specs()["w"].shape,
                                 generator=gen)} for n in ("wi", "wu", "wo")}
    if case == "frozen":
        for n in ("wi", "wu", "wo"):
            wf = torch.fft.rfft(tree[n].pop("w"), dim=-1)
            tree[n].update(wr=wf.real.contiguous(), wi=wf.imag.contiguous())
    load_tree(t, tree)
    x = torch.randn(*((2,) if case == "experts" else ()), 3, 16,
                    generator=gen)
    assert torch.isfinite(t(x)).all()
    assert calls == []


# ---------------------------------------------------------------------------
# Bookkeeping helpers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("m,n,k", [(24, 16, 8), (21, 14, 7), (128, 256, 128)])
def test_dense_to_blocks_lstsq_matches_reference(m, n, k):
    W = np.random.default_rng(m + n).standard_normal((m, n)).astype(
        np.float32)
    got = T.dense_to_blocks_lstsq(torch.from_numpy(W), k)
    ref = J.dense_to_blocks_lstsq(jnp.asarray(W), k)
    assert got.shape == (m // k, n // k, k)
    assert _rel(got.numpy(), ref) <= 1e-6
    # a circulant table is its own projection
    w = got.clone()
    assert _rel(T.dense_to_blocks_lstsq(T.blocks_to_dense(w), k).numpy(),
                w.numpy()) <= 1e-6
    with pytest.raises(ValueError, match="not divisible"):
        T.dense_to_blocks_lstsq(torch.from_numpy(W), 5)


def test_flop_counts_equal_reference():
    for batch, m, n, k in [(1, 8, 8, 8), (4, 1024, 3072, 128),
                           (32, 112, 48, 16), (2, 7, 21, 7), (5, 6, 6, 1)]:
        assert T.dense_flops(batch, m, n) == J.dense_flops(batch, m, n)
        for impl in ("paper", "freq", "dft", "pallas"):
            assert (T.swm_flops(batch, m, n, k, impl)
                    == J.swm_flops(batch, m, n, k, impl))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_count_params_equals_reference(arch):
    for tget, jget in ((get_config, jget_config), (get_smoke, jget_smoke)):
        got, ref = count_params(tget(arch)), jcount_params(jget(arch))
        assert got == ref


# ---------------------------------------------------------------------------
# A train step of the qwen3 smoke model on the dft impl
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("karatsuba", [False, True])
def test_dft_smoke_train_step_matches_reference(karatsuba):
    swm = dict(block_size=8, impl="dft", karatsuba=karatsuba)
    jcfg = dataclasses.replace(jq.SMOKE, swm=JSWM(**swm))
    tcfg = dataclasses.replace(tq.SMOKE, swm=TSWM(**swm))
    train = dict(z_loss=1e-4, warmup_steps=1)
    jm = JLM(jcfg)
    jparams = fast_jit(lambda: jinit(jm.specs(), 0))()
    data = SyntheticLM(vocab=tcfg.vocab, seq_len=16, batch=4)
    tokens = data.batch_np(0)["tokens"]
    jstate, jmet = fast_jit(jmake_step(jm, jcfg, JTrain(**train)))(
        jinit_state(jparams, JTrain(**train)),
        {"tokens": jnp.asarray(tokens)})
    state = init_train_state(
        convert.from_reference(tcfg, jax.tree.map(np.asarray, jparams),
                               device="cpu"), TTrain(**train))
    step = make_train_step(build_model(tcfg, device="cpu"), tcfg,
                           TTrain(**train))
    state, m = step(state, {"tokens": torch.from_numpy(tokens)})
    assert _rel(m["loss"], jmet["loss"]) <= LOSS_TOL
    assert _rel(m["grad_norm"], jmet["grad_norm"]) <= LOSS_TOL
    ref = jax.tree.leaves(jax.tree.map(np.asarray, jstate["params"]))
    got = jax.tree.leaves(convert.to_reference(tcfg, state["params"]))
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert _rel(a, b) <= LEAF_TOL
