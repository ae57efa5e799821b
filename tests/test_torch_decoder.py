"""Port parity: the qwen3 smoke decoder (repro_torch.models.decoder) with
the kernel impl against the JAX reference with its Pallas kernel (interpret
mode on the CPU): prefill logits over left-padded rows with negative pad
positions, then 3 decode steps against the cache — unfrozen, frozen fp32
and frozen int8, on JAX-initialized params carried across."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jq
from repro.configs.base import SWMConfig as JSWM
from repro.kernels.block_circulant import plan as jplan
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.kernels.block_circulant import plan as tplan
from repro_torch.launch.specs import build_model
from repro_torch.nn.attention import _direct_attention, flash_attention
from repro_torch.nn.module import load_tree, module_tree
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

# f32 end to end: both sides sum in other orders (kernel vs plain version,
# XLA vs ATen reductions) through 3 layers of attention and FFN
LOGIT_TOL = 1e-4
CACHE_LEN = 16


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


@pytest.fixture(scope="module")
def setup():
    jcfg = dataclasses.replace(jq.SMOKE, swm=JSWM(block_size=8,
                                                  impl="pallas"))
    tcfg = dataclasses.replace(tq.SMOKE, swm=TSWM(block_size=8,
                                                  impl="pallas"))
    jm = JLM(jcfg)
    # jitted: the same values as eager init, compiled once
    jparams = jax.jit(lambda: jinit(jm.specs(), 0))()
    jfrozen = jax.jit(lambda p: jplan.freeze_params(jm.specs(), p))(jparams)
    jint8 = jax.jit(lambda p: jplan.freeze_params(jm.specs(), p, "int8"))(
        jfrozen)
    trees = {"unfrozen": jparams, "fp32": jfrozen, "int8": jint8}
    return jcfg, tcfg, jm, trees


def _inputs():
    # row 0: a full 6-token prompt; row 1: 4 tokens left-padded by 2 lanes
    # whose positions are negative (masked)
    toks = np.asarray([[5, 17, 250, 3, 99, 42], [0, 0, 7, 7, 120, 64]],
                      np.int32)
    pos = np.asarray([[0, 1, 2, 3, 4, 5], [-2, -1, 0, 1, 2, 3]], np.int32)
    return toks, pos


@pytest.mark.parametrize("mode", ["unfrozen", "fp32", "int8"])
def test_prefill_and_decode_match_reference(setup, mode):
    jcfg, tcfg, jm, trees = setup
    jparams = trees[mode]
    tm = build_model(tcfg, device="cpu")
    load_tree(tm, convert.from_reference(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    toks, pos = _inputs()
    jcache = jm.init_cache(2, CACHE_LEN)
    jlog, jcache, _ = jax.jit(jm.forward)(
        jparams, jnp.asarray(toks), positions=jnp.asarray(pos), cache=jcache)
    jdecode = jax.jit(jm.decode_step)
    tcache = tm.init_cache(2, CACHE_LEN)
    with torch.no_grad():
        tlog, tcache = tm.forward(torch.from_numpy(toks).long(),
                                  positions=torch.from_numpy(pos),
                                  cache=tcache)
    real = pos >= 0
    assert _rel(tlog.numpy()[real], np.asarray(jlog)[real]) <= LOGIT_TOL
    nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)
    cur = pos[:, -1] + 1
    for _ in range(3):
        jl, jcache = jdecode(jparams, jnp.asarray(nxt[:, None]), jcache,
                             jnp.asarray(cur))
        with torch.no_grad():
            tl, tcache = tm.decode_step(torch.from_numpy(nxt[:, None]).long(),
                                        tcache, torch.from_numpy(cur))
        assert _rel(tl.numpy(), jl) <= LOGIT_TOL
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        cur = cur + 1
    # the in-place ring cache holds what the reference's cache holds
    for li in range(tcfg.n_layers):
        for name in ("k", "v", "pos"):
            ref = np.asarray(jcache[0]["l0"][name])[li]
            got = tcache[li][name].numpy()
            if name == "pos":
                assert np.array_equal(got, ref)
            else:
                assert _rel(got, ref) <= LOGIT_TOL


def test_port_freeze_matches_carried_frozen_tables(setup):
    """The port freezing its own tree gives the same logits as the
    reference-frozen tables carried across."""
    jcfg, tcfg, jm, trees = setup
    toks, pos = _inputs()
    outs = []
    for src in ("unfrozen", "fp32"):
        tm = build_model(tcfg, device="cpu")
        load_tree(tm, convert.from_reference(
            tcfg, jax.tree.map(np.asarray, trees[src]), device="cpu"))
        if src == "unfrozen":
            load_tree(tm, tplan.freeze_params(tm.specs(), module_tree(tm)))
        with torch.no_grad():
            outs.append(tm.forward(torch.from_numpy(toks).long(),
                                   positions=torch.from_numpy(pos))[0])
    assert _rel(outs[0].numpy(), outs[1].numpy()) <= LOGIT_TOL


def test_flash_attention_matches_direct():
    rng = np.random.default_rng(0)
    B, S, HKV, G, hd = 2, 11, 2, 2, 8
    q = torch.from_numpy(rng.standard_normal((B, S, HKV, G, hd)).astype(
        np.float32))
    k = torch.from_numpy(rng.standard_normal((B, S, HKV, hd)).astype(
        np.float32))
    v = torch.from_numpy(rng.standard_normal((B, S, HKV, hd)).astype(
        np.float32))
    pos = torch.arange(S, dtype=torch.int32).expand(B, S).clone()
    pos[1, :3] = torch.tensor([-3, -2, -1], dtype=torch.int32)
    ref = _direct_attention(q, k, v, pos, pos)
    got = flash_attention(q, k, v, pos, pos, q_chunk=4, kv_chunk=3)
    real = (pos >= 0).numpy()
    assert _rel(got.numpy()[real], ref.numpy()[real]) <= 1e-5


@pytest.mark.parametrize("kind", ["SwiGLU", "MLP"])
def test_ffn_blocks_match_reference(kind):
    from repro.nn import ffn as jffn
    from repro.nn.module import init_params as jinit2
    from repro_torch.nn import ffn as tffn

    jblock = getattr(jffn, kind)(d_model=32, d_ff=64,
                                 swm=JSWM(block_size=8, impl="pallas"),
                                 dtype="float32")
    tblock = getattr(tffn, kind)(32, 64, swm=TSWM(block_size=8,
                                                  impl="pallas"),
                                 dtype="float32")
    params = jinit2(jblock.specs(), 1)
    load_tree(tblock, jax.tree.map(lambda a: torch.from_numpy(np.array(a)),
                                   params))
    x = np.random.default_rng(5).standard_normal((3, 32)).astype(np.float32)
    yj = jblock(params, jnp.asarray(x))
    with torch.no_grad():
        yt = tblock(torch.from_numpy(x))
    assert _rel(yt.numpy(), yj) <= LOGIT_TOL
