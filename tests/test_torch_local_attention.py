"""Port parity for local (sliding-window) and prefix-LM attention and the
ring-buffer KV cache, against the JAX package on the CPU.

Covers: ``_mask_bias`` against the reference's for (causal, window,
prefix) cases with pad and unfilled slots; chunked (flash) attention
against direct attention and both against the reference's direct
attention under every mask; the window span property (the reference's
``tests/test_attention.py::test_windowed_span_slicing_property``, which
its span-sliced flash must pass; the port's loops compute every chunk);
local layers rotating with ``rope_theta_local``; and the mirrors of
``tests/test_ring_cache.py``: decode to 4x the ring matching the full
forward, window-sized local caches, and a small (window, S) property.

Tolerances are the reference tests' own: 2e-5 for attention outputs (f32,
other summation orders), 2e-4 / 3e-4 for decode against the full forward
(``tests/test_ring_cache.py``). The reference's ring tests run its ``dft``
impl, which the port lacks; the port runs its kernel impl (the plain
version on the CPU), the same function in other summation orders, so the
port's full forward is held to the reference's at the ring tests' 2e-4.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.base import ModelConfig as JCfg, SWMConfig as JSWM
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn import attention as jatt
from repro.nn.module import init_params as jinit
from repro_torch import convert
from repro_torch.configs.base import ModelConfig as TCfg, SWMConfig as TSWM
from repro_torch.models.decoder import HybridDecoderLM, local_attn_cache_len
from repro_torch.nn import attention as tatt
from repro_torch.nn.module import load_tree
from test_torch_decoder_family import fast_jit
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

ATT_TOL = 2e-5
MASKS = [(True, 0, 0), (True, 16, 0), (True, 0, 10), (True, 16, 10),
         (False, 0, 0), (False, 16, 0)]
# (window, prefix) of the causal attention paths (the bidirectional ones,
# ``causal=False``, are tests/test_torch_encdec.py's)
ATT_MASKS = [(0, 0), (16, 0), (0, 10), (16, 10), (8, 20), (40, 0)]


def _qkv(B=2, Sq=64, Skv=64, HKV=2, G=2, hd=8, seed=0):
    r = np.random.default_rng(seed)
    q = r.standard_normal((B, Sq, HKV, G, hd)).astype(np.float32)
    k = r.standard_normal((B, Skv, HKV, hd)).astype(np.float32)
    v = r.standard_normal((B, Skv, HKV, hd)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Skv - Sq, Skv), (B, Sq)).astype(np.int32)
    kp = np.broadcast_to(np.arange(Skv), (B, Skv)).astype(np.int32)
    return q, k, v, qp, kp


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("causal,window,prefix", MASKS)
def test_mask_bias_matches_reference(causal, window, prefix):
    r = np.random.default_rng(1)
    # keys: left-pad lanes and unfilled slots (negative), a wrapped ring
    kp = np.stack([np.arange(-3, 37), r.permutation(40) - 4]).astype(np.int32)
    qp = np.stack([np.arange(20, 30), np.arange(-2, 8)]).astype(np.int32)
    got = tatt._mask_bias(*_t(qp, kp), causal=causal, window=window,
                          prefix_len=prefix)
    ref = jatt._mask_bias(jnp.asarray(qp), jnp.asarray(kp), causal=causal,
                          window=window, prefix_len=prefix)
    assert got.dtype == torch.float32
    assert np.array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("window,prefix", ATT_MASKS)
def test_flash_and_direct_match_reference(window, prefix):
    q, k, v, qp, kp = _qkv()
    kw = dict(window=window, prefix_len=prefix)
    flash = tatt.flash_attention(*_t(q, k, v, qp, kp), q_chunk=16,
                                 kv_chunk=16, **kw)
    direct = tatt._direct_attention(*_t(q, k, v, qp, kp), **kw)
    ref = jatt._direct_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                 causal=True, softcap=0.0, **kw)
    np.testing.assert_allclose(flash.numpy(), direct.numpy(), rtol=ATT_TOL,
                               atol=ATT_TOL)
    np.testing.assert_allclose(direct.numpy(), np.asarray(ref), rtol=ATT_TOL,
                               atol=ATT_TOL)


@given(st.sampled_from([32, 64, 100]), st.sampled_from([8, 16, 32]),
       st.sampled_from([16, 32]))
@settings(max_examples=12, deadline=None)
def test_windowed_span_slicing_property(S, window, chunk):
    """Windowed flash equals direct attention for any (S, window, chunk):
    the property the reference's span-sliced flash is held to."""
    q, k, v, qp, kp = _qkv(B=2, Sq=S, Skv=S)
    ref = tatt._direct_attention(*_t(q, k, v, qp, kp), window=window)
    out = tatt.flash_attention(*_t(q, k, v, qp, kp), window=window,
                               q_chunk=chunk, kv_chunk=chunk)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=3e-5,
                               atol=3e-5)


# ---------------------------------------------------------------------------
# The ring cache (mirrors of tests/test_ring_cache.py)
# ---------------------------------------------------------------------------


def _cfgs(window=6, pattern=5):
    """The reference ring tests' model, with distinct global and local
    rope thetas (gemma3's), so a swapped theta shows in every test."""
    kw = dict(name="ring", n_layers=6, d_model=32, n_heads=2, n_kv_heads=2,
              head_dim=16, d_ff=64, vocab=64, sliding_window=window,
              local_global_pattern=pattern, rope_theta=1_000_000.0,
              rope_theta_local=10_000.0, remat="none",
              param_dtype="float32", compute_dtype="float32")
    return (JCfg(swm=JSWM(block_size=8, impl="dft"), **kw),
            TCfg(swm=TSWM(block_size=8, impl="pallas"), **kw))


RING_B, RING_S = 2, 26


@pytest.fixture(scope="module")
def ring():
    """JAX-initialised params of the ring model (the window is not in any
    param shape, so one tree serves every window), seeded tokens and the
    reference's full-forward logits on them at window 6."""
    jcfg, _ = _cfgs()
    params = jax.tree.map(np.asarray,
                          fast_jit(lambda: jinit(JLM(jcfg).specs(), 0))())
    toks = np.random.default_rng(0).integers(
        0, 64, (RING_B, RING_S)).astype(np.int32)
    ref, _, _ = fast_jit(JLM(jcfg).forward)(params, jnp.asarray(toks))
    return params, toks, np.asarray(ref)


@pytest.fixture(scope="module")
def ring_params(ring):
    return ring[0]


def _port(tcfg, params):
    m = HybridDecoderLM(tcfg, device="cpu")
    load_tree(m, convert.from_reference(tcfg, params, device="cpu"))
    return m


def _decode_from(m, toks, Sp):
    """Prefill ``toks[:, :Sp]`` into a cache of the full length, then
    decode the rest one token at a time: the logits of every step."""
    B, S = toks.shape
    cache = m.init_cache(B, S)
    out = []
    with torch.no_grad():
        _, cache = m.prefill(toks[:, :Sp], cache)
        for t in range(Sp, S):
            lg, cache = m.decode_step(toks[:, t:t + 1], cache,
                                      torch.full((B,), t, dtype=torch.int32))
            out.append(lg)
    return torch.stack(out, 1)


def test_decode_wraps_ring_buffer_many_times(ring):
    """Decode to 4x the local ring (26 positions, ring 6): every step
    equals the port's full forward, and the port's full forward equals the
    reference's."""
    params, toks, ref = ring
    m = _port(_cfgs(window=6)[1], params)
    Sp = 2
    with torch.no_grad():
        full, _ = m(torch.from_numpy(toks).long())
    np.testing.assert_allclose(full.numpy(), ref, rtol=2e-4, atol=2e-4)
    steps = _decode_from(m, torch.from_numpy(toks).long(), Sp)
    np.testing.assert_allclose(steps.numpy(), full[:, Sp:].numpy(),
                               rtol=2e-4, atol=2e-4)


def test_local_cache_is_window_sized(ring_params):
    _, tcfg = _cfgs(window=6)
    cache = _port(tcfg, ring_params).init_cache(2, 1000)
    assert [c["k"].shape[1] for c in cache] == [6] * 5 + [1000]
    assert local_attn_cache_len(tcfg, 1000) == 6
    assert local_attn_cache_len(tcfg, 4) == 4
    assert local_attn_cache_len(dataclasses.replace(
        tcfg, sliding_window=0), 9) == 9


@given(st.integers(3, 10), st.integers(12, 30))
@settings(max_examples=6, deadline=None)
def test_wraparound_property(ring_params, window, S):
    """Arbitrary (window, S): prefill + decode == the full forward."""
    _, tcfg = _cfgs(window=window)
    m = _port(tcfg, ring_params)
    toks = torch.from_numpy(np.random.default_rng(window * 100 + S).integers(
        0, 64, (1, S))).long()
    with torch.no_grad():
        full, _ = m(toks)
    steps = _decode_from(m, toks, max(1, S // 3))
    np.testing.assert_allclose(steps[:, -1].numpy(), full[:, -1].numpy(),
                               rtol=3e-4, atol=3e-4)


def test_local_layers_rotate_with_the_local_theta(ring):
    """Local layers take ``rope_theta_local``, global ones ``rope_theta``
    (the reference's ``Attention._rope_theta``); with the two swapped the
    port leaves the reference, so the parity above sees a swap."""
    params, toks, ref = ring
    tcfg = _cfgs(window=6)[1]
    m = _port(tcfg, params)
    thetas = [layer._modules["mixer"].rope_theta
              for layer in m._modules["layers"]]
    assert thetas == [10_000.0] * 5 + [1_000_000.0]
    swapped = _port(dataclasses.replace(tcfg, rope_theta=10_000.0,
                                        rope_theta_local=1_000_000.0), params)
    with torch.no_grad():
        bad, _ = swapped(torch.from_numpy(toks).long())
    assert np.abs(bad.numpy() - ref).max() > 1e-3
