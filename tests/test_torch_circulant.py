"""Port parity: circulant math and int8 quantization (repro_torch.core)
against the JAX reference on the same numpy inputs, on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import circulant as jcirc
from repro.core import quant as jquant
from repro_torch.core import circulant as tcirc
from repro_torch.core import quant as tquant
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # fp32 vs fp32 (tests/test_conformance.py REL_TOL)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _data(B, p, q, k, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, q * k)).astype(np.float32)
    w = (rng.standard_normal((p, q, k)) / np.sqrt(q * k)).astype(np.float32)
    return x, w


# (B, p, q, k): odd k, k=1, B=1, rectangular grids
GRID = [(1, 2, 3, 8), (5, 3, 2, 5), (4, 1, 1, 1), (3, 4, 2, 7)]


@pytest.mark.parametrize("k", [1, 2, 5, 7, 8, 16, 128])
def test_dft_bases_equal(k):
    for a, b in zip(jcirc._dft_bases_np(k), tcirc._dft_bases_np(k)):
        assert np.array_equal(a, b)
    for a, b in zip(jcirc.dft_bases(k), tcirc.dft_bases(k)):
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("B,p,q,k", GRID)
@pytest.mark.parametrize("impl", ["paper", "freq"])
def test_matvec_matches_reference(B, p, q, k, impl):
    x, w = _data(B, p, q, k)
    yj = jcirc.block_circulant_apply(jnp.asarray(x), jnp.asarray(w),
                                     impl=impl)
    yt = tcirc.block_circulant_apply(torch.from_numpy(x),
                                     torch.from_numpy(w), impl=impl)
    assert _rel(yt.numpy(), yj) <= REL_TOL
    dense = tcirc.blocks_to_dense(torch.from_numpy(w)).numpy()
    assert np.array_equal(dense, np.asarray(jcirc.blocks_to_dense(
        jnp.asarray(w))))


@pytest.mark.parametrize("B,p,q,k", GRID[1:])
@pytest.mark.parametrize("act", ["none", "gelu"])
def test_apply_fused_frozen_matches_reference(B, p, q, k, act):
    x, w = _data(B, p, q, k, seed=1)
    bias = np.random.default_rng(2).standard_normal(p * k).astype(np.float32)
    wf = np.fft.rfft(w.astype(np.float64), axis=-1)
    wr, wi = wf.real.astype(np.float32), wf.imag.astype(np.float32)
    for impl in ("paper", "pallas"):
        yj = jcirc.block_circulant_apply_fused(
            jnp.asarray(x), None, impl=impl, bias=jnp.asarray(bias),
            activation=act, w_freq=(jnp.asarray(wr), jnp.asarray(wi)), k=k)
        yt = tcirc.block_circulant_apply_fused(
            torch.from_numpy(x), None, impl=impl,
            bias=torch.from_numpy(bias), activation=act,
            w_freq=(torch.from_numpy(wr), torch.from_numpy(wi)), k=k)
        assert _rel(yt.numpy(), yj) <= REL_TOL, impl


@pytest.mark.parametrize("impl", ["paper", "freq", "pallas"])
def test_apply_multi_matches_reference(impl):
    rng = np.random.default_rng(3)
    k, q = 5, 3
    ws = [(rng.standard_normal((p, q, k)) * 0.3).astype(np.float32)
          for p in (2, 1, 3)]
    x = rng.standard_normal((4, q * k)).astype(np.float32)
    biases = [None, rng.standard_normal(k).astype(np.float32), None]
    yj = jcirc.block_circulant_apply_multi(
        jnp.asarray(x), [jnp.asarray(w) for w in ws], impl=impl,
        biases=[None if b is None else jnp.asarray(b) for b in biases],
        activation="tanh")
    yt = tcirc.block_circulant_apply_multi(
        torch.from_numpy(x), [torch.from_numpy(w) for w in ws], impl=impl,
        biases=[None if b is None else torch.from_numpy(b) for b in biases],
        activation="tanh")
    assert len(yt) == 3
    for a, b in zip(yt, yj):
        assert _rel(a.numpy(), b) <= REL_TOL
    # the pre-stacked frozen form (w_freq_cat + splits) agrees as well
    wf = np.fft.rfft(np.concatenate(ws).astype(np.float64), axis=-1)
    cat = (wf.real.astype(np.float32), wf.imag.astype(np.float32))
    yj = jcirc.block_circulant_apply_multi(
        jnp.asarray(x), None, impl=impl, w_freq_cat=tuple(map(jnp.asarray,
                                                              cat)),
        splits=(2, 1, 3), k=k)
    yt = tcirc.block_circulant_apply_multi(
        torch.from_numpy(x), None, impl=impl,
        w_freq_cat=tuple(map(torch.from_numpy, cat)), splits=(2, 1, 3), k=k)
    for a, b in zip(yt, yj):
        assert _rel(a.numpy(), b) <= REL_TOL


@pytest.mark.parametrize("dims,requested", [((20, 12), 8), ((9, 6), 8),
                                            ((7, 5), 8), ((1024, 3072), 128)])
def test_valid_block_size_equal(dims, requested):
    assert (tcirc.valid_block_size(requested, *dims)
            == jcirc.valid_block_size(requested, *dims))


@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 3, 2, 65), (1, 1, 1)])
def test_symmetric_quant_exact(shape):
    rng = np.random.default_rng(4)
    wr = (rng.standard_normal(shape) * 3).astype(np.float32)
    wi = (rng.standard_normal(shape) * 3).astype(np.float32)
    wr.reshape(-1)[0] = 0.0
    sj = jquant.symmetric_scales(jnp.asarray(wr), jnp.asarray(wi))
    st = tquant.symmetric_scales(torch.from_numpy(wr), torch.from_numpy(wi))
    assert np.array_equal(st.numpy(), np.asarray(sj))
    for a in (wr, wi):
        qj = jquant.quantize_symmetric(jnp.asarray(a), sj)
        qt = tquant.quantize_symmetric(torch.from_numpy(a), st)
        assert qt.dtype == torch.int8
        assert np.array_equal(qt.numpy(), np.asarray(qj))
        dj = jquant.dequantize_symmetric(qj, sj)
        dt = tquant.dequantize_symmetric(qt, st)
        assert np.array_equal(dt.numpy(), np.asarray(dj))
    with pytest.raises(ValueError):
        tquant.quantize_symmetric(torch.from_numpy(wr), st, bits=9)
    # all-zero blocks land on the scale floor and round-trip to zeros
    z = torch.zeros(shape)
    sz = tquant.symmetric_scales(z, z)
    assert torch.all(sz > 0)
    assert torch.equal(tquant.dequantize_symmetric(
        tquant.quantize_symmetric(z, sz), sz), z)
