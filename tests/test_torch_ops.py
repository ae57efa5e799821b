"""Port parity: the block-circulant kernel module (repro_torch.kernels.
block_circulant.kernel/ops) against the JAX reference's Pallas kernel (in
interpret mode on the CPU), on the same numpy inputs.

On CPU tensors the port's wrapper runs the kernel's plain PyTorch version;
the CUDA kernel itself is held against that plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels.block_circulant import ops as jops
from repro_torch.kernels.block_circulant import kernel as tkernel
from repro_torch.kernels.block_circulant import ops as tops
from repro_torch.kernels.block_circulant.ref import block_circulant_matmul_ref
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # fp32 vs fp32 (tests/test_conformance.py REL_TOL)
# bf16 output: one bf16 ulp (2^-7 relative) at the largest magnitude, on
# top of the fp32 tolerance — the two sides may round a value that sits
# near a bf16 rounding boundary to neighbouring bf16 numbers
BF16_TOL = 2.0 ** -7 + REL_TOL


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _tables(p, q, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((p, q, k)) / np.sqrt(q * k)).astype(np.float32)
    wf = np.fft.rfft(w.astype(np.float64), axis=-1)
    return w, wf.real.astype(np.float32), wf.imag.astype(np.float32)


def _x(B, n, seed):
    return np.random.default_rng(seed).standard_normal((B, n)).astype(
        np.float32)


def _t(*arrs):
    return [torch.from_numpy(np.array(a)) for a in arrs]


def _j(*arrs):
    return [jnp.asarray(a) for a in arrs]


@pytest.mark.parametrize("act", ["none", "relu", "tanh", "sigmoid", "gelu"])
def test_frozen_matmul_activations_with_bias(act):
    B, p, q, k = 5, 3, 2, 7                       # odd k, ragged everything
    _, wr, wi = _tables(p, q, k, 0)
    x = _x(B, q * k, 1)
    bias = _x(1, p * k, 2)[0]
    yj = jops.block_circulant_matmul(*_j(x), None, bias=jnp.asarray(bias),
                                     activation=act,
                                     w_freq=tuple(_j(wr, wi)), k=k)
    yt = tops.block_circulant_matmul(*_t(x), None,
                                     bias=torch.from_numpy(bias),
                                     activation=act,
                                     w_freq=tuple(_t(wr, wi)), k=k)
    assert yt.shape == (B, p * k)
    assert _rel(yt.numpy(), yj) <= REL_TOL


@pytest.mark.parametrize("B,p,q,k", [(1, 2, 3, 8), (4, 1, 1, 1)])
def test_frozen_matmul_no_bias_leading_dims(B, p, q, k):
    _, wr, wi = _tables(p, q, k, 3)
    x = _x(B * 2, q * k, 4).reshape(2, B, q * k)
    yj = jops.block_circulant_matmul(*_j(x), None, w_freq=tuple(_j(wr, wi)),
                                     k=k)
    yt = tops.block_circulant_matmul(*_t(x), None, w_freq=tuple(_t(wr, wi)),
                                     k=k)
    assert yt.shape == (2, B, p * k)
    assert _rel(yt.numpy(), yj) <= REL_TOL


def test_time_domain_matmul_matches_reference_and_oracle():
    B, p, q, k = 3, 2, 3, 5
    w, _, _ = _tables(p, q, k, 5)
    x = _x(B, q * k, 6)
    n0 = tops.freq_weights_trace_count()
    yt = tops.block_circulant_matmul(*_t(x, w))
    assert tops.freq_weights_trace_count() == n0 + 1
    yj = jops.block_circulant_matmul(*_j(x, w))
    assert _rel(yt.numpy(), yj) <= REL_TOL
    oracle = block_circulant_matmul_ref(*_t(x, w))
    assert _rel(yt.numpy(), oracle.numpy()) <= REL_TOL


def test_int8_tables_match_reference_and_dequant_exactly():
    B, p, q, k = 4, 3, 2, 16
    _, wr, wi = _tables(p, q, k, 7)
    x = _x(B, q * k, 8)
    bias = _x(1, p * k, 9)[0]
    sj = jquant.symmetric_scales(*_j(wr, wi))
    qr, qi = (jquant.quantize_symmetric(jnp.asarray(a), sj) for a in (wr, wi))
    yj = jops.block_circulant_matmul(
        *_j(x), None, bias=jnp.asarray(bias), activation="gelu",
        w_freq=(qr, qi), w_scale=sj, k=k)
    tq = _t(np.asarray(qr), np.asarray(qi), np.asarray(sj))
    yt = tops.block_circulant_matmul(
        *_t(x), None, bias=torch.from_numpy(bias), activation="gelu",
        w_freq=(tq[0], tq[1]), w_scale=tq[2], k=k)
    assert _rel(yt.numpy(), yj) <= REL_TOL
    # the int8 launch equals the fp32 launch on dequantized tables, bit
    # for bit (same dequant expression, same arithmetic downstream)
    from repro_torch.core.quant import dequantize_symmetric
    yd = tops.block_circulant_matmul(
        *_t(x), None, bias=torch.from_numpy(bias), activation="gelu",
        w_freq=(dequantize_symmetric(tq[0], tq[2]),
                dequantize_symmetric(tq[1], tq[2])), k=k)
    assert torch.equal(yt, yd)


def test_multi_w_freq_cat_splits_match_reference():
    k, q, splits = 8, 2, (2, 1, 1)
    _, wr, wi = _tables(sum(splits), q, k, 10)
    x = _x(3, q * k, 11)
    bias = _x(1, sum(splits) * k, 12)[0]
    yj = jops.block_circulant_matmul_multi(
        *_j(x), None, w_freq_cat=tuple(_j(wr, wi)), splits=splits, k=k,
        bias_cat=jnp.asarray(bias), activation="relu")
    yt = tops.block_circulant_matmul_multi(
        *_t(x), None, w_freq_cat=tuple(_t(wr, wi)), splits=splits, k=k,
        bias_cat=torch.from_numpy(bias), activation="relu")
    assert [o.shape[-1] for o in yt] == [s * k for s in splits]
    for a, b in zip(yt, yj):
        assert _rel(a.numpy(), b) <= REL_TOL
    # per-projection tables (w_freqs) and time-domain tables (ws) agree
    ws = [_tables(p, q, k, 13 + i)[0] for i, p in enumerate(splits)]
    biases = [None, _x(1, k, 20)[0], None]
    yj = jops.block_circulant_matmul_multi(
        *_j(x), [jnp.asarray(w) for w in ws],
        biases=[None if b is None else jnp.asarray(b) for b in biases])
    yt = tops.block_circulant_matmul_multi(
        *_t(x), [torch.from_numpy(w) for w in ws],
        biases=[None if b is None else torch.from_numpy(b) for b in biases])
    for a, b in zip(yt, yj):
        assert _rel(a.numpy(), b) <= REL_TOL


@pytest.mark.parametrize("case", ["scale_without_freq", "width",
                                  "scale_cat_without_cat", "cat_no_splits",
                                  "cat_with_biases"])
def test_same_value_errors_as_reference(case):
    k, q = 4, 2
    w, wr, wi = _tables(2, q, k, 21)
    x = _x(2, q * k, 22)
    sc = np.ones((2, q), np.float32)

    def call(mod, cv):
        if case == "scale_without_freq":
            return mod.block_circulant_matmul(cv(x), cv(w), w_scale=cv(sc))
        if case == "width":
            return mod.block_circulant_matmul(cv(x[:, :-1]), cv(w))
        if case == "scale_cat_without_cat":
            return mod.block_circulant_matmul_multi(cv(x), [cv(w)],
                                                    w_scale_cat=cv(sc))
        if case == "cat_no_splits":
            return mod.block_circulant_matmul_multi(
                cv(x), None, w_freq_cat=(cv(wr), cv(wi)), k=k)
        return mod.block_circulant_matmul_multi(
            cv(x), None, w_freq_cat=(cv(wr), cv(wi)), splits=(2,), k=k,
            biases=[None])

    with pytest.raises(ValueError) as ej:
        call(jops, jnp.asarray)
    with pytest.raises(ValueError) as et:
        call(tops, torch.from_numpy)
    assert str(et.value) == str(ej.value)


def test_plain_kernel_version_matches_dense_oracle_bf16():
    """bf16 x through the plain version: f32 math, one cast at the end."""
    B, p, q, k = 6, 3, 4, 8
    w, wr, wi = _tables(p, q, k, 23)
    x = torch.from_numpy(_x(B, q * k, 24)).to(torch.bfloat16)
    y = tkernel.bc_matmul_plain(x, *_t(wr, wi), k=k)
    assert y.dtype == torch.bfloat16
    oracle = block_circulant_matmul_ref(x.float(), torch.from_numpy(w))
    assert _rel(y.float().numpy(), oracle.numpy()) <= BF16_TOL


@pytest.mark.parametrize("in_dim,out_dim,requested,expect_k", [
    (20, 12, 8, 4),     # gcd fallback: 8 -> 4
    (9, 6, 8, 3),       # odd fallback: 8 -> 3
    (7, 5, 8, 1),       # coprime dims -> dense layout (k=1)
])
def test_linear_non_divisible_dims(in_dim, out_dim, requested, expect_k):
    from repro.configs.base import SWMConfig as JSWM
    from repro.nn.linear import Linear as JLinear
    from repro.nn.module import init_params as jinit
    from repro_torch.configs.base import SWMConfig as TSWM
    from repro_torch.nn.linear import Linear as TLinear
    from repro_torch.nn.module import load_tree

    jl = JLinear(in_dim=in_dim, out_dim=out_dim, family="ffn",
                 swm=JSWM(block_size=requested, impl="pallas"),
                 dtype="float32")
    tl = TLinear(in_dim, out_dim, family="ffn",
                 swm=TSWM(block_size=requested, impl="pallas"),
                 dtype="float32")
    assert tl.block_size == jl.block_size == expect_k
    params = jinit(jl.specs(), 0)
    load_tree(tl, {"w": torch.from_numpy(np.array(params["w"]))})
    x = _x(4, in_dim, 30)
    bias = _x(1, out_dim, 31)[0]
    yj = jl(params, jnp.asarray(x), bias=jnp.asarray(bias),
            activation="sigmoid")
    yt = tl(torch.from_numpy(x), bias=torch.from_numpy(bias),
            activation="sigmoid")
    assert _rel(yt.numpy(), yj) <= REL_TOL
