"""Port parity: ``repro_torch.core.conv`` (``extract_patches``,
``CirculantConv2D``) and the ``conv_taps`` branch of ``plan.freeze_params``
against the JAX reference, on JAX-initialised params carried across with
``convert.tree_from_reference`` and the same numpy inputs. The reference's
conv always runs its Pallas kernel (interpret mode on the CPU); the port's
runs the plain version of ``bc_matmul`` on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.conv import CirculantConv2D as JConv
from repro.core.conv import extract_patches as jextract
from repro.kernels.block_circulant import plan as jplan
from repro.nn.module import init_params as jinit
from repro_torch import convert
from repro_torch.core.conv import CirculantConv2D as TConv
from repro_torch.core.conv import extract_patches as textract
from repro_torch.kernels.block_circulant import ops as tops
from repro_torch.kernels.block_circulant import plan as tplan
from repro_torch.nn.module import load_tree
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # fp32 vs fp32 (tests/test_conformance.py REL_TOL)
# gradients: dw sums B·Ho·Wo rows and dx scatters r² taps back, each in
# another order on the two sides (XLA vs ATen); 5x the forward's limit
GRAD_TOL = 1e-4
FREEZE_TOL = 1e-6       # torch.fft vs jnp.fft rfft of the same f32 table


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _pair(block_size, in_ch=8, out_ch=8, ksize=3, seed=0):
    """(reference conv, its numpy params, port conv with them loaded)."""
    jc = JConv(in_ch=in_ch, out_ch=out_ch, ksize=ksize,
               block_size=block_size)
    params = jax.tree.map(np.asarray, jinit(jc.specs(), seed))
    tc = TConv(in_ch, out_ch, ksize=ksize, block_size=block_size)
    load_tree(tc, convert.tree_from_reference(params, device="cpu"))
    return jc, params, tc


@pytest.mark.parametrize("r", (1, 2, 3))
def test_extract_patches_bit_identical(r):
    x = _rand((2, 9, 11, 5), 0)
    want = np.asarray(jextract(jnp.asarray(x), r))
    got = textract(torch.from_numpy(x), r).numpy()
    assert got.shape == want.shape == (2, 10 - r, 12 - r, r * r, 5)
    np.testing.assert_array_equal(got, want)


def test_conv_small_input_raises():
    _, _, tc = _pair(4)
    with pytest.raises(ValueError, match="smaller than ksize"):
        tc(torch.zeros((1, 2, 8, 8)))
    with pytest.raises(ValueError, match="smaller than ksize"):
        tc(torch.zeros((1, 8, 2, 8)))


def test_conv_k1_dense_path_matches_reference():
    """k = 1 is a dense einsum over the same patches (bit-identical, see
    above) and taps. The einsum itself is not: XLA's and ATen's CPU dot
    products sum the r²·C = 72 terms in other orders (max abs difference
    8.3e-7 here), so it is held to the f32 limit."""
    jc, params, tc = _pair(1)
    assert tc.k == jc.k == 1
    x = _rand((2, 7, 7, 8), 1)
    want = np.asarray(jc(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = tc(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 5, 5, 8)
    assert _rel(got, want) <= REL_TOL


@pytest.mark.parametrize("block_size,ksize,in_ch,out_ch",
                         [(2, 3, 8, 8), (4, 3, 8, 8), (8, 5, 16, 24),
                          (4, 2, 12, 8)])
def test_conv_forward_matches_reference(block_size, ksize, in_ch, out_ch):
    jc, params, tc = _pair(block_size, in_ch, out_ch, ksize)
    assert tc.k == jc.k == block_size
    x = _rand((2, 10, 10, in_ch), 1)
    want = np.asarray(jc(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = tc(torch.from_numpy(x)).detach().numpy()
    assert got.shape == want.shape
    assert _rel(got, want) <= REL_TOL


@pytest.mark.parametrize("block_size", (2, 4, 8))
def test_conv_grads_match_reference(block_size):
    """dx and every param's grad of ``sum((conv(x) - t)²)``: the port's
    autograd Functions (closed-form adjoints) against ``jax.grad``."""
    jc, params, tc = _pair(block_size, in_ch=16, out_ch=16)
    x = _rand((2, 8, 8, 16), 1)
    t = _rand((2, 6, 6, 16), 2)
    gp, gx = jax.grad(
        lambda p, x: ((jc(p, x) - t) ** 2).sum(), argnums=(0, 1))(
            jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    bufs = {k: v.requires_grad_(True) for k, v in tc._buffers.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    loss = ((tc(xt) - torch.from_numpy(t)) ** 2).sum()
    grads = torch.autograd.grad(loss, [xt] + list(bufs.values()))
    assert _rel(grads[0], gx) <= GRAD_TOL
    for (key, _), g in zip(bufs.items(), grads[1:]):
        assert _rel(g, gp[key]) <= GRAD_TOL, key


@pytest.mark.parametrize("quantize", ("off", "int8"))
def test_conv_taps_freeze_matches_reference_leaves(quantize):
    """Tap tables (r², p, q, k) freeze into the (p, r²·q, K) im2col layout;
    under int8 the (p, r²·q) scale grid matches the stored table."""
    jc, params, tc = _pair(4, in_ch=8, out_ch=12, ksize=3)
    jfrozen = jax.tree.map(np.asarray, jplan.freeze_params(
        jc.specs(), jax.tree.map(jnp.asarray, params), quantize))
    tparams = convert.tree_from_reference(params, device="cpu")
    tfrozen = convert.tree_to_reference(
        tplan.freeze_params(tc.specs(), tparams, quantize))
    keys = {"wr", "wi", "b"} | ({"w_scale"} if quantize == "int8" else set())
    assert set(tfrozen) == set(jfrozen) == keys     # w dropped, no _fused
    assert tfrozen["wr"].shape == (3, 9 * 2, 3)
    for key in sorted(keys):
        assert tfrozen[key].dtype == jfrozen[key].dtype, key
        if quantize == "int8" and key in ("wr", "wi"):
            np.testing.assert_array_equal(tfrozen[key], jfrozen[key])
        else:
            assert _rel(tfrozen[key], jfrozen[key]) <= FREEZE_TOL, key


@pytest.mark.parametrize("quantize", ("off", "int8"))
def test_conv_frozen_forward_matches_and_issues_no_rfft(quantize):
    jc, params, tc = _pair(4)
    x = _rand((2, 8, 8, 8), 1)
    jfrozen = jplan.freeze_params(jc.specs(),
                                  jax.tree.map(jnp.asarray, params),
                                  quantize)
    tfrozen = convert.tree_from_reference(
        jax.tree.map(np.asarray, jfrozen), device="cpu")
    assert tplan.freeze_params(tc.specs(), tfrozen, quantize) is tfrozen
    load_tree(tc, tfrozen)
    n0 = tops.freq_weights_trace_count()
    got = tc(torch.from_numpy(x)).numpy()
    assert tops.freq_weights_trace_count() == n0
    want = np.asarray(jc(jfrozen, jnp.asarray(x)))
    assert _rel(got, want) <= REL_TOL


def test_conv_frozen_f32_equals_unfrozen_forward():
    """The frozen tables are the unfrozen path's rfft(w) in the same
    layout, so both launch the same arithmetic."""
    _, params, tc = _pair(8, in_ch=16, out_ch=16, ksize=3)
    x = torch.from_numpy(_rand((2, 6, 6, 16), 3))
    y = tc(x)
    load_tree(tc, tplan.freeze_params(
        tc.specs(), convert.tree_from_reference(params, device="cpu")))
    assert torch.equal(tc(x), y)


def test_block_circulant_matmul_validates_q():
    """``q`` must equal the tables' q: the port stores them unpadded."""
    w = torch.randn(2, 3, 4)
    x = torch.randn(5, 12)
    y = tops.block_circulant_matmul(x, w, q=3)
    assert torch.equal(y, tops.block_circulant_matmul(x, w))
    with pytest.raises(ValueError, match="unpadded"):
        tops.block_circulant_matmul(x, w, q=2)
    wr, wi = tops.freq_weights(w)
    with pytest.raises(ValueError, match="unpadded"):
        tops.block_circulant_matmul(x, None, w_freq=(wr, wi), k=4, q=4)
