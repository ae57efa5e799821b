"""Port parity: the backward of the block-circulant ops (repro_torch.kernels.
block_circulant.kernel/ops) against the JAX reference's custom VJPs, which
run its Pallas kernels in interpret mode on the CPU, on the same numpy
inputs.

On CPU tensors the port's autograd Functions run the kernels' plain
versions (``bc_matmul_plain``, ``bc_dw_plain``); the CUDA kernels are held
against those plain versions on the card by ``tests/test_torch_cuda.py``
and ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jquant
from repro.kernels.block_circulant import ops as jops
from repro_torch.core.quant import quantize_symmetric, symmetric_scales
from repro_torch.kernels.block_circulant import kernel as tkernel
from repro_torch.kernels.block_circulant import ops as tops
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # fp32 vs fp32 (tests/test_conformance.py REL_TOL)
ACTS = ["none", "relu", "tanh", "sigmoid", "gelu"]
# (B, P, Q, k): ragged block grids, odd k, k = 1, a single row
DW_SHAPES = [(4, 2, 3, 8), (5, 3, 2, 7), (3, 1, 1, 1), (1, 2, 2, 16),
             (6, 3, 4, 5)]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


@pytest.mark.parametrize("freq_out", [False, True])
@pytest.mark.parametrize("B,P,Q,k", DW_SHAPES)
def test_dw_matches_reference_kernel_and_oracle(B, P, Q, k, freq_out):
    x, g = _rand((B, Q * k), 1), _rand((B, P * k), 2)
    ref = jops._dw_via_kernel(jnp.asarray(x), jnp.asarray(g), P, Q, k,
                              interpret=True, freq_out=freq_out)
    got = tops._dw_via_kernel(_t(x), _t(g), P, Q, k, freq_out=freq_out)
    plain = tkernel.bc_dw_plain(_t(x), _t(g), P=P, Q=Q, k=k,
                                freq_out=freq_out)
    if freq_out:
        oracle = jops._dw_freq_cotangents(jnp.asarray(x), jnp.asarray(g),
                                          P, Q, k)
        port_oracle = tops._dw_freq_cotangents(_t(x), _t(g), P, Q, k)
        for i in range(2):
            assert got[i].shape == (P, Q, k // 2 + 1)
            assert _rel(got[i], ref[i]) <= REL_TOL
            assert _rel(plain[i], ref[i]) <= REL_TOL
            assert _rel(got[i], oracle[i]) <= REL_TOL
            assert _rel(port_oracle[i], oracle[i]) <= REL_TOL
    else:
        assert got.shape == (P, Q, k) and plain.shape == (P, Q * k)
        assert _rel(got, ref) <= REL_TOL
        assert _rel(plain.reshape(P, Q, k), ref) <= REL_TOL


def _grads_both(fj, ft, inputs, argnums):
    """jax.grad of sum(f(...) * cot) against torch.autograd.grad."""
    jin = [None if a is None else jnp.asarray(a) for a in inputs]
    tin = [None if a is None else _t(a, i in argnums)
           for i, a in enumerate(inputs)]
    y = ft(*tin)
    cot = _rand(tuple(y.shape), 99)
    jg = jax.grad(lambda *a: jnp.sum(fj(*a) * cot), argnums=argnums)(*jin)
    tg = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                             [tin[i] for i in argnums])
    return y, jg, tg


@pytest.mark.parametrize("act", ACTS)
def test_time_domain_grads_match_reference(act):
    """dx, dw, db of the trainable-table Function against jax.grad of the
    reference's ``_bc_matmul2d`` (odd k, ragged p/q, every activation)."""
    B, p, q, k = 5, 3, 2, 7
    inputs = [_rand((B, q * k), 1), _rand((p, q, k), 2, (q * k) ** -0.5),
              _rand((p * k,), 3)]
    y, jg, tg = _grads_both(
        lambda x, w, b: jops.block_circulant_matmul(x, w, bias=b,
                                                    activation=act),
        lambda x, w, b: tops.block_circulant_matmul(x, w, bias=b,
                                                    activation=act),
        inputs, (0, 1, 2))
    assert y.grad_fn is not None
    for a, b in zip(tg, jg):
        assert a.shape == b.shape
        assert _rel(a, b) <= REL_TOL


@pytest.mark.parametrize("act", ACTS)
def test_freq_table_grads_match_reference(act):
    """dx, dwr, dwi, db of the trainable-frozen-table Function against
    jax.grad of the reference's ``_bc_freq2d``."""
    B, p, q, k = 4, 2, 3, 8
    K = k // 2 + 1
    inputs = [_rand((B, q * k), 4), _rand((p, q, K), 5), _rand((p, q, K), 6),
              _rand((p * k,), 7)]
    y, jg, tg = _grads_both(
        lambda x, wr, wi, b: jops.block_circulant_matmul(
            x, None, bias=b, activation=act, w_freq=(wr, wi), k=k),
        lambda x, wr, wi, b: tops.block_circulant_matmul(
            x, None, bias=b, activation=act, w_freq=(wr, wi), k=k),
        inputs, (0, 1, 2, 3))
    for a, b in zip(tg, jg):
        assert _rel(a, b) <= REL_TOL


def test_multi_projection_grads_match_reference():
    """Stacked-p launch over per-projection tables and biases: grads flow
    back through the concatenation to each table."""
    B, q, k, ps = 3, 2, 8, (2, 1, 1)
    ws = [_rand((p, q, k), 10 + i, (q * k) ** -0.5) for i, p in enumerate(ps)]
    inputs = [_rand((B, q * k), 9), *ws, _rand((k,), 20)]

    def fj(x, w0, w1, w2, b1):
        return jnp.concatenate(jops.block_circulant_matmul_multi(
            x, [w0, w1, w2], biases=[None, b1, None], activation="gelu"), -1)

    def ft(x, w0, w1, w2, b1):
        return torch.cat(tops.block_circulant_matmul_multi(
            x, [w0, w1, w2], biases=[None, b1, None], activation="gelu"), -1)

    _, jg, tg = _grads_both(fj, ft, inputs, (0, 1, 2, 3, 4))
    for a, b in zip(tg, jg):
        assert _rel(a, b) <= REL_TOL


def _graph_nodes(t):
    """Names of every autograd node behind ``t``."""
    seen, todo, names = set(), [t.grad_fn], set()
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        names.add(type(node).__name__)
        todo.extend(fn for fn, _ in node.next_functions)
    return names


def test_cpu_grads_run_the_closed_form_adjoints():
    """On the CPU the graph goes through the port's Functions (plain
    versions of the kernels inside), not through autograd of the plain
    version's products and rfft."""
    x = _t(_rand((3, 16), 1), True)
    w = _t(_rand((2, 2, 8), 2), True)
    wr = _t(_rand((2, 2, 5), 3), True)
    for y, fn in ((tops.block_circulant_matmul(x, w), "_BCMatmul2dBackward"),
                  (tops.block_circulant_matmul(
                      x, None, w_freq=(wr, _t(wr.detach())), k=8),
                   "_BCFreq2dBackward")):
        names = _graph_nodes(y)
        assert fn in names
        assert not {n for n in names if "Mm" in n or "Fft" in n}, names
    with torch.no_grad():
        assert tops.block_circulant_matmul(x, w).grad_fn is None


def test_backward_reuses_forward_freq_weights():
    """One rfft(w) per forward and none in the backward: the forward's
    (wr, wi) are saved for it."""
    x = _t(_rand((4, 24), 1), True)
    w = _t(_rand((2, 3, 8), 2), True)
    n0 = tops.freq_weights_trace_count()
    y = tops.block_circulant_matmul(x, w)
    assert tops.freq_weights_trace_count() == n0 + 1
    (y ** 2).sum().backward()
    assert tops.freq_weights_trace_count() == n0 + 1
    assert x.grad is not None and w.grad is not None


def test_int8_tables_refuse_gradients_as_the_reference_does():
    """The reference's int8 path is primal-only: jax.grad through it
    raises. The port raises too instead of returning a missing grad; the
    primal value still matches."""
    B, p, q, k = 3, 2, 2, 8
    K = k // 2 + 1
    wr, wi, x = _rand((p, q, K), 1), _rand((p, q, K), 2), _rand((B, q * k), 3)
    sj = jquant.symmetric_scales(jnp.asarray(wr), jnp.asarray(wi))
    qr, qi = (jquant.quantize_symmetric(jnp.asarray(a), sj) for a in (wr, wi))
    fj = lambda x: jops.block_circulant_matmul(
        x, None, w_freq=(qr, qi), w_scale=sj, k=k).sum()
    with pytest.raises(Exception):
        jax.grad(fj)(jnp.asarray(x))
    ts = symmetric_scales(_t(wr), _t(wi))
    tqr, tqi = quantize_symmetric(_t(wr), ts), quantize_symmetric(_t(wi), ts)
    xt = _t(x, True)
    y = tops.block_circulant_matmul(xt, None, w_freq=(tqr, tqi), w_scale=ts,
                                    k=k)
    assert _rel(y.detach(), jops.block_circulant_matmul(
        jnp.asarray(x), None, w_freq=(qr, qi), w_scale=sj, k=k)) <= REL_TOL
    with pytest.raises(NotImplementedError, match="int8"):
        y.sum().backward()
