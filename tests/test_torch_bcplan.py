"""Port parity: the frozen-plan objects (``repro_torch.kernels.
block_circulant.plan``: ``BCPlan``, ``build_plan``, ``build_multi_plan``)
and the capture probes of ``ops`` (``count_kernel_launches``,
``outer_mm_shapes``) against the JAX package's.

The same numpy tables and inputs go through the reference's plan (its
Pallas kernel in interpret mode on the CPU) and the port's (the plain
version of ``bc_matmul`` on the CPU): f32 plans to ``REL_TOL = 2e-5``, int8
plans bit for bit against the port's f32 plan on the dequantized tables
(and to the reference's int8 plan at ``REL_TOL``). A plan is one launch and
holds no transform; the probes read captures as the reference's read
jaxprs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.block_circulant import build_multi_plan as jbuild_multi
from repro.kernels.block_circulant import build_plan as jbuild
from repro.kernels.block_circulant.ops import (count_pallas_launches,
                                               outer_dot_shapes)
from repro_torch.analysis.walker import capture
from repro_torch.core.quant import dequantize_symmetric
from repro_torch.kernels.block_circulant import (BCPlan, build_multi_plan,
                                                 build_plan)
from repro_torch.kernels.block_circulant.ops import (count_kernel_launches,
                                                     outer_mm_shapes)
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5


def _np(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("act,bias", [("none", False), ("gelu", True)])
def test_build_plan_matches_reference(act, bias):
    p, q, k = 3, 4, 8
    w = _np((p, q, k), 0, (q * k) ** -0.5)
    b = _np((p * k,), 1) if bias else None
    x = _np((5, q * k), 2)
    jp = jbuild(jnp.asarray(w), bias=None if b is None else jnp.asarray(b),
                activation=act)
    tp = build_plan(_t(w), bias=None if b is None else _t(b),
                    activation=act)
    assert isinstance(tp, BCPlan)
    assert (tp.in_dim, tp.out_dim, tp.n_projections, tp.quantized) == (
        jp.in_dim, jp.out_dim, jp.n_projections, jp.quantized)
    assert tp.cache_key() == jp.cache_key()
    assert tp.table_bytes() == 2 * p * q * (k // 2 + 1) * 4
    assert _rel(tp(_t(x)), jp.apply(jnp.asarray(x))) <= REL_TOL
    # leading batch dims pass through
    x3 = _np((2, 3, q * k), 3)
    assert _rel(tp.apply(_t(x3)), jp.apply(jnp.asarray(x3))) <= REL_TOL


def test_build_multi_plan_matches_reference():
    q, k = 4, 8
    ws = [_np((p, q, k), 10 + p, 0.3) for p in (2, 3, 1)]
    bs = [_np((2 * k,), 20), None, _np((1 * k,), 21)]
    x = _np((6, q * k), 22)
    jp = jbuild_multi([jnp.asarray(w) for w in ws],
                      biases=[None if b is None else jnp.asarray(b)
                              for b in bs], activation="relu")
    tp = build_multi_plan([_t(w) for w in ws],
                          biases=[None if b is None else _t(b) for b in bs],
                          activation="relu")
    assert tp.splits == tuple(jp.splits) == (2, 3, 1)
    outs_t, outs_j = tp.apply_multi(_t(x)), jp.apply_multi(jnp.asarray(x))
    assert len(outs_t) == 3
    for a, b in zip(outs_t, outs_j):
        assert a.shape == b.shape and _rel(a, b) <= REL_TOL
    with pytest.raises(ValueError, match="share"):
        build_multi_plan([_t(ws[0]), torch.zeros(2, 3, 8)])


def test_int8_plans():
    p, q, k = 4, 3, 8
    ws = [_np((p, q, k), 30 + i, 0.2) for i in range(2)]
    x = _np((7, q * k), 33)
    tq = build_multi_plan([_t(w) for w in ws], quantize="int8")
    assert tq.quantized and tq.wr.dtype == torch.int8
    assert tq.scale.shape == (2 * p, q) and tq.scale.dtype == torch.float32
    assert tq.cache_key()[-1] == "int8"
    # bit for bit against the f32 plan on the dequantized tables
    deq = BCPlan(wr=dequantize_symmetric(tq.wr, tq.scale),
                 wi=dequantize_symmetric(tq.wi, tq.scale), bias=None,
                 k=k, p=2 * p, q=q, splits=tq.splits)
    assert torch.equal(tq(_t(x)), deq(_t(x)))
    jq = jbuild_multi([jnp.asarray(w) for w in ws], quantize="int8")
    np.testing.assert_array_equal(tq.wr.numpy(), np.asarray(jq.wr))
    np.testing.assert_array_equal(tq.scale.numpy(), np.asarray(jq.scale))
    for a, b in zip(tq.apply_multi(_t(x)), jq.apply_multi(jnp.asarray(x))):
        assert _rel(a, b) <= REL_TOL
    with pytest.raises(ValueError, match="quantize"):
        build_plan(_t(ws[0]), quantize="int4")


def test_plan_is_one_launch_and_no_transform():
    """The probes on captures, as the reference's on jaxprs: a plan's
    forward is one kernel launch with no fft and no outer contraction
    (the plain version's matmuls stay inside the op)."""
    p, q, k = 3, 3, 8
    w = _np((p, q, k), 40)
    x = _np((4, q * k), 41)
    tp = build_plan(_t(w))
    trace = capture(tp.apply, _t(x), pure=[tp.wr, tp.wi])
    jx = jax.make_jaxpr(jbuild(jnp.asarray(w)).apply)(jnp.asarray(x))
    assert count_kernel_launches(trace) == count_pallas_launches(jx) == 1
    assert outer_mm_shapes(trace) == outer_dot_shapes(jx) == []
    assert not any("fft" in op.name for op in trace)
    # a dense contraction outside the kernel is seen by both probes
    dense = capture(lambda a: a @ a.T, _t(x))
    jd = jax.make_jaxpr(lambda a: a @ a.T)(jnp.asarray(x))
    assert outer_mm_shapes(dense) == outer_dot_shapes(jd) == [(4, 4)]
    # two applies, two launches
    twice = capture(lambda a: tp(tp(a) * 0 + a), _t(x))
    assert count_kernel_launches(twice) == 2
