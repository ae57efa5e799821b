"""Port parity: ``repro_torch.core.lstm.SWMLSTM`` against the JAX
reference on JAX-initialised params (carried across with
``convert.tree_from_reference``) and the same numpy inputs, through each
of its gate paths: the fused 8-table launch (unfrozen, frozen with the
``_fused`` group, frozen per side without it, int8), and the 8-launch path
(x- and recurrent-side block sizes differ, or SWM off). ``impl="pallas"``
runs the reference's Pallas kernel in interpret mode and the port's plain
version of ``bc_matmul``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SWMConfig as JSWM
from repro.core.lstm import SWMLSTM as JLSTM
from repro.kernels.block_circulant import plan as jplan
from repro.nn.module import init_params as jinit
from repro_torch import convert
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.core.lstm import SWMLSTM as TLSTM
from repro_torch.kernels.block_circulant import ops as tops
from repro_torch.kernels.block_circulant import plan as tplan
from repro_torch.nn.module import load_tree
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

# fp32 vs fp32 per launch is 2e-5 (tests/test_conformance.py REL_TOL); the
# recurrence feeds each step's output into the next, so the difference
# compounds over T = 5 steps: 5x the per-launch limit
SEQ_TOL = 1e-4
B, T = 2, 5
FREEZE_TOL = 1e-6       # torch.fft vs jnp.fft rfft of the same f32 table


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _cells(d_in, d_cell, d_proj, block_size, impl):
    kw = dict(block_size=block_size, impl=impl, targets=("lstm",))
    return (JLSTM(d_in=d_in, d_cell=d_cell, d_proj=d_proj, swm=JSWM(**kw)),
            TLSTM(d_in, d_cell, d_proj, swm=TSWM(**kw)))


def _params(jc, seed=0):
    """JAX-initialised params with non-zero biases and peepholes (their
    init is zeros, which would leave those terms untested)."""
    params = jax.tree.map(np.asarray, jinit(jc.specs(), seed))
    rng = np.random.default_rng(seed + 1)
    for key in ("bi", "bf", "bc", "bo", "Wic", "Wfc", "Woc"):
        params[key] = (rng.standard_normal(params[key].shape)
                       * 0.3).astype(np.float32)
    return params


def _run(jc, tc, jtree, xs):
    """Both cells over xs; returns the port's and the reference's
    (ys, yT, cT) as numpy."""
    load_tree(tc, convert.tree_from_reference(
        jax.tree.map(np.asarray, jtree), device="cpu"))
    ys, (yT, cT) = tc(torch.from_numpy(xs))
    jys, (jyT, jcT) = jc(jax.tree.map(jnp.asarray, jtree), jnp.asarray(xs))
    return ((ys.detach().numpy(), yT.detach().numpy(), cT.detach().numpy()),
            (np.asarray(jys), np.asarray(jyT), np.asarray(jcT)))


def _check(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        assert _rel(a, b) <= SEQ_TOL


def _counting(monkeypatch):
    """Count the port's ``bc_matmul`` calls (on the CPU they run its plain
    version; on the card each is one kernel launch)."""
    calls = []
    inner = tops.bc_matmul

    def counted(*args, **kwargs):
        calls.append(args[1].shape)
        return inner(*args, **kwargs)

    monkeypatch.setattr(tops, "bc_matmul", counted)
    return calls


@pytest.mark.parametrize("impl", ("pallas", "freq"))
def test_fused_unfrozen_matches_reference(impl, monkeypatch):
    jc, tc = _cells(24, 32, 16, 8, impl)
    assert tc._fused_gate_k == jc._fused_gate_k == 8
    xs = np.random.default_rng(2).standard_normal((B, T, 24)).astype(
        np.float32)
    calls = _counting(monkeypatch)
    got, want = _run(jc, tc, _params(jc), xs)
    _check(got, want)
    if impl == "pallas":
        # per step: ONE fused gate launch (4·32/8 = 16 p blocks over
        # (24 + 16)/8 = 5 q blocks) and Wym
        assert calls == [(16, 5, 5), (2, 4, 5)] * T
    else:
        assert calls == []


@pytest.mark.parametrize("quantize", ("off", "int8"))
@pytest.mark.parametrize("fused", (True, False))
def test_frozen_matches_reference(quantize, fused, monkeypatch):
    """Frozen trees: with the ``_fused`` group (one stacked table, int8
    scales concatenated beside it) and without it (per-side tables,
    dequantized, then concatenated along q per step)."""
    jc, tc = _cells(24, 32, 16, 8, "pallas")
    params = _params(jc)
    jfrozen = jplan.freeze_params(jc.specs(),
                                  jax.tree.map(jnp.asarray, params),
                                  quantize)
    tfrozen = tplan.freeze_params(
        tc.specs(), convert.tree_from_reference(params, device="cpu"),
        quantize)
    assert (tplan.FUSED_KEY in tfrozen) and (jplan.FUSED_KEY in jfrozen)
    tf = tfrozen[tplan.FUSED_KEY]
    jf = jax.tree.map(np.asarray, jfrozen[jplan.FUSED_KEY])
    assert sorted(tf) == sorted(jf)
    assert tuple(tf["wr"].shape) == (16, 5, 5)
    if quantize == "int8":
        assert tf["wr"].dtype == torch.int8
        assert tuple(tf["w_scale"].shape) == (16, 5)
        # scales of tables from two rffts (torch.fft vs jnp.fft)
        assert _rel(tf["w_scale"], jf["w_scale"]) <= FREEZE_TOL
    if not fused:
        jfrozen = {k: v for k, v in jfrozen.items() if k != jplan.FUSED_KEY}
    xs = np.random.default_rng(3).standard_normal((B, T, 24)).astype(
        np.float32)
    calls = _counting(monkeypatch)
    n0 = tops.freq_weights_trace_count()
    got, want = _run(jc, tc, jfrozen, xs)
    assert tops.freq_weights_trace_count() == n0
    assert [c[:2] for c in calls] == [(16, 5), (2, 4)] * T
    _check(got, want)


@pytest.mark.parametrize("block_size,d_in", [(8, 12), (0, 24)])
def test_eight_launch_path_matches_reference(block_size, d_in, monkeypatch):
    """x side k = 4 and recurrent side k = 8 (not fusable), and SWM off
    (dense): each step runs the projections one by one."""
    jc, tc = _cells(d_in, 32, 16, block_size, "pallas")
    assert tc._fused_gate_k == jc._fused_gate_k == 0
    xs = np.random.default_rng(4).standard_normal((B, T, d_in)).astype(
        np.float32)
    calls = _counting(monkeypatch)
    got, want = _run(jc, tc, _params(jc), xs)
    _check(got, want)
    assert len(calls) == (9 * T if block_size else 0)


def test_step_equals_forward_and_state_carries():
    """Stepwise equals the loop, and a given state resumes it."""
    _, tc = _cells(24, 32, 16, 8, "pallas")
    jc, _ = _cells(24, 32, 16, 8, "pallas")
    load_tree(tc, convert.tree_from_reference(_params(jc), device="cpu"))
    xs = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (B, 2 * T, 24)).astype(np.float32))
    with torch.no_grad():
        ys, (yT, cT) = tc(xs)
        y, c = torch.zeros(B, 16), torch.zeros(B, 32)
        for t in range(2 * T):
            y, c = tc.step(xs[:, t], y, c)
            assert torch.equal(y, ys[:, t])
        ys1, state = tc(xs[:, :T])
        ys2, (yT2, cT2) = tc(xs[:, T:], state)
    assert cT.dtype == torch.float32 and tuple(cT.shape) == (B, 32)
    assert torch.equal(torch.cat([ys1, ys2], 1), ys)
    assert torch.equal(yT2, yT) and torch.equal(cT2, cT)


def test_grads_through_fused_path_match_reference():
    """A loss over the fused unfrozen path: every leaf's grad against
    ``jax.grad`` (dx through ``bc_matmul`` on the transposed tables, dw
    through ``bc_dw``'s plain version)."""
    jc, tc = _cells(24, 32, 16, 8, "pallas")
    params = _params(jc)
    xs = np.random.default_rng(6).standard_normal((B, 3, 24)).astype(
        np.float32)
    jg = jax.grad(lambda p: (jc(p, jnp.asarray(xs))[0] ** 2).sum())(
        jax.tree.map(jnp.asarray, params))
    tree = convert.tree_from_reference(params, device="cpu")
    leaves = []
    for sub in tree.values():
        for t in (sub.values() if isinstance(sub, dict) else [sub]):
            leaves.append(t.requires_grad_(True))
    load_tree(tc, tree)
    loss = (tc(torch.from_numpy(xs))[0] ** 2).sum()
    grads = dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))
    for key, sub in tree.items():
        if isinstance(sub, dict):
            for leaf, t in sub.items():
                assert _rel(grads[id(t)], jg[key][leaf]) <= SEQ_TOL, key
        else:
            assert _rel(grads[id(sub)], jg[key]) <= SEQ_TOL, key
