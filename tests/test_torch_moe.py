"""Port parity: the MoE layer (repro_torch.nn.moe) and the grouped
block-circulant launch its experts run through, against the JAX package's
``MoE`` and its Pallas kernel under ``jax.vmap`` (interpret mode on the
CPU), on the same numpy params and inputs.

Covers: the serving dispatch (``no_drop``) and the capacity drop path with
their aux losses, at the jamba smoke config's MoE width; router rows with
exact ties (``lax.top_k`` picks the lower index); the grouped
``bc_matmul_plain`` against G separate plain calls in f32 and int8, and
against the dense oracle; the grouped op against the reference's vmapped
kernel; ``freeze_params`` over expert-stacked tables; the grouped int8
path's refusal of gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_52b as jj
from repro.configs.base import SWMConfig as JSWM
from repro.core import circulant as jcirc
from repro.kernels.block_circulant import plan as jplan
from repro.nn.module import init_params as jinit
from repro.nn.moe import MoE as JMoE
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.convert import tree_from_reference
from repro_torch.core.circulant import blocks_to_dense
from repro_torch.core.quant import quantize_symmetric, symmetric_scales
from repro_torch.kernels.block_circulant import kernel as tkernel
from repro_torch.kernels.block_circulant import ops as tops
from repro_torch.kernels.block_circulant import plan as tplan
from repro_torch.nn.module import load_tree, module_tree
from repro_torch.nn.moe import MoE as TMoE, top_k_lower_index
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # one f32 projection (tests/test_conformance.py)
# a MoE layer's output passes three projections in sequence (wi/wu, wo)
# after the router; f32 on both sides, sums in other orders (XLA vs ATen,
# kernel vs plain version), as the decoder parity's logits tolerance
MOE_TOL = 1e-4

CFG = jj.SMOKE
E, T, D, DFF = CFG.n_experts, CFG.n_experts_per_token, CFG.d_model, \
    CFG.d_ff_expert


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _jmoe(impl="pallas", cf=1.25):
    return JMoE(d_model=D, d_ff=DFF, n_experts=E, top_k=T,
                capacity_factor=cf, swm=JSWM(block_size=8, impl=impl),
                dtype="float32")


def _tmoe(impl="pallas", cf=1.25):
    return TMoE(D, DFF, E, T, cf, swm=TSWM(block_size=8, impl=impl),
                dtype="float32")


@pytest.fixture(scope="module")
def params():
    jm = _jmoe()
    p = jax.jit(lambda: jinit(jm.specs(), 0))()
    frozen = jplan.freeze_params(jm.specs(), p)
    int8 = jplan.freeze_params(jm.specs(), frozen, "int8")
    return {"unfrozen": p, "fp32": frozen, "int8": int8}


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, D)).astype(np.float32)


def _run_both(jparams, x, no_drop, impl="pallas", cf=1.25):
    jm = _jmoe(impl, cf)
    jy, jaux = jax.jit(lambda p, x: jm(p, x, no_drop=no_drop))(
        jparams, jnp.asarray(x))
    tm = _tmoe(impl, cf)
    load_tree(tm, tree_from_reference(jax.tree.map(np.asarray, jparams),
                                      device="cpu"))
    with torch.no_grad():
        ty, taux = tm(torch.from_numpy(x), no_drop=no_drop)
    return (np.asarray(jy), float(jaux)), (ty.numpy(), float(taux))


# the drop path at a capacity factor that drops: 3 x 5 tokens x 2 slots
# over 4 experts is 7.5 per expert on average, and capacity 0.5 x 7.5
# keeps 3
DROP_CF = 0.5


@pytest.mark.parametrize("mode", ["unfrozen", "fp32", "int8"])
@pytest.mark.parametrize("no_drop,cf", [(True, 1.25), (False, 1.25),
                                        (False, DROP_CF)])
def test_moe_matches_reference(params, mode, no_drop, cf):
    """Serving dispatch and the drop path, output and aux loss."""
    x = _x(3, 5, 1)
    (jy, jaux), (ty, taux) = _run_both(params[mode], x, no_drop, cf=cf)
    assert _rel(ty, jy) <= MOE_TOL
    assert abs(taux - jaux) <= REL_TOL * abs(jaux)


def test_drop_path_drops(params):
    """The drop-path case above really drops: some token's slot lands past
    its expert's capacity, so its output differs from the no-drop one."""
    tm = _tmoe(cf=DROP_CF)
    load_tree(tm, tree_from_reference(jax.tree.map(
        np.asarray, params["unfrozen"]), device="cpu"))
    x = torch.from_numpy(_x(3, 5, 1))
    assert tm.capacity(15, False) == 3 and tm.capacity(15, True) == 15
    with torch.no_grad():
        y_drop, _ = tm(x, no_drop=False)
        y_all, _ = tm(x, no_drop=True)
    assert not torch.equal(y_drop, y_all)


@pytest.mark.parametrize("impl", ["paper", "freq"])
def test_moe_other_impls_match_reference(params, impl):
    """Without the kernel impl the stacked experts run expert by expert,
    as the reference's vmap does."""
    (jy, jaux), (ty, taux) = _run_both(params["unfrozen"], _x(2, 4, 2),
                                       True, impl=impl)
    assert _rel(ty, jy) <= MOE_TOL
    assert abs(taux - jaux) <= REL_TOL * abs(jaux)


def _tied_probs():
    """Rows with exact ties at and around the top-k boundary."""
    return np.asarray([[0.25, 0.25, 0.25, 0.25],
                       [0.1, 0.3, 0.3, 0.3],
                       [0.4, 0.2, 0.2, 0.2],
                       [0.2, 0.2, 0.4, 0.2],
                       [0.0, 0.5, 0.0, 0.5]], np.float32)


def test_top_k_breaks_ties_like_lax_top_k():
    probs = _tied_probs()
    jv, ji = jax.lax.top_k(jnp.asarray(probs), T)
    tv, ti = top_k_lower_index(torch.from_numpy(probs), T)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(tv.numpy(), np.asarray(jv))
    assert ti[0].tolist() == [0, 1] and ti[1].tolist() == [1, 2]


@pytest.mark.parametrize("no_drop", [True, False])
def test_moe_exact_tie_router_matches_reference(params, no_drop):
    """A zero router gives every token the same uniform probabilities:
    every row is an exact E-way tie, resolved toward experts 0 and 1."""
    tree = jax.tree.map(np.asarray, params["fp32"])
    tree["router"]["w"] = np.zeros_like(tree["router"]["w"])
    x = _x(2, 3, 3)
    (jy, jaux), (ty, taux) = _run_both(tree, x, no_drop)
    assert _rel(ty, jy) <= MOE_TOL
    assert abs(taux - jaux) <= REL_TOL * abs(jaux)


# ---------------------------------------------------------------------------
# The grouped launch's plain version and op
# ---------------------------------------------------------------------------


def _stacked(G, p, q, k, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((G, p, q, k)) / np.sqrt(q * k)).astype(
        np.float32)
    wf = np.fft.rfft(w.astype(np.float64), axis=-1)
    return (torch.from_numpy(w), torch.from_numpy(wf.real.astype(np.float32)),
            torch.from_numpy(wf.imag.astype(np.float32)))


@pytest.mark.parametrize("G,B,p,q,k", [(4, 5, 3, 2, 8), (3, 1, 2, 4, 7),
                                       (16, 4, 3, 2, 16)])
@pytest.mark.parametrize("quant", [False, True])
def test_grouped_plain_is_g_separate_calls(G, B, p, q, k, quant):
    """The grouped plain version equals G separate plain calls bit for
    bit, f32 and int8 tables, with bias and activation."""
    _, wr, wi = _stacked(G, p, q, k, G + k)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((G, B, q * k)).astype(
        np.float32))
    bias = torch.from_numpy(rng.standard_normal((G, p * k)).astype(
        np.float32))
    sc = None
    if quant:
        sc = symmetric_scales(wr, wi)
        wr, wi = quantize_symmetric(wr, sc), quantize_symmetric(wi, sc)
    y = tkernel.bc_matmul(x, wr, wi, bias, sc, k=k, activation="gelu")
    assert y.shape == (G, B, p * k)
    for g in range(G):
        yg = tkernel.bc_matmul_plain(x[g], wr[g], wi[g], bias[g],
                                     None if sc is None else sc[g], k=k,
                                     activation="gelu")
        assert torch.equal(y[g], yg)


def test_grouped_plain_matches_dense_oracle():
    G, B, p, q, k = 4, 6, 3, 5, 8
    w, wr, wi = _stacked(G, p, q, k, 9)
    x = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (G, B, q * k)).astype(np.float32))
    y = tkernel.bc_matmul_plain(x, wr, wi, k=k)
    ref = torch.stack([x[g].double() @ blocks_to_dense(w[g]).double().T
                       for g in range(G)])
    assert _rel(y.numpy(), ref.numpy()) <= REL_TOL


@pytest.mark.parametrize("frozen", [False, True])
def test_grouped_op_matches_vmapped_reference(frozen):
    """``ops.block_circulant_matmul`` with stacked tables against the
    reference's single-projection kernel under ``jax.vmap`` (the MoE's
    expert axis), x with extra leading dims."""
    G, p, q, k = 4, 3, 2, 8
    w, wr, wi = _stacked(G, p, q, k, 5)
    x = np.random.default_rng(3).standard_normal((G, 2, 3, q * k)).astype(
        np.float32)
    bias = np.random.default_rng(4).standard_normal((G, p * k)).astype(
        np.float32)

    def one(w_, wr_, wi_, b_, x_):
        return jcirc.block_circulant_apply_fused(
            x_, None if frozen else w_, impl="pallas", bias=b_,
            activation="relu", w_freq=(wr_, wi_) if frozen else None, k=k)

    jy = jax.vmap(one)(*(jnp.asarray(a.numpy()) for a in (w, wr, wi)),
                       jnp.asarray(bias), jnp.asarray(x))
    ty = tops.block_circulant_matmul(
        torch.from_numpy(x), None if frozen else w,
        bias=torch.from_numpy(bias), activation="relu",
        w_freq=(wr, wi) if frozen else None, k=k)
    assert ty.shape == (G, 2, 3, p * k)
    assert _rel(ty.numpy(), np.asarray(jy)) <= REL_TOL


def test_grouped_op_refuses_gradients():
    """Stacked int8 tables are primal-only, as the reference's
    ``_bc_freq_quant2d`` under ``jax.vmap``: a gradient through them
    raises. (Stacked f32 tables carry gradients through the grouped
    backward: ``tests/test_torch_grouped_backward.py``.)"""
    G, p, q, k = 2, 2, 2, 8
    _, wr, wi = _stacked(G, p, q, k, 6)
    sc = symmetric_scales(wr, wi)
    qr, qi = quantize_symmetric(wr, sc), quantize_symmetric(wi, sc)
    x = torch.zeros(G, 3, q * k, requires_grad=True)
    y = tops.block_circulant_matmul(x, None, w_freq=(qr, qi), w_scale=sc,
                                    k=k)
    with pytest.raises(NotImplementedError, match="no gradient"):
        y.sum().backward()
    with torch.no_grad():
        tops.block_circulant_matmul(x, None, w_freq=(qr, qi), w_scale=sc,
                                    k=k)
    with pytest.raises(ValueError, match="groups"):
        tops.block_circulant_matmul(torch.zeros(G + 1, 3, q * k), None,
                                    w_freq=(wr, wi), k=k)


@pytest.mark.parametrize("quantize", ["off", "int8"])
def test_freeze_params_with_expert_axes(params, quantize):
    """Expert-stacked tables freeze to (E, p, q, K), int8 to (E, p, q)
    scales, the same values as the reference; no fused group spans
    experts."""
    jm = _jmoe()
    jt = jax.tree.map(np.asarray, jplan.freeze_params(
        jm.specs(), params["unfrozen"], quantize))
    tm = _tmoe()
    load_tree(tm, tree_from_reference(jax.tree.map(
        np.asarray, params["unfrozen"]), device="cpu"))
    tt = tplan.freeze_params(tm.specs(), module_tree(tm), quantize)
    assert tplan.FUSED_KEY not in tt["experts"]
    for name in ("wi", "wu", "wo"):
        got, ref = tt["experts"][name], jt["experts"][name]
        assert sorted(got) == sorted(ref)
        assert got["wr"].shape[0] == E and got["wr"].dim() == 4
        if quantize == "int8":
            assert got["w_scale"].shape == got["wr"].shape[:3]
            assert np.allclose(got["w_scale"].numpy(), ref["w_scale"],
                               rtol=1e-6, atol=0)
            # int8 codes may differ by one where |w|/scale sits on a .5
            assert np.abs(got["wr"].numpy().astype(np.int32)
                          - ref["wr"].astype(np.int32)).max() <= 1
        else:
            for leaf in ("wr", "wi"):
                assert _rel(got[leaf].numpy(), ref[leaf]) <= REL_TOL
    # per-expert quantisation: expert e's scales are its own table's
    if quantize == "int8":
        f32 = tplan.freeze_params(tm.specs(), module_tree(tm))["experts"]
        fr, fi = f32["wi"]["wr"], f32["wi"]["wi"]
        got = tt["experts"]["wi"]
        for e in range(E):
            sc = symmetric_scales(fr[e], fi[e])
            assert torch.equal(got["w_scale"][e], sc)
            assert torch.equal(got["wr"][e], quantize_symmetric(fr[e], sc))
