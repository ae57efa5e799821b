"""Port parity: freezing circulant tables (repro_torch.kernels.
block_circulant.plan) against the JAX reference, leaf by leaf, on the
qwen3 smoke decoder tree (attention with fused QKV, SwiGLU FFN) carried
across with ``repro_torch.convert``."""

import dataclasses

import jax
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
from repro_torch.kernels.block_circulant import ops as tops
from repro_torch.kernels.block_circulant import plan as tplan
from repro_torch.launch.specs import build_model
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

FREEZE_TOL = 1e-6       # torch.fft vs jnp.fft rfft of the same f32 table


@pytest.fixture(scope="module")
def trees():
    jcfg = dataclasses.replace(jq.SMOKE, swm=JSWM(block_size=8,
                                                  impl="pallas"))
    tcfg = dataclasses.replace(tq.SMOKE, swm=TSWM(block_size=8,
                                                  impl="pallas"))
    jm = JLM(jcfg)
    # jitted: the same values as eager init, compiled once
    jparams = jax.jit(lambda: jinit(jm.specs(), 0))()
    np_tree = jax.tree.map(np.asarray, jparams)
    tm = build_model(tcfg, device="cpu")
    return jcfg, tcfg, jm, jparams, tm, convert.from_reference(
        tcfg, np_tree, device="cpu")


def _leaves(tree, path=()):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), np.asarray(v)


def _compare(port_ref_layout, jax_tree, tol):
    a = dict(_leaves(port_ref_layout))
    b = dict(_leaves(jax.tree.map(np.asarray, jax_tree)))
    assert a.keys() == b.keys()
    for path in a:
        x, y = a[path], b[path]
        assert x.shape == y.shape, path
        if tol == 0 or not np.issubdtype(y.dtype, np.floating):
            assert x.dtype == y.dtype and np.array_equal(x, y), path
        else:
            den = max(float(np.max(np.abs(y))), 1e-6)
            assert float(np.max(np.abs(x - y))) / den <= tol, path


def test_convert_round_trip_is_exact(trees):
    from repro.nn.module import param_count as jcount
    from repro_torch.nn.module import param_count as tcount

    jcfg, tcfg, jm, jparams, tm, tparams = trees
    assert len(tparams["layers"]) == tcfg.n_layers
    assert tcount(tm.specs()) == jcount(jm.specs())
    _compare(convert.to_reference(tcfg, tparams), jparams, 0)


def test_freeze_fp32_matches_reference_leaf_by_leaf(trees):
    jcfg, tcfg, jm, jparams, tm, tparams = trees
    jfrozen = jplan.freeze_params(jm.specs(), jparams)
    n0 = tops.freq_weights_trace_count()
    tfrozen = tplan.freeze_params(tm.specs(), tparams)
    n_tables = tplan.count_frozen_tables(tfrozen)
    # q, k, v, o, wi, wu, wo per layer; the reference stacks the layers of
    # a repeated group into one table per projection
    assert n_tables == 7 * tcfg.n_layers
    assert jplan.count_frozen_tables(jfrozen) == 7
    assert tops.freq_weights_trace_count() - n0 == n_tables
    for layer in tfrozen["layers"].values():
        mixer = layer["mixer"]
        assert tplan.FUSED_KEY in mixer
        assert "w" not in mixer["q"] and "wr" in mixer["q"]
    _compare(convert.to_reference(tcfg, tfrozen), jfrozen, FREEZE_TOL)
    # idempotent: a frozen tree comes back as the same object
    assert tplan.freeze_params(tm.specs(), tfrozen) is tfrozen
    assert (tplan.frozen_table_bytes(tfrozen)
            == jplan.frozen_table_bytes(jfrozen))


def test_freeze_int8_matches_reference_exactly(trees):
    """int8 tables and scales are equal when quantized from the same fp32
    frozen tables (the reference's, carried across)."""
    jcfg, tcfg, jm, jparams, tm, tparams = trees
    jfrozen = jplan.freeze_params(jm.specs(), jparams)
    jint8 = jplan.freeze_params(jm.specs(), jfrozen, quantize="int8")
    carried = convert.from_reference(
        tcfg, jax.tree.map(np.asarray, jfrozen), device="cpu")
    n0 = tops.freq_weights_trace_count()
    tint8 = tplan.freeze_params(tm.specs(), carried, quantize="int8")
    assert tops.freq_weights_trace_count() == n0      # no new rfft
    mixer = tint8["layers"]["0"]["mixer"]
    assert mixer["q"]["wr"].dtype == torch.int8
    assert mixer[tplan.FUSED_KEY]["w_scale"].dtype == torch.float32
    _compare(convert.to_reference(tcfg, tint8), jint8, 0)
    assert tplan.freeze_params(tm.specs(), tint8, quantize="int8") is tint8
    assert tplan.freeze_params(tm.specs(), tint8) is tint8
    assert (tplan.frozen_table_bytes(tint8)
            == jplan.frozen_table_bytes(jint8))
    assert (tplan.frozen_table_bytes(tint8)
            < 0.55 * tplan.frozen_table_bytes(carried))
    _compare(convert.to_reference(tcfg, tplan.dequantize_frozen(tint8)),
             jplan.dequantize_frozen(jint8), 0)


def test_freeze_from_time_domain_int8_close_to_reference(trees):
    """Quantizing the port's own rfft tables: scales agree to the rfft
    tolerance and int8 codes to within one step."""
    jcfg, tcfg, jm, jparams, tm, tparams = trees
    jint8 = jax.tree.map(np.asarray,
                         jplan.freeze_params(jm.specs(), jparams, "int8"))
    tint8 = convert.to_reference(
        tcfg, tplan.freeze_params(tm.specs(), tparams, "int8"))
    a, b = dict(_leaves(tint8)), dict(_leaves(jint8))
    assert a.keys() == b.keys()
    for path in a:
        if a[path].dtype == np.int8:
            d = np.abs(a[path].astype(np.int32) - b[path].astype(np.int32))
            assert d.max() <= 1, path
        elif path[-1] == "w_scale":
            np.testing.assert_allclose(a[path], b[path], rtol=FREEZE_TOL)


def test_attach_fused_rejects_mixed_quantization():
    wr = torch.zeros(2, 3, 5)
    grp = {n: {"wr": wr, "wi": wr} for n in ("q", "k", "v")}
    grp["q"]["w_scale"] = torch.ones(2, 3)
    with pytest.raises(ValueError, match="mixes quantized"):
        tplan._attach_fused(grp)
    with pytest.raises(ValueError, match="quantize="):
        tplan.freeze_params({}, {}, quantize="int4")


def test_attach_fused_lstm_gates_matches_reference():
    """The LSTM gate group (x- and recurrent-side tables along q, the four
    gates along p, biases and int8 scales alongside) fuses as in the
    reference."""
    rng = np.random.default_rng(6)
    p, qx, qr, K = 2, 3, 2, 5
    tree = {}
    for g in ("i", "f", "c", "o"):
        for side, q in (("x", qx), ("r", qr)):
            tree[f"W{g}{side}"] = {
                "wr": rng.integers(-127, 128, (p, q, K)).astype(np.int8),
                "wi": rng.integers(-127, 128, (p, q, K)).astype(np.int8),
                "w_scale": rng.random((p, q)).astype(np.float32)}
        tree[f"b{g}"] = rng.standard_normal(p * 5).astype(np.float32)
    jtree = jax.tree.map(jax.numpy.asarray, tree)
    ttree = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)
    assert jplan._attach_fused(jtree) and tplan._attach_fused(ttree)
    for key in ("wr", "wi", "bias", "w_scale"):
        a = ttree[tplan.FUSED_KEY][key].numpy()
        b = np.asarray(jtree[jplan.FUSED_KEY][key])
        assert a.dtype == b.dtype and np.array_equal(a, b), key
    assert not tplan._attach_fused(ttree)        # already fused
