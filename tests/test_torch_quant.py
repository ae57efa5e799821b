"""Port parity: the fixed-point family of ``repro_torch.core.quant``
(``fixed_point``, ``quantize_tree``, ``default_exempt``) and
``fake_quant_symmetric``, against the JAX reference on the same numpy
inputs. Both sides compute ``round-half-even(x·2^f)/2^f`` on f32, so the
forwards are held bit for bit; the clipped straight-through gradients are
masks times the cotangent, so they are bit-identical too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")


def _grid_probe(bits, frac, n=4096, seed=0):
    """Values across and past the rails, with exact half-quanta (where
    round-half-even decides) and the rails themselves."""
    lo, hi = jq._rails(bits, frac)
    rng = np.random.default_rng(seed + bits)
    x = rng.uniform(lo * 1.5, hi * 1.5, size=n).astype(np.float32)
    halves = (rng.integers(-2 ** (bits - 1), 2 ** (bits - 1), size=64)
              + 0.5) / 2.0 ** frac
    return np.concatenate([x, halves.astype(np.float32),
                           np.asarray([lo, hi, lo - 1, hi + 1, 0.0],
                                      np.float32)])


@pytest.mark.parametrize("bits", (8, 12, 16))
def test_fixed_point_forward_bit_identical(bits):
    frac = bits - 4
    x = _grid_probe(bits, frac)
    want = np.asarray(jq.fixed_point(jnp.asarray(x), bits, frac))
    got = tq.fixed_point(torch.from_numpy(x), bits, frac).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("bits", (8, 12, 16))
def test_fixed_point_clipped_ste_matches_reference(bits):
    """The mirror of ``tests/test_paper_models.py``'s bit-width sweep:
    the gradient is the cotangent inside [lo, hi] and zero outside, and
    ``quantize_tree`` inherits it."""
    frac = bits - 4
    lo, hi = tq._rails(bits, frac)
    assert (lo, hi) == jq._rails(bits, frac)
    x = np.asarray([lo - 1.0, lo, lo / 2, 0.0, hi / 2, hi, hi + 1.0],
                   np.float32)
    t = np.asarray([3.0, -2.0, 1.0, 5.0, -1.0, 2.0, 4.0], np.float32)
    expect = t * np.asarray([0, 1, 1, 1, 1, 1, 0], np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (tq.fixed_point(xt, bits, frac) * torch.from_numpy(t)).sum().backward()
    np.testing.assert_array_equal(xt.grad.numpy(), expect)
    jg = jax.grad(lambda v: (jq.fixed_point(v, bits, frac) * t).sum())(
        jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(jg))
    q = tq.fixed_point(torch.from_numpy(x), bits, frac)
    assert float(q[0]) == lo and float(q[-1]) == hi
    xt2 = torch.from_numpy(x).requires_grad_(True)
    (tq.quantize_tree({"w": xt2}, bits, frac)["w"]
     * torch.from_numpy(t)).sum().backward()
    np.testing.assert_array_equal(xt2.grad.numpy(), expect)


def test_fixed_point_on_other_dtypes_matches_reference():
    """bf16 rounds in f32 and casts back; int8 (a frozen int8 table under
    ``SWMMLP(quant_bits=12)``) clips to the rails and truncates, so
    ``fixed_point(int8 100) == 7`` on both sides."""
    rng = np.random.default_rng(3)
    x8 = rng.integers(-128, 128, size=257).astype(np.int8)
    want = np.asarray(jq.fixed_point(jnp.asarray(x8), 12, 8))
    got = tq.fixed_point(torch.from_numpy(x8), 12, 8)
    assert got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(tq.fixed_point(torch.tensor([100], dtype=torch.int8),
                              12, 8)[0]) == 7
    xb = rng.standard_normal(512).astype(np.float32) * 4
    want = np.asarray(jq.fixed_point(jnp.asarray(xb, jnp.bfloat16), 12, 8)
                      .astype(jnp.float32))
    got = tq.fixed_point(torch.from_numpy(xb).bfloat16(), 12, 8)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)


NAMES = ["bias", "scale", "w_scale", "gamma", "beta", "b", "b0", "bi", "bfo",
         "bias2", "out_b", "w", "wr", "wi", "table", "Wic", "fb0", "fc0",
         "bq_x", "norm_b", ""]


@pytest.mark.parametrize("name", NAMES)
def test_default_exempt_matches_reference(name):
    path = ("layers", "0", name) if name else ()
    assert tq.default_exempt(path) == jq.default_exempt(path)


def _tree(seed):
    rng = np.random.default_rng(seed)
    f = lambda *s: (rng.standard_normal(s) * 3).astype(np.float32)
    return {"w": f(4, 6), "b0": f(6), "scale": f(6),
            "wc": (f(3, 5) + 1j * f(3, 5)).astype(np.complex64),
            "idx": rng.integers(-50, 50, size=(7,)).astype(np.int32),
            "sub": {"bias": f(5), "out_b": f(2), "wr": f(2, 3, 5),
                    "w8": rng.integers(-128, 128, size=(9,)).astype(np.int8)}}


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


@pytest.mark.parametrize("exempt", [None, "default"])
def test_quantize_tree_bit_identical_with_complex_and_int_leaves(exempt):
    np_tree = _tree(5)
    ex_j = jq.default_exempt if exempt else None
    ex_t = tq.default_exempt if exempt else None
    want = jq.quantize_tree(jax.tree.map(jnp.asarray, np_tree), 12, 8,
                            exempt=ex_j)
    t_tree = jax.tree.map(torch.from_numpy, np_tree)
    got = tq.quantize_tree(t_tree, 12, 8, exempt=ex_t)
    want = dict(_walk(jax.tree.map(np.asarray, want)))
    got = dict(_walk(jax.tree.map(lambda t: t.numpy(), got,
                                  is_leaf=lambda v: isinstance(
                                      v, torch.Tensor))))
    assert got.keys() == want.keys()
    for path in got:
        assert got[path].dtype == want[path].dtype, path
        np.testing.assert_array_equal(got[path], want[path], err_msg=path)
    # the complex leaf really was quantized, the int leaves passed through
    assert not np.array_equal(got[("wc",)], np_tree["wc"])
    np.testing.assert_array_equal(got[("idx",)], np_tree["idx"])
    if exempt:
        np.testing.assert_array_equal(got[("sub", "bias")],
                                      np_tree["sub"]["bias"])


def test_quantize_tree_leaves_input_tree_alone():
    t = {"w": torch.full((3,), 0.123)}
    out = tq.quantize_tree(t, 8, 4)
    assert out is not t and out["w"] is not t["w"]
    assert float(t["w"][0]) == pytest.approx(0.123)


@pytest.mark.parametrize("bits", (4, 8))
def test_fake_quant_symmetric_matches_reference(bits):
    rng = np.random.default_rng(bits)
    wr = rng.standard_normal((3, 4, 9)).astype(np.float32)
    wi = rng.standard_normal((3, 4, 9)).astype(np.float32)
    jr, ji, js = jq.fake_quant_symmetric(jnp.asarray(wr), jnp.asarray(wi),
                                         bits)
    tr_ = torch.from_numpy(wr).requires_grad_(True)
    ti_ = torch.from_numpy(wi).requires_grad_(True)
    gr, gi, gs = tq.fake_quant_symmetric(tr_, ti_, bits)
    for a, b in ((gr, jr), (gi, ji), (gs, js)):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))
    assert not gs.requires_grad
    # the int8 freeze's dequantized tables, bit for bit
    s = tq.symmetric_scales(tr_.detach(), ti_.detach(), bits)
    np.testing.assert_array_equal(
        gr.detach().numpy(),
        tq.dequantize_symmetric(tq.quantize_symmetric(tr_.detach(), s,
                                                      bits), s).numpy())
    t = rng.standard_normal(wr.shape).astype(np.float32)
    (gr * torch.from_numpy(t) + gi * 2).sum().backward()
    jgr, jgi = jax.grad(
        lambda a, b: (jq.fake_quant_symmetric(a, b, bits)[0] * t
                      + jq.fake_quant_symmetric(a, b, bits)[1] * 2).sum(),
        argnums=(0, 1))(jnp.asarray(wr), jnp.asarray(wi))
    np.testing.assert_array_equal(tr_.grad.numpy(), np.asarray(jgr))
    np.testing.assert_array_equal(ti_.grad.numpy(), np.asarray(jgi))
