"""Port parity: the Mamba mixer (repro_torch.nn.ssm) against the JAX
package's ``Mamba`` at the jamba smoke config's width with the kernel impl
(the reference's Pallas kernel in interpret mode on the CPU), on the same
numpy params and inputs: without and with the validity mask, without a
cache, from a fresh cache and from a carried one (decode steps), states
included; plus the port's Mamba-specific init kinds."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_52b as jj
from repro.configs.base import SWMConfig as JSWM
from repro.kernels.block_circulant import plan as jplan
from repro.nn.module import init_params as jinit
from repro.nn.ssm import Mamba as JMamba, init_mamba_cache as jcache
from repro_torch.configs import jamba_52b as tj
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.convert import tree_from_reference
from repro_torch.nn.module import ParamSpec, init_params, load_tree
from repro_torch.nn.ssm import Mamba as TMamba, init_mamba_cache as tcache
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

# a mixer's output: in_proj, the conv and scan, x_proj/dt_proj, out_proj in
# sequence; f32 on both sides with sums in other orders, as the decoder
# parity's logits tolerance
MIXER_TOL = 1e-4

JCFG = dataclasses.replace(jj.SMOKE, swm=JSWM(block_size=8, impl="pallas"))
TCFG = dataclasses.replace(tj.SMOKE, swm=TSWM(block_size=8, impl="pallas"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


@pytest.fixture(scope="module")
def params():
    jm = JMamba(JCFG)
    p = jax.jit(lambda: jinit(jm.specs(), 0))()
    return {"unfrozen": p,
            "fp32": jax.jit(lambda p: jplan.freeze_params(jm.specs(), p))(p)}


def _inputs(B=2, S=6, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, JCFG.d_model)).astype(np.float32)
    # row 0 full; row 1 left-padded by two lanes
    mask = np.ones((B, S), bool)
    mask[1, :2] = False
    return x, mask


def _port(jparams):
    tm = TMamba(TCFG)
    load_tree(tm, tree_from_reference(jax.tree.map(np.asarray, jparams),
                                      device="cpu"))
    return tm


def _cache(B):
    m = JMamba(JCFG)
    args = (B, m.d_inner, JCFG.mamba_d_state, JCFG.mamba_d_conv)
    return jcache(*args, jnp.float32), tcache(*args, torch.float32, "cpu")


@pytest.mark.parametrize("mode", ["unfrozen", "fp32"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_mamba_matches_reference(params, mode, masked, cached):
    x, mask = _inputs()
    jm, tm = JMamba(JCFG), _port(params[mode])
    jc, tc = _cache(2) if cached else (None, None)
    jmask = jnp.asarray(mask) if masked else None
    jy, jnew = jax.jit(lambda p, x, c, m: jm(p, x, cache=c, mask=m))(
        params[mode], jnp.asarray(x), jc, jmask)
    with torch.no_grad():
        ty, tnew = tm(torch.from_numpy(x), cache=tc,
                      mask=torch.from_numpy(mask) if masked else None)
    assert _rel(ty.numpy(), jy) <= MIXER_TOL
    if cached:
        for name in ("conv", "ssm"):
            assert _rel(tnew[name].numpy(), jnew[name]) <= MIXER_TOL
    else:
        assert tnew is None and jnew is None


def test_mamba_decode_steps_match_reference(params):
    """A masked prefill into a fresh cache, then three one-token steps
    against the carried conv window and SSM state."""
    x, mask = _inputs()
    jm, tm = JMamba(JCFG), _port(params["fp32"])
    jc, tc = _cache(2)
    step = jax.jit(lambda p, x, c, m: jm(p, x, cache=c, mask=m))
    _, jc = step(params["fp32"], jnp.asarray(x), jc, jnp.asarray(mask))
    with torch.no_grad():
        tm(torch.from_numpy(x), cache=tc, mask=torch.from_numpy(mask))
    for i in range(3):
        xt, _ = _inputs(2, 1, seed=10 + i)
        valid = np.ones((2, 1), bool)
        jy, jc = step(params["fp32"], jnp.asarray(xt), jc,
                      jnp.asarray(valid))
        with torch.no_grad():
            ty, _ = tm(torch.from_numpy(xt), cache=tc,
                       mask=torch.from_numpy(valid))
        assert _rel(ty.numpy(), jy) <= MIXER_TOL
        for name in ("conv", "ssm"):
            assert _rel(tc[name].numpy(), jc[name]) <= MIXER_TOL


def test_masked_padded_row_matches_unpadded_run(params):
    """Pad lanes contribute nothing: the left-padded row's real positions
    and final state equal the same tokens run alone without padding."""
    x, mask = _inputs()
    tm = _port(params["fp32"])
    _, tc = _cache(2)
    _, tc1 = _cache(1)
    with torch.no_grad():
        y, _ = tm(torch.from_numpy(x), cache=tc, mask=torch.from_numpy(mask))
        y1, _ = tm(torch.from_numpy(x[1:, 2:]), cache=tc1)
    assert _rel(y[1, 2:].numpy(), y1[0].numpy()) <= MIXER_TOL
    for name in ("conv", "ssm"):
        assert _rel(tc[name][1].numpy(), tc1[name][0].numpy()) <= MIXER_TOL


def test_mamba_specs_mirror_reference():
    jspec = JMamba(JCFG).specs()
    tspec = TMamba(TCFG).specs()

    def shapes(tree, leaf):
        return {k: shapes(v, leaf) if isinstance(v, dict) else leaf(v)
                for k, v in tree.items()}

    assert shapes(tspec, lambda s: s.shape) == shapes(jspec, lambda s: s.shape)


def test_a_log_init_is_the_reference_rule():
    """``mamba_a_log`` gives log(1..d_state) on every row, the reference's
    initializer, and the port's random init uses it. XLA's and ATen's f32
    log may round one value to neighbouring floats (log 7 does), so the
    two are held to one f32 ulp."""
    m = JMamba(JCFG)
    ref = np.asarray(jinit(m.specs(), 3)["A_log"])
    got = init_params({"a": ParamSpec(ref.shape, torch.float32,
                                      init="mamba_a_log")}, 0, "cpu")["a"]
    np.testing.assert_allclose(got.numpy(), ref, rtol=2.0 ** -23, atol=0)
    assert np.array_equal(got.numpy()[0], got.numpy()[-1])
    tm = TMamba(TCFG)
    assert torch.equal(init_params(tm.specs(), 5, "cpu")["A_log"], got)


def test_uniform_init_range_and_spread():
    """``uniform`` draws from [-scale, scale) like the reference's
    ``jax.random.uniform`` (mean 0, variance scale²/3)."""
    got = init_params({"u": ParamSpec((200, 100), torch.float32,
                                      init="uniform", scale=0.5)}, 0,
                      "cpu")["u"]
    assert float(got.min()) >= -0.5 and float(got.max()) < 0.5
    assert abs(float(got.mean())) < 0.01
    assert abs(float(got.var()) - 0.25 / 3) < 0.005
