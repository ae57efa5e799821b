"""Port parity: the RWKV-6 time mix and channel mix (repro_torch.nn.rwkv)
against the JAX package's ``RWKV6TimeMix``/``RWKV6ChannelMix`` at the
rwkv6 smoke config's width with the kernel impl (the reference's Pallas
kernel in interpret mode on the CPU), on the same numpy params and inputs:
without and with the validity mask (token shift under left padding, pad
steps skipped), without a cache, from a fresh cache and over carried
decode steps, states included."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import rwkv6_7b as jr
from repro.configs.base import SWMConfig as JSWM
from repro.kernels.block_circulant import plan as jplan
from repro.nn.module import init_params as jinit
from repro.nn import rwkv as jrwkv
from repro_torch.configs import rwkv6_7b as tr
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.convert import tree_from_reference
from repro_torch.nn import rwkv as trwkv
from repro_torch.nn.module import load_tree
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

# a mix's output passes several projections and the f32 WKV recurrence;
# sums in other orders on the two sides, as the decoder parity's logits
MIXER_TOL = 1e-4

JCFG = dataclasses.replace(jr.SMOKE, swm=JSWM(block_size=8, impl="pallas"))
TCFG = dataclasses.replace(tr.SMOKE, swm=TSWM(block_size=8, impl="pallas"))
MIXES = {"time": (jrwkv.RWKV6TimeMix, trwkv.RWKV6TimeMix,
                  ("shift_att", "wkv")),
         "channel": (jrwkv.RWKV6ChannelMix, trwkv.RWKV6ChannelMix,
                     ("shift_ffn",))}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


@pytest.fixture(scope="module")
def params():
    out = {}
    for name, (jcls, _, _) in MIXES.items():
        jm = jcls(JCFG)
        p = jax.jit(lambda jm=jm: jinit(jm.specs(), 0))()
        out[name, "unfrozen"] = p
        out[name, "fp32"] = jplan.freeze_params(jm.specs(), p)
        out[name, "int8"] = jplan.freeze_params(jm.specs(), p, "int8")
    return out


def _inputs(B=2, S=6, seed=1):
    x = np.random.default_rng(seed).standard_normal(
        (B, S, JCFG.d_model)).astype(np.float32)
    mask = np.ones((B, S), bool)
    mask[1, :3] = False
    return x, mask


def _caches(B):
    H = JCFG.d_model // JCFG.rwkv_head_dim
    args = (B, JCFG.d_model, H, JCFG.rwkv_head_dim)
    return (jrwkv.init_rwkv_cache(*args, jnp.float32),
            trwkv.init_rwkv_cache(*args, torch.float32, "cpu"))


def _both(name, jparams):
    jcls, tcls, keys = MIXES[name]
    tm = tcls(TCFG)
    load_tree(tm, tree_from_reference(jax.tree.map(np.asarray, jparams),
                                      device="cpu"))
    return jcls(JCFG), tm, keys


@pytest.mark.parametrize("mix", sorted(MIXES))
@pytest.mark.parametrize("mode", ["unfrozen", "fp32", "int8"])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("cached", [False, True])
def test_mix_matches_reference(params, mix, mode, masked, cached):
    x, mask = _inputs()
    jm, tm, keys = _both(mix, params[mix, mode])
    jc, tc = _caches(2) if cached else (None, None)
    jmask = jnp.asarray(mask) if masked else None
    jy, jnew = jax.jit(lambda p, x, c, m: jm(p, x, cache=c, mask=m))(
        params[mix, mode], jnp.asarray(x), jc, jmask)
    with torch.no_grad():
        ty, _ = tm(torch.from_numpy(x), cache=tc,
                   mask=torch.from_numpy(mask) if masked else None)
    assert _rel(ty.numpy(), jy) <= MIXER_TOL
    if cached:
        for key in keys:
            assert _rel(tc[key].numpy(), jnew[key]) <= MIXER_TOL


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_decode_steps_match_reference(params, mix):
    """A masked prefill into a fresh cache, then three one-token steps
    against the carried shift and WKV states."""
    x, mask = _inputs()
    jm, tm, keys = _both(mix, params[mix, "fp32"])
    jc, tc = _caches(2)
    step = jax.jit(lambda p, x, c, m: jm(p, x, cache=c, mask=m))

    def merge(c, new):
        return {**c, **new}

    _, new = step(params[mix, "fp32"], jnp.asarray(x), jc, jnp.asarray(mask))
    jc = merge(jc, new)
    with torch.no_grad():
        tm(torch.from_numpy(x), cache=tc, mask=torch.from_numpy(mask))
    for i in range(3):
        xt, _ = _inputs(2, 1, seed=20 + i)
        valid = np.ones((2, 1), bool)
        jy, new = step(params[mix, "fp32"], jnp.asarray(xt), jc,
                       jnp.asarray(valid))
        jc = merge(jc, new)
        with torch.no_grad():
            ty, _ = tm(torch.from_numpy(xt), cache=tc,
                       mask=torch.from_numpy(valid))
        assert _rel(ty.numpy(), jy) <= MIXER_TOL
        for key in keys:
            assert _rel(tc[key].numpy(), jc[key]) <= MIXER_TOL


@pytest.mark.parametrize("mix", sorted(MIXES))
def test_masked_padded_row_matches_unpadded_run(params, mix):
    """The left-padded row's real positions and final states equal the
    same tokens run alone: pad x enters no token shift and no WKV step."""
    x, mask = _inputs()
    _, tm, keys = _both(mix, params[mix, "fp32"])
    _, tc = _caches(2)
    _, tc1 = _caches(1)
    with torch.no_grad():
        y, _ = tm(torch.from_numpy(x), cache=tc, mask=torch.from_numpy(mask))
        y1, _ = tm(torch.from_numpy(x[1:, 3:]), cache=tc1)
    assert _rel(y[1, 3:].numpy(), y1[0].numpy()) <= MIXER_TOL
    for key in keys:
        assert _rel(tc[key][1].numpy(), tc1[key][0].numpy()) <= MIXER_TOL


def test_prev_valid_and_group_norm_epsilon():
    """``_prev_valid`` is the reference's (True at t = 0, then the previous
    lane's validity) and the group norm's epsilon is the reference's."""
    mask = np.asarray([[False, False, True, True], [True, True, True, True]])
    assert np.array_equal(trwkv._prev_valid(torch.from_numpy(mask)).numpy(),
                          np.asarray(jrwkv._prev_valid(jnp.asarray(mask))))
    assert trwkv._GN_EPS == 64e-5
