"""Port parity for the rest of the decoder family at their smoke configs:
gemma3 (5 local : 1 global sliding-window layers), paligemma (prefix-LM
behind an image prefix) and deepseek (d_ff 172: ``valid_block_size``)
here; internlm2, qwen3-moe (qk-norm, every layer MoE) and arctic (MoE with
the parallel dense residual) run the same family-parametrised tests from
``tests/test_torch_moe_family.py``, so the two halves spread over test
workers. Each is held against the JAX package on the same JAX-initialised
params carried across with ``convert``.

The port runs its kernel impl (each kernel's plain version on the CPU);
the JAX side runs its ``freq`` impl (XLA), the same function in other
summation orders, which compiles in a fraction of the Pallas kernel's
interpret mode, and :func:`fast_jit` compiles the reference's functions
with XLA's cheap CPU options (the compiles dominate these files' time).

Covers: prefill over left-padded 12-token rows (longer than gemma3's
8-wide window: its rings take the fresh-kv branch, its global cache the
cache branch; paligemma's 8-position prefix span) and 3 decode steps
(wrapping the rings), unfrozen, fp32-frozen and int8-frozen, caches
included; paligemma's ``img_embeds`` through ``forward``,
``forward_hidden`` and ``prefill``; ``convert`` round trips; bucketed
engine prefill against the B = 1 runner loop; greedy engine tokens against
the JAX ``ServeEngine`` (text-only for paligemma, as the reference engine
serves requests without ``extra``); the full configs field for field; the
runner choice (and the decoder runner's refusal of a request's enc-dec
``extra``); the serve launcher at ``--smoke`` on the CPU.
"""

import dataclasses
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SWMConfig as JSWM
from repro.configs.registry import ARCHS as JARCHS
from repro.kernels.block_circulant import plan as jplan
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro.serve import engine as jeng
from repro_torch import convert
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.configs.registry import ARCHS, get_smoke
from repro_torch.launch import serve as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params, load_tree
from repro_torch.serve import engine as teng
from repro_torch.serve.runner import (DecoderRunner, EncDecRunner,
                                      make_runner)
from test_torch_recurrent import _b1_oracle, _layer_states, _rel, _reqs
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

# f32 end to end: both sides sum in other orders (plain kernel version vs
# XLA's FFT) through every layer, as tests/test_torch_decoder.py
LOGIT_TOL = 1e-4
CACHE_LEN = 16
# family -> (config module, registry id): the decoder-family archs besides
# qwen3 and the recurrent hybrids; the family-parametrised tests here take
# HERE, those of tests/test_torch_moe_family.py the rest
FAMILIES = {"gemma3": ("gemma3_27b", "gemma3-27b"),
            "paligemma": ("paligemma_3b", "paligemma-3b"),
            "deepseek": ("deepseek_7b", "deepseek-7b"),
            "internlm2": ("internlm2_20b", "internlm2-20b"),
            "qwen3_moe": ("qwen3_moe_235b", "qwen3-moe-235b-a22b"),
            "arctic": ("arctic_480b", "arctic-480b")}
HERE = ("gemma3", "paligemma", "deepseek")


# XLA CPU options that cut compile time several-fold for these small
# graphs; the reference's functions compute the same values in f32
FAST_XLA = {"xla_backend_optimization_level": 0,
            "xla_llvm_disable_expensive_passes": True}


def fast_jit(fn):
    """``jax.jit(fn)``, compiled once per argument signature with
    ``FAST_XLA``."""
    jitted, compiled = jax.jit(fn), {}

    def call(*args):
        key = (jax.tree_util.tree_structure(args),
               tuple((a.shape, str(a.dtype)) for a in jax.tree.leaves(args)))
        if key not in compiled:
            compiled[key] = jitted.lower(*args).compile(FAST_XLA)
        return compiled[key](*args)

    return call


def _mods(name):
    mod = FAMILIES[name][0]
    return (importlib.import_module(f"repro.configs.{mod}"),
            importlib.import_module(f"repro_torch.configs.{mod}"))


@functools.lru_cache(maxsize=None)
def _setup(name):
    """(jcfg, tcfg, JAX model, {mode: JAX param tree}) of one family,
    built once per process."""
    jmod, tmod = _mods(name)
    jcfg = dataclasses.replace(jmod.SMOKE, swm=JSWM(block_size=8,
                                                    impl="freq"))
    tcfg = dataclasses.replace(tmod.SMOKE, swm=TSWM(block_size=8,
                                                    impl="pallas"))
    jm = JLM(jcfg)
    specs = jm.specs()
    p = fast_jit(lambda: jinit(specs, 0))()
    fz, i8 = fast_jit(lambda p: (
        jplan.freeze_params(specs, p),
        jplan.freeze_params(specs, jplan.freeze_params(specs, p), "int8")))(p)
    return jcfg, tcfg, jm, {"unfrozen": p, "fp32": fz, "int8": i8}


@pytest.fixture(scope="module", params=HERE)
def family(request):
    return (request.param,) + _setup(request.param)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tcfg, jparams):
    tm = build_model(tcfg, device="cpu")
    load_tree(tm, convert.from_reference(tcfg, _np(jparams), device="cpu"))
    return tm


def _inputs():
    """Row 0: a full 12-token prompt; row 1: 10 tokens left-padded by two
    lanes with negative (masked) positions."""
    r = np.random.default_rng(11)
    toks = r.integers(1, 256, (2, 12)).astype(np.int32)
    toks[1, :2] = 0
    pos = np.stack([np.arange(12), np.arange(-2, 10)]).astype(np.int32)
    return toks, pos


def _check_caches(tcache, jcfg, jcache):
    for got, ref in zip(tcache, _layer_states(jcfg, jcache), strict=True):
        assert sorted(got) == sorted(ref)
        assert got["k"].shape == ref["k"].shape
        assert np.array_equal(got["pos"].numpy(), ref["pos"])
        for key in ("k", "v"):
            assert _rel(got[key].numpy(), ref[key]) <= LOGIT_TOL, key


@pytest.mark.parametrize("mode", ["unfrozen", "fp32", "int8"])
def test_prefill_and_decode_match_reference(family, mode):
    name, jcfg, tcfg, jm, trees = family
    tm = _port(tcfg, trees[mode])
    toks, pos = _inputs()
    fwd = fast_jit(lambda p, t, ps, c: jm.forward(p, t, positions=ps,
                                                  cache=c, moe_no_drop=True))
    jlog, jcache, _ = fwd(trees[mode], jnp.asarray(toks), jnp.asarray(pos),
                          jm.init_cache(2, CACHE_LEN))
    tcache = tm.init_cache(2, CACHE_LEN)
    with torch.no_grad():
        tlog, tcache = tm.forward(torch.from_numpy(toks).long(),
                                  positions=torch.from_numpy(pos),
                                  cache=tcache, moe_no_drop=True)
    real = pos >= 0
    assert _rel(tlog.numpy()[real], np.asarray(jlog)[real]) <= LOGIT_TOL
    _check_caches(tcache, jcfg, jcache)
    jdecode = fast_jit(lambda p, t, c, ps: jm.decode_step(
        p, t, c, ps, moe_no_drop=True))
    nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)
    cur = pos[:, -1] + 1
    for _ in range(3):
        jl, jcache = jdecode(trees[mode], jnp.asarray(nxt[:, None]), jcache,
                             jnp.asarray(cur))
        with torch.no_grad():
            tl, tcache = tm.decode_step(torch.from_numpy(nxt[:, None]).long(),
                                        tcache, torch.from_numpy(cur),
                                        moe_no_drop=True)
        assert _rel(tl.numpy(), jl) <= LOGIT_TOL
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        cur = cur + 1
    _check_caches(tcache, jcfg, jcache)
    if name == "gemma3":
        # the five local layers hold window-sized rings, the global layer
        # the full cache, and decode wrapped the rings
        assert [c["k"].shape[1] for c in tcache] == [8] * 5 + [CACHE_LEN]
        assert int(tcache[0]["pos"].max()) >= 8 + 6


def test_image_prefix_matches_reference():
    """paligemma's image prefix (B, P, D) before the tokens: prefix-LM
    attention over P + S positions through ``forward`` (all logits),
    ``forward_hidden`` and ``prefill`` (last logits and the cache)."""
    jcfg, tcfg, jm, trees = _setup("paligemma")
    tm = _port(tcfg, trees["unfrozen"])
    P = jcfg.n_img_tokens
    toks, _ = _inputs()
    img = np.random.default_rng(5).standard_normal(
        (2, P, jcfg.d_model)).astype(np.float32)
    p = trees["unfrozen"]
    jlog, _, _ = fast_jit(lambda p, t, i: jm.forward(p, t, img_embeds=i))(
        p, jnp.asarray(toks), jnp.asarray(img))
    jh, _ = fast_jit(lambda p, t, i: jm.forward_hidden(p, t, img_embeds=i))(
        p, jnp.asarray(toks), jnp.asarray(img))
    jlast, jcache = fast_jit(jm.prefill)(p, jnp.asarray(toks),
                                         jm.init_cache(2, 32),
                                         jnp.asarray(img))
    t_toks, t_img = torch.from_numpy(toks).long(), torch.from_numpy(img)
    with torch.no_grad():
        tlog, _ = tm.forward(t_toks, img_embeds=t_img)
        th, _ = tm.forward_hidden(t_toks, img_embeds=t_img)
        tlast, tcache = tm.prefill(t_toks, tm.init_cache(2, 32), t_img)
    assert tlog.shape == (2, P + toks.shape[1], jcfg.vocab)
    assert _rel(tlog.numpy(), jlog) <= LOGIT_TOL
    assert _rel(th.numpy(), jh) <= LOGIT_TOL
    assert _rel(tlast.numpy(), jlast) <= LOGIT_TOL
    _check_caches(tcache, jcfg, jcache)
    # the prefix is attended bidirectionally: the first image position
    # sees the last one, so changing it moves position 0's logits
    img2 = img.copy()
    img2[:, P - 1] += 1.0
    with torch.no_grad():
        moved, _ = tm.forward(t_toks, img_embeds=torch.from_numpy(img2))
    assert np.abs(moved[:, 0].numpy() - tlog[:, 0].numpy()).max() > 1e-4


def test_convert_round_trip(family):
    """One reference tree loads into the port and exports back leaf for
    leaf, frozen and int8 trees included; local attention has global
    attention's keys."""
    name, jcfg, tcfg, jm, trees = family
    for tree in trees.values():
        ref = _np(tree)
        back = convert.to_reference(tcfg, convert.from_reference(
            tcfg, ref, device="cpu"))
        flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_r) == len(flat_b)
        for path, leaf in flat_r:
            assert np.array_equal(flat_b[path], leaf), path
            assert flat_b[path].dtype == leaf.dtype, path
    tm = build_model(tcfg, device="cpu")
    kinds = {layer.mixer_kind: sorted(layer.specs()["mixer"])
             for layer in tm._modules["layers"]}
    assert set(kinds) == ({"attn", "attn_local"} if name == "gemma3"
                          else {"attn"})
    assert len({tuple(v) for v in kinds.values()}) == 1
    # the port's own init, exported, has the reference's layout
    mine = convert.to_reference(tcfg, init_params(tm.specs(), 0, "cpu"))
    shape = lambda t: jax.tree.map(lambda a: (a.shape, str(a.dtype)), t)
    assert shape(mine) == shape(_np(trees["unfrozen"]))


def test_bucketed_matches_b1(family):
    """Left-padded bucketed prefill and compacted decode give the tokens
    of the unbucketed B = 1 loop (the reference's
    ``tests/test_runner.py::test_bucketed_matches_b1``)."""
    name, jcfg, tcfg, jm, trees = family
    eng = teng.ServeEngine(_port(tcfg, trees["unfrozen"]), tcfg,
                           convert.from_reference(tcfg, _np(trees["unfrozen"]),
                                                  device="cpu"),
                           batch=4, cache_len=24)
    assert type(eng.runner) is DecoderRunner
    reqs = _reqs(tcfg)
    outs = eng.generate(reqs)
    assert any(b > 1 for b, _ in eng.stats.prefill_shapes)
    assert eng.stats.padded_prompt_tokens > 0
    assert outs == _b1_oracle(eng.runner, reqs)


def test_engine_tokens_match_reference(family):
    """Greedy tokens of the port's engine equal the JAX engine's on the
    same params and requests: four prompts of mixed lengths in one
    left-padded (4, 16) prefill, then decode at 4 rows while requests of
    different lengths finish (one prompt and one decode bucket keep the
    JAX engine at two compiles; refills are ``test_bucketed_matches_b1``'s
    part)."""
    name, jcfg, tcfg, jm, trees = family
    kw = dict(batch=4, cache_len=24, prompt_buckets=(16,),
              decode_buckets=(4,))
    je = jeng.ServeEngine(jm, jcfg, trees["unfrozen"], **kw)
    te = teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg,
                          convert.from_reference(
                              tcfg, _np(trees["unfrozen"]), "cpu"), **kw)
    rng = np.random.default_rng(3)
    lens = [int(rng.integers(2, 14)) for _ in range(4)]
    prompts = [rng.integers(0, 256, size=L).astype(np.int32) for L in lens]
    news = [int(rng.integers(2, 6)) for _ in lens]
    jout = je.generate([jeng.Request(p, max_new=n)
                        for p, n in zip(prompts, news)])
    tout = te.generate([teng.Request(p, max_new=n)
                        for p, n in zip(prompts, news)])
    assert tout == jout
    assert te.stats.prefill_shapes == je.stats.prefill_shapes == {(4, 16)}
    assert te.stats.decode_shapes == je.stats.decode_shapes


def test_full_configs_mirror_reference():
    """CONFIG and SMOKE copied field for field (dtypes as names), and the
    registry serves every decoder-family arch."""
    for name, (mod, arch) in FAMILIES.items():
        jmod, tmod = _mods(name)
        for which in ("CONFIG", "SMOKE"):
            assert (dataclasses.asdict(getattr(tmod, which))
                    == dataclasses.asdict(getattr(jmod, which))), (name, which)
        assert ARCHS[arch] == tmod.__name__
    assert sorted(ARCHS) == sorted(JARCHS)
    g = _mods("gemma3")[1].CONFIG
    mixers = [lspec.mixer for lspec in g.layer_specs()]
    assert (mixers.count("attn_local"), mixers.count("attn")) == (52, 10)


def test_runner_choice_and_encdec_refusal():
    """Every decoder-family arch gets ``DecoderRunner``, which refuses a
    request carrying enc-dec conditioning (``extra``); the enc-dec family
    gets ``EncDecRunner``."""
    req = teng.Request(np.arange(1, 5, dtype=np.int32),
                       extra=np.zeros((4, 4), np.float32))
    for name, (_, arch) in FAMILIES.items():
        cfg = get_smoke(arch)
        runner = make_runner(build_model(cfg, device="cpu"), cfg, 16)
        assert type(runner) is DecoderRunner
        with pytest.raises(ValueError, match="extra"):
            runner.validate_request(req)
    encdec = dataclasses.replace(get_smoke("qwen3-0.6b"), family="encdec")
    assert type(make_runner(None, encdec, 16)) is EncDecRunner


@pytest.mark.parametrize("model", ["gemma3-27b", "qwen3-moe-235b-a22b"])
def test_launcher_serves_smoke_on_cpu(model, capsys):
    outs = tlaunch.main(["--model", model, "--smoke", "--device", "cpu",
                         "--batch", "2", "--cache-len", "16",
                         "--n-requests", "3", "--max-new", "3"])
    assert [len(o) for o in outs] == [3, 3, 3]
    assert "request 2:" in capsys.readouterr().out
