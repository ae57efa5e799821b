"""Port parity for the recurrent hybrids: jamba (Mamba + attention + MoE)
and rwkv6 at their smoke configs with the kernel impl, against the JAX
package (its Pallas kernel in interpret mode on the CPU) on the same
JAX-initialised params carried across with ``convert``.

Covers: prefill over left-padded rows (negative pad positions) and decode
steps against the cache, unfrozen, fp32-frozen and int8-frozen, states
included; the MoE aux loss through ``forward_hidden``; ``convert`` round
trips of the stacked reference layout (jamba's 6 + 2 layer groups, the
expert-stacked and Mamba/RWKV leaves, the untied head); bucketed
left-padded engine prefill against the unbucketed B = 1 runner loop;
greedy engine tokens against the JAX ``ServeEngine``; the runner choice
and ``RecurrentRunner``'s prefix-cache flag; the serve launcher at
``--smoke`` on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import jamba_52b as jj, rwkv6_7b as jr
from repro.configs.base import SWMConfig as JSWM
from repro.kernels.block_circulant import plan as jplan
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro.serve import engine as jeng
from repro_torch import convert
from repro_torch.configs import jamba_52b as tj, qwen3_0_6b as tq, \
    rwkv6_7b as tr
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.launch import serve as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params, load_tree
from repro_torch.serve import engine as teng
from repro_torch.serve.runner import (DecoderRunner, RecurrentRunner,
                                      make_runner, recurrent_mixer_names)
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

# f32 end to end: both sides sum in other orders (kernel vs plain version,
# XLA vs ATen) through every layer, as tests/test_torch_decoder.py
LOGIT_TOL = 1e-4
CACHE_LEN = 16
FAMILIES = {"jamba": (jj, tj), "rwkv6": (jr, tr)}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def family(request):
    jmod, tmod = FAMILIES[request.param]
    jcfg = dataclasses.replace(jmod.SMOKE, swm=JSWM(block_size=8,
                                                    impl="pallas"))
    tcfg = dataclasses.replace(tmod.SMOKE, swm=TSWM(block_size=8,
                                                    impl="pallas"))
    jm = JLM(jcfg)
    p = jax.jit(lambda: jinit(jm.specs(), 0))()
    fz = jax.jit(lambda p: jplan.freeze_params(jm.specs(), p))(p)
    i8 = jax.jit(lambda p: jplan.freeze_params(jm.specs(), p, "int8"))(fz)
    return request.param, jcfg, tcfg, jm, {"unfrozen": p, "fp32": fz,
                                           "int8": i8}


def _port(tcfg, jparams):
    tm = build_model(tcfg, device="cpu")
    load_tree(tm, convert.from_reference(
        tcfg, jax.tree.map(np.asarray, jparams), device="cpu"))
    return tm


def _inputs():
    # row 0: a full 6-token prompt; row 1: 4 tokens left-padded by 2 lanes
    toks = np.asarray([[5, 17, 250, 3, 99, 42], [0, 0, 7, 7, 120, 64]],
                      np.int32)
    pos = np.asarray([[0, 1, 2, 3, 4, 5], [-2, -1, 0, 1, 2, 3]], np.int32)
    return toks, pos


def _layer_states(jcfg, jcache):
    """The reference's per-group stacked cache -> one dict per layer in
    execution order (the port's layout)."""
    out = []
    for gi, group in enumerate(jcfg.layer_groups()):
        for r in range(group.repeat):
            for li in range(len(group.layers)):
                c = jcache[gi][f"l{li}"]
                out.append({k: np.asarray(v)[r] if group.repeat > 1
                            else np.asarray(v) for k, v in c.items()})
    return out


@pytest.mark.parametrize("mode", ["unfrozen", "fp32", "int8"])
def test_prefill_and_decode_match_reference(family, mode):
    name, jcfg, tcfg, jm, trees = family
    tm = _port(tcfg, trees[mode])
    toks, pos = _inputs()
    jcache = jm.init_cache(2, CACHE_LEN)
    fwd = jax.jit(lambda p, t, ps, c: jm.forward(p, t, positions=ps,
                                                 cache=c, moe_no_drop=True))
    jlog, jcache, _ = fwd(trees[mode], jnp.asarray(toks), jnp.asarray(pos),
                          jcache)
    tcache = tm.init_cache(2, CACHE_LEN)
    with torch.no_grad():
        tlog, tcache = tm.forward(torch.from_numpy(toks).long(),
                                  positions=torch.from_numpy(pos),
                                  cache=tcache, moe_no_drop=True)
    real = pos >= 0
    assert _rel(tlog.numpy()[real], np.asarray(jlog)[real]) <= LOGIT_TOL
    jdecode = jax.jit(lambda p, t, c, ps: jm.decode_step(
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
    # every layer's state (KV, conv/SSM, shift/WKV) is the reference's
    for got, ref in zip(tcache, _layer_states(jcfg, jcache)):
        assert sorted(got) == sorted(ref)
        for key, val in ref.items():
            if key == "pos":
                assert np.array_equal(got[key].numpy(), val)
            else:
                assert _rel(got[key].numpy(), val) <= LOGIT_TOL, key


def test_forward_hidden_and_aux_match_reference(family):
    """The training-side entry: final hidden states and the summed MoE
    aux loss (drop dispatch; 0 for rwkv6)."""
    name, jcfg, tcfg, jm, trees = family
    toks, _ = _inputs()
    jh, jaux = jax.jit(jm.forward_hidden)(trees["unfrozen"],
                                          jnp.asarray(toks))
    tm = _port(tcfg, trees["unfrozen"])
    with torch.no_grad():
        th, taux = tm.forward_hidden(torch.from_numpy(toks).long())
    assert _rel(th.numpy(), jh) <= LOGIT_TOL
    assert abs(float(taux) - float(jaux)) <= 2e-5 * max(abs(float(jaux)), 1)
    assert (float(jaux) > 0) == (name == "jamba")
    # the table of the chunked loss: rwkv6-smoke's head is untied,
    # jamba-smoke's tied (its SMOKE keeps the default)
    ref = (np.asarray(trees["unfrozen"]["embed"]["table"])
           if tcfg.tie_embeddings
           else np.asarray(trees["unfrozen"]["lm_head"]["w"]).T)
    assert tcfg.tie_embeddings == (name == "jamba")
    assert np.array_equal(tm.output_table().numpy(), ref)


def test_convert_round_trip(family):
    """One reference tree loads into the port and exports back leaf for
    leaf, frozen and int8 trees included (expert axes, Mamba and RWKV
    leaves, the untied head, jamba's two layer groups)."""
    name, jcfg, tcfg, jm, trees = family
    for tree in trees.values():
        ref = jax.tree.map(np.asarray, tree)
        back = convert.to_reference(tcfg, convert.from_reference(
            tcfg, ref, device="cpu"))
        flat_r = jax.tree_util.tree_flatten_with_path(ref)[0]
        flat_b = dict(jax.tree_util.tree_flatten_with_path(back)[0])
        assert len(flat_r) == len(flat_b)
        for path, leaf in flat_r:
            assert np.array_equal(flat_b[path], leaf), path
            assert flat_b[path].dtype == leaf.dtype, path


def test_port_tree_has_the_reference_layout(family):
    """The port's own random init, exported, has the reference's keys,
    shapes and dtypes."""
    name, jcfg, tcfg, jm, trees = family
    tm = build_model(tcfg, device="cpu")
    mine = convert.to_reference(tcfg, init_params(tm.specs(), 0, "cpu"))
    ref = jax.tree.map(np.asarray, trees["unfrozen"])
    shape = lambda t: jax.tree.map(lambda a: (a.shape, str(a.dtype)), t)
    assert shape(mine) == shape(ref)


def _reqs(cfg, seed=7, lens=(3, 9, 5, 12, 2, 7), max_new=3):
    """Mixed prompt lengths, so bucketed admission pads."""
    rng = np.random.default_rng(seed)
    return [teng.Request(rng.integers(1, cfg.vocab, size=L).astype(np.int32),
                         max_new=max_new) for L in lens]


def _b1_oracle(runner, reqs):
    """Greedy B = 1 loop through the runner: the exact prompt length,
    fresh state per request — the unbucketed ground truth."""
    outs = []
    for r in reqs:
        p = torch.from_numpy(np.asarray(r.prompt, np.int64))[None]
        L = p.shape[1]
        state = runner.init_state(1)
        slot = torch.zeros(1, dtype=torch.long)
        lg, ok, state = runner.prefill(p, torch.arange(L)[None], state, slot)
        assert bool(ok[0])
        cur = int(lg[0].argmax())
        out, pos = [cur], L
        while len(out) < r.max_new:
            lg, ok, state = runner.decode(torch.tensor([[cur]]), state,
                                          torch.tensor([pos]), slot)
            cur = int(lg[0].argmax())
            out.append(cur)
            pos += 1
        outs.append(out)
    return outs


def test_bucketed_matches_b1(family):
    """Left-padded bucketed prefill and compacted decode give the tokens
    of the unbucketed B = 1 loop (the reference's
    ``tests/test_runner.py::test_bucketed_matches_b1``)."""
    name, jcfg, tcfg, jm, trees = family
    tm = _port(tcfg, trees["unfrozen"])
    eng = teng.ServeEngine(tm, tcfg, convert.from_reference(
        tcfg, jax.tree.map(np.asarray, trees["unfrozen"]), device="cpu"),
        batch=4, cache_len=32)
    assert isinstance(eng.runner, RecurrentRunner)
    reqs = _reqs(tcfg)
    outs = eng.generate(reqs)
    assert any(b > 1 for b, _ in eng.stats.prefill_shapes)
    assert eng.stats.padded_prompt_tokens > 0
    assert outs == _b1_oracle(eng.runner, reqs)
    assert eng.prefill_compiles <= eng.max_prefill_variants
    assert eng.decode_compiles <= eng.max_decode_variants


def test_engine_tokens_match_reference(family):
    """Greedy tokens of the port's engine equal the JAX engine's on the
    same params and requests (4 slots, so decode compacts and refills)."""
    name, jcfg, tcfg, jm, trees = family
    je = jeng.ServeEngine(jm, jcfg, trees["unfrozen"], batch=4,
                          cache_len=24)
    te = teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg,
                          convert.from_reference(
                              tcfg, jax.tree.map(np.asarray,
                                                 trees["unfrozen"]), "cpu"),
                          batch=4, cache_len=24)
    rng = np.random.default_rng(3)
    lens = [int(rng.integers(2, 10)) for _ in range(6)]
    prompts = [rng.integers(0, 256, size=L).astype(np.int32) for L in lens]
    news = [int(rng.integers(2, 6)) for _ in lens]
    jout = je.generate([jeng.Request(p, max_new=n)
                        for p, n in zip(prompts, news)])
    tout = te.generate([teng.Request(p, max_new=n)
                        for p, n in zip(prompts, news)])
    assert tout == jout
    assert te.stats.prefill_shapes == je.stats.prefill_shapes
    assert te.stats.decode_shapes == je.stats.decode_shapes


def test_runner_choice_and_prefix_flag():
    for cfg, kind, mixers in ((tj.SMOKE, RecurrentRunner, ("mamba",)),
                              (tr.SMOKE, RecurrentRunner, ("rwkv",)),
                              (tq.SMOKE, DecoderRunner, ())):
        assert recurrent_mixer_names(cfg) == mixers
        runner = make_runner(build_model(cfg, device="cpu"), cfg, 16)
        assert type(runner) is kind
    rr = make_runner(build_model(tj.SMOKE, device="cpu"), tj.SMOKE, 16)
    assert rr.supports_prefix_cache is False
    assert "mamba" in rr.prefix_cache_unsupported_reason
    assert RecurrentRunner.supports_prefix_cache is False
    assert DecoderRunner.supports_prefix_cache is True


@pytest.mark.parametrize("model", ["jamba-v0.1-52b", "rwkv6-7b"])
def test_launcher_serves_smoke_on_cpu(model, capsys):
    outs = tlaunch.main(["--model", model, "--smoke", "--device", "cpu",
                         "--batch", "2", "--cache-len", "16",
                         "--n-requests", "3", "--max-new", "3"])
    assert [len(o) for o in outs] == [3, 3, 3]
    assert "request 2:" in capsys.readouterr().out


def test_full_configs_mirror_reference():
    """CONFIG and SMOKE copied field for field (dtypes as names)."""
    for jmod, tmod in FAMILIES.values():
        for which in ("CONFIG", "SMOKE"):
            j = dataclasses.asdict(getattr(jmod, which))
            t = dataclasses.asdict(getattr(tmod, which))
            assert t == j
