"""Port parity: the engine's shared-prefix KV reuse (``prefix_cache=True``)
against the JAX reference engine on the qwen3 smoke model with the kernel
impl and the same JAX-initialised params (carried over by
``convert.from_reference``).

Mirrors ``tests/test_engine.py``'s prefix-cache tests (shared heads, the
disjoint workload, pin deferral, the capacity bound, the short-ring
refusal, the launch-shape budget) and ``tests/test_runner.py``'s
capability gating. Each mixed script runs through both engines: tokens and
the prefix counters must be equal, and the port's tokens must equal its
cache-off engine's. The runner's donor-seeded prefill logits are held to
the reference's within ``REL_TOL`` (``tests/test_conformance.py``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import gemma3_27b as jg, qwen3_0_6b as jq
from repro.configs.base import SWMConfig as JSWM
from repro.configs.registry import get_smoke as jsmoke
from repro.launch.specs import build_model as jbuild
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro.serve import engine as jeng
from repro.serve.runner import make_runner as jmake_runner
from repro_torch import convert
from repro_torch.configs import gemma3_27b as tg, qwen3_0_6b as tq
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.configs.registry import get_smoke as tsmoke
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.serve import engine as teng
from repro_torch.serve.runner import make_runner
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL_TOL = 2e-5          # tests/test_conformance.py
CACHE = 32
BUCKETS = (8, 16)        # + cache_len: a fixed small set of launch shapes
STATS = ("prefix_hits", "prefix_lookups", "prefill_tokens_saved",
         "prefill_shapes", "padded_prompt_tokens")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jq.SMOKE, swm=JSWM(block_size=8,
                                                  impl="pallas"))
    tcfg = dataclasses.replace(tq.SMOKE, swm=TSWM(block_size=8,
                                                  impl="pallas"))
    jm = JLM(jcfg)
    jparams = jax.jit(lambda: jinit(jm.specs(), 0))()
    return jcfg, tcfg, jm, jparams, jax.tree.map(np.asarray, jparams)


def _port(models, **kw):
    _, tcfg, _, _, np_params = models
    kw.setdefault("prompt_buckets", BUCKETS)
    return teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg,
                            convert.from_reference(tcfg, np_params, "cpu"),
                            cache_len=CACHE, **kw)


def _ref(models, **kw):
    jcfg, _, jm, jparams, _ = models
    kw.setdefault("prompt_buckets", BUCKETS)
    return jeng.ServeEngine(jm, jcfg, jparams, cache_len=CACHE, **kw)


def _shared_head_mix(mod, seed, n, head_len=12, vocab=256, n_heads=2):
    """Requests drawn from a few shared prompt heads + private tails."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, size=head_len).astype(np.int32)
             for _ in range(n_heads)]
    reqs = []
    for i in range(n):
        tail = rng.integers(0, vocab,
                            size=int(rng.integers(1, 5))).astype(np.int32)
        reqs.append(mod.Request(np.concatenate([heads[i % n_heads], tail]),
                                max_new=int(rng.integers(2, 6))))
    return reqs


def _mix(mod, seed, n, vocab=256, plen_hi=11, new_hi=7):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(0, vocab, size=int(rng.integers(
        1, plen_hi))).astype(np.int32), max_new=int(rng.integers(1, new_hi)))
        for _ in range(n)]


def _deferral_mix(mod):
    head = np.arange(8, dtype=np.int32) + 3
    return [mod.Request(np.concatenate([head, np.asarray([40 + i],
                                                         np.int32)]),
                        max_new=3) for i in range(6)]


def _check_prefix_invariants(eng):
    """No dangling pins, and every index entry points at a slot that still
    holds the indexed prefix."""
    assert (eng._slot_refs == 0).all()
    for (m, bts), slot in eng._prefix_index.items():
        p = eng._slot_prompt[slot]
        assert p is not None and p.shape[0] >= m
        assert p[:m].tobytes() == bts


def _both(models, make_reqs, **kw):
    """The same script through the reference and the port engine (both
    prefix-cached) and the port's cache-off engine: equal tokens and
    prefix counters. Returns the port's prefix-cached engine."""
    je = _ref(models, prefix_cache=True, **kw)
    te = _port(models, prefix_cache=True, **kw)
    off_kw = {k: v for k, v in kw.items() if not k.startswith("prefix_")}
    off = _port(models, **off_kw)
    jout = je.generate(make_reqs(jeng))
    tout = te.generate(make_reqs(teng))
    assert tout == jout
    assert off.generate(make_reqs(teng)) == tout
    for f in STATS:
        assert getattr(te.stats, f) == getattr(je.stats, f), f
    assert te.stats.prefix_hit_rate == je.stats.prefix_hit_rate
    assert sorted(te._prefix_index.items()) == sorted(
        je._prefix_index.items())
    assert off.stats.prefix_lookups == 0
    assert off.stats.prefill_tokens_saved == 0
    _check_prefix_invariants(te)
    return te


def test_prefix_cache_shared_heads_match_reference(models):
    te = _both(models, lambda mod: _shared_head_mix(mod, 20, 9), batch=3)
    assert te.stats.prefix_hits > 0
    assert te.stats.prefill_tokens_saved > 0
    assert 0.0 < te.stats.prefix_hit_rate <= 1.0


def test_prefix_cache_disjoint_workload_all_misses(models):
    te = _both(models, lambda mod: _mix(mod, 21, 7), batch=2,
               prefix_block=16)
    assert te.stats.prefix_hits == 0
    assert te.stats.prefill_tokens_saved == 0


def test_prefix_refcount_defers_instead_of_clobbering(models):
    """Every queued request matches the SAME donor rows while placement is
    starved (2 slots): pins keep the donor out of placement and pad lanes,
    deferral keeps the engine making progress."""
    te = _both(models, _deferral_mix, batch=2)
    assert te.stats.prefix_hits >= 3
    assert te.stats.prefill_tokens_saved == 8 * te.stats.prefix_hits


def test_prefix_capacity_bounds_index(models):
    te = _both(models, lambda mod: _shared_head_mix(mod, 22, 8, n_heads=3),
               batch=2, prefix_capacity=2)
    assert len(te._prefix_index) <= 2
    with pytest.raises(ValueError, match="prefix_capacity"):
        _port(models, batch=2, prefix_cache=True, prefix_capacity=0)
    with pytest.raises(ValueError, match="prefix_block"):
        _port(models, batch=2, prefix_cache=True, prefix_block=0)


def test_prefix_cache_launch_shape_budget(models):
    """Seeding rides in the same bucketed launches: the prefix cache adds
    no launch shape."""
    eng = _port(models, batch=4, prefix_cache=True)
    eng.generate(_shared_head_mix(teng, 26, 10))
    eng.generate(_mix(teng, 27, 5))
    assert eng.prefill_compiles <= eng.max_prefill_variants
    assert eng.decode_compiles <= eng.max_decode_variants
    assert eng.max_decode_variants == len(eng.decode_buckets)
    _check_prefix_invariants(eng)


def test_prefix_cache_rejects_short_ring_caches():
    """gemma3's local rings (window 8) are shorter than cache_len: donor
    rows past the window are overwritten, so prefix reuse must refuse with
    the reference's reason — and serve without it."""
    tcfg = tg.SMOKE
    runner = make_runner(build_model(tcfg, device="cpu"), tcfg, CACHE)
    jrunner = jmake_runner(jbuild(jg.SMOKE), jg.SMOKE, CACHE)
    assert runner.supports_prefix_cache is jrunner.supports_prefix_cache \
        is False
    assert runner.prefix_cache_unsupported_reason \
        == jrunner.prefix_cache_unsupported_reason
    model = build_model(tcfg, device="cpu")
    params = init_params(model.specs(), 0, device="cpu")
    with pytest.raises(ValueError, match="full-length KV caches") as e:
        teng.ServeEngine(model, tcfg, params, batch=2, cache_len=CACHE,
                         prefix_cache=True)
    assert runner.prefix_cache_unsupported_reason in str(e.value)
    teng.ServeEngine(model, tcfg, params, batch=2, cache_len=CACHE)
    # a cache no longer than the window keeps every row: reuse is allowed
    short = make_runner(model, tcfg, tcfg.sliding_window)
    assert short.supports_prefix_cache is True
    assert jmake_runner(jbuild(jg.SMOKE), jg.SMOKE,
                        jg.SMOKE.sliding_window).supports_prefix_cache


@pytest.mark.parametrize("arch,match", [("rwkv6-7b", "recurrent state"),
                                        ("seamless-m4t-medium",
                                         "prefix_cache")])
def test_prefix_cache_gated_on_capability(arch, match):
    """Recurrent state and enc-dec cross state have no per-position rows:
    the engine refuses prefix_cache=True with the runner's reason (the
    reference's), and the index and matcher stay inert."""
    tcfg = tsmoke(arch)
    model = build_model(tcfg, device="cpu")
    runner = make_runner(model, tcfg, CACHE)
    jcfg = jsmoke(arch)
    jrunner = jmake_runner(jbuild(jcfg), jcfg, CACHE)
    assert runner.prefix_cache_unsupported_reason \
        == jrunner.prefix_cache_unsupported_reason
    params = init_params(model.specs(), 0, device="cpu")
    with pytest.raises(ValueError, match=match):
        teng.ServeEngine(model, tcfg, params, batch=2, cache_len=CACHE,
                         prefix_cache=True)
    eng = teng.ServeEngine(model, tcfg, params, batch=2, cache_len=CACHE)
    prompt = np.arange(1, 17, dtype=np.int32)
    eng._index_insert(0, prompt)
    assert len(eng._prefix_index) == 0
    assert eng._slot_prompt[0] is None
    assert eng._match_prefix(prompt) == (None, 0)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-6))


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _ref_layers(state):
    """The reference decoder cache (one dict per layer group, leaves with a
    leading layer axis, slot axis 1) as one dict per layer."""
    out = []
    for group in state:
        for lay in group.values():
            n = np.asarray(lay["pos"]).shape[0]
            out += [{k: np.asarray(v)[i] for k, v in lay.items()}
                    for i in range(n)]
    return out


def test_donor_seeded_prefill_matches_reference(models):
    """Runner level: prefill a donor prompt into slot 0, then a prompt
    sharing its first ``m`` tokens into slot 1 from slot 0's rows, with
    only the tail as tokens (the engine's layout: tail at positions
    m..L-1, pads parked on masked ring slots past it). The first-token
    logits and the placed rows match the reference's, and the logits match
    a full prefill of the same prompt; a seed masking the head's last row
    (a planted fault) reads above the limit."""
    je = _ref(models, batch=2)
    te = _port(models, batch=2)
    rng = np.random.default_rng(5)
    m, T, Sb, pads = 8, 5, 8, 3
    donor = rng.integers(0, 256, size=13).astype(np.int32)
    prompt = np.concatenate([donor[:m],
                             rng.integers(0, 256, size=T).astype(np.int32)])
    dtok = np.concatenate([np.zeros(pads, np.int32), donor])[None]
    dpos = np.arange(16, dtype=np.int32)[None] - pads
    tok = np.zeros((1, Sb), np.int32)
    tok[0, Sb - T:] = prompt[m:]
    pos = np.zeros((1, Sb), np.int32)
    pos[0, Sb - T:] = m + np.arange(T)
    pos[0, :Sb - T] = m + T + np.arange(Sb - T) - CACHE
    one = np.asarray([1], np.int32)
    zero = np.asarray([0], np.int32)
    mlen = np.asarray([m], np.int32)

    jr = je.runner
    _, _, js = jr.prefill(je.params, dtok, dpos, jr.init_state(2), zero)
    jl, jok, js = jr.prefill(je.params, tok, pos, js, one, donor_idx=zero,
                             match_len=mlen)

    r = te.runner

    def donor_state():
        return r.prefill(_t(dtok).long(), _t(dpos), r.init_state(2),
                         _t(zero).long())[2]

    tl, tok_ok, ts = r.prefill(_t(tok).long(), _t(pos), donor_state(),
                               _t(one).long(), donor_idx=_t(zero).long(),
                               match_len=_t(mlen))
    assert bool(tok_ok.all()) and bool(np.asarray(jok).all())
    err = _rel(tl.numpy(), jl)
    assert err <= REL_TOL, err
    for tlay, jlay in zip(ts, _ref_layers(js)):
        np.testing.assert_array_equal(tlay["pos"].numpy(), jlay["pos"])
        # live entries match; past the match the port blanks the copied
        # k/v, the reference leaves them (both masked)
        live = jlay["pos"] >= 0
        for n in ("k", "v"):
            assert _rel(tlay[n].numpy()[live], jlay[n][live]) <= REL_TOL
    full = np.concatenate([np.zeros(pads, np.int32), prompt])[None]
    fl, _, _ = r.prefill(_t(full).long(), _t(dpos), r.init_state(1),
                         _t(zero).long())
    assert _rel(tl.numpy(), fl.numpy()) <= REL_TOL
    seed = type(r)._seed_state

    def hit_with(fault):
        r._seed_state = fault
        try:
            return r.prefill(_t(tok).long(), _t(pos), donor_state(),
                             _t(one).long(), donor_idx=_t(zero).long(),
                             match_len=_t(mlen))[0]
        finally:
            del r._seed_state

    # no mask at all changes nothing in a full-length cache: the tail
    # rewrites positions m..L-1 before any query reads them, and causality
    # hides every later donor row — the mask is defensive
    same = hit_with(lambda s, d, ml: r.gather_state(s, d))
    assert torch.equal(same, tl)
    # a planted fault the check must see: the mask one row short of the
    # match drops the head's last row
    bad = hit_with(lambda s, d, ml: seed(r, s, d, ml - 1))
    assert _rel(bad.numpy(), fl.numpy()) > REL_TOL
