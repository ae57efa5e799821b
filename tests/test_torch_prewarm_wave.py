"""Port parity: ``ServeEngine.prewarm``, ``WaveEngine`` and the step
makers against the JAX package, the launcher's ``--engine wave`` /
``--prewarm`` / ``--tenants`` / ``--fair``, and the torch ``serve_demo``.

Mirrors ``tests/test_engine.py``'s prewarm tests (the compile budget, the
committed warm-up and the idle check) and wave tests (wave against
continuous, validation, greedy only, recurrent refusal) on its 2-layer,
d 32 ``dft`` model, the same params in both packages (the port's init,
carried across by ``convert.to_reference``): the prewarm's return value,
the shape counters, the tokens served, ``stats`` and a snapshot's meta
equal the reference engine's. The port's counters count launch shapes,
the reference's jit executables: prewarm fills both to the bucket grid.
Then, on the port alone: prewarm-then-serve equals serving cold for the
recurrent (rwkv6), enc-dec (seamless) and ring-cache (gemma3) smoke
configs, with rwkv6's state back to fresh rows after prewarm. ``audit()`` returns
no violations on both engines, and ``prewarm(audit=True)`` on a planted
weight transform raises before its first warm-up launch. The launcher's errors are held to the
reference launcher's wording, and the torch ``serve_demo`` runs at 20
training steps with its printed invariants checked.
"""

import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import (LayerGroup as JGroup, LayerSpec as JSpec,
                                ModelConfig as JCfg, SWMConfig as JSWM)
from repro.launch import serve as jlaunch
from repro.models.decoder import HybridDecoderLM as JLM
from repro.serve import engine as jeng, guard as jguard
from repro_torch import convert
from repro_torch.configs.base import (LayerGroup as TGroup,
                                      LayerSpec as TSpec, ModelConfig as TCfg,
                                      SWMConfig as TSWM)
from repro_torch.configs.registry import get_smoke
from repro_torch.examples import serve_demo
from repro_torch.ft import checkpoint as tck
from repro_torch.launch import serve as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.serve import engine as teng, guard as tguard
from repro_torch.serve.guard import flatten_state_tree
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

FIELDS = dict(name="eng", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
              head_dim=16, d_ff=64, vocab=48, remat="none",
              param_dtype="float32", compute_dtype="float32")
SIDES = ((jeng, jguard), (teng, tguard))


@pytest.fixture(scope="module")
def lm():
    jcfg = JCfg(**FIELDS, swm=JSWM(block_size=8, impl="dft"))
    tcfg = TCfg(**FIELDS, swm=TSWM(block_size=8, impl="dft"))
    tparams = init_params(build_model(tcfg, device="cpu").specs(), 0,
                          device="cpu")
    ref = convert.to_reference(tcfg, tparams)
    return jcfg, tcfg, JLM(jcfg), jax.tree.map(jnp.asarray, ref), ref


def _model(mod, lm):
    """(model, cfg, params) of ``mod``'s package; the port gets a model of
    its own per engine (an engine installs its tables in the model)."""
    jcfg, tcfg, jm, jparams, ref = lm
    if mod is jeng:
        return jm, jcfg, jparams
    return (build_model(tcfg, device="cpu"), tcfg,
            convert.from_reference(tcfg, ref, "cpu"))


_JITS = {}


def _engine(mod, lm, cls="ServeEngine", share=True, **kw):
    """An engine of ``mod``'s package. Reference ServeEngines of one
    geometry share the first one's jitted executables (``share``): the
    same traced functions, one compile; an engine whose counters are
    compared gets its own."""
    model, cfg, params = _model(mod, lm)
    kw.setdefault("batch", 2)
    kw.setdefault("cache_len", 32)
    eng = getattr(mod, cls)(model, cfg, params, **kw)
    if mod is jeng and cls == "ServeEngine" and share:
        key = (eng.batch, eng.cache_len, eng.prefix_cache)
        eng._prefill, eng._decode = _JITS.setdefault(
            key, (eng._prefill, eng._decode))
    return eng


def _mix(mod, seed, n, vocab=48, plen_hi=11, new_hi=7):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(0, vocab, size=int(rng.integers(
        1, plen_hi))).astype(np.int32), max_new=int(rng.integers(1, new_hi)))
        for _ in range(n)]


def _shared_head_mix(mod, seed, n, head_len=12, vocab=48, n_heads=2):
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, vocab, size=head_len).astype(np.int32)
             for _ in range(n_heads)]
    out = []
    for i in range(n):
        tail = rng.integers(0, vocab, size=int(rng.integers(1, 6)))
        out.append(mod.Request(np.concatenate(
            [heads[i % n_heads], tail.astype(np.int32)]),
            max_new=int(rng.integers(2, 6))))
    return out


def _stats(s):
    return ({f: int(getattr(s, f)) for f in teng.ServeEngine._STAT_FIELDS},
            sorted(s.prefill_shapes), sorted(s.decode_shapes))


def _both(script):
    ref, port = (script(*side) for side in SIDES)
    assert port == ref
    return port


# ---------------------------------------------------------------------------
# prewarm
# ---------------------------------------------------------------------------


def test_prewarm_fills_the_bucket_grid_and_serves_unchanged(lm, tmp_path):
    """Mirror of test_engine's prewarm tests, prefix cache on: prewarm
    returns max_prefill_variants + max_decode_variants and the counters
    stay at the grid while serving; prewarm touches neither ``stats`` nor
    a snapshot's meta (both equal the reference's, and the port's equal
    an unprewarmed engine's); the tokens equal the reference's and the
    cold engine's; an idle engine prewarms again and serves the same
    tokens."""
    def script(mod, guard, warm=True):
        clk = guard.ManualClock()
        snap = str(tmp_path / f"{mod.__name__}{warm}")
        eng = _engine(mod, lm, prompt_buckets=(8, 16), prefix_cache=True,
                      clock=clk, snapshot_dir=snap, share=not warm)
        n = eng.prewarm() if warm else 0
        counts = (n, eng.prefill_compiles, eng.decode_compiles)
        if mod is teng:                   # every warm-up write masked
            assert all(bool((layer["pos"] < 0).all())
                       for layer in eng.cache)
        assert _stats(eng.stats) == _stats(mod.EngineStats())
        reqs = _shared_head_mix(mod, 25, 5) + _mix(mod, 11, 6)
        rids = [eng.submit(r) for r in reqs[:3]]
        eng.step()
        clk.advance(0.003)
        eng.snapshot()
        meta = tck.restore_checkpoint(snap, eng._step_count,
                                      device="cpu")["meta"]
        meta = json.loads(meta.numpy().tobytes().decode("utf-8"))
        done = eng.drain(rids)
        outs = [done[r] for r in rids] + eng.generate(reqs[3:])
        if warm:
            assert (eng.prefill_compiles, eng.decode_compiles) == counts[1:]
            eng.prewarm()
            assert eng.generate(reqs) == outs
        return counts, meta, outs, _stats(eng.stats)
    counts, meta, outs, stats = _both(script)
    assert counts == (8, 6, 2)
    _, cold_meta, cold_outs, cold_stats = script(teng, tguard, warm=False)
    assert (cold_meta, cold_outs) == (meta, outs)


def test_prewarm_requires_idle(lm):
    def script(mod, guard):
        eng = _engine(mod, lm)
        eng.submit(mod.Request(np.arange(4, dtype=np.int32), max_new=6))
        eng.step()
        with pytest.raises(RuntimeError, match="idle") as ei:
            eng.prewarm()
        return str(ei.value), eng.drain()
    _both(script)


@pytest.fixture(scope="module")
def lm_kernel():
    """``lm``'s model on the kernel impl (``pallas``), whose serve path
    holds no transform at all (the ``dft`` impl's frozen path still runs
    an irfft in both packages: ``tests/test_torch_analysis.py``)."""
    jcfg = JCfg(**FIELDS, swm=JSWM(block_size=8, impl="pallas"))
    tcfg = TCfg(**FIELDS, swm=TSWM(block_size=8, impl="pallas"))
    tparams = init_params(build_model(tcfg, device="cpu").specs(), 0,
                          device="cpu")
    ref = convert.to_reference(tcfg, tparams)
    return jcfg, tcfg, JLM(jcfg), jax.tree.map(jnp.asarray, ref), ref


def test_audit_passes_and_prewarm_audits_first(lm_kernel):
    """``audit()`` on a clean engine returns [] in both packages, and the
    port's ``prewarm(audit=True)`` warms every shape after it, keeping
    its audit's captures: one per bucket, with a fresh capture's launch
    counts."""
    from repro_torch.analysis.contracts import launch_counts

    for mod in (jeng, teng):
        assert _engine(mod, lm_kernel, share=False).audit() == []
    eng = _engine(teng, lm_kernel)
    assert eng.audit_traces == []
    n = eng.prewarm(audit=True)
    assert n == eng.max_prefill_variants + eng.max_decode_variants
    assert len(eng.audit_traces) == n
    kept = launch_counts(eng, eng.audit_traces)
    assert kept == launch_counts(eng) and min(kept.values()) > 0


def test_prewarm_audit_raises_before_any_warm_up_launch(lm_kernel):
    """A planted weight transform in one layer's forward: the audit names
    it (rule, bucket and this file's line) and prewarm launches
    nothing."""
    from repro_torch.analysis.contracts import StructuralContractError

    eng = _engine(teng, lm_kernel)
    mixer = eng.runner.model.layers[0].mixer

    def weight_fft(module, args):
        torch.fft.rfft(module.o.wr, dim=-1)          # the planted fault

    handle = mixer.register_forward_pre_hook(weight_fft)
    before = (eng.cache[0]["k"].clone(), eng.stats.prefill_calls)
    with pytest.raises(StructuralContractError) as ei:
        eng.prewarm(audit=True)
    handle.remove()
    msg = str(ei.value)
    assert "NoWeightFFT" in msg and "serve_prefill[B1," in msg
    assert f"test_torch_prewarm_wave.py:{_line_of('the planted fault')}" \
        in msg
    assert eng.prefill_compiles == eng.decode_compiles == 0
    assert torch.equal(eng.cache[0]["k"], before[0])
    assert eng.stats.prefill_calls == before[1]
    assert eng.audit() == []


def _line_of(marker):
    with open(__file__) as f:
        return next(i for i, line in enumerate(f, 1)
                    if marker in line and "_line_of" not in line)


def _smoke_serve(arch, prewarm):
    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu")
    eng = teng.ServeEngine(model, cfg, init_params(model.specs(), 0,
                                                   device="cpu"),
                           batch=2, cache_len=32, prompt_buckets=(8, 16),
                           clock=tguard.ManualClock())
    n = eng.prewarm() if prewarm else 0
    return eng, n


@pytest.mark.parametrize("arch", ["rwkv6-7b", "seamless-m4t-medium",
                                  "gemma3-27b"])
def test_prewarm_then_serve_equals_cold(arch):
    """Every runner: prewarm's writes are masked, and admission replaces a
    prewarmed slot's rows whole, so once two requests hold both slots the
    prewarmed engine's state equals
    the cold engine's leaf for leaf (rwkv6's shift and WKV states,
    gemma3's local rings of 8 entries < cache_len 32, which the probes
    wrote masked, seamless's cross caches after prefills of zero frames);
    then every token and the stats are equal."""
    cfg = get_smoke(arch)
    rng = np.random.default_rng(4)
    reqs = []
    for i in range(5):
        extra = (rng.standard_normal((cfg.enc_seq or 32, cfg.d_model))
                 .astype(np.float32) if cfg.family == "encdec" else None)
        reqs.append(teng.Request(rng.integers(0, cfg.vocab, size=int(
            rng.integers(2, 12))).astype(np.int32), max_new=5, extra=extra))
    cold, _ = _smoke_serve(arch, False)
    warm, n = _smoke_serve(arch, True)
    assert n == warm.max_prefill_variants + warm.max_decode_variants
    # every warm-up write is masked: each self-attention entry's stored
    # position is negative (the enc-dec cross caches hold the zero
    # frames' encoder positions, which admission replaces)
    layers = warm.cache["self"] if isinstance(warm.cache, dict) \
        else warm.cache
    pos = [layer["pos"] for layer in layers if "pos" in layer]
    assert bool(pos) == (arch != "rwkv6-7b")
    assert all(bool((p < 0).all()) for p in pos)
    for eng in (cold, warm):
        rids = [eng.submit(r) for r in reqs[:2]]
        eng.step()
    a, b = (flatten_state_tree(e.cache) for e in (cold, warm))
    for k in a:
        assert torch.equal(a[k], b[k]), f"prewarm's rows survived in {k}"
    outs = []
    for eng in (cold, warm):
        done = eng.drain(rids)
        outs.append([done[r] for r in rids] + eng.generate(reqs[2:]))
    assert outs[1] == outs[0]
    assert _stats(warm.stats) == _stats(cold.stats)
    assert warm.prefill_compiles == warm.max_prefill_variants


# ---------------------------------------------------------------------------
# The wave baseline and the step makers
# ---------------------------------------------------------------------------


def test_wave_and_continuous_identical_greedy(lm):
    """Acceptance mirror: a seeded mix (two waves of 3) through the wave
    and the continuous engine, bit-identical; the wave's counters and stats equal
    the reference's."""
    def script(mod, guard):
        reqs = _mix(mod, 5, 6, plen_hi=13, new_hi=9)
        wave = _engine(mod, lm, "WaveEngine", batch=3)
        outs = wave.generate(reqs)
        assert _engine(mod, lm, batch=3).generate(reqs) == outs
        s = wave.stats
        return (outs, wave.prefill_compiles, wave.decode_compiles,
                _stats(s), s.tokens_generated, s.requests_completed,
                wave.frozen_table_bytes())
    _both(script)


def _step_loop(mod, eng, requests):
    """The B=1 gold loop of test_engine through each package's
    make_prefill_step/make_decode_step on ``eng``'s model and frozen
    params (the port's steps take no params: the model holds them)."""
    model = eng.runner.model
    prefill = mod.make_prefill_step(model, eng.cfg)
    decode = mod.make_decode_step(model, eng.cfg)
    if mod is jeng:
        jp, jd = jax.jit(prefill), jax.jit(decode)
        prefill = lambda toks, c: jp(eng.params, jnp.asarray(toks), c)
        decode = lambda toks, c, pos: jd(eng.params, jnp.asarray(toks), c,
                                         jnp.asarray(pos))
    else:
        pf, df = prefill, decode
        prefill = lambda toks, c: pf(torch.as_tensor(toks, dtype=torch.int64),
                                     c)
        decode = lambda toks, c, pos: df(
            torch.as_tensor(toks, dtype=torch.int64), c,
            torch.as_tensor(pos, dtype=torch.int64))
    outs = []
    for r in requests:
        p = np.asarray(r.prompt, np.int32).reshape(-1)
        cache = model.init_cache(1, eng.cache_len)
        logits, cache = prefill(p[None], cache)
        out, pos = [], len(p)
        while True:
            out.append(int(np.argmax(np.asarray(logits, np.float32)[0])))
            if len(out) >= r.max_new:
                break
            logits, cache = decode(np.asarray([[out[-1]]], np.int32), cache,
                                   np.asarray([pos], np.int32))
            pos += 1
        outs.append(out)
    return outs


def test_step_makers_match_reference(lm):
    """The step makers' B=1 loop: equal tokens in both packages, equal to
    each package's engine."""
    def script(mod, guard):
        eng = _engine(mod, lm)
        reqs = [mod.Request(np.arange(3, 9, dtype=np.int32) * k,
                            max_new=3 + k) for k in (1, 2, 5)]
        outs = eng.generate(reqs)
        assert _step_loop(mod, eng, reqs) == outs
        return outs
    _both(script)


def test_wave_validation_matches_reference(lm):
    """The wave's refusals: prompt overflow, degenerate budgets, sampling,
    stop tokens, deadlines, enc-dec configs and batched recurrent mixers,
    each with the reference's text; a wave of one recurrent request is
    allowed; int8 tables hold the reference's bytes."""
    rwkv = dict(FIELDS, n_layers=1, rwkv_head_dim=16, rwkv_decay_lora=8,
                rwkv_mix_lora=8)

    def script(mod, guard):
        wave = _engine(mod, lm, "WaveEngine")
        errs = []
        for r in (mod.Request(np.arange(40, dtype=np.int32), max_new=1),
                  mod.Request(np.arange(3, dtype=np.int32), max_new=0),
                  mod.Request(np.arange(3, dtype=np.int32), max_new=2,
                              sampling=mod.SamplingParams(temperature=0.5)),
                  mod.Request(np.arange(3, dtype=np.int32), max_new=2,
                              stop_tokens=(1,)),
                  mod.Request(np.arange(3, dtype=np.int32), max_new=2,
                              deadline_ms=5.0)):
            with pytest.raises(ValueError) as ei:
                wave.generate([r])
            errs.append(str(ei.value))
        cfgs = ((JCfg, JGroup, JSpec, JLM) if mod is jeng
                else (TCfg, TGroup, TSpec, None))
        rcfg = cfgs[0](**rwkv, swm=(JSWM if mod is jeng else TSWM)(
            block_size=8, impl="dft"), groups=(cfgs[1](layers=(cfgs[2](
                mixer="rwkv", ffn="dense"),), repeat=1),))
        rmodel = JLM(rcfg) if mod is jeng else build_model(rcfg, "cpu")
        for cfg, batch in ((rcfg, 2),
                           (dataclasses.replace(rcfg, family="encdec"), 1)):
            with pytest.raises(ValueError) as ei:
                mod.WaveEngine(rmodel, cfg, None, batch=batch, cache_len=32)
            errs.append(str(ei.value))
        q = _engine(mod, lm, "WaveEngine", quantize="int8")
        return errs, q.frozen_table_bytes()
    errs, _ = _both(script)
    assert "greedy-only" in errs[2] and "recurrent state" in errs[5]
    # a wave of one never pads: allowed for recurrent mixers
    rcfg = TCfg(**rwkv, swm=TSWM(block_size=8, impl="dft"), groups=(
        TGroup(layers=(TSpec(mixer="rwkv", ffn="dense"),), repeat=1),))
    rmodel = build_model(rcfg, "cpu")
    one = teng.WaveEngine(rmodel, rcfg, init_params(rmodel.specs(), 0,
                                                    device="cpu"),
                          batch=1, cache_len=32)
    reqs = _mix(teng, 2, 2)
    assert [len(o) for o in one.generate(reqs)] == [r.max_new for r in reqs]


# ---------------------------------------------------------------------------
# The launcher and the demo
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("extra", [
    ["--engine", "wave", "--prewarm"],
    ["--engine", "wave", "--temperature", "0.5"],
    ["--engine", "wave", "--tenants", "a,b"],
    ["--engine", "wave", "--deadline-ms", "50"],
    ["--engine", "wave", "--model", "seamless-m4t-medium"],
    ["--engine", "wave", "--model", "rwkv6-7b", "--batch", "2"],
    ["--fair"],
    ["--tenants", "a:gold"],
])
def test_launcher_errors_match_reference(extra, capsys, monkeypatch):
    """Both launchers stop with the same ``ap.error`` line (the
    reference's params init, which precedes its checks, stubbed out)."""
    args = ["--smoke"] + extra
    if "--model" not in extra:
        args = ["--model", "qwen3-0.6b"] + args
    with pytest.raises(SystemExit):
        tlaunch.main(args + ["--device", "cpu"])
    port = capsys.readouterr().err.strip().splitlines()[-1]
    monkeypatch.setattr(jlaunch, "init_params", lambda specs, seed: None)
    monkeypatch.setattr(sys, "argv", ["serve.py"] + args)
    with pytest.raises(SystemExit):
        jlaunch.main()
    ref = capsys.readouterr().err.strip().splitlines()[-1]
    assert port.split("error: ", 1)[1] == ref.split("error: ", 1)[1]


def test_launcher_wave_prewarm_and_tenants(capsys):
    base = ["--model", "qwen3-0.6b", "--smoke", "--device", "cpu",
            "--batch", "2", "--cache-len", "32", "--n-requests", "6",
            "--max-new", "4"]
    wave = tlaunch.main(base + ["--engine", "wave"])
    out = capsys.readouterr().out
    assert "prefill compiles=" in out and "decode compiles=1" in out
    cont = tlaunch.main(base + ["--prewarm"])
    out = capsys.readouterr().out
    assert "prewarmed 8 shapes" in out and "prefill compiles=6 " in out
    assert wave == cont
    tenanted = tlaunch.main(base + ["--stream", "--tenants",
                                    "a:interactive,b:batch,c", "--fair"])
    out = capsys.readouterr().out
    assert tenanted == cont
    for t in "abc":
        assert f"tenant {t}: submitted=2 completed=2 tokens=8" in out


def test_serve_demo_invariants(capsys):
    got = serve_demo.main(["--device", "cpu", "--steps", "20"])
    out = capsys.readouterr().out
    assert got == {"int8_equal": True, "bucketed_equal": True,
                   "restarts": 1}
    assert "trained 20 steps" in out
    assert "engine restarts=1 recoveries=1" in out
    assert "int8 == dequantized-oracle outputs: True" in out
    assert "bucketed == unbucketed B=1: True" in out
    assert "req 2: CANCELLED (cancelled by caller)" in out
