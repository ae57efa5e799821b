"""Port parity for the enc-dec family (seamless-m4t-medium) at smoke size:
bidirectional and cross attention, ``EncDecLM``, ``EncDecRunner`` and the
engine's per-request encoder frames, each held against the JAX package on
JAX-initialised params carried across with ``convert``.

The port runs its ``paper`` impl against the JAX package's ``paper``, and
its kernel impl (``pallas``: each kernel's plain version on the CPU)
against the JAX package's ``freq`` (XLA), the same function in other
summation orders, which compiles in a fraction of the Pallas kernel's
interpret mode; :func:`fast_jit` compiles the reference's functions with
XLA's cheap CPU options (the compiles dominate this file's time). The
runner tests mirror ``tests/test_runner.py``'s enc-dec config with the
``pallas`` impl on both sides in place of the reference's ``dft``, which
the port does not have.

Covers: ``flash_attention`` and ``_direct_attention`` with
``causal=False``; cross attention without a cache, its prefill stash and
its decode read-back, with the frozen tree's unread ``_fused`` table
poisoned; the encoder through the flash loops (``flash_q_chunk`` below
the frames' length); ``encode`` and ``forward`` (all and last logits),
unfrozen, fp32- and int8-frozen, for both impls; prefill over left-padded
rows and decode steps with the caches; prefill + decode against the full
forward (the mirror of ``tests/test_models_smoke.py::
test_encdec_decode_consistency``); ``forward_hidden``; ``convert`` round
trips; bucketed engine vs the B = 1 runner loop; engine tokens vs the JAX
engine; request validation both ways; the runner choice; frozen table
bytes (cross ``_fused`` included) vs the JAX engine's; the configs; the
serve launcher on the CPU.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import seamless_m4t_medium as jmod
from repro.configs.base import ModelConfig as JConfig
from repro.configs.base import SWMConfig as JSWM
from repro.kernels.block_circulant import plan as jplan
from repro.models.encdec import EncDecLM as JEncDec
from repro.nn import attention as jatt
from repro.nn.module import init_params as jinit
from repro.serve import engine as jeng
from repro_torch import convert
from repro_torch.configs import seamless_m4t_medium as tmod
from repro_torch.configs.base import ModelConfig as TConfig
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.configs.registry import ARCHS, get_config
from repro_torch.kernels.block_circulant import plan as tplan
from repro_torch.launch import serve as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.models.encdec import EncDecLM
from repro_torch.nn import attention as tatt
from repro_torch.nn.module import init_params, load_tree
from repro_torch.serve import engine as teng
from repro_torch.serve.runner import (EncDecRunner, make_runner,
                                      recurrent_mixer_names)
from test_torch_decoder_family import fast_jit
from test_torch_recurrent import _rel
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

# f32 end to end: both sides sum in other orders through every layer, as
# tests/test_torch_decoder_family.py
LOGIT_TOL = 1e-4
# one attention call in f32 (tests/test_conformance.py REL_TOL)
ATT_TOL = 2e-5
CACHE_LEN = 16
# port impl -> the JAX package's impl it is held against
IMPLS = {"paper": "paper", "pallas": "freq"}
MODES = ("unfrozen", "fp32", "int8")


def _cfgs(impl="pallas", **kw):
    """The SMOKE config on both sides with ``impl`` (and ``kw``)."""
    j = dataclasses.replace(jmod.SMOKE, swm=JSWM(block_size=8,
                                                 impl=IMPLS[impl]), **kw)
    t = dataclasses.replace(tmod.SMOKE, swm=TSWM(block_size=8, impl=impl),
                            **kw)
    return j, t


@functools.lru_cache(maxsize=None)
def _trees():
    """{mode: JAX param tree} of the smoke model, built once per process
    (the specs do not depend on the impl)."""
    specs = JEncDec(_cfgs()[0]).specs()
    p = fast_jit(lambda: jinit(specs, 0))()
    fz, i8 = fast_jit(lambda p: (
        jplan.freeze_params(specs, p),
        jplan.freeze_params(specs, jplan.freeze_params(specs, p), "int8")))(p)
    return {"unfrozen": p, "fp32": fz, "int8": i8}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _port(tcfg, jparams):
    tm = build_model(tcfg, device="cpu")
    load_tree(tm, convert.from_reference(tcfg, _np(jparams), device="cpu"))
    return tm


def _frames(cfg, B=2, T=None, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (B, T or cfg.enc_seq, cfg.d_model)).astype(np.float32)


def _inputs():
    """Row 0: a full 10-token prompt; row 1: 7 tokens left-padded by three
    lanes with negative (masked) positions."""
    r = np.random.default_rng(11)
    toks = r.integers(1, 256, (2, 10)).astype(np.int32)
    toks[1, :3] = 0
    pos = np.stack([np.arange(10), np.arange(-3, 7)]).astype(np.int32)
    return toks, pos


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", ["flash", "direct"])
def test_bidirectional_attention_matches_reference(path):
    """``causal=False`` on both attention paths, with masked (negative)
    key positions and keys after the queries, against the reference's."""
    r = np.random.default_rng(3)
    B, Sq, Skv, HKV, G, hd = 2, 12, 20, 2, 2, 8
    q = r.standard_normal((B, Sq, HKV, G, hd)).astype(np.float32)
    k = r.standard_normal((B, Skv, HKV, hd)).astype(np.float32)
    v = r.standard_normal((B, Skv, HKV, hd)).astype(np.float32)
    qp = np.tile(np.arange(Sq, dtype=np.int32), (B, 1))
    kp = np.tile(np.arange(Skv, dtype=np.int32), (B, 1))
    kp[1, :5] = -1
    if path == "flash":
        kw = dict(q_chunk=5, kv_chunk=8)
        got = tatt.flash_attention(*_t(q, k, v, qp, kp), causal=False, **kw)
        ref = jatt.flash_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                   causal=False, **kw)
    else:
        got = tatt._direct_attention(*_t(q, k, v, qp, kp), causal=False)
        ref = jatt._direct_attention(*map(jnp.asarray, (q, k, v, qp, kp)),
                                     causal=False, window=0, prefix_len=0,
                                     softcap=0.0)
    assert _rel(got.numpy(), ref) <= ATT_TOL
    # keys after every query are seen: the causal result differs
    causal = tatt._direct_attention(*_t(q, k, v, qp, kp))
    assert np.abs(causal.numpy() - got.numpy()).max() > 1e-3


@pytest.mark.parametrize("mode", ["unfrozen", "fp32"])
def test_cross_attention_matches_reference(mode):
    """Cross attention of the first decoder layer: no cache (k/v from the
    encoder output), the prefill stash into a cross cache and a decode
    step that reads it back, against the reference
    ``Attention(cfg, cross=True)``. A frozen tree carries a ``_fused`` QKV
    table on cross attention too, never read: poisoning it changes
    nothing."""
    jcfg, tcfg = _cfgs()
    jp = _trees()[mode]["decoder"]["cross_attn"]
    jp0 = jax.tree.map(lambda a: a[0], jp)
    tp = convert.tree_from_reference(_np(jp0), device="cpu")
    assert (tplan.FUSED_KEY in tp) == (mode == "fp32")
    if mode == "fp32":
        tp[tplan.FUSED_KEY] = {n: torch.full_like(t, float("nan"))
                               for n, t in tp[tplan.FUSED_KEY].items()}
    ta = tatt.Attention(tcfg, cross=True)
    load_tree(ta, tp)
    ja = jatt.Attention(jcfg, cross=True)
    r = np.random.default_rng(4)
    T = jcfg.enc_seq
    x = r.standard_normal((2, 5, jcfg.d_model)).astype(np.float32)
    enc = r.standard_normal((2, T, jcfg.d_model)).astype(np.float32)
    qp = np.stack([np.arange(5), np.arange(-2, 3)]).astype(np.int32)
    ep = np.tile(np.arange(T, dtype=np.int32), (2, 1))
    jx, jenc, jqp, jep = map(jnp.asarray, (x, enc, qp, ep))

    ref, _ = ja(jp0, jx, jqp, kv_x=jenc, kv_positions=jep)
    with torch.no_grad():
        got, _ = ta(*_t(x, qp), kv_x=torch.from_numpy(enc),
                    kv_positions=torch.from_numpy(ep))
    assert _rel(got.numpy(), ref) <= ATT_TOL

    jc = jatt.init_kv_cache(2, T, jcfg.n_kv_heads, jcfg.head_dim,
                            jnp.float32)
    ref_p, jc = ja(jp0, jx, jqp, cache=jc, kv_x=jenc, kv_positions=jep)
    x1 = r.standard_normal((2, 1, jcfg.d_model)).astype(np.float32)
    p1 = np.array([[5], [3]], np.int32)
    ref_d, jc = ja(jp0, jnp.asarray(x1), jnp.asarray(p1), cache=jc,
                   update_cache=False)
    tc = tatt.init_kv_cache(2, T, tcfg.n_kv_heads, tcfg.head_dim,
                            torch.float32, "cpu")
    with torch.no_grad():
        got_p, tc = ta(*_t(x, qp), cache=tc, kv_x=torch.from_numpy(enc),
                       kv_positions=torch.from_numpy(ep))
        got_d, tc = ta(*_t(x1, p1), cache=tc)
    assert _rel(got_p.numpy(), ref_p) <= ATT_TOL
    assert _rel(got_d.numpy(), ref_d) <= ATT_TOL
    assert np.array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("k", "v"):
        assert _rel(tc[key].numpy(), jc[key]) <= ATT_TOL


def test_encoder_flash_path_matches_reference():
    """The encoder with ``flash_q_chunk``/``flash_kv_chunk`` below the
    frames' length: every encoder attention takes the bidirectional flash
    loops."""
    jcfg, tcfg = _cfgs(flash_q_chunk=4, flash_kv_chunk=8)
    p = _trees()["fp32"]
    frames = _frames(jcfg)
    jm = JEncDec(jcfg)
    ref, _ = fast_jit(jm.encode)(p, jnp.asarray(frames))
    with torch.no_grad():
        got, pos = _port(tcfg, p).encode(torch.from_numpy(frames))
    assert _rel(got.numpy(), ref) <= LOGIT_TOL
    assert pos.shape == (2, jcfg.enc_seq) and int(pos.min()) == 0


# ---------------------------------------------------------------------------
# EncDecLM
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("impl", sorted(IMPLS))
@pytest.mark.parametrize("mode", MODES)
def test_encode_and_forward_match_reference(impl, mode):
    """``encode`` and the teacher-forced ``forward`` (every position's and
    the last position's logits) against the JAX package."""
    jcfg, tcfg = _cfgs(impl)
    p = _trees()[mode]
    jm = JEncDec(jcfg)
    frames = _frames(jcfg)
    toks, _ = _inputs()

    def ref_fn(p, f, t):
        return (jm.encode(p, f)[0], jm.forward(p, f, t)[0],
                jm.forward(p, f, t, logits_mode="last")[0])

    enc, full, last = fast_jit(ref_fn)(p, jnp.asarray(frames),
                                       jnp.asarray(toks))
    tm = _port(tcfg, p)
    f, t = torch.from_numpy(frames), torch.from_numpy(toks).long()
    with torch.no_grad():
        got_enc, _ = tm.encode(f)
        got_full, cache = tm.forward(f, t)
        got_last, _ = tm.forward(f, t, logits_mode="last")
    assert cache is None
    assert got_full.shape == (2, toks.shape[1], jcfg.vocab)
    assert got_last.shape == (2, 1, jcfg.vocab)
    assert _rel(got_enc.numpy(), enc) <= LOGIT_TOL
    assert _rel(got_full.numpy(), full) <= LOGIT_TOL
    assert _rel(got_last.numpy(), last) <= LOGIT_TOL


def _check_caches(tcache, jcache):
    for part in ("self", "cross"):
        for i, got in enumerate(tcache[part]):
            ref = {k: np.asarray(v)[i] for k, v in jcache[part].items()}
            assert sorted(got) == sorted(ref)
            assert np.array_equal(got["pos"].numpy(), ref["pos"]), part
            for key in ("k", "v"):
                assert _rel(got[key].numpy(), ref[key]) <= LOGIT_TOL, part


@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_reference(mode):
    """Prefill over left-padded rows into fresh caches (the self rings and
    the cross caches), then 3 decode steps that read the cross K/V back,
    against the JAX package: logits and both caches."""
    jcfg, tcfg = _cfgs()
    p = _trees()[mode]
    jm = JEncDec(jcfg)
    frames = _frames(jcfg)
    toks, pos = _inputs()
    jlog, jcache, _ = fast_jit(lambda p, f, t, ps, c: jm.forward(
        p, f, t, cache=c, positions=ps))(
        p, jnp.asarray(frames), jnp.asarray(toks), jnp.asarray(pos),
        jm.init_cache(2, CACHE_LEN))
    tm = _port(tcfg, p)
    with torch.no_grad():
        tlog, tcache = tm.forward(*_t(frames), torch.from_numpy(toks).long(),
                                  cache=tm.init_cache(2, CACHE_LEN),
                                  positions=torch.from_numpy(pos))
    real = pos >= 0
    assert _rel(tlog.numpy()[real], np.asarray(jlog)[real]) <= LOGIT_TOL
    _check_caches(tcache, jcache)
    assert [c["k"].shape[1] for c in tcache["cross"]] == [jcfg.enc_seq] * 2
    jdecode = fast_jit(jm.decode_step)
    nxt = np.asarray(jlog)[:, -1].argmax(-1).astype(np.int32)
    cur = pos[:, -1] + 1
    for _ in range(3):
        jl, jcache = jdecode(p, jnp.asarray(nxt[:, None]), jcache,
                             jnp.asarray(cur))
        with torch.no_grad():
            tl, tcache = tm.decode_step(torch.from_numpy(nxt[:, None]).long(),
                                        tcache, torch.from_numpy(cur))
        assert _rel(tl.numpy(), jl) <= LOGIT_TOL
        nxt = np.asarray(jl).argmax(-1).astype(np.int32)
        cur = cur + 1
    _check_caches(tcache, jcache)


def test_decode_consistency():
    """Prefill then decode steps equal the full forward (the mirror of
    ``tests/test_models_smoke.py::test_encdec_decode_consistency``), on
    the port alone."""
    _, tcfg = _cfgs("paper")
    tm = _port(tcfg, _trees()["unfrozen"])
    B, S = 2, 10
    frames = torch.from_numpy(_frames(tcfg, B))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab, (B, S)))
    with torch.no_grad():
        full, _ = tm.forward(frames, toks)
        Sp = S - 3
        out, cache = tm.forward(frames, toks[:, :Sp],
                                cache=tm.init_cache(B, 16))
        np.testing.assert_allclose(out[:, -1].numpy(),
                                   full[:, Sp - 1].numpy(), rtol=1e-4,
                                   atol=1e-4)
        for t in range(Sp, S):
            pos = torch.full((B,), t, dtype=torch.int32)
            lg, cache = tm.decode_step(toks[:, t:t + 1], cache, pos)
            np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                       rtol=1e-4, atol=1e-4)


def test_forward_hidden_and_output_table_match_reference():
    jcfg, tcfg = _cfgs()
    p = _trees()["unfrozen"]
    jm = JEncDec(jcfg)
    frames = _frames(jcfg)
    toks, _ = _inputs()
    jh, jaux = fast_jit(lambda p, t, f: jm.forward_hidden(p, t, frames=f))(
        p, jnp.asarray(toks), jnp.asarray(frames))
    tm = _port(tcfg, p)
    with torch.no_grad():
        th, taux = tm.forward_hidden(torch.from_numpy(toks).long(),
                                     frames=torch.from_numpy(frames))
    assert th.shape == (2, toks.shape[1], jcfg.d_model)
    assert _rel(th.numpy(), jh) <= LOGIT_TOL
    assert float(taux) == float(jaux) == 0.0
    assert np.array_equal(tm.output_table().numpy(),
                          np.asarray(jm.output_table(p)))


def test_convert_round_trip():
    """One reference tree loads into the port and exports back leaf for
    leaf, frozen and int8 trees (cross ``_fused`` included) too; the
    port's own init has the reference's layout."""
    _, tcfg = _cfgs()
    for tree in _trees().values():
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
    assert sorted(tm.specs()) == ["dec_norm", "decoder", "embed", "enc_norm",
                                  "encoder"]
    assert sorted(tm.specs()["decoder"]["1"]) == [
        "cross_attn", "ffn", "ln1", "ln2", "ln_x", "self_attn"]
    mine = convert.to_reference(tcfg, init_params(tm.specs(), 0, "cpu"))
    shape = lambda t: jax.tree.map(lambda a: (a.shape, str(a.dtype)), t)
    assert shape(mine) == shape(_np(_trees()["unfrozen"]))


# ---------------------------------------------------------------------------
# Runner and engine
# ---------------------------------------------------------------------------

# tests/test_runner.py's _BASE and _cfg_encdec, with the pallas impl
_BASE = dict(name="rt", d_model=32, n_heads=2, n_kv_heads=2, head_dim=16,
             d_ff=64, vocab=48, remat="none", param_dtype="float32",
             compute_dtype="float32", family="encdec", n_layers=2,
             n_enc_layers=2, enc_seq=8)


def _cfg_encdec():
    return (JConfig(**_BASE, swm=JSWM(block_size=8, impl="pallas")),
            TConfig(**_BASE, swm=TSWM(block_size=8, impl="pallas")))


@functools.lru_cache(maxsize=None)
def _runner_setup():
    jcfg, tcfg = _cfg_encdec()
    jm = JEncDec(jcfg)
    specs = jm.specs()
    return jcfg, tcfg, jm, fast_jit(lambda: jinit(specs, 0))()


def _reqs(cfg, req_cls, seed=7, lens=(3, 9, 5, 12, 2, 7), max_new=3):
    """tests/test_runner.py's ``_reqs``: mixed prompt lengths, so bucketed
    admission pads, each with its encoder frames."""
    rng = np.random.default_rng(seed)
    out = []
    for L in lens:
        extra = rng.standard_normal(
            (cfg.enc_seq, cfg.d_model)).astype(np.float32)
        out.append(req_cls(
            prompt=rng.integers(1, cfg.vocab, size=L).astype(np.int32),
            max_new=max_new, extra=extra))
    return out


def _b1_oracle(runner, reqs):
    """Greedy B = 1 loop through the runner: the exact prompt length,
    fresh state per request, the request's frames."""
    outs = []
    for r in reqs:
        p = torch.from_numpy(np.asarray(r.prompt, np.int64))[None]
        L = p.shape[1]
        state = runner.init_state(1)
        slot = torch.zeros(1, dtype=torch.long)
        lg, ok, state = runner.prefill(p, torch.arange(L)[None], state, slot,
                                       extra=torch.from_numpy(r.extra)[None])
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


def _engine(tcfg, tree, **kw):
    return teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg,
                            convert.from_reference(tcfg, _np(tree), "cpu"),
                            **kw)


def test_bucketed_matches_b1():
    """The mirror of ``tests/test_runner.py::test_bucketed_matches_b1
    [encdec]``: left-padded bucketed prefill and compacted decode give the
    tokens of the unbucketed B = 1 loop."""
    jcfg, tcfg, jm, p = _runner_setup()
    eng = _engine(tcfg, p, batch=4, cache_len=32)
    assert type(eng.runner) is EncDecRunner
    reqs = _reqs(tcfg, teng.Request)
    outs = eng.generate(reqs)
    assert any(b > 1 for b, _ in eng.stats.prefill_shapes)
    assert eng.stats.padded_prompt_tokens > 0
    assert outs == _b1_oracle(eng.runner, reqs)
    assert eng.prefill_compiles <= eng.max_prefill_variants
    assert eng.decode_compiles <= eng.max_decode_variants


def test_engine_tokens_match_reference():
    """Greedy tokens of the port's engine equal the JAX engine's for the
    same requests and frames: one left-padded (4, 16) prefill, then decode
    at 4 rows while requests of different lengths finish."""
    jcfg, tcfg, jm, p = _runner_setup()
    kw = dict(batch=4, cache_len=24, prompt_buckets=(16,),
              decode_buckets=(4,))
    je = jeng.ServeEngine(jm, jcfg, p, **kw)
    te = _engine(tcfg, p, **kw)
    jreqs = _reqs(jcfg, jeng.Request, seed=3, lens=(4, 13, 2, 9))
    treqs = _reqs(tcfg, teng.Request, seed=3, lens=(4, 13, 2, 9))
    for i, (jr, tr) in enumerate(zip(jreqs, treqs)):
        jr.max_new = tr.max_new = 2 + i
    tout = te.generate(treqs)
    assert tout == je.generate(jreqs)
    assert te.stats.prefill_shapes == je.stats.prefill_shapes == {(4, 16)}
    assert te.stats.decode_shapes == je.stats.decode_shapes
    assert te.frozen_table_bytes() == je.frozen_table_bytes()


def test_frozen_table_bytes_match_reference():
    """The frozen smoke tree's resident table bytes, cross attention's
    ``_fused`` copies included (freezing cannot tell cross from self
    attention), equal the JAX package's, fp32 and int8."""
    jcfg, tcfg = _cfgs()
    for mode in ("fp32", "int8"):
        jtree = _trees()[mode]
        ttree = convert.from_reference(tcfg, _np(jtree), device="cpu")
        for layer in ttree["decoder"].values():
            assert tplan.FUSED_KEY in layer["cross_attn"]
            assert tplan.FUSED_KEY in layer["self_attn"]
        assert (tplan.frozen_table_bytes(ttree)
                == jplan.frozen_table_bytes(jtree))
        frozen = tplan.freeze_params(
            build_model(tcfg, device="cpu").specs(),
            convert.from_reference(tcfg, _np(_trees()["unfrozen"]), "cpu"),
            quantize="off" if mode == "fp32" else "int8")
        assert (tplan.frozen_table_bytes(frozen)
                == jplan.frozen_table_bytes(jtree))


def test_encdec_request_validation():
    """The mirror of ``tests/test_runner.py::
    test_encdec_request_validation``."""
    jcfg, tcfg, jm, p = _runner_setup()
    eng = _engine(tcfg, p, batch=2, cache_len=32)
    with pytest.raises(ValueError, match="encoder frames"):
        eng.generate([teng.Request(prompt=np.arange(1, 5, dtype=np.int32),
                                   max_new=2)])
    with pytest.raises(ValueError, match="shape"):
        eng.submit(teng.Request(prompt=np.arange(1, 5, dtype=np.int32),
                                max_new=2, extra=np.zeros((3, 3),
                                                          np.float32)))


def test_decoder_extra_rejected():
    """The mirror of ``tests/test_runner.py::test_decoder_extra_rejected``:
    a decoder runner refuses a request with ``extra``."""
    cfg = TConfig(**{k: v for k, v in _BASE.items()
                     if k not in ("family", "n_enc_layers", "enc_seq")},
                  swm=TSWM(block_size=8, impl="pallas"))
    model = build_model(cfg, device="cpu")
    eng = teng.ServeEngine(model, cfg, init_params(model.specs(), 0, "cpu"),
                           batch=2, cache_len=32)
    bad = teng.Request(prompt=np.arange(1, 5, dtype=np.int32), max_new=2,
                       extra=np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="extra"):
        eng.generate([bad])
    with pytest.raises(ValueError, match="extra"):
        eng.submit(bad)


def test_runner_choice_and_flags():
    _, tcfg = _cfg_encdec()
    runner = make_runner(build_model(tcfg, device="cpu"), tcfg, 32)
    assert type(runner) is EncDecRunner
    assert recurrent_mixer_names(tcfg) == ()
    assert runner.requires_extra and not runner.supports_prefix_cache
    assert "prefix_cache=False" in runner.prefix_cache_unsupported_reason
    assert runner.enc_len == 8
    no_enc = dataclasses.replace(tcfg, enc_seq=0)
    assert make_runner(None, no_enc, 32).enc_len == 32
    state = runner.init_state(3)
    assert [c["k"].shape[:2] for c in state["self"]] == [(3, 32)] * 2
    assert [c["k"].shape[:2] for c in state["cross"]] == [(3, 8)] * 2


def test_configs_and_build_model():
    """CONFIG and SMOKE copied field for field; the registry serves the
    arch; ``build_model`` gives ``EncDecLM`` and defaults to the card."""
    for which in ("CONFIG", "SMOKE"):
        assert (dataclasses.asdict(getattr(tmod, which))
                == dataclasses.asdict(getattr(jmod, which))), which
    assert ARCHS["seamless-m4t-medium"] == tmod.__name__
    assert type(build_model(tmod.SMOKE, device="cpu")) is EncDecLM
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            build_model(get_config("seamless-m4t-medium"))


def test_launcher_serves_smoke_on_cpu(capsys):
    outs = tlaunch.main(["--model", "seamless-m4t-medium", "--smoke",
                         "--device", "cpu", "--batch", "2", "--cache-len",
                         "16", "--n-requests", "3", "--max-new", "3"])
    assert [len(o) for o in outs] == [3, 3, 3]
    assert "request 2:" in capsys.readouterr().out
