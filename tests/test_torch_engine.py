"""Port parity: the continuous-batching engine (repro_torch.serve.engine)
against the JAX reference engine on the qwen3 smoke model with the kernel
impl, the same JAX-initialized params and the same request mix. Token
streams and launch-shape sets must be identical; the frozen tables are
computed exactly once per engine lifetime."""

import dataclasses

import jax
import numpy as np
import pytest

from repro.configs import qwen3_0_6b as jq
from repro.configs.base import SWMConfig as JSWM
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro.serve import engine as jeng
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.kernels.block_circulant import ops as tops
from repro_torch.kernels.block_circulant.plan import count_frozen_tables
from repro_torch.launch.specs import build_model
from repro_torch.serve import engine as teng
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")


@pytest.fixture(scope="module")
def models():
    jcfg = dataclasses.replace(jq.SMOKE, swm=JSWM(block_size=8,
                                                  impl="pallas"))
    tcfg = dataclasses.replace(tq.SMOKE, swm=TSWM(block_size=8,
                                                  impl="pallas"))
    jm = JLM(jcfg)
    jparams = jax.jit(lambda: jinit(jm.specs(), 0))()
    return jcfg, tcfg, jm, jparams, jax.tree.map(np.asarray, jparams)


def _mix(mod, seed, n, sampled):
    """The same request mix for either engine module: prompt lengths 1-11,
    budgets 1-6, a stop token, and (optionally) seeded top-k sampling."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        prompt = rng.integers(0, 256, size=int(rng.integers(1, 12)))
        sp = (mod.SamplingParams(temperature=0.8, top_k=20, seed=i)
              if sampled and i % 2 else mod.SamplingParams())
        out.append(mod.Request(prompt.astype(np.int32),
                               max_new=int(rng.integers(1, 7)),
                               stop_tokens=(7,), sampling=sp))
    return out


# (batch, policy, prompt_buckets, decode_buckets, sampled)
CASES = [(4, "fifo", (4, 8, 16), None, True),
         (2, "sjf", None, (1, 2), False)]


@pytest.mark.parametrize("batch,policy,pbk,dbk,sampled", CASES)
def test_engine_streams_match_reference(models, batch, policy, pbk, dbk,
                                        sampled):
    jcfg, tcfg, jm, jparams, np_params = models
    kw = dict(prompt_buckets=pbk, decode_buckets=dbk, policy=policy)
    je = jeng.ServeEngine(jm, jcfg, jparams, batch=batch, cache_len=24, **kw)
    tm = build_model(tcfg, device="cpu")
    n0 = tops.freq_weights_trace_count()
    te = teng.ServeEngine(tm, tcfg,
                          convert.from_reference(tcfg, np_params, "cpu"),
                          batch=batch, cache_len=24, **kw)
    n_frozen = count_frozen_tables(te.params)
    assert n_frozen == 7 * tcfg.n_layers
    assert tops.freq_weights_trace_count() - n0 == n_frozen
    assert (te.batch_buckets, te.prompt_buckets, te.decode_buckets) == (
        je.batch_buckets, je.prompt_buckets, je.decode_buckets)

    for seed, n in ((1, 7), (2, 3)):          # two generate calls, one engine
        jout = je.generate(_mix(jeng, seed, n, sampled))
        tout = te.generate(_mix(teng, seed, n, sampled))
        assert tout == jout
    assert te.stats.prefill_shapes == je.stats.prefill_shapes
    assert te.stats.decode_shapes == je.stats.decode_shapes
    for f in ("prefill_calls", "decode_steps", "tokens_generated",
              "padded_prompt_tokens", "slot_steps_active", "decode_rows"):
        assert getattr(te.stats, f) == getattr(je.stats, f), f
    assert te.prefill_compiles <= te.max_prefill_variants
    assert te.decode_compiles <= te.max_decode_variants
    # freeze once: no rfft(w) across the whole serving lifetime
    assert tops.freq_weights_trace_count() - n0 == n_frozen


def test_streaming_api_and_int8(models):
    jcfg, tcfg, jm, jparams, np_params = models
    tm = build_model(tcfg, device="cpu")
    params = convert.from_reference(tcfg, np_params, "cpu")
    eng = teng.ServeEngine(tm, tcfg, params, batch=2, cache_len=16,
                           quantize="int8")
    rid = eng.submit(teng.Request(np.arange(5, dtype=np.int32), max_new=3))
    assert eng.poll(rid).status == teng.QUEUED
    eng.step()
    st = eng.poll(rid)
    assert st.status == teng.RUNNING and len(st.tokens) == 2
    out = eng.drain()
    assert list(out) == [rid]
    assert len(out[rid]) == 3 and out[rid][:2] == list(st.tokens)
    with pytest.raises(KeyError):
        eng.poll(rid)
    fp32 = teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg, params,
                            batch=2, cache_len=16)
    assert eng.frozen_table_bytes() < 0.55 * fp32.frozen_table_bytes()


@pytest.mark.parametrize("bad", [dict(prompt=np.zeros(0, np.int32)),
                                 dict(max_new=0),
                                 dict(prompt=np.zeros(17, np.int32)),
                                 dict(prompt=np.zeros(10, np.int32),
                                      max_new=8)])
def test_admission_errors_match_reference(models, bad):
    jcfg, tcfg, jm, jparams, np_params = models
    args = dict(prompt=np.arange(4, dtype=np.int32), max_new=2)
    args.update(bad)
    with pytest.raises(ValueError) as ej:
        jeng._validate_request(jeng.Request(**args), 16)
    with pytest.raises(ValueError) as et:
        teng._validate_request(teng.Request(**args), 16)
    assert str(et.value) == str(ej.value)


def test_bucket_helpers_match_reference():
    for lo, hi in ((1, 1), (1, 6), (8, 128), (3, 40)):
        assert teng.pow2_buckets(lo, hi) == jeng.pow2_buckets(lo, hi)
    for m in range(0, 13):
        assert teng.batch_split(m, (1, 2, 4, 8)) == jeng.batch_split(
            m, (1, 2, 4, 8))
    assert teng.pick_bucket(5, (4, 8)) == 8
    with pytest.raises(ValueError):
        teng.batch_split(3, (2,))
    assert teng.validate_buckets("b", (2, 8, 2), 16) == (2, 8, 16)
    with pytest.raises(ValueError):
        teng.validate_buckets("b", (0, 4), 16)
    with pytest.raises(ValueError):
        teng.Scheduler("lifo")
    rng = np.random.default_rng(0)
    logits = rng.standard_normal(64).astype(np.float32)
    for sp in (teng.SamplingParams(), teng.SamplingParams(0.7, 5, 3),
               teng.SamplingParams(1.3, 0, 9)):
        jsp = jeng.SamplingParams(sp.temperature, sp.top_k, sp.seed)
        a = [teng._sample_token(logits, sp, r)
             for r in [sp.make_rng()] for _ in range(20)]
        b = [jeng._sample_token(logits, jsp, r)
             for r in [jsp.make_rng()] for _ in range(20)]
        assert a == b
