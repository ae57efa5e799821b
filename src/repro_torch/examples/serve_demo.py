"""Serving demo on the port, the torch version of ``examples/serve_demo.py``.

Trains a tiny SWM LM briefly, then serves it: a mixed-length,
mixed-budget batch through the continuous-batching engine (per-slot
admission, bucketed prefill shapes, compacted decode buckets, per-request
sampling and stop tokens, frozen FFT(w)); the streaming
submit()/step()/poll()/drain() API serving an open-ended trickle;
shared-prefix KV reuse (later requests copy a donor slot's rows for the
shared head and prefill only their tails).

Then: int8 frozen tables (``quantize="int8"``, one f32 scale per
circulant block), whose greedy tokens equal serving the dequantized
tables in f32; an RWKV config served through ``RecurrentRunner``,
bucketed against an unbucketed B=1 loop through the same runner; the
failure semantics on a seeded ``ServeFaultInjector`` (a transient decode
fault retried, reject-new shedding, a deadline on a ``ManualClock``, a
cancel); and last a multi-tenant burst: three tenants of different SLO
classes submit through ``AsyncFrontend`` into a ``Supervisor``-owned
``fair``-policy engine whose DRR weights come from the same classes, and
an injected mid-stream engine fatal heals from the latest snapshot
(``restarts=1``).

The port keeps params in the model, so every engine here gets a model of
its own (two engines on one model would share its installed tables).

    PYTHONPATH=src python -m repro_torch.examples.serve_demo
    PYTHONPATH=src python -m repro_torch.examples.serve_demo --device cpu \
        --steps 20

Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import asyncio
import tempfile

import numpy as np
import torch

from repro_torch.configs.base import (LayerGroup, LayerSpec, ModelConfig,
                                      SWMConfig, TrainConfig)
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.kernels.block_circulant.plan import dequantize_frozen
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params, tree_map
from repro_torch.serve.engine import Request, SamplingParams, ServeEngine
from repro_torch.serve.frontend import AsyncFrontend, TenantConfig
from repro_torch.serve.guard import (ManualClock, QueueFullError,
                                     ServeFaultInjector)
from repro_torch.serve.runner import make_runner
from repro_torch.serve.supervisor import Supervisor
from repro_torch.train.loop import init_train_state, make_train_step

CONFIG = ModelConfig(
    name="serve-demo", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
    head_dim=16, d_ff=128, vocab=128,
    swm=SWMConfig(block_size=8, impl="dft"),
    remat="none", param_dtype="float32", compute_dtype="float32",
)
RWKV_CONFIG = ModelConfig(
    name="serve-demo-rwkv", n_layers=2, d_model=64, n_heads=4,
    n_kv_heads=2, head_dim=16, d_ff=128, vocab=128,
    rwkv_head_dim=16, rwkv_decay_lora=8, rwkv_mix_lora=8,
    groups=(LayerGroup(layers=(LayerSpec(mixer="rwkv", ffn="dense"),),
                       repeat=2),),
    swm=SWMConfig(block_size=8, impl="dft"),
    remat="none", param_dtype="float32", compute_dtype="float32",
)
# prompts from the training distribution (+1..+6 drifts)
PROMPTS = [np.array([5, 9, 14, 18, 21], np.int32),
           np.array([100, 104, 107], np.int32),
           np.array([50, 53], np.int32),
           np.array([7, 11, 16, 19, 25, 28], np.int32),
           np.array([64, 70, 75], np.int32),
           np.array([30, 33, 37, 40], np.int32)]


def train(steps: int, dev):
    """``steps`` AdamW steps of CONFIG on ``SyntheticLM``; the trained
    params, detached."""
    cfg = CONFIG
    tcfg = TrainConfig(learning_rate=5e-3, warmup_steps=10,
                       total_steps=steps, z_loss=0.0)
    model = build_model(cfg, device=dev)
    state = init_train_state(init_params(model.specs(), 0, device=dev), tcfg)
    step = make_train_step(model, cfg, tcfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=48, batch=16)
    metrics = {"loss": float("nan")}
    for s in range(steps):
        tokens = torch.from_numpy(data.batch_np(s)["tokens"]).to(dev)
        state, metrics = step(state, {"tokens": tokens})
    print(f"trained {steps} steps, final loss {float(metrics['loss']):.3f}")
    return tree_map(lambda t: t.detach(), state["params"])


def engine(params, dev, cfg=CONFIG, **kw):
    """A ServeEngine on a model of its own."""
    kw.setdefault("batch", 4)
    kw.setdefault("cache_len", 64)
    kw.setdefault("prompt_buckets", (8, 16))
    return ServeEngine(build_model(cfg, device=dev), cfg, params, **kw)


def continuous(params, dev):
    # 4 slots, prompt buckets 8/16, decode buckets 1/2/4: a request is
    # admitted the moment a slot frees, and a tailing batch decodes in a
    # smaller bucket instead of stepping all 4 slot rows
    eng = engine(params, dev, decode_buckets=(1, 2, 4), policy="sjf",
                 prefix_cache=True)
    reqs = [
        Request(PROMPTS[0], max_new=8),                       # greedy
        Request(PROMPTS[1], max_new=3),                       # short budget
        Request(PROMPTS[2], max_new=12),                      # long budget
        Request(PROMPTS[3], max_new=8,
                stop_tokens=tuple(range(120, 128))),          # stop band
        Request(PROMPTS[4], max_new=8,
                sampling=SamplingParams(temperature=0.7, top_k=8, seed=7)),
        Request(PROMPTS[5], max_new=6),
    ]
    for r, o in zip(reqs, eng.generate(reqs)):
        tag = ("sampled" if r.sampling.temperature > 0 else
               "stop" if r.stop_tokens else "greedy")
        print(f"prompt {np.asarray(r.prompt).tolist()} [{tag:7s} "
              f"max_new={r.max_new:2d}] -> {o}")
    s = eng.stats
    print(f"prefill shapes {sorted(s.prefill_shapes)} "
          f"({eng.prefill_compiles} shapes, bound "
          f"{eng.max_prefill_variants}); decode shapes "
          f"{sorted(s.decode_shapes)} ({eng.decode_compiles} shapes, bound "
          f"{eng.max_decode_variants}); tokens/decode-step "
          f"{s.tokens_per_decode_step:.2f}; decode-rows/token "
          f"{s.decode_rows_per_token:.2f}")

    # streaming: submit() returns an id at once, step() runs one admission
    # + decode round, poll() reads partial tokens, drain() finishes
    print("\nstreaming trickle:")
    rids = []
    for i, p in enumerate(PROMPTS[:4]):
        rid = eng.submit(Request(p, max_new=4 + 2 * i))
        rids.append(rid)
        eng.step()                          # requests decode while we submit
        v = eng.poll(rid)
        print(f"  submitted req {rid}; poll -> done={v.done} "
              f"tokens={list(v.tokens)}")
    done = eng.drain(rids)
    for rid in rids:
        print(f"  req {rid} finished: {done[rid]}")

    # shared-prefix reuse: after one request prefills a 16-token head,
    # later ones copy its resident rows and prefill only their tails
    print("\nshared-prefix reuse:")
    head = np.array([3, 9, 14, 20, 25, 31, 36, 42, 47, 53, 58, 64,
                     69, 75, 80, 86], np.int32)
    tails = [np.array(t, np.int32) for t in
             ([90, 94], [101, 105, 110], [7, 12], [115, 120, 125],
              [50, 55], [33, 38, 44])]
    h0, s0 = eng.stats.prefix_hits, eng.stats.prefill_tokens_saved
    outs = eng.generate(
        [Request(np.concatenate([head, t]), max_new=4) for t in tails])
    for t, o in zip(tails, outs):
        print(f"  head+{t.tolist()} -> {o}")
    s = eng.stats
    print(f"  prefix hits {s.prefix_hits - h0}/{len(tails)}; prefill "
          f"tokens saved {s.prefill_tokens_saved - s0} "
          f"(lifetime hit rate {s.prefix_hit_rate:.2f})")


def quantized(params, dev) -> bool:
    # int8 tables with one f32 scale per circulant block, dequantized in
    # the serving math: the tokens equal the dequantized tables' in f32
    print("\nquantized serving (int8 frozen tables):")
    q_eng = engine(params, dev, decode_buckets=(1, 2, 4), quantize="int8")
    oracle = engine(dequantize_frozen(q_eng.params), dev,
                    decode_buckets=(1, 2, 4))
    greedy = [Request(p, max_new=6) for p in PROMPTS[:4]]
    outs_q = q_eng.generate(greedy)
    outs_o = oracle.generate([Request(p, max_new=6) for p in PROMPTS[:4]])
    for r, o in zip(greedy, outs_q):
        print(f"  prompt {np.asarray(r.prompt).tolist()} -> {o}")
    bytes_q, bytes_f = q_eng.frozen_table_bytes(), oracle.frozen_table_bytes()
    print(f"  int8 == dequantized-oracle outputs: {outs_q == outs_o}; "
          f"frozen table bytes {bytes_q} vs fp32 {bytes_f} "
          f"({bytes_q / bytes_f:.2f}x)")
    return outs_q == outs_o


def recurrent(dev) -> bool:
    # the RecurrentRunner's pad-invariant prefill makes left-padded
    # bucketed admission legal for stateful mixers: the bucketed tokens
    # equal an unbucketed B=1 loop through the same runner
    print("\nrecurrent family (rwkv):")
    rcfg = RWKV_CONFIG
    rmodel = build_model(rcfg, device=dev)
    reng = ServeEngine(rmodel, rcfg, init_params(rmodel.specs(), 0,
                                                 device=dev),
                       batch=4, cache_len=64, prompt_buckets=(8, 16),
                       decode_buckets=(1, 2, 4))
    print(f"  runner: {type(reng.runner).__name__} "
          f"(prefix cache supported: {reng.runner.supports_prefix_cache})")
    reqs = [Request(p, max_new=5) for p in PROMPTS[:4]]
    outs = reng.generate(reqs)
    runner = make_runner(rmodel, rcfg, 64)
    slot = torch.zeros(1, dtype=torch.int64, device=dev)
    ref = []
    for r in reqs:
        p = np.asarray(r.prompt, np.int64)
        st = runner.init_state(1)
        lg, _, st = runner.prefill(
            torch.from_numpy(p)[None].to(dev),
            torch.arange(len(p), dtype=torch.int32, device=dev)[None],
            st, slot)
        out, pos = [int(np.argmax(lg.float().cpu().numpy()[0]))], len(p)
        while len(out) < r.max_new:
            lg, _, st = runner.decode(
                torch.tensor([[out[-1]]], dtype=torch.int64, device=dev),
                st, torch.tensor([pos], dtype=torch.int64, device=dev),
                slot)
            out.append(int(np.argmax(lg.float().cpu().numpy()[0])))
            pos += 1
        ref.append(out)
    for r, o in zip(reqs, outs):
        print(f"  prompt {np.asarray(r.prompt).tolist()} -> {o}")
    print(f"  bucketed == unbucketed B=1: {outs == ref}")
    return outs == ref


def faults(params, dev):
    # a seeded fault schedule: a transient decode launch failure (retried),
    # reject-new shedding at max_queue, a deadline on a manual clock and a
    # cancel; every request ends in exactly one terminal state
    print("\nfault injection:")
    clk = ManualClock()
    inj = ServeFaultInjector(fail_decode_at={1}, clock=clk)
    eng = engine(params, dev, batch=2, max_queue=3, fault_injector=inj,
                 clock=clk)
    rids = [eng.submit(Request(PROMPTS[0], max_new=6)),
            eng.submit(Request(PROMPTS[1], max_new=6, deadline_ms=25.0)),
            eng.submit(Request(PROMPTS[2], max_new=8))]
    try:                                   # the queue is full: reject-new
        eng.submit(Request(PROMPTS[3], max_new=4))
    except QueueFullError as e:
        print(f"  shed: {e}")
    eng.cancel(rids[2])
    while eng.step():                      # each step "takes" 10 ms
        clk.advance(0.010)
    for rid in rids:
        v = eng.poll(rid)
        err = f" ({v.error})" if v.error else ""
        print(f"  req {rid}: {v.status}{err} tokens={list(v.tokens)}")
    fs = eng.stats
    print(f"  stats: rejected={fs.rejected} expired={fs.expired} "
          f"cancelled={fs.cancelled} retries={fs.launch_retries} "
          f"aborted={fs.aborted}")


def tenants_burst(params, dev) -> int:
    # three tenants burst through the asyncio front-end into a supervised
    # fair-policy engine: DRR weights from the SLO classes (interactive 4,
    # standard 2, batch 1), class deadlines stamped by the front-end, and a
    # mid-stream engine fatal healed from the latest snapshot
    print("\nmulti-tenant burst (fair DRR + SLOs + self-heal):")
    tenants = {
        "chat-app": TenantConfig("chat-app", slo="interactive"),
        "dashboard": TenantConfig("dashboard", slo="standard"),
        "nightly-jobs": TenantConfig("nightly-jobs", slo="batch"),
    }
    weights = {n: c.slo_class.weight for n, c in tenants.items()}
    inj = ServeFaultInjector(fatal_decode_at={8})
    # a manual clock ticked 10 ms per engine round (through the front-end's
    # injectable sleep) keeps the SLO deadlines independent of host speed
    clk = ManualClock()

    async def tick(s):
        clk.advance(max(float(s), 0.010))
        await asyncio.sleep(0)

    model = build_model(CONFIG, device=dev)
    with tempfile.TemporaryDirectory() as snap_dir:
        def factory():
            return ServeEngine(model, CONFIG, params, batch=4, cache_len=64,
                               prompt_buckets=(8, 16),
                               decode_buckets=(1, 2, 4), policy="fair",
                               tenant_weights=weights, snapshot_dir=snap_dir,
                               snapshot_every=2, clock=clk,
                               fault_injector=inj)

        sup = Supervisor(factory)
        fe = AsyncFrontend(sup, tenants, clock=clk, sleep=tick)

        async def feed(name):
            return [await fe.submit(name, Request(p, max_new=5))
                    for p in PROMPTS[:4]]

        async def burst():
            feeds = [asyncio.ensure_future(feed(n)) for n in sorted(tenants)]
            runner = asyncio.ensure_future(fe.run(idle_rounds=2))
            await asyncio.gather(*feeds)
            await runner

        asyncio.run(burst())
        while sup.step():                  # finish any straggler rounds
            pass
        st = sup.stats
        for name in sorted(tenants):
            ts = st.tenants[name]
            print(f"  {name:12s} [{tenants[name].slo:11s} "
                  f"w={tenants[name].slo_class.weight}] "
                  f"submitted={ts.submitted} admitted={ts.admitted} "
                  f"completed={ts.completed} "
                  f"ttft p50={ts.ttft_ms.p50} ms")
        print(f"  engine restarts={sup.restarts} "
              f"recoveries={st.recoveries}; fleet ttft "
              f"p50/p99 = {st.ttft_ms.p50}/{st.ttft_ms.p99} ms")
    return sup.restarts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=120,
                    help="training steps before serving")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = train(args.steps, dev)
    continuous(params, dev)
    int8_equal = quantized(params, dev)
    bucketed_equal = recurrent(dev)
    faults(params, dev)
    restarts = tenants_burst(params, dev)
    return {"int8_equal": int8_equal, "bucketed_equal": bucketed_equal,
            "restarts": restarts}


if __name__ == "__main__":
    main()
