"""Serving launcher: builds the model, initializes seeded demo params and
serves batched requests through the continuous-batching engine.

    PYTHONPATH=src python -m repro_torch.launch.serve --model qwen3-0.6b \
        --batch 4 --cache-len 128

``--model`` takes every id in ``configs/registry.ARCHS``: the nine
decoder-family archs, qwen3-0.6b, gemma3-27b (sliding-window rings),
paligemma-3b (text-only requests under its prefix-LM mask, as the
reference engine serves requests without ``extra``), deepseek-7b,
internlm2-20b, qwen3-moe-235b-a22b and arctic-480b through
``DecoderRunner`` and the recurrent hybrids jamba-v0.1-52b and rwkv6-7b
through ``RecurrentRunner``, and the enc-dec arch seamless-m4t-medium
through ``EncDecRunner`` (``serve/runner.make_runner``), whose requests
each carry seeded random encoder frames ``(enc_seq or cache_len,
d_model)`` in place of the stubbed speech frontend.
The circulant implementation (``impl``) comes from the config. The engine
freezes the frequency tables once at load, rounds prefill launches to
(batch-bucket, prompt-bucket) shapes and compacts decode launches to the
smallest decode bucket holding the active slots; ``--prewarm`` launches
every bucket shape once before serving. ``--engine wave`` serves through
the fixed-wave baseline ``WaveEngine`` instead (greedy, decoder-LM
configs, no request lifecycle). ``--prefix-cache on`` reuses resident KV
rows across requests sharing a prompt head (the demo prompts then share
two seeded heads); ``--deadline-ms``, ``--max-queue`` and ``--shed-policy``
set the request lifecycle's deadlines and load shedding; ``--stream``
drives the open-ended submit()/step()/poll()/drain() API instead of the
closed generate() call. ``--tenants name[:slo],...`` assigns requests
round-robin to tenants (``--slo-class`` is the default class);
``--stream --tenants`` serves them through the asyncio front-end
(``serve/frontend.AsyncFrontend``: per-tenant token buckets, SLO deadline
defaults, bounded retry on a full queue), and ``--fair`` admits by
weighted deficit round-robin with each tenant's SLO-class weight
(``--policy fair`` weighs every tenant 1). ``--ckpt-dir`` serves the
params of the latest train checkpoint there (``ft.checkpoint``, as
written by ``launch.train``) instead of seeded random ones;
``--snapshot-dir`` snapshots the engine's whole state every
``--snapshot-every`` steps (default 8), so a replacement engine can
``restore()`` it mid-stream. ``--device`` defaults to ``cuda`` and fails
without a card; ``--device cpu`` runs the plain PyTorch path. The engine
serves on one device, as the reference's launcher does (it has no
``--mesh``); sharded serving under a ``(data, model)`` mesh, the enc-dec
family's included, is ``serve.engine.make_prefill_step(mesh=)`` /
``make_decode_step(mesh=)``.
"""

from __future__ import annotations

import argparse
import asyncio
import time

import numpy as np
import torch

from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.device import resolve_device
from repro_torch.ft.checkpoint import latest_step, restore_checkpoint
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.serve.engine import (Request, SamplingParams, Scheduler,
                                      ServeEngine, WaveEngine)
from repro_torch.serve.frontend import (SLO_CLASSES, AsyncFrontend,
                                        TenantConfig, TenantRejectedError)
from repro_torch.serve.guard import QueueFullError
from repro_torch.serve.runner import recurrent_mixer_names


def _parse_buckets(ap: argparse.ArgumentParser, text: str, flag: str):
    """Comma-separated bucket list -> tuple of ints (ap.error otherwise)."""
    if not text:
        return None
    try:
        return tuple(int(tok) for tok in text.split(","))
    except ValueError:
        ap.error(f"{flag} must be comma-separated ints, got {text!r}")


def _parse_pos_int(ap: argparse.ArgumentParser, text: str, flag: str,
                   default: int) -> int:
    """Positive-int flag value (``default`` when unset; ap.error
    otherwise)."""
    if not text:
        return default
    try:
        v = int(text)
    except ValueError:
        ap.error(f"{flag} must be a positive int, got {text!r}")
    if v < 1:
        ap.error(f"{flag} must be a positive int, got {text!r}")
    return v


def _parse_pos_float(ap: argparse.ArgumentParser, text: str, flag: str):
    """Positive-float flag value (None when unset; ap.error otherwise)."""
    if not text:
        return None
    try:
        v = float(text)
    except ValueError:
        ap.error(f"{flag} must be a positive number, got {text!r}")
    if v <= 0:
        ap.error(f"{flag} must be a positive number, got {text!r}")
    return v


def _parse_tenants(ap: argparse.ArgumentParser, text: str,
                   default_slo: str):
    """``name[:slo],name[:slo],...`` -> {name: TenantConfig}; malformed
    entries and unknown SLO classes route through ap.error."""
    if not text:
        return {}
    out = {}
    for tok in text.split(","):
        tok = tok.strip()
        if not tok:
            ap.error(f"--tenants has an empty entry in {text!r}")
        name, _, slo = tok.partition(":")
        slo = slo or default_slo
        if slo not in SLO_CLASSES:
            ap.error(f"--tenants: unknown SLO class {slo!r} for tenant "
                     f"{name!r}; choices: {sorted(SLO_CLASSES)}")
        if name in out:
            ap.error(f"--tenants lists tenant {name!r} twice")
        out[name] = TenantConfig(name, slo=slo)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", default="",
                    help=f"registry model name, one of {sorted(ARCHS)}")
    ap.add_argument("--arch", default="", help="alias for --model")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="cache slots (continuous) / wave size (wave)")
    ap.add_argument("--cache-len", type=int, default=128)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--n-requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--engine", choices=("continuous", "wave"),
                    default="continuous")
    ap.add_argument("--policy", choices=Scheduler.POLICIES, default="fifo",
                    help="admission order: fifo | sjf (shortest prompt "
                         "first) | fair (deficit round-robin over tenants)")
    ap.add_argument("--prompt-buckets", default="",
                    help="comma-separated prompt-length buckets, e.g. 8,16,32 "
                         "(default: powers of two up to cache-len)")
    ap.add_argument("--decode-buckets", default="",
                    help="comma-separated decode batch buckets, e.g. 1,2,4 "
                         "(default: powers of two up to --batch)")
    ap.add_argument("--stream", action="store_true",
                    help="drive the streaming submit()/step()/poll()/drain() "
                         "API: requests trickle in while the engine runs")
    ap.add_argument("--prefix-cache", choices=("on", "off"), default="off",
                    help="reuse resident KV rows across requests sharing a "
                         "prompt head: admission copies the matched rows "
                         "from a donor slot and prefills only the tail")
    ap.add_argument("--prefix-capacity", default="",
                    help="max entries in the prefix index (LRU; default "
                         "256). Forgetting an entry never frees slot rows.")
    ap.add_argument("--deadline-ms", default="",
                    help="per-request time to live in milliseconds: a "
                         "step-boundary watchdog EXPIREs overdue requests "
                         "and recycles their slots")
    ap.add_argument("--max-queue", default="",
                    help="bound the admission queue: submissions at the "
                         "bound are load-shed per --shed-policy (default "
                         "unbounded)")
    ap.add_argument("--shed-policy", choices=Scheduler.SHED_POLICIES,
                    default="reject",
                    help="at the --max-queue bound: 'reject' new work "
                         "(backpressure) or 'drop-oldest' queued request")
    ap.add_argument("--snapshot-dir", default="",
                    help="serve-state snapshot directory: the engine "
                         "checkpoints its full state (slots, queue, KV "
                         "cache) every --snapshot-every steps so a "
                         "replacement engine can resume mid-stream")
    ap.add_argument("--snapshot-every", default="",
                    help="steps between automatic snapshots (default 8; "
                         "needs --snapshot-dir)")
    ap.add_argument("--prewarm", action="store_true",
                    help="launch every bucket shape once before serving "
                         "(continuous engine only)")
    ap.add_argument("--tenants", default="",
                    help="comma-separated tenant list, each 'name' or "
                         "'name:slo' (slo in interactive|standard|batch; "
                         "default from --slo-class). Requests are assigned "
                         "round-robin; with --stream the asyncio front-end "
                         "drives per-tenant token-bucket admission "
                         "(continuous engine only)")
    ap.add_argument("--slo-class", choices=sorted(SLO_CLASSES),
                    default="standard",
                    help="default SLO class for --tenants entries without "
                         "an explicit one: sets the deadline_ms default "
                         "and the DRR fairness weight")
    ap.add_argument("--fair", action="store_true",
                    help="shortcut for --policy fair with per-tenant DRR "
                         "weights taken from each tenant's SLO class "
                         "(needs --tenants)")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy")
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stop-token", type=int, action="append", default=[],
                    help="stop generation at this token id (repeatable)")
    ap.add_argument("--quantize", choices=("off", "int8"), default="off",
                    help="int8: freeze the circulant frequency tables as int8 "
                         "with per-block scales (dequantized in the kernel)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    args = ap.parse_args(argv)

    if bool(args.model) == bool(args.arch):
        ap.error("pass exactly one of --model / --arch (they are aliases)")
    arch = (args.model or args.arch).strip().lower().replace("_", "-")
    if arch not in ARCHS:
        ap.error(f"unknown model {arch!r}; choices: {sorted(ARCHS)}")
    prefix_cache = args.prefix_cache == "on"
    prefix_capacity = _parse_pos_int(ap, args.prefix_capacity,
                                     "--prefix-capacity", 256)
    if args.prefix_capacity and not prefix_cache:
        ap.error("--prefix-capacity has no effect without --prefix-cache on")
    deadline_ms = _parse_pos_float(ap, args.deadline_ms, "--deadline-ms")
    max_queue = (_parse_pos_int(ap, args.max_queue, "--max-queue", 0)
                 if args.max_queue else None)
    snapshot_dir = args.snapshot_dir or None
    snapshot_every = _parse_pos_int(ap, args.snapshot_every,
                                    "--snapshot-every", 8)
    if args.snapshot_every and not snapshot_dir:
        ap.error("--snapshot-every has no effect without --snapshot-dir")
    if args.shed_policy != "reject" and max_queue is None:
        ap.error("--shed-policy has no effect without --max-queue")
    tenants = _parse_tenants(ap, args.tenants, args.slo_class)
    if args.fair and not tenants:
        ap.error("--fair needs --tenants (the DRR weights come from each "
                 "tenant's SLO class)")
    policy = "fair" if args.fair else args.policy
    tenant_weights = None
    if args.fair:
        tenant_weights = {n: c.slo_class.weight for n, c in tenants.items()}
    cfg = get_smoke(arch) if args.smoke else get_config(arch)
    if args.engine == "wave":
        if args.temperature > 0 or args.top_k or args.stop_token:
            ap.error("--engine wave is a greedy-only baseline; "
                     "--temperature/--top-k/--stop-token need the "
                     "continuous engine")
        if (args.prompt_buckets or args.decode_buckets
                or args.policy != "fifo" or args.prewarm or args.stream
                or prefix_cache or args.prefix_capacity):
            ap.error("--prompt-buckets/--decode-buckets/--policy/--prewarm/"
                     "--stream/--prefix-cache/--prefix-capacity only apply "
                     "to the continuous engine")
        if (deadline_ms is not None or max_queue is not None
                or snapshot_dir or args.snapshot_every
                or args.shed_policy != "reject"):
            ap.error("--deadline-ms/--max-queue/--shed-policy/"
                     "--snapshot-dir/--snapshot-every only apply to the "
                     "continuous engine (WaveEngine has no request "
                     "lifecycle)")
        if tenants or args.fair:
            ap.error("--tenants/--fair only apply to the continuous "
                     "engine (WaveEngine has no admission queue)")
        # the wave baseline is decoder-LM only
        if cfg.family == "encdec":
            ap.error(f"--engine wave cannot serve enc-dec config {arch!r}: "
                     f"use the continuous engine (EncDecRunner)")
        mix = recurrent_mixer_names(cfg)
        if args.batch > 1 and mix:
            ap.error(f"--engine wave pads batched prompts and gives "
                     f"{'/'.join(mix)} layers no pad-validity guarantee: "
                     f"use the continuous engine (pad-aware "
                     f"RecurrentRunner) or --batch 1")
    device = resolve_device(args.device)
    model = build_model(cfg, device=device)
    # one directory scan per load
    step = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if step is not None:
        params = restore_checkpoint(args.ckpt_dir, step,
                                    device=device)["params"]
        print(f"restored checkpoint step {step}")
    else:
        params = init_params(model.specs(), args.seed, device=device)
        print(f"serving seeded random params (demo mode) on {device}, "
              f"impl={cfg.swm.impl}")
    if args.engine == "wave":
        engine = WaveEngine(model, cfg, params, batch=args.batch,
                            cache_len=args.cache_len,
                            quantize=args.quantize)
    else:
        try:
            engine = ServeEngine(
                model, cfg, params, batch=args.batch,
                cache_len=args.cache_len,
                prompt_buckets=_parse_buckets(ap, args.prompt_buckets,
                                              "--prompt-buckets"),
                decode_buckets=_parse_buckets(ap, args.decode_buckets,
                                              "--decode-buckets"),
                policy=policy, tenant_weights=tenant_weights,
                prefix_cache=prefix_cache, prefix_capacity=prefix_capacity,
                max_queue=max_queue, shed_policy=args.shed_policy,
                snapshot_dir=snapshot_dir,
                snapshot_every=snapshot_every if snapshot_dir else 0,
                quantize=args.quantize)
        except ValueError as e:
            # misconfiguration (bad bucket lists, prefix cache against a
            # runner that cannot donate rows) is a usage error, not a crash
            if "_buckets" in str(e) or "prefix_cache" in str(e):
                ap.error(str(e))
            raise
        print(f"buckets: batch={engine.batch_buckets} "
              f"prompt={engine.prompt_buckets} "
              f"decode={engine.decode_buckets} "
              f"(<= {engine.max_prefill_variants} prefill + "
              f"{engine.max_decode_variants} decode shapes)")
        if args.prewarm:
            n = engine.prewarm()
            print(f"prewarmed {n} shapes")
    if args.quantize != "off":
        print(f"quantize={args.quantize}: frozen table bytes = "
              f"{engine.frozen_table_bytes()}")
    sampling = SamplingParams(temperature=args.temperature, top_k=args.top_k,
                              seed=args.seed)
    rng = np.random.default_rng(args.seed)

    def _extra():
        # enc-dec requests carry per-request encoder frames (the speech
        # frontend is a stub, so random embeddings stand in)
        if cfg.family != "encdec":
            return None
        enc_len = cfg.enc_seq or args.cache_len
        return rng.standard_normal((enc_len, cfg.d_model)).astype(np.float32)

    # with the prefix cache on, draw prompts from a few shared heads so the
    # reuse path fires (head length clipped to leave decode room)
    head_len = min(args.cache_len // 4,
                   max(0, args.cache_len - args.max_new - 8))
    heads = []
    if prefix_cache and head_len >= 8:
        heads = [rng.integers(0, cfg.vocab, size=head_len).astype(np.int32)
                 for _ in range(2)]

    def _prompt(i):
        tail = rng.integers(0, cfg.vocab,
                            size=int(rng.integers(3, 9))).astype(np.int32)
        if heads:
            return np.concatenate([heads[i % len(heads)], tail])
        return tail

    tenant_names = sorted(tenants)
    reqs = [Request(_prompt(i), max_new=args.max_new,
                    stop_tokens=tuple(args.stop_token), sampling=sampling,
                    deadline_ms=deadline_ms, extra=_extra(),
                    tenant=(tenant_names[i % len(tenant_names)]
                            if tenant_names else "default"))
            for i in range(args.n_requests)]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    if args.stream and tenants:
        # multi-tenant async mode: the front-end owns admission (token
        # buckets, SLO deadline defaults, bounded retry on a full queue)
        # while run() drives the engine on the same event loop
        frontend = AsyncFrontend(engine, tenants)

        async def _serve():
            rids = []

            async def _feed():
                for r in reqs:
                    try:
                        rid = await frontend.submit(r.tenant, r)
                    except TenantRejectedError as e:
                        print(f"shed: {e}")
                        continue
                    rids.append(rid)
                    print(f"submitted req {rid} tenant={r.tenant} "
                          f"(prompt_len={r.prompt_len})")

            runner = asyncio.ensure_future(frontend.run(idle_rounds=2))
            await _feed()
            await runner
            while engine.step():    # submits that landed after run() idled
                pass
            # poll before drain: an EXPIRED/FAILED terminal prints as such
            for rid in rids:
                v = engine.poll(rid)
                if v.status != "FINISHED":
                    print(f"req {rid}: {v.status}"
                          + (f" ({v.error})" if v.error else ""))
            done = engine.drain(rids)
            return [done[rid] for rid in rids]

        outs = asyncio.run(_serve())
    elif args.stream:
        # open-ended serving: submissions trickle in while the engine
        # steps. A submit rejected at the --max-queue bound is
        # backpressure: step while the engine's retry_after_hint elapses
        rids = []
        for r in reqs:
            while True:
                try:
                    rid = engine.submit(r)
                    break
                except QueueFullError as e:
                    print(f"backpressure: {e}")
                    hold = time.perf_counter() + (e.retry_after_hint or 0.0)
                    engine.step()
                    while time.perf_counter() < hold and engine.step():
                        pass
            rids.append(rid)
            engine.step()
            v = engine.poll(rid)
            print(f"submitted req {rid} (prompt_len={r.prompt_len}); "
                  f"poll -> status={v.status} tokens={list(v.tokens)}")
        while engine.step():
            pass
        # poll before drain: an EXPIRED/FAILED/CANCELLED terminal prints
        # as such rather than as a short finish
        for rid in rids:
            v = engine.poll(rid)
            if v.status != "FINISHED":
                print(f"req {rid}: {v.status}"
                      + (f" ({v.error})" if v.error else ""))
        done = engine.drain(rids)
        outs = [done[rid] for rid in rids]
    else:
        outs = engine.generate(reqs)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    for i, o in enumerate(outs):
        print(f"request {i}: {o}")
    n_tok = sum(len(o) for o in outs)
    s = engine.stats
    extra = ""
    if args.engine == "continuous":
        extra = (f" decode-shapes={sorted(s.decode_shapes)}"
                 f" decode-rows/token={s.decode_rows_per_token:.2f}")
        if prefix_cache:
            extra += (f" prefix-hit-rate={s.prefix_hit_rate:.2f}"
                      f" prefill-tokens-saved={s.prefill_tokens_saved}")
        if s.rejected or s.expired or s.aborted or s.cancelled \
                or s.snapshots:
            extra += (f" rejected={s.rejected} expired={s.expired}"
                      f" aborted={s.aborted} cancelled={s.cancelled}"
                      f" snapshots={s.snapshots}")
        if s.ttft_ms.count:
            extra += (f" ttft-p50={s.ttft_ms.p50:.3g}ms"
                      f" ttft-p99={s.ttft_ms.p99:.3g}ms")
        for t in sorted(s.tenants):
            ts = s.tenants[t]
            extra += (f"\n  tenant {t}: submitted={ts.submitted} "
                      f"completed={ts.completed} tokens={ts.tokens} "
                      f"rejected={ts.rejected}"
                      + (f" ttft-p99={ts.ttft_ms.p99:.3g}ms"
                         if ts.ttft_ms.count else ""))
    print(f"{n_tok} tokens in {dt:.2f}s ({n_tok / max(dt, 1e-9):.1f} tok/s); "
          f"prefill compiles={engine.prefill_compiles} "
          f"decode compiles={engine.decode_compiles} "
          f"tokens/decode-step={s.tokens_per_decode_step:.2f}{extra}")
    return outs


if __name__ == "__main__":
    main()
