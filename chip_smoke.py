#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device line (``nvidia-smi`` name and power limit), then build every
   kernel from the sources in this checkout and print the build time;
2. serve full-width qwen3-0.6b (28 layers, d_model 1024, vocab 151936,
   bf16) with ``impl="pallas"`` (the kernel path) and seeded random params:
   ``ServeEngine(batch=4, cache_len=128)``, 8 greedy requests of 16 tokens;
   the kernel's launch count must equal 140 x the forwards run; then a
   ``torch.profiler`` view of decode steps (device busy time per step);
3. every kernel against its plain PyTorch version on the card: the
   slice's projection shapes at every row count the serve run launched
   (read from its prefill and decode shape sets) and at B in {1, 4, 512},
   with f32 and bf16 x; small ragged shapes (k in {7, 8, 16}) with bias and
   every activation; the int8 tables bit for bit against the f32 launch on
   dequantized tables;
4. the first request's prefill logits on the card (kernel) against the
   same params on the CPU (plain versions);
5. a short int8-table engine pass and its resident table bytes;
6. kernel, plain-version and ``torch.matmul`` (dense-equivalent matrix,
   a yardstick the port never calls) device times at the slice's shapes,
   beside the least time the card could take for the function (transforms
   counted at an FFT's operations), and the wrapper's host time per call.

The line before the last is the JSON kernel report; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA, and in a
directory without the rest of the repository.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and f32 rate
# outside the tensor cores (the kernel's arithmetic is f32 FMA)
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12

FP32_TOL = 2e-5                 # tests/test_conformance.py REL_TOL
# bf16 output: one bf16 ulp (2^-7 relative) at the largest magnitude on top
# of the f32 tolerance — kernel and plain version may round a value near a
# bf16 boundary to neighbouring bf16 numbers
BF16_TOL = 2.0 ** -7 + FP32_TOL
# card vs CPU at full width: bf16 activations (8-bit significand) are
# re-rounded after every layer; summation-order differences between the
# kernel and the plain version flip single roundings, which propagate
# through 28 layers. 1% of the largest logit bounds that drift
FULL_WIDTH_TOL = 1e-2
# device-side sleep queued ahead of each timed call (~5 ms at 1.98 GHz), so
# the host has enqueued the call before the device reaches it and the
# events time the device alone, not the Python launch path
SLEEP_CYCLES = 10_000_000

K = 128
# (name, p, q) of every circulant launch in one qwen3-0.6b layer, and its
# launches per forward (28 layers)
SLICE_SHAPES = [("qkv", 32, 8, 28), ("o", 8, 16, 28), ("wi_wu", 24, 8, 56),
                ("wo", 8, 24, 28)]
RAGGED = [(37, 5, 3, 7), (9, 3, 11, 8), (13, 2, 2, 16), (3, 1, 1, 1)]


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def rel_err(y, ref):
    return float((y.float() - ref.float()).abs().max()
                 / ref.float().abs().max().clamp_min(1e-6))


def tables(p, q, k, gen, device):
    import torch
    Kf = k // 2 + 1
    wr = torch.randn(p, q, Kf, generator=gen, device=device)
    wi = torch.randn(p, q, Kf, generator=gen, device=device)
    return wr, wi


def phase_kernels(torch, kernel, quant, dev, row_counts):
    """Every kernel against its plain version, the slice's shapes at each
    of ``row_counts``; returns the max abs error of the f32 checks at the
    slice's shapes."""
    gen = torch.Generator(device=dev).manual_seed(1)
    worst_abs = 0.0
    n_checks = 0
    for name, p, q, _ in SLICE_SHAPES:
        wr, wi = tables(p, q, K, gen, dev)
        for B in row_counts:
            x32 = torch.randn(B, q * K, generator=gen, device=dev)
            for x, tol in ((x32, FP32_TOL), (x32.bfloat16(), BF16_TOL)):
                y = kernel.bc_matmul(x, wr, wi, k=K)
                yp = kernel.bc_matmul_plain(x, wr, wi, k=K)
                torch.cuda.synchronize()
                e = rel_err(y, yp)
                if not e <= tol:
                    fail(f"{name} B={B} {x.dtype}: rel err {e:.3g} > {tol}")
                if x.dtype == torch.float32:
                    worst_abs = max(worst_abs,
                                    float((y - yp).abs().max()))
                n_checks += 1
        s = quant.symmetric_scales(wr, wi)
        qr, qi = quant.quantize_symmetric(wr, s), quant.quantize_symmetric(
            wi, s)
        x = torch.randn(4, q * K, generator=gen, device=dev).bfloat16()
        y8 = kernel.bc_matmul(x, qr, qi, None, s, k=K)
        yd = kernel.bc_matmul(x, quant.dequantize_symmetric(qr, s),
                              quant.dequantize_symmetric(qi, s), k=K)
        if not torch.equal(y8, yd):
            fail(f"{name}: int8 launch differs from dequantized f32 launch")
        n_checks += 1
    for B, p, q, k in RAGGED:
        wr, wi = tables(p, q, k, gen, dev)
        bias = torch.randn(p * k, generator=gen, device=dev)
        x32 = torch.randn(B, q * k, generator=gen, device=dev)
        for act in kernel.ACTIVATIONS:
            for x, tol in ((x32, FP32_TOL), (x32.bfloat16(), BF16_TOL)):
                y = kernel.bc_matmul(x, wr, wi, bias, k=k, activation=act)
                yp = kernel.bc_matmul_plain(x, wr, wi, bias, k=k,
                                            activation=act)
                torch.cuda.synchronize()
                e = rel_err(y, yp)
                if not e <= tol:
                    fail(f"ragged B={B} p={p} q={q} k={k} {act} {x.dtype}: "
                         f"rel err {e:.3g} > {tol}")
                n_checks += 1
        s = quant.symmetric_scales(wr, wi)
        qr, qi = quant.quantize_symmetric(wr, s), quant.quantize_symmetric(
            wi, s)
        y8 = kernel.bc_matmul(x32, qr, qi, bias, s, k=k, activation="gelu")
        yd = kernel.bc_matmul(x32, quant.dequantize_symmetric(qr, s),
                              quant.dequantize_symmetric(qi, s), bias, k=k,
                              activation="gelu")
        if not torch.equal(y8, yd):
            fail(f"ragged k={k}: int8 launch differs from dequantized f32")
        n_checks += 1
    print(f"kernel checks: {n_checks} passed at slice-shape rows "
          f"{list(row_counts)} (f32 rel <= {FP32_TOL}, bf16 rel <= "
          f"{BF16_TOL:.3g}, int8 bit-identical); max abs err at the slice "
          f"shapes (f32) = {worst_abs!r}")
    print("kernels: [\"bc_matmul\"]")
    return worst_abs


def phase_serve(torch, dev):
    """Full-width qwen3-0.6b through the engine's streaming API."""
    from repro_torch.configs.base import SWMConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.kernels.block_circulant import kernel
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    import numpy as np

    cfg = dataclasses.replace(CONFIG, swm=SWMConfig(block_size=128,
                                                    impl="pallas"))
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), seed=0, device=dev)
    engine = ServeEngine(model, cfg, params, batch=4, cache_len=128)
    torch.cuda.synchronize()
    print(f"qwen3-0.6b full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, vocab {cfg.vocab}, {cfg.compute_dtype}, "
          f"impl={cfg.swm.impl}): built, initialized and frozen in "
          f"{time.perf_counter() - t0:.2f}s; frozen table bytes "
          f"{engine.frozen_table_bytes()}")
    # warm-up request (allocator, library handles), outside the counted run
    engine.generate([Request(np.arange(4, dtype=np.int32), max_new=2)])

    rng = np.random.default_rng(0)
    reqs = [Request(rng.integers(0, cfg.vocab, size=int(rng.integers(3, 9))
                                 ).astype(np.int32), max_new=16)
            for _ in range(8)]
    s = engine.stats
    f0 = s.prefill_calls + s.decode_steps
    kernel.LAUNCHES["bc_matmul"] = 0
    t_start = time.perf_counter()
    rids = [engine.submit(r) for r in reqs]
    decode_ms = []
    while True:
        p0 = s.prefill_calls
        t = time.perf_counter()
        more = engine.step()
        torch.cuda.synchronize()
        if s.prefill_calls == p0:
            decode_ms.append((time.perf_counter() - t) * 1e3)
        if not more:
            break
    outs = engine.drain(rids)
    dt = time.perf_counter() - t_start
    launches = kernel.LAUNCHES["bc_matmul"]
    forwards = s.prefill_calls + s.decode_steps - f0
    per_forward = 5 * cfg.n_layers
    if [len(outs[r]) for r in rids] != [16] * 8:
        fail(f"token counts {[len(outs[r]) for r in rids]} != 16 each")
    if launches != per_forward * forwards:
        fail(f"kernel launches {launches} != {per_forward} x {forwards} "
             f"forwards")
    n_tok = sum(len(o) for o in outs.values())
    print(f"serve: {len(reqs)} requests x 16 tokens = {n_tok} tokens in "
          f"{dt:.3f}s = {n_tok / dt:.1f} tok/s; {forwards} forwards "
          f"({len(decode_ms)} decode-only steps, median "
          f"{statistics.median(decode_ms):.2f} ms/step); bc_matmul launches "
          f"{launches} = {per_forward} x {forwards}; all logits finite")
    print(f"serve shapes: prefill {sorted(s.prefill_shapes)} decode "
          f"{sorted(s.decode_shapes)}")
    # rows of x at each launch: rows x bucket length in prefill, rows in
    # decode (every shape the engine ran, warm-up included)
    row_counts = ({b * t for b, t in s.prefill_shapes}
                  | set(s.decode_shapes))
    return (cfg, engine, params, reqs, launches,
            statistics.median(decode_ms), row_counts)


def phase_cpu_vs_card(torch, cfg, engine, prompt_req):
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import load_tree

    def to_cpu(tree):
        return {k: to_cpu(v) if isinstance(v, dict) else v.cpu()
                for k, v in tree.items()}

    cpu_model = build_model(cfg, device="cpu")
    load_tree(cpu_model, to_cpu(engine.params))
    toks = torch.as_tensor(prompt_req.prompt, dtype=torch.long)[None]
    with torch.no_grad():
        card = engine.runner.model.forward(toks.cuda(),
                                           logits_mode="last")[0]
        cpu = cpu_model.forward(toks, logits_mode="last")[0]
    card = card.float().cpu()
    if not (torch.isfinite(card).all() and torch.isfinite(cpu).all()):
        fail("non-finite prefill logits")
    e = rel_err(card, cpu)
    same = int(card.argmax()) == int(cpu.argmax())
    print(f"card vs cpu prefill logits (full width): rel err {e:.3g} "
          f"(tolerance {FULL_WIDTH_TOL}), argmax equal: {same}")
    if not e <= FULL_WIDTH_TOL:
        fail(f"card vs cpu logits rel err {e:.3g} > {FULL_WIDTH_TOL}")


def phase_int8(torch, cfg, params, dev, fp32_bytes):
    from repro_torch.launch.specs import build_model
    from repro_torch.serve.engine import Request, ServeEngine
    import numpy as np

    eng = ServeEngine(build_model(cfg, device=dev), cfg, params, batch=4,
                      cache_len=128, quantize="int8")
    outs = eng.generate([Request(np.arange(3, 9, dtype=np.int32), max_new=4),
                         Request(np.arange(5, dtype=np.int32), max_new=4)])
    if [len(o) for o in outs] != [4, 4]:
        fail(f"int8 engine token counts {[len(o) for o in outs]}")
    b8 = eng.frozen_table_bytes()
    print(f"int8 tables: frozen table bytes {b8} vs fp32 {fp32_bytes} "
          f"({b8 / fp32_bytes:.3f}x); tokens {outs}")
    if not b8 < 0.55 * fp32_bytes:
        fail("int8 tables are not below 0.55x of fp32")


def time_ms(torch, fn, runs=30):
    """Device time of one call: median over ``runs`` calls, CUDA events
    around each, with the device kept busy while the host enqueues."""
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def phase_times(torch, kernel, dev):
    from repro_torch.core.circulant import blocks_to_dense
    from repro_torch.kernels.block_circulant.ops import freq_weights

    gen = torch.Generator(device=dev).manual_seed(2)
    Kf = K // 2 + 1
    rows = []
    print("device times (bf16 x, f32 tables, no bias; median of 30 runs, "
          "CUDA events; bound = max(bytes / 3.35 TB/s, flops / "
          "67 TFLOP/s), flops with FFT-counted transforms; 'dense-DFT' = "
          "the kernel's own flops / 67 TFLOP/s):")
    for name, p, q, per_fwd in SLICE_SHAPES:
        w = torch.randn(p, q, K, generator=gen, device=dev) * (q * K) ** -0.5
        wr, wi = freq_weights(w)
        dense_t = blocks_to_dense(w).T.contiguous().bfloat16()
        for B in (4, 512):
            x = torch.randn(B, q * K, generator=gen, device=dev).bfloat16()
            ms = time_ms(torch, lambda: kernel.bc_matmul(x, wr, wi, k=K))
            plain = time_ms(torch,
                            lambda: kernel.bc_matmul_plain(x, wr, wi, k=K))
            lib = time_ms(torch, lambda: torch.matmul(x, dense_t))
            nbytes = x.nbytes + wr.nbytes + wi.nbytes + B * p * K * 2
            # least work: q forward and p inverse real transforms per row at
            # an FFT's 2.5·k·log2(k), plus the per-bin complex products
            flops = B * (2.5 * K * math.log2(K) * (q + p) + 8 * p * q * Kf)
            # this kernel's own count: transforms as dense DFT matmuls
            kernel_flops = B * (4 * q * K * Kf + 8 * p * q * Kf
                                + 4 * p * Kf * K)
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOP_PER_S * 1e3
            row = dict(shape=name, B=B, p=p, q=q, k=K, launches_per_forward=
                       per_fwd, ms=ms, plain_ms=plain, library_ms=lib,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations",
                       bytes=nbytes, flops=flops, kernel_flops=kernel_flops,
                       kernel_flops_ms=kernel_flops / F32_FLOP_PER_S * 1e3)
            rows.append(row)
            print(f"  {name:6s} p={p:2d} q={q:2d} B={B:3d}: kernel {ms!r} ms, "
                  f"plain {plain!r} ms, torch.matmul {lib!r} ms, bound "
                  f"{row['bound_ms']!r} ms ({row['bound_by']}), dense-DFT "
                  f"{row['kernel_flops_ms']!r} ms, {per_fwd} launches/forward")
    # host cost of the wrapper: enqueue time per call, no device wait
    x = torch.randn(4, 8 * K, generator=gen, device=dev).bfloat16()
    wr, wi = freq_weights(torch.randn(32, 8, K, generator=gen, device=dev))
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(200):
        kernel.bc_matmul(x, wr, wi, k=K)
    host_us = (time.perf_counter() - t) / 200 * 1e6
    torch.cuda.synchronize()
    print(f"host time per bc_matmul call (qkv, B=4, enqueue only): "
          f"{host_us:.1f} us")
    return rows


def phase_profile(torch, engine, reqs, step_ms):
    """Device time of decode steps with 4 active slots (torch.profiler)."""
    from torch.profiler import ProfilerActivity, profile

    rids = [engine.submit(r) for r in reqs[:4]]
    engine.step()                          # admit (prefill) + first decode
    torch.cuda.synchronize()
    n = 3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            engine.step()
        torch.cuda.synchronize()
    engine.drain(rids)

    # kernel (device-side) rows only: CPU op rows carry the device time of
    # the kernels they launch, which would count it twice
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / n
    if busy_ms == 0:
        print("profile: the profiler saw no device time (not measured)")
        return
    print(f"profile, decode step at 4 active slots: device busy "
          f"{busy_ms:.3f} ms/step of {step_ms:.2f} ms/step unprofiled "
          f"(device idle share {1 - busy_ms / step_ms:.3f}); "
          f"{sum(e.count for e in kernels) // n} device kernels/step")
    for e in sorted(kernels, key=lambda e: e.self_device_time_total,
                    reverse=True)[:6]:
        print(f"  {e.self_device_time_total / 1e3 / n:8.3f} ms/step "
              f"{e.count // n:5d} launches/step  {e.key[:70]}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from repro_torch.core import quant
    from repro_torch.kernels.block_circulant import kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])

    t0 = time.perf_counter()
    lib, log = kernel.build()
    print(f"built {lib.name} in {time.perf_counter() - t0:.2f}s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    cfg, engine, params, reqs, launches, step_ms, serve_rows = phase_serve(
        torch, dev)
    phase_profile(torch, engine, reqs, step_ms)
    max_abs = phase_kernels(torch, kernel, quant, dev,
                            sorted({1, 4, 512} | serve_rows))
    phase_cpu_vs_card(torch, cfg, engine, reqs[0])
    phase_int8(torch, cfg, params, dev, engine.frozen_table_bytes())
    rows = phase_times(torch, kernel, dev)

    main_row = next(r for r in rows if r["shape"] == "qkv" and r["B"] == 4)
    report = {"kernels": [{
        "name": "bc_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/block_circulant/csrc/bc_matmul.cu",
        "replaces": "src/repro/kernels/block_circulant/kernel.py:220",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "fused QKV at decode: x (4, 1024) bf16, tables "
                 "(32, 8, 65) f32, k=128",
        "all_shapes": rows,
    }]}
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
