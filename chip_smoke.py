#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA H100 and check its kernels.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device line (``nvidia-smi`` name and power limit), then build every
   kernel from the sources in this checkout (one ``nvcc`` per source, all
   started together) and print the build time;
2. serve full-width qwen3-0.6b (28 layers, d_model 1024, vocab 151936,
   bf16) with ``impl="pallas"`` (the kernel path) and seeded random params:
   ``ServeEngine(batch=4, cache_len=128)``, 8 greedy requests of 16 tokens;
   ``bc_matmul``'s launch count must equal 140 x the forwards run; then a
   ``torch.profiler`` view of decode steps (device busy time per step);
3. train the same model (``remat="block"``, AdamW, ``SyntheticLM(seed=0)``,
   batch 8 x seq 256): one warm-up step, then 4 counted steps with finite
   losses; the launch counts must equal (forward + recompute + dx) x 140 x
   steps for ``bc_matmul`` and 140 x steps for ``bc_dw``; every circulant
   table's grad finite and non-zero; params unchanged by step 0 (lr 0)
   and moved by the later steps;
3b. the distribution and measurement layers (``dist`` phase, after phase
   3; its rows join phase 4's checks; budget 60 s): (a) a world-1 NCCL
   mesh (``launch.mesh.make_local_mesh``): full-width qwen3-0.6b, 3 steps
   with ``make_train_step(mesh=)`` bit-identical to 3 steps without
   (params and moments), 420/140 launches per step, collectives per step,
   wall and busy ms of both; (b) two spawned ranks in a ``gloo`` group on
   cuda:0 (collectives staged through host memory): one data-parallel
   ZeRO-1 step of a 2-layer full-width f32 cut against one process's
   full-batch step, rel <= 1e-5 on params and moment shards; (c)
   ``compressed_psum_grads`` over (a)'s group on the real grads of 3
   batches: every element within scale/2 (plus f32 rounding), the error
   feedback telescoping, the payload bytes against f32; (d)
   ``impl="freq_shmap"`` bit-identical to ``freq`` at qwen3-0.6b's
   projection shapes; (e) ``TrainDriver(mesh=, state_shardings=)``
   through a fault before step 3 on a 2-layer cut, bit-identical to an
   uninterrupted run; (f) ``launch.analytic.cell_model(chips=1)`` and the
   roofline's compute and memory ms with the card's constants for the
   decode step and the train step, beside the busy ms phases 2 and 3
   measured;
3c. the analysis layer (``analysis`` phase, after ``dist``; budget 60 s;
   its launches counted apart from every other phase's): (a)
   ``torch.library.opcheck`` on ``repro_torch::bc_matmul``, ``bc_dw`` and
   ``bc_dw_freq`` on the card at the qkv shape, single and grouped over
   16 groups; (b) ``prewarm(audit=True)`` on phase 2's engine: its audit
   captures every bucket once, on a clone of the cache (no violation; 140
   ``bc_matmul`` ops per forward, read from the captures the audit keeps
   in ``engine.audit_traces``; the audit's wall ms), then the warm-up;
   (c) ``make_train_step(audit_args=...)`` on the train cell (batch 8 x
   seq 256), its default rules on one capture: NoFFT fires at
   ``freq_weights`` only (the kernel impl's training forward transforms
   its tables each step, as the reference's does), DenseFallbackDot fires
   nothing, and the capture the error carries holds 420 ``bc_matmul`` and
   140 ``bc_dw`` ops (the backward, which runs on autograd's device
   thread); (d) a planted weight-fft loss behind
   ``make_grad_step(audit_args=...)`` raises ``StructuralContractError``
   naming this file's line; (e) ``python -m repro_torch.analysis
   --all-configs`` on the card (every registry arch at SMOKE, both quantize
   legs, and the lint: no violation), run in the background beside
   (a)-(d);
3d. tensor parallelism and FSDP (``tp`` phase; its ranks are spawned
   before the analysis phase and run beside it, the rest follows it; its
   rows join phase 4's checks): runs (a) qwen3-0.6b, (b) arctic-480b with
   ``fsdp=True``, (c) seamless-m4t-medium, (d) jamba-v0.1-52b with
   ``fsdp=True`` (layer 0 Mamba + dense SwiGLU, layer 1 Mamba + MoE of 16
   experts, top 2; each Mamba layer's d_inner channels split over
   ``model``) and (e) rwkv6-7b (each time mix's 64 WKV heads and each
   channel mix's d_ff blocks split over ``model``), each cut to 2 layers
   (2 encoder + 2 decoder for seamless) at full width in f32
   (``impl="pallas"``, AdamW, one step at step 1 of the schedule, batch 8
   x seq 256; seamless's 2 rows x 256 tokens, each with 4096 seeded
   encoder frames), on meshes (data=1, model=2), (data=2, model=2),
   (data=1, model=2), (data=2, model=2) and (data=1, model=2): 2, 4, 2, 4
   and 2 ranks in ``gloo`` groups on cuda:0 (NCCL refuses two ranks on one
   GPU; collectives staged through host memory; (d)'s ranks start once
   (a)'s and (c)'s are done and (e)'s once all others are, so that the
   card's memory holds them). Each rank saves its state
   whole (``save_checkpoint(shardings=, mesh=)``); this process takes the
   same step on one process and holds the checkpoint, restored onto one
   process, to it (params over the tree and moments leaf by leaf, (e)'s
   over each moment's tree beside a rounding-step control of one process
   against itself, rel <= 1e-5; loss and grad norm of every rank too); launches per rank per step
   pinned (30/10, 54/16, 72/24, 33/10, 48/16); collectives, bytes per
   collective,
   per-rank param and moment bytes beside one process's, and (b)'s and
   (d)'s peak device memory per rank, which must be below one process's;
   (c) every shard shape (qwen3's fused QKV (16, 8), o (8, 8), gate/up
   (12, 8), down
   (8, 12); arctic's (36, 56), (56, 28), (19, 56), (56, 19) and its 64
   local experts' (38, 56) and (56, 38) grouped; seamless's fused QKV
   (12, 8), o (8, 4), cross q and k/v (4, 8) on its decoder's and its
   encoder's rows, wi (16, 8), wo (8, 16); jamba's Mamba in_proj (64, 32)
   and out_proj (32, 32), its dense FFN's (56, 32) and (32, 56) and its 8
   local experts' (112, 32) and (32, 112) grouped; rwkv6's r, k, v, g
   (16, 32), o (32, 16), wk (56, 32), wr (32, 32), wv (32, 56); their dx
   transposes, and
   q and k/v alone) against its plain version, f32 and bf16, ``bc_dw`` at
   every weight shape, and their device times; (d) after its train step
   each rank serves through ``make_prefill_step(mesh=)`` /
   ``make_decode_step(mesh=)`` with frozen tables, f32 then int8 (4
   prompts of 64 tokens, then 16 greedy decode steps): (a) qwen3-0.6b at
   full depth (28 layers), (b) arctic-480b cut to 3 layers (its 64
   local experts; 3, so that the cache rule splits the slot axis over the
   data ranks and the MoE routes over the global batch) and (c)
   seamless-m4t-medium at 2 + 2 layers, each request with 4096 seeded
   frames (the cross caches split on their frames, 2048 per rank, read
   through the combine of the ranks' attention partials) and (d)
   jamba-v0.1-52b at the train step's 2 layers (each Mamba layer's conv
   window and SSM state split on their channels) and (e) rwkv6-7b at the
   train step's 2 layers (the shift states split on their channels and
   all-gathered at each step, the WKV states on their heads), held to this
   process serving the same prompts (greedy tokens equal, the last step's
   logits within 1e-5 f32 and 2e-5 int8); launches per prefill and per
   decode step pinned (140/140, 24/24, 24/12, 10/10, 16/16), collectives
   and bytes per step by
   kind, per-rank param and cache bytes beside one process's, prefill and
   decode wall and busy ms; the serve shard shapes' kernels against plain,
   f32 and int8, and their device times; (e) ``python -m
   repro_torch.launch.dryrun`` on the three committed cells (the CPU,
   beside the rest): ``params``, ``analytic`` and the donated cache bytes
   equal to ``experiments/dryrun/``'s; and on seamless's three cells,
   jamba's four (its Mamba mixer under ``model = 16``) and rwkv6's four
   (its RWKV mixer), each ``OK`` with the reference's argument and donated
   cache bytes (rwkv6's cache 16 times the reference's per rank: the
   reference puts the data axes on its stack of 32 layers);
4. every kernel against its plain PyTorch version on the card: the
   slice's projection shapes at every row count the serve and train runs
   launched and at B in {1, 4, 512}, with f32 and bf16 x, each launched
   twice (the two must agree bit for bit); ragged shapes (k in {1, 7, 8,
   16, 64, 96, 128}: the dense-DFT path at 1, 7 and 96, the FFT path at
   the powers of two) with bias and every activation; the int8
   tables bit for bit against the f32 launch on dequantized tables; the dx
   launches (``bc_matmul`` on the transposed shapes) and ``bc_dw`` in both
   epilogues at the train rows, 512, one row and a row count that leaves
   a ragged last chunk, f32 and bf16, plus ragged shapes;
5. the resilient serving tier (``serve_resilient`` phase, run after phase
   2 so its row counts join phase 4's checks): (a) full-width qwen3-0.6b
   (bf16, ``impl="pallas"``) through ``ServeEngine(batch=4,
   cache_len=256, prefix_cache=True)``: 8 greedy requests of 16 tokens,
   one seeded 128-token head plus seeded 4-20-token tails, all submitted
   at once; prefix hits, lookups and saved tokens held to the prediction
   (4, 8, 512), ``bc_matmul`` held to 140 launches per forward, every
   prefill timed (the CUDA-event span and the profiler's device busy
   time) against the same requests through a ``prefix_cache=False``
   engine on the same model, and the token streams compared; (b) the f32
   prefix check at 2 layers: a donor-seeded tail prefill's first-token
   logits against a full prefill of the same prompt, held to 2e-5, then a
   planted fault (the seed masks the head's last row) that must read
   above it; (c) the NaN guard at 2 layers with an untied head and one
   NaN embedding row: a prompt carrying the poison fails in prefill, a
   victim fails in decode, both with the reference's errors, their slots
   scrubbed to fresh rows, the four clean requests bit-identical to a
   fault-free run (twice, the second over the scrubbed slots), then one
   deadline expiry and one cancel on a ``ManualClock``, and no leaks;
5b. the durable tier (``durable`` phase, after ``serve_resilient``; its
   row counts join phase 4's checks; its files live under one temporary
   directory, removed at the end): (a) full-width qwen3-0.6b behind
   ``ServeEngine(batch=4, cache_len=256, prefix_cache=True,
   snapshot_dir=...)`` serves phase 5's 8 requests and 2 seeded requests
   sampled at T = 0.8, top_k = 50, snapshots after 6 steps and runs on; a
   replacement engine on a fresh model from the same seeded params
   restores and drains: its cache equals the first's at the snapshot bit
   for bit, all 10 streams equal the first's, 140 launches per forward,
   the bytes written, ``snapshot()``/``restore()`` wall ms and the
   restored decode step's busy ms; (b) a ``PrefixStore`` (256 MiB) on a
   prefix-cache engine: phase 5's traffic, then 4 requests on another
   seeded head evict and spill its donors; ``save()``, ``load()`` into a
   fresh store, a cold engine on a fresh model ``adopt_prefixes()`` and
   serves requests 5-8 again: adopted rows equal the spilled ones bit for
   bit, hits equal the requests that reach an adopted prompt, tokens equal
   the first engine's; phase 5's NaN guard again with a store attached:
   a scrub spills nothing; (c) ``TrainDriver`` on qwen3-0.6b cut to 2
   layers (full width), batch 8 x seq 256, AdamW, ``remat="block"``,
   checkpoints every 2 steps and a fault before step 3: one restart, 7
   step executions, launches held to 7 x (30, 10) (derived from the
   modules), the model's tensors aliased to the state's after the
   restore, losses and final params and moments against an uninterrupted
   run (bit-identical, else within 1e-5), the checkpoint bytes and the
   host-copy, write and restore ms;
5c. the serving tier's last part (``serve_tier`` phase, after ``durable``;
   its row counts join phase 4's checks), all on phase 2's full-width
   params: (a) ``prewarm()`` on ``ServeEngine(batch=4, cache_len=128)``
   returns the bucket grid's 18 shapes and launches ``bc_matmul`` 140 x 18
   times; the first request's TTFT on it and on a fresh engine; then
   phase 2's 8 requests give phase 2's tokens bit for bit with the shape
   counters unchanged; (b) ``WaveEngine(batch=4, cache_len=128)`` against
   the continuous engine on the same 8 requests: gated equal tokens in f32
   on a 2-layer cut (at a mismatch, the step and both engines' top-2
   logit margins beside their logit difference), the bf16 full-width
   match count (not gated), wall and profiler busy ms per token and decode
   rows per token; (c) a ``Supervisor`` over ``fair`` engines (the three
   SLO classes' weights), prefix cache with a 256 MiB ``PrefixStore``,
   snapshots every 4 steps, a ``ManualClock``: 12 requests of 16 tokens
   (4 per tenant, two of each on a shared 32-token head), a fault-free
   run and one with an engine fatal at decode launch 20: one restart and
   one recovery, every at-most-once stream equal to the fault-free run's,
   140 launches per forward on both engines, device memory after the heal
   within 5% of before the fatal step, the heal's ms split into factory,
   restore, adopt_prefixes and re-queue; (d) ``AsyncFrontend`` over a
   fresh supervisor on the real event loop: the same 12 requests
   burst-submitted by the three tenants (``interactive`` at rate 4, burst
   2): every request terminal, every ``stream()`` equal to its final
   tokens, per-tenant admissions, rejections, statuses and TTFT;
6. the first request's prefill logits on the card (kernels) against the
   same params on the CPU (plain versions), and one full-width train step
   (batch 2 x seq 32) on the card against the CPU: loss and grad norm;
7. a short int8-table engine pass and its resident table bytes;
8. kernel, plain-version and yardstick device times at qwen3-0.6b's shapes
   (``torch.matmul`` with the dense-equivalent matrix for ``bc_matmul``
   and the dense weight gradient ``g.T @ x`` for ``bc_dw``, both calls the
   port never makes), beside the least time the card could take for the
   function (transforms counted at an FFT's operations), each shape's
   launch geometry and transform path (``bc_dw``: its tile, row splits and
   chunk, beside the first version's time), and the wrapper's host time
   per call through the registered op, against the wrapper's path before
   the op in interleaved rounds of the same run (the op may take at most
   50 / 41.3 of it);
9. the paper's own models (``paper`` phase), built on the card from seeded
   generators at the paper benchmarks' widths and batches:
   ``SWMMLP((784, 512, 512, 10), 64, quant_bits=12, impl="pallas")`` at
   B = 64, the ASIC net ``SWMMLP((512, 512, 512, 64, 10), 64, 12,
   impl="pallas")`` at B = 256, ``SWMCNN()`` at B = 8 (conv1 always runs the
   kernel), ``SWMLSTMASR``'s two cells with ``impl="pallas"`` at k = 16 and
   8 (B = 4, T = 32) and ``SWMLSTMASR`` itself (its default impl, no
   kernel): each against the same params on the CPU unfrozen, f32-frozen
   and (models with quant_bits = 0) int8-frozen, with exact launch counts
   per forward, then images/s or frames/s; one ``SWMCNN`` train step at
   batch 128 (launches (2, 1)) on the card against the CPU, then counted
   steps; both kernels against their plain versions at every new shape,
   the MNIST example's (phase 13) included (``bc_dw`` at P = 8, Q = 100,
   k = 8 over 8192 rows and at P = 32, Q = 98 and 32, k = 8 over 128),
   and their times;
10. the recurrent hybrids (``hybrid`` and ``rwkv`` paths): full-width
   jamba-v0.1-52b (Mamba + attention + MoE) and rwkv6-7b with
   ``impl="pallas"`` and seeded random params, each served like phase 2
   (8 greedy requests x 16 tokens, ``batch=4, cache_len=128``) through
   ``make_runner`` -> ``RecurrentRunner``, ``bc_matmul``'s launches held to
   160 and 256 per forward (the MoE's experts: one grouped launch per
   expert projection), a decode-step profile, the first request's prefill
   logits twice on the card (bit-identical) and against the CPU; then
   ``bc_matmul`` against its plain version at every new shape and row
   count, the grouped launch (16 experts) group by group against single
   launches (f32 and int8, bit for bit), and the times of every new shape
   beside ``torch.bmm``/``torch.matmul`` on the dense equivalent and the
   bound;
11. the rest of the decoder family (``family`` paths), all with
   ``impl="pallas"``, seeded random params and full width: gemma3-27b (62
   layers, 52 sliding-window local and 10 global) served with
   ``cache_len=2048`` to 6 short requests and prompts of 1015 and 1400
   tokens (the rings wrap in decode and in prefill), then the 1400-token
   request's prefill + 15 decode steps through the cache against a
   no-cache forward (sound, then with a planted fault that must exceed the
   limit), and a profile of its 1400-row prefill; paligemma-3b (18
   layers, prefix-LM) served the short
   traffic, plus one forward behind a seeded 256 x 2048 image prefix;
   arctic-480b (35 layers, 128 experts + dense residual); qwen3-moe-235b-
   a22b, deepseek-7b and internlm2-20b cut to 2 layers. Each through
   ``DecoderRunner`` with bc_matmul held to its pinned launches per
   forward (310, 90, 280; 10 at 2 layers), a decode profile, prefill twice
   on the card (bit-identical) and card against CPU (gemma3 on one 6-layer
   period, arctic on a 2-layer cut); then bc_matmul against its plain
   version at every new shape and row count (128-expert grouped launches
   group by group against single launches) and the times of every new
   shape;
12. the enc-dec family (``encdec`` path): full-width seamless-m4t-medium
   (12 encoder + 12 decoder layers, bidirectional encoder, cross attention
   over a stashed encoder K/V) with ``impl="pallas"`` and seeded random
   params, served through ``make_runner`` -> ``EncDecRunner`` to the short
   traffic, each request with seeded (4096, 1024) f32 frames; bc_matmul
   held to 144 launches per prefill and 72 per decode step; a decode
   profile, a profiled 4-request prefill (16,384 encoder rows) and the
   device time of the runner's gather and place; the cross-cache check in
   f32 (prefill + 15 cached decode steps against a no-cache forward, then a
   planted fault that must exceed the limit); the first request's prefill
   twice on the card (bit-identical) and against the CPU at full depth;
   bc_matmul against its plain version at its four shapes and every row
   count launched (int8 too), and their times at 4 to 16,384 rows;
13. the paper's two examples (``repro_torch.examples``): ``train_one`` at
   block size 8 for 40 steps each on the card, losses finite and falling,
   launches held to the pinned counts (the MNIST example's shapes are
   checked in phase 9);
14. training every family (``train_family`` path): qwen3-moe-235b-a22b
   (2 of 94 layers, full width: 128 experts, top-8, untied head),
   paligemma-3b (18 layers, a seeded 256 x 2048 image prefix per row),
   seamless-m4t-medium (12 + 12 layers, seeded (256, 1024) frames per
   row), jamba-v0.1-52b and rwkv6-7b (one 8-layer period each, their Mamba
   and WKV scans under autograd) and arctic-480b (2 of 35 layers: attention, 128
   experts and the dense residual), each with ``impl="pallas"``, seeded
   random params, AdamW, ``remat="block"`` and batch 8 x seq 256 in
   ``launch.specs.batch_specs``' shapes through ``make_train_step``: one
   warm-up step, then 4 counted steps (2 for jamba and rwkv6) with both
   kernels' launches held to the pinned counts per step (36/10, 270/90,
   432/144, 132/40, 192/64, 54/16: the experts' grad through one grouped
   ``bc_matmul`` dx and one grouped ``bc_dw`` per projection), a profiled
   step (device busy and idle share), peak memory, and one step at batch 2
   x seq 32 on the card against the CPU (loss and grad norm); then
   ``bc_matmul`` against its
   plain version at every shape and row count the path launches (the
   grouped launches at the experts' capacity rows, G = 16 and 128, group
   by group against single launches), ``bc_dw`` against its plain version
   at every weight-adjoint shape it launches (grouped, both epilogues, f32
   and bf16, bit-identical repeats) and at a ragged grouped case (G = 3,
   37 rows), and the times of every shape beside the bound and
   ``torch.matmul``/``torch.bmm`` (for ``bc_dw`` the dense weight gradient
   ``g^T @ x``);
15. the scans' per-chunk recompute (``scan_remat``): one train step's
   forward and backward at batch 2 x seq 1024 of 2-layer full-width cuts
   of jamba (one Mamba, one attention + MoE layer) and rwkv6, with the
   recompute on and forced off: peak device memory of each, equal losses,
   grads bit-identical (or within FP32_TOL beside a second run's spread),
   launches pinned;
16. the ``dft`` impl (``dft`` path): ``block_circulant_apply(impl="dft")``
   forward and both grads against the ``freq`` impl at qwen3-0.6b's
   projection shapes over 2048 rows, f32 and bf16, karatsuba off and on;
   full-width qwen3-0.6b trained with ``impl="dft"`` (a timed and a
   profiled step beside the kernel path's busy time, no kernel launched)
   and one step against the CPU; the torch quickstart for 200 steps, its
   loss dropping by more than 2 nats.

The CPU halves of the card-vs-CPU checks (the serve paths' logits, the
train_family steps) are queued when their card halves are done and run on
a worker thread only while the card is being checked or timed by CUDA
events (``CpuChecks``); what those windows leave runs before the report,
and a failed CPU check fails the run there.

The line before the last is the JSON kernel report; the last line is
``{"ok": true, "device": {...}}``. Exits non-zero without CUDA, and in a
directory without the rest of the repository.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import tempfile
import threading
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
# bc_dw sums B rows per element, in other orders in the kernel (row ranges
# then a split reduction) and in the plain version (cuBLAS). The worst-case
# rounding error of an n-term f32 sum grows linearly in n (Higham: (n-1)·u
# times the sum of |terms|), so FP32_TOL, which holds to 512 rows, scales
# with the row count beyond that
DW_TOL_ROWS = 512
# device-side sleep queued ahead of each timed call, so the host has
# enqueued the call before the device reaches it and the events time the
# device alone, not the Python launch path. Its length is SLEEP_COVER times
# the host's enqueue of one call, measured before the timed runs, at the
# SM clock's 1.98 GHz maximum (a lower clock only lengthens it), between
# SLEEP_MIN_CYCLES and SLEEP_CYCLES (~5 ms): a fixed 5 ms sleep before each
# of 30 runs of ~1,100 timed functions would add ~160 s to the command
SLEEP_CYCLES = 10_000_000
SLEEP_MIN_CYCLES = 200_000
SLEEP_COVER = 4
SLEEP_CLOCK_HZ = 1.98e9
# timed runs per function: TIME_RUNS, or TIME_MIN_RUNS once the runs have
# taken TIME_BUDGET_S (the plain versions of the G = 128 grouped launches,
# 60-100 ms each)
TIME_RUNS = 30
TIME_MIN_RUNS = 7
TIME_BUDGET_S = 0.3

K = 128
# (name, p, q) of every circulant launch in one qwen3-0.6b layer, and its
# launches per forward (28 layers)
SLICE_SHAPES = [("qkv", 32, 8, 28), ("o", 8, 16, 28), ("wi_wu", 24, 8, 56),
                ("wo", 8, 24, 28)]
# dx = g @ W runs bc_matmul on the transposed block grid (q, p)
DX_SHAPES = [(f"{name}.dx", q, p, n) for name, p, q, n in SLICE_SHAPES]
# (B, p, q, k): dense path at k = 7, 1 and 96, FFT path at k = 8, 16, 64
# and 128 (ragged B and p at full block size)
RAGGED = [(37, 5, 3, 7), (9, 3, 11, 8), (13, 2, 2, 16), (3, 1, 1, 1),
          (29, 3, 5, 64), (19, 3, 4, 96), (37, 5, 3, 128)]
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 256, 4
# bc_dw rows checked besides the train rows and 512: one row, and a count
# whose last row chunk is ragged (checked against the geometry below)
DW_EXTRA_ROWS = (1, 37)
# device ms of the first bc_dw (8 x 8 (p, q) tiles, dense DFT loops over
# bases in global memory) at the train shapes, B = 2048, bf16: this script
# on an NVIDIA H100 80GB HBM3 at a 700 W power limit. Printed in brackets
# beside this run's times for comparison; the JSON report holds only what
# this run measured
DW_FIRST_MS = {"qkv": 3.269904, "o": 1.648368, "wi_wu": 2.457136,
               "wo": 2.458400}


# the card's name and power limit as nvidia-smi prints them, set by main and
# printed beside every time and size the durable phase reports
CARD = ["card not read"]


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
    for name, p, q, _ in SLICE_SHAPES + DX_SHAPES:
        wr, wi = tables(p, q, K, gen, dev)
        for B in row_counts:
            x32 = torch.randn(B, q * K, generator=gen, device=dev)
            for x, tol in ((x32, FP32_TOL), (x32.bfloat16(), BF16_TOL)):
                y = kernel.bc_matmul(x, wr, wi, k=K)
                again = kernel.bc_matmul(x, wr, wi, k=K)
                yp = kernel.bc_matmul_plain(x, wr, wi, k=K)
                torch.cuda.synchronize()
                e = rel_err(y, yp)
                if not e <= tol:
                    fail(f"{name} B={B} {x.dtype}: rel err {e:.3g} > {tol}")
                if not torch.equal(y, again):
                    fail(f"{name} B={B} {x.dtype}: two launches differ")
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
                again = kernel.bc_matmul(x, wr, wi, bias, k=k, activation=act)
                yp = kernel.bc_matmul_plain(x, wr, wi, bias, k=k,
                                            activation=act)
                torch.cuda.synchronize()
                e = rel_err(y, yp)
                if not e <= tol:
                    fail(f"ragged B={B} p={p} q={q} k={k} {act} {x.dtype}: "
                         f"rel err {e:.3g} > {tol}")
                if not torch.equal(y, again):
                    fail(f"ragged B={B} p={p} q={q} k={k} {act}: two "
                         f"launches differ")
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
    paths = sorted({("fft" if kernel._mm_fft(k) else "dense") + f" k={k}"
                    for _, _, _, k in RAGGED + [(0, 0, 0, K)]})
    print(f"bc_matmul checks: {n_checks} passed at forward and dx shapes, "
          f"rows {list(row_counts)} and ragged shapes ({', '.join(paths)}) "
          f"(f32 rel <= {FP32_TOL}, bf16 rel <= {BF16_TOL:.3g}, int8 "
          f"bit-identical, repeat launches bit-identical); max abs err at "
          f"the slice shapes (f32) = {worst_abs!r}")
    return worst_abs


def dw_tol(B):
    """bc_dw's limit at B rows. bf16 x and g convert to f32 exactly in the
    kernel and in the plain version, and dw is f32, so bf16 inputs are held
    to the f32 limit too."""
    return FP32_TOL * max(1.0, B / DW_TOL_ROWS)


def check_dw(torch, kernel, x32, g32, P, Q, k, name):
    """bc_dw on ``x32``/``g32`` ((B, ·) or grouped (G, B, ·)) and on their
    bf16 copies, in both epilogues, each launched twice (the two must agree
    bit for bit), against its plain version within ``dw_tol(B)``. Returns
    the max abs error of the f32 launches."""
    B, worst_abs = x32.shape[-2], 0.0
    tol = dw_tol(B)
    for x, g in ((x32, g32), (x32.bfloat16(), g32.bfloat16())):
        for freq_out in (False, True):
            got = kernel.bc_dw(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
            again = kernel.bc_dw(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
            ref = kernel.bc_dw_plain(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
            torch.cuda.synchronize()
            got, again, ref = ((t,) if not freq_out else t
                               for t in (got, again, ref))
            for a, a2, r in zip(got, again, ref):
                e = rel_err(a, r)
                if not e <= tol:
                    fail(f"bc_dw {name} B={B} P={P} Q={Q} k={k} {x.dtype} "
                         f"freq_out={freq_out}: rel err {e:.3g} > "
                         f"{tol:.3g}")
                if not torch.equal(a, a2):
                    fail(f"bc_dw {name} B={B}: two launches differ")
                if x.dtype == torch.float32:
                    worst_abs = max(worst_abs, float((a - r).abs().max()))
    return worst_abs


def phase_dw(torch, kernel, dev, row_counts):
    """bc_dw against its plain version: the slice's shapes at ``row_counts``
    in both epilogues, f32 and bf16 inputs, and ragged shapes; the same
    launch twice must agree bit for bit. Returns the max abs error of the
    f32 checks at the slice's shapes."""
    gen = torch.Generator(device=dev).manual_seed(3)
    worst_abs, n_checks = 0.0, 0
    cases = [(name, B, p, q, K) for name, p, q, _ in SLICE_SHAPES
             for B in row_counts]
    B = DW_EXTRA_ROWS[-1]
    for name, p, q, _ in SLICE_SHAPES:
        geo = kernel._dw_geometry(B, p, q, K)
        if all(((s + 1) * B // geo.splits - s * B // geo.splits) % geo.rows
               == 0 for s in range(geo.splits)):
            fail(f"bc_dw {name}: B={B} leaves no ragged row chunk")
    cases += [(f"ragged k={k}", B, p, q, k) for B, p, q, k in RAGGED]
    for name, B, P, Q, k in cases:
        x32 = torch.randn(B, Q * k, generator=gen, device=dev)
        g32 = torch.randn(B, P * k, generator=gen, device=dev)
        e = check_dw(torch, kernel, x32, g32, P, Q, k, name)
        if k == K:
            worst_abs = max(worst_abs, e)
        n_checks += 4
    print(f"bc_dw checks: {n_checks} passed at slice shapes x rows "
          f"{list(row_counts)} and {len(RAGGED)} ragged shapes, both "
          f"epilogues, f32 and bf16 inputs (rel <= {FP32_TOL} x max(1, "
          f"B/{DW_TOL_ROWS}); repeat launches bit-identical); max abs err at the slice shapes (f32) = "
          f"{worst_abs!r}")
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
            statistics.median(decode_ms), row_counts,
            [outs[r] for r in rids])


def to_device(tree, dev):
    from repro_torch.nn.module import tree_map

    return tree_map(lambda v: v.detach().to(dev), tree)


class CpuChecks:
    """The CPU halves of the card-vs-CPU checks. ``submit`` queues one
    under a key once its card half is done and its inputs sit in host
    memory. ``window()`` runs the queue on a worker thread for the body of
    a ``with`` around device-timed work (kernel checks, CUDA-event times,
    which a busy host does not move) and stops after the task in hand when
    the body ends, so that no host-clock measurement runs beside a CPU
    pass. ``result`` returns a task's result, first running what is queued
    before it, and raises what the task raised (a ``fail``)."""

    def __init__(self):
        self.queue, self.done = collections.deque(), {}

    def submit(self, key, fn):
        self.queue.append((key, fn))

    def _run_one(self):
        key, fn = self.queue.popleft()
        try:
            self.done[key] = (True, fn())
        except BaseException as e:        # fail() raises SystemExit
            self.done[key] = (False, e)

    @contextlib.contextmanager
    def window(self):
        stop = threading.Event()

        def work():
            while self.queue and not stop.is_set():
                self._run_one()

        worker = threading.Thread(target=work, daemon=True)
        worker.start()
        try:
            yield
        finally:
            stop.set()
            worker.join()

    def result(self, key):
        while key not in self.done:
            self._run_one()
        ok, value = self.done.pop(key)
        if not ok:
            raise value
        return value


CPU_CHECKS = CpuChecks()


def phase_train(torch, dev):
    """Full-width qwen3-0.6b training through the kernels: one warm-up
    step, then TRAIN_STEPS counted steps with the launch counts read."""
    from repro_torch.configs.base import SWMConfig, TrainConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels.block_circulant import kernel
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, tree_leaves
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                        make_train_step, value_and_grad)

    cfg = dataclasses.replace(CONFIG, swm=SWMConfig(block_size=128,
                                                    impl="pallas"))
    tcfg = TrainConfig()
    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), seed=0, device=dev)
    state = init_train_state(params, tcfg, cfg.optimizer)
    step_fn = make_train_step(model, cfg, tcfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                       seed=0)

    def batch(i):
        return {"tokens": torch.from_numpy(data.batch_np(i)["tokens"]).to(
            dev)}

    circ = [p for p in tree_leaves(params) if p.dim() == 3]
    before = [p.detach().clone() for p in circ]
    t = time.perf_counter()
    state, m = step_fn(state, batch(0))          # warm-up; lr(0) = 0
    loss0 = float(m["loss"])
    warm_s = time.perf_counter() - t
    if not all(torch.equal(a, b) for a, b in zip(before, circ)):
        fail("step 0 (learning rate 0) changed the params")

    kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
    losses, norms, step_ms = [], [], []
    for i in range(1, TRAIN_STEPS + 1):
        t = time.perf_counter()
        state, m = step_fn(state, batch(i))
        losses.append(float(m["loss"]))          # waits for the device
        norms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(kernel.LAUNCHES)
    per_pass = 5 * cfg.n_layers
    passes = 3 if cfg.remat != "none" else 2      # forward, recompute, dx
    want = {"bc_matmul": passes * per_pass * TRAIN_STEPS,
            "bc_dw": per_pass * TRAIN_STEPS}
    if not all(math.isfinite(v) for v in losses + norms + [loss0]):
        fail(f"non-finite train loss or grad norm: {losses} {norms}")
    if launches != want:
        fail(f"train launches {launches} != {want} ({passes} x {per_pass} "
             f"bc_matmul and {per_pass} bc_dw per step, remat="
             f"{cfg.remat!r})")
    if any(torch.equal(a, b) for a, b in zip(before, circ)):
        fail("a circulant table did not move in steps 1..4")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ms = statistics.median(step_ms)
    print(f"train: qwen3-0.6b full width, remat={cfg.remat!r}, AdamW, "
          f"batch {TRAIN_BATCH} x seq {TRAIN_SEQ} = {tokens} tokens/step; "
          f"warm-up step {warm_s:.2f}s (loss {loss0!r}); steps 1..."
          f"{TRAIN_STEPS}: losses {losses}, grad norms {norms}, ms/step "
          f"{step_ms} (median {ms:.1f} = {tokens / ms * 1e3:.1f} tokens/s); "
          f"launches {launches} = {want}")

    # where a step's device time goes: one more full step, profiled
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batch(TRAIN_STEPS + 1))
        torch.cuda.synchronize()
    busy = report_profile(torch, prof, 1, ms, f"train step (batch "
                          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}; wall = the "
                          f"median unprofiled step)")

    # every circulant table gets a finite, non-zero grad (outside the count)
    _, grads = value_and_grad(make_loss_fn(model, cfg, tcfg),
                              state["params"], batch(99), has_aux=True)
    cg = [g for p, g in zip(tree_leaves(state["params"]),
                            tree_leaves(grads)) if p.dim() == 3]
    bad = [i for i, g in enumerate(cg)
           if not (bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0)]
    if len(cg) != 7 * cfg.n_layers or bad:
        fail(f"circulant grads: {len(cg)} tables, not finite or zero at {bad}")
    print(f"train grads: {len(cg)} circulant tables, all finite and "
          f"non-zero; global grad norm {float(global_norm(grads))!r}")
    return cfg, launches, ms, tokens, busy


def phase_cpu_vs_card(torch, cfg, engine, prompt_req):
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import load_tree

    cpu_model = build_model(cfg, device="cpu")
    load_tree(cpu_model, to_device(engine.params, "cpu"))
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


def time_ms(torch, fn, runs=TIME_RUNS, cycles=None):
    """Device time of one call: median over ``runs`` calls (TIME_MIN_RUNS
    once they pass TIME_BUDGET_S), CUDA events around each, behind a
    device-side sleep that outlasts the host's enqueue of the call (or of
    ``cycles``)."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    enqueue_s = time.perf_counter() - t
    torch.cuda.synchronize()
    if cycles is None:
        cycles = int(min(SLEEP_CYCLES, max(
            SLEEP_MIN_CYCLES, SLEEP_COVER * enqueue_s * SLEEP_CLOCK_HZ)))
    times = []
    t = time.perf_counter()
    for i in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
        if i + 1 >= TIME_MIN_RUNS and time.perf_counter() - t > TIME_BUDGET_S:
            break
    return statistics.median(times)


def bound(nbytes, flops):
    """(least time in ms, what bounds it) on the H100's published peaks."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_times(torch, kernel, dev, cases):
    """bc_matmul device times at ``cases`` = [(name, p, q, launches, B)]."""
    from repro_torch.core.circulant import blocks_to_dense
    from repro_torch.kernels.block_circulant.ops import freq_weights

    gen = torch.Generator(device=dev).manual_seed(2)
    Kf = K // 2 + 1
    rows = []
    print("bc_matmul device times (bf16 x, f32 tables, no bias; median of "
          "7-30 runs, CUDA events; bound = max(bytes / 3.35 TB/s, flops / "
          "67 TFLOP/s), flops with FFT-counted transforms; 'own' = the "
          "kernel's own flops / 67 TFLOP/s (x transformed once per block "
          "column); torch.matmul = the dense-equivalent product, a "
          "yardstick; geometry = grid, rows x output blocks per block, q "
          "chunk, q groups, transform path):")
    for name, p, q, per, B in cases:
        w = torch.randn(p, q, K, generator=gen, device=dev) * (q * K) ** -0.5
        wr, wi = freq_weights(w)
        dense_t = blocks_to_dense(w).T.contiguous().bfloat16()
        x = torch.randn(B, q * K, generator=gen, device=dev).bfloat16()
        ms = time_ms(torch, lambda: kernel.bc_matmul(x, wr, wi, k=K))
        # the same call behind the fixed SLEEP_CYCLES sleep: the shorter
        # sleep must time the same device work
        fixed = time_ms(torch, lambda: kernel.bc_matmul(x, wr, wi, k=K),
                        cycles=SLEEP_CYCLES)
        plain = time_ms(torch, lambda: kernel.bc_matmul_plain(x, wr, wi, k=K))
        lib = time_ms(torch, lambda: torch.matmul(x, dense_t))
        nbytes = x.nbytes + wr.nbytes + wi.nbytes + B * p * K * 2
        # least work: q forward and p inverse real transforms per row at
        # an FFT's 2.5·k·log2(k), plus the per-bin complex products
        flops = B * (2.5 * K * math.log2(K) * (q + p) + 8 * p * q * Kf)
        # this kernel's own count: each x row is transformed once per
        # column of blocks (grid[1] times)
        g = kernel._mm_geometry(B, p, q, K)
        kernel_flops = B * (2.5 * K * math.log2(K) * (q * g.grid[1] + p)
                            + 8 * p * q * Kf)
        b_ms, b_by = bound(nbytes, flops)
        geometry = (f"grid {g.grid[0]}x{g.grid[1]} = "
                    f"{g.grid[0] * g.grid[1]} blocks, {g.rows} rows x "
                    f"{g.p_group} out blocks, q chunk {g.q_chunk}, "
                    f"{g.q_groups} q groups, "
                    f"{'fft' if g.fft else 'dense'}")
        row = dict(shape=name, B=B, p=p, q=q, k=K, launches=per, ms=ms,
                   fixed_sleep_ms=fixed, plain_ms=plain, library_ms=lib, bound_ms=b_ms,
                   bound_by=b_by, bytes=nbytes, flops=flops,
                   kernel_flops=kernel_flops,
                   kernel_flops_ms=kernel_flops / F32_FLOP_PER_S * 1e3,
                   geometry=geometry, smem_bytes=g.smem_bytes)
        rows.append(row)
        print(f"  {name:9s} p={p:2d} q={q:2d} B={B:4d}: kernel {ms!r} ms "
              f"({fixed!r} behind a {SLEEP_CYCLES}-cycle sleep), "
              f"plain {plain!r} ms, torch.matmul {lib!r} ms, bound "
              f"{b_ms!r} ms ({b_by}), own {row['kernel_flops_ms']!r} "
              f"ms, {per} launches; {geometry}, {g.smem_bytes} B smem")
    return rows


# the wrapper's host time per call before its launch became a registered
# op (41.3 us, NVIDIA H100 80GB HBM3, 700 W) and the limit set beside it
# (50 us): the op may cost at most 50 / 41.3 of that path measured in the
# same run, so a slower host, which moves both, does not move the check
HOST_US_BEFORE, HOST_US_LIMIT = 41.3, 50.0
HOST_ROUNDS = 7


def phase_host_time(torch, kernel, dev):
    """Host cost of the bc_matmul wrapper: enqueue time per call, through
    the registered op, against the wrapper's path before the op in the
    same run."""
    from repro_torch.kernels.block_circulant.ops import freq_weights

    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(4, 8 * K, generator=gen, device=dev).bfloat16()
    wr, wi = freq_weights(torch.randn(32, 8, K, generator=gen, device=dev))

    def per_call(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(200):
            fn()
        us = (time.perf_counter() - t) / 200 * 1e6
        torch.cuda.synchronize()
        return us

    def old_launch_on(device, launch, *args):
        # the launch route before the ops: a device context and a Stream
        # object around every call
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            return launch(*args, stream)

    def before():
        # the public wrapper before the ops: its checks, then the launch
        if "none" not in kernel.ACTIVATIONS or x.device.type != "cuda":
            raise RuntimeError("not the cuda path")
        return kernel._bc_matmul_cuda(x, wr, wi, None, None, K, "none")

    def run_before():
        launch_on, kernel._launch_on = kernel._launch_on, old_launch_on
        try:
            return per_call(before)
        finally:
            kernel._launch_on = launch_on

    direct = kernel._bc_matmul_cuda
    # the wrapper as before (one mean over 200 calls), then interleaved
    # rounds of the parent's path, of the CUDA impl called directly (the
    # launch without the dispatcher) and of the op; the least of each
    host_us = per_call(lambda: kernel.bc_matmul(x, wr, wi, k=K))
    before_us, launch_us, op_us = [], [], []
    for _ in range(HOST_ROUNDS):
        before_us.append(run_before())
        launch_us.append(per_call(
            lambda: direct(x, wr, wi, None, None, K, "none")))
        op_us.append(per_call(lambda: kernel.bc_matmul(x, wr, wi, k=K)))
    least = dict(before=min(before_us), launch=min(launch_us),
                 op=min(op_us))
    limit = least["before"] * HOST_US_LIMIT / HOST_US_BEFORE
    print(f"host time per bc_matmul call (qkv, B=4, enqueue only; "
          f"{CARD[0]}): {host_us:.1f} us through the op "
          f"repro_torch::bc_matmul; least of {HOST_ROUNDS} interleaved "
          f"rounds: {least['op']:.1f} us through the op, "
          f"{least['before']:.1f} us on the path before the op (device "
          f"context and Stream object, no dispatcher), {least['launch']:.1f}"
          f" us for the op's CUDA impl called directly; the op costs "
          f"{least['op'] - least['before']:+.1f} us against the path before "
          f"it (limit {limit:.1f} us = {HOST_US_LIMIT} / {HOST_US_BEFORE} of "
          f"it)")
    if least["op"] > limit:
        fail(f"host time through the op {least['op']:.1f} us over "
             f"{limit:.1f} us ({HOST_US_LIMIT} / {HOST_US_BEFORE} of the "
             f"path before it, {least['before']:.1f} us)")
    return dict(host_us_per_call=host_us, host_us_least=least["op"],
                before_op_host_us=least["before"],
                launch_only_host_us=least["launch"],
                dispatcher_us=least["op"] - least["before"],
                host_us_limit=limit)


def phase_dw_times(torch, kernel, dev, B):
    """bc_dw device times at the train shapes (B rows, bf16 x and g, the
    time-domain epilogue the trainable tables take)."""
    gen = torch.Generator(device=dev).manual_seed(5)
    Kf = K // 2 + 1
    rows = []
    print(f"bc_dw device times (B={B}, bf16 x and g, dw (P, Q*k) f32; median "
          f"of 7-30 runs, CUDA events; bound = max(one read of x and g and "
          f"one write of dw / 3.35 TB/s, flops / 67 TFLOP/s) with (P+Q) FFT-"
          f"counted transforms and 8*P*Q*K per row; g.T @ x = the dense "
          f"weight gradient, a yardstick the port never calls; [first "
          f"version's ms]; geometry = grid, tile p x q blocks, thread p x q, "
          f"rows per split, rows per chunk):")
    for name, P, Q, per in SLICE_SHAPES:
        x = torch.randn(B, Q * K, generator=gen, device=dev).bfloat16()
        g = torch.randn(B, P * K, generator=gen, device=dev).bfloat16()
        ms = time_ms(torch, lambda: kernel.bc_dw(x, g, P=P, Q=Q, k=K))
        plain = time_ms(torch, lambda: kernel.bc_dw_plain(x, g, P=P, Q=Q,
                                                          k=K))
        dense = time_ms(torch, lambda: torch.matmul(g.T, x))
        nbytes = x.nbytes + g.nbytes + P * Q * K * 4
        flops = B * (2.5 * K * math.log2(K) * (P + Q) + 8 * P * Q * Kf)
        b_ms, b_by = bound(nbytes, flops)
        geo = kernel._dw_geometry(B, P, Q, K)
        geometry = (f"grid {geo.grid[0]}x{geo.grid[1]}, tile "
                    f"{geo.p_tile} x {geo.q_tile} ({geo.tiles[0]}x"
                    f"{geo.tiles[1]} tiles), thread {geo.p_per_thread} x "
                    f"{geo.q_per_thread}, {geo.rows_per_split} rows per "
                    f"split, {geo.rows} per chunk, "
                    f"{'fft' if geo.fft else 'dense'}")
        rows.append(dict(shape=name, B=B, P=P, Q=Q, k=K, launches=per,
                         ms=ms, plain_ms=plain, library_ms=None,
                         dense_dw_matmul_ms=dense, bound_ms=b_ms,
                         bound_by=b_by, bytes=nbytes, flops=flops,
                         geometry=geometry, smem_bytes=geo.smem_bytes))
        print(f"  {name:6s} P={P:2d} Q={Q:2d}: kernel {ms!r} ms "
              f"[{DW_FIRST_MS[name]!r}], plain {plain!r} ms, g.T @ x "
              f"{dense!r} ms, bound {b_ms!r} ms ({b_by}), {per} "
              f"launches/step; {geometry}, {geo.smem_bytes} B smem")
    return rows


def device_kernels(torch, prof):
    """{name: [device ns, count]} of a finished profile's device events
    (kernels, copies, sets), read from the raw kineto events:
    ``key_averages()`` would build a Python event per kernel first (~80 µs
    each, tens of seconds for a train step of the scans' ~300k kernels).
    CPU op rows are left out: they carry the device time of the kernels
    they launch, which would count it twice."""
    cuda = torch.autograd.DeviceType.CUDA
    out = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda:
            row = out.setdefault(e.name(), [0, 0])
            row[0] += e.duration_ns()
            row[1] += 1
    return out


def report_profile(torch, prof, n, wall_ms, what):
    """Device busy time per step and the top kernels of a profile; returns
    the busy ms per step (None when the profiler saw no device time)."""
    kernels = device_kernels(torch, prof)
    busy_ms = sum(ns for ns, _ in kernels.values()) / 1e6 / n
    if busy_ms == 0:
        print(f"profile, {what}: the profiler saw no device time "
              f"(not measured)")
        return None
    print(f"profile, {what}: device busy {busy_ms:.3f} ms/step of "
          f"{wall_ms:.2f} ms/step unprofiled (device idle share "
          f"{1 - busy_ms / wall_ms:.3f}); "
          f"{sum(c for _, c in kernels.values()) // n} device kernels/step")
    # the six largest, then the port's own kernels wherever they rank
    ranked = sorted(kernels.items(), key=lambda kv: kv[1][0], reverse=True)
    for i, (key, (ns, count)) in enumerate(ranked):
        if i < 6 or "bc_matmul" in key or "bc_dw" in key:
            print(f"  {ns / 1e6 / n:8.3f} ms/step "
                  f"{count // n:5d} launches/step  {key[:70]}")
    return busy_ms


def phase_profile(torch, engine, reqs, step_ms):
    """Device time of decode steps with 4 active slots (torch.profiler);
    returns the busy ms per step."""
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
    return report_profile(torch, prof, n, step_ms,
                          "decode step at 4 active slots")


# ---------------------------------------------------------------------------
# The resilient serving tier: prefix cache, NaN guard, deadlines, cancel
# ---------------------------------------------------------------------------

# part (a): qwen3-0.6b at full depth behind a 256-row cache; 8 greedy
# requests of 16 tokens, each one seeded 128-token head plus a seeded tail
# of 4-20 tokens, all submitted at once, so requests 5-8 find resident
# donors
RESILIENT_CACHE_LEN = 256
RESILIENT_HEAD = 128
RESILIENT_TAILS = (4, 21)
RESILIENT_SEED = 7
# part (b): hit vs full prefill logits in f32 (2 of 28 layers), held to
# the conformance tolerance; the planted fault masks the head's last row
PREFIX_TOL = FP32_TOL
# part (c): the NaN guard at 2 layers, untied head, 8 slots with one
# decode bucket so every launch keeps its shape whatever fails
NAN_SLOTS = 8
NAN_MAX_NEW = 8
NAN_CACHE_LEN = 64


def resilient_requests(cfg, n=8, max_new=16, seed=RESILIENT_SEED):
    """Part (a)'s traffic: one seeded 128-token head, ``n`` seeded tails of
    4-20 tokens. Predicted counters: every request after the first
    ``batch`` admissions matches a resident donor on the whole head (the
    tails' first tokens differ, so no match runs past it): 4 hits of 128
    tokens over 8 lookups."""
    from repro_torch.serve.engine import Request
    import numpy as np

    rng = np.random.default_rng(seed)
    head = rng.integers(0, cfg.vocab, size=RESILIENT_HEAD).astype(np.int32)
    tails = [rng.integers(0, cfg.vocab, size=int(rng.integers(
        *RESILIENT_TAILS))).astype(np.int32) for _ in range(n)]
    if len({int(t[0]) for t in tails}) != n:
        fail("serve_resilient: two tails share their first token")
    return [Request(np.concatenate([head, t]), max_new=max_new)
            for t in tails]


def timed_calls(torch, runner, log, attr="prefill"):
    """Wrap ``runner.prefill`` (or ``runner.decode``) so each call appends
    (shape, span ms, busy ms) to ``log``: the span between CUDA events
    around the call, and the device busy time of its kernels
    (``torch.profiler``). The forward blocks the host on the device (a
    device sleep ahead of the call never outlasts the enqueue), so the
    span includes the device's waits for the host. Returns the undo."""
    from torch.profiler import ProfilerActivity, profile

    inner = getattr(runner, attr)

    def timed(tokens, *args, **kw):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            a.record()
            out = inner(tokens, *args, **kw)
            b.record()
            b.synchronize()
        busy = device_busy_ms(torch, prof)
        log.append((tuple(tokens.shape), a.elapsed_time(b), busy))
        return out

    setattr(runner, attr, timed)
    return lambda: delattr(runner, attr)


def serve_resilient_run(torch, kernel, engine, reqs, name):
    """``reqs`` through ``engine`` with bc_matmul counted from 0 and every
    prefill timed; held to 5 launches per layer per forward and every
    request's ``max_new`` tokens.
    Returns (tokens, launches, forwards, prefill log)."""
    s = engine.stats
    f0 = s.prefill_calls + s.decode_steps
    log = []
    undo = timed_calls(torch, engine.runner, log)
    torch.cuda.synchronize()
    kernel.LAUNCHES["bc_matmul"] = 0
    try:
        rids = [engine.submit(r) for r in reqs]
        outs = engine.drain(rids)
    finally:
        torch.cuda.synchronize()
        undo()
    launches = kernel.LAUNCHES["bc_matmul"]
    forwards = s.prefill_calls + s.decode_steps - f0
    per = 5 * engine.cfg.n_layers
    if [len(outs[r]) for r in rids] != [r.max_new for r in reqs]:
        fail(f"{name}: token counts {[len(outs[r]) for r in rids]}")
    if launches != per * forwards:
        fail(f"{name}: bc_matmul launches {launches} != {per} x {forwards}")
    return [outs[r] for r in rids], launches, forwards, log


def prefix_f32_check(torch, cfg, dev):
    """Part (b): 2 layers at full width in f32. A donor prompt (head +
    its own tail) fills slot 0; the consumer (head + another tail)
    prefills only its tail into slot 1 from slot 0's rows (the engine's
    layout), against a full prefill of the consumer's prompt. Then the
    planted fault: the seed masks the head's last row. Returns (sound,
    planted) rel errs."""
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import ServeEngine, pick_bucket
    import numpy as np

    cfg = dataclasses.replace(cut_depth(cfg, 2), param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, device=dev)
    eng = ServeEngine(model, cfg, init_params(model.specs(), seed=0,
                                              device=dev),
                      batch=2, cache_len=RESILIENT_CACHE_LEN)
    r, C = eng.runner, RESILIENT_CACHE_LEN
    donor, consumer = (np.asarray(q.prompt, np.int64)
                       for q in resilient_requests(cfg)[:2])
    m = RESILIENT_HEAD
    T = consumer.shape[0] - m
    Sb = pick_bucket(T, eng.prompt_buckets)

    def t(a):
        return torch.as_tensor(np.asarray(a), device=dev)

    def left_padded(p):
        S = pick_bucket(p.shape[0], eng.prompt_buckets)
        toks = np.zeros((1, S), np.int64)
        toks[0, S - p.shape[0]:] = p
        return t(toks), t(np.arange(S, dtype=np.int32)[None]
                          - (S - p.shape[0]))

    tok = np.zeros((1, Sb), np.int64)
    tok[0, Sb - T:] = consumer[m:]
    pos = np.zeros((1, Sb), np.int32)
    pos[0, Sb - T:] = m + np.arange(T)
    pos[0, :Sb - T] = m + T + np.arange(Sb - T) - C
    zero, one = t(np.asarray([0])), t(np.asarray([1]))

    def hit():
        state = r.prefill(*left_padded(donor), r.init_state(2), zero)[2]
        return r.prefill(t(tok), t(pos), state, one, donor_idx=zero,
                         match_len=t(np.asarray([m], np.int32)))[0]

    full = r.prefill(*left_padded(consumer), r.init_state(1), zero)[0]
    sound = rel_err(hit(), full)
    seed = type(r)._seed_state
    r._seed_state = lambda s, d, ml: seed(r, s, d, ml - 1)
    try:
        planted = rel_err(hit(), full)
    finally:
        del r._seed_state
    torch.cuda.synchronize()
    print(f"serve_resilient prefix check (f32, 2 layers at full width): "
          f"{T}-token tail after a {m}-token head copied from a donor slot "
          f"(bucket {Sb}) vs a full prefill of {consumer.shape[0]} tokens: "
          f"rel err {sound!r} (tolerance {PREFIX_TOL}); planted fault "
          f"(seed masks the head's last row) rel err {planted!r}")
    if not sound <= PREFIX_TOL:
        fail(f"prefix check rel err {sound:.3g} > {PREFIX_TOL}")
    if not planted > PREFIX_TOL:
        fail(f"planted prefix fault reads {planted:.3g}, not above "
             f"{PREFIX_TOL}")
    return sound, planted


def nan_guard_check(torch, kernel, cfg, dev, store=None):
    """Part (c): 2 layers at full width with an untied head and one NaN
    embedding row. A fault-free run of the mix picks the poison: the
    victim's first generated token, which no clean request carries or
    emits. Then the poisoned run: one request carries the poison in its
    prompt (fails in prefill), the victim feeds it back (fails in decode);
    the four clean requests' tokens must equal the fault-free run's bit
    for bit, the scrubbed slots hold fresh rows, a second pass reuses the
    scrubbed slots with the same results, nothing leaks; then one cancel
    and one deadline expiry on a ManualClock. With a prefix ``store`` on
    the poisoned engine: every eviction of a scrubbed slot spills nothing,
    and no poisoned prompt reaches the store."""
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.guard import ManualClock
    import numpy as np

    cfg = dataclasses.replace(cut_depth(cfg, 2), tie_embeddings=False)
    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), seed=0, device=dev)
    rng = np.random.default_rng(RESILIENT_SEED + 1)
    prompts = [rng.integers(0, cfg.vocab, size=int(rng.integers(9, 17))
                            ).astype(np.int32) for _ in range(8)]

    def engine(p, clock=None, prefix_store=None):
        # prefix_block past every prompt: no match, so each prefill seeds
        # from its own slot's rows (match 0) — the path a scrub protects
        return ServeEngine(model, cfg, p, batch=NAN_SLOTS,
                           cache_len=NAN_CACHE_LEN, prefix_cache=True,
                           prefix_block=NAN_CACHE_LEN,
                           decode_buckets=(NAN_SLOTS,),
                           clock=clock or time.monotonic,
                           prefix_store=prefix_store)

    def mix(carrier_tok, victim):
        # [carrier, victim, 4 clean]: the carrier's middle token is the
        # poison (or, fault-free, its clean stand-in)
        carrier = prompts[0].copy()
        carrier[len(carrier) // 2] = carrier_tok
        clean = [p for i, p in enumerate(prompts[1:]) if i != victim][:4]
        return [Request(p, max_new=NAN_MAX_NEW)
                for p in [carrier, prompts[1 + victim]] + clean]

    base_eng = engine(params)
    for victim in range(7):
        reqs = mix(int(prompts[0][len(prompts[0]) // 2]), victim)
        base = base_eng.generate(reqs)
        poison = base[1][0]
        clean = {int(x) for r, o in zip(reqs[2:], base[2:])
                 for x in list(r.prompt) + o}
        if (poison not in clean and poison not in reqs[1].prompt
                and poison not in reqs[0].prompt and poison not in base[0]):
            break
    else:
        fail("nan guard: no victim whose first token is unused elsewhere")
    table = params["embed"]["table"].clone()
    table[poison] = float("nan")
    poisoned = dict(params, embed=dict(params["embed"], table=table))
    clk = ManualClock()
    eng = engine(poisoned, clk, store)
    bad = mix(poison, victim)
    drops = []                 # (slot, spill, rows indexed) per eviction
    drop = eng._index_drop_slot

    def logged_drop(slot, *, spill=True):
        drops.append((slot, spill, eng._slot_prompt[slot] is not None))
        drop(slot, spill=spill)

    eng._index_drop_slot = logged_drop
    fresh = eng.runner.init_state(1)
    scrubbed = []
    scrub = eng._scrub_slot

    def checked_scrub(slot):
        # the rows must equal fresh rows right after the scrub (a later pad
        # lane of the same step may write into the freed slot)
        scrub(slot)
        rows = eng.runner.gather_state(
            eng.cache, torch.as_tensor([slot], device=dev))
        if not all(torch.equal(got[n], want[n])
                   for got, want in zip(rows, fresh) for n in want):
            fail(f"nan guard: scrubbed slot {slot} is not blank")
        scrubbed.append(slot)

    eng._scrub_slot = checked_scrub
    kernel.LAUNCHES["bc_matmul"] = 0
    rids = [eng.submit(r) for r in bad]
    while eng.step():
        pass
    launches = kernel.LAUNCHES["bc_matmul"]
    forwards = eng.stats.prefill_calls + eng.stats.decode_steps
    if launches != 10 * forwards:
        fail(f"nan guard: bc_matmul launches {launches} != 10 x {forwards}")
    states = [eng.poll(r) for r in rids]
    want = [("FAILED", "non-finite logits in prefill (request aborted; "
             "batch continues)"), ("FAILED", "non-finite logits in decode "
                                   "(request aborted; batch continues)")]
    if [(s.status, s.error) for s in states[:2]] != want:
        fail(f"nan guard: poisoned requests ended "
             f"{[(s.status, s.error) for s in states[:2]]}")
    if sorted(scrubbed) != [0, 1] or states[1].tokens != (poison,):
        fail(f"nan guard: scrubbed slots {scrubbed}, victim tokens "
             f"{states[1].tokens}")
    first_scrubs = sorted(scrubbed)
    got = [list(s.tokens) for s in states[2:]]
    if got != base[2:] or any(s.status != "FINISHED" for s in states[2:]):
        fail(f"nan guard: clean tokens {got} != fault-free {base[2:]}")
    eng.drain(rids)
    # second pass over the scrubbed slots, the carrier now clean: it must
    # give the fault-free tokens from slot 0; the victim fails again
    again = [eng.submit(q) for q in mix(int(prompts[0][len(prompts[0])
                                                        // 2]), victim)]
    while eng.step():
        pass
    again = [eng.poll(r) for r in again]
    if [list(s.tokens) for s in again[:1] + again[2:]] != \
            base[:1] + base[2:] or [s.status for s in again] != \
            ["FINISHED", "FAILED"] + ["FINISHED"] * 4:
        fail(f"nan guard: the second pass differs: "
             f"{[(s.status, s.error) for s in again]}")
    eng.drain()
    # one deadline expiry and one cancel on the manual clock
    doomed = eng.submit(Request(prompts[2], max_new=NAN_MAX_NEW,
                                deadline_ms=5.0))
    victim_c = eng.submit(Request(prompts[3], max_new=NAN_MAX_NEW))
    eng.step()
    clk.advance(0.010)
    eng.cancel(victim_c)
    while eng.step():
        pass
    ends = [(eng.poll(r).status, eng.poll(r).error)
            for r in (doomed, victim_c)]
    if ends != [("EXPIRED", "deadline_ms=5.0 exceeded at step boundary"),
                ("CANCELLED", "cancelled by caller")]:
        fail(f"nan guard: deadline/cancel ended {ends}")
    eng.drain()
    if eng._active.any() or (eng._slot_refs != 0).any() or eng._rid_slot \
            or len(eng._sched):
        fail("nan guard: a slot, pin or queue entry leaked")
    st = eng.stats
    print(f"serve_resilient nan guard (2 layers at full width, untied head, "
          f"poison token {poison}): prefill carrier and decode victim "
          f"FAILED with the reference's errors, slots {first_scrubs} "
          f"scrubbed to fresh rows, 4 clean requests bit-identical to the "
          f"fault-free run twice, the clean carrier's too from its "
          f"scrubbed slot (the victim's second end: {again[1].error!r}); "
          f"bc_matmul launches {launches} = 10 x "
          f"{forwards}; then EXPIRED and CANCELLED as expected; aborted "
          f"{st.aborted}, expired {st.expired}, cancelled {st.cancelled}, "
          f"no leaks")
    rows = ({b * t for b, t in st.prefill_shapes}
            | set(st.decode_shapes))
    out = dict(poison=poison, aborted=st.aborted, expired=st.expired,
               cancelled=st.cancelled, launches=launches)
    if store is not None:
        poisoned_prompts = {np.asarray(q.prompt, np.int32).tobytes()
                            for q in bad[:2]}
        stored = {p.tobytes() for p, _ in store.hottest()}
        scrub_drops = [d for d in drops if not d[1]]
        spilled = sum(1 for d in drops if d[1] and d[2])
        if not scrub_drops or poisoned_prompts & stored \
                or st.prefix_spills != spilled \
                or store.spills != spilled or not spilled:
            fail(f"nan guard with a prefix store: scrub evictions "
                 f"{scrub_drops}, {st.prefix_spills} spills of {spilled} "
                 f"indexed evictions, poisoned prompts stored: "
                 f"{len(poisoned_prompts & stored)}")
        print(f"durable (b) nan guard with a prefix store: "
              f"{len(scrub_drops)} scrub evictions of the decode victim "
              f"(slots {sorted({d[0] for d in scrub_drops})}) spilled "
              f"nothing (the prefill carrier was never indexed); {spilled} "
              f"clean donors spilled; no poisoned prompt stored")
        out.update(store_spills=spilled, scrub_evictions=len(scrub_drops))
    return rows, out


def phase_serve_resilient(torch, kernel, dev):
    """The resilient serving tier on the card: (a) full-width qwen3-0.6b
    with the prefix cache against the same requests without it, (b) the
    f32 prefix check, (c) the NaN guard with cancel and deadline. Returns
    (report row, bc_matmul row counts launched)."""
    from repro_torch.configs.base import SWMConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import ServeEngine

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(CONFIG, swm=SWMConfig(block_size=128,
                                                    impl="pallas"))
    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), seed=0, device=dev)
    reqs = resilient_requests(cfg)
    runs = {}
    for on in (False, True):
        eng = ServeEngine(model, cfg, params, batch=4,
                          cache_len=RESILIENT_CACHE_LEN, prefix_cache=on)
        outs, launches, forwards, log = serve_resilient_run(
            torch, kernel, eng, reqs, f"serve_resilient prefix_cache={on}")
        runs[on] = (eng, outs, launches, forwards, log)
    on_eng, on_outs, launches, forwards, on_log = runs[True]
    off_eng, off_outs, _, _, off_log = runs[False]
    s = on_eng.stats
    want = (len(reqs) - on_eng.batch, RESILIENT_HEAD
            * (len(reqs) - on_eng.batch), len(reqs))
    got = (s.prefix_hits, s.prefill_tokens_saved, s.prefix_lookups)
    if got != want:
        fail(f"serve_resilient: (hits, saved, lookups) {got} != predicted "
             f"{want}")
    # the first admission round misses on both engines; the rest of the
    # prefills serve requests 5-8: hits on one engine, full prompts on the
    # other
    hit_ms, hit_busy = (sum(x[i] for x in on_log[1:]) for i in (1, 2))
    miss_ms, miss_busy = (sum(x[i] for x in off_log[1:]) for i in (1, 2))
    agree = sum(a == b for a, b in zip(on_outs, off_outs))
    print(f"serve_resilient (qwen3-0.6b, {cfg.n_layers} layers, bf16, "
          f"batch 4, cache_len {RESILIENT_CACHE_LEN}, 8 requests = "
          f"{RESILIENT_HEAD}-token shared head + 4-20-token tails, 16 new "
          f"tokens each): prefix hits {s.prefix_hits} of {s.prefix_lookups} "
          f"lookups (hit rate {s.prefix_hit_rate!r}), prefill tokens saved "
          f"{s.prefill_tokens_saved} (as predicted); bc_matmul launches "
          f"{launches} = {5 * cfg.n_layers} x {forwards} forwards; prefill "
          f"shapes {sorted(s.prefill_shapes)} (cache off: "
          f"{sorted(off_eng.stats.prefill_shapes)})")
    for name, log in (("prefix cache", on_log), ("no prefix cache",
                                                 off_log)):
        print(f"  {name}: prefill launches (B, S): span ms (CUDA events) / "
              f"device busy ms (profiler): " + ", ".join(
                  f"{sh}: {e!r} / {b!r}" for sh, e, b in log))
    print(f"  requests 5-8 prefill: {hit_busy!r} ms device busy with the "
          f"prefix cache, {miss_busy!r} ms without (ratio "
          f"{miss_busy / hit_busy!r}); spans {hit_ms!r} and {miss_ms!r} ms; "
          f"token streams equal in {agree} of {len(reqs)} (bf16: tail and "
          f"full prefill take different attention paths)")
    sound, planted = prefix_f32_check(torch, cfg, dev)
    nan_rows, nan = nan_guard_check(torch, kernel, cfg, dev)
    rows = nan_rows
    for e in (on_eng, off_eng):
        rows |= {b * t for b, t in e.stats.prefill_shapes}
        rows |= set(e.stats.decode_shapes)
    print(f"serve_resilient phase: {time.perf_counter() - t_phase:.1f}s")
    return dict(launches=launches, forwards=forwards,
                prefix_hits=s.prefix_hits,
                prefix_lookups=s.prefix_lookups,
                prefix_hit_rate=s.prefix_hit_rate,
                prefill_tokens_saved=s.prefill_tokens_saved,
                prefill_shapes=sorted(s.prefill_shapes),
                prefill_log=[list(x) for x in on_log],
                prefill_log_off=[list(x) for x in off_log],
                hit_prefill_ms=hit_ms, hit_prefill_busy_ms=hit_busy,
                miss_prefill_ms=miss_ms, miss_prefill_busy_ms=miss_busy,
                streams_equal=agree,
                f32_rel_err=sound,
                f32_planted_rel_err=planted, nan_guard=nan), rows


# ---------------------------------------------------------------------------
# The durable tier: snapshot/restore, the prefix store, TrainDriver
# ---------------------------------------------------------------------------

# part (a): serve_resilient's 8 requests plus 2 seeded ones sampled at
# temperature 0.8, top_k 50 (their numpy RNG states ride in the snapshot);
# the snapshot after 6 steps
DURABLE_SAMPLED = (0.8, 50)
DURABLE_SNAPSHOT_AT = 6
# part (b): the store's byte budget (one spilled qwen3-0.6b slot at
# cache_len 256 is 28 layers x (K, V) x 256 x 8 x 128 x 2 B = 28 MiB); wave
# 2 is one admission round of 4 requests on another seeded head, so it
# evicts (spills) wave 1's 4 resident donors and none of its own
DURABLE_STORE_BYTES = 256 << 20
DURABLE_WAVE2 = (4, RESILIENT_SEED + 2)
# part (c): 2 layers at full width, 6 steps, a fault before step 3,
# checkpoints every 2 steps; the resumed run against an uninterrupted one:
# bit-identical expected, held to RESUME_TOL (an embedding backward's
# atomics may reorder sums)
DURABLE_TRAIN_LAYERS = 2
DURABLE_TRAIN_STEPS = 6
DURABLE_FAIL_AT = 3
DURABLE_CKPT_EVERY = 2
RESUME_TOL = 1e-5


def durable_requests(cfg):
    """Part (a)'s traffic: serve_resilient's 8 greedy requests and two
    seeded prompts of 8-40 tokens sampled at ``DURABLE_SAMPLED``."""
    from repro_torch.serve.engine import Request, SamplingParams
    import numpy as np

    rng = np.random.default_rng(RESILIENT_SEED + 3)
    t, k = DURABLE_SAMPLED
    return resilient_requests(cfg) + [
        Request(rng.integers(0, cfg.vocab, size=int(rng.integers(8, 41)))
                .astype(np.int32), max_new=16,
                sampling=SamplingParams(t, k, seed=i + 1)) for i in range(2)]


def dir_bytes(path):
    return sum(f.stat().st_size for f in Path(path).rglob("*") if f.is_file())


def rows_equal(torch, a, b):
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and torch.equal(a[k].cpu(), b[k].cpu())
        for k in a)


def fresh_engine(cfg, dev, **kw):
    """An engine on a model built anew from the seeded params, as a
    replacement process would build it."""
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import ServeEngine

    model = build_model(cfg, device=dev)
    return ServeEngine(model, cfg, init_params(model.specs(), seed=0,
                                               device=dev), **kw)


def durable_snapshot(torch, kernel, cfg, dev, model, params, tmp):
    """Part (a): engine A serves ``durable_requests`` and snapshots after
    ``DURABLE_SNAPSHOT_AT`` steps; engine B, on a fresh model, restores
    and drains. B's restored cache must equal A's at the snapshot bit for
    bit and all ten streams A's; 140 launches per forward on both."""
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.guard import flatten_state_tree

    reqs = durable_requests(cfg)
    kw = dict(batch=4, cache_len=RESILIENT_CACHE_LEN, prefix_cache=True,
              snapshot_dir=tmp)
    per = 5 * cfg.n_layers
    a = ServeEngine(model, cfg, params, **kw)
    torch.cuda.synchronize()
    kernel.LAUNCHES["bc_matmul"] = 0
    rids = [a.submit(r) for r in reqs]
    for _ in range(DURABLE_SNAPSHOT_AT):
        a.step()
    torch.cuda.synchronize()
    t = time.perf_counter()
    path = a.snapshot()
    snap_ms = (time.perf_counter() - t) * 1e3
    kept = {k: v.clone() for k, v in flatten_state_tree(a.cache).items()}
    cache_bytes = sum(v.numel() * v.element_size() for v in kept.values())
    live = sum(1 for r in rids if not a.poll(r).done)
    while a.step():
        pass
    torch.cuda.synchronize()
    forwards_a = a.stats.prefill_calls + a.stats.decode_steps
    if kernel.LAUNCHES["bc_matmul"] != per * forwards_a:
        fail(f"durable (a): engine A's bc_matmul launches "
             f"{kernel.LAUNCHES['bc_matmul']} != {per} x {forwards_a}")
    want = [a.poll(r) for r in rids]
    if any(w.status != "FINISHED" or len(w.tokens) != r.max_new
           for w, r in zip(want, reqs)):
        fail(f"durable (a): engine A ended {[w.status for w in want]}")
    nbytes = dir_bytes(path)

    b = fresh_engine(cfg, dev, **kw)
    torch.cuda.synchronize()
    t = time.perf_counter()
    step = b.restore()
    torch.cuda.synchronize()
    restore_ms = (time.perf_counter() - t) * 1e3
    if step != DURABLE_SNAPSHOT_AT or not rows_equal(
            torch, flatten_state_tree(b.cache), kept):
        fail(f"durable (a): B restored step {step}, or its cache differs "
             f"from A's at the snapshot")
    s = b.stats
    f0 = s.prefill_calls + s.decode_steps
    log = []
    undo = timed_calls(torch, b.runner, log, "decode")
    kernel.LAUNCHES["bc_matmul"] = 0
    try:
        while b.step():
            pass
    finally:
        torch.cuda.synchronize()
        undo()
    forwards = s.prefill_calls + s.decode_steps - f0
    launches = kernel.LAUNCHES["bc_matmul"]
    if launches != per * forwards:
        fail(f"durable (a): engine B's bc_matmul launches {launches} != "
             f"{per} x {forwards}")
    got = [b.poll(r) for r in rids]
    if got != want:
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        fail(f"durable (a): restored streams {bad} differ from A's")
    busy4 = [x[2] for x in log if x[0][0] == 4]
    busy = statistics.median(busy4) if busy4 else None
    print(f"durable (a) snapshot/restore (qwen3-0.6b, {cfg.n_layers} layers, "
          f"bf16, batch 4, cache_len {RESILIENT_CACHE_LEN}, prefix cache; "
          f"{len(reqs)} requests, 2 sampled at T={DURABLE_SAMPLED[0]}, "
          f"top_k={DURABLE_SAMPLED[1]}): snapshot at step {step} with "
          f"{live} requests unfinished; {cache_bytes} B of K/V on the card, "
          f"{nbytes} B written; snapshot() {snap_ms!r} ms, restore() "
          f"{restore_ms!r} ms wall ({CARD[0]}); B's cache equals A's bit "
          f"for bit, all {len(reqs)} streams equal A's (sampled included); "
          f"bc_matmul launches A {per} x {forwards_a}, B {launches} = {per} "
          f"x {forwards}; B's decode busy per step at 4 rows (profiler, "
          f"median of {len(busy4)}): {busy!r} ms ({CARD[0]})")
    rows = set()
    for e in (a, b):
        rows |= {x * y for x, y in e.stats.prefill_shapes}
        rows |= set(e.stats.decode_shapes)
    return dict(snapshot_bytes=nbytes, cache_bytes=cache_bytes,
                snapshot_ms=snap_ms, restore_ms=restore_ms,
                launches=per * forwards_a + launches,
                restored_forwards=forwards, decode_busy_ms=busy,
                decode_busy_all=busy4), rows


def durable_store(torch, kernel, cfg, dev, model, params, tmp):
    """Part (b): wave 1 (serve_resilient's traffic) and wave 2 (4 requests
    on another head) through a prefix-cache engine with a ``PrefixStore``;
    save, load into a fresh store, adopt into a cold engine C on a fresh
    model, and serve wave 1's requests 5-8 again: the adopted rows equal
    the spilled ones bit for bit, C's hits equal the requests that reach an
    adopted prompt, C's tokens equal the first engine's."""
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.prefix_store import PrefixStore
    from repro_torch.serve.guard import flatten_state_tree
    import numpy as np

    per = 5 * cfg.n_layers
    store = PrefixStore(capacity_bytes=DURABLE_STORE_BYTES, persist_dir=tmp)
    eng = ServeEngine(model, cfg, params, batch=4,
                      cache_len=RESILIENT_CACHE_LEN, prefix_cache=True,
                      prefix_store=store)
    spill_ms = []
    drop = eng._index_drop_slot

    def timed_drop(slot, *, spill=True):
        n = store.spills
        t = time.perf_counter()
        drop(slot, spill=spill)
        if store.spills > n:
            spill_ms.append((time.perf_counter() - t) * 1e3)

    eng._index_drop_slot = timed_drop
    wave1 = resilient_requests(cfg)
    wave2 = resilient_requests(cfg, *DURABLE_WAVE2)
    torch.cuda.synchronize()
    kernel.LAUNCHES["bc_matmul"] = 0
    out1 = eng.generate(wave1)
    after1 = dict(store.as_dict())
    eng.generate(wave2)
    torch.cuda.synchronize()
    forwards = eng.stats.prefill_calls + eng.stats.decode_steps
    if kernel.LAUNCHES["bc_matmul"] != per * forwards:
        fail(f"durable (b): bc_matmul launches "
             f"{kernel.LAUNCHES['bc_matmul']} != {per} x {forwards}")
    spilled = {p.tobytes(): (p, rows) for p, rows in store.hottest()}
    head1 = wave1[0].prompt[:RESILIENT_HEAD].tobytes()
    w1_entries = sum(1 for p, _ in spilled.values()
                     if p[:RESILIENT_HEAD].tobytes() == head1)
    if eng.stats.prefix_spills != store.spills or store.spills < 4 \
            or w1_entries < 4:
        fail(f"durable (b): {eng.stats.prefix_spills} spills counted, "
             f"store {store.as_dict()}, {w1_entries} wave-1 entries")
    t = time.perf_counter()
    store.save()
    save_ms = (time.perf_counter() - t) * 1e3
    saved_bytes = dir_bytes(tmp)
    t = time.perf_counter()
    loaded = PrefixStore.load(tmp)
    load_ms = (time.perf_counter() - t) * 1e3
    if [p.tobytes() for p, _ in loaded.hottest()] != list(spilled) or \
            not all(rows_equal(torch, rows, spilled[p.tobytes()][1])
                    for p, rows in loaded.hottest()):
        fail("durable (b): the loaded store differs from the saved one")

    c = fresh_engine(cfg, dev, batch=4, cache_len=RESILIENT_CACHE_LEN,
                     prefix_cache=True, prefix_store=loaded)
    torch.cuda.synchronize()
    t = time.perf_counter()
    adopted = c.adopt_prefixes()
    torch.cuda.synchronize()
    adopt_ms = (time.perf_counter() - t) * 1e3
    slots = [s for s in range(c.batch) if c._slot_prompt[s] is not None]
    for s in slots:
        rows = flatten_state_tree(c.runner.gather_state(
            c.cache, torch.as_tensor([s], device=dev)))
        if not rows_equal(torch, rows,
                          spilled[c._slot_prompt[s].tobytes()][1]):
            fail(f"durable (b): adopted slot {s}'s rows differ from the "
                 f"spilled rows")
    again = [Request(r.prompt, max_new=r.max_new) for r in wave1[4:]]
    reach = sum(1 for r in again if any(
        np.array_equal(c._slot_prompt[s][:c.prefix_block],
                       r.prompt[:c.prefix_block]) for s in slots))
    kernel.LAUNCHES["bc_matmul"] = 0
    out_c = c.generate(again)
    torch.cuda.synchronize()
    fc = c.stats.prefill_calls + c.stats.decode_steps
    if kernel.LAUNCHES["bc_matmul"] != per * fc:
        fail(f"durable (b): C's bc_matmul launches "
             f"{kernel.LAUNCHES['bc_matmul']} != {per} x {fc}")
    if adopted != len(slots) or adopted != c.batch \
            or c.stats.prefix_hits != reach or reach != len(again):
        fail(f"durable (b): adopted {adopted} into {slots}, hits "
             f"{c.stats.prefix_hits}, reachable {reach}")
    if out_c != out1[4:]:
        fail(f"durable (b): C's tokens {out_c} != the first engine's "
             f"{out1[4:]}")
    st = store.as_dict()
    per_spill = statistics.median(spill_ms)
    print(f"durable (b) prefix store (capacity {DURABLE_STORE_BYTES} B): "
          f"wave 1 spilled {after1['spills']}, wave 2 ({DURABLE_WAVE2[0]} "
          f"requests, another head) {st['spills'] - after1['spills']}; "
          f"{st['entries']} entries ({w1_entries} of wave 1), {st['nbytes']} "
          f"B, {st['spills']} spills, {st['evictions']} evictions; host ms "
          f"per spill {per_spill!r} (median of {len(spill_ms)}), save() "
          f"{save_ms!r} ms ({saved_bytes} B on disk), load() {load_ms!r} ms, "
          f"adopt_prefixes() {adopt_ms!r} ms for {adopted} slots "
          f"({adopt_ms / max(adopted, 1)!r} ms each) ({CARD[0]}); adopted "
          f"rows equal the spilled ones bit for bit; C's hits "
          f"{c.stats.prefix_hits} = reachable {reach}, tokens saved "
          f"{c.stats.prefill_tokens_saved}, tokens equal the first engine's")
    rows = set()
    for e in (eng, c):
        rows |= {x * y for x, y in e.stats.prefill_shapes}
        rows |= set(e.stats.decode_shapes)
    return dict(store=st, wave1_spills=after1["spills"],
                spill_ms=spill_ms, save_ms=save_ms, saved_bytes=saved_bytes,
                load_ms=load_ms, adopt_ms=adopt_ms, adopted=adopted,
                hits=c.stats.prefix_hits,
                tokens_saved=c.stats.prefill_tokens_saved,
                launches=per * (forwards + fc)), rows


def durable_train(torch, kernel, dev, tmp):
    """Part (c): qwen3-0.6b cut to 2 layers at full width, batch 8 x seq
    256, AdamW, ``remat="block"``, through ``TrainDriver`` with
    checkpoints every 2 steps and a fault before step 3, against an
    uninterrupted TrainDriver run from the same seed. Launches derived
    from the modules and pinned; right after the restore the model trains
    the state's own tensors, which hold the checkpoint's values."""
    from repro_torch.configs.base import SWMConfig, TrainConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.ft import checkpoint as ck
    from repro_torch.ft.driver import FaultInjector, TrainDriver
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, module_tree, tree_leaves
    from repro_torch.train.loop import init_train_state, make_train_step

    cfg = cut_depth(dataclasses.replace(
        CONFIG, swm=SWMConfig(block_size=128, impl="pallas")),
        DURABLE_TRAIN_LAYERS)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                       seed=0)

    def batch(i):
        return {"tokens": torch.from_numpy(data.batch_np(i)["tokens"]).to(
            dev)}

    def driver(ckpt_dir, every, faults=None):
        tcfg = TrainConfig(checkpoint_every=every, checkpoint_dir=ckpt_dir)
        model = build_model(cfg, device=dev)
        state = init_train_state(init_params(model.specs(), seed=0,
                                             device=dev), tcfg,
                                 cfg.optimizer)
        return model, state, TrainDriver(make_train_step(model, cfg, tcfg),
                                         tcfg, batch, fault_injector=faults)

    model, state, drv = driver(str(Path(tmp) / "resumed"),
                               DURABLE_CKPT_EVERY,
                               FaultInjector(fail_at=(DURABLE_FAIL_AT,)))
    # derived from the modules: forward, recompute (remat) and dx per
    # executed step for bc_matmul, the weight adjoint for bc_dw; the fault
    # rolls back to the last checkpoint, whose steps run twice
    per = hybrid_launches(model)
    passes = 3 if cfg.remat != "none" else 2
    resume_at = DURABLE_FAIL_AT // DURABLE_CKPT_EVERY * DURABLE_CKPT_EVERY
    runs = DURABLE_FAIL_AT + DURABLE_TRAIN_STEPS - resume_at
    want = {"bc_matmul": runs * passes * per, "bc_dw": runs * per}
    copies, writes, restores = [], [], []
    host_copy, save = ck._host_copy, ck.save_checkpoint

    def timed_copy(tree):
        # the outermost call only (_host_copy recurses through its name)
        ck._host_copy = host_copy
        try:
            t = time.perf_counter()
            out = host_copy(tree)
        finally:
            ck._host_copy = timed_copy
        copies.append(((time.perf_counter() - t) * 1e3, out))
        return out

    def timed_save(*a):
        t = time.perf_counter()
        out = save(*a)
        writes.append((time.perf_counter() - t) * 1e3)
        return out

    inner = drv._restore

    def checked_restore(st):
        torch.cuda.synchronize()
        t = time.perf_counter()
        st, step = inner(st)
        torch.cuda.synchronize()
        restores.append((time.perf_counter() - t) * 1e3)
        saved = copies[-1][1]
        mine = dict(ck._flatten(module_tree(model)))
        for (path, leaf), (_, host) in zip(ck._flatten(st["params"]),
                                           ck._flatten(saved["params"])):
            if mine[path].data_ptr() != leaf.data_ptr() \
                    or not torch.equal(leaf.cpu(), host):
                fail(f"durable (c): after the restore {path} is not the "
                     f"model's tensor or not the checkpoint's value")
        if step != resume_at or st["step"] != resume_at:
            fail(f"durable (c): restored step {step}, state step "
                 f"{st['step']}, not {resume_at}")
        return st, step

    drv._restore = checked_restore
    ck._host_copy, ck.save_checkpoint = timed_copy, timed_save
    torch.cuda.synchronize()
    kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
    try:
        t = time.perf_counter()
        final = drv.run(state, n_steps=DURABLE_TRAIN_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    finally:
        ck._host_copy, ck.save_checkpoint = host_copy, save
    launches = dict(kernel.LAUNCHES)
    steps = [m["step"] for m in drv.metrics_log]
    if drv.restarts != 1 or launches != want or steps != [
            0, 1, 2, 2, 3, 4, 5] or ck.available_steps(
                str(Path(tmp) / "resumed")) != [2, 4, 6]:
        fail(f"durable (c): restarts {drv.restarts}, launches {launches} "
             f"!= {want}, steps {steps}")
    ckpt_bytes = dir_bytes(Path(tmp) / "resumed" / "step_00000002")

    _, clean_state, clean = driver(str(Path(tmp) / "clean"),
                                   DURABLE_TRAIN_STEPS + 1)
    clean_final = clean.run(clean_state, n_steps=DURABLE_TRAIN_STEPS)
    torch.cuda.synchronize()
    losses = [m["loss"] for m in drv.metrics_log][runs - (
        DURABLE_TRAIN_STEPS - resume_at):]
    clean_losses = [m["loss"] for m in clean.metrics_log][resume_at:]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(losses,
                                                        clean_losses))
    leaves = [(a, b) for part in ("params", "opt")
              for a, b in zip(tree_leaves(final[part]),
                              tree_leaves(clean_final[part]))]
    identical = loss_rel == 0 and all(torch.equal(a, b) for a, b in leaves)
    with torch.no_grad():
        rel = max(float((a.float() - b.float()).abs().max())
                  / max(float(b.float().abs().max()), 1e-30)
                  for a, b in leaves)
    if not (rel <= RESUME_TOL and loss_rel <= RESUME_TOL):
        fail(f"durable (c): resumed vs uninterrupted rel {rel!r}, losses "
             f"rel {loss_rel!r} > {RESUME_TOL}")
    copy_ms = [c[0] for c in copies]
    print(f"durable (c) TrainDriver (qwen3-0.6b, {cfg.n_layers} layers at "
          f"full width, AdamW, remat={cfg.remat!r}, batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}, checkpoints every {DURABLE_CKPT_EVERY}, fault "
          f"before step {DURABLE_FAIL_AT}): restarts {drv.restarts}, steps "
          f"run {steps}, launches {launches} = {runs} x ({passes} x {per}, "
          f"{per}); {ckpt_bytes} B per checkpoint; blocking host copy "
          f"{copy_ms!r} ms, background write {writes!r} ms, restore "
          f"{restores!r} ms, driver wall {wall:.2f} s ({CARD[0]}); resumed "
          f"vs uninterrupted: "
          + ("bit-identical (losses and every param and moment)"
             if identical else f"params/moments rel {rel!r}, losses rel "
             f"{loss_rel!r} (limit {RESUME_TOL})")
          + f"; after the restore the model trains the state's tensors")
    return dict(launches=launches, restarts=drv.restarts, steps=steps,
                checkpoint_bytes=ckpt_bytes, host_copy_ms=copy_ms,
                write_ms=writes, restore_ms=restores, identical=identical,
                rel=rel, loss_rel=loss_rel, losses=losses)


def phase_durable(torch, kernel, dev):
    """The durable tier on the card: (a) snapshot/restore mid-stream, (b)
    the prefix store's spill, persistence and adoption, and the NaN
    guard's scrub spilling nothing, (c) TrainDriver through an injected
    fault. Everything on disk lives under one temporary directory, removed
    at the end. Returns (report row, bc_matmul row counts launched)."""
    import shutil
    import tempfile

    from repro_torch.configs.base import SWMConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.prefix_store import PrefixStore

    t_phase = time.perf_counter()
    cfg = dataclasses.replace(CONFIG, swm=SWMConfig(block_size=128,
                                                    impl="pallas"))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_durable_")
    try:
        model = build_model(cfg, device=dev)
        params = init_params(model.specs(), seed=0, device=dev)
        snap, rows = durable_snapshot(torch, kernel, cfg, dev, model, params,
                                      str(Path(tmp) / "snapshot"))
        store, store_rows = durable_store(torch, kernel, cfg, dev, model,
                                          params, str(Path(tmp) / "store"))
        del model, params
        nan_rows, nan = nan_guard_check(torch, kernel, cfg, dev,
                                        store=PrefixStore(64 << 20))
        train = durable_train(torch, kernel, dev, str(Path(tmp) / "train"))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(f"durable phase: {time.perf_counter() - t_phase:.1f}s")
    return dict(snapshot=snap, store=store, nan_guard=nan, train=train,
                launches={"bc_matmul": snap["launches"] + store["launches"]
                          + nan["launches"]
                          + train["launches"]["bc_matmul"],
                          "bc_dw": train["launches"]["bc_dw"]}), \
        rows | store_rows | nan_rows


# ---------------------------------------------------------------------------
# The serving tier's last part: prewarm, the wave baseline, the supervisor's
# heal and the asyncio front-end
# ---------------------------------------------------------------------------

# (b) the f32 gate runs on a 2-layer cut (full width)
TIER_CUT_LAYERS = 2
# (c) 12 greedy requests of 16 tokens, 4 per tenant; two of each tenant's
# share that tenant's seeded 32-token head. Snapshots every 4 steps; the
# fatal at decode launch 20 of 45-50 lands mid-stream, after the fourth
# snapshot, with a second admission round in flight
TIER_TENANTS = ("interactive", "standard", "batch")
TIER_HEAD = 32
TIER_SNAPSHOT_EVERY = 4
TIER_FATAL_AT = 20
TIER_STORE_BYTES = 256 << 20
# dead engine released: device memory after the heal within 5% of before
TIER_MEM_SLACK = 0.05
TIER_SEED = RESILIENT_SEED + 5


def tier_prewarm(torch, kernel, cfg, dev, params, reqs, want):
    """(a): ``prewarm()`` on a full-width engine launches the whole bucket
    grid, 140 launches per shape; the first request's TTFT (host clock) on
    it and on a fresh engine; then the serve phase's 8 requests give the
    serve phase's tokens with the shape counters unchanged."""
    from repro_torch.launch.specs import build_model
    from repro_torch.serve.engine import Request, ServeEngine

    per = 5 * cfg.n_layers
    eng = ServeEngine(build_model(cfg, device=dev), cfg, params, batch=4,
                      cache_len=128)
    torch.cuda.synchronize()
    kernel.LAUNCHES["bc_matmul"] = 0
    t = time.perf_counter()
    n = eng.prewarm()
    torch.cuda.synchronize()
    warm_ms = (time.perf_counter() - t) * 1e3
    launches = kernel.LAUNCHES["bc_matmul"]
    shapes = eng.max_prefill_variants + eng.max_decode_variants
    if n != shapes or launches != per * shapes:
        fail(f"serve_tier (a): prewarm returned {n} and launched "
             f"{launches}; want {shapes} and {per} x {shapes}")
    counters = (eng.prefill_compiles, eng.decode_compiles)

    def ttft_ms(engine):
        one = Request(reqs[0].prompt, max_new=1)
        torch.cuda.synchronize()
        t = time.perf_counter()
        engine.generate([one])
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3

    fresh = ServeEngine(build_model(cfg, device=dev), cfg, params, batch=4,
                        cache_len=128)
    ttft_fresh = ttft_ms(fresh)
    del fresh
    ttft_warm = ttft_ms(eng)
    torch.cuda.synchronize()
    s = eng.stats
    f0 = s.prefill_calls + s.decode_steps
    kernel.LAUNCHES["bc_matmul"] = 0
    t = time.perf_counter()
    rids = [eng.submit(r) for r in reqs]
    outs = eng.drain(rids)
    torch.cuda.synchronize()
    serve_ms = (time.perf_counter() - t) * 1e3
    forwards = s.prefill_calls + s.decode_steps - f0
    served = kernel.LAUNCHES["bc_matmul"]
    got = [outs[r] for r in rids]
    if served != per * forwards:
        fail(f"serve_tier (a): {served} launches != {per} x {forwards}")
    if got != want:
        fail("serve_tier (a): the prewarmed engine's tokens differ from "
             "the serve phase's")
    if (eng.prefill_compiles, eng.decode_compiles) != counters:
        fail(f"serve_tier (a): shape counters grew while serving: "
             f"{counters} -> {(eng.prefill_compiles, eng.decode_compiles)}")
    rows = ({b * t for b in eng.batch_buckets for t in eng.prompt_buckets}
            | set(eng.decode_buckets))
    print(f"serve_tier (a) prewarm [{CARD[0]}]: {n} shapes "
          f"({eng.max_prefill_variants} prefill + "
          f"{eng.max_decode_variants} decode), bc_matmul launches "
          f"{launches} = {per} x {shapes}, {warm_ms!r} ms wall; first "
          f"request's TTFT {ttft_warm!r} ms prewarmed, {ttft_fresh!r} ms "
          f"on a fresh engine; then the serve phase's 8 requests: tokens "
          f"bit-identical, {served} launches = {per} x {forwards}, "
          f"counters stay {counters}, {serve_ms!r} ms wall")
    return eng, dict(shapes=n, launches=launches + served,
                     prewarm_ms=warm_ms, ttft_prewarmed_ms=ttft_warm,
                     ttft_fresh_ms=ttft_fresh, serve_ms=serve_ms,
                     counters=list(counters)), rows


def wave_logits(wave):
    """Record a WaveEngine's logits (f32, host) per step call: call c of
    wave w holds row j = request 4w + j's token c."""
    calls = []
    for attr in ("_prefill", "_decode"):
        inner = getattr(wave, attr)

        def rec(*a, inner=inner):
            out = inner(*a)
            calls.append(out[0].float().cpu().numpy())
            return out
        setattr(wave, attr, rec)
    return calls


def pushed_logits(engine):
    """Record a ServeEngine's logits row of every token it samples, by
    request id (``_push_token``)."""
    log = {}
    inner = engine._push_token

    def push(slot, row):
        log.setdefault(engine._slot_req[slot], []).append(row.copy())
        return inner(slot, row)
    engine._push_token = push
    return log


def first_mismatch(reqs, wave_out, cont_out, calls, log, B):
    """(request, token index, wave top-2 margin, continuous top-2 margin,
    max |logit difference|) at the first differing token, or None. Also
    returns the largest logit difference and the smallest top-2 margin
    over every token both engines produced."""
    import numpy as np

    def margin(row):
        top = np.partition(row, -2)[-2:]
        return float(top[1] - top[0])

    worst, tightest, first = 0.0, float("inf"), None
    for i, r in enumerate(reqs):
        w, j = divmod(i, B)
        calls_w = calls[w * r.max_new: (w + 1) * r.max_new]
        for t in range(min(len(wave_out[i]), len(cont_out[i]))):
            a, b = calls_w[t][j], log[i][t]
            diff = float(np.abs(a - b).max())
            worst = max(worst, diff)
            tightest = min(tightest, margin(a), margin(b))
            if first is None and wave_out[i][t] != cont_out[i][t]:
                first = (i, t, margin(a), margin(b), diff)
    return first, worst, tightest


def device_busy_ms(torch, prof):
    """Sum of the device events' durations in a finished profile, read
    from the raw kineto events: ``key_averages()`` would build a Python
    event per kernel first (~80 µs each, seconds for a serve run)."""
    cuda = torch.autograd.DeviceType.CUDA
    return sum(e.duration_ns() for e in prof.profiler.kineto_results.events()
               if e.device_type() == cuda) / 1e6


def tier_wave(torch, kernel, cfg, dev, params, reqs, want, cont,
              cont_ms):
    """(b): ``WaveEngine(batch=4, cache_len=128)`` against the continuous
    engine on the same 8 greedy requests: f32 on a 2-layer cut, gated
    (equal tokens; at a mismatch the step and both top-2 margins beside
    the logit difference); full width in bf16, tokens compared but not
    gated; both engines' wall and profiler busy ms per token (the
    continuous engine's wall, ``cont_ms``, from (a)'s run of the same
    requests on the same engine)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import ServeEngine, WaveEngine

    per = 5 * cfg.n_layers
    t0 = time.perf_counter()
    # f32 gate at 2 layers
    cut = dataclasses.replace(cut_depth(cfg, TIER_CUT_LAYERS),
                              param_dtype="float32",
                              compute_dtype="float32")
    cut_model = build_model(cut, device=dev)
    cut_params = init_params(cut_model.specs(), seed=0, device=dev)
    w32 = WaveEngine(cut_model, cut, cut_params, batch=4, cache_len=128)
    calls = wave_logits(w32)
    wave32 = w32.generate(reqs)
    c32 = ServeEngine(build_model(cut, device=dev), cut, cut_params,
                      batch=4, cache_len=128)
    log = pushed_logits(c32)
    cont32 = c32.generate(reqs)
    first, worst, tightest = first_mismatch(reqs, wave32, cont32, calls,
                                            log, 4)
    rows = {b * t for b, t in w32.stats.prefill_shapes | c32.stats
            .prefill_shapes} | set(c32.stats.decode_shapes) | {4}
    del w32, c32, cut_model, cut_params, calls, log
    n32 = sum(len(o) for o in cont32)
    same32 = sum(a == b for x, y in zip(wave32, cont32)
                 for a, b in zip(x, y))
    print(f"serve_tier (b) wave vs continuous, f32, {TIER_CUT_LAYERS} of "
          f"{cfg.n_layers} layers at full width: {same32} of {n32} tokens "
          f"equal; largest |logit difference| {worst!r}, smallest top-2 "
          f"margin {tightest!r}")
    if first is not None:
        i, t, mw, mc, d = first
        print(f"  first mismatch: request {i} token {t}: top-2 margin wave "
              f"{mw!r}, continuous {mc!r}; |logit difference| {d!r}")
        if min(mw, mc) > d:
            fail(f"serve_tier (b): f32 tokens differ at request {i} token "
                 f"{t} with top-2 margins {mw!r}/{mc!r} above the logit "
                 f"difference {d!r}: a fault, not rounding")
        fail("serve_tier (b): f32 wave and continuous tokens differ")

    t1 = time.perf_counter()
    # full width, bf16: wall (unprofiled) and busy (profiled) per token
    model = build_model(cfg, device=dev)
    wave = WaveEngine(model, cfg, params, batch=4, cache_len=128)
    torch.cuda.synchronize()
    kernel.LAUNCHES["bc_matmul"] = 0
    t = time.perf_counter()
    wave_out = wave.generate(reqs)
    torch.cuda.synchronize()
    wave_ms = (time.perf_counter() - t) * 1e3
    forwards = wave.stats.prefill_calls + wave.stats.decode_steps
    launches = kernel.LAUNCHES["bc_matmul"]
    if launches != per * forwards:
        fail(f"serve_tier (b): wave launches {launches} != {per} x "
             f"{forwards}")
    rows |= {b * t for b, t in wave.stats.prefill_shapes}
    wave_rpt = wave.stats.decode_rows_per_token
    n_tok = sum(len(o) for o in wave_out)
    same = sum(a == b for x, y in zip(wave_out, want) for a, b in zip(x, y))

    def busy(run):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        return device_busy_ms(torch, prof)

    # busy time over the first wave (4 requests, 64 tokens): the profiler's
    # parse of both waves' ~90k kernel events costs seconds
    first = reqs[:4]
    n_first = sum(r.max_new for r in first)
    t2 = time.perf_counter()
    wave_busy = busy(lambda: wave.generate(first))
    del wave, model
    cs = cont.stats
    rows0 = (cs.decode_rows, cs.tokens_generated)
    t3 = time.perf_counter()
    cont_busy = busy(lambda: cont.generate(first))
    cont_rpt = ((cs.decode_rows - rows0[0])
                / (cs.tokens_generated - rows0[1]))
    t4 = time.perf_counter()
    print(f"serve_tier (b) full width, bf16 [{CARD[0]}]: wave tokens equal "
          f"to continuous in {same} of {n_tok} (not gated: the wave's "
          f"(4, {max(r.prompt_len for r in reqs)}) prefills launch other "
          f"GEMM shapes); wave {forwards} forwards, {launches} launches = "
          f"{per} x {forwards}; per generated token: wave {wave_ms / n_tok!r} "
          f"ms wall, {wave_busy / n_first!r} ms busy, continuous "
          f"{cont_ms / n_tok!r} ms wall, {cont_busy / n_first!r} ms busy "
          f"(busy over requests 1-4); "
          f"decode_rows_per_token wave {wave_rpt!r}, continuous "
          f"{cont_rpt!r} (requests 1-4); seconds: f32 gate {t1 - t0:.1f}, "
          f"wave run {t2 - t1:.1f}, wave profile {t3 - t2:.1f}, "
          f"continuous profile {t4 - t3:.1f}")
    return dict(f32_tokens_equal=same32, f32_tokens=n32,
                f32_max_logit_diff=worst, f32_min_margin=tightest,
                bf16_tokens_equal=same, tokens=n_tok,
                wave_ms_per_token=wave_ms / n_tok,
                wave_busy_ms_per_token=wave_busy / n_first,
                cont_ms_per_token=cont_ms / n_tok,
                cont_busy_ms_per_token=cont_busy / n_first,
                wave_decode_rows_per_token=wave_rpt,
                cont_decode_rows_per_token=cont_rpt,
                launches=launches), rows


def tier_requests(cfg):
    """(c)'s and (d)'s traffic: 12 greedy requests of 16 tokens, 4 per
    tenant; two of each tenant's on its own seeded 32-token head, the
    others bare; tails of 3-8 tokens."""
    from repro_torch.serve.engine import Request
    import numpy as np

    rng = np.random.default_rng(TIER_SEED)
    reqs = []
    for tenant in TIER_TENANTS:
        head = rng.integers(0, cfg.vocab, size=TIER_HEAD).astype(np.int32)
        for i in range(4):
            tail = rng.integers(0, cfg.vocab, size=int(rng.integers(3, 9))
                                ).astype(np.int32)
            reqs.append(Request(np.concatenate([head, tail]) if i < 2
                                else tail, max_new=16, tenant=tenant))
    return reqs


def tier_supervised(torch, kernel, cfg, dev, params, reqs, snap_dir,
                    fatal):
    """One supervised run of ``reqs`` (all submitted, then stepped to idle
    on a ManualClock) behind the (c) factory. Returns (streams, supervisor,
    per-engine (launches, forwards), heal timings, device memory before
    the fatal step and after the heal)."""
    import gc

    from repro_torch.launch.specs import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.frontend import AsyncFrontend, TenantConfig
    from repro_torch.serve.guard import ManualClock, ServeFaultInjector
    from repro_torch.serve.prefix_store import PrefixStore
    from repro_torch.serve.supervisor import Supervisor

    gc.collect()              # an earlier run's engines (reference cycles)
    weights = AsyncFrontend(None, {t: TenantConfig(t, slo=t)
                                   for t in TIER_TENANTS}).tenant_weights()
    clk = ManualClock()
    inj = ServeFaultInjector(fatal_decode_at={fatal} if fatal else ())
    store = PrefixStore(TIER_STORE_BYTES)
    model = build_model(cfg, device=dev)
    engines, timings = [], {}

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            timings[name] = timings.get(name, 0.0) + (
                time.perf_counter() - t) * 1e3
            return out
        return run

    def factory():
        heal = bool(engines)
        torch.cuda.synchronize()
        t = time.perf_counter()
        eng = ServeEngine(model, cfg, params, batch=4, cache_len=128,
                          policy="fair", tenant_weights=weights,
                          prefix_cache=True, prefix_store=store,
                          snapshot_dir=snap_dir,
                          snapshot_every=TIER_SNAPSHOT_EVERY, clock=clk,
                          fault_injector=inj)
        torch.cuda.synchronize()
        if heal:
            timings["factory"] = (time.perf_counter() - t) * 1e3
            eng.restore = timed("restore", eng.restore)
            eng.adopt_prefixes = timed("adopt_prefixes", eng.adopt_prefixes)
        # a runner call counter per engine (the injector's fatal raises
        # before its launch, which never runs)
        count = [kernel.LAUNCHES["bc_matmul"], 0]
        engines.append(count)
        for attr in ("prefill", "decode"):
            inner = getattr(eng.runner, attr)

            def counted(*a, inner=inner, count=count, **kw):
                count[1] += 1
                return inner(*a, **kw)
            setattr(eng.runner, attr, counted)
        return eng

    kernel.LAUNCHES["bc_matmul"] = 0
    sup = Supervisor(factory)
    sup._heal = timed("heal", sup._heal)
    sup._requeue_missing = timed("requeue", sup._requeue_missing)
    srids = [sup.submit(r) for r in reqs]
    streams = {r: [] for r in srids}
    mem = [None, None]
    steps = 0
    while True:
        before = torch.cuda.memory_allocated()
        restarts = sup.restarts
        alive = sup.step()
        steps += 1
        clk.advance(0.002)
        if sup.restarts != restarts:
            torch.cuda.synchronize()
            gc.collect()
            mem = [before, torch.cuda.memory_allocated()]
        for r in srids:
            new, _ = sup.take_new_tokens(r)
            streams[r].extend(new)
        if not alive:
            break
        if steps > 400:
            fail("serve_tier (c): the supervised engine did not go idle")
    torch.cuda.synchronize()
    # launches per engine: from its construction to the next one's
    ends = [c[0] for c in engines[1:]] + [kernel.LAUNCHES["bc_matmul"]]
    per_engine = [(end - c[0], c[1]) for c, end in zip(engines, ends)]
    return ([streams[r] for r in srids], sup, per_engine, timings, mem,
            store, steps)


def tier_heal(torch, kernel, cfg, dev, params, tmp):
    """(c): full-width qwen3-0.6b behind a Supervisor (fair policy with the
    three SLO classes' weights, prefix cache with a 256 MiB PrefixStore,
    snapshots every 4 steps, a ManualClock), 12 requests; a fault-free run,
    then one with an engine fatal at decode launch TIER_FATAL_AT. Gates:
    one restart and one recovery, every at-most-once stream equal to the
    fault-free run's, 140 launches per forward on both engines, the dead
    engine's device memory released."""
    per = 5 * cfg.n_layers
    reqs = tier_requests(cfg)
    base, _, base_engines, _, _, _, _ = tier_supervised(
        torch, kernel, cfg, dev, params, reqs, str(Path(tmp) / "base"),
        None)
    streams, sup, engines, timings, mem, store, steps = tier_supervised(
        torch, kernel, cfg, dev, params, reqs, str(Path(tmp) / "heal"),
        TIER_FATAL_AT)
    s = sup.stats
    if (sup.restarts, s.recoveries) != (1, 1) or len(engines) != 2:
        fail(f"serve_tier (c): restarts {sup.restarts}, recoveries "
             f"{s.recoveries}, engines {len(engines)}; want 1, 1, 2")
    if streams != base:
        fail("serve_tier (c): the healed streams differ from the fault-free "
             "run's (a token lost, repeated or changed)")
    if [len(x) for x in streams] != [16] * len(reqs):
        fail(f"serve_tier (c): stream lengths {[len(x) for x in streams]}")
    for i, (launches, forwards) in enumerate(engines + base_engines):
        if launches != per * forwards:
            fail(f"serve_tier (c): engine {i}: {launches} launches != "
                 f"{per} x {forwards}")
    if not mem[1] <= mem[0] * (1 + TIER_MEM_SLACK):
        fail(f"serve_tier (c): device memory {mem[1]} B after the heal, "
             f"{mem[0]} B before the fatal step: the dead engine was not "
             f"released")
    launches = sum(x[0] for x in engines + base_engines)
    print(f"serve_tier (c) supervisor [{CARD[0]}]: fatal at decode launch "
          f"{TIER_FATAL_AT}: restarts {sup.restarts}, recoveries "
          f"{s.recoveries}; 12 streams bit-identical to the fault-free run "
          f"({steps} supervised steps); launches per engine "
          f"{[f'{a} = {per} x {b}' for a, b in engines]} (fault-free "
          f"{[f'{a} = {per} x {b}' for a, b in base_engines]}); device "
          f"memory {mem[0]} B before the fatal step, {mem[1]} B after the "
          f"heal and gc ({mem[1] / mem[0]!r}x); heal {timings['heal']!r} ms "
          f"wall = factory {timings['factory']!r} + restore "
          f"{timings['restore']!r} + adopt_prefixes "
          f"{timings['adopt_prefixes']!r} + re-queue "
          f"{timings['requeue']!r}; prefix store {len(store)} entries, "
          f"{store.spills} spills; adoptions {s.prefix_adoptions}, hits "
          f"{s.prefix_hits} of {s.prefix_lookups}")
    return dict(restarts=sup.restarts, recoveries=s.recoveries,
                heal_ms=timings, memory_before=mem[0], memory_after=mem[1],
                launches=launches, store_entries=len(store),
                spills=store.spills, adoptions=s.prefix_adoptions,
                prefix_hits=s.prefix_hits, steps=steps)


def tier_frontend(torch, kernel, cfg, dev, params):
    """(d): AsyncFrontend over a fresh supervisor (no fault, no snapshots),
    the real event loop and time.monotonic; the three tenants burst-submit
    (c)'s 12 requests, ``interactive`` throttled to rate 4, burst 2. Gates:
    every request terminal, the statuses add up to 12, every stream()
    yields exactly its final poll tokens; 140 launches per forward."""
    import asyncio

    from repro_torch.launch.specs import build_model
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.frontend import AsyncFrontend, TenantConfig
    from repro_torch.serve.guard import TERMINAL_STATES
    from repro_torch.serve.supervisor import Supervisor

    per = 5 * cfg.n_layers
    reqs = tier_requests(cfg)
    tenants = {t: TenantConfig(t, slo=t, **(dict(rate=4, burst=2)
                                            if t == "interactive" else {}))
               for t in TIER_TENANTS}
    weights = AsyncFrontend(None, tenants).tenant_weights()
    model = build_model(cfg, device=dev)
    sup = Supervisor(lambda: ServeEngine(
        model, cfg, params, batch=4, cache_len=128, policy="fair",
        tenant_weights=weights), require_snapshots=False)
    fe = AsyncFrontend(sup, tenants)
    s = sup.stats

    async def main():
        async def feed(tenant):
            out = []
            for i, r in enumerate(reqs):
                if r.tenant == tenant:
                    out.append((i, await fe.submit(tenant, r)))
            return out

        async def consume(rid):
            return [tok async for tok in fe.stream(rid)]

        runner = asyncio.ensure_future(fe.run(idle_rounds=2))
        fed = await asyncio.gather(*(feed(t) for t in TIER_TENANTS))
        pairs = sorted(p for f in fed for p in f)
        consumers = [asyncio.ensure_future(consume(r)) for _, r in pairs]
        await runner
        await fe.run(idle_rounds=2)     # submits that landed after idling
        return pairs, await asyncio.gather(*consumers)

    torch.cuda.synchronize()
    f0 = s.prefill_calls + s.decode_steps
    kernel.LAUNCHES["bc_matmul"] = 0
    t = time.perf_counter()
    pairs, streams = asyncio.run(main())
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    forwards = s.prefill_calls + s.decode_steps - f0
    launches = kernel.LAUNCHES["bc_matmul"]
    states = [sup.poll(rid) for _, rid in pairs]
    if len(pairs) != len(reqs) or any(st.status not in TERMINAL_STATES
                                      for st in states):
        fail(f"serve_tier (d): {len(pairs)} submitted, statuses "
             f"{[st.status for st in states]}")
    if any(got != list(st.tokens) for got, st in zip(streams, states)):
        fail("serve_tier (d): a stream() differs from its final poll tokens")
    if launches != per * forwards:
        fail(f"serve_tier (d): {launches} launches != {per} x {forwards}")
    report = {}
    for tenant in TIER_TENANTS:
        ts = s.tenants[tenant]
        mine = [st.status for (i, _), st in zip(pairs, states)
                if reqs[i].tenant == tenant]
        report[tenant] = dict(
            admitted=ts.admitted, rejected=fe.rejections[tenant],
            statuses={k: mine.count(k) for k in sorted(set(mine))},
            ttft_p50_ms=ts.ttft_ms.p50, ttft_p99_ms=ts.ttft_ms.p99)
    if sum(sum(r["statuses"].values()) for r in report.values()) != 12:
        fail(f"serve_tier (d): statuses {report} do not add up to 12")
    print(f"serve_tier (d) front-end [{CARD[0]}]: 12 requests terminal in "
          f"{wall_ms!r} ms wall, {forwards} forwards, {launches} launches = "
          f"{per} x {forwards}; every stream equal to its final tokens; "
          + "; ".join(f"{t}: admitted {r['admitted']}, rejected "
                      f"{r['rejected']}, {r['statuses']}, TTFT p50/p99 "
                      f"{r['ttft_p50_ms']}/{r['ttft_p99_ms']} ms (histogram "
                      f"bounds)" for t, r in report.items()))
    return dict(wall_ms=wall_ms, forwards=forwards, launches=launches,
                tenants=report)


def phase_serve_tier(torch, kernel, dev, cfg, params, reqs, want):
    """The serving tier's last part on the card: (a) prewarm, (b) the wave
    baseline, (c) the supervisor's heal, (d) the asyncio front-end, all on
    the serve phase's full-width qwen3-0.6b params. Returns (report row,
    bc_matmul row counts launched)."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    parts = []
    tmp = tempfile.mkdtemp(prefix="chip_smoke_tier_")
    try:
        cont, prewarm, rows = tier_prewarm(torch, kernel, cfg, dev, params,
                                           reqs, want)
        parts.append(time.perf_counter())
        wave, wave_rows = tier_wave(torch, kernel, cfg, dev, params, reqs,
                                    want, cont, prewarm["serve_ms"])
        del cont
        parts.append(time.perf_counter())
        heal = tier_heal(torch, kernel, cfg, dev, params, tmp)
        parts.append(time.perf_counter())
        front = tier_frontend(torch, kernel, cfg, dev, params)
        parts.append(time.perf_counter())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    part_s = [b - a for a, b in zip([t_phase] + parts, parts)]
    print(f"serve_tier phase: {secs:.1f}s ((a)-(d): "
          f"{', '.join(f'{x:.1f}' for x in part_s)} s)")
    # (a)'s bucket grid covers every prefill (c) and (d) launch
    return dict(prewarm=prewarm, wave=wave, heal=heal, frontend=front,
                seconds=secs, part_seconds=part_s,
                launches=(prewarm["launches"] + wave["launches"]
                          + heal["launches"] + front["launches"])), \
        rows | wave_rows


# ---------------------------------------------------------------------------
# The paper's own models (the fifth slice's path)
# ---------------------------------------------------------------------------

# bc_matmul's launches at the paper models' widths, (name, B, p, q, k):
# SWMMLP((784, 512, 512, 10), 64, 12) at B = 64 (fc0's k is
# valid_block_size(64, 784, 512) = 16); the ASIC net's 512-wide layers at
# B = 256; SWMCNN's conv1 im2col table (p = 8, r²·q = 25·4 = 100, k = 8) at
# B·8·8 rows (B = 8 forward, 128 in the train step) and its dx on the
# transposed grid; the SWMLSTM cells' fused gates and Wym at B = 4 with
# SWMLSTMASR's geometry (153 features padded to 160, 1024 cells, 512
# projection) at k = 16 and 8; the MNIST example's SWMMLP((784, 256, 256,
# 10), 8, 12) at its batch of 128: fc0 (p = 32, q = 98) and fc1 (32 x 32,
# also the shape of fc1's dx on the transposed grid; fc0 takes no dx)
PAPER_SHAPES = [
    ("mlp.fc0", 64, 32, 49, 16), ("mlp.fc1", 64, 8, 8, 64),
    ("asic.fc0", 256, 8, 8, 64), ("asic.fc2", 256, 1, 8, 64),
    ("cnn.conv1", 512, 8, 100, 8), ("cnn.conv1.train", 8192, 8, 100, 8),
    ("cnn.conv1.dx", 8192, 100, 8, 8),
    ("lstm16.gates0", 4, 256, 42, 16), ("lstm16.gates1", 4, 256, 64, 16),
    ("lstm16.Wym", 4, 32, 64, 16), ("lstm8.gates0", 4, 512, 84, 8),
    ("lstm8.gates1", 4, 512, 128, 8), ("lstm8.Wym", 4, 64, 128, 8),
    ("mnist.fc0", 128, 32, 98, 8), ("mnist.fc1", 128, 32, 32, 8)]
# int8 tables are checked at the shapes of the models with quant_bits = 0
PAPER_INT8 = ("cnn.", "lstm")
# (name, B, P, Q, k) of bc_dw in the CNN train step (conv1's weight
# adjoint over 128 images x 8 x 8 positions) and in the MNIST example's
# train step (fc0's and fc1's over its batch of 128)
PAPER_DW = [("cnn.conv1.dw", 128 * 8 * 8, 8, 100, 8),
            ("mnist.fc0.dw", 128, 32, 98, 8), ("mnist.fc1.dw", 128, 32, 32, 8)]
PAPER_LSTM_T = 32
PAPER_REPS = 10                 # timed forwards (or train steps) per model
# card vs CPU for the f32 paper models: the per-launch limit FP32_TOL times
# the launches and plain ops an output passes through in sequence. MLP and
# ASIC use QUANT_TOL instead. CNN: conv0 (dense), conv1 (kernel), fc0 (FFT),
# fc1 (dense) = 4
CNN_TOL = 4 * FP32_TOL
# LSTM: 2 layers x 32 steps x 2 launches; each launch adds at most FP32_TOL
# to what the next step reads, and the cell carries it at most linearly
# (sigmoid' <= 1/4, tanh' <= 1, the forget gate < 1), so the errors add
LSTM_TOL = 2 * PAPER_LSTM_T * 2 * FP32_TOL
# quant_bits = 12 (SWMMLP, ASIC net): fixed_point rounds every activation
# to a 1/256 grid; a 1e-7 difference between card and CPU can move one
# value across a rounding boundary and change it by a whole quantum
# (0.0039), which the next layer spreads over its outputs. Held to 1% of
# the largest |logit|
QUANT_TOL = 1e-2


class _LSTMStack:
    """SWMLSTMASR's two cells at its geometry with ``impl="pallas"`` (the
    model itself takes the default impl, which has no kernel), as one
    module keyed like its tree (``lstm0``, ``lstm1``)."""

    def __init__(self, k):
        from torch import nn
        from repro_torch.configs.base import SWMConfig
        from repro_torch.core.lstm import SWMLSTM
        from repro_torch.models.paper_models import SWMLSTMASR

        asr = SWMLSTMASR(block_size=k)
        swm = SWMConfig(block_size=k, impl="pallas", targets=("lstm",))
        self.pad = asr.d_in_padded - asr.d_in
        self.module = nn.ModuleDict({
            f"lstm{i}": SWMLSTM(asr.d_in_padded if i == 0 else asr.d_proj,
                                asr.d_cell, asr.d_proj, swm=swm)
            for i in range(asr.n_layers)})

    def specs(self):
        return {n: c.specs() for n, c in self.module.items()}

    def __call__(self, xs):
        import torch
        h = torch.nn.functional.pad(xs, (0, self.pad))
        for cell in self.module.values():
            h, _ = cell(h)
        return h


def paper_models(torch, dev):
    """The paper phase's models: (name, card model, CPU model, input on
    the card, launches per forward, tolerance, unit, check int8)."""
    from repro_torch.data.pipeline import synthetic_images, synthetic_speech
    from repro_torch.models.paper_models import SWMCNN, SWMLSTMASR, SWMMLP

    img64 = torch.from_numpy(synthetic_images(64, 0)[0].reshape(64, -1))
    x_asic = torch.randn(256, 512,
                         generator=torch.Generator().manual_seed(12))
    img8 = torch.from_numpy(synthetic_images(8, 0)[0])
    speech = torch.from_numpy(synthetic_speech(4, PAPER_LSTM_T, 153, 0)[0])

    def mlp():
        return SWMMLP((784, 512, 512, 10), 64, 12, impl="pallas")

    def asic():
        return SWMMLP((512, 512, 512, 64, 10), 64, 12, impl="pallas")

    out = [("mlp", mlp, img64, 2, QUANT_TOL, "images", False),
           ("asic", asic, x_asic, 3, QUANT_TOL, "images", False),
           ("cnn", SWMCNN, img8, 1, CNN_TOL, "images", True)]
    for k in (16, 8):
        out.append((f"lstm{k}", lambda k=k: _LSTMStack(k),
                    speech, 2 * 2 * PAPER_LSTM_T, LSTM_TOL, "frames", True))
    out.append(("lstm_asr", SWMLSTMASR, speech, 0, LSTM_TOL, "frames",
                False))
    return [(name, make(), make(), x.to(dev), per, tol, unit, int8)
            for name, make, x, per, tol, unit, int8 in out]


def _load(model, tree):
    from repro_torch.nn.module import load_tree
    load_tree(getattr(model, "module", model), tree)


def phase_paper(torch, kernel, dev):
    """Each paper model on the card against the same params on the CPU,
    unfrozen, f32-frozen and (quant_bits = 0 models) int8-frozen, with
    exact bc_matmul launch counts per forward; then images/s or frames/s
    on the f32-frozen (serving) path, counted launches read. Returns (rows,
    launches of the counted runs)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.block_circulant.plan import freeze_params
    from repro_torch.nn.module import init_params

    rows, launched = [], 0
    print("paper models, card vs cpu (same seeded params; tolerance "
          "beside each; launches = bc_matmul per forward):")
    for i, (name, card, cpu, x, per, tol, unit, int8) in enumerate(
            paper_models(torch, dev)):
        specs = card.specs()
        params = init_params(specs, seed=100 + i, device=dev)
        modes = ("unfrozen", "off") + (("int8",) if int8 else ())
        errs = {}
        for mode in modes:
            tree = (params if mode == "unfrozen"
                    else freeze_params(specs, params, mode))
            _load(card, tree)
            _load(cpu, to_device(tree, "cpu"))
            with torch.no_grad():
                kernel.LAUNCHES["bc_matmul"] = 0
                y = card(x)
                torch.cuda.synchronize()
                n = kernel.LAUNCHES["bc_matmul"]
                ref = cpu(x.cpu())
            if n != per:
                fail(f"paper {name} {mode}: {n} bc_matmul launches per "
                     f"forward, expected {per}")
            y = y.float().cpu()
            if y.shape != ref.shape or not bool(torch.isfinite(y).all()):
                fail(f"paper {name} {mode}: output {tuple(y.shape)} vs "
                     f"{tuple(ref.shape)} or not finite")
            errs[mode] = rel_err(y, ref)
            if not errs[mode] <= tol:
                fail(f"paper {name} {mode}: card vs cpu rel err "
                     f"{errs[mode]:.3g} > {tol}")
        # throughput on the f32-frozen path
        _load(card, freeze_params(specs, params))
        with torch.no_grad():
            for _ in range(2):
                card(x)
            torch.cuda.synchronize()
            kernel.LAUNCHES["bc_matmul"] = 0
            t = time.perf_counter()
            for _ in range(PAPER_REPS):
                card(x)
            torch.cuda.synchronize()
            dt = (time.perf_counter() - t) / PAPER_REPS
            n = kernel.LAUNCHES["bc_matmul"]
        if n != per * PAPER_REPS:
            fail(f"paper {name}: {n} launches in {PAPER_REPS} forwards")
        launched += n
        with torch.no_grad(), profile(activities=[
                ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            card(x)
            torch.cuda.synchronize()
        report_profile(torch, prof, 1, dt * 1e3, f"paper {name} forward "
                       f"(f32-frozen, input {tuple(x.shape)})")
        items = x.shape[0] * (x.shape[1] if unit == "frames" else 1)
        rows.append(dict(model=name, batch=tuple(x.shape), ms=dt * 1e3,
                         per_s=items / dt, unit=unit, launches=per,
                         rel_err=errs, tol=tol))
        print(f"  {name:8s} input {tuple(x.shape)}: rel err "
              + ", ".join(f"{m} {e:.3g}" for m, e in errs.items())
              + f" (tolerance {tol:.3g}); {per} launches/forward; "
              f"{dt * 1e3:.3f} ms/forward = {items / dt:.1f} {unit}/s "
              f"(f32-frozen)")
    return rows, launched


def _cnn_loss(model, params, batch):
    from repro_torch.nn.module import load_tree
    import torch

    load_tree(model, params)
    lp = torch.log_softmax(model(batch["x"]), -1)
    return -lp.gather(1, batch["y"][:, None].long()).mean()


def phase_paper_train(torch, kernel, dev):
    """One SWMCNN train step at batch 128 (the examples' log-softmax
    cross-entropy, grads by ``torch.autograd.grad``, the port's AdamW) on
    the card against the CPU from the same params: loss, grad norm and the
    updated params; the step's (bc_matmul, bc_dw) launches must be (2, 1).
    Then PAPER_REPS counted steps on the card. Returns (row, launches)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.data.pipeline import synthetic_images
    from repro_torch.models.paper_models import SWMCNN
    from repro_torch.nn.module import init_params, tree_leaves, tree_map
    from repro_torch.optim.optimizers import adamw_update, global_norm
    from repro_torch.train.loop import init_train_state, value_and_grad

    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=10, total_steps=200,
                       weight_decay=0.0)
    B = PAPER_DW[0][1] // 64
    x, y = synthetic_images(B, 1)
    params = init_params(SWMCNN().specs(), seed=200, device=dev)
    copies = {"card": tree_map(lambda v: v.detach().clone(), params),
              "cpu": to_device(params, "cpu")}
    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        model = SWMCNN()
        state = init_train_state(copies[name], tcfg)
        batch = {"x": torch.from_numpy(x).to(d),
                 "y": torch.from_numpy(y).to(d)}
        kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
        loss, grads = value_and_grad(
            lambda p, b, m=model: _cnn_loss(m, p, b), state["params"], batch)
        adamw_update(state["params"], grads, state["opt"], 1, tcfg)
        if d == dev:
            torch.cuda.synchronize()
            launches = (kernel.LAUNCHES["bc_matmul"], kernel.LAUNCHES["bc_dw"])
            if launches != (2, 1):
                fail(f"SWMCNN train step launches {launches} != (2, 1) "
                     f"(conv1 forward and dx; conv1 dw)")
        out[name] = (float(loss), float(global_norm(grads)),
                     [p.detach().cpu() for p in tree_leaves(state["params"])])
        if not all(math.isfinite(v) for v in out[name][:2]):
            fail(f"SWMCNN train step on {name}: non-finite loss or norm")
    (lc, nc, pc), (lp, npu, pp) = out["card"], out["cpu"]
    el, en = abs(lc - lp) / abs(lp), abs(nc - npu) / abs(npu)
    ep = max(rel_err(a, b) for a, b in zip(pc, pp))
    # loss: the forward's CNN_TOL; the grad norm also passes the backward
    # (dx and dw adjoints, each a launch): twice that; params after one
    # AdamW step at lr 3e-4 move by ~lr per element, far less than either
    print(f"paper SWMCNN train step (batch {B}, card vs cpu): loss {lc!r} vs "
          f"{lp!r} (rel {el:.3g}, tolerance {CNN_TOL:.3g}), grad norm {nc!r} "
          f"vs {npu!r} (rel {en:.3g}, tolerance {2 * CNN_TOL:.3g}), updated "
          f"params rel {ep:.3g}; launches (bc_matmul, bc_dw) = (2, 1)")
    if not (el <= CNN_TOL and en <= 2 * CNN_TOL and ep <= 2 * CNN_TOL):
        fail("SWMCNN train step: card vs cpu beyond the tolerance")

    # counted steps on the card
    model = SWMCNN()
    state = init_train_state(params, tcfg)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in
                zip(("x", "y"), synthetic_images(B, i))}
               for i in range(2, 3 + PAPER_REPS)]

    def step(i, b):
        loss, grads = value_and_grad(
            lambda p, bb: _cnn_loss(model, p, bb), state["params"], b)
        adamw_update(state["params"], grads, state["opt"], i, tcfg)
        return loss

    step(2, batches[0])
    torch.cuda.synchronize()
    kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
    t = time.perf_counter()
    losses = [float(step(i, b)) for i, b in enumerate(batches[1:], 3)]
    dt = (time.perf_counter() - t) / PAPER_REPS
    launches = dict(kernel.LAUNCHES)
    if launches != {"bc_matmul": 2 * PAPER_REPS, "bc_dw": PAPER_REPS}:
        fail(f"SWMCNN train launches {launches} in {PAPER_REPS} steps")
    if not all(math.isfinite(v) for v in losses):
        fail(f"SWMCNN train losses {losses}")
    print(f"paper SWMCNN train: {PAPER_REPS} steps at batch {B}, "
          f"{dt * 1e3:.3f} ms/step = {B / dt:.1f} images/s; losses "
          f"{losses[0]!r} ... {losses[-1]!r}; launches {launches}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(3 + PAPER_REPS, batches[-1])
        torch.cuda.synchronize()
    report_profile(torch, prof, 1, dt * 1e3,
                   f"paper SWMCNN train step (batch {B})")
    return (dict(model="cnn.train", batch=B, ms=dt * 1e3, per_s=B / dt,
                 unit="images", loss_rel=el, grad_norm_rel=en),
            launches)


def phase_paper_kernels(torch, kernel, quant, dev):
    """bc_matmul against its plain version at every paper shape (f32 x;
    repeat launches bit-identical; int8 tables bit for bit against the f32
    launch on dequantized tables at the CNN and LSTM shapes) and bc_dw at
    every PAPER_DW shape in both epilogues. Returns the max abs errors."""
    gen = torch.Generator(device=dev).manual_seed(6)
    mm_abs, n_checks = 0.0, 0
    for name, B, p, q, k in PAPER_SHAPES:
        wr, wi = tables(p, q, k, gen, dev)
        bias = torch.randn(p * k, generator=gen, device=dev)
        x = torch.randn(B, q * k, generator=gen, device=dev)
        y = kernel.bc_matmul(x, wr, wi, bias, k=k)
        again = kernel.bc_matmul(x, wr, wi, bias, k=k)
        yp = kernel.bc_matmul_plain(x, wr, wi, bias, k=k)
        torch.cuda.synchronize()
        e = rel_err(y, yp)
        if not e <= FP32_TOL:
            fail(f"paper {name} B={B} p={p} q={q} k={k}: rel err {e:.3g}")
        if not torch.equal(y, again):
            fail(f"paper {name}: two launches differ")
        mm_abs = max(mm_abs, float((y - yp).abs().max()))
        n_checks += 1
        if name.startswith(PAPER_INT8):
            s = quant.symmetric_scales(wr, wi)
            qr, qi = (quant.quantize_symmetric(wr, s),
                      quant.quantize_symmetric(wi, s))
            y8 = kernel.bc_matmul(x, qr, qi, bias, s, k=k)
            yd = kernel.bc_matmul(x, quant.dequantize_symmetric(qr, s),
                                  quant.dequantize_symmetric(qi, s), bias,
                                  k=k)
            if not torch.equal(y8, yd):
                fail(f"paper {name}: int8 launch differs from dequantized")
            n_checks += 1
    dw_abs = 0.0
    for name, B, P, Q, k in PAPER_DW:
        x = torch.randn(B, Q * k, generator=gen, device=dev)
        g = torch.randn(B, P * k, generator=gen, device=dev)
        for freq_out in (False, True):
            got = kernel.bc_dw(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
            again = kernel.bc_dw(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
            ref = kernel.bc_dw_plain(x, g, P=P, Q=Q, k=k, freq_out=freq_out)
            torch.cuda.synchronize()
            got, again, ref = ((t,) if not freq_out else t
                               for t in (got, again, ref))
            for a, a2, r in zip(got, again, ref):
                e = rel_err(a, r)
                if not e <= dw_tol(B):
                    fail(f"paper bc_dw {name} P={P} Q={Q} k={k} B={B} "
                         f"freq_out={freq_out}: rel err {e:.3g} > "
                         f"{dw_tol(B):.3g}")
                if not torch.equal(a, a2):
                    fail(f"paper bc_dw {name}: two launches differ")
                dw_abs = max(dw_abs, float((a - r).abs().max()))
            n_checks += 1
    dws = ", ".join(f"P={P} Q={Q} k={k} over {B} rows (rel <= "
                    f"{dw_tol(B):.3g})" for _, B, P, Q, k in PAPER_DW)
    print(f"paper kernel checks: {n_checks} passed at {len(PAPER_SHAPES)} "
          f"bc_matmul shapes (f32 rel <= {FP32_TOL}, int8 bit-identical at "
          f"the CNN and LSTM shapes, repeat launches bit-identical) and "
          f"bc_dw, both epilogues, at {dws}; max abs err bc_matmul "
          f"{mm_abs!r}, bc_dw {dw_abs!r}")
    return mm_abs, dw_abs


def phase_paper_times(torch, kernel, dev):
    """Device times at the paper shapes: bc_matmul with f32 x (the paper
    models are f32) beside its plain version, ``torch.matmul`` on the f32
    dense-equivalent matrix and the bound; bc_dw at every PAPER_DW shape."""
    from repro_torch.core.circulant import blocks_to_dense
    from repro_torch.kernels.block_circulant.ops import freq_weights

    gen = torch.Generator(device=dev).manual_seed(7)
    rows = []
    print("paper bc_matmul device times (f32 x, f32 tables, no bias; "
          "median of 7-30 runs, CUDA events; bound and yardstick as above):")
    for name, B, p, q, k in PAPER_SHAPES:
        w = torch.randn(p, q, k, generator=gen, device=dev) * (q * k) ** -0.5
        wr, wi = freq_weights(w)
        dense_t = blocks_to_dense(w).T.contiguous()
        x = torch.randn(B, q * k, generator=gen, device=dev)
        ms = time_ms(torch, lambda: kernel.bc_matmul(x, wr, wi, k=k))
        plain = time_ms(torch, lambda: kernel.bc_matmul_plain(x, wr, wi,
                                                              k=k))
        lib = time_ms(torch, lambda: torch.matmul(x, dense_t))
        nbytes = x.nbytes + wr.nbytes + wi.nbytes + B * p * k * 4
        flops = B * (2.5 * k * math.log2(k) * (q + p)
                     + 8 * p * q * (k // 2 + 1))
        b_ms, b_by = bound(nbytes, flops)
        g = kernel._mm_geometry(B, p, q, k)
        geometry = (f"grid {g.grid[0]}x{g.grid[1]} = "
                    f"{g.grid[0] * g.grid[1]} blocks, {g.rows} rows x "
                    f"{g.p_group} out blocks, q chunk {g.q_chunk}, "
                    f"{g.q_groups} q groups, {g.p_inner} p groups")
        rows.append(dict(shape=name, path="paper", B=B, p=p, q=q, k=k,
                         ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         flops=flops, geometry=geometry,
                         smem_bytes=g.smem_bytes))
        print(f"  {name:16s} p={p:3d} q={q:3d} k={k:2d} B={B:4d}: kernel "
              f"{ms!r} ms, plain {plain!r} ms, torch.matmul {lib!r} ms, "
              f"bound {b_ms!r} ms ({b_by}); {geometry}, {g.smem_bytes} B "
              f"smem")
    dw_rows = []
    for name, B, P, Q, k in PAPER_DW:
        x = torch.randn(B, Q * k, generator=gen, device=dev)
        g = torch.randn(B, P * k, generator=gen, device=dev)
        ms = time_ms(torch, lambda: kernel.bc_dw(x, g, P=P, Q=Q, k=k))
        plain = time_ms(torch, lambda: kernel.bc_dw_plain(x, g, P=P, Q=Q,
                                                          k=k))
        dense = time_ms(torch, lambda: torch.matmul(g.T, x))
        nbytes = x.nbytes + g.nbytes + P * Q * k * 4
        flops = B * (2.5 * k * math.log2(k) * (P + Q)
                     + 8 * P * Q * (k // 2 + 1))
        b_ms, b_by = bound(nbytes, flops)
        geo = kernel._dw_geometry(B, P, Q, k)
        geometry = (f"grid {geo.grid[0]}x{geo.grid[1]}, tile {geo.p_tile} "
                    f"x {geo.q_tile} ({geo.tiles[0]}x{geo.tiles[1]} tiles), "
                    f"thread {geo.p_per_thread} x {geo.q_per_thread}, "
                    f"{geo.rows_per_split} rows per split, {geo.rows} per "
                    f"chunk")
        dw_rows.append(dict(shape=name, path="paper", B=B, P=P, Q=Q, k=k,
                            launches=1, ms=ms, plain_ms=plain,
                            library_ms=None, dense_dw_matmul_ms=dense,
                            bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                            flops=flops, geometry=geometry,
                            smem_bytes=geo.smem_bytes))
        print(f"paper bc_dw device time (f32 x and g, B={B}): {name} P={P} "
              f"Q={Q} k={k}: kernel {ms!r} ms, plain {plain!r} ms, g.T @ x "
              f"{dense!r} ms, bound {b_ms!r} ms ({b_by}); {geometry}, "
              f"{geo.smem_bytes} B smem")
    return rows, dw_rows


# ---------------------------------------------------------------------------
# The recurrent hybrids (the sixth slice's path)
# ---------------------------------------------------------------------------

# bc_matmul launches per forward, pinned: jamba's 4 attention layers (fused
# QKV, o), 28 Mamba layers (in_proj, out_proj: family "ffn", so circulant)
# and 32 FFNs (16 dense SwiGLU, 16 MoE with one grouped launch per expert
# projection) = 8 + 56 + 96; rwkv6's 32 layers of time mix (r, k, v, g, o)
# and channel mix (wk, wr, wv) = 32 x 8. ``hybrid_launches`` derives the
# same counts from the built model
HYBRID_LAUNCHES = {"jamba-v0.1-52b": 160, "rwkv6-7b": 256}
# (name, groups, p, q, launches per forward) of every bc_matmul shape the
# two serve paths add at k = 128: jamba's attention, Mamba and FFN/expert
# projections (d_ff 14336: p or q = 112), rwkv6's time mix (r, k, v, g, o)
# and channel mix (wr shares their shape); groups 16 = the MoE's grouped
# launches over its experts. Each model's launches sum to HYBRID_LAUNCHES
HYBRID_SHAPES = [("jamba.qkv", 1, 48, 32, 4), ("jamba.o", 1, 32, 32, 4),
                 ("jamba.in_proj", 1, 128, 32, 28),
                 ("jamba.out_proj", 1, 32, 64, 28),
                 ("jamba.wi_wu", 1, 112, 32, 32), ("jamba.wo", 1, 32, 112, 16),
                 ("jamba.expert.wi_wu", 16, 112, 32, 32),
                 ("jamba.expert.wo", 16, 32, 112, 16),
                 ("rwkv.rkvgo_wr", 1, 32, 32, 192), ("rwkv.wk", 1, 112, 32, 32),
                 ("rwkv.wv", 1, 32, 112, 32)]
# rows of the timed launches: decode at 4 active slots, and the prefill
# bucket of 4 prompts x 8 tokens (an expert launch's rows are its capacity,
# the forward's tokens)
HYBRID_TIME_ROWS = (4, 32)
# AdamW steps of each example on the card
EXAMPLE_STEPS = 40
# (bc_matmul, bc_dw) launches per train step and per evaluation batch of
# each example at block size 8: the MNIST MLP runs fc0 and fc1 forward, fc1's
# dx (fc0's input takes no grad) and both weight adjoints per step, fc0 and
# fc1 per evaluation batch; the LSTM example takes its default impl, no
# kernel
EXAMPLE_LAUNCHES = {"train_mnist_swm": ((3, 2), (2, 0)),
                    "lstm_asr": ((0, 0), (0, 0))}


def hybrid_launches(model):
    """bc_matmul launches of one forward, read off the built model: 2 per
    attention (global or local) or Mamba mixer (fused QKV + o; in_proj +
    out_proj), 5 per RWKV time mix, 3 per dense FFN or RWKV channel mix, 3
    grouped per MoE (wi, wu, wo over all experts at once)."""
    n = 0
    for layer in model._modules["layers"]:
        n += {"attn": 2, "attn_local": 2, "mamba": 2,
              "rwkv": 5}[layer.mixer_kind]
        n += 3 * sum(name in layer._modules
                     for name in ("ffn_dense", "ffn_moe"))
    return n


def cut_depth(cfg, n):
    """``cfg`` cut to ``n`` layers: its ``n_layers`` (and an enc-dec
    config's ``n_enc_layers``), or for a config that lists its layers as
    one group of one kind (rwkv6) that group's repeat."""
    if cfg.groups is not None:
        (group,) = cfg.groups
        if len(group.layers) != 1:
            fail(f"{cfg.name}: cannot cut a group of {len(group.layers)} "
                 f"layer kinds")
        cfg = dataclasses.replace(cfg, groups=(dataclasses.replace(
            group, repeat=n),))
    cfg = dataclasses.replace(cfg, n_layers=n)
    if cfg.n_enc_layers:
        cfg = dataclasses.replace(cfg, n_enc_layers=n)
    if len(cfg.layer_specs()) != n:
        fail(f"{cfg.name}: the cut has {len(cfg.layer_specs())} layers, "
             f"not {n}")
    return cfg


def serve_cfg(arch, depth=None):
    """``arch``'s CONFIG with ``impl="pallas"`` (the kernel path), cut to
    ``depth`` layers when given."""
    from repro_torch.configs.base import SWMConfig
    from repro_torch.configs.registry import get_config

    cfg = dataclasses.replace(get_config(arch), swm=SWMConfig(
        block_size=128, impl="pallas"))
    return cfg if depth is None else dataclasses.replace(cfg, n_layers=depth)


def card_vs_cpu(torch, cfg, frozen, toks, card, name, img=None,
                frames=None):
    """Queue on CPU_CHECKS, under ("serve", ``name``), the logits of
    ``toks`` (after the image prefix ``img``, or under the encoder
    ``frames`` of an enc-dec model) on the CPU from the frozen tree
    ``frozen`` against ``card`` (the same forward on the card), within
    FULL_WIDTH_TOL of the largest |logit|; its result is (rel err, argmax
    equal, CPU seconds). The inputs are copied to host memory now."""
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import load_tree

    tree, toks = to_device(frozen, "cpu"), toks.cpu()
    img = None if img is None else img.cpu()
    frames = None if frames is None else frames.cpu()
    card = card.float().cpu()

    def cpu_half():
        t = time.perf_counter()
        cpu_model = build_model(cfg, device="cpu")
        load_tree(cpu_model, tree)
        with torch.no_grad():
            if frames is not None:
                cpu = cpu_model.forward(frames, toks, logits_mode="last")[0]
            else:
                cpu = cpu_model.forward(
                    toks, img_embeds=img,
                    logits_mode="last" if img is None else "all",
                    moe_no_drop=True)[0]
        secs = time.perf_counter() - t
        if card.shape != cpu.shape or not (torch.isfinite(card).all()
                                           and torch.isfinite(cpu).all()):
            fail(f"{name}: card logits {tuple(card.shape)} vs cpu "
                 f"{tuple(cpu.shape)}, or not finite")
        e = rel_err(card, cpu)
        same = bool((card.argmax(-1) == cpu.argmax(-1)).all())
        what = f"{toks.shape[1]} tokens" + (
            "" if img is None else f" after a {img.shape[1]}-position image "
            f"prefix, every position's logits") + (
            "" if frames is None
            else f" over {frames.shape[1]} encoder frames")
        depth = (f"{cfg.n_enc_layers} + {cfg.n_layers}" if cfg.n_enc_layers
                 else cfg.n_layers)
        print(f"{name} card vs cpu logits ({depth} layers at full width, "
              f"{what}): rel err {e:.3g} (tolerance {FULL_WIDTH_TOL}), argmax "
              f"equal: {same}; cpu pass {secs:.1f}s")
        if not e <= FULL_WIDTH_TOL:
            fail(f"{name}: card vs cpu logits rel err {e:.3g} > "
                 f"{FULL_WIDTH_TOL}")
        return e, same, secs

    CPU_CHECKS.submit(("serve", name), cpu_half)


def settle(rows, kind, fields):
    """Each of ``rows`` updated with its CPU check's result (``fields``
    named in order; None skips one), keyed (``kind``, its model)."""
    for row in rows:
        got = CPU_CHECKS.result((kind, row["model"]))
        row.update((f, v) for f, v in zip(fields, got) if f is not None)


def prefill_twice(torch, model, toks, name):
    """The last position's logits of ``toks`` on the card, twice; the two
    must agree bit for bit."""
    with torch.no_grad():
        a = model.forward(toks, logits_mode="last", moe_no_drop=True)[0]
        b = model.forward(toks, logits_mode="last", moe_no_drop=True)[0]
    torch.cuda.synchronize()
    if not torch.equal(a, b):
        fail(f"{name}: two prefills of one prompt on the card differ")
    return a


def short_requests(cfg, n=8, max_new=16):
    """The serve traffic of every path: ``n`` greedy requests of 3-8
    random tokens (numpy seed 0), ``max_new`` new tokens each."""
    from repro_torch.serve.engine import Request
    import numpy as np

    rng = np.random.default_rng(0)
    return [Request(rng.integers(0, cfg.vocab, size=int(rng.integers(3, 9))
                                 ).astype(np.int32), max_new=max_new)
            for _ in range(n)]


def serve_counted(torch, kernel, engine, reqs, per_forward, name,
                  per_decode=None):
    """``reqs`` through the engine's streaming API with the bc_matmul count
    set to 0 just before and read just after, held to ``per_forward`` per
    prefill call and ``per_decode`` (default ``per_forward``) per decode
    step. Returns ({rid index: tokens}, stats of the run)."""
    per_decode = per_forward if per_decode is None else per_decode
    s = engine.stats
    prefills0, decodes0 = s.prefill_calls, s.decode_steps
    torch.cuda.synchronize()
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
    prefills = s.prefill_calls - prefills0
    decodes = s.decode_steps - decodes0
    forwards = prefills + decodes
    if [len(outs[r]) for r in rids] != [r.max_new for r in reqs]:
        fail(f"{name}: token counts {[len(outs[r]) for r in rids]}")
    want = per_forward * prefills + per_decode * decodes
    held = (f"{per_forward} x {forwards}" if per_decode == per_forward
            else f"{per_forward} x {prefills} prefills + {per_decode} x "
            f"{decodes} decode steps")
    if launches != want:
        fail(f"{name}: bc_matmul launches {launches} != {held} = {want}")
    n_tok = sum(len(o) for o in outs.values())
    step_ms = statistics.median(decode_ms)
    print(f"{name} serve: {len(reqs)} requests = {n_tok} tokens in "
          f"{dt:.3f}s = {n_tok / dt:.1f} tok/s; {forwards} forwards "
          f"({len(decode_ms)} decode-only steps, median {step_ms:.2f} "
          f"ms/step); bc_matmul launches {launches} = {held}; all logits "
          f"finite; prefill shapes {sorted(s.prefill_shapes)} decode "
          f"{sorted(s.decode_shapes)}")
    return ([outs[r] for r in rids],
            dict(tokens=n_tok, seconds=dt, step_ms=step_ms,
                 launches=launches, forwards=forwards, prefills=prefills,
                 decodes=decodes))


def phase_hybrid(torch, kernel, dev, arch):
    """Full-width ``arch`` (jamba-v0.1-52b or rwkv6-7b) served through
    ``make_runner`` -> ``RecurrentRunner``: 8 greedy requests x 16 tokens
    with the bc_matmul count set to 0 just before and read just after and
    held to the pinned launches per forward; a profile of decode steps; the
    first request's prefill logits on the card against the CPU, and twice
    on the card (bit-identical: the MoE dispatch's atomic scatter-add sums
    one value per slot). Returns (report row, row counts launched)."""
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.runner import RecurrentRunner
    import numpy as np

    cfg = serve_cfg(arch)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), seed=0, device=dev)
    engine = ServeEngine(model, cfg, params, batch=4, cache_len=128)
    del params
    torch.cuda.synchronize()
    per_forward = hybrid_launches(model)
    if per_forward != HYBRID_LAUNCHES[arch]:
        fail(f"{arch}: the model has {per_forward} bc_matmul launches per "
             f"forward, expected {HYBRID_LAUNCHES[arch]}")
    if not isinstance(engine.runner, RecurrentRunner):
        fail(f"{arch}: served by {type(engine.runner).__name__}")
    print(f"{arch} full width ({cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab}, "
          f"{cfg.compute_dtype}, impl={cfg.swm.impl}): built, initialized "
          f"and frozen in {time.perf_counter() - t0:.2f}s; frozen table "
          f"bytes {engine.frozen_table_bytes()}; device memory allocated "
          f"{torch.cuda.memory_allocated(dev)}; runner "
          f"{type(engine.runner).__name__}")
    engine.generate([Request(np.arange(4, dtype=np.int32), max_new=2)])

    reqs = short_requests(cfg)
    _, serve = serve_counted(torch, kernel, engine, reqs, per_forward, arch)
    n_tok, dt, step_ms = serve["tokens"], serve["seconds"], serve["step_ms"]
    s, launches, forwards = engine.stats, serve["launches"], serve["forwards"]
    busy = phase_profile(torch, engine, reqs, step_ms)

    # the first request's prefill: twice on the card, then on the CPU
    toks = torch.as_tensor(reqs[0].prompt, dtype=torch.long,
                           device=dev)[None]
    card = prefill_twice(torch, engine.runner.model, toks, arch)
    frozen = engine.params
    del engine, model
    torch.cuda.empty_cache()
    card_vs_cpu(torch, cfg, frozen, toks, card, arch)
    del frozen
    rows = {b * t for b, t in s.prefill_shapes} | set(s.decode_shapes)
    return (dict(model=arch, requests=len(reqs), tokens=n_tok, seconds=dt,
                 tokens_per_s=n_tok / dt, decode_ms_per_step=step_ms,
                 device_busy_ms_per_step=busy,
                 device_idle_share=(None if busy is None
                                    else 1 - busy / step_ms),
                 launches=launches, launches_per_forward=per_forward,
                 forwards=forwards,
                 prefill_shapes=sorted(s.prefill_shapes),
                 decode_shapes=sorted(s.decode_shapes)),
            rows)


def phase_hybrid_kernels(torch, kernel, quant, dev, row_counts,
                         shapes=HYBRID_SHAPES, label="hybrid", seed=8):
    """bc_matmul against its plain version at every one of ``shapes`` and
    every row count its serve path launched (``row_counts``: {shape name:
    row counts}; an expert launch's rows are its capacity, the tokens of
    the forward), f32 and bf16 x,
    each launched twice (bit-identical). Grouped shapes also: every group
    of the grouped launch bit for bit against its own single launch, f32
    and int8 tables. Every shape: the int8 launch bit for bit against the
    f32 launch on dequantized tables. Returns the max abs error of the f32
    checks."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    worst_abs, n_checks = 0.0, 0
    all_rows, groups = set(), set()
    for name, G, p, q, _ in shapes:
        lead = (G,) if G > 1 else ()
        wr = torch.randn(*lead, p, q, K // 2 + 1, generator=gen, device=dev)
        wi = torch.randn(*lead, p, q, K // 2 + 1, generator=gen, device=dev)
        all_rows |= set(row_counts[name])
        groups.add(G)
        for B in sorted(row_counts[name]):
            shape = (G, B, q * K) if G > 1 else (B, q * K)
            x32 = torch.randn(*shape, generator=gen, device=dev)
            for x, tol in ((x32, FP32_TOL), (x32.bfloat16(), BF16_TOL)):
                y = kernel.bc_matmul(x, wr, wi, k=K)
                again = kernel.bc_matmul(x, wr, wi, k=K)
                yp = kernel.bc_matmul_plain(x, wr, wi, k=K)
                torch.cuda.synchronize()
                e = rel_err(y, yp)
                if not e <= tol:
                    fail(f"{name} B={B} {x.dtype}: rel err {e:.3g} > {tol}")
                if not torch.equal(y, again):
                    fail(f"{name} B={B} {x.dtype}: two launches differ")
                if G > 1:
                    for g in range(G):
                        if not torch.equal(y[g], kernel.bc_matmul(
                                x[g], wr[g], wi[g], k=K)):
                            fail(f"{name} B={B} {x.dtype}: group {g} differs "
                                 f"from its single launch")
                if x.dtype == torch.float32:
                    worst_abs = max(worst_abs, float((y - yp).abs().max()))
                n_checks += 1
        sc = quant.symmetric_scales(wr, wi)
        qr, qi = (quant.quantize_symmetric(wr, sc),
                  quant.quantize_symmetric(wi, sc))
        x = torch.randn(*lead, 4, q * K, generator=gen, device=dev).bfloat16()
        y8 = kernel.bc_matmul(x, qr, qi, None, sc, k=K)
        yd = kernel.bc_matmul(x, quant.dequantize_symmetric(qr, sc),
                              quant.dequantize_symmetric(qi, sc), k=K)
        if not torch.equal(y8, yd):
            fail(f"{name}: int8 launch differs from the f32 launch on "
                 f"dequantized tables")
        for g in range(G if G > 1 else 0):
            if not torch.equal(y8[g], kernel.bc_matmul(
                    x[g], qr[g], qi[g], None, sc[g], k=K)):
                fail(f"{name}: int8 group {g} differs from its single "
                     f"launch")
        n_checks += 1
    grouped = (f" (grouped G={max(groups)} at the expert shapes)"
               if max(groups) > 1 else "")
    print(f"{label} bc_matmul checks: {n_checks} passed at {len(shapes)} "
          f"shapes{grouped} x rows {sorted(all_rows)} (f32 rel <= "
          f"{FP32_TOL}, bf16 rel <= {BF16_TOL:.3g}; repeat launches "
          f"bit-identical; every group of a grouped launch bit-identical to "
          f"its single launch, f32 and int8; int8 bit-identical to "
          f"dequantized f32); max abs err (f32) = {worst_abs!r}")
    return worst_abs


def phase_hybrid_times(torch, kernel, dev, cases, label="hybrid", seed=9):
    """Device times at ``cases`` = [(name, groups, p, q, launches per
    forward, B)], bf16 x and f32 tables: the kernel, its plain version, the
    dense-equivalent product (``torch.bmm`` over the experts' stack for a
    grouped launch, ``torch.matmul`` otherwise; yardsticks the port never
    calls) and the bound (every group's bytes and operations)."""
    from repro_torch.core.circulant import blocks_to_dense
    from repro_torch.kernels.block_circulant.ops import freq_weights

    gen = torch.Generator(device=dev).manual_seed(seed)
    Kf = K // 2 + 1
    rows = []
    print(f"{label} bc_matmul device times (bf16 x, f32 tables; median of "
          "7-30 runs, CUDA events; bound as above over all groups; "
          "yardstick = torch.bmm on the (G, q*k, p*k) dense-equivalent stack for a "
          "grouped launch, torch.matmul otherwise):")
    for name, G, p, q, per, B in cases:
        w = torch.randn(G, p, q, K, generator=gen, device=dev) * (
            q * K) ** -0.5
        wr, wi = freq_weights(w)
        dense = torch.stack([blocks_to_dense(w[g]).T.bfloat16()
                             for g in range(G)])
        x = torch.randn(G, B, q * K, generator=gen, device=dev).bfloat16()
        if G == 1:
            wr, wi, dense, x = wr[0], wi[0], dense[0], x[0]
            lib_fn = lambda: torch.matmul(x, dense)
        else:
            lib_fn = lambda: torch.bmm(x, dense)
        ms = time_ms(torch, lambda: kernel.bc_matmul(x, wr, wi, k=K))
        plain = time_ms(torch, lambda: kernel.bc_matmul_plain(x, wr, wi, k=K))
        lib = time_ms(torch, lib_fn)
        nbytes = x.nbytes + wr.nbytes + wi.nbytes + G * B * p * K * 2
        flops = G * B * (2.5 * K * math.log2(K) * (q + p) + 8 * p * q * Kf)
        b_ms, b_by = bound(nbytes, flops)
        g = kernel._mm_geometry(B, p, q, K)
        geometry = (f"grid {g.grid[0]}x{g.grid[1]}x{G} = "
                    f"{g.grid[0] * g.grid[1] * G} blocks, {g.rows} rows x "
                    f"{g.p_group} out blocks, q chunk {g.q_chunk}, "
                    f"{g.q_groups} q groups")
        rows.append(dict(shape=name, path=label, groups=G, B=B, p=p, q=q,
                         k=K, launches=per, ms=ms, plain_ms=plain,
                         library_ms=lib, bound_ms=b_ms, bound_by=b_by,
                         bytes=nbytes, flops=flops, geometry=geometry,
                         smem_bytes=g.smem_bytes))
        print(f"  {name:24s} G={G:3d} p={p:3d} q={q:3d} B={B:4d}: kernel "
              f"{ms!r} ms, plain {plain!r} ms, "
              f"{'torch.bmm' if G > 1 else 'torch.matmul'} {lib!r} ms, bound "
              f"{b_ms!r} ms ({b_by}), {per} launches/forward; {geometry}, "
              f"{g.smem_bytes} B smem")
        del dense
    return rows


# ---------------------------------------------------------------------------
# The rest of the decoder family (the seventh slice's path)
# ---------------------------------------------------------------------------

# bc_matmul launches per forward at full depth, pinned: 2 per attention
# layer (fused QKV, o; gemma3's 52 local and 10 global alike) and 3 per
# dense SwiGLU or grouped MoE (wi, wu, wo over all 128 experts at once):
# gemma3 62 x 5, paligemma 18 x 5, deepseek 30 x 5, internlm2 48 x 5,
# qwen3-moe 94 x (2 + 3 grouped), arctic 35 x (2 + 3 dense + 3 grouped).
# A path cut in depth is held to (these / full depth) x its layers
FAMILY_LAUNCHES = {"gemma3-27b": 310, "paligemma-3b": 90,
                   "arctic-480b": 280, "qwen3-moe-235b-a22b": 470,
                   "deepseek-7b": 150, "internlm2-20b": 240}
# per path: the depth it is served at (None: full) and the depth of its
# card-vs-CPU comparison (None: the served model itself). gemma3's CPU pass
# over 62 layers at the 1400-token prompt would take minutes of the time
# limit, so it compares one full 5 local + 1 global period at full width;
# arctic's (35 layers of 128 experts) compares a 2-layer cut; qwen3-moe,
# deepseek and internlm2 are uniform, so 2 layers keep every layer kind
FAMILY_DEPTHS = {"gemma3-27b": (None, 6), "paligemma-3b": (None, None),
                 "arctic-480b": (None, 2), "qwen3-moe-235b-a22b": (2, None),
                 "deepseek-7b": (2, None), "internlm2-20b": (2, None)}
# gemma3's long prompts beside the short traffic: 1015 tokens (a 1024-row
# prefill bucket: its local layers take the fresh-kv branch, its global
# ones the cache branch; decode wraps the 1024-entry rings) and 1400 (a
# 2048-row bucket that wraps the rings during prefill)
GEMMA_LONG = (1015, 1400)
GEMMA_CACHE_LEN = 2048
# the ring check compares two f32 card passes (cached decode against a
# no-cache forward), so it is not held to FULL_WIDTH_TOL. RING_TOL lies
# between the sound reading and a planted fault's: every local layer's
# window one short during decode, i.e. one key of 1024 dropped per local
# layer per step. On an NVIDIA H100 80GB HBM3 at 700 W the sound pass reads
# 1.84e-6 and the planted fault 1.24e-5 (PERF.md §6). The served bf16
# model's sound pass reads 2.27e-4, above that fault, hence the f32 pass
RING_TOL = 5e-6
RING_FAULT_SHIFT = -1
# per path, (name, groups, p, q, launches per forward at the served depth)
# of every bc_matmul shape it launches at k = 128; groups 128 = one grouped
# launch over a MoE layer's experts
FAMILY_SHAPES = {
    "gemma3-27b": [("gemma3.qkv", 1, 64, 42, 62), ("gemma3.o", 1, 42, 32, 62),
                   ("gemma3.wi_wu", 1, 168, 42, 124),
                   ("gemma3.wo", 1, 42, 168, 62)],
    "paligemma-3b": [("paligemma.qkv", 1, 20, 16, 18),
                     ("paligemma.o", 1, 16, 16, 18),
                     ("paligemma.wi_wu", 1, 128, 16, 36),
                     ("paligemma.wo", 1, 16, 128, 18)],
    "deepseek-7b": [("deepseek.qkv", 1, 96, 32, 2),
                    ("deepseek.o", 1, 32, 32, 2),
                    ("deepseek.wi_wu", 1, 86, 32, 4),
                    ("deepseek.wo", 1, 32, 86, 2)],
    "internlm2-20b": [("internlm2.qkv", 1, 64, 48, 2),
                      ("internlm2.o", 1, 48, 48, 2),
                      ("internlm2.wi_wu", 1, 128, 48, 4),
                      ("internlm2.wo", 1, 48, 128, 2)],
    "qwen3-moe-235b-a22b": [("qwen3_moe.qkv", 1, 72, 32, 2),
                            ("qwen3_moe.o", 1, 32, 64, 2),
                            ("qwen3_moe.expert.wi_wu", 128, 12, 32, 4),
                            ("qwen3_moe.expert.wo", 128, 32, 12, 2)],
    "arctic-480b": [("arctic.qkv", 1, 72, 56, 35), ("arctic.o", 1, 56, 56, 35),
                    ("arctic.wi_wu", 1, 38, 56, 70),
                    ("arctic.wo", 1, 56, 38, 35),
                    ("arctic.expert.wi_wu", 128, 38, 56, 70),
                    ("arctic.expert.wo", 128, 56, 38, 35)]}
# rows of the timed launches: decode at 4 active slots, the 4 x 8 prefill
# bucket, and gemma3's long prefill buckets
FAMILY_TIME_ROWS = (4, 32)
GEMMA_TIME_ROWS = (4, 1024, 2048)


def family_per_forward(arch, cfg):
    full = get_full_depth(arch)
    if FAMILY_LAUNCHES[arch] % full:
        fail(f"{arch}: pinned launches not a multiple of its depth")
    return FAMILY_LAUNCHES[arch] // full * cfg.n_layers


def get_full_depth(arch):
    from repro_torch.configs.registry import get_config
    return get_config(arch).n_layers


def tree_bytes(tree, keep, path=()):
    """Bytes of the tensors of a nested-dict tree whose path ``keep``s."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v, keep, path + (k,)) for k, v in tree.items())
    return tree.nbytes if keep(path) else 0


def ring_check(torch, cfg, frozen, prompt, gen, dev):
    """gemma3's rings at full width and depth, in f32 as
    ``tests/test_ring_cache.py`` runs them: the served model's frozen tree
    ``frozen`` cast to f32 in an f32 model; prefill ``prompt`` into a fresh
    B = 1 cache of GEMMA_CACHE_LEN, then decode the engine's tokens ``gen``
    through it. The logits of those len(gen) steps must equal a no-cache
    forward of prompt + gen[:-1] at the same positions within RING_TOL,
    with the same argmax at every step. The cached pass runs again with a
    planted fault (every local layer's window RING_FAULT_SHIFT short during
    the decode steps, so each step drops the oldest key of its ring), whose
    reading must exceed RING_TOL. Returns (rel err, planted rel err, the
    rows launched)."""
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import load_tree, tree_map

    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, device=dev)
    load_tree(model, tree_map(lambda t: t.float() if t.is_floating_point()
                              else t, frozen))
    L = len(prompt)
    toks = torch.as_tensor(list(prompt) + list(gen[:-1]), dtype=torch.long,
                           device=dev)[None]
    local = [layer._modules["mixer"] for layer in model._modules["layers"]
             if layer.mixer_kind == "attn_local"]

    def cached(shift):
        with torch.no_grad():
            cache = model.init_cache(1, GEMMA_CACHE_LEN)
            lg, cache = model.prefill(toks[:, :L], cache)
            steps = [lg]
            for m in local:
                m.window += shift
            try:
                for i in range(len(gen) - 1):
                    lg, cache = model.decode_step(
                        toks[:, L + i:L + i + 1], cache,
                        torch.full((1,), L + i, dtype=torch.int32,
                                   device=dev))
                    steps.append(lg)
            finally:
                for m in local:
                    m.window -= shift
        return torch.cat(steps).float(), cache[0]["k"].shape[1]

    steps, ring = cached(0)
    with torch.no_grad():
        h, _ = model.forward(toks, logits_mode="none")
        full = model._logits(h[:, L - 1:])[0].float()
    e = rel_err(steps, full)
    planted = rel_err(cached(RING_FAULT_SHIFT)[0], full)
    agree = int((steps.argmax(-1) == full.argmax(-1)).sum())
    del model
    torch.cuda.empty_cache()
    print(f"gemma3-27b ring check (f32): prefill {L} tokens + "
          f"{len(gen) - 1} decode steps through the cache (local rings of "
          f"{ring}, {(L + len(gen)) / ring:.2f} ring lengths) against a "
          f"no-cache forward of {toks.shape[1]} tokens: rel err {e!r} "
          f"(tolerance {RING_TOL}); planted fault (local windows "
          f"{RING_FAULT_SHIFT} during decode) rel err {planted!r}; argmax "
          f"of the cached steps equals the forward's at {agree} of "
          f"{len(gen)} steps")
    if not e <= RING_TOL:
        fail(f"gemma3-27b: cached decode vs no-cache forward rel err "
             f"{e:.3g} > {RING_TOL}")
    if not planted > RING_TOL:
        fail(f"gemma3-27b: the planted ring fault reads {planted:.3g}, "
             f"within the ring check's tolerance {RING_TOL}")
    if agree != len(gen):
        fail(f"gemma3-27b: cached and no-cache argmax agree at {agree} of "
             f"{len(gen)} steps")
    return e, planted, {L, toks.shape[1], 1}


def long_prefill_profile(torch, model, toks):
    """Wall and device time of one B = 1 prefill of ``toks`` (gemma3's
    1400-token prompt: 1400 rows through every projection, the plain-loop
    flash attention over 1400 keys on every layer)."""
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.forward(toks, logits_mode="last")
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            model.forward(toks, logits_mode="last")
            torch.cuda.synchronize()
    busy = report_profile(torch, prof, 1, wall_ms, f"gemma3-27b prefill of "
                          f"{toks.shape[1]} tokens (B = 1)")
    return dict(long_prefill_wall_ms=wall_ms, long_prefill_busy_ms=busy)


def phase_family(torch, kernel, dev, arch):
    """``arch`` (gemma3-27b, paligemma-3b, arctic-480b at full depth;
    qwen3-moe-235b-a22b, deepseek-7b, internlm2-20b cut to 2 layers; all at
    full width) served through ``make_runner`` -> ``DecoderRunner``: the
    short traffic (8 greedy requests x 16 tokens; gemma3 adds GEMMA_LONG)
    with bc_matmul held to the pinned launches per forward, a decode
    profile, the served prompt's prefill twice on the card (bit-identical)
    and against the CPU; gemma3's ring check; paligemma's image prefix
    through ``model.forward`` on the card and the CPU. Returns (report row,
    the row counts launched)."""
    from repro_torch.launch.specs import build_model
    from repro_torch.kernels.block_circulant.plan import freeze_params
    from repro_torch.nn.module import init_params, load_tree
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.runner import DecoderRunner
    import numpy as np

    depth, cpu_depth = FAMILY_DEPTHS[arch]
    cfg = serve_cfg(arch, depth)
    gemma = arch == "gemma3-27b"
    cache_len = GEMMA_CACHE_LEN if gemma else 128
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), seed=0, device=dev)
    engine = ServeEngine(model, cfg, params, batch=4, cache_len=cache_len)
    del params
    torch.cuda.synchronize()
    per_forward = family_per_forward(arch, cfg)
    if hybrid_launches(model) != per_forward:
        fail(f"{arch}: the model has {hybrid_launches(model)} bc_matmul "
             f"launches per forward, expected {per_forward}")
    if type(engine.runner) is not DecoderRunner:
        fail(f"{arch}: served by {type(engine.runner).__name__}")
    mixers = [layer.mixer_kind for layer in model._modules["layers"]]
    experts = tree_bytes(engine.params, lambda path: "ffn_moe" in path
                         and "experts" in path)
    print(f"{arch} full width ({cfg.n_layers} of {get_full_depth(arch)} "
          f"layers: {mixers.count('attn_local')} local, "
          f"{mixers.count('attn')} global attention; d_model {cfg.d_model}, "
          f"d_ff {cfg.d_ff}, experts {cfg.n_experts}, vocab {cfg.vocab}, "
          f"{cfg.compute_dtype}, impl={cfg.swm.impl}): built, initialized "
          f"and frozen in {time.perf_counter() - t0:.2f}s; frozen table "
          f"bytes {engine.frozen_table_bytes()} (experts {experts}); device "
          f"memory allocated {torch.cuda.memory_allocated(dev)}; runner "
          f"{type(engine.runner).__name__}, {per_forward} bc_matmul "
          f"launches per forward")
    engine.generate([Request(np.arange(4, dtype=np.int32), max_new=2)])

    reqs = short_requests(cfg, n=6 if gemma else 8)
    if gemma:
        rng = np.random.default_rng(1)
        reqs += [Request(rng.integers(0, cfg.vocab, size=n).astype(np.int32),
                         max_new=16) for n in GEMMA_LONG]
    outs, serve = serve_counted(torch, kernel, engine, reqs, per_forward,
                                arch)
    s = engine.stats
    busy = phase_profile(torch, engine, reqs, serve["step_ms"])
    rows = {b * t for b, t in s.prefill_shapes} | set(s.decode_shapes) | {1}

    row = dict(model=arch, layers=cfg.n_layers,
               full_layers=get_full_depth(arch), requests=len(reqs),
               tokens=serve["tokens"], seconds=serve["seconds"],
               tokens_per_s=serve["tokens"] / serve["seconds"],
               decode_ms_per_step=serve["step_ms"],
               device_busy_ms_per_step=busy,
               device_idle_share=(None if busy is None
                                  else 1 - busy / serve["step_ms"]),
               launches=serve["launches"], launches_per_forward=per_forward,
               forwards=serve["forwards"],
               frozen_table_bytes=engine.frozen_table_bytes(),
               expert_table_bytes=experts,
               device_memory_allocated=torch.cuda.memory_allocated(dev),
               prefill_shapes=sorted(s.prefill_shapes),
               decode_shapes=sorted(s.decode_shapes))
    served = engine.runner.model
    # the prompt compared: gemma3's 1400-token one, else the first request
    prompt = reqs[-1].prompt if gemma else reqs[0].prompt
    toks = torch.as_tensor(prompt, dtype=torch.long, device=dev)[None]
    rows.add(toks.shape[1])
    card = prefill_twice(torch, served, toks, arch)
    if gemma:
        e, planted, more = ring_check(torch, cfg, engine.params, prompt,
                                      outs[-1], dev)
        rows |= more
        row.update(ring_rel_err=e, ring_planted_fault_rel_err=planted,
                   **long_prefill_profile(torch, served, toks))
    img = None
    if cfg.n_img_tokens:
        img = torch.randn(1, cfg.n_img_tokens, cfg.d_model,
                          generator=torch.Generator().manual_seed(5)).to(
                              dev, torch.bfloat16)
        kernel.LAUNCHES["bc_matmul"] = 0
        with torch.no_grad():
            card = served.forward(toks, img_embeds=img)[0]
        torch.cuda.synchronize()
        if kernel.LAUNCHES["bc_matmul"] != per_forward:
            fail(f"{arch}: image-prefix forward launched "
                 f"{kernel.LAUNCHES['bc_matmul']} bc_matmul, not "
                 f"{per_forward}")
        rows.add(img.shape[1] + toks.shape[1])
    frozen = engine.params
    del engine, model, served
    torch.cuda.empty_cache()
    if cpu_depth is not None:
        # compare a cut of the same width: fresh seeded params, frozen
        cfg = serve_cfg(arch, cpu_depth)
        cut = build_model(cfg, device=dev)
        frozen = freeze_params(cut.specs(), init_params(cut.specs(), seed=1,
                                                        device=dev))
        load_tree(cut, frozen)
        card = prefill_twice(torch, cut, toks, f"{arch} ({cpu_depth} layers)")
        del cut
    card_vs_cpu(torch, cfg, frozen, toks, card, arch, img)
    del frozen
    torch.cuda.empty_cache()
    row.update(cpu_vs_card_layers=cfg.n_layers)
    return row, rows


# ---------------------------------------------------------------------------
# The enc-dec family (the eighth slice's path)
# ---------------------------------------------------------------------------

ENCDEC_ARCH = "seamless-m4t-medium"
# bc_matmul launches per prefill and per decode step, pinned: 4 per encoder
# layer (fused QKV, o, wi, wo) and 8 per decoder layer in prefill (fused
# self QKV, o; cross q, k, v, o; wi, wo), 6 in decode (the cross k/v come
# from the cache): 12 x 4 + 12 x 8 and 12 x 6. ``encdec_launches`` derives
# the same counts from the built model
ENCDEC_LAUNCHES = (144, 72)
# (name, groups, p, q, launches per prefill, launches per decode step) of
# every bc_matmul shape the path launches at k = 128: the fused QKV (encoder
# and decoder self attention), the 8 x 8 projections (every o; cross q, k
# and v), the MLP's wi and wo
ENCDEC_SHAPES = [("encdec.qkv", 1, 24, 8, 24, 12),
                 ("encdec.proj", 1, 8, 8, 72, 36),
                 ("encdec.wi", 1, 32, 8, 24, 12),
                 ("encdec.wo", 1, 8, 32, 24, 12)]
# rows of the timed launches: decode at 4 active slots, the 4 x 8 prefill
# bucket, one request's and a 4-request bucket's encoder frames
ENCDEC_TIME_ROWS = (4, 32, 4096, 16384)
# the frames of every request come from this numpy seed (the prompts from
# ``short_requests``' seed 0)
ENCDEC_FRAME_SEED = 2
ENCDEC_CACHE_LEN = 128
# the cross-cache check compares two f32 card passes (cached decode, which
# reads the cross K/V stashed at prefill, against a no-cache forward), so
# it is not held to FULL_WIDTH_TOL. CROSS_TOL lies between the sound
# reading and a planted fault's: encoder frame CROSS_FAULT_FRAME masked
# (cross-cache pos = -1) in every decoder layer during decode, i.e. one key
# of 4096 dropped per layer per step. On an NVIDIA H100 80GB HBM3 at 700 W
# the sound pass reads 9.30e-7 and the planted fault 3.69e-6 (PERF.md §6)
CROSS_TOL = 2e-6
CROSS_FAULT_FRAME = 0


def encdec_launches(model):
    """(per prefill, per decode step) bc_matmul launches read off the built
    model, once every projection is checked circulant: per encoder layer
    the fused QKV, o, wi and wo; per decoder layer the fused self QKV, o,
    cross q, k, v, o, wi and wo in prefill, less cross k and v in
    decode."""
    from repro_torch.nn.linear import Linear

    flat = [m for m in model.modules() if isinstance(m, Linear)]
    if not all(m.is_circulant for m in flat):
        fail("enc-dec: a projection is not circulant")
    n_enc = len(model._modules["encoder"])
    n_dec = len(model._modules["decoder"])
    return 4 * n_enc + 8 * n_dec, 6 * n_dec


def encdec_frames(cfg, n):
    """``n`` requests' encoder frames (enc_seq, d_model), f32, from
    ENCDEC_FRAME_SEED."""
    import numpy as np

    rng = np.random.default_rng(ENCDEC_FRAME_SEED)
    return [rng.standard_normal((cfg.enc_seq, cfg.d_model)).astype(
        np.float32) for _ in range(n)]


def cross_check(torch, cfg, frozen, prompt, frames, gen, dev):
    """The cross caches at full width and depth, in f32: the served model's
    frozen tree ``frozen`` cast to f32 in an f32 model; prefill ``prompt``
    under ``frames`` into a fresh B = 1 cache, then decode the engine's
    tokens ``gen`` through it (cross K/V read back from the cache). The
    logits of those len(gen) steps must equal a no-cache forward of
    prompt + gen[:-1] within CROSS_TOL, with the same argmax at every step.
    The cached pass runs again with a planted fault (encoder frame
    CROSS_FAULT_FRAME's cross-cache position set to -1 in every decoder
    layer after the prefill), whose reading must exceed CROSS_TOL. Returns
    (rel err, planted rel err, the rows launched)."""
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import load_tree, tree_map

    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, device=dev)
    load_tree(model, tree_map(lambda t: t.float() if t.is_floating_point()
                              else t, frozen))
    L = len(prompt)
    toks = torch.as_tensor(list(prompt) + list(gen[:-1]), dtype=torch.long,
                           device=dev)[None]
    f = torch.as_tensor(frames, device=dev)[None]

    def cached(fault):
        with torch.no_grad():
            lg, cache = model.forward(f, toks[:, :L],
                                      cache=model.init_cache(
                                          1, ENCDEC_CACHE_LEN),
                                      logits_mode="last")
            steps = [lg[:, -1]]
            if fault:
                for c in cache["cross"]:
                    c["pos"][:, CROSS_FAULT_FRAME] = -1
            for i in range(len(gen) - 1):
                lg, cache = model.decode_step(
                    toks[:, L + i:L + i + 1], cache,
                    torch.full((1,), L + i, dtype=torch.int32, device=dev))
                steps.append(lg)
        return torch.cat(steps).float()

    steps = cached(False)
    with torch.no_grad():
        full = model.forward(f, toks)[0][0, L - 1:].float()
    e = rel_err(steps, full)
    planted = rel_err(cached(True), full)
    agree = int((steps.argmax(-1) == full.argmax(-1)).sum())
    del model
    torch.cuda.empty_cache()
    print(f"{ENCDEC_ARCH} cross-cache check (f32): prefill {L} tokens over "
          f"{f.shape[1]} frames + {len(gen) - 1} decode steps reading the "
          f"cross K/V from the cache, against a no-cache forward of "
          f"{toks.shape[1]} tokens: rel err {e!r} (tolerance {CROSS_TOL}); "
          f"planted fault (frame {CROSS_FAULT_FRAME} masked in every cross "
          f"cache during decode) rel err {planted!r}; argmax of the cached "
          f"steps equals the forward's at {agree} of {len(gen)} steps")
    if not e <= CROSS_TOL:
        fail(f"{ENCDEC_ARCH}: cached decode vs no-cache forward rel err "
             f"{e:.3g} > {CROSS_TOL}")
    if not planted > CROSS_TOL:
        fail(f"{ENCDEC_ARCH}: the planted cross-cache fault reads "
             f"{planted:.3g}, within the check's tolerance {CROSS_TOL}")
    if agree != len(gen):
        fail(f"{ENCDEC_ARCH}: cached and no-cache argmax agree at {agree} "
             f"of {len(gen)} steps")
    return e, planted, {f.shape[1], L, toks.shape[1], 1}


def encdec_prefill_profile(torch, engine, reqs):
    """Wall and device time of one 4-request prefill through the runner
    (4 x enc_seq encoder rows through every encoder projection and the
    plain-loop flash attention, the 4 x 8 decoder bucket), its bc_matmul
    share, and the device time of one decode step's gather and place of
    4 slots' whole state. Run on the idle engine's slots 0-3, which the
    next admission overwrites."""
    from torch.profiler import ProfilerActivity, profile
    import numpy as np

    runner, dev = engine.runner, engine.device
    chunk = reqs[:4]
    Sb = 8
    toks = np.zeros((4, Sb), np.int64)
    pos = np.zeros((4, Sb), np.int32)
    for j, r in enumerate(chunk):
        T = r.prompt_len
        toks[j, Sb - T:] = r.prompt
        pos[j] = np.arange(Sb, dtype=np.int32) - (Sb - T)
    args = (torch.as_tensor(toks, device=dev), torch.as_tensor(pos,
                                                               device=dev))
    extra = torch.as_tensor(np.stack([r.extra for r in chunk]), device=dev)
    slots = torch.arange(4, device=dev)

    def run():
        runner.prefill(*args, engine.cache, slots, extra=extra)

    torch.cuda.synchronize()
    t = time.perf_counter()
    run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = report_profile(torch, prof, 1, wall_ms, f"{ENCDEC_ARCH} prefill "
                          f"of 4 requests ({4 * extra.shape[1]} encoder "
                          f"rows, 4 x {Sb} decoder rows)")
    bc_ms = sum(ns for key, (ns, _) in device_kernels(torch, prof).items()
                if "bc_matmul" in key) / 1e6
    gp_ms = time_ms(torch, lambda: runner.place_state(
        engine.cache, runner.gather_state(engine.cache, slots), slots),
        runs=10)
    print(f"  bc_matmul {bc_ms!r} ms of the prefill; gather + place of 4 "
          f"slots' state (self rings and {engine.cfg.n_layers} cross caches "
          f"of {extra.shape[1]} frames): {gp_ms!r} ms of device time")
    return dict(prefill_wall_ms=wall_ms, prefill_busy_ms=busy,
                prefill_bc_matmul_ms=bc_ms, gather_place_ms=gp_ms)


def phase_encdec(torch, kernel, dev):
    """Full-width seamless-m4t-medium (12 encoder + 12 decoder layers)
    served through ``make_runner`` -> ``EncDecRunner``: the short traffic
    (8 greedy requests x 16 tokens), each request with seeded (4096, 1024)
    frames, with bc_matmul held to ENCDEC_LAUNCHES per prefill and decode
    step; a decode profile; a profiled 4-request prefill; the first
    request's prefill twice on the card (bit-identical) and against the
    CPU; the cross-cache check. Returns (report row, the row counts
    launched)."""
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.serve.engine import Request, ServeEngine
    from repro_torch.serve.runner import EncDecRunner
    import numpy as np

    cfg = serve_cfg(ENCDEC_ARCH)
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), seed=0, device=dev)
    engine = ServeEngine(model, cfg, params, batch=4,
                         cache_len=ENCDEC_CACHE_LEN)
    del params
    torch.cuda.synchronize()
    per_prefill, per_decode = encdec_launches(model)
    if (per_prefill, per_decode) != ENCDEC_LAUNCHES:
        fail(f"{ENCDEC_ARCH}: the model has {per_prefill}/{per_decode} "
             f"bc_matmul launches per prefill/decode step, expected "
             f"{ENCDEC_LAUNCHES}")
    if type(engine.runner) is not EncDecRunner:
        fail(f"{ENCDEC_ARCH}: served by {type(engine.runner).__name__}")
    print(f"{ENCDEC_ARCH} full width ({cfg.n_enc_layers} encoder + "
          f"{cfg.n_layers} decoder layers, d_model {cfg.d_model}, d_ff "
          f"{cfg.d_ff}, vocab {cfg.vocab}, enc_seq {cfg.enc_seq}, "
          f"{cfg.compute_dtype}, impl={cfg.swm.impl}): built, initialized "
          f"and frozen in {time.perf_counter() - t0:.2f}s; frozen table "
          f"bytes {engine.frozen_table_bytes()}; device memory allocated "
          f"{torch.cuda.memory_allocated(dev)}; runner "
          f"{type(engine.runner).__name__}, {per_prefill} bc_matmul "
          f"launches per prefill, {per_decode} per decode step")
    reqs = short_requests(cfg)
    warm, *frames = encdec_frames(cfg, len(reqs) + 1)
    for r, f in zip(reqs, frames):
        r.extra = f
    engine.generate([Request(np.arange(4, dtype=np.int32), max_new=2,
                             extra=warm)])

    outs, serve = serve_counted(torch, kernel, engine, reqs, per_prefill,
                                ENCDEC_ARCH, per_decode=per_decode)
    s = engine.stats
    busy = phase_profile(torch, engine, reqs, serve["step_ms"])
    prof = encdec_prefill_profile(torch, engine, reqs)
    rows = ({b * t for b, t in s.prefill_shapes}
            | {b * cfg.enc_seq for b, _ in s.prefill_shapes}
            | set(s.decode_shapes) | {1})
    row = dict(model=ENCDEC_ARCH, enc_layers=cfg.n_enc_layers,
               layers=cfg.n_layers, requests=len(reqs),
               tokens=serve["tokens"], seconds=serve["seconds"],
               tokens_per_s=serve["tokens"] / serve["seconds"],
               decode_ms_per_step=serve["step_ms"],
               device_busy_ms_per_step=busy,
               device_idle_share=(None if busy is None
                                  else 1 - busy / serve["step_ms"]),
               launches=serve["launches"],
               launches_per_prefill=per_prefill,
               launches_per_decode=per_decode, prefills=serve["prefills"],
               decode_steps=serve["decodes"],
               frozen_table_bytes=engine.frozen_table_bytes(),
               device_memory_allocated=torch.cuda.memory_allocated(dev),
               prefill_shapes=sorted(s.prefill_shapes),
               decode_shapes=sorted(s.decode_shapes), **prof)

    served = engine.runner.model
    toks = torch.as_tensor(reqs[0].prompt, dtype=torch.long,
                           device=dev)[None]
    f0 = torch.as_tensor(reqs[0].extra, device=dev)[None]
    rows.add(toks.shape[1])
    e, planted, more = cross_check(torch, cfg, engine.params, reqs[0].prompt,
                                   reqs[0].extra, outs[0], dev)
    rows |= more
    frozen = engine.params
    del engine, model
    torch.cuda.empty_cache()
    # the CPU pass runs the full depth (12.8 s on an H100 host, PERF.md §4)
    with torch.no_grad():
        card = served.forward(f0, toks, logits_mode="last")[0]
        again = served.forward(f0, toks, logits_mode="last")[0]
    torch.cuda.synchronize()
    if not torch.equal(card, again):
        fail(f"{ENCDEC_ARCH}: two prefills of one request on the card "
             f"differ")
    del served
    torch.cuda.empty_cache()
    card_vs_cpu(torch, cfg, frozen, toks, card, ENCDEC_ARCH, frames=f0)
    del frozen
    torch.cuda.empty_cache()
    row.update(cross_rel_err=e, cross_planted_fault_rel_err=planted)
    return row, rows


def phase_examples(torch, kernel, dev):
    """The paper's two examples on the card: ``train_one`` at block size 8
    for EXAMPLE_STEPS AdamW steps each (finite losses, the last 5 below the
    first 5), with launches held to EXAMPLE_LAUNCHES, and their times.
    Returns report rows."""
    from repro_torch.examples import lstm_asr, train_mnist_swm

    out = []
    for name, mod in (("train_mnist_swm", train_mnist_swm),
                      ("lstm_asr", lstm_asr)):
        torch.cuda.synchronize()
        kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
        t = time.perf_counter()
        acc, n, losses = mod.train_one(8, EXAMPLE_STEPS, device=dev)
        dt = time.perf_counter() - t
        launches = dict(kernel.LAUNCHES)
        per_step, per_eval = EXAMPLE_LAUNCHES[name]
        want = {kname: per_step[i] * EXAMPLE_STEPS
                + per_eval[i] * len(mod.EVAL_STEPS)
                for i, kname in enumerate(("bc_matmul", "bc_dw"))}
        if {kname: launches[kname] for kname in want} != want:
            fail(f"example {name}: launches {launches}, expected {want}")
        first, last = losses[:5], losses[-5:]
        if not all(math.isfinite(v) for v in losses) or not (
                sum(last) < sum(first)):
            fail(f"example {name}: losses {losses}")
        print(f"example {name} (k=8, {EXAMPLE_STEPS} steps on the card): "
              f"loss {losses[0]!r} -> {losses[-1]!r}, accuracy {acc!r}, "
              f"{n} params, {dt:.2f}s ({dt / EXAMPLE_STEPS * 1e3:.1f} "
              f"ms/step incl. evaluation); launches {launches}")
        out.append(dict(example=name, block_size=8, steps=EXAMPLE_STEPS,
                        seconds=dt, loss_first=losses[0],
                        loss_last=losses[-1], accuracy=acc,
                        launches=launches))
    return out


# ---------------------------------------------------------------------------
# Training the MoE, vlm and enc-dec families (the ninth slice's path)
# ---------------------------------------------------------------------------

# the depth each arch trains at (None: full depth). qwen3-moe's 94 layers
# are all one kind (attention + a 128-expert MoE) and its full model (235 B
# params, with AdamW's moments) does not fit one card, so it trains a
# 2-layer cut as its serve path does: every layer kind and every grouped
# expert launch stay, at full width. arctic-480b's 35 layers are all one
# kind too (attention, the 128-expert MoE and its dense residual SwiGLU);
# its full model stores 4.21 B params (launch.specs.count_params), whose
# AdamW state is about 50 GB on the card and again in host memory for the
# card-vs-CPU step, which runs the same cut. So it trains the 2-layer cut
# that its serve path compares against the CPU. jamba-v0.1-52b and
# rwkv6-7b train one 8-layer period (jamba's 7 Mamba + 1 attention layers,
# 4 of them with the MoE; rwkv6's single layer kind), the cut their
# card-vs-CPU step compares: every projection shape and row count of the
# full depth, at a quarter of its host time (a full-depth step took
# 11.6-21.9 s, the scans' ~260-330k small kernels, on an NVIDIA H100 80GB
# HBM3 at 700 W; their warm-up, counted and profiled steps ~155 s of the
# command)
TRAIN_FAMILY_DEPTH = {"qwen3-moe-235b-a22b": 2, "paligemma-3b": None,
                      "seamless-m4t-medium": None, "jamba-v0.1-52b": 8,
                      "rwkv6-7b": 8, "arctic-480b": 2}
# (bc_matmul, bc_dw) launches per train step, pinned. remat="block" in
# every config: each launch of a forward runs again in the layer's
# recompute and once more as dx on the transposed grid (3 per projection),
# a MoE layer's three grouped expert projections once more in the experts'
# own recompute, and each projection takes one bc_dw. qwen3-moe 2 x (3 x 5
# + 3) and 2 x 5; paligemma 3 x 90 and 90; seamless 3 x 144 and 144; jamba
# (8 layers) 3 x 40 + 3 x 4 MoE layers and 40; rwkv6 (8 layers) 3 x 64 and
# 64; arctic 2 x (3 x 8 + 3) and 2 x 8. ``train_family_launches`` derives the same counts
# from the built model
TRAIN_FAMILY_LAUNCHES = {"qwen3-moe-235b-a22b": (36, 10),
                         "paligemma-3b": (270, 90),
                         "seamless-m4t-medium": (432, 144),
                         "jamba-v0.1-52b": (132, 40),
                         "rwkv6-7b": (192, 64),
                         "arctic-480b": (54, 16)}
# batch 8 x seq 256: 2048 token rows; paligemma's 256-position image prefix
# makes 8 x 512 = 4096; seamless's frames are min(256, enc_seq) = 256 per
# row (launch.specs.batch_specs), 2048 encoder rows; an expert's capacity
# C = int(2048 x top_k / E x 1.25): qwen3-moe 160 rows (top 8 of 128),
# jamba 320 (top 2 of 16), arctic 40 (top 2 of 128)
TRAIN_FAMILY_BATCH = (8, 256)
# counted steps where not TRAIN_STEPS: a step of jamba or rwkv6 is host
# time (their scans' ~65-80k small kernels per 8-layer step), so they count
# 2 steps after the warm-up
TRAIN_FAMILY_STEPS = {"jamba-v0.1-52b": 2, "rwkv6-7b": 2}
MOE_CAPACITY = 160
# the depth of the card-vs-CPU train step where not the trained depth.
# jamba's and rwkv6's trained 8-layer period is also the compared one: at
# 32 layers a CPU step takes 20-45 s, and rwkv6's bf16 backward amplifies
# rounding with depth (on an NVIDIA H100 80GB HBM3 at 700 W its 32-layer
# bf16 grad norms read 9.1106 on the card and 8.5920 on the CPU, rel
# 6.0e-2, losses within 1e-4, where in f32 they agree to 2.4e-6 and at 8
# layers in bf16 to 1.5e-4; PERF.md §6). paligemma-3b and
# seamless-m4t-medium compare 2-layer cuts (seamless: 2 encoder + 2
# decoder layers): their full-depth CPU steps took 25.6-28.1 s and 5.1-6.2
# s of a run whose host speed moves its total by a quarter
TRAIN_FAMILY_CPU_DEPTH = {"paligemma-3b": 2, "seamless-m4t-medium": 2}
JAMBA_CAPACITY = 320
ARCTIC_CAPACITY = 40
# per arch, (name, groups, p, q, rows, bc_matmul launches, bc_dw launches)
# per step of every shape the path launches at k = 128: each projection's
# (p, q) with its forward and recompute launches and its bc_dw, and its dx
# on the transposed (q, p) grid. Each arch's rows sum to
# TRAIN_FAMILY_LAUNCHES
TRAIN_FAMILY_SHAPES = {
    "qwen3-moe-235b-a22b": [
        ("qwen3_moe.qkv", 1, 72, 32, 2048, 4, 2),
        ("qwen3_moe.qkv.dx", 1, 32, 72, 2048, 2, 0),
        ("qwen3_moe.o", 1, 32, 64, 2048, 4, 2),
        ("qwen3_moe.o.dx", 1, 64, 32, 2048, 2, 0),
        ("qwen3_moe.expert.wi_wu", 128, 12, 32, MOE_CAPACITY, 12, 4),
        ("qwen3_moe.expert.wi_wu.dx", 128, 32, 12, MOE_CAPACITY, 4, 0),
        ("qwen3_moe.expert.wo", 128, 32, 12, MOE_CAPACITY, 6, 2),
        ("qwen3_moe.expert.wo.dx", 128, 12, 32, MOE_CAPACITY, 2, 0)],
    "paligemma-3b": [
        ("paligemma.qkv", 1, 20, 16, 4096, 36, 18),
        ("paligemma.qkv.dx", 1, 16, 20, 4096, 18, 0),
        ("paligemma.o", 1, 16, 16, 4096, 54, 18),      # o and its dx
        ("paligemma.wi_wu", 1, 128, 16, 4096, 90, 36),  # and wo's dx
        ("paligemma.wo", 1, 16, 128, 4096, 72, 18)],    # and wi_wu's dx
    "seamless-m4t-medium": [
        ("encdec.qkv", 1, 24, 8, 2048, 48, 24),
        ("encdec.qkv.dx", 1, 8, 24, 2048, 24, 0),
        ("encdec.proj", 1, 8, 8, 2048, 216, 72),       # and their dx
        ("encdec.wi", 1, 32, 8, 2048, 72, 24),         # and wo's dx
        ("encdec.wo", 1, 8, 32, 2048, 72, 24)],        # and wi's dx
    "jamba-v0.1-52b": [
        ("jamba.qkv", 1, 48, 32, 2048, 2, 1),
        ("jamba.qkv.dx", 1, 32, 48, 2048, 1, 0),
        ("jamba.o", 1, 32, 32, 2048, 3, 1),             # o and its dx
        ("jamba.in_proj", 1, 128, 32, 2048, 14, 7),
        ("jamba.in_proj.dx", 1, 32, 128, 2048, 7, 0),
        ("jamba.out_proj", 1, 32, 64, 2048, 14, 7),
        ("jamba.out_proj.dx", 1, 64, 32, 2048, 7, 0),
        ("jamba.wi_wu", 1, 112, 32, 2048, 20, 8),       # and wo's dx
        ("jamba.wo", 1, 32, 112, 2048, 16, 4),          # and wi_wu's dx
        ("jamba.expert.wi_wu", 16, 112, 32, JAMBA_CAPACITY, 28, 8),
        ("jamba.expert.wo", 16, 32, 112, JAMBA_CAPACITY, 20, 4)],
    "rwkv6-7b": [
        ("rwkv.rkvgo_wr", 1, 32, 32, 2048, 144, 48),    # and their dx
        ("rwkv.wk", 1, 112, 32, 2048, 24, 8),           # and wv's dx
        ("rwkv.wv", 1, 32, 112, 2048, 24, 8)],          # and wk's dx
    "arctic-480b": [
        ("arctic.qkv", 1, 72, 56, 2048, 4, 2),
        ("arctic.qkv.dx", 1, 56, 72, 2048, 2, 0),
        ("arctic.o", 1, 56, 56, 2048, 6, 2),            # o and its dx
        ("arctic.wi_wu", 1, 38, 56, 2048, 10, 4),       # and wo's dx
        ("arctic.wo", 1, 56, 38, 2048, 8, 2),           # and wi_wu's dx
        ("arctic.expert.wi_wu", 128, 38, 56, ARCTIC_CAPACITY, 14, 4),
        ("arctic.expert.wo", 128, 56, 38, ARCTIC_CAPACITY, 10, 2)]}
# the card-vs-CPU train step's batch (qwen3-0.6b's and each train_family
# arch's): 2 x 32 tokens from other seeded params (a CPU pass at batch 8 x
# 256 would take minutes); paligemma keeps its 256-position image prefix,
# seamless's frames are min(32, 4096) = 32
CPU_STEP_BATCH = (2, 32)
# the ragged grouped bc_dw check: (G, B, P, Q); 37 rows leave a ragged last
# row chunk
GROUPED_DW_RAGGED = (3, 37, 12, 32)


def train_family_launches(model, cfg):
    """(bc_matmul, bc_dw) launches per train step read off the built model
    (see TRAIN_FAMILY_LAUNCHES)."""
    from repro_torch.nn.moe import MoE

    per_forward = (encdec_launches(model)[0] if cfg.family == "encdec"
                   else hybrid_launches(model))
    passes = 3 if cfg.remat != "none" else 2     # forward, recompute, dx
    moe = sum(isinstance(m, MoE) for m in model.modules())
    return passes * per_forward + 3 * moe, per_forward


def family_batch(torch, cfg, B, S, seed, dev):
    """A training batch in ``launch.specs.batch_specs``' shapes and dtypes:
    ``SyntheticLM`` tokens (``seed``) and, for a vlm or an enc-dec model,
    an ``img`` or ``frames`` tensor of standard normals from a generator
    seeded with ``seed``, made on the CPU and moved to ``dev``."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.specs import batch_specs

    specs = batch_specs(cfg, ShapeConfig("train_family", S, B, "train"))
    gen = torch.Generator().manual_seed(seed)
    batch = {}
    for name, (shape, dtype) in specs.items():
        if name == "tokens":
            t = torch.from_numpy(SyntheticLM(vocab=cfg.vocab, seq_len=S,
                                             batch=B, seed=seed).batch_np(
                                                 0)["tokens"])
        else:
            t = torch.randn(shape, generator=gen).to(dtype)
        if tuple(t.shape) != shape or t.dtype != dtype:
            fail(f"batch {name}: {tuple(t.shape)} {t.dtype}, specs say "
                 f"{shape} {dtype}")
        batch[name] = t.to(dev)
    return batch


def train_step_card_vs_cpu(torch, cfg, dev, name):
    """One full-width train step at CPU_STEP_BATCH on the card and, queued
    on CPU_CHECKS under ("train", ``name``), on the CPU from the same
    seeded params (seed 1) and batch (``family_batch``, seed 1): loss and
    grad norm within FULL_WIDTH_TOL; its result is (rel err of the loss,
    of the grad norm, CPU seconds). Both are the step's readings before its
    optimizer update (the loss and the norm ``clip_by_global_norm``
    reports), so the step runs as far as ``value_and_grad`` and
    ``global_norm``: the update, which neither reading sees, would cost the
    CPU seconds over the full param tree."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, tree_leaves
    from repro_torch.optim.optimizers import global_norm
    from repro_torch.train.loop import make_loss_fn, value_and_grad

    tcfg = TrainConfig()
    card_params = init_params(build_model(cfg, device=dev).specs(), seed=1,
                              device=dev)
    cpu_params = to_device(card_params, "cpu")
    B, S = CPU_STEP_BATCH
    batch = family_batch(torch, cfg, B, S, 1, "cpu")

    def step(d, params):
        t = time.perf_counter()
        model = build_model(cfg, device=d)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        (loss, _), grads = value_and_grad(
            make_loss_fn(model, cfg, tcfg), params,
            {k: v.to(d) for k, v in batch.items()}, has_aux=True)
        return float(loss), float(global_norm(grads)), time.perf_counter() - t

    lc, nc, _ = step(dev, card_params)
    del card_params
    torch.cuda.empty_cache()

    def cpu_half():
        lp, npu, secs = step("cpu", cpu_params)
        el, en = abs(lc - lp) / abs(lp), abs(nc - npu) / abs(npu)
        depth = (f"{cfg.n_enc_layers} + {cfg.n_layers}" if cfg.n_enc_layers
                 else cfg.n_layers)
        print(f"{name} card vs cpu train step ({depth} layers at full "
              f"width, {cfg.param_dtype} params, {cfg.compute_dtype} "
              f"compute, batch {B} x seq {S}): loss {lc!r} vs {lp!r} (rel "
              f"{el:.3g}), grad norm {nc!r} vs {npu!r} (rel {en:.3g}); "
              f"tolerance {FULL_WIDTH_TOL}; cpu step {secs:.1f}s")
        if not (el <= FULL_WIDTH_TOL and en <= FULL_WIDTH_TOL):
            fail(f"{name}: card vs cpu train step differs beyond the "
                 f"tolerance")
        return el, en, secs

    CPU_CHECKS.submit(("train", name), cpu_half)

def phase_train_family(torch, kernel, dev, arch):
    """``arch`` trained on the card at full width through
    ``make_train_step`` with ``impl="pallas"`` (AdamW, its config's
    remat="block", batch TRAIN_FAMILY_BATCH from ``family_batch``): one
    warm-up step, then TRAIN_FAMILY_STEPS counted steps with both kernels'
    counts set to 0 just before and read just after, held to
    TRAIN_FAMILY_LAUNCHES; a profiled step (device kernels only: the CPU
    side of a profile of the scans' ~400k kernels would take minutes);
    then one step on the card against the CPU. Returns a report row."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, tree_leaves
    from repro_torch.train.loop import init_train_state, make_train_step

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    cfg = serve_cfg(arch)
    if TRAIN_FAMILY_DEPTH[arch] is not None:
        cfg = cut_depth(cfg, TRAIN_FAMILY_DEPTH[arch])
    steps = TRAIN_FAMILY_STEPS.get(arch, TRAIN_STEPS)
    tcfg = TrainConfig()
    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), seed=0, device=dev)
    state = init_train_state(params, tcfg, cfg.optimizer)
    step_fn = make_train_step(model, cfg, tcfg)
    derived = train_family_launches(model, cfg)
    if derived != TRAIN_FAMILY_LAUNCHES[arch]:
        fail(f"{arch}: the model has {derived} (bc_matmul, bc_dw) launches "
             f"per train step, expected {TRAIN_FAMILY_LAUNCHES[arch]}")
    B, S = TRAIN_FAMILY_BATCH
    batches = [family_batch(torch, cfg, B, S, i, dev)
               for i in range(steps + 2)]
    n_params = sum(p.numel() for p in tree_leaves(params))
    torch.cuda.synchronize()
    built_s = time.perf_counter() - t0
    t = time.perf_counter()
    state, m = step_fn(state, batches[0])          # warm-up; lr(0) = 0
    loss0 = float(m["loss"])
    warm_s = time.perf_counter() - t
    kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
    losses, norms, step_ms = [], [], []
    for i in range(1, steps + 1):
        t = time.perf_counter()
        state, m = step_fn(state, batches[i])
        losses.append(float(m["loss"]))          # waits for the device
        norms.append(float(m["grad_norm"]))
        step_ms.append((time.perf_counter() - t) * 1e3)
    launches = dict(kernel.LAUNCHES)
    mm, dw = TRAIN_FAMILY_LAUNCHES[arch]
    want = {"bc_matmul": mm * steps, "bc_dw": dw * steps}
    if not all(math.isfinite(v) for v in losses + norms + [loss0]):
        fail(f"{arch}: non-finite train loss or grad norm: {losses} "
             f"{norms}")
    if launches != want:
        fail(f"{arch}: train launches {launches} != {want}")
    ms = statistics.median(step_ms)
    tokens = B * S
    peak = torch.cuda.max_memory_allocated(dev)
    extra = {k: tuple(v.shape) for k, v in batches[0].items()
             if k != "tokens"}
    depth = (f"{cfg.n_enc_layers} + {cfg.n_layers}" if cfg.n_enc_layers
             else f"{cfg.n_layers} of {get_full_depth(arch)}")
    print(f"train_family {arch}: full width ({depth} layers, d_model "
          f"{cfg.d_model}, d_ff {cfg.d_ff_expert or cfg.d_ff}, experts "
          f"{cfg.n_experts}, vocab {cfg.vocab}, remat={cfg.remat!r}, "
          f"impl={cfg.swm.impl}, {n_params} params), AdamW, batch {B} x "
          f"seq {S} = {tokens} tokens/step{'' if not extra else ' + '}"
          f"{extra or ''}; built in {built_s:.1f}s; "
          f"warm-up step {warm_s:.2f}s (loss {loss0!r}); steps 1..."
          f"{steps}: losses {losses}, grad norms {norms}, ms/step "
          f"{step_ms} (median {ms:.1f} = {tokens / ms * 1e3:.1f} tokens/s); "
          f"launches {launches} = {want}; peak device memory {peak}")

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step_fn(state, batches[steps + 1])
        torch.cuda.synchronize()
    busy = report_profile(torch, prof, 1, ms, f"{arch} train step (batch "
                          f"{B} x seq {S}; wall = the median unprofiled "
                          f"step)")
    del state, params, model, step_fn, batches, prof
    torch.cuda.empty_cache()
    train_step_card_vs_cpu(
        torch, cut_depth(cfg, TRAIN_FAMILY_CPU_DEPTH[arch])
        if arch in TRAIN_FAMILY_CPU_DEPTH else cfg, dev, arch)
    return dict(model=arch, layers=cfg.n_layers,
                enc_layers=cfg.n_enc_layers,
                full_layers=get_full_depth(arch), batch=B, seq=S,
                tokens_per_step=tokens, ms_per_step=step_ms,
                median_ms_per_step=ms, tokens_per_s=tokens / ms * 1e3,
                device_busy_ms_per_step=busy,
                device_idle_share=None if busy is None else 1 - busy / ms,
                launches=launches, launches_per_step={
                    "bc_matmul": mm, "bc_dw": dw},
                losses=losses, grad_norms=norms, params=n_params,
                peak_device_memory=peak,
                cpu_vs_card_layers=TRAIN_FAMILY_CPU_DEPTH.get(
                    arch, cfg.n_layers))


def phase_train_family_dw(torch, kernel, dev):
    """bc_dw against its plain version at every weight-adjoint shape the
    train_family path launches, at its rows (the 128-expert adjoints
    grouped, G = 128, at the capacity's 160 rows), and at the ragged
    grouped case GROUPED_DW_RAGGED: f32 and bf16 inputs, both epilogues,
    each launched twice (bit-identical). Returns the max abs error of the
    f32 checks."""
    gen = torch.Generator(device=dev).manual_seed(14)
    cases = sorted({(G, B, p, q) for shapes in TRAIN_FAMILY_SHAPES.values()
                    for _, G, p, q, B, _, dw in shapes if dw}
                   | {GROUPED_DW_RAGGED})
    worst_abs = 0.0
    for G, B, P, Q in cases:
        lead = (G,) if G > 1 else ()
        x32 = torch.randn(*lead, B, Q * K, generator=gen, device=dev)
        g32 = torch.randn(*lead, B, P * K, generator=gen, device=dev)
        worst_abs = max(worst_abs, check_dw(torch, kernel, x32, g32, P, Q,
                                            K, f"G={G}"))
    n_checks = 4 * len(cases)
    print(f"train_family bc_dw checks: {n_checks} passed at (G, B, P, Q) "
          f"{cases}, k = {K}, both epilogues, f32 and bf16 inputs (rel <= "
          f"{FP32_TOL} x max(1, B/{DW_TOL_ROWS}); repeat launches "
          f"bit-identical); max abs err (f32) = {worst_abs!r}")
    return worst_abs


def phase_dw_group_times(torch, kernel, dev, cases, label="train_family"):
    """bc_dw device times at ``cases`` = [(name, groups, P, Q, rows,
    launches per step)], bf16 x and g, dw (G, P, Q·k) f32: the kernel, its
    plain version, the dense weight gradient ``gᵀ @ x`` (``torch.bmm`` over
    the groups, ``torch.matmul`` for one; a yardstick the port never calls)
    and the bound over every group."""
    gen = torch.Generator(device=dev).manual_seed(15)
    Kf = K // 2 + 1
    rows = []
    print(f"{label} bc_dw device times (bf16 x and g; median of 7-30 "
          "runs, CUDA events; bound as above over all groups; yardstick = "
          "the dense weight gradient g^T @ x, torch.bmm over the groups):")
    for name, G, P, Q, B, per in cases:
        x = torch.randn(G, B, Q * K, generator=gen, device=dev).bfloat16()
        g = torch.randn(G, B, P * K, generator=gen, device=dev).bfloat16()
        if G == 1:
            x, g = x[0], g[0]
            lib_fn = lambda: torch.matmul(g.T, x)
        else:
            lib_fn = lambda: torch.bmm(g.transpose(1, 2), x)
        ms = time_ms(torch, lambda: kernel.bc_dw(x, g, P=P, Q=Q, k=K))
        plain = time_ms(torch, lambda: kernel.bc_dw_plain(x, g, P=P, Q=Q,
                                                          k=K), runs=10)
        dense = time_ms(torch, lib_fn)
        nbytes = x.nbytes + g.nbytes + G * P * Q * K * 4
        flops = G * B * (2.5 * K * math.log2(K) * (P + Q) + 8 * P * Q * Kf)
        b_ms, b_by = bound(nbytes, flops)
        geo = kernel._dw_geometry(B, P, Q, K, G)
        geometry = (f"grid {geo.grid[0]}x{geo.grid[1]}x{geo.grid[2]} = "
                    f"{geo.grid[0] * geo.grid[1] * geo.grid[2]} blocks, tile "
                    f"{geo.p_tile} x {geo.q_tile}, thread {geo.p_per_thread}"
                    f" x {geo.q_per_thread}, {geo.rows_per_split} rows per "
                    f"split, {geo.rows} per chunk")
        rows.append(dict(shape=name, path="train_family", groups=G, B=B,
                         P=P, Q=Q, k=K, launches=per, ms=ms, plain_ms=plain,
                         library_ms=None, dense_dw_matmul_ms=dense,
                         bound_ms=b_ms, bound_by=b_by, bytes=nbytes,
                         flops=flops, geometry=geometry,
                         smem_bytes=geo.smem_bytes))
        print(f"  {name:24s} G={G:3d} P={P:3d} Q={Q:3d} B={B:4d}: kernel "
              f"{ms!r} ms, plain {plain!r} ms, "
              f"{'torch.bmm' if G > 1 else 'torch.matmul'} {dense!r} ms, "
              f"bound {b_ms!r} ms ({b_by}), {per} launches/step; "
              f"{geometry}, {geo.smem_bytes} B smem")
    return rows


# ---------------------------------------------------------------------------
# The scans' per-chunk recompute and the dft impl (the tenth slice's paths)
# ---------------------------------------------------------------------------

# one train step's forward and backward past 256 steps, with
# chunked_time_scan's per-chunk recompute on (as the mixers ask at S > 256)
# and forced off: 2-layer cuts at full width of jamba (layer 0 Mamba with
# its dense SwiGLU, layer 1 attention with the 16-expert MoE:
# attn_every=2, attn_offset=1) and rwkv6, batch 2 x seq 1024 (4 chunks of
# 256 steps)
REMAT_CUTS = {"jamba-v0.1-52b": dict(attn_every=2, attn_offset=1),
              "rwkv6-7b": {}}
REMAT_BATCH = (2, 1024)
# the dft impl against the freq impl (torch.fft, f32 inside) at qwen3-0.6b's
# projection shapes (SLICE_SHAPES) and its train rows. f32: FP32_TOL. bf16:
# the dft impl rounds four stages to bf16 in series (x̂ and ŵ, the per-bin
# sums, the inverse transform's output; the adjoints likewise), each by at
# most one unit roundoff, 2^-8, of the magnitudes it is computed from,
# where freq rounds once at its output: four unit roundoffs of the largest
# magnitude
DFT_ROWS = 2048
DFT_BF16_TOL = 2.0 ** -6
# the torch quickstart's steps on the card (its default), and the drop of
# its loss the example promises
QUICKSTART_STEPS = 200
QUICKSTART_DROP = 2.0


@contextlib.contextmanager
def scan_recompute_off():
    """The recurrent mixers' scans without the per-chunk recompute: both
    call ``chunked_time_scan`` by the name they import, which this swaps for
    a call with ``remat=False`` and puts back on the way out."""
    from repro_torch.nn import rwkv, scan, ssm

    def plain(step_fn, carry, xs, *, chunk=256, remat=True):
        return scan.chunked_time_scan(step_fn, carry, xs, chunk=chunk,
                                      remat=False)

    saved = ssm.chunked_time_scan, rwkv.chunked_time_scan
    ssm.chunked_time_scan = rwkv.chunked_time_scan = plain
    try:
        yield
    finally:
        ssm.chunked_time_scan, rwkv.chunked_time_scan = saved


def phase_scan_remat(torch, kernel, dev):
    """Peak device memory of one train step's forward and backward at
    REMAT_BATCH (``value_and_grad`` of the train loss; the optimizer update
    changes neither reading) with the scans' per-chunk recompute on and
    off, for each of REMAT_CUTS. The two runs' losses must be equal and
    their grads agree: bit for bit, or else within FP32_TOL with a second
    run without the recompute read beside them; their launches must equal
    ``train_family_launches``. Then the cut's recurrent layer alone
    (forward and input grad): its peak must be lower with the recompute.
    Returns report rows."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, tree_leaves
    from repro_torch.train.loop import make_loss_fn, value_and_grad

    B, S = REMAT_BATCH
    rows = []
    for arch, cut in REMAT_CUTS.items():
        cfg = dataclasses.replace(cut_depth(serve_cfg(arch), 2), **cut)
        tcfg = TrainConfig()
        model = build_model(cfg, device=dev)
        params = init_params(model.specs(), seed=0, device=dev)
        for p in tree_leaves(params):
            p.requires_grad_(True)
        loss_fn = make_loss_fn(model, cfg, tcfg)
        batch = family_batch(torch, cfg, B, S, 0, dev)
        mm, dw = train_family_launches(model, cfg)
        value_and_grad(loss_fn, params, batch, has_aux=True)   # warm-up
        out = {}
        for on in (True, False):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
            t = time.perf_counter()
            with contextlib.nullcontext() if on else scan_recompute_off():
                (loss, _), grads = value_and_grad(loss_fn, params, batch,
                                                  has_aux=True)
            torch.cuda.synchronize()
            secs = time.perf_counter() - t
            peak = torch.cuda.max_memory_allocated(dev)
            launches = dict(kernel.LAUNCHES)
            if launches != {"bc_matmul": mm, "bc_dw": dw}:
                fail(f"{arch} scan recompute {on}: launches {launches}, "
                     f"expected {mm} and {dw}")
            # the grads leave the card, so both runs start from one base
            out[on] = (float(loss), [g.cpu() for g in tree_leaves(grads)],
                       peak, base, secs)
            del grads
        (l1, g1, p1, b1, s1), (l0, g0, p0, b0, s0) = out[True], out[False]
        same = [torch.equal(a, b) for a, b in zip(g1, g0)]
        mixers = [layer.mixer_kind for layer in model._modules["layers"]]
        print(f"scan recompute, {arch} ({mixers}, full width, batch {B} x "
              f"seq {S}, value_and_grad of the train loss): peak device "
              f"memory {p1} B on, {p0} B off (above the {b1} B and {b0} B "
              f"held before each: {p1 - b1} and {p0 - b0}), "
              f"{(p0 - p1) / 2 ** 30:.3f} GiB saved; {s1:.2f}s on, "
              f"{s0:.2f}s off (after a warm-up run); loss {l1!r} / {l0!r}; "
              f"{sum(same)} of {len(same)} grads bit-identical; launches "
              f"{mm} / {dw} per run")
        on_off = max(rel_err(a, b) for a, b in zip(g1, g0))
        rerun = None
        if not all(same):
            # the reading's reason: a second run without the recompute
            # against the first shows how far the step itself repeats
            with scan_recompute_off():
                _, g2 = value_and_grad(loss_fn, params, batch, has_aux=True)
            rerun = max(rel_err(a.cpu(), b)
                        for a, b in zip(tree_leaves(g2), g0))
            print(f"  grads on vs off: max rel {on_off!r}; off vs a second "
                  f"off run: max rel {rerun!r} (limit {FP32_TOL})")
            del g2
        if on_off > FP32_TOL or l1 != l0:
            fail(f"{arch}: the scan recompute changed the loss or a grad")
        # the step's peak may be set elsewhere (the loss, attention); the
        # recurrent layer's own forward and backward show what the scan
        # keeps: its input grad alone, so no param grad is held
        layer = model._modules["layers"][0]
        x = torch.randn(B, S, cfg.d_model, device=dev).to(cfg.dtype)
        lpeak = {}
        for on in (True, False):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
            lbase = torch.cuda.memory_allocated(dev)
            xi = x.clone().requires_grad_()
            with contextlib.nullcontext() if on else scan_recompute_off():
                y = layer(xi, None)[0]
                torch.autograd.grad(y.float().square().mean(), xi)
            torch.cuda.synchronize()
            lpeak[on] = torch.cuda.max_memory_allocated(dev) - lbase
            del y, xi
        print(f"  its {layer.mixer_kind} layer alone (forward and input "
              f"grad at batch {B} x seq {S}): peak {lpeak[True]} B above "
              f"the held memory on, {lpeak[False]} B off "
              f"({(lpeak[False] - lpeak[True]) / 2 ** 30:.3f} GiB saved)")
        if not lpeak[True] < lpeak[False]:
            fail(f"{arch}: the scan recompute did not lower its layer's "
                 f"peak memory")
        rows.append(dict(model=arch, layers=mixers, batch=B, seq=S,
                         peak_on=p1, peak_off=p0, base_on=b1, base_off=b0,
                         seconds_on=s1, seconds_off=s0, loss=l1,
                         grads_bit_identical=sum(same), grads=len(same),
                         grads_on_off_max_rel=on_off,
                         grads_off_rerun_max_rel=rerun,
                         layer_peak_on=lpeak[True],
                         layer_peak_off=lpeak[False],
                         launches={"bc_matmul": 2 * mm, "bc_dw": 2 * dw}))
        del model, params, out, batch, g1, g0
        torch.cuda.empty_cache()
    return rows


def phase_dft(torch, kernel, dev, pallas_busy):
    """The dft impl on the card: ``block_circulant_apply(impl="dft")``
    forward and both grads against the freq impl at SLICE_SHAPES x
    DFT_ROWS rows, f32 and bf16, karatsuba off and on; full-width
    qwen3-0.6b trained with ``impl="dft"`` (batch 8 x seq 256: one warm-up
    and one timed step, a profiled step, no kernel of ours launched) and
    one step against the CPU; then the torch quickstart for
    QUICKSTART_STEPS steps, whose loss must drop by more than
    QUICKSTART_DROP. Returns a report row."""
    from repro_torch.configs.base import SWMConfig, TrainConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.core.circulant import block_circulant_apply
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.examples import quickstart
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.train.loop import init_train_state, make_train_step

    gen = torch.Generator(device=dev).manual_seed(18)
    worst = {torch.float32: 0.0, torch.bfloat16: 0.0}
    for name, p, q, _ in SLICE_SHAPES:
        x32 = torch.randn(DFT_ROWS, q * K, generator=gen, device=dev)
        w32 = torch.randn(p, q, K, generator=gen, device=dev) * (
            q * K) ** -0.5
        ct = torch.randn(DFT_ROWS, p * K, generator=gen, device=dev)
        for dtype, tol in ((torch.float32, FP32_TOL),
                           (torch.bfloat16, DFT_BF16_TOL)):
            out = {}
            for impl, kar in (("freq", False), ("dft", False),
                              ("dft", True)):
                x = x32.to(dtype).clone().requires_grad_()
                w = w32.to(dtype).clone().requires_grad_()
                y = block_circulant_apply(x, w, impl=impl, karatsuba=kar)
                (y.float() * ct).sum().backward()
                out[impl, kar] = (y.detach(), x.grad, w.grad)
            for kar in (False, True):
                errs = [rel_err(a, b) for a, b in zip(out["dft", kar],
                                                      out["freq", False])]
                if not max(errs) <= tol:
                    fail(f"dft {name} {dtype} karatsuba={kar}: rel err "
                         f"(y, dx, dw) {errs} > {tol}")
                worst[dtype] = max(worst[dtype], *errs)
    print(f"dft impl checks: forward, dx and dw against the freq impl at "
          f"{[(n, p, q) for n, p, q, _ in SLICE_SHAPES]} x {DFT_ROWS} rows, "
          f"k = {K}, karatsuba off and on: max rel err f32 "
          f"{worst[torch.float32]!r} (<= {FP32_TOL}), bf16 "
          f"{worst[torch.bfloat16]!r} (<= {DFT_BF16_TOL})")

    cfg = dataclasses.replace(CONFIG, swm=SWMConfig(block_size=128,
                                                    impl="dft"))
    tcfg = TrainConfig()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, device=dev)
    state = init_train_state(init_params(model.specs(), seed=0, device=dev),
                             tcfg, cfg.optimizer)
    step_fn = make_train_step(model, cfg, tcfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                       seed=0)
    batches = [{"tokens": torch.from_numpy(data.batch_np(i)["tokens"]).to(
        dev)} for i in range(3)]
    state, m = step_fn(state, batches[0])               # warm-up
    float(m["loss"])
    kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
    t = time.perf_counter()
    state, m = step_fn(state, batches[1])
    loss = float(m["loss"])
    ms = (time.perf_counter() - t) * 1e3
    launches = dict(kernel.LAUNCHES)
    if launches != {"bc_matmul": 0, "bc_dw": 0} or not math.isfinite(loss):
        fail(f"dft train step: launches {launches}, loss {loss}")
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn(state, batches[2])
        torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    busy = report_profile(torch, prof, 1, ms, f"qwen3-0.6b dft train step "
                          f"(batch {TRAIN_BATCH} x seq {TRAIN_SEQ})")
    print(f"dft train: qwen3-0.6b full width, impl='dft', AdamW, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}: step {ms:.1f} ms, loss "
          f"{loss!r}, device busy {busy} ms (the pallas path's: "
          f"{pallas_busy} ms), peak device memory {peak}; launches "
          f"{launches}")
    del state, model, step_fn, prof
    torch.cuda.empty_cache()
    train_step_card_vs_cpu(torch, cfg, dev, "qwen3-0.6b dft")
    el, en, secs = CPU_CHECKS.result(("train", "qwen3-0.6b dft"))

    t = time.perf_counter()
    counts, losses = quickstart.run(QUICKSTART_STEPS, device=dev)
    q_s = time.perf_counter() - t
    drop = losses[0] - losses[-1]
    print(f"quickstart on the card: {counts['stored']} stored params "
          f"({counts['compression']:.2f}x), {QUICKSTART_STEPS} steps in "
          f"{q_s:.1f}s, loss {losses[0]!r} -> {losses[-1]!r} (drop "
          f"{drop:.3f}, must exceed {QUICKSTART_DROP})")
    if not (all(math.isfinite(v) for v in losses)
            and drop > QUICKSTART_DROP):
        fail(f"quickstart: losses {losses[:3]} ... {losses[-3:]}")
    return dict(max_rel_err_f32=worst[torch.float32],
                max_rel_err_bf16=worst[torch.bfloat16], train_ms=ms,
                train_loss=loss, device_busy_ms_per_step=busy,
                pallas_device_busy_ms_per_step=pallas_busy,
                peak_device_memory=peak, cpu_vs_card_loss_rel_err=el,
                cpu_vs_card_grad_norm_rel_err=en, cpu_seconds=secs,
                quickstart_seconds=q_s, quickstart_loss_first=losses[0],
                quickstart_loss_last=losses[-1])


# ---------------------------------------------------------------------------
# The distribution and measurement layers (``dist`` phase)
# ---------------------------------------------------------------------------

# (a): full-width qwen3-0.6b, 3 steps with a world-1 mesh and 3 without
DIST_A_STEPS = 3
# (b): two gloo ranks on the one card, a 2-layer cut at full width in f32:
# two 28-layer f32 states per rank would not leave the phase its 60 s,
# and 2 layers hold every leaf kind (embedding, attention, SwiGLU, norms).
# Moments are held leaf by leaf (max |diff| over max |ref|); params over
# the whole tree (||diff|| / ||ref||): AdamW divides by sqrt(v) + 1e-8, so
# an element whose grad is near 1e-8 moves by an O(1) share of its update
# when the two batch splits round its sum differently (the per-leaf
# reading is printed beside it)
DIST_B_LAYERS = 2
DIST_B_TOL = 1e-5
# (c): the compressed all-reduce on the real grads of 3 batches
DIST_C_STEPS = 3
DIST_C_TOL = 1e-5
# (e): TrainDriver on the mesh: 2 layers, 4 steps, checkpoints every 2,
# a fault before step 3
DIST_E_LAYERS = 2
DIST_E_STEPS = 4
DIST_E_FAIL_AT = 3


def dist_rank_main(rank, port, q):
    """Part (b)'s rank: a gloo group of 2 on cuda:0 (NCCL refuses two
    ranks on one GPU), one data-parallel ZeRO-1 step on its half of the
    batch against one process's full-batch step, both in this process on
    the card; the relative differences go back through ``q``."""
    import torch
    import torch.distributed as dist

    out = {"rank": rank}
    try:
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        dev = torch.device("cuda", 0)
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=2, rank=rank)
        from repro_torch.configs.base import SWMConfig, TrainConfig
        from repro_torch.configs.qwen3_0_6b import CONFIG
        from repro_torch.data.pipeline import SyntheticLM
        from repro_torch.dist.sharding import local_shard
        from repro_torch.kernels.block_circulant import kernel
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.launch.specs import build_model
        from repro_torch.nn.module import init_params, tree_leaves
        from repro_torch.train.loop import init_train_state, make_train_step

        mesh = make_local_mesh(device="cpu")
        cfg = cut_depth(dataclasses.replace(
            CONFIG, swm=SWMConfig(block_size=128, impl="pallas"),
            param_dtype="float32", compute_dtype="float32"), DIST_B_LAYERS)
        tcfg = TrainConfig(warmup_steps=1)
        tokens = torch.from_numpy(SyntheticLM(
            vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
            seed=0).batch_np(0)["tokens"]).to(dev)

        def run(m):
            model = build_model(cfg, device=dev)
            step = make_train_step(model, cfg, tcfg, mesh=m)
            state = init_train_state(
                init_params(model.specs(), seed=0, device=dev), tcfg,
                opt_shardings=(step.data_parallel.state_shardings["opt"]
                               if m is not None else None), mesh=m)
            state["step"] = 1          # a step whose learning rate is > 0
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, {"tokens": tokens})
            loss = float(metrics["loss"])
            return state, step, loss, (time.perf_counter() - t) * 1e3

        kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
        mine, step, loss, ms = run(mesh)
        out["launches"] = dict(kernel.LAUNCHES)
        ref, _, ref_loss, ref_ms = run(None)
        specs = step.data_parallel.state_shardings["opt"]
        with torch.no_grad():
            pairs = list(zip(tree_leaves(mine["params"]),
                             tree_leaves(ref["params"])))
            out["rel_params_leaf"] = max(rel_err(a, b) for a, b in pairs)
            diff = sum(float((a.double() - b.double()).square().sum())
                       for a, b in pairs)
            norm = sum(float(b.double().square().sum()) for _, b in pairs)
            out["rel_params"] = math.sqrt(diff / norm)
            rel_m, n_cut = 0.0, 0
            for key in ("m", "v"):
                for a, b, spec in zip(tree_leaves(mine["opt"][key]),
                                      tree_leaves(ref["opt"][key]),
                                      tree_leaves(specs[key])):
                    want = local_shard(b, spec, mesh)
                    if a.shape != want.shape:
                        raise AssertionError(f"moment shard {tuple(a.shape)}"
                                             f" != {tuple(want.shape)}")
                    n_cut += a.shape != b.shape
                    rel_m = max(rel_m, rel_err(a, want))
        out.update(rel_moments=rel_m, moments_cut=n_cut, loss=loss,
                   ref_loss=ref_loss, ms=ms, ref_ms=ref_ms,
                   collectives=step.data_parallel.collectives,
                   rows=tokens.shape[0] // 2 * TRAIN_SEQ)
    except Exception as e:             # reported by the parent, which fails
        out["error"] = f"{type(e).__name__}: {e}"
    finally:
        q.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def dist_spawn():
    """Start part (b)'s two ranks (``spawn``: this process holds the
    card); returns (processes, queue)."""
    import socket

    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=dist_rank_main, args=(r, port, q))
             for r in range(2)]
    for p in procs:
        p.start()
    return procs, q


def dist_join(procs, q):
    """Part (b)'s gates, from both ranks' reports."""
    try:
        outs = sorted((q.get(timeout=120) for _ in procs),
                      key=lambda o: o["rank"])
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
    for o in outs:
        if "error" in o:
            fail(f"dist (b) rank {o['rank']}: {o['error']}")
        if not (o["rel_params"] <= DIST_B_TOL
                and o["rel_moments"] <= DIST_B_TOL and o["moments_cut"]):
            fail(f"dist (b) rank {o['rank']}: data-parallel step vs the "
                 f"full-batch step: params rel {o['rel_params']!r}, moments "
                 f"rel {o['rel_moments']!r} (limit {DIST_B_TOL}), "
                 f"{o['moments_cut']} moments cut")
    print(f"dist (b) two gloo ranks on cuda:0 (qwen3-0.6b cut to "
          f"{DIST_B_LAYERS} of 28 layers at full width, f32, AdamW, one "
          f"step at step 1 of the schedule, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ} split 2 ways; the cut because two 28-layer f32 "
          f"states per rank would not fit the phase's 60 s): "
          + "; ".join(
              f"rank {o['rank']}: params rel {o['rel_params']!r} over the "
              f"tree (leaf by leaf {o['rel_params_leaf']!r}), moments rel "
              f"{o['rel_moments']!r} ({o['moments_cut']} moments held "
              f"as half shards), loss {o['loss']!r} vs {o['ref_loss']!r}, "
              f"step {o['ms']:.1f} ms vs {o['ref_ms']:.1f} ms one-rank, "
              f"{o['collectives']} collectives (gloo, staged through host "
              f"memory), launches {o['launches']}" for o in outs)
          + f" (limit {DIST_B_TOL}; {CARD[0]})")
    return outs


def dist_mesh_step(torch, kernel, dev, mesh):
    """Part (a): full-width qwen3-0.6b, DIST_A_STEPS steps with the
    world-1 mesh against as many without, from the same seeded state and
    batches; params and moments bit-identical, launches pinned."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.base import SWMConfig, TrainConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, tree_leaves
    from repro_torch.train.loop import init_train_state, make_train_step

    cfg = dataclasses.replace(CONFIG, swm=SWMConfig(block_size=128,
                                                    impl="pallas"))
    tcfg = TrainConfig(warmup_steps=1)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                       seed=0)
    batches = [{"tokens": torch.from_numpy(data.batch_np(i)["tokens"]).to(
        dev)} for i in range(DIST_A_STEPS + 1)]
    per_step = {"bc_matmul": 3 * 5 * cfg.n_layers,
                "bc_dw": 5 * cfg.n_layers}
    out = {}
    for name, m in (("mesh", mesh), ("no mesh", None)):
        model = build_model(cfg, device=dev)
        step = make_train_step(model, cfg, tcfg, mesh=m)
        state = init_train_state(
            init_params(model.specs(), seed=0, device=dev), tcfg,
            opt_shardings=(step.data_parallel.state_shardings["opt"]
                           if m is not None else None), mesh=m)
        kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
        ms = []
        for b in batches[:DIST_A_STEPS]:
            torch.cuda.synchronize()
            t = time.perf_counter()
            state, metrics = step(state, b)
            float(metrics["loss"])
            ms.append((time.perf_counter() - t) * 1e3)
        launches = dict(kernel.LAUNCHES)
        want = {k: v * DIST_A_STEPS for k, v in per_step.items()}
        if launches != want:
            fail(f"dist (a) {name}: launches {launches} != {want}")
        leaves = [t.detach().clone() for part in ("params", "opt")
                  for t in tree_leaves(state[part])]
        coll = (step.data_parallel.collectives / DIST_A_STEPS
                if m is not None else 0)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            step(state, batches[DIST_A_STEPS])
            torch.cuda.synchronize()
        out[name] = dict(leaves=leaves, ms=statistics.median(ms),
                         busy=device_busy_ms(torch, prof), launches=launches,
                         collectives=coll, loss=float(metrics["loss"]))
        del model, state, step
    a, b = out["mesh"], out["no mesh"]
    same = len(a["leaves"]) == len(b["leaves"]) and all(
        torch.equal(x, y) for x, y in zip(a["leaves"], b["leaves"]))
    if not same or a["loss"] != b["loss"]:
        fail(f"dist (a): {DIST_A_STEPS} steps with the world-1 mesh are not "
             f"bit-identical to {DIST_A_STEPS} without (loss {a['loss']!r} "
             f"vs {b['loss']!r})")
    print(f"dist (a) world-1 NCCL mesh, qwen3-0.6b full width and depth, "
          f"remat='block', AdamW, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}: "
          f"{DIST_A_STEPS} steps with mesh= bit-identical to {DIST_A_STEPS} "
          f"without (params and moments); launches {a['launches']} = "
          f"{DIST_A_STEPS} x {per_step}; {a['collectives']:g} collectives "
          f"per step (the bucketed grad all-reduce, one param all-gather per "
          f"param dtype); "
          f"median wall {a['ms']:.1f} ms with the mesh vs {b['ms']:.1f} ms "
          f"without, device busy {a['busy']:.1f} vs {b['busy']:.1f} ms per "
          f"step (one profiled step each; {CARD[0]})")
    return dict(launches=a["launches"], ms=a["ms"], ms_no_mesh=b["ms"],
                busy=a["busy"], busy_no_mesh=b["busy"],
                collectives=a["collectives"])


def dist_compress(torch, dev, mesh):
    """Part (c): ``compressed_psum_grads`` over the world-1 mesh's data
    group on the real grads of DIST_C_STEPS batches (full-width
    qwen3-0.6b, f32 copies of the bf16 grads): per element |Q(g) - g| <=
    scale/2, and the error feedback telescopes."""
    from repro_torch.configs.base import SWMConfig, TrainConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.dist.compress import (CHUNK, compressed_psum_grads,
                                           int8_compress, int8_decompress)
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, tree_leaves, tree_map
    from repro_torch.train.loop import (init_train_state, make_loss_fn,
                                        value_and_grad)

    cfg = dataclasses.replace(CONFIG, swm=SWMConfig(block_size=128,
                                                    impl="pallas"))
    tcfg = TrainConfig()
    model = build_model(cfg, device=dev)
    state = init_train_state(init_params(model.specs(), seed=0, device=dev),
                             tcfg)
    loss_fn = make_loss_fn(model, cfg, tcfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                       seed=1)
    group = mesh.get_group("data")
    res = None
    sum_g = sum_tx = None
    worst, n, n_chunks = 0.0, 0, 0
    for i in range(DIST_C_STEPS):
        batch = {"tokens": torch.from_numpy(data.batch_np(i)["tokens"]).to(
            dev)}
        _, grads = value_and_grad(loss_fn, state["params"], batch,
                                  has_aux=True)
        grads = tree_map(lambda g: g.float(), grads)
        if res is None:
            res = tree_map(torch.zeros_like, grads)
        with torch.no_grad():
            for g, r in zip(tree_leaves(grads), tree_leaves(res)):
                c = g + r
                q, s = int8_compress(c)
                err = (int8_decompress(q, s, c.shape, c.numel()) - c).abs()
                pad = (-c.numel()) % CHUNK
                err = torch.nn.functional.pad(err.reshape(-1), (0, pad))
                # the quantizer's bound scale/2, plus the f32 roundings of
                # the quotient g/s and the product q·s (each <= 127 ulps
                # of 2^-24 relative to the scale)
                excess = (err.reshape(-1, CHUNK)
                          - s[:, None] * (0.5 + 256 * 2 ** -24)).max()
                worst = max(worst, float(excess))
                if i == 0:
                    n += c.numel()
                    n_chunks += s.numel()
            red, res = compressed_psum_grads(grads, res, group)
            sum_g = grads if sum_g is None else tree_map(
                torch.add, sum_g, grads)
            sum_tx = red if sum_tx is None else tree_map(
                torch.add, sum_tx, red)
    if worst > 0:
        fail(f"dist (c): an element's quantization error exceeds scale/2 "
             f"by {worst!r}")
    with torch.no_grad():
        tele = max(rel_err(tx + r, g) for tx, r, g in zip(
            tree_leaves(sum_tx), tree_leaves(res), tree_leaves(sum_g)))
    if not tele <= DIST_C_TOL:
        fail(f"dist (c): the error feedback does not telescope: rel "
             f"{tele!r} > {DIST_C_TOL}")
    wire, full = n_chunks * CHUNK + 4 * n_chunks, 4 * n
    print(f"dist (c) compressed_psum_grads on the real grads of "
          f"{DIST_C_STEPS} batches (qwen3-0.6b full width, {n} grad "
          f"elements): every |Q(g) - g| <= scale/2; sum(tx) + residual vs "
          f"sum(g) over {DIST_C_STEPS} steps rel {tele!r} (limit "
          f"{DIST_C_TOL}); payload {wire} B (int8 + f32 scale per {CHUNK}) "
          f"against {full} B f32 = {full / wire:.3f}x smaller (the "
          f"all-reduce itself carries the dequantized f32 sum, as the "
          f"reference's psum does)")
    return dict(telescope_rel=tele, payload_bytes=wire, f32_bytes=full)


def dist_freq_shmap(torch, dev, mesh):
    """Part (d): ``impl="freq_shmap"`` against ``freq`` at qwen3-0.6b's
    projection shapes under the ambient mesh; bit-identical."""
    from repro_torch.core import circulant as circ
    from repro_torch.dist.sharding import get_ambient_mesh

    if get_ambient_mesh() is not mesh:
        fail("dist (d): the train step did not set the ambient mesh")
    gen = torch.Generator(device=dev).manual_seed(21)
    for name, p, q, _ in SLICE_SHAPES:
        x = torch.randn(TRAIN_BATCH * TRAIN_SEQ, q * K, generator=gen,
                        device=dev)
        w = torch.randn(p, q, K, generator=gen, device=dev) * 0.03
        a = circ.block_circulant_apply(x, w, impl="freq_shmap")
        b = circ.block_circulant_apply(x, w, impl="freq")
        if not torch.equal(a, b):
            fail(f"dist (d): freq_shmap != freq at {name} ({p}, {q}, {K})")
    print(f"dist (d) freq_shmap == freq bit for bit at "
          f"{[(n, p, q, K) for n, p, q, _ in SLICE_SHAPES]} over "
          f"{TRAIN_BATCH * TRAIN_SEQ} rows under the mesh")


def dist_driver(torch, kernel, dev, mesh, tmp):
    """Part (e): ``TrainDriver(mesh=, state_shardings=)`` on a 2-layer
    full-width cut through a fault before step DIST_E_FAIL_AT, against an
    uninterrupted run on the same mesh; bit-identical."""
    from repro_torch.configs.base import SWMConfig, TrainConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.ft.driver import FaultInjector, TrainDriver
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, tree_leaves
    from repro_torch.train.loop import init_train_state, make_train_step

    cfg = cut_depth(dataclasses.replace(
        CONFIG, swm=SWMConfig(block_size=128, impl="pallas")), DIST_E_LAYERS)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                       seed=2)

    def batch(i):
        return {"tokens": torch.from_numpy(data.batch_np(i)["tokens"]).to(
            dev)}

    runs = {}
    for name, every, faults in (
            ("resumed", 2, FaultInjector(fail_at=(DIST_E_FAIL_AT,))),
            ("clean", DIST_E_STEPS + 1, None)):
        tcfg = TrainConfig(warmup_steps=1, checkpoint_every=every,
                           checkpoint_dir=str(Path(tmp) / name))
        model = build_model(cfg, device=dev)
        step = make_train_step(model, cfg, tcfg, mesh=mesh)
        shardings = step.data_parallel.state_shardings
        state = init_train_state(init_params(model.specs(), seed=0,
                                             device=dev), tcfg,
                                 opt_shardings=shardings["opt"], mesh=mesh)
        drv = TrainDriver(step, tcfg, batch, state_shardings=shardings,
                          mesh=mesh, fault_injector=faults)
        kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
        t = time.perf_counter()
        state = drv.run(state, n_steps=DIST_E_STEPS)
        torch.cuda.synchronize()
        runs[name] = dict(
            leaves=[x.detach().clone() for part in ("params", "opt")
                    for x in tree_leaves(state[part])],
            restarts=drv.restarts, launches=dict(kernel.LAUNCHES),
            steps=[m["step"] for m in drv.metrics_log],
            wall=time.perf_counter() - t)
        del model, state, step, drv
    a, b = runs["resumed"], runs["clean"]
    identical = all(torch.equal(x, y) for x, y in zip(a["leaves"],
                                                      b["leaves"]))
    if a["restarts"] != 1 or b["restarts"] != 0 or not identical:
        fail(f"dist (e): restarts {a['restarts']}/{b['restarts']}, resumed "
             f"vs uninterrupted bit-identical: {identical}")
    print(f"dist (e) TrainDriver(mesh=, state_shardings=) on qwen3-0.6b cut "
          f"to {DIST_E_LAYERS} layers at full width, fault before step "
          f"{DIST_E_FAIL_AT}, checkpoints every 2: steps run {a['steps']}, "
          f"1 restart, bit-identical to an uninterrupted run (params and "
          f"moments); launches {a['launches']} resumed, {b['launches']} "
          f"clean; wall {a['wall']:.2f} s vs {b['wall']:.2f} s")
    return dict(launches={k: a["launches"][k] + b["launches"][k]
                          for k in a["launches"]},
                steps=a["steps"], identical=identical)


def dist_analytic(train_busy, decode_busy, decode_ms, train_ms):
    """Part (f): ``cell_model(chips=1, dp=1, tp=1)`` and the roofline's
    compute and memory times with the card's constants, for the serve
    phase's decode step (4 rows against a 128-row cache) and the train
    phase's step, beside the busy ms those phases measured."""
    from repro_torch.configs.base import SWMConfig, ShapeConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.launch.analytic import cell_model
    from repro_torch.launch.roofline import HBM, PEAK

    cfg = dataclasses.replace(CONFIG, swm=SWMConfig(block_size=128,
                                                    impl="pallas"))
    out = {}
    for name, shape, busy, wall in (
            ("decode", ShapeConfig("serve decode", 128, 4, "decode"),
             decode_busy, decode_ms),
            ("train", ShapeConfig("train", TRAIN_SEQ, TRAIN_BATCH, "train"),
             train_busy, train_ms)):
        a = cell_model(cfg, shape, chips=1, dp=1, tp=1)
        tc, tm = a["a_flops_per_chip"] / PEAK, a["a_bytes_per_chip"] / HBM
        out[name] = dict(flops=a["a_flops"], bytes=a["a_bytes"],
                         compute_ms=tc * 1e3, memory_ms=tm * 1e3,
                         busy_ms=busy, wall_ms=wall)
        busy_txt = "not measured" if busy is None else f"{busy:.3f} ms"
        print(f"dist (f) analytic {name} step (qwen3-0.6b, "
              f"{shape.global_batch} x {shape.seq_len}, chips=1): "
              f"{a['a_flops']:.6e} FLOP, {a['a_bytes']:.6e} B -> compute "
              f"{tc * 1e3:.4f} ms at {PEAK:.3g} FLOP/s, memory "
              f"{tm * 1e3:.4f} ms at {HBM:.3g} B/s; measured device busy "
              f"{busy_txt}, wall {wall:.2f} ms ({CARD[0]})")
    return out


def phase_dist(torch, kernel, dev, train_busy, decode_busy, decode_ms,
               train_ms):
    """The distribution and measurement layers on the card, parts (a)-(f)
    (module docstring); (b)'s two ranks run beside (c)-(e). Returns
    (report row, launches, bc_matmul row counts)."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch.dist.sharding import set_ambient_mesh
    from repro_torch.launch.mesh import make_local_mesh

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dist_")
    try:
        mesh = make_local_mesh()
        a = dist_mesh_step(torch, kernel, dev, mesh)
        procs, q = dist_spawn()
        c = dist_compress(torch, dev, mesh)
        dist_freq_shmap(torch, dev, mesh)
        e = dist_driver(torch, kernel, dev, mesh, tmp)
        b = dist_join(procs, q)
        f = dist_analytic(train_busy, decode_busy, decode_ms, train_ms)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        set_ambient_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
    secs = time.perf_counter() - t_phase
    print(f"dist phase: {secs:.1f}s")
    launches = {k: a["launches"][k] + e["launches"][k]
                for k in a["launches"]}
    row = dict(mesh_step=a, compress=c, driver=e, two_ranks=b, analytic=f,
               seconds=secs)
    return row, launches, {b[0]["rows"]}


# ---------------------------------------------------------------------------
# The analysis layer: registered ops, structural audits, lint
# ---------------------------------------------------------------------------

# (a)'s shapes: the fused QKV at decode (x (4, 1024) bf16, tables (32, 8,
# 65)) and its weight adjoint over 512 rows, single and grouped over 16
# groups (a 16-expert MoE layer's launch)
ANALYSIS_GROUPS = 16
ANALYSIS_DW_ROWS = 512


def analysis_opcheck(torch, kernel, dev):
    """(a) ``torch.library.opcheck`` on each op on the card."""
    gen = torch.Generator(device=dev).manual_seed(20)
    Kf = K // 2 + 1

    def rnd(*shape, dtype=torch.float32):
        return torch.randn(*shape, generator=gen, device=dev).to(dtype)

    cases = []
    for lead in ((), (ANALYSIS_GROUPS,)):
        cases.append(("bc_matmul", (rnd(*lead, 4, 8 * K,
                                        dtype=torch.bfloat16),
                                    rnd(*lead, 32, 8, Kf),
                                    rnd(*lead, 32, 8, Kf),
                                    rnd(*lead, 32 * K), None, K, "gelu")))
        for op in ("bc_dw", "bc_dw_freq"):
            cases.append((op, (rnd(*lead, ANALYSIS_DW_ROWS, 8 * K,
                                   dtype=torch.bfloat16),
                               rnd(*lead, ANALYSIS_DW_ROWS, 32 * K,
                                   dtype=torch.bfloat16), 32, 8, K)))
    for op, args in cases:
        res = torch.library.opcheck(kernel.OPS[op], args)
        if set(res.values()) != {"SUCCESS"}:
            fail(f"opcheck {op} {tuple(args[0].shape)}: {res}")
    print(f"analysis (a) opcheck on the card: {len(cases)} cases (bc_matmul, "
          f"bc_dw, bc_dw_freq at the qkv shape, single and G = "
          f"{ANALYSIS_GROUPS}): every test SUCCESS")
    return len(cases)


def analysis_serve(torch, engine):
    """(b) ``prewarm(audit=True)`` on the serve cell's engine: its audit
    captures every bucket once (no violation, 140 bc_matmul ops per
    forward, read from the captures the audit keeps), then the warm-up."""
    from repro_torch.analysis.contracts import launch_counts

    audit = engine.audit
    audit_ms = []

    def timed_audit(**kw):
        t = time.perf_counter()
        try:
            return audit(**kw)
        finally:
            torch.cuda.synchronize()
            audit_ms.append((time.perf_counter() - t) * 1e3)

    engine.audit = timed_audit          # times the audit inside prewarm
    try:
        t = time.perf_counter()
        n = engine.prewarm(audit=True)
        torch.cuda.synchronize()
        prewarm_ms = (time.perf_counter() - t) * 1e3
    finally:
        del engine.audit
    want = engine.max_prefill_variants + engine.max_decode_variants
    if n != want or len(audit_ms) != 1:
        fail(f"prewarm(audit=True) warmed {n} shapes, not {want}, after "
             f"{len(audit_ms)} audits")
    counts = launch_counts(engine, engine.audit_traces)
    per_forward = 5 * engine.cfg.n_layers
    if len(counts) != want or set(counts.values()) != {per_forward}:
        fail(f"serve audit: bc_matmul ops per bucket {counts} != "
             f"{per_forward} in each of {want}")
    print(f"analysis (b) prewarm(audit=True) (qwen3-0.6b full width, 28 "
          f"layers, bf16, impl=pallas): {len(counts)} buckets audited, 0 "
          f"violations, {per_forward} bc_matmul ops per forward in each; "
          f"audit wall {audit_ms[0]!r} ms, prewarm(audit=True) "
          f"{prewarm_ms!r} ms for {n} shapes ({CARD[0]})")
    return dict(buckets=len(counts), audit_ms=audit_ms[0],
                prewarm_audit_ms=prewarm_ms, ops_per_forward=per_forward)


def analysis_train(torch, dev):
    """(c) ``make_train_step(audit_args=...)`` on the train cell, its
    default rules on one capture: NoFFT fires, at ``freq_weights`` only
    (the kernel impl's training forward transforms each time-domain
    table, in both packages); DenseFallbackDot, also a default rule,
    fires nothing; the capture (carried by the error) holds the
    backward's bc_dw launches (autograd's device thread reached)."""
    from repro_torch.analysis.contracts import StructuralContractError
    from repro_torch.configs.base import SWMConfig, TrainConfig
    from repro_torch.configs.qwen3_0_6b import CONFIG
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.train.loop import init_train_state, make_train_step

    cfg = dataclasses.replace(CONFIG, swm=SWMConfig(block_size=128,
                                                    impl="pallas"))
    tcfg = TrainConfig()
    model = build_model(cfg, device=dev)
    state = init_train_state(init_params(model.specs(), seed=0, device=dev),
                             tcfg, cfg.optimizer)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=TRAIN_BATCH,
                       seed=0)
    batch = {"tokens": torch.from_numpy(data.batch_np(0)["tokens"]).to(dev)}
    t = time.perf_counter()
    try:
        make_train_step(model, cfg, tcfg, audit_args=(state, batch))
        fail("the kernel impl's default train audit raised nothing")
    except StructuralContractError as e:
        torch.cuda.synchronize()
        audit_ms = (time.perf_counter() - t) * 1e3
        rules = {v.rule for v in e.violations}
        where = {(v.where or "").split("/")[-1].split(":")[0]
                 for v in e.violations}
        if rules != {"NoFFT"} or where != {"ops.py"}:
            fail(f"default train audit: rules {rules} at {where}")
        n_default = len(e.violations)
        names = [op.name for op in e.trace]
    per_pass = 5 * cfg.n_layers
    n_mm = names.count("repro_torch.bc_matmul")
    n_dw = names.count("repro_torch.bc_dw")
    if (n_mm, n_dw) != (3 * per_pass, per_pass):
        fail(f"train audit capture: bc_matmul {n_mm}, bc_dw {n_dw} != "
             f"{3 * per_pass}, {per_pass}")
    print(f"analysis (c) train audit (qwen3-0.6b full width, batch "
          f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, remat={cfg.remat!r}), default "
          f"rules on one capture: {n_default} NoFFT at freq_weights (the "
          f"kernel impl's per-step rfft(w), as in the reference), 0 "
          f"DenseFallbackDot; the capture holds {n_mm} bc_matmul and {n_dw} "
          f"bc_dw (backward on autograd's device thread captured), "
          f"{len(names)} ops; wall {audit_ms!r} ms ({CARD[0]})")
    return dict(default_nofft=n_default, bc_matmul=n_mm, bc_dw=n_dw,
                ops=len(names), audit_ms=audit_ms)


def analysis_planted(torch, dev):
    """(d) a loss with a weight fft: the grad-step gate names this
    file's line."""
    from repro_torch.analysis.contracts import StructuralContractError
    from repro_torch.train.loop import make_grad_step

    def bad_loss(params, batch):
        wf = torch.fft.rfft(params["w"], dim=-1)      # the planted fault
        return wf.abs().mean() + (batch["x"] * params["w"]).mean()

    gen = torch.Generator(device=dev).manual_seed(21)
    params = {"w": torch.randn(4, 8, K, generator=gen, device=dev
                               ).requires_grad_(True)}
    batch = {"x": torch.randn(4, 8, K, generator=gen, device=dev)}
    line = next(i for i, text in enumerate(
        Path(__file__).read_text().splitlines(), 1)
        if "# the planted fault" in text and "next(" not in text)
    want = f"chip_smoke.py:{line}"
    try:
        make_grad_step(bad_loss, audit_args=(params, batch))
        fail("the planted weight fft raised nothing")
    except StructuralContractError as e:
        if want not in str(e):
            fail(f"planted fault: {want} not in {e}")
    print(f"analysis (d) planted weight-fft loss: StructuralContractError "
          f"names {want}")
    return want


def analysis_cli_start():
    """(e) ``python -m repro_torch.analysis --all-configs`` on the card,
    started in the background (it runs beside (a)-(d))."""
    import os

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.analysis", "--all-configs"],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def analysis_cli_join(proc, timeout=120):
    try:
        out = proc.communicate(timeout=timeout)[0]
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        fail(f"python -m repro_torch.analysis --all-configs ran over "
             f"{timeout}s")
    lines = out.strip().splitlines()
    if proc.returncode != 0:
        fail("python -m repro_torch.analysis --all-configs exited "
             f"{proc.returncode}:\n" + "\n".join(lines[-20:]))
    ok = [ln for ln in lines if ln.startswith("[  ok]")]
    if len(ok) != 11 or "total: 0 violation(s)" not in lines[-1]:
        fail("analysis CLI: " + "\n".join(lines[-15:]))
    print("analysis (e) python -m repro_torch.analysis --all-configs on the "
          "card: " + "; ".join(ln[7:].split(" surfaces")[0].strip()
                                for ln in ok) + f"; {lines[-1]}")
    return len(ok) - 1


def phase_analysis(torch, kernel, dev, engine):
    """The analysis layer on the card, parts (a)-(e) (module docstring).
    Its launches are counted apart from every other phase's. Returns
    (report row, launches)."""
    t_phase = time.perf_counter()
    saved = dict(kernel.LAUNCHES)
    kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
    proc = analysis_cli_start()
    try:
        n_opcheck = analysis_opcheck(torch, kernel, dev)
        serve = analysis_serve(torch, engine)
        train = analysis_train(torch, dev)
        planted = analysis_planted(torch, dev)
    except BaseException:
        proc.kill()
        proc.communicate()
        raise
    archs = analysis_cli_join(proc)
    torch.cuda.synchronize()
    launches = dict(kernel.LAUNCHES)
    kernel.LAUNCHES.update(saved)
    secs = time.perf_counter() - t_phase
    print(f"analysis phase: {secs:.1f}s; launches {launches}")
    return dict(opcheck_cases=n_opcheck, serve=serve, train=train,
                planted=planted, cli_archs=archs, seconds=secs), launches


# ---------------------------------------------------------------------------
# Tensor parallelism and FSDP (``tp`` phase)
# ---------------------------------------------------------------------------

# (a) qwen3-0.6b on (data=1, model=2), (b) arctic-480b with fsdp=True on
# (data=2, model=2), (c) seamless-m4t-medium on (data=1, model=2), (d)
# jamba-v0.1-52b (its config's fsdp=True) on (data=2, model=2) and (e)
# rwkv6-7b on (data=1, model=2): 2-layer cuts at full width in f32
# (train_family's depth for arctic; dist (b)'s cut for qwen3; 2 encoder +
# 2 decoder layers for seamless; jamba's first two layers, both Mamba, the
# first with the dense FFN, the second with the MoE; rwkv6's time mix
# split on its 64 heads, its channel mix on its d_ff blocks),
# impl="pallas", remat "block", AdamW, one step at step 1 of the schedule
# on the train batch (seamless's: TP_ENCDEC_BATCH rows of TRAIN_SEQ tokens,
# each with enc_seq = 4096 seeded frames, so that the cross K/V span the
# whole frame axis)
TP_RUNS = {"a": ("qwen3-0.6b", (1, 2)), "b": ("arctic-480b", (2, 2)),
           "c": ("seamless-m4t-medium", (1, 2)),
           "d": ("jamba-v0.1-52b", (2, 2)), "e": ("rwkv6-7b", (1, 2))}
# the runs whose config shards ``embed`` over the data axis
TP_FSDP = ("b", "d")
# the runs whose one-process step waits for the ranks to exit: jamba's
# (a 14.5 GB peak) does not fit on the card beside the fourteen ranks;
# rwkv6's, whose recomputed layer keeps a (8, 64, 64, 64) f32 WKV state
# per step, runs there with its control
TP_REF_AFTER_JOIN = ("d", "e")
# the runs whose ranks start on the card only once every rank of the named
# runs is done (its step and its serving): one wave at a time, (a) with (c)
# (19.7 GB of rank peaks), then (b) (28.3 GB), (d) (26.1 GB) and (e)
# (19.8 GB), beside this process's analysis phase and one-process steps
# (up to 15.4 GB). Every rank at once ran the card out of memory, and so
# did (d) started after (a) and (c) only, beside (b)'s ranks
TP_RANKS_AFTER = {"b": ("a", "c"), "d": ("b",), "e": ("d",)}
TP_RANKS_WAIT_S = 600
TP_LAYERS = 2
TP_ENCDEC_BATCH = 2
TP_TOL = 1e-5
# the runs whose moments are held to TP_TOL over each moment's tree, not
# leaf by leaf (printed all the same): rwkv6's f32 time-mix gradients are
# ill-conditioned leaf by leaf, so a change of summation order moves a
# moment leaf by more than TP_TOL of its largest entry. Their control
# shows it: one process's step taken again with its embedding table times
# 1 + TP_CONTROL_NOISE noise (a rounding step), held to the first by the
# same measures and printed beside the ranks'
TP_MOMENTS_OVER_TREE = ("e",)
TP_CONTROL_NOISE = 6e-8
# bc_matmul / bc_dw launches per rank per step, pinned: one process's
# (2 layers x qwen3's 15 / 5, arctic's 27 / 8; seamless 2 x 12 / 4 per
# encoder layer and 2 x 24 / 8 per decoder layer; jamba's Mamba 6 / 2 per
# layer, its dense FFN 9 / 3 and its MoE 12 / 3; rwkv6's time mix 15 / 5
# and channel mix 9 / 3 per layer), each at its shard shape
TP_LAUNCHES = {"a": {"bc_matmul": 30, "bc_dw": 10},
               "b": {"bc_matmul": 54, "bc_dw": 16},
               "c": {"bc_matmul": 72, "bc_dw": 24},
               "d": {"bc_matmul": 33, "bc_dw": 10},
               "e": {"bc_matmul": 48, "bc_dw": 16}}
# (name, groups, p, q, launches per rank per step, rows) of every shard
# shape a rank launches at model = 2, k = 128: forward (and recompute) at
# (p, q), dx at (q, p). qwen3 runs 2048 rows per rank (data = 1); arctic
# 1024 (data = 2), its 64 local experts at the capacity's 40 rows
TP_SHAPES = {
    "a": [("qwen3.qkv", 1, 16, 8, 4, 2048),
          ("qwen3.qkv.dx", 1, 8, 16, 2, 2048),
          ("qwen3.o", 1, 8, 8, 4, 2048), ("qwen3.o.dx", 1, 8, 8, 2, 2048),
          ("qwen3.wi_wu", 1, 12, 8, 8, 2048),
          ("qwen3.wi_wu.dx", 1, 8, 12, 4, 2048),
          ("qwen3.wo", 1, 8, 12, 4, 2048),
          ("qwen3.wo.dx", 1, 12, 8, 2, 2048)],
    "b": [("arctic.qkv", 1, 36, 56, 4, 1024),
          ("arctic.qkv.dx", 1, 56, 36, 2, 1024),
          ("arctic.o", 1, 56, 28, 4, 1024),
          ("arctic.o.dx", 1, 28, 56, 2, 1024),
          ("arctic.wi_wu", 1, 19, 56, 8, 1024),
          ("arctic.wi_wu.dx", 1, 56, 19, 4, 1024),
          ("arctic.wo", 1, 56, 19, 4, 1024),
          ("arctic.wo.dx", 1, 19, 56, 2, 1024),
          ("arctic.experts.wi_wu", 64, 38, 56, 12, 40),
          ("arctic.experts.wi_wu.dx", 64, 56, 38, 4, 40),
          ("arctic.experts.wo", 64, 56, 38, 6, 40),
          ("arctic.experts.wo.dx", 64, 38, 56, 2, 40)],
    # seamless: the encoder's rows are 2 x 4096 frames, the decoder's 2 x
    # 256 tokens; cross k and v (one launch each) run on the encoder's
    "c": [("seamless.enc.qkv", 1, 12, 8, 4, 8192),
          ("seamless.enc.qkv.dx", 1, 8, 12, 2, 8192),
          ("seamless.enc.o", 1, 8, 4, 4, 8192),
          ("seamless.enc.o.dx", 1, 4, 8, 2, 8192),
          ("seamless.enc.wi", 1, 16, 8, 4, 8192),
          ("seamless.enc.wi.dx", 1, 8, 16, 2, 8192),
          ("seamless.enc.wo", 1, 8, 16, 4, 8192),
          ("seamless.enc.wo.dx", 1, 16, 8, 2, 8192),
          ("seamless.dec.qkv", 1, 12, 8, 4, 512),
          ("seamless.dec.qkv.dx", 1, 8, 12, 2, 512),
          ("seamless.dec.o", 1, 8, 4, 8, 512),
          ("seamless.dec.o.dx", 1, 4, 8, 4, 512),
          ("seamless.cross.q", 1, 4, 8, 4, 512),
          ("seamless.cross.q.dx", 1, 8, 4, 2, 512),
          ("seamless.cross.kv", 1, 4, 8, 8, 8192),
          ("seamless.cross.kv.dx", 1, 8, 4, 4, 8192),
          ("seamless.dec.wi", 1, 16, 8, 4, 512),
          ("seamless.dec.wi.dx", 1, 8, 16, 2, 512),
          ("seamless.dec.wo", 1, 8, 16, 4, 512),
          ("seamless.dec.wo.dx", 1, 16, 8, 2, 512)],
    # jamba: 1024 rows per rank (data = 2); in_proj keeps the rule's cut
    # of its 2 d_inner outputs (p 64 of 128) and, under FSDP, its whole q
    # (32) after the layer's gather; the 8 local experts at the global
    # batch's capacity, 320 rows
    "d": [("jamba.in_proj", 1, 64, 32, 4, 1024),
          ("jamba.in_proj.dx", 1, 32, 64, 2, 1024),
          ("jamba.out_proj", 1, 32, 32, 4, 1024),
          ("jamba.out_proj.dx", 1, 32, 32, 2, 1024),
          ("jamba.wi_wu", 1, 56, 32, 4, 1024),
          ("jamba.wi_wu.dx", 1, 32, 56, 2, 1024),
          ("jamba.wo", 1, 32, 56, 2, 1024),
          ("jamba.wo.dx", 1, 56, 32, 1, 1024),
          ("jamba.experts.wi_wu", 8, 112, 32, 6, JAMBA_CAPACITY),
          ("jamba.experts.wi_wu.dx", 8, 32, 112, 2, JAMBA_CAPACITY),
          ("jamba.experts.wo", 8, 32, 112, 3, JAMBA_CAPACITY),
          ("jamba.experts.wo.dx", 8, 112, 32, 1, JAMBA_CAPACITY)],
    # rwkv6: 2048 rows per rank (data = 1); r, k, v and g one launch each
    # at the rank's 32 heads (p 16 of 32), o on their blocks (q 16), the
    # channel mix's wk and wv on 56 of d_ff's 112 blocks and wr whole
    "e": [("rwkv6.rkvg", 1, 16, 32, 16, 2048),
          ("rwkv6.rkvg.dx", 1, 32, 16, 8, 2048),
          ("rwkv6.o", 1, 32, 16, 4, 2048),
          ("rwkv6.o.dx", 1, 16, 32, 2, 2048),
          ("rwkv6.wk", 1, 56, 32, 4, 2048),
          ("rwkv6.wk.dx", 1, 32, 56, 2, 2048),
          ("rwkv6.wr", 1, 32, 32, 4, 2048),
          ("rwkv6.wr.dx", 1, 32, 32, 2, 2048),
          ("rwkv6.wv", 1, 32, 56, 4, 2048),
          ("rwkv6.wv.dx", 1, 56, 32, 2, 2048)],
}
# the q and k/v tables on their own (the fused launch concatenates them)
TP_SPLIT_SHAPES = [("qwen3.q", 1, 8, 8, 0, 2048),
                   ("qwen3.kv", 1, 4, 8, 0, 2048),
                   ("arctic.q", 1, 28, 56, 0, 1024),
                   ("arctic.kv", 1, 4, 56, 0, 1024)]
# (name, groups, P, Q, launches per rank per step, rows) of every bc_dw
TP_DW_SHAPES = {
    "a": [("qwen3.qkv", 1, 16, 8, 2, 2048), ("qwen3.o", 1, 8, 8, 2, 2048),
          ("qwen3.wi_wu", 1, 12, 8, 4, 2048), ("qwen3.wo", 1, 8, 12, 2, 2048)],
    "b": [("arctic.qkv", 1, 36, 56, 2, 1024), ("arctic.o", 1, 56, 28, 2, 1024),
          ("arctic.wi_wu", 1, 19, 56, 4, 1024),
          ("arctic.wo", 1, 56, 19, 2, 1024),
          ("arctic.experts.wi_wu", 64, 38, 56, 4, 40),
          ("arctic.experts.wo", 64, 56, 38, 2, 40)],
    "c": [("seamless.enc.qkv", 1, 12, 8, 2, 8192),
          ("seamless.enc.o", 1, 8, 4, 2, 8192),
          ("seamless.enc.wi", 1, 16, 8, 2, 8192),
          ("seamless.enc.wo", 1, 8, 16, 2, 8192),
          ("seamless.dec.qkv", 1, 12, 8, 2, 512),
          ("seamless.dec.o", 1, 8, 4, 4, 512),
          ("seamless.cross.q", 1, 4, 8, 2, 512),
          ("seamless.cross.kv", 1, 4, 8, 4, 8192),
          ("seamless.dec.wi", 1, 16, 8, 2, 512),
          ("seamless.dec.wo", 1, 8, 16, 2, 512)],
    "d": [("jamba.in_proj", 1, 64, 32, 2, 1024),
          ("jamba.out_proj", 1, 32, 32, 2, 1024),
          ("jamba.wi_wu", 1, 56, 32, 2, 1024),
          ("jamba.wo", 1, 32, 56, 1, 1024),
          ("jamba.experts.wi_wu", 8, 112, 32, 2, JAMBA_CAPACITY),
          ("jamba.experts.wo", 8, 32, 112, 1, JAMBA_CAPACITY)],
    "e": [("rwkv6.rkvg", 1, 16, 32, 8, 2048),
          ("rwkv6.o", 1, 32, 16, 2, 2048),
          ("rwkv6.wk", 1, 56, 32, 2, 2048),
          ("rwkv6.wr", 1, 32, 32, 2, 2048),
          ("rwkv6.wv", 1, 32, 56, 2, 2048)],
}

# (d) serving after the train step: (a) qwen3-0.6b at full depth, (b)
# arctic-480b cut to 3 layers (2 would stack evenly over data = 2, and the
# cache rule would then put the data axis on the layer stack and leave
# every data rank all the rows), (c) seamless-m4t-medium at the train
# step's 2 + 2 layers, each request with enc_seq = 4096 seeded frames
# (the cross caches split on their frames: 4096 = d_ff, a channel size of
# the cache rule), (d) jamba-v0.1-52b at the train step's 2 layers (the
# Mamba states split on their channels, the slot axis over the data
# ranks), (e) rwkv6-7b at the train step's 2 layers (the shift states
# split on their channels, all-gathered at each step, the WKV state on its
# heads), full width, f32, frozen tables f32 then int8; prompts, prompt
# tokens, greedy decode steps, cache length (none a channel or head size
# of the rule: a batch of 64 would put rwkv6's 'model' on the slot axis)
TP_SERVE_DEPTH = {"a": None, "b": 3, "c": TP_LAYERS, "d": TP_LAYERS,
                  "e": TP_LAYERS}
TP_SERVE = (4, 64, 16)
TP_SERVE_CACHE = 128
TP_SERVE_INT8_TOL = FP32_TOL    # tests/test_torch_bcplan.py's int8 plans
# bc_matmul launches per rank per prefill and per decode step, pinned: one
# process's (qwen3's 5 per layer x 28, arctic's 8 per layer x 3; seamless
# 4 per encoder and 8 per decoder layer in prefill, 6 per decoder layer in
# decode: cross k and v run at prefill only; jamba's 2 per Mamba layer, 3
# per dense FFN and 3 per MoE; rwkv6's 5 per time mix and 3 per channel
# mix)
TP_SERVE_LAUNCHES = {"a": (140, 140), "b": (24, 24), "c": (24, 12),
                     "d": (10, 10), "e": (16, 16)}
# (name, groups, p, q, launches per rank per forward) of every serve shard
# shape at model = 2, k = 128; rows from tp_serve_rows
TP_SERVE_SHAPES = {
    "a": [("qwen3.serve.qkv", 1, 16, 8, 28), ("qwen3.serve.o", 1, 8, 8, 28),
          ("qwen3.serve.wi_wu", 1, 12, 8, 56),
          ("qwen3.serve.wo", 1, 8, 12, 28)],
    "b": [("arctic.serve.qkv", 1, 36, 56, 3),
          ("arctic.serve.o", 1, 56, 28, 3),
          ("arctic.serve.wi_wu", 1, 19, 56, 6),
          ("arctic.serve.wo", 1, 56, 19, 3),
          ("arctic.serve.experts.wi_wu", 64, 38, 56, 6),
          ("arctic.serve.experts.wo", 64, 56, 38, 3)],
    "c": [("seamless.serve.enc.qkv", 1, 12, 8, 2),
          ("seamless.serve.enc.o", 1, 8, 4, 2),
          ("seamless.serve.enc.wi", 1, 16, 8, 2),
          ("seamless.serve.enc.wo", 1, 8, 16, 2),
          ("seamless.serve.cross.kv", 1, 4, 8, 4),
          ("seamless.serve.qkv", 1, 12, 8, 2),
          ("seamless.serve.o", 1, 8, 4, 4),
          ("seamless.serve.cross.q", 1, 4, 8, 2),
          ("seamless.serve.wi", 1, 16, 8, 2),
          ("seamless.serve.wo", 1, 8, 16, 2)],
    "d": [("jamba.serve.in_proj", 1, 64, 32, 2),
          ("jamba.serve.out_proj", 1, 32, 32, 2),
          ("jamba.serve.wi_wu", 1, 56, 32, 2),
          ("jamba.serve.wo", 1, 32, 56, 1),
          ("jamba.serve.experts.wi_wu", 8, 112, 32, 2),
          ("jamba.serve.experts.wo", 8, 32, 112, 1)],
    "e": [("rwkv6.serve.rkvg", 1, 16, 32, 8),
          ("rwkv6.serve.o", 1, 32, 16, 2),
          ("rwkv6.serve.wk", 1, 56, 32, 2),
          ("rwkv6.serve.wr", 1, 32, 32, 2),
          ("rwkv6.serve.wv", 1, 32, 56, 2)],
}
# the serve shapes that run on the encoder's frames (prefill only)
TP_SERVE_ENC = {"seamless.serve.enc.qkv", "seamless.serve.enc.o",
                "seamless.serve.enc.wi", "seamless.serve.enc.wo",
                "seamless.serve.cross.kv"}
# the committed dry-run records the dry-run step reproduces on the CPU
DRYRUN_CELLS = ("train_4k", "prefill_32k", "decode_32k")
# seamless's three cells and jamba's four beside them, which have no
# committed record: rank 0's argument bytes and donated cache bytes (None:
# the train state, not a cache) as the reference's
# repro.launch.specs.input_specs gives them on 256 fake devices
# (tests/test_torch_dryrun_encdec.py and tests/test_torch_dryrun_jamba.py
# compute them there)
DRYRUN_JAMBA = {"train_4k": (60_524_612, None),
                "prefill_32k": (1_216_430_080, 1_076_797_440),
                "decode_32k": (4_446_560_320, 4_307_189_760),
                "long_500k": (8_738_697_224, 8_599_326_720)}
DRYRUN_ENCDEC = {"train_4k": (793_847_876, None),
                 "prefill_32k": (774_221_824, 229_662_720),
                 "decode_32k": (1_446_170_688, 918_650_880)}
# rwkv6's four (its RWKV mixer under model = 16), the reference's figures
# (tests/test_torch_dryrun_rwkv.py). rwkv6's 32 stacked layers divide the
# 16-way data axis, so the reference puts the data axes on its layer stack
# and the port's per-layer cache leaves, whose slot axis stays whole, hold
# DRYRUN_CACHE_FACTOR times the reference's cache bytes per rank (ROADMAP
# Queue 3 item 1); the rest of the arguments are equal
DRYRUN_RWKV = {"train_4k": (374_462_532, None),
               "prefill_32k": (328_056_832, 4_259_840),
               "decode_32k": (340_574_272, 17_039_360),
               "long_500k": (323_667_976, 133_120)}
DRYRUN_CACHE_FACTOR = {"rwkv6-7b": 16}
DRYRUN_REF = {"seamless-m4t-medium": DRYRUN_ENCDEC,
              "jamba-v0.1-52b": DRYRUN_JAMBA, "rwkv6-7b": DRYRUN_RWKV}


def tp_config(run):
    """(a)'s or (b)'s config: the arch at full width in f32, 2 layers."""
    from repro_torch.configs.base import SWMConfig
    from repro_torch.configs.registry import get_config

    arch, _ = TP_RUNS[run]
    return cut_depth(dataclasses.replace(
        get_config(arch), swm=SWMConfig(block_size=128, impl="pallas"),
        param_dtype="float32", compute_dtype="float32"), TP_LAYERS)


def tp_batch(torch, cfg, dev):
    """The train batch: TRAIN_BATCH rows of TRAIN_SEQ tokens, or for the
    enc-dec family TP_ENCDEC_BATCH rows, each with its seeded frames."""
    import numpy as np

    from repro_torch.data.pipeline import SyntheticLM

    encdec = cfg.family == "encdec"
    B = TP_ENCDEC_BATCH if encdec else TRAIN_BATCH
    batch = {"tokens": torch.from_numpy(SyntheticLM(
        vocab=cfg.vocab, seq_len=TRAIN_SEQ, batch=B,
        seed=0).batch_np(0)["tokens"]).to(dev)}
    if encdec:
        batch["frames"] = torch.from_numpy(np.stack(encdec_frames(
            cfg, B))).to(dev)
    return batch


def tp_batch_rows(run):
    """The rows of ``run``'s train batch, printed with their frames."""
    if tp_config(run).family != "encdec":
        return str(TRAIN_BATCH)
    return f"{TP_ENCDEC_BATCH} (each with {tp_config(run).enc_seq} frames)"


def tp_depth(cfg):
    """A config's depth as printed: its layers, or an enc-dec config's
    encoder + decoder layers."""
    n = len(cfg.layer_specs())
    return f"{cfg.n_enc_layers} + {n}" if cfg.family == "encdec" else str(n)


def tp_cache_bytes(cache):
    """The bytes of a cache: a list of per-layer dicts, or the enc-dec's
    dict of such lists."""
    if isinstance(cache, dict) and "self" in cache:
        return sum(tp_cache_bytes(v) for v in cache.values())
    return sum(t.nbytes for layer in cache for t in layer.values())


def tp_bytes(tree):
    from repro_torch.nn.module import tree_leaves

    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def tp_step(torch, dev, run, mesh, perturb=False):
    """One step of ``run`` from seed 0's params, on ``mesh`` (this rank's
    shards) or in one process (None); with ``perturb``, the embedding
    table times 1 + TP_CONTROL_NOISE seeded noise. Returns (state, step
    fn, model, metrics, step ms, peak device bytes above the bytes held
    before the model)."""
    from repro_torch.configs.base import TrainConfig
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params
    from repro_torch.train.loop import init_train_state, make_train_step

    cfg = tp_config(run)
    tcfg = TrainConfig(warmup_steps=1)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    model = build_model(cfg, device=dev)
    step = make_train_step(model, cfg, tcfg, mesh=mesh)
    shard = (step.data_parallel.state_shardings if mesh is not None
             else {"params": None, "opt": None})
    params = init_params(model.specs(), seed=0, device=dev)
    if perturb:
        table = params["embed"]["table"]
        gen = torch.Generator(device=dev).manual_seed(1)
        params["embed"]["table"] = table * (1 + TP_CONTROL_NOISE * torch.randn(
            table.shape, generator=gen, device=dev))
    state = init_train_state(params, tcfg, opt_shardings=shard["opt"],
                             param_shardings=shard["params"], mesh=mesh)
    state["step"] = 1                  # a step whose learning rate is > 0
    batch = tp_batch(torch, cfg, dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    state, metrics = step(state, batch)
    float(metrics["loss"])
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    return (state, step, model, metrics, ms,
            torch.cuda.max_memory_allocated() - base)


def tp_serve_config(run):
    """(a)'s or (b)'s serve config: the arch at full width in f32,
    ``impl="pallas"``, cut to ``TP_SERVE_DEPTH`` layers."""
    from repro_torch.configs.base import SWMConfig
    from repro_torch.configs.registry import get_config

    arch, _ = TP_RUNS[run]
    cfg = dataclasses.replace(
        get_config(arch), swm=SWMConfig(block_size=128, impl="pallas"),
        param_dtype="float32", compute_dtype="float32")
    depth = TP_SERVE_DEPTH[run]
    return cfg if depth is None else cut_depth(cfg, depth)


def tp_serve_rows(run, shape):
    """{shape name: rows per launch} of ``run``'s serve on ``shape`` (data,
    model): a rank's rows of the prompts (prefill) and of the batch
    (decode); an expert launch's rows are the capacity of the global
    batch's tokens."""
    from repro_torch.nn.moe import MoE

    B, P, _ = TP_SERVE
    per = B // shape[0]
    cfg = tp_serve_config(run)
    out = {}
    for name, G, *_ in TP_SERVE_SHAPES[run]:
        if name in TP_SERVE_ENC:
            out[name] = {per * cfg.enc_seq}
        elif G > 1:
            moe = MoE(cfg.d_model, cfg.d_ff_expert or cfg.d_ff,
                      cfg.n_experts, cfg.n_experts_per_token,
                      cfg.capacity_factor)
            out[name] = {min(moe.capacity(n, False), n // shape[0])
                         for n in (B * P, B)}
        else:
            out[name] = {per * P, per}
    return out


def tp_serve(torch, kernel, dev, run, quantize, mesh=None):
    """``run``'s serve config with frozen tables (``quantize``) on
    ``mesh`` (this rank's shards) or in one process (None): TP_SERVE's
    prompts (seeded) prefilled, then greedy decode steps, the next step's
    global tokens all-gathered over the data ranks. Returns the greedy
    tokens of every step, the last step's logits (this rank's rows),
    bc_matmul launches and collectives by kind per prefill and per decode
    step, the rows, param and cache bytes, wall ms, and (f32) a profiled
    prefill's and decode step's busy ms."""
    import numpy as np
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.dist.sharding import all_gather_list
    from repro_torch.kernels.block_circulant.plan import freeze_params
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, load_tree, module_tree
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    cfg = tp_serve_config(run)
    B, P, steps = TP_SERVE
    model = build_model(cfg, device=dev)
    specs = model.specs()
    load_tree(model, freeze_params(specs, init_params(specs, seed=0,
                                                      device=dev), quantize))
    prefill = make_prefill_step(model, cfg, mesh=mesh)
    decode = make_decode_step(model, cfg, mesh=mesh)
    par = prefill.parallel
    group = None if mesh is None else mesh.get_group("data")

    def fresh_cache():
        return (model.init_cache(B, TP_SERVE_CACHE) if par is None
                else par.init_cache(B, TP_SERVE_CACHE))

    def counted(fn, *args):
        n0 = kernel.LAUNCHES["bc_matmul"]
        c0 = dict(par.log.counts) if par else {}
        b0 = dict(par.log.kind_bytes) if par else {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t) * 1e3
        coll = {k: (par.log.counts[k] - c0[k], par.log.kind_bytes[k] - b0[k])
                for k in c0 if par.log.counts[k] > c0[k]} if par else {}
        return out, kernel.LAUNCHES["bc_matmul"] - n0, coll, ms

    def global_tokens(logits):
        tok = logits.argmax(-1).to(torch.int32)
        if tok.shape[0] < B:
            tok = torch.cat(all_gather_list(tok, group))
        return tok

    prompts = torch.from_numpy(np.random.default_rng(23).integers(
        0, cfg.vocab, (B, P)).astype(np.int32)).to(dev)
    # the enc-dec family's requests carry their encoder frames
    extra = ((torch.from_numpy(np.stack(encdec_frames(cfg, B))).to(dev),)
             if cfg.family == "encdec" else ())
    cache = fresh_cache()
    rows = par.step_rows(B, cache) if par else (0, B)
    (logits, cache), pre_n, pre_coll, pre_ms = counted(prefill, prompts,
                                                       cache, *extra)
    toks = [global_tokens(logits)]
    dec_n, dec_coll, dec_ms = set(), [], []
    for i in range(steps):
        pos = torch.full((B,), P + i, dtype=torch.int32, device=dev)
        (logits, cache), n, coll, ms = counted(decode, toks[-1][:, None],
                                               cache, pos)
        dec_n.add(n)
        dec_coll.append(coll)
        dec_ms.append(ms)
        toks.append(global_tokens(logits))
    out = dict(tokens=[t.cpu().numpy() for t in toks],
               logits=logits.float().cpu().numpy(), rows=rows,
               prefill_launches=pre_n, decode_launches=sorted(dec_n),
               prefill_coll=pre_coll, decode_coll=dec_coll[-1],
               param_bytes=tp_bytes(module_tree(model)),
               cache_bytes=tp_cache_bytes(cache),
               prefill_ms=pre_ms, decode_ms=statistics.median(dec_ms))
    if quantize == "off":
        busy = {}
        for name, fn, args in (
                ("prefill", prefill, (prompts, fresh_cache(), *extra)),
                ("decode", decode, (toks[-1][:, None], cache, pos + 1))):
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                fn(*args)
                torch.cuda.synchronize()
            busy[name] = device_busy_ms(torch, prof)
        out.update(prefill_busy_ms=busy["prefill"],
                   decode_busy_ms=busy["decode"])
    del model, cache, prefill, decode
    torch.cuda.empty_cache()
    return out


def tp_wait_for(done, run):
    """Wait until every rank of the runs ``TP_RANKS_AFTER[run]`` is done
    (``done``: the count of such ranks by run)."""
    after = [r for r in TP_RANKS_AFTER.get(run, ()) if r in done]
    deadline = time.monotonic() + TP_RANKS_WAIT_S
    while any(done[r].value < math.prod(TP_RUNS[r][1]) for r in after):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the ranks of {after} were not done in "
                               f"{TP_RANKS_WAIT_S} s")
        time.sleep(0.2)


def tp_rank_main(run, rank, port, ckpt, q, done):
    """A rank of a ``TP_RUNS`` run, once the ranks of the runs
    ``TP_RANKS_AFTER`` names are done: a gloo group on cuda:0 (NCCL refuses
    two ranks on one GPU), one step on its shards, then the state saved
    whole (``save_checkpoint(shardings=, mesh=)``, rank 0 writing) for the
    parent to restore onto one process, then serving; its figures go back
    through ``q``, and ``done[run]`` counts it at its end."""
    import torch
    import torch.distributed as dist

    arch, shape = TP_RUNS[run]
    out = {"run": run, "rank": rank}
    try:
        tp_wait_for(done, run)         # before this rank touches the card
        out["t_card"] = time.time()
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.set_num_threads(1)
        dev = torch.device("cuda", 0)
        dist.init_process_group("gloo",
                                init_method=f"tcp://localhost:{port}",
                                world_size=shape[0] * shape[1], rank=rank)
        from torch.distributed.device_mesh import init_device_mesh

        from repro_torch.ft.checkpoint import save_checkpoint
        from repro_torch.kernels.block_circulant import kernel

        mesh = init_device_mesh("cpu", shape,
                                mesh_dim_names=("data", "model"))
        kernel.LAUNCHES.update(bc_matmul=0, bc_dw=0)
        from repro_torch.nn.attention import Attention
        from repro_torch.nn.rwkv import RWKV6TimeMix
        from repro_torch.nn.ssm import Mamba

        state, step, model, metrics, ms, peak = tp_step(torch, dev, run,
                                                        mesh)
        launches = dict(kernel.LAUNCHES)
        dp = step.data_parallel
        out.update(coord=tuple(int(c) for c in mesh.get_coordinate()),
                   launches=launches, ms=ms, peak=peak,
                   loss=float(metrics["loss"]),
                   grad_norm=float(metrics["grad_norm"]),
                   collectives=dp.collectives, comm_bytes=dp.comm_bytes,
                   param_bytes=tp_bytes(state["params"]),
                   moment_bytes=tp_bytes(state["opt"]),
                   kv=sorted({m.tp.kv for m in model.modules()
                               if isinstance(m, Attention)
                               and m.tp is not None}),
                   mamba=sorted({m.tp.channels for m in model.modules()
                                 if isinstance(m, Mamba)
                                 and m.tp is not None}),
                   rwkv=sorted({m.tp.heads for m in model.modules()
                                if isinstance(m, RWKV6TimeMix)
                                and m.tp is not None}))
        t = time.perf_counter()
        save_checkpoint(ckpt, 1, state, shardings=dp.state_shardings,
                        mesh=mesh)
        out["save_s"] = time.perf_counter() - t
        del state, step, model, metrics
        torch.cuda.empty_cache()
        # (d) serving on the same mesh, its launches counted apart
        saved = dict(kernel.LAUNCHES)
        out["serve"] = {q_: tp_serve(torch, kernel, dev, run, q_, mesh)
                        for q_ in ("off", "int8")}
        kernel.LAUNCHES.update(saved)
        out["serve_launches"] = sum(
            o["prefill_launches"] + TP_SERVE[2] * o["decode_launches"][0]
            for o in out["serve"].values())
    except Exception as e:             # reported by the parent, which fails
        import traceback

        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        torch.cuda.empty_cache()
        out["t_done"] = time.time()
        with done[run].get_lock():     # a failed rank holds no one back
            done[run].value += 1
        q.put(out)
        if dist.is_initialized():
            dist.destroy_process_group()


def tp_spawn(tmp):
    """Start every ``TP_RUNS`` run's ranks (``spawn``: this process holds
    the card), each run with its own group and checkpoint directory under
    ``tmp``; returns (processes, the queue of their reports, the ranks'
    shared counts of ``tp_rank_main``), the last to be held while the ranks
    run (``start()`` lets go of a process's arguments before the child has
    read them). A thread moves each report off the ranks' pipe as it comes,
    so that a rank that is done exits and lets go of its CUDA context
    (a child's exit waits until its queue's data is in the pipe)."""
    import os
    import queue
    import socket

    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    done = {run: ctx.Value("i", 0) for run in TP_RUNS}
    procs = []
    for run, (_, shape) in TP_RUNS.items():
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs += [ctx.Process(target=tp_rank_main,
                              args=(run, r, port, os.path.join(tmp, run), q,
                                    done))
                  for r in range(shape[0] * shape[1])]
    for p in procs:
        p.start()
    got = queue.Queue()

    def drain():
        for _ in procs:
            got.put(q.get())

    threading.Thread(target=drain, daemon=True).start()
    return procs, got, done


def card_memory_sampler(torch, every=0.05):
    """Sample the bytes in use on the card, every process's
    (``torch.cuda.mem_get_info``), on a thread every ``every`` s; returns
    stop(), which ends the thread and returns (the most bytes in use, the
    seconds from the start to that sample, this process's reserved bytes
    then, the card's bytes)."""
    halt = threading.Event()
    t0 = time.perf_counter()
    total = torch.cuda.mem_get_info()[1]
    peak = [0, 0.0, 0]

    def sample():
        while not halt.is_set():
            used = total - torch.cuda.mem_get_info()[0]
            if used > peak[0]:
                peak[:] = [used, time.perf_counter() - t0,
                           torch.cuda.memory_reserved()]
            halt.wait(every)

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()

    def stop():
        halt.set()
        thread.join()
        return (*peak, total)

    return stop


def tp_join(procs, q):
    """Every rank's report, by run and rank; a rank that failed fails."""
    try:
        outs = [q.get(timeout=300) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    for o in outs:
        if "error" in o:
            fail(f"tp ({o['run']}) rank {o['rank']}: {o['error']}")
    return {run: sorted((o for o in outs if o["run"] == run),
                        key=lambda o: o["rank"]) for run in TP_RUNS}


def tp_compare(torch, ref, ckpt, dev):
    """The ranks' checkpoint, restored onto one process, against the
    one-process state ``ref`` (``state_rel``), and its step."""
    from repro_torch.ft.checkpoint import restore_checkpoint

    got = restore_checkpoint(ckpt, 1, device=dev)
    return state_rel(torch, got, ref) + (int(got["step"]),)


def state_rel(torch, got, ref):
    """Train state ``got`` against ``ref``: params over the tree (||diff||
    / ||ref||, and leaf by leaf), moments leaf by leaf (max |diff| / max
    |ref|) and over each moment's tree (the larger of m's and v's)."""
    from repro_torch.nn.module import tree_leaves

    with torch.no_grad():
        pairs = list(zip(tree_leaves(got["params"]),
                         tree_leaves(ref["params"])))
        if any(a.shape != b.shape for a, b in pairs):
            fail("tp: a restored param's shape differs from one process's")
        leaf = max(rel_err(a, b) for a, b in pairs)

        def over_tree(pairs):
            diff = sum(float((a.double() - b.double()).square().sum())
                       for a, b in pairs)
            norm = sum(float(b.double().square().sum()) for _, b in pairs)
            return math.sqrt(diff / norm)

        moments = [list(zip(tree_leaves(got["opt"][key]),
                            tree_leaves(ref["opt"][key])))
                   for key in ("m", "v")]
        leaf_m = max(rel_err(a, b) for m in moments for a, b in m)
        tree_m = max(over_tree(m) for m in moments)
    return over_tree(pairs), leaf, leaf_m, tree_m


def dryrun_start(out_dir):
    """(e) ``python -m repro_torch.launch.dryrun`` on each committed cell
    and on seamless's three, jamba's four and rwkv6's four into
    ``out_dir``, one process per cell, started
    together in the background (the CPU and ``meta`` tensors: no card).
    The processes are killed and ``out_dir`` removed when this script
    exits."""
    import atexit
    import os
    import shutil

    env = dict(os.environ, OMP_NUM_THREADS="1")      # meta: no arithmetic
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    cells = [("qwen3-0.6b", shape) for shape in DRYRUN_CELLS] + [
        (arch, shape) for arch, ref in DRYRUN_REF.items() for shape in ref]
    # at the lowest priority: they take the cores the kernels' build and
    # the serve phases leave idle
    procs = {cell: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", "single", "--out",
         out_dir, "--force"], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True,
        preexec_fn=lambda: os.nice(19)) for cell in cells}

    def stop():
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(out_dir, ignore_errors=True)

    atexit.register(stop)
    return out_dir, procs


def dryrun_join(torch, started, timeout=300):
    """Each cell's record against the reference's: qwen3's ``params`` and
    donated cache bytes equal to its committed record's, ``analytic`` to
    rel 1e-12, the port's bytes, flops and collectives printed beside the
    reference's; the other archs' argument and donated cache bytes equal
    to DRYRUN_REF's, the cache's times DRYRUN_CACHE_FACTOR. A cell not
    ``OK`` fails the run."""
    import os

    out_dir, procs = started
    rows = {}
    for (arch, shape), proc in procs.items():
        try:
            log = proc.communicate(timeout=timeout)[0]
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"dryrun {arch} {shape}: ran over {timeout}s")
        if proc.returncode != 0 or "cells: 1 OK" not in log:
            fail(f"dryrun {arch} {shape}: exited {proc.returncode}:\n"
                 + "\n".join(log.strip().splitlines()[-20:]))
        tag = f"{arch}__{shape}__single.json"
        with open(os.path.join(out_dir, tag)) as f:
            mine = json.load(f)
        keys = ("argument_size_in_bytes", "output_size_in_bytes",
                "alias_size_in_bytes", "temp_size_in_bytes", "flops")
        if arch != "qwen3-0.6b":
            args, cache = DRYRUN_REF[arch][shape]
            f = DRYRUN_CACHE_FACTOR.get(arch, 1)
            want = (args + (f - 1) * (cache or 0),
                    None if cache is None else f * cache)
            if mine["argument_size_in_bytes"] != want[0] or (
                    cache is not None
                    and mine["alias_size_in_bytes"] != want[1]):
                fail(f"dryrun {arch} {shape}: argument / donated cache bytes "
                     f"{mine['argument_size_in_bytes']} / "
                     f"{mine['alias_size_in_bytes']} != {want[0]} / "
                     f"{want[1]}: the reference's {args} / {cache} with the "
                     f"cache times {f}")
            print(f"dryrun (e) {arch} {shape} single on the CPU "
                  f"({mine['lower_s']} s on meta; torch {torch.__version__}): "
                  f"OK; argument bytes {want[0]} and donated cache bytes "
                  f"{want[1]}: the reference's shard bytes {args} and "
                  f"{cache} with the cache's times {f}; "
                  + ", ".join(f"{k} {mine[k]!r}" for k in keys[1:])
                  + f"; collectives {mine['collective_counts']}")
            rows[f"{arch} {shape}"] = {k: mine[k] for k in keys + (
                "collective_counts", "lower_s")}
            continue
        with open(ROOT / "experiments" / "dryrun" / tag) as f:
            ref = json.load(f)
        bad = [k for k in ("params", "tokens", "devices", "kind", "impl",
                           "argument_size_in_bytes") if mine[k] != ref[k]]
        bad += [f"analytic.{k}" for k, v in ref["analytic"].items()
                if abs(mine["analytic"][k] - v) > 1e-12 * abs(v)]
        if shape != "train_4k" and mine["alias_size_in_bytes"] != ref[
                "alias_size_in_bytes"]:
            bad.append("alias_size_in_bytes")
        if bad:
            fail(f"dryrun {shape}: {bad} differ from the reference's record")
        print(f"dryrun (e) qwen3-0.6b {shape} single on the CPU "
              f"({mine['lower_s']} s on meta; torch {torch.__version__}): "
              f"params stored {mine['params']['stored']} = the reference's; "
              f"analytic a_flops_per_chip {mine['analytic']['a_flops_per_chip']!r}"
              f" = the reference's; "
              + ", ".join(f"{k} {mine[k]!r} (reference {ref[k]!r})"
                          for k in keys)
              + f"; collectives {mine['collective_counts']} (reference "
              f"{ref['collective_counts']})")
        rows[shape] = {k: mine[k] for k in keys + ("collective_counts",
                                                   "lower_s")}
    return rows


def phase_tp(torch, kernel, quant, dev, procs, q, tmp):
    """Tensor parallelism and FSDP on the card, parts (a)-(c) (module
    docstring). The ranks were started before the analysis phase and ran
    beside it; here one process takes the same steps (its launches not
    counted), the shard shapes are checked while the ranks finish, the
    ranks are joined, their checkpoints restored and held to the steps,
    and the shard shapes are timed with the card to itself. Returns
    (report row, the ranks' launches, rows, bc_matmul times, bc_dw
    times)."""
    import os

    t_phase = time.perf_counter()
    saved = dict(kernel.LAUNCHES)
    refs, serve_refs = {}, {}

    def one_process(runs):
        """The one-process train step and serving of each of ``runs``,
        their launches not counted."""
        for run in runs:
            state, _, _, metrics, ms, peak = tp_step(torch, dev, run, None)
            refs[run] = dict(state=state, loss=float(metrics["loss"]),
                             grad_norm=float(metrics["grad_norm"]), ms=ms,
                             peak=peak,
                             param_bytes=tp_bytes(state["params"]),
                             moment_bytes=tp_bytes(state["opt"]))
            if run in TP_MOMENTS_OVER_TREE:
                control = tp_step(torch, dev, run, None, perturb=True)[0]
                refs[run]["control"] = state_rel(torch, control, state)
                del control
            # (d) one process serving what the ranks serve
            serve_refs[run] = {q_: tp_serve(torch, kernel, dev, run, q_)
                               for q_ in ("off", "int8")}
        kernel.LAUNCHES.update(saved)

    one_process([run for run in TP_RUNS if run not in TP_REF_AFTER_JOIN])
    t_ref = time.perf_counter() - t_phase
    # (c) the shard shapes against their plain versions while the ranks
    # finish (their timing waits for the ranks' exit); (d)'s serve shard
    # shapes at the rows the ranks launch them
    shapes = [c for run in TP_RUNS for c in TP_SHAPES[run]] + TP_SPLIT_SHAPES
    serve_rows = {name: rows for run, (_, shape) in TP_RUNS.items()
                  for name, rows in tp_serve_rows(run, shape).items()}
    serve_shapes = [c for run in TP_RUNS for c in TP_SERVE_SHAPES[run]]
    mm_abs = phase_hybrid_kernels(
        torch, kernel, quant, dev,
        {**{c[0]: {c[5]} for c in shapes}, **serve_rows},
        shapes=[c[:5] for c in shapes] + [c[:5] for c in serve_shapes],
        label="tp", seed=20)
    gen = torch.Generator(device=dev).manual_seed(21)
    dw_abs = 0.0
    dw_shapes = [c for run in TP_RUNS for c in TP_DW_SHAPES[run]]
    for name, G, P, Q, _, B in dw_shapes:
        lead = (G,) if G > 1 else ()
        x32 = torch.randn(*lead, B, Q * K, generator=gen, device=dev)
        g32 = torch.randn(*lead, B, P * K, generator=gen, device=dev)
        dw_abs = max(dw_abs, check_dw(torch, kernel, x32, g32, P, Q, K,
                                      name))
    print(f"tp bc_dw checks: {4 * len(dw_shapes)} passed at "
          f"{[(n, G, P, Q, B) for n, G, P, Q, _, B in dw_shapes]}, k = {K}, "
          f"both epilogues, f32 and bf16 inputs (rel <= {FP32_TOL} x max(1, "
          f"B/{DW_TOL_ROWS}); repeat launches bit-identical); max abs err "
          f"(f32) = {dw_abs!r}")
    t_checks = time.perf_counter() - t_phase
    outs = tp_join(procs, q)
    t0 = min(o["t_card"] for run in TP_RUNS for o in outs[run])
    print("tp ranks on the card (s after the first one reached it; "
          "TP_RANKS_AFTER's waves): " + ", ".join(
              f"({run}) {min(o['t_card'] for o in outs[run]) - t0:.1f}-"
              f"{max(o['t_done'] for o in outs[run]) - t0:.1f}"
              for run in sorted(TP_RUNS, key=lambda r: min(
                  o["t_card"] for o in outs[r]))))
    one_process(TP_REF_AFTER_JOIN)
    t_join = time.perf_counter() - t_phase
    report = {}
    for run, (arch, shape) in TP_RUNS.items():
        ref, ranks = refs.pop(run), outs[run]
        t = time.perf_counter()
        rel_p, rel_leaf, rel_m, rel_mt, step = tp_compare(
            torch, ref["state"], os.path.join(tmp, run), dev)
        restore_s = time.perf_counter() - t
        del ref["state"]
        torch.cuda.empty_cache()
        held = rel_mt if run in TP_MOMENTS_OVER_TREE else rel_m
        if not (rel_p <= TP_TOL and held <= TP_TOL and step == 2):
            fail(f"tp ({run}) {arch} on {shape}: the ranks' state vs one "
                 f"process's: params rel {rel_p!r}, moments rel {rel_m!r} "
                 f"leaf by leaf and {rel_mt!r} over the tree (limit "
                 f"{TP_TOL} on the "
                 f"{'tree' if run in TP_MOMENTS_OVER_TREE else 'leaves'}), "
                 f"step {step}")
        coll = {o["collectives"] for o in ranks}
        for o in ranks:
            if o["launches"] != TP_LAUNCHES[run]:
                fail(f"tp ({run}) rank {o['rank']}: launches "
                     f"{o['launches']} != {TP_LAUNCHES[run]}")
            for key in ("loss", "grad_norm"):
                e = abs(o[key] - ref[key]) / abs(ref[key])
                if not e <= TP_TOL:
                    fail(f"tp ({run}) rank {o['rank']}: {key} {o[key]!r} "
                         f"vs one process's {ref[key]!r}")
            if run in TP_FSDP and not o["peak"] < ref["peak"]:
                fail(f"tp ({run}) rank {o['rank']}: peak device memory "
                     f"{o['peak']} B is not below one process's "
                     f"{ref['peak']} B")
        if len(coll) != 1:
            fail(f"tp ({run}): the ranks issued {sorted(coll)} collectives")
        o0 = ranks[0]
        per_coll = o0["comm_bytes"] / max(o0["collectives"], 1)
        control = ref.get("control")
        control_txt = "" if control is None else (
            f" (the control, one process's step again with its embedding "
            f"table times 1 + {TP_CONTROL_NOISE} noise: params rel "
            f"{control[0]!r} over the tree, {control[1]!r} leaf by leaf; "
            f"moments {control[2]!r} leaf by leaf and {control[3]!r} over "
            f"the tree)")
        print(f"tp ({run}) {arch} cut to {tp_depth(tp_config(run))} layers "
              f"at full width, "
              f"f32, AdamW, on mesh (data={shape[0]}, model={shape[1]}) = "
              f"{len(ranks)} gloo ranks on cuda:0 (collectives staged "
              f"through host memory)"
              f"{', fsdp=True' if run in TP_FSDP else ''}; "
              f"one step at step 1 of the schedule, batch "
              f"{tp_batch_rows(run)} x seq {TRAIN_SEQ}: params rel "
              f"{rel_p!r} over the tree (leaf "
              f"by leaf {rel_leaf!r}), moments rel {rel_m!r} leaf by leaf "
              f"and {rel_mt!r} over the tree (limit {TP_TOL} on the "
              f"{'tree' if run in TP_MOMENTS_OVER_TREE else 'leaves'})"
              f"{control_txt}, "
              f"through the ranks' checkpoint saved whole "
              f"and restored onto one process ({restore_s:.1f} s restore, "
              f"{max(o['save_s'] for o in ranks):.1f} s save); loss "
              f"{o0['loss']!r} vs {ref['loss']!r}, grad norm "
              f"{o0['grad_norm']!r} vs {ref['grad_norm']!r}; K/V "
              f"{o0['kv']}; Mamba channels per rank "
              f"{[o['mamba'] for o in ranks]}; RWKV heads per rank "
              f"{[o['rwkv'] for o in ranks]}; per rank per step: launches "
              f"{o0['launches']} "
              f"(pinned), {o0['collectives']} collectives, "
              f"{o0['comm_bytes']} B sent ({per_coll:.0f} B per "
              f"collective); per rank: params {o0['param_bytes']} B and "
              f"moments {o0['moment_bytes']} B vs one process's "
              f"{ref['param_bytes']} B and {ref['moment_bytes']} B; peak "
              f"device memory per rank "
              f"{[o['peak'] for o in ranks]} B vs one process's "
              f"{ref['peak']} B; step wall "
              f"{[round(o['ms'], 1) for o in ranks]} ms per rank vs "
              f"{ref['ms']:.1f} ms in one process ({CARD[0]})")
        report[run] = dict(arch=arch, mesh=shape, rel_params=rel_p,
                           rel_params_leaf=rel_leaf, rel_moments=rel_m,
                           rel_moments_tree=rel_mt, control=control,
                           loss=o0["loss"], ref_loss=ref["loss"],
                           launches=o0["launches"],
                           collectives=o0["collectives"],
                           comm_bytes=o0["comm_bytes"],
                           param_bytes=o0["param_bytes"],
                           moment_bytes=o0["moment_bytes"],
                           ref_param_bytes=ref["param_bytes"],
                           ref_moment_bytes=ref["moment_bytes"],
                           peak=[o["peak"] for o in ranks],
                           ref_peak=ref["peak"],
                           ms=[o["ms"] for o in ranks], ref_ms=ref["ms"],
                           save_s=max(o["save_s"] for o in ranks),
                           restore_s=restore_s, kv=o0["kv"],
                           mamba=[o["mamba"] for o in ranks],
                           rwkv=[o["rwkv"] for o in ranks])
    for run, (arch, shape) in TP_RUNS.items():
        report[run]["serve"] = tp_serve_compare(run, arch, shape, outs[run],
                                                serve_refs[run])
    t_cmp = time.perf_counter() - t_phase
    # each distinct (groups, p, q, rows) timed once: a dx launch runs the
    # transposed grid of another layer's forward
    distinct = {}
    for name, G, p, q, per, B in (c for run in TP_RUNS
                                  for c in TP_SHAPES[run]):
        n, total = distinct.get((G, p, q, B), ("", 0))
        distinct[(G, p, q, B)] = (f"{n} + {name}" if n else name,
                                  total + per)
    times = phase_hybrid_times(
        torch, kernel, dev, [(n, G, p, q, per, B) for (G, p, q, B), (n, per)
                             in distinct.items()], label="tp", seed=22)
    times += phase_hybrid_times(
        torch, kernel, dev, [(n, G, p, q, per, B)
                             for n, G, p, q, per in serve_shapes
                             for B in sorted(serve_rows[n])],
        label="tp serve", seed=23)
    dw_times = phase_dw_group_times(
        torch, kernel, dev, [(n, G, P, Q, B, per)
                             for n, G, P, Q, per, B in dw_shapes], label="tp")
    secs = time.perf_counter() - t_phase
    print(f"tp phase: {secs:.1f}s after the analysis phase (one-process "
          f"steps until {t_ref:.1f}s, kernel checks until {t_checks:.1f}s, "
          f"waiting for the ranks and the one-process steps of "
          f"{list(TP_REF_AFTER_JOIN)} until {t_join:.1f}s, their checkpoints "
          f"held to the steps until {t_cmp:.1f}s, then the times)")
    launches = {k: sum(o["launches"][k] for run in TP_RUNS
                       for o in outs[run]) for k in ("bc_matmul", "bc_dw")}
    launches["bc_matmul"] += sum(o["serve_launches"] for run in TP_RUNS
                                 for o in outs[run])
    report.update(seconds=secs, mm_abs=mm_abs, dw_abs=dw_abs)
    rows = {c[5] for c in shapes if c[1] == 1} | {
        r for c in serve_shapes if c[1] == 1 for r in serve_rows[c[0]]}
    return report, launches, rows, times, dw_times


def tp_serve_compare(run, arch, shape, ranks, refs):
    """(d): every rank's serve against one process's, f32 and int8:
    greedy tokens equal at every step, the last step's logits of its rows
    within TP_TOL (f32) or TP_SERVE_INT8_TOL (int8), launches pinned;
    printed with collectives, bytes and times. Returns the report row."""
    import numpy as np

    out = {}
    want_pre, want_dec = TP_SERVE_LAUNCHES[run]
    for q_, tol in (("off", TP_TOL), ("int8", TP_SERVE_INT8_TOL)):
        ref = refs[q_]
        errs = []
        for o in ranks:
            got = o["serve"][q_]
            if len(got["tokens"]) != len(ref["tokens"]) or not all(
                    np.array_equal(a, b)
                    for a, b in zip(got["tokens"], ref["tokens"])):
                fail(f"tp (d) ({run}) {arch} {q_} rank {o['rank']}: greedy "
                     f"tokens differ from one process's")
            a, b = got["rows"]
            errs.append(rel_err(torch_from(got["logits"]),
                                torch_from(ref["logits"][a:b])))
            if not errs[-1] <= tol:
                fail(f"tp (d) ({run}) {arch} {q_} rank {o['rank']}: last "
                     f"logits rel {errs[-1]!r} > {tol}")
            if (got["prefill_launches"], got["decode_launches"]) != (
                    want_pre, [want_dec]):
                fail(f"tp (d) ({run}) rank {o['rank']} {q_}: launches per "
                     f"prefill / decode step {got['prefill_launches']} / "
                     f"{got['decode_launches']} != {want_pre} / {want_dec}")
        o0 = ranks[0]["serve"][q_]
        busy = (f"; busy ms prefill "
                f"{[o['serve'][q_]['prefill_busy_ms'] for o in ranks]} (one "
                f"process {ref['prefill_busy_ms']!r}), decode step "
                f"{[o['serve'][q_]['decode_busy_ms'] for o in ranks]} "
                f"({ref['decode_busy_ms']!r})" if q_ == "off" else "")
        if any(o["serve"][q_][k] != o0[k] for o in ranks
               for k in ("prefill_coll", "decode_coll")):
            fail(f"tp (d) ({run}) {q_}: the ranks issued different "
                 f"collectives")
        B, P, steps = TP_SERVE
        print(f"tp (d) ({run}) {arch} serving at "
              f"{tp_depth(tp_serve_config(run))} layers, full width, "
              f"f32 compute, frozen {'f32' if q_ == 'off' else 'int8'} "
              f"tables, on (data={shape[0]}, model={shape[1]}): {B} prompts "
              f"x {P} tokens then {steps} greedy steps; tokens equal to one "
              f"process's at every step on every rank; last logits rel "
              f"{errs} (limit {tol}); rows per rank {o0['rows']}; launches "
              f"per prefill {o0['prefill_launches']} and per decode step "
              f"{o0['decode_launches'][0]} (pinned); collectives (count, "
              f"bytes) per prefill {o0['prefill_coll']} and per decode step "
              f"{o0['decode_coll']}; per rank params "
              f"{[o['serve'][q_]['param_bytes'] for o in ranks]} B and cache "
              f"{o0['cache_bytes']} B vs one process's {ref['param_bytes']} "
              f"and {ref['cache_bytes']} B; wall ms prefill "
              f"{[round(o['serve'][q_]['prefill_ms'], 2) for o in ranks]} "
              f"(one process {ref['prefill_ms']:.2f}), decode step median "
              f"{[round(o['serve'][q_]['decode_ms'], 2) for o in ranks]} "
              f"({ref['decode_ms']:.2f}){busy} ({CARD[0]})")
        out[q_] = dict(rel_logits=max(errs), rows=o0["rows"],
                       prefill_launches=o0["prefill_launches"],
                       decode_launches=o0["decode_launches"][0],
                       prefill_coll=o0["prefill_coll"],
                       decode_coll=o0["decode_coll"],
                       param_bytes=[o["serve"][q_]["param_bytes"]
                                    for o in ranks],
                       cache_bytes=o0["cache_bytes"],
                       ref_param_bytes=ref["param_bytes"],
                       ref_cache_bytes=ref["cache_bytes"],
                       prefill_ms=[o["serve"][q_]["prefill_ms"]
                                   for o in ranks],
                       decode_ms=[o["serve"][q_]["decode_ms"] for o in ranks],
                       ref_prefill_ms=ref["prefill_ms"],
                       ref_decode_ms=ref["decode_ms"])
        if q_ == "off":
            out[q_].update(
                prefill_busy_ms=[o["serve"][q_]["prefill_busy_ms"]
                                 for o in ranks],
                decode_busy_ms=[o["serve"][q_]["decode_busy_ms"]
                                for o in ranks],
                ref_prefill_busy_ms=ref["prefill_busy_ms"],
                ref_decode_busy_ms=ref["decode_busy_ms"])
    return out


def torch_from(a):
    import torch

    return torch.from_numpy(a)


def main() -> int:
    t_start = time.perf_counter()
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
    CARD[0] = smi.stdout.strip().splitlines()[0]
    print(CARD[0])
    # the dry-run's cells on the CPU, beside the kernels' build and
    # the first serve path; joined in the tp phase
    dry_procs = dryrun_start(tempfile.mkdtemp(prefix="chip_smoke_dryrun_"))

    marks = [t_start]

    def lap(name):
        """Print the seconds since the last lap: where the command's
        time goes, phase by phase."""
        now = time.perf_counter()
        print(f"time: {name} {now - marks[0]:.1f}s (command "
              f"{now - t_start:.1f}s)")
        marks[0] = now

    t0 = time.perf_counter()
    libs = kernel.build()
    print(f"built {sorted(lib.name for lib, _ in libs.values())} in "
          f"{time.perf_counter() - t0:.2f}s")
    for name, (_, log) in sorted(libs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    (cfg, engine, params, reqs, serve_launches, step_ms, serve_rows,
     serve_outs) = phase_serve(torch, dev)
    decode_busy = phase_profile(torch, engine, reqs, step_ms)
    lap("build, serve")
    resilient, resilient_rows = phase_serve_resilient(torch, kernel, dev)
    durable, durable_rows = phase_durable(torch, kernel, dev)
    tier, tier_rows = phase_serve_tier(torch, kernel, dev, cfg, params,
                                       reqs, serve_outs)
    lap("serve_resilient, durable, serve_tier")
    train_cfg, train_launches, train_ms, train_rows, train_busy = \
        phase_train(torch, dev)
    dist_row, dist_launches, dist_rows = phase_dist(
        torch, kernel, dev, train_busy, decode_busy, step_ms, train_ms)
    lap("train, dist")
    for run in TP_RUNS:
        mm = sum(c[4] for c in TP_SHAPES[run])
        dw = sum(c[4] for c in TP_DW_SHAPES[run])
        if {"bc_matmul": mm, "bc_dw": dw} != TP_LAUNCHES[run]:
            fail(f"TP_SHAPES' launches of ({run}) do not sum to "
                 f"{TP_LAUNCHES[run]}")
        if sum(c[4] for c in TP_SERVE_SHAPES[run]) != \
                TP_SERVE_LAUNCHES[run][0]:
            fail(f"TP_SERVE_SHAPES' launches of ({run}) do not sum to "
                 f"{TP_SERVE_LAUNCHES[run][0]}")
    import shutil

    tp_tmp = tempfile.mkdtemp(prefix="chip_smoke_tp_")
    print(f"tp: checkpoints under {tp_tmp}, "
          f"{shutil.disk_usage(tp_tmp).free / 2**30:.1f} GiB free")
    card_memory = card_memory_sampler(torch)
    tp_procs, tp_q, tp_done = tp_spawn(tp_tmp)
    try:
        analysis_row, analysis_launches = phase_analysis(torch, kernel, dev,
                                                         engine)
        tp_row, tp_launches, tp_rows, tp_times, tp_dw_times = phase_tp(
            torch, kernel, quant, dev, tp_procs, tp_q, tp_tmp)
        used, at, mine, total = card_memory()
        tp_row["card_peak_bytes"] = used
        print(f"tp: card memory in use at most {used} B of {total} B "
              f"(every process's, sampled every 50 ms from the ranks' start "
              f"to the end of the tp phase), {at:.1f}s after their start, "
              f"this process then reserving {mine} B ({CARD[0]})")
        tp_row["dryrun"] = dryrun_join(torch, dry_procs)
    finally:
        card_memory()
        for p in tp_procs:
            if p.is_alive():
                p.kill()
        del tp_done
        shutil.rmtree(tp_tmp, ignore_errors=True)
    lap("analysis, tp")
    max_abs = phase_kernels(
        torch, kernel, quant, dev,
        sorted({1, 4, 512, train_rows} | serve_rows | resilient_rows
               | durable_rows | tier_rows | dist_rows | tp_rows))
    dw_abs = phase_dw(torch, kernel, dev,
                      sorted({512, train_rows, *DW_EXTRA_ROWS} | dist_rows
                             | tp_rows))
    print("kernels: [\"bc_matmul\", \"bc_dw\"]")
    lap("kernel checks")
    phase_cpu_vs_card(torch, cfg, engine, reqs[0])
    train_step_card_vs_cpu(torch, train_cfg, dev, "qwen3-0.6b")
    CPU_CHECKS.result(("train", "qwen3-0.6b"))
    phase_int8(torch, cfg, params, dev, engine.frozen_table_bytes())
    rows = phase_times(
        torch, kernel, dev,
        [(n, p, q, per, B) for n, p, q, per in SLICE_SHAPES for B in (4, 512)]
        + [(n, p, q, per, train_rows) for n, p, q, per in DX_SHAPES])
    host = phase_host_time(torch, kernel, dev)
    dw_rows = phase_dw_times(torch, kernel, dev, train_rows)
    lap("card vs cpu, int8, kernel times")
    paper_rows, paper_mm = phase_paper(torch, kernel, dev)
    paper_train, paper_train_launches = phase_paper_train(torch, kernel, dev)
    paper_mm_abs, paper_dw_abs = phase_paper_kernels(torch, kernel, quant,
                                                     dev)
    paper_times, paper_dw_rows = phase_paper_times(torch, kernel, dev)
    paper_launches = {"bc_matmul": paper_mm
                      + paper_train_launches["bc_matmul"],
                      "bc_dw": paper_train_launches["bc_dw"]}
    lap("paper")

    for arch, prefix in (("jamba-v0.1-52b", "jamba."), ("rwkv6-7b", "rwkv.")):
        if sum(c[4] for c in HYBRID_SHAPES
               if c[0].startswith(prefix)) != HYBRID_LAUNCHES[arch]:
            fail(f"HYBRID_SHAPES' launches do not sum to {arch}'s "
                 f"{HYBRID_LAUNCHES[arch]}")
    hybrid_rows, hybrid_counts = [], {1}
    for arch in HYBRID_LAUNCHES:
        row, counts = phase_hybrid(torch, kernel, dev, arch)
        hybrid_rows.append(row)
        hybrid_counts |= counts
    # the queued CPU passes run beside device-timed work only (CpuChecks)
    with CPU_CHECKS.window():
        hybrid_abs = phase_hybrid_kernels(
            torch, kernel, quant, dev, {c[0]: hybrid_counts
                                        for c in HYBRID_SHAPES})
        hybrid_times = phase_hybrid_times(
            torch, kernel, dev, [(n, G, p, q, per, B)
                                 for n, G, p, q, per in HYBRID_SHAPES
                                 for B in HYBRID_TIME_ROWS])
    hybrid_launches = {r["model"]: r["launches"] for r in hybrid_rows}
    lap("hybrid")

    for arch, shapes in FAMILY_SHAPES.items():
        want = family_per_forward(arch, serve_cfg(arch,
                                                   FAMILY_DEPTHS[arch][0]))
        if sum(c[4] for c in shapes) != want:
            fail(f"FAMILY_SHAPES' launches do not sum to {arch}'s {want}")
    family_rows, family_counts = [], {}
    for arch in FAMILY_LAUNCHES:
        row, counts = phase_family(torch, kernel, dev, arch)
        family_rows.append(row)
        family_counts.update((c[0], counts) for c in FAMILY_SHAPES[arch])
    with CPU_CHECKS.window():
        family_abs = phase_hybrid_kernels(
            torch, kernel, quant, dev, family_counts,
            shapes=[c for shapes in FAMILY_SHAPES.values() for c in shapes],
            label="family", seed=10)
        family_times = phase_hybrid_times(
            torch, kernel, dev,
            [(n, G, p, q, per, B) for arch, shapes in FAMILY_SHAPES.items()
             for n, G, p, q, per in shapes
             for B in (GEMMA_TIME_ROWS if arch == "gemma3-27b"
                       else FAMILY_TIME_ROWS)], label="family", seed=11)
    family_launches = {r["model"]: r["launches"] for r in family_rows}
    lap("family")

    if tuple(sum(c[i] for c in ENCDEC_SHAPES) for i in (4, 5)) != \
            ENCDEC_LAUNCHES:
        fail(f"ENCDEC_SHAPES' launches do not sum to {ENCDEC_LAUNCHES}")
    encdec_row, encdec_counts = phase_encdec(torch, kernel, dev)
    with CPU_CHECKS.window():
        encdec_abs = phase_hybrid_kernels(
            torch, kernel, quant, dev, {c[0]: encdec_counts | {512}
                                        for c in ENCDEC_SHAPES},
            shapes=[c[:5] for c in ENCDEC_SHAPES], label="encdec", seed=12)
        encdec_times = phase_hybrid_times(
            torch, kernel, dev, [(n, G, p, q, per, B)
                                 for n, G, p, q, per, _ in ENCDEC_SHAPES
                                 for B in ENCDEC_TIME_ROWS],
            label="encdec", seed=13)
    example_rows = phase_examples(torch, kernel, dev)
    example_launches = {name: sum(r["launches"][name] for r in example_rows)
                        for name in ("bc_matmul", "bc_dw")}
    lap("encdec, examples")

    for arch, shapes in TRAIN_FAMILY_SHAPES.items():
        if tuple(sum(c[i] for c in shapes) for i in (5, 6)) != \
                TRAIN_FAMILY_LAUNCHES[arch]:
            fail(f"TRAIN_FAMILY_SHAPES' launches do not sum to {arch}'s "
                 f"{TRAIN_FAMILY_LAUNCHES[arch]}")
    tf_rows = [phase_train_family(torch, kernel, dev, arch)
               for arch in TRAIN_FAMILY_LAUNCHES]
    tf_shapes = [c for shapes in TRAIN_FAMILY_SHAPES.values() for c in shapes]
    with CPU_CHECKS.window():
        tf_abs = phase_hybrid_kernels(
            torch, kernel, quant, dev, {c[0]: {c[4]} for c in tf_shapes},
            shapes=[c[:5] for c in tf_shapes], label="train_family",
            seed=16)
        tf_dw_abs = phase_train_family_dw(torch, kernel, dev)
        tf_times = phase_hybrid_times(
            torch, kernel, dev, [(n, G, p, q, mm, B)
                                 for n, G, p, q, B, mm, _ in tf_shapes],
            label="train_family", seed=17)
        tf_dw_rows = phase_dw_group_times(
            torch, kernel, dev, [(n, G, p, q, B, dw)
                                 for n, G, p, q, B, _, dw in tf_shapes
                                 if dw])
    tf_launches = {r["model"]: r["launches"] for r in tf_rows}
    lap("train_family")
    remat_rows = phase_scan_remat(torch, kernel, dev)
    remat_launches = {name: sum(r["launches"][name] for r in remat_rows)
                      for name in ("bc_matmul", "bc_dw")}
    dft_row = phase_dft(torch, kernel, dev, train_busy)
    lap("scan_remat, dft")
    # the CPU passes that their windows did not finish run here
    settle(hybrid_rows, "serve", ("cpu_vs_card_rel_err",))
    settle(family_rows, "serve", ("cpu_vs_card_rel_err", "argmax_equal",
                                  "cpu_seconds"))
    settle([encdec_row], "serve", ("cpu_vs_card_rel_err", "argmax_equal",
                                   "cpu_seconds"))
    settle(tf_rows, "train", ("cpu_vs_card_loss_rel_err",
                              "cpu_vs_card_grad_norm_rel_err",
                              "cpu_seconds"))
    lap("cpu checks")

    main_row = next(r for r in rows if r["shape"] == "qkv" and r["B"] == 4)
    dw_row = next(r for r in dw_rows if r["shape"] == "qkv")
    report = {"kernels": [{
        "name": "bc_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/block_circulant/csrc/bc_matmul.cu",
        "replaces": "src/repro/kernels/block_circulant/kernel.py:220",
        "launches": (serve_launches + resilient["launches"]
                     + durable["launches"]["bc_matmul"]
                     + tier["launches"]
                     + train_launches["bc_matmul"]
                     + dist_launches["bc_matmul"]
                     + analysis_launches["bc_matmul"]
                     + tp_launches["bc_matmul"]
                     + paper_launches["bc_matmul"]
                     + sum(hybrid_launches.values())
                     + sum(family_launches.values())
                     + encdec_row["launches"]
                     + example_launches["bc_matmul"]
                     + sum(v["bc_matmul"] for v in tf_launches.values())
                     + remat_launches["bc_matmul"]),
        "launches_by_path": {"serve": serve_launches,
                             "serve_resilient": resilient["launches"],
                             "durable": durable["launches"]["bc_matmul"],
                             "serve_tier": tier["launches"],
                             "train": train_launches["bc_matmul"],
                             "dist": dist_launches["bc_matmul"],
                             "analysis": analysis_launches["bc_matmul"],
                             "tp": tp_launches["bc_matmul"],
                             "paper": paper_launches["bc_matmul"],
                             "hybrid": hybrid_launches["jamba-v0.1-52b"],
                             "rwkv": hybrid_launches["rwkv6-7b"],
                             **family_launches,
                             "encdec": encdec_row["launches"],
                             "examples": example_launches["bc_matmul"],
                             **{f"train_family {a}": v["bc_matmul"]
                                for a, v in tf_launches.items()},
                             "scan_remat": remat_launches["bc_matmul"]},
        "max_abs_err": max(max_abs, paper_mm_abs, hybrid_abs, family_abs,
                           encdec_abs, tf_abs, tp_row["mm_abs"]),
        "ms": main_row["ms"],
        "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"],
        "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"],
        "shape": "fused QKV at decode: x (4, 1024) bf16, tables "
                 "(32, 8, 65) f32, k=128",
        **host,
        "all_shapes": (rows + paper_times + hybrid_times + family_times
                       + encdec_times + tf_times + tp_times),
    }, {
        "name": "bc_dw",
        "route": "cuda",
        "source": "src/repro_torch/kernels/block_circulant/csrc/bc_dw.cu",
        "replaces": "src/repro/kernels/block_circulant/kernel.py:374",
        "launches": (train_launches["bc_dw"] + dist_launches["bc_dw"]
                     + analysis_launches["bc_dw"] + tp_launches["bc_dw"]
                     + paper_launches["bc_dw"]
                     + durable["launches"]["bc_dw"]
                     + example_launches["bc_dw"]
                     + sum(v["bc_dw"] for v in tf_launches.values())
                     + remat_launches["bc_dw"]),
        "launches_by_path": {"train": train_launches["bc_dw"],
                             "dist": dist_launches["bc_dw"],
                             "analysis": analysis_launches["bc_dw"],
                             "tp": tp_launches["bc_dw"],
                             "durable": durable["launches"]["bc_dw"],
                             "paper": paper_launches["bc_dw"],
                             "examples": example_launches["bc_dw"],
                             **{f"train_family {a}": v["bc_dw"]
                                for a, v in tf_launches.items()},
                             "scan_remat": remat_launches["bc_dw"]},
        "max_abs_err": max(dw_abs, paper_dw_abs, tf_dw_abs,
                           tp_row["dw_abs"]),
        "ms": dw_row["ms"],
        "plain_ms": dw_row["plain_ms"],
        "bound_ms": dw_row["bound_ms"],
        "bound_by": dw_row["bound_by"],
        "library_ms": None,
        "dense_dw_matmul_ms": dw_row["dense_dw_matmul_ms"],
        "shape": f"fused QKV weight adjoint in training: x ({train_rows}, "
                 f"1024) and g ({train_rows}, 4096) bf16, dw (32, 1024) "
                 f"f32, k=128",
        "all_shapes": dw_rows + paper_dw_rows + tf_dw_rows + tp_dw_times,
    }], "train": {"ms_per_step": train_ms,
                  "tokens_per_s": train_rows / train_ms * 1e3},
        "paper": paper_rows + [paper_train], "hybrid": hybrid_rows,
        "family": family_rows, "encdec": encdec_row,
        "examples": example_rows, "train_family": tf_rows,
        "scan_remat": remat_rows, "dft": dft_row,
        "serve_resilient": resilient, "durable": durable,
        "serve_tier": tier, "dist": dist_row, "analysis": analysis_row,
        "tp": tp_row}
    print(f"command time {time.perf_counter() - t_start:.1f}s")
    print(json.dumps(report))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
