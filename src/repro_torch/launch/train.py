"""Training launcher: one device, synthetic data, a per-step line.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --steps 10 --seq 256 --batch 8                   # on the card
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \
        --smoke --steps 4 --device cpu                    # on the CPU

Builds the model and seeded params on ``--device`` (default ``cuda``;
raises without a card unless ``--device cpu``), then runs
``make_train_step`` over ``SyntheticLM`` batches under the fault-tolerant
``ft.driver.TrainDriver``: an async checkpoint every ``--ckpt-every``
steps into ``--ckpt-dir`` (default ``repro_ckpt`` under the temp
directory), and on a step failure a restore of the latest checkpoint and a
resume. Prints the reference's ``step … loss … (… ms)`` line for the last
5 steps run, then ``restarts=… straggler_events=…``. Without ``--seq`` /
``--batch`` the shape is ``train_4k``'s (``--smoke``: 64 × 8). The
circulant implementation comes from the config (qwen3-0.6b's says
``paper``, ``torch.fft``; the kernel path is ``SWMConfig(impl="pallas")``,
as ``chip_smoke.py`` builds it).

The batches are ``SyntheticLM`` tokens alone, as the reference
launcher's: the lm-family archs train (the MoE ones with their experts
through the grouped kernels on the kernel path) and paligemma-3b trains
text-only; an enc-dec arch stops at its first step, whose batch has no
``frames``, as in the reference.

The reference launcher's mesh, sharded state and host-sharded batches
wait for the port's ``dist`` layer.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch

from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.ft.driver import TrainDriver
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.train.loop import init_train_state, make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="",
                    help=f"registry model name, one of {sorted(ARCHS)}")
    ap.add_argument("--model", default="", help="alias for --arch")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config + small synthetic shapes")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=0)
    ap.add_argument("--batch", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda", help="cuda (default) | cpu")
    args = ap.parse_args(argv)
    arch = args.arch or args.model
    if not arch:
        ap.error("--arch (or --model) is required")

    dev = resolve_device(args.device)
    cfg = get_smoke(arch) if args.smoke else get_config(arch)
    shape = SHAPES["train_4k"]
    seq = args.seq or (64 if args.smoke else shape.seq_len)
    batch = args.batch or (8 if args.smoke else shape.global_batch)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       microbatch=args.microbatch,
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir,
                       z_loss=0.0 if args.smoke else 1e-4)

    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), tcfg.seed, device=dev)
    state = init_train_state(params, tcfg, cfg.optimizer)
    step_fn = make_train_step(model, cfg, tcfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch,
                       seed=tcfg.seed)

    def data_fn(step: int):
        return {"tokens": torch.from_numpy(
            data.batch_np(step)["tokens"]).to(dev)}

    driver = TrainDriver(step_fn, tcfg, data_fn)
    state = driver.run(state, n_steps=args.steps)
    for m in driver.metrics_log[-5:]:
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"({m['dt'] * 1e3:.0f} ms)")
    print(f"restarts={driver.restarts} "
          f"straggler_events={len(driver.watchdog.events)}")
    return driver


if __name__ == "__main__":
    main()
