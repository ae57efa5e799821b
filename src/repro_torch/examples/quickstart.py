"""Quickstart on the port: train a small SWM (block-circulant) language
model, the torch version of ``examples/quickstart.py``.

Set ``swm.block_size=k`` on a config and every projection becomes a
circulant block table (k× less storage), trained with the ordinary AdamW
loop. The same config (4 layers, d_model 128, ``block_size=16``,
``impl="dft"``, f32), optimizer settings and data as the reference; the
loss should drop by more than 2 nats over the 200 steps.

    PYTHONPATH=src python -m repro_torch.examples.quickstart
    PYTHONPATH=src python -m repro_torch.examples.quickstart --device cpu \
        --steps 20

Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import ModelConfig, SWMConfig, TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.launch.specs import count_params
from repro_torch.models.decoder import HybridDecoderLM
from repro_torch.nn.module import init_params, tree_map
from repro_torch.train.loop import init_train_state, make_train_step

CONFIG = ModelConfig(
    name="quickstart-swm-lm",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2, head_dim=32,
    d_ff=512, vocab=512,
    swm=SWMConfig(block_size=16, impl="dft"),   # <-- the paper, one line
    remat="none", param_dtype="float32", compute_dtype="float32",
)
SEQ, BATCH = 64, 16


def run(steps: int = 200, device="cuda", params=None):
    """Train CONFIG for ``steps`` AdamW steps on ``device`` from ``params``
    (a tree keyed like the model's specs, copied; default: the port's
    seeded init). Returns (count_params' counts, per-step losses)."""
    dev = resolve_device(device)
    cfg = CONFIG
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=20,
                       total_steps=steps, z_loss=0.0)
    model = HybridDecoderLM(cfg, device=dev)
    counts = count_params(cfg)
    print(f"params: {counts['stored']:,} stored "
          f"({counts['dense']:,} dense-equivalent → "
          f"{counts['compression']:.1f}x compression)")
    if params is None:
        params = init_params(model.specs(), seed=0, device=dev)
    state = init_train_state(
        tree_map(lambda t: t.detach().to(dev).clone(), params), tcfg)
    step = make_train_step(model, cfg, tcfg)
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH)
    losses = []
    for s in range(steps):
        tokens = torch.from_numpy(data.batch_np(s)["tokens"]).to(dev)
        state, metrics = step(state, {"tokens": tokens})
        losses.append(float(metrics["loss"]))
        if s % 25 == 0 or s == steps - 1:
            print(f"step {s:4d}  loss {losses[-1]:8.4f}  "
                  f"grad_norm {float(metrics['grad_norm']):7.3f}")
    return counts, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=200)
    args = ap.parse_args(argv)
    counts, losses = run(args.steps, args.device)
    print("done — loss should have dropped by >2 nats.")
    return counts, losses


if __name__ == "__main__":
    main()
