"""Paper §6.1 LSTM end to end on the port: train the SWM-LSTM
(Google-LSTM geometry, TIMIT-like synthetic frames) at FFT8/FFT16 block
sizes and report per-frame accuracy (a proxy for 1-PER) and model-size
reduction against the dense LSTM, as ``examples/lstm_asr.py``.

    PYTHONPATH=src python -m repro_torch.examples.lstm_asr
    PYTHONPATH=src python -m repro_torch.examples.lstm_asr --device cpu \
        --steps 10

The same model (``SWMLSTMASR(d_cell=256, d_proj=128, block_size=k)``), data
(``synthetic_speech``, B = 16, T = 24), loss, AdamW schedule and evaluation
as the reference. The model takes its default impl, as in the reference
(``SWMLSTMASR`` has no impl field, so its cells run ``torch.fft``, not the
kernel). Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import synthetic_speech
from repro_torch.device import resolve_device
from repro_torch.models.paper_models import SWMLSTMASR
from repro_torch.nn.module import (init_params, load_tree, param_count,
                                   tree_map)
from repro_torch.optim.optimizers import adamw_update
from repro_torch.train.loop import init_train_state, value_and_grad

B, T, D_IN = 16, 24, 153
EVAL_STEPS = range(500, 504)


def train_one(block_size: int, steps: int = 250, device="cuda", params=None):
    """Train at ``block_size`` (0 = dense) for ``steps`` AdamW steps from
    ``params`` (a tree keyed like ``SWMLSTMASR.specs()``, copied; default:
    the port's seeded init) and evaluate on 4 held-out batches. Returns
    (frame accuracy, parameter count, per-step losses)."""
    dev = resolve_device(device)
    model = SWMLSTMASR(d_cell=256, d_proj=128, block_size=block_size)
    tcfg = TrainConfig(learning_rate=8e-3, warmup_steps=10, total_steps=steps,
                       weight_decay=0.0)
    if params is None:
        params = init_params(model.specs(), 0, device=dev)
    state = init_train_state(
        tree_map(lambda t: t.detach().to(dev).clone(), params), tcfg)
    params, opt = state["params"], state["opt"]

    def loss_fn(p, batch):
        load_tree(model, p)
        lp = torch.log_softmax(model(batch["x"]), -1)
        return -lp.gather(-1, batch["y"][..., None].long()).mean()

    losses = []
    for i in range(steps):
        x, y = synthetic_speech(B, T, D_IN, i)
        batch = {"x": torch.from_numpy(x).to(dev),
                 "y": torch.from_numpy(y).to(dev)}
        loss, grads = value_and_grad(loss_fn, params, batch)
        adamw_update(params, grads, opt, i, tcfg)
        losses.append(float(loss))
    load_tree(model, params)
    hits = tot = 0
    with torch.no_grad():
        for i in EVAL_STEPS:
            x, y = synthetic_speech(B, T, D_IN, i)
            pred = model(torch.from_numpy(x).to(dev)).argmax(-1).cpu().numpy()
            hits += int((pred == y).sum())
            tot += y.size
    return hits / tot, param_count(model.specs()), losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=250)
    args = ap.parse_args(argv)
    print(f"{'variant':>14} {'frame_acc':>10} {'params':>10} {'reduction':>10}")
    base = None
    rows = []
    for k, name in ((0, "dense"), (8, "FFT8/LSTM2"), (16, "FFT16/LSTM1")):
        acc, n, _ = train_one(k, args.steps, args.device)
        base = base or n
        rows.append((name, acc, n))
        print(f"{name:>14} {acc:10.4f} {n:10,} {base / n:9.1f}x")
    print("\n(paper: FFT8 -> 7.6x size cut at 0.32% PER loss; "
          "FFT16 -> 14.6x at 1.23%)")
    return rows


if __name__ == "__main__":
    main()
