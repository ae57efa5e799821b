"""Paper §4.2/§6.1 end to end on the port: train the paper's MNIST MLP with
SWM compression at several block sizes and compare accuracy against model
size, the accuracy/compression curve of ``examples/train_mnist_swm.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_mnist_swm
    PYTHONPATH=src python -m repro_torch.examples.train_mnist_swm \
        --device cpu --steps 20

The same widths (``SWMMLP((784, 256, 256, 10), k, quant_bits=12 if k)``),
data (``synthetic_images``), loss, AdamW schedule and evaluation as the
reference, with one departure: the reference builds the model with its
default impl (``freq``), this example with ``impl="pallas"`` so that its
block-circulant layers train through the kernels (``bc_matmul`` forward and
dx, ``bc_dw`` for the weight adjoint) on the card, and through their plain
versions on the CPU. Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import synthetic_images
from repro_torch.device import resolve_device
from repro_torch.models.paper_models import SWMMLP
from repro_torch.nn.module import (init_params, load_tree, param_count,
                                   tree_map)
from repro_torch.optim.optimizers import adamw_update
from repro_torch.train.loop import init_train_state, value_and_grad

BATCH = 128
EVAL_STEPS = range(1000, 1010)


def train_one(k: int, steps: int = 200, device="cuda", params=None):
    """Train at block size ``k`` (0 = dense) for ``steps`` AdamW steps from
    ``params`` (a tree keyed like ``SWMMLP.specs()``, copied; default: the
    port's seeded init) and evaluate on 10 held-out batches. Returns
    (accuracy, parameter count, per-step losses)."""
    dev = resolve_device(device)
    model = SWMMLP(dims=(784, 256, 256, 10), block_size=k,
                   quant_bits=12 if k else 0, impl="pallas")
    tcfg = TrainConfig(learning_rate=3e-3, warmup_steps=10,
                       total_steps=steps, weight_decay=0.0)
    if params is None:
        params = init_params(model.specs(), 0, device=dev)
    state = init_train_state(
        tree_map(lambda t: t.detach().to(dev).clone(), params), tcfg)
    params, opt = state["params"], state["opt"]

    def loss_fn(p, batch):
        load_tree(model, p)
        lp = torch.log_softmax(model(batch["x"]), -1)
        return -lp.gather(1, batch["y"][:, None].long()).mean()

    losses = []
    for i in range(steps):
        x, y = synthetic_images(BATCH, i)
        batch = {"x": torch.from_numpy(x.reshape(BATCH, -1)).to(dev),
                 "y": torch.from_numpy(y).to(dev)}
        loss, grads = value_and_grad(loss_fn, params, batch)
        adamw_update(params, grads, opt, i, tcfg)
        losses.append(float(loss))
    load_tree(model, params)
    correct = total = 0
    with torch.no_grad():
        for i in EVAL_STEPS:
            x, y = synthetic_images(BATCH, i)
            pred = model(torch.from_numpy(x.reshape(BATCH, -1)).to(dev)
                         ).argmax(-1).cpu().numpy()
            correct += int((pred == y).sum())
            total += len(y)
    return correct / total, param_count(model.specs()), losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (plain PyTorch path)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--block-sizes", default="0,2,4,8,16")
    args = ap.parse_args(argv)
    print(f"{'block size':>12} {'accuracy':>9} {'params':>9} {'reduction':>10}")
    base = None
    rows = []
    for k in (int(s) for s in args.block_sizes.split(",")):
        acc, n, _ = train_one(k, args.steps, args.device)
        base = base or n
        rows.append((k, acc, n))
        print(f"{k or 'dense':>12} {acc:9.4f} {n:9,} {base / n:9.1f}x")
    print("\n(the paper reports <2% accuracy loss at 400x+ FC-layer "
          "compression on real MNIST; synthetic data shown here)")
    return rows


if __name__ == "__main__":
    main()
