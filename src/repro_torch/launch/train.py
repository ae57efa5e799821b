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

``--mesh local`` (the default) trains data-parallel on
``launch.mesh.make_local_mesh``: a (world, 1) mesh over the process group
that ``torchrun`` sets up (``WORLD_SIZE`` and friends in the environment),
or a one-rank group of its own (``nccl`` on the card, ``gloo`` with
``--device cpu``), removed again when the run ends. Each rank takes its
shard of every global batch and holds its ZeRO-1 share of the moments.
``--mesh single`` / ``multi`` train on the reference's production meshes,
(data=16, model=16) and (pod=2, data=16, model=16), at a world of 256 or
512 ranks: each rank holds its shard of the params under the rule table
(tensor parallelism over ``model``, FSDP over the data axes for an FSDP
config; ``dist.tensor_parallel``). A model that tensor parallelism does
not cover (the Mamba and RWKV mixers, paligemma's vision prefix, an FSDP
enc-dec config) stops there with ``NotImplementedError``; the enc-dec
family is covered, and stops at its first step for want of ``frames`` as
above (``train.loop.make_train_step(mesh=)`` takes them in the batch).
"""

from __future__ import annotations

import argparse
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, TrainConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.device import resolve_device
from repro_torch.ft.driver import TrainDriver
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
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
    ap.add_argument("--mesh", default="local",
                    choices=["local", "single", "multi"])
    args = ap.parse_args(argv)
    arch = args.arch or args.model
    if not arch:
        ap.error("--arch (or --model) is required")

    dev = resolve_device(args.device)
    own_group = not dist.is_initialized()
    if own_group and "WORLD_SIZE" in os.environ:       # torchrun
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    try:
        return _run(args, arch, dev)
    finally:
        if own_group and dist.is_initialized():
            dist.destroy_process_group()


def _mesh(kind: str, dev):
    if kind == "local":
        return make_local_mesh(device=dev.type)
    prod = make_production_mesh(multi_pod=kind == "multi")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != prod.size:
        raise SystemExit(
            f"--mesh {kind} is the reference's production mesh "
            f"{dict(prod.shape)} (axes {prod.axis_names}) over "
            f"{prod.size} ranks; this run has a world of {world}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(dev.type, tuple(prod.shape[a]
                                            for a in prod.axis_names),
                            mesh_dim_names=prod.axis_names)


def _run(args, arch, dev):
    cfg = get_smoke(arch) if args.smoke else get_config(arch)
    shape = SHAPES["train_4k"]
    seq = args.seq or (64 if args.smoke else shape.seq_len)
    batch = args.batch or (8 if args.smoke else shape.global_batch)
    tcfg = TrainConfig(learning_rate=args.lr, total_steps=args.steps,
                       microbatch=args.microbatch,
                       checkpoint_every=args.ckpt_every,
                       checkpoint_dir=args.ckpt_dir,
                       z_loss=0.0 if args.smoke else 1e-4)

    mesh = _mesh(args.mesh, dev)
    model = build_model(cfg, device=dev)
    params = init_params(model.specs(), tcfg.seed, device=dev)
    step_fn = make_train_step(model, cfg, tcfg, mesh=mesh)
    shardings = step_fn.data_parallel.state_shardings
    state = init_train_state(params, tcfg, cfg.optimizer,
                             opt_shardings=shardings["opt"], mesh=mesh,
                             stacks=step_fn.data_parallel.stacks,
                             param_shardings=shardings["params"])
    data = SyntheticLM(vocab=cfg.vocab, seq_len=seq, batch=batch,
                       seed=tcfg.seed)

    def data_fn(step: int):
        return {"tokens": torch.from_numpy(
            data.batch_np(step)["tokens"]).to(dev)}

    driver = TrainDriver(step_fn, tcfg, data_fn, state_shardings=shardings,
                         mesh=mesh)
    state = driver.run(state, n_steps=args.steps)
    for m in driver.metrics_log[-5:]:
        print(f"step {m['step']:5d} loss {m['loss']:.4f} "
              f"({m['dt'] * 1e3:.0f} ms)")
    print(f"restarts={driver.restarts} "
          f"straggler_events={len(driver.watchdog.events)}")
    return driver


if __name__ == "__main__":
    main()
