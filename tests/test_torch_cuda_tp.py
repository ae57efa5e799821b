"""Port: tensor-parallel and FSDP training over NCCL, one rank per card.

The ranks run the collectives of a non-gloo backend (``all_reduce``,
``all_gather_into_tensor`` and ``reduce_scatter_tensor`` in the tensors'
own dtype, ``dist.sharding``), which the CPU tests reach only through
gloo. Four ranks, each on its own card, train the smoke models in f32 for
two steps, ``impl="freq"``: qwen3 on ``(2, 2)`` (AdamW and Adafactor) and
on ``(4,)`` (a rank's K/V slice splits a KV head), qwen3-moe on ``(1, 4)``
and arctic with ``fsdp=True`` on ``(2, 2)``. Each rank's shards are held
against one process's full-batch steps on the first card at rel 1e-5, as
``tests/test_torch_tensor_parallel.py`` holds the gloo ranks, and the
qwen3 ``(2, 2)`` state, saved whole from the ranks
(``save_checkpoint(shardings=, mesh=)``: NCCL's gather to rank 0),
restores equal to the ranks' shards. Marked ``gpu``; skipped without four
CUDA devices. This file imports neither jax nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda_tp.py
"""

import dataclasses
import socket

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import test_torch_threads  # noqa: F401  (one thread budget per worker)

from repro_torch import convert
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import sharding as sh
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params, tree_leaves

pytestmark = pytest.mark.gpu

REL = 1e-5
WORLD = 4
BATCH, SEQ, STEPS = 8, 16, 2
TCFG = TrainConfig(warmup_steps=1, total_steps=10)


def _freq(arch, **kw):
    cfg = get_smoke(arch)
    return dataclasses.replace(
        cfg, swm=dataclasses.replace(cfg.swm, impl="freq"), **kw)


QWEN = _freq("qwen3-0.6b")
# name: (config, (data, model))
VARIANTS = {
    "qwen3_2x2": (QWEN, (2, 2)),
    "qwen3_2x2_adafactor": (dataclasses.replace(QWEN, optimizer="adafactor"),
                            (2, 2)),
    "qwen3_model4": (QWEN, (4,)),
    "moe_1x4": (_freq("qwen3-moe-235b-a22b", remat="block",
                      capacity_factor=0.5), (1, 4)),
    "arctic_fsdp_2x2": (_freq("arctic-480b", fsdp=True, remat="block",
                              capacity_factor=0.5), (2, 2)),
}


def _names(shape):
    return ("data", "model")[-len(shape):]


def _np(tree):
    return [t.detach().float().cpu().numpy() for t in tree_leaves(tree)]


def _train(mesh, cfg, dev):
    """STEPS steps from seed 0's whole params: (state, step, metrics)."""
    from repro_torch.train.loop import init_train_state, make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    model = build_model(cfg, device=dev)
    step = make_train_step(model, cfg, TCFG, mesh=mesh)
    shard = (step.data_parallel.state_shardings if mesh is not None
             else {"params": None, "opt": None})
    state = init_train_state(init_params(model.specs(), 0, device=dev),
                             TCFG, cfg.optimizer, opt_shardings=shard["opt"],
                             param_shardings=shard["params"], mesh=mesh,
                             stacks=convert.layer_stacks(cfg))
    data = SyntheticLM(vocab=cfg.vocab, seq_len=SEQ, batch=BATCH)
    metrics = None
    for i in range(STEPS):
        batch = {"tokens": torch.from_numpy(
            data.batch_np(i)["tokens"]).to(dev)}
        state, metrics = step(state, batch)
    return state, step, metrics


def _rank_main(rank, port, root, q):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.ft import checkpoint as tck

    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    out = {"rank": rank}
    try:
        for name, (cfg, shape) in VARIANTS.items():
            mesh = init_device_mesh("cuda", shape,
                                    mesh_dim_names=_names(shape))
            state, step, m = _train(mesh, cfg, dev)
            dp = step.data_parallel
            out[name] = {
                "coord": tuple(int(c) for c in mesh.get_coordinate()),
                "native": sh.mesh_axis(mesh, _names(shape)[-1],
                                       sh.CommLog()).native,
                "params": _np(state["params"]), "opt": _np(state["opt"]),
                "shardings": dp.state_shardings,
                "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                "collectives": dp.collectives, "comm_bytes": dp.comm_bytes}
            if name == "qwen3_2x2":
                tck.save_checkpoint(root, STEPS, state,
                                    shardings=dp.state_shardings, mesh=mesh)
    except Exception as e:            # reported by the test, which fails
        import traceback

        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        q.put(out)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    if torch.cuda.device_count() < WORLD:
        pytest.skip(f"needs {WORLD} CUDA devices: NCCL takes one rank per "
                    f"card")
    root = str(tmp_path_factory.mktemp("nccl"))
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, port, root, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        outs = [q.get(timeout=600) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [o["error"] for o in outs if "error" in o]
    assert not errors, errors[0]
    return sorted(outs, key=lambda o: o["rank"]), root


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _tree_rel(got, want):
    diff = sum(float(np.square(np.asarray(a, np.float64) - b).sum())
               for a, b in zip(got, want))
    norm = sum(float(np.square(np.asarray(b, np.float64)).sum())
               for b in want)
    return (diff / norm) ** 0.5


def _cut(full, spec, shape, coord):
    mesh = MeshSpec(_names(shape), dict(zip(_names(shape), shape)))
    return sh.local_shard(torch.from_numpy(np.asarray(full)), spec, mesh,
                          coordinate=coord).numpy()


def _specs(shardings, part):
    tree = shardings[part]
    if part == "opt":
        return [s for k in sorted(tree) for s in tree_leaves(tree[k])]
    return tree_leaves(tree)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_nccl_step_matches_one_process(ranks, variant):
    """Each rank's shards after two NCCL steps against one process's
    full-batch steps on the first card: params over the tree and moments
    leaf by leaf at rel 1e-5, the loss and the grad norm."""
    outs, _ = ranks
    cfg, shape = VARIANTS[variant]
    ref, _, m = _train(None, cfg, torch.device("cuda", 0))
    full = {"params": _np(ref["params"]), "opt": _np(ref["opt"])}
    for o in outs:
        got = o[variant]
        assert got["native"]
        assert got["loss"] == pytest.approx(float(m["loss"]), rel=REL)
        assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                                 rel=REL)
        want = {part: [_cut(b, spec, shape, got["coord"]) for b, spec in
                       zip(full[part], _specs(got["shardings"], part))]
                for part in ("params", "opt")}
        assert _tree_rel(got["params"], want["params"]) <= REL
        for a, b in zip(got["opt"], want["opt"]):
            assert a.shape == b.shape
            assert _rel(a, b) <= REL
        assert got["collectives"] == outs[0][variant]["collectives"] > 0


def test_nccl_checkpoint_is_the_ranks_state(ranks):
    """The qwen3 (2, 2) state saved whole through NCCL's gather restores
    as each rank's exact shards."""
    from repro_torch.ft import checkpoint as tck

    outs, root = ranks
    whole = tck.restore_checkpoint(root, STEPS, device="cpu")
    leaves = _np(whole["params"]) + _np(whole["opt"])
    for o in outs:
        got = o["qwen3_2x2"]
        specs = _specs(got["shardings"], "params") + _specs(
            got["shardings"], "opt")
        for a, b, spec in zip(got["params"] + got["opt"], leaves, specs):
            np.testing.assert_array_equal(a, _cut(b, spec, (2, 2),
                                                  got["coord"]))
