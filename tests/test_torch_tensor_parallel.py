"""Port: tensor-parallel and FSDP training on a ``(data, model)`` mesh
(``repro_torch.dist.tensor_parallel``, the ``model`` axis in ``nn/``, the
vocab-parallel loss, the shard-aware clip, sharded checkpoints).

The multi-rank half spawns ``gloo`` ranks on the CPU twice for the module:
a world of 4 and, after it, a world of 2. Each rank builds its meshes
with ``init_device_mesh`` and trains smoke models in f32 (2 steps, AdamW
unless named): qwen3 on ``(1, 2)`` and ``(2, 2)`` (microbatch 2 and
Adafactor too); qwen3-moe on ``(1, 4)`` at its own ``k = 8``, where a
rank's K/V slice splits a KV head, and at ``block_size=16``, where
``p_kv = 2`` leaves K/V whole; qwen3-moe with ``low_tp=True`` on
``(2, 2)``; arctic with ``fsdp=True`` and ``remat="block"`` on ``(2, 2)``.
The ranks' shards come back to the test process, which holds them against
one process training on the full batch: moments leaf by leaf and params
over the tree (AdamW divides by ``sqrt(v) + 1e-8``, so an element of a
zero-initialised norm scale whose grad is near 1e-8 moves by an O(1)
share of its update when the ranks sum its partials in another order),
rel 1e-5, and the loss, grad norm, MoE aux loss and drops. The ``(2, 2)``
AdamW run is held to the reference's one-device step too (rel 2e-5). A
checkpoint written by ``TrainDriver`` on ``(2, 2)`` through a fault is
bit-identical to one without, restores onto ``(4, 1)`` and ``(1, 2)``
and loads through the reference's ``restore_checkpoint``. The refused
mixers raise under ``model = 2`` and jamba trains data-parallel on
``(2, 1)``.

The one-process half checks the split rule and each sharded region
against its unsharded function, with the ranks as threads of this
process (the collectives replaced by a barrier exchange).
"""

import dataclasses
import os
import socket
import threading

import test_torch_threads  # noqa: F401  (one thread budget per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import qwen3_0_6b as jq
from repro.configs.base import TrainConfig as JTrain
from repro.ft import checkpoint as jck
from repro.models.decoder import HybridDecoderLM as JLM
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import arctic_480b as ta
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs import qwen3_moe_235b as tqm
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_smoke
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import sharding as sh
from repro_torch.ft import checkpoint as tck
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.specs import build_model
from repro_torch.nn.linear import Linear
from repro_torch.nn.module import init_params, tree_leaves
from repro_torch.nn.moe import MoE
from repro_torch.optim.optimizers import clip_by_global_norm
from repro_torch.train import losses
from repro_torch.train.loop import init_train_state, make_train_step

jax.config.update("jax_platform_name", "cpu")

REL = 1e-5
REF_REL = 2e-5          # fp32 vs fp32 (tests/test_torch_train.py REL_TOL)
BATCH, SEQ, STEPS = 8, 16, 2
TCFG = TrainConfig(warmup_steps=1, total_steps=10)


def _freq(cfg, **kw):
    return dataclasses.replace(
        cfg, swm=dataclasses.replace(cfg.swm, impl="freq"), **kw)


QWEN = _freq(tq.SMOKE)
# the MoE configs: remat="block" (the experts' and the FSDP gathers'
# recompute), capacity factor 0.5 so that the capacity drops tokens
MOE = _freq(tqm.SMOKE, remat="block", capacity_factor=0.5)
MOE16 = dataclasses.replace(
    MOE, swm=dataclasses.replace(MOE.swm, block_size=16))
ARCTIC = _freq(ta.SMOKE, fsdp=True, remat="block", capacity_factor=0.5)
# name: (config, train config, (data, model))
VARIANTS4 = {
    "qwen3_2x2": (QWEN, TCFG, (2, 2)),
    "qwen3_2x2_micro": (QWEN, dataclasses.replace(TCFG, microbatch=2),
                        (2, 2)),
    "qwen3_2x2_adafactor": (dataclasses.replace(QWEN, optimizer="adafactor"),
                            TCFG, (2, 2)),
    "moe_kv_split_1x4": (MOE, TCFG, (1, 4)),
    "moe_kv_whole_1x4": (MOE16, TCFG, (1, 4)),
    "moe_low_tp_2x2": (dataclasses.replace(MOE, low_tp=True), TCFG, (2, 2)),
    "arctic_fsdp_2x2": (ARCTIC, TCFG, (2, 2)),
    # a mesh with no data axis: tensor parallelism alone
    "qwen3_model4": (QWEN, TCFG, (4,)),
}
# the same runs through the collectives of a non-gloo backend (NCCL's:
# reduce_scatter_tensor, all_gather_into_tensor), which gloo on the CPU
# also runs
NATIVE = {"arctic_fsdp_2x2_native": "arctic_fsdp_2x2",
          "qwen3_model4_native": "qwen3_model4"}
VARIANTS4.update({k: VARIANTS4[v] for k, v in NATIVE.items()})
VARIANTS2 = {"qwen3_1x2": (QWEN, TCFG, (1, 2))}
VARIANTS = {**VARIANTS4, **VARIANTS2}
DRIVER_STEPS, FAIL_AT = 4, 3


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _tree_rel(got, want):
    diff = sum(float(np.square(np.asarray(a, np.float64) - b).sum())
               for a, b in zip(got, want))
    norm = sum(float(np.square(np.asarray(b, np.float64)).sum())
               for b in want)
    return (diff / norm) ** 0.5


def _batches(n=STEPS + 2, vocab=256):
    data = SyntheticLM(vocab=vocab, seq_len=SEQ, batch=BATCH)
    return [{"tokens": torch.from_numpy(data.batch_np(i)["tokens"])}
            for i in range(n)]


def _np(tree):
    return [t.detach().float().numpy().copy() for t in tree_leaves(tree)]


def _dropped(model) -> int:
    return sum(int(getattr(m, "dropped", 0)) for m in model.modules()
               if isinstance(m, MoE))


def _train(mesh, cfg, tcfg, steps=STEPS):
    """``steps`` steps from seed 0's whole params: (state, step, metrics,
    tokens dropped last, model)."""
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, cfg, tcfg, mesh=mesh)
    shard = (step.data_parallel.state_shardings if mesh is not None
             else {"params": None, "opt": None})
    state = init_train_state(init_params(model.specs(), 0, device="cpu"),
                             tcfg, cfg.optimizer, opt_shardings=shard["opt"],
                             param_shardings=shard["params"], mesh=mesh,
                             stacks=convert.layer_stacks(cfg))
    metrics = None
    for b in _batches()[:steps]:
        state, metrics = step(state, b)
    return state, step, metrics, _dropped(model), model


# ---------------------------------------------------------------------------
# The spawned ranks
# ---------------------------------------------------------------------------


def _names(shape):
    return ("data", "model")[-len(shape):]


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=_names(shape))


def _native_axes(monkeypatch):
    """Every mesh axis built from here on takes the non-gloo route."""
    from repro_torch.dist import data_parallel, tensor_parallel

    def native(*args, **kw):
        axis = sh.mesh_axis(*args, **kw)
        axis.native = True
        return axis

    for mod in (data_parallel, tensor_parallel):
        monkeypatch.setattr(mod, "mesh_axis", native)


def _variant(name, cfg, tcfg, shape):
    from repro_torch.nn.attention import Attention

    mesh = _mesh(shape)
    with pytest.MonkeyPatch.context() as mp_:
        if name in NATIVE:
            _native_axes(mp_)
        state, step, m, dropped, model = _train(mesh, cfg, tcfg)
    dp = step.data_parallel
    return {"coord": tuple(mesh.get_coordinate()),
            "params": _np(state["params"]), "opt": _np(state["opt"]),
            "shardings": dp.state_shardings,
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "aux": float(m["aux"]), "dropped": dropped,
            "collectives": dp.collectives, "comm_bytes": dp.comm_bytes,
            "kv": sorted({mod.tp.kv for mod in model.modules()
                          if isinstance(mod, Attention)
                          and mod.tp is not None}),
            "fsdp": model.fsdp is not None}


def _driver(shape, tmp, faults, direct=None):
    """``TrainDriver`` on qwen3 over ``shape``: DRIVER_STEPS steps,
    checkpoints every 2, a fault before FAIL_AT when ``faults``; the final
    state also saved to ``direct`` by ``save_checkpoint(shardings=,
    mesh=)`` when given."""
    from repro_torch.ft.driver import FaultInjector, TrainDriver

    mesh = _mesh(shape)
    batches = _batches(DRIVER_STEPS)
    tcfg = dataclasses.replace(TCFG, checkpoint_dir=tmp, checkpoint_every=2)
    model = build_model(QWEN, device="cpu")
    step = make_train_step(model, QWEN, tcfg, mesh=mesh)
    shard = step.data_parallel.state_shardings
    state = init_train_state(init_params(model.specs(), 0, device="cpu"),
                             tcfg, opt_shardings=shard["opt"],
                             param_shardings=shard["params"], mesh=mesh)
    drv = TrainDriver(step, tcfg, lambda i: batches[i],
                      state_shardings=shard, mesh=mesh,
                      fault_injector=(FaultInjector(fail_at={FAIL_AT})
                                      if faults else None))
    state = drv.run(state, n_steps=DRIVER_STEPS)
    whole = None
    if direct is not None:
        tck.save_checkpoint(direct, DRIVER_STEPS, state, shardings=shard,
                            mesh=mesh)
        whole = tck.gather_state(state, shard, mesh)
        whole = whole and _np(whole["params"]) + _np(whole["opt"])
    return _np(state["params"]) + _np(state["opt"]), drv.restarts, whole


def _collective_routes():
    """gather_many (FSDP) and gather_along on bf16 shards over a 2-rank
    data axis, through the gloo route and the native one: per route the
    gathered values, the shards' grads and what the axis logged."""
    import torch.distributed as dist

    mesh, r = _mesh((2, 1)), dist.get_rank()
    out = {}
    for native in (False, True):
        log = sh.CommLog()
        axis = sh.mesh_axis(mesh, "data", log)
        axis.native = native
        a = (torch.arange(6.) + 10 * r).reshape(2, 3).to(torch.bfloat16)
        b = (torch.arange(4.) - r).reshape(4, 1).to(torch.bfloat16)
        x = torch.full((3, 2), float(r + 1), dtype=torch.bfloat16)
        a, b, x = (t.requires_grad_(True) for t in (a, b, x))
        fa, fb = sh.gather_many([a, b], [0, 1], axis)
        fx = sh.gather_along(x, axis, dim=0)
        w = torch.arange(1., 5.)
        loss = ((fa.float() * w[:, None]).sum() + (fb.float() * w[:, None]).sum()
                + (fx.float() * w[:, None].repeat(2, 1)[:6]).sum())
        loss.backward()
        out[native] = {
            "full": [t.detach().float().numpy() for t in (fa, fb, fx)],
            "grads": [t.grad.float().numpy() for t in (a, b, x)],
            "dtypes": {str(t.grad.dtype) for t in (a, b, x)},
            "bytes": log.bytes, "collectives": log.collectives}
    return out


def _restore(shape, ckpt):
    """The checkpoint at ``ckpt`` restored onto ``shape`` as this rank's
    shards, with the specs it was cut by."""
    mesh = _mesh(shape)
    step = make_train_step(build_model(QWEN, device="cpu"), QWEN, TCFG,
                           mesh=mesh)
    shard = step.data_parallel.state_shardings
    got = tck.restore_checkpoint(ckpt, DRIVER_STEPS, shardings=shard,
                                 mesh=mesh, device="cpu")
    return {"coord": tuple(mesh.get_coordinate()),
            "state": _np(got["params"]) + _np(got["opt"]),
            "specs": tree_leaves(shard["params"]) + [
                s for k in sorted(shard["opt"])
                for s in tree_leaves(shard["opt"][k])]}


def _rank_main(world, rank, port, root, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    out = {"rank": rank}
    try:
        variants = VARIANTS4 if world == 4 else VARIANTS2
        for name, (cfg, tcfg, shape) in variants.items():
            out[name] = _variant(name, cfg, tcfg, shape)
        clean = os.path.join(root, "clean")
        if world == 4:
            out["driver_fault"] = _driver((2, 2), os.path.join(root, "fault"),
                                          True)
            out["driver_clean"] = _driver((2, 2), clean, False,
                                          os.path.join(root, "direct"))
            dist.barrier()            # rank 0's last checkpoint is written
            out["restore"] = _restore((4, 1), clean)
        else:
            out["restore"] = _restore((1, 2), clean)
            out["routes"] = _collective_routes()
            jamba = _freq(get_smoke("jamba-v0.1-52b"))
            state, step, m, _, _ = _train(_mesh((2, 1)), jamba, TCFG,
                                          steps=1)
            out["jamba"] = {"params": _np(state["params"]),
                            "loss": float(m["loss"])}
    except Exception as e:            # reported by the test, which fails
        import traceback

        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        q.put(out)
        dist.destroy_process_group()


def _spawn(world, root):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(world, r, port, root, q))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        outs = [q.get(timeout=300) for _ in range(world)]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [o["error"] for o in outs if "error" in o]
    assert not errors, errors[0]
    return sorted(outs, key=lambda o: o["rank"])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The ranks' reports: the world of 4's, then the world of 2's, and
    the directory of the clean driver run's checkpoints."""
    root = str(tmp_path_factory.mktemp("tp"))
    four = _spawn(4, root)
    two = _spawn(2, root)
    return four, two, os.path.join(root, "clean")


def _outs(ranks, name):
    four, two, _ = ranks
    return four if name in VARIANTS4 else two


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
def test_sharded_step_matches_one_process(ranks, variant):
    cfg, tcfg, shape = VARIANTS[variant]
    ref, _, m, dropped, _ = _train(None, cfg, tcfg)
    full = {"params": _np(ref["params"]), "opt": _np(ref["opt"])}
    outs = _outs(ranks, variant)
    n_split = 0
    for o in outs:
        got = o[variant]
        assert got["loss"] == pytest.approx(float(m["loss"]), rel=REL)
        assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                                 rel=REL)
        want = {}
        for part in ("params", "opt"):
            want[part] = [_cut(b, spec, shape, got["coord"]) for b, spec in
                          zip(full[part], _specs(got["shardings"], part))]
            for a, b, f in zip(got[part], want[part], full[part]):
                assert a.shape == b.shape
                n_split += a.shape != f.shape
        assert _tree_rel(got["params"], want["params"]) <= REL
        for a, b in zip(got["opt"], want["opt"]):
            assert _rel(a, b) <= REL
        if cfg.n_experts:
            assert got["aux"] == pytest.approx(float(m["aux"]), rel=REL)
        # every rank issues its collectives, as many on every rank
        assert got["collectives"] == outs[0][variant]["collectives"] > 0
    assert n_split > 0
    if cfg.n_experts:
        # the global routing: the drops of one model column's data ranks
        # add up to the full batch's
        assert dropped > 0
        assert sum(o[variant]["dropped"] for o in outs
                   if o[variant]["coord"][-1] == 0) == dropped


def test_two_by_two_step_matches_the_reference(ranks):
    """qwen3 on (2, 2) against the reference's one-device AdamW step on
    the same numpy tree and batches."""
    outs = _outs(ranks, "qwen3_2x2")
    tparams = init_params(build_model(QWEN, device="cpu").specs(), 0,
                          device="cpu")
    jcfg = dataclasses.replace(
        jq.SMOKE, swm=dataclasses.replace(jq.SMOKE.swm, impl="freq"))
    jt = JTrain(warmup_steps=TCFG.warmup_steps,
                total_steps=TCFG.total_steps)
    jstate = jinit_state(jax.tree.map(jnp.asarray, convert.to_reference(
        QWEN, tparams)), jt)
    jstep = jax.jit(jmake_step(JLM(jcfg), jcfg, jt))
    for b in _batches()[:STEPS]:
        jstate, jm = jstep(jstate, {"tokens": jnp.asarray(b["tokens"])})
    want = _np(convert.from_reference(
        QWEN, jax.tree.map(np.asarray, jstate["params"]), device="cpu"))
    for o in outs:
        got = o["qwen3_2x2"]
        assert _rel(got["loss"], jm["loss"]) <= REF_REL
        assert _rel(got["grad_norm"], jm["grad_norm"]) <= REF_REL
        cut = [_cut(b, spec, (2, 2), got["coord"]) for b, spec in
               zip(want, _specs(got["shardings"], "params"))]
        assert _tree_rel(got["params"], cut) <= REF_REL


def test_kv_layouts_cover_the_three_cases(ranks):
    """The rule table decides K/V by block count: aligned with heads
    (qwen3 at model = 2), split inside a head (qwen3-moe's p_kv = 4 at
    model = 4) and whole (p_kv = 2 at model = 4)."""
    expect = {"qwen3_1x2": ["local"], "qwen3_2x2": ["local"],
              "qwen3_model4": ["gather"],
              "moe_kv_split_1x4": ["gather"],
              "moe_kv_whole_1x4": ["replicated"],
              "arctic_fsdp_2x2": ["local"], "moe_low_tp_2x2": []}
    for name, kv in expect.items():
        assert all(o[name]["kv"] == kv for o in _outs(ranks, name)), name


def test_fsdp_holds_embed_sharded_params(ranks):
    """arctic with fsdp=True: the embed dim of its tables is split over
    data, and a rank holds well under a whole-param rank's bytes."""
    got = _outs(ranks, "arctic_fsdp_2x2")[0]["arctic_fsdp_2x2"]
    assert got["fsdp"]
    specs = _specs(got["shardings"], "params")
    assert sum("data" in spec for spec in specs) >= 10
    ref, _, _, _, _ = _train(None, ARCTIC, TCFG, steps=0)
    whole = sum(a.nbytes for a in _np(ref["params"]))
    mine = sum(a.nbytes for a in got["params"])
    assert mine < 0.4 * whole
    assert "data" not in str(_outs(ranks, "qwen3_2x2")[0]["qwen3_2x2"][
        "shardings"]["params"])


def test_low_tp_shards_only_the_experts(ranks):
    got = _outs(ranks, "moe_low_tp_2x2")[0]["moe_low_tp_2x2"]
    model = [s for s in _specs(got["shardings"], "params") if "model" in s]
    assert model and all(len(s) == 4 and s[0] == "model" for s in model)


def test_train_driver_on_the_tp_mesh_through_a_fault(ranks):
    four, _, _ = ranks
    for o in four:
        faulted, restarts, _ = o["driver_fault"]
        clean, clean_restarts, _ = o["driver_clean"]
        assert (restarts, clean_restarts) == (1, 0)
        for a, b in zip(faulted, clean):
            np.testing.assert_array_equal(a, b)


def test_sharded_checkpoint_restores_elastically(ranks):
    """The (2, 2) run's checkpoint is whole on disk, restores onto (4, 1)
    and (1, 2) as each rank's exact shard, and loads through the
    reference's loader."""
    four, two, ckpt = ranks
    whole = tck.restore_checkpoint(ckpt, DRIVER_STEPS, device="cpu")
    leaves = _np(whole["params"]) + _np(whole["opt"])
    for outs, shape in ((four, (4, 1)), (two, (1, 2))):
        for o in outs:
            got = o["restore"]
            for a, b, spec in zip(got["state"], leaves, got["specs"]):
                np.testing.assert_array_equal(
                    a, _cut(b, spec, shape, got["coord"]))
    # the restored whole state is the clean run's on any rank
    for a, b in zip(four[0]["driver_clean"][0], leaves):
        if a.shape == b.shape:
            np.testing.assert_array_equal(a, b)
    # save_checkpoint(shardings=, mesh=) writes the same whole state
    direct = tck.restore_checkpoint(os.path.join(os.path.dirname(ckpt),
                                                 "direct"), DRIVER_STEPS,
                                    device="cpu")
    for a, b in zip(_np(direct), _np(whole)):
        np.testing.assert_array_equal(a, b)
    ref = jck.restore_checkpoint(ckpt, DRIVER_STEPS)
    ref_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
    mine = [t.numpy() for t in tree_leaves(whole) if hasattr(t, "numpy")]
    assert len(ref_leaves) == len(mine)
    for a, b in zip(ref_leaves, mine):
        np.testing.assert_array_equal(a.astype(b.dtype), b)


def test_gather_state_is_whole_on_rank_zero_only(ranks):
    """``gather_state`` (the route of ``TrainDriver``'s checkpoints and of
    ``save_checkpoint(shardings=, mesh=)``) gives rank 0 the whole state
    and every other rank None."""
    four, _, ckpt = ranks
    assert all(o["driver_clean"][2] is None for o in four[1:])
    whole = tck.restore_checkpoint(ckpt, DRIVER_STEPS, device="cpu")
    want = _np(whole["params"]) + _np(whole["opt"])
    got = four[0]["driver_clean"][2]
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_native_route_keeps_the_dtype_and_sends_less(ranks):
    """The non-gloo route (NCCL's reduce_scatter_tensor and
    all_gather_into_tensor in the shards' own dtype) gathers and
    reduce-scatters bf16 shards to the same values as gloo's f32
    all-reduce kept in part, with bf16 grads, and logs its bf16 bytes."""
    _, two, _ = ranks
    w = np.arange(1.0, 5.0)
    wx = np.concatenate([w, w[:2]])
    for o in two:
        r = o["rank"]
        gloo, native = o["routes"][False], o["routes"][True]
        for a, b in zip(gloo["full"] + gloo["grads"],
                        native["full"] + native["grads"]):
            np.testing.assert_array_equal(a, b)
        ga, gb, gx = native["grads"]
        np.testing.assert_array_equal(ga, np.repeat(
            2 * w[2 * r:2 * r + 2, None], 3, axis=1))
        np.testing.assert_array_equal(gb, 2 * w[:, None])
        np.testing.assert_array_equal(gx, np.repeat(
            2 * wx[3 * r:3 * r + 3, None], 2, axis=1))
        assert gloo["dtypes"] == native["dtypes"] == {"torch.bfloat16"}
        assert gloo["collectives"] == native["collectives"] == 4
        # gather_many: a 10-element all-gather, then a 20-element
        # reduce-scatter; gather_along: 6, then 12; 2 B each in bf16, the
        # gloo route's reduce-scatter an all-reduce of 4 B elements
        assert native["bytes"] == 2 * (10 + 20 + 6 + 12)
        assert gloo["bytes"] == 2 * (10 + 6) + 4 * (20 + 12)


def test_native_route_runs_the_same_step(ranks):
    """The native route's collectives count as gloo's, one each, and carry
    as many bytes in f32."""
    four, _, _ = ranks
    for name, base in NATIVE.items():
        for o in four:
            assert o[name]["collectives"] == o[base]["collectives"]
            assert o[name]["comm_bytes"] == o[base]["comm_bytes"]


def test_refused_mixer_trains_data_parallel(ranks):
    _, two, _ = ranks
    jamba = _freq(get_smoke("jamba-v0.1-52b"))
    ref, _, m, _, _ = _train(None, jamba, TCFG, steps=1)
    for o in two:
        assert o["jamba"]["loss"] == pytest.approx(float(m["loss"]),
                                                   rel=REL)
        assert _tree_rel(o["jamba"]["params"], _np(ref["params"])) <= REL


@pytest.mark.parametrize("arch", ["paligemma-3b"])
def test_refused_under_a_model_axis(arch):
    cfg = get_smoke(arch)
    mesh = MeshSpec(("data", "model"), {"data": 1, "model": 2})
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1"):
        make_train_step(build_model(cfg, device="cpu"), cfg, TCFG,
                        mesh=mesh)


# ---------------------------------------------------------------------------
# One process: each sharded region against its unsharded function, the
# ranks as threads exchanging through a barrier
# ---------------------------------------------------------------------------


class _Threads:
    """``n`` ranks as threads; the collectives of ``dist.sharding``
    replaced by an exchange through a barrier."""

    def __init__(self, n, monkeypatch):
        self.n, self.bar = n, threading.Barrier(n)
        self.slots = [None] * n
        self.log = sh.CommLog()

        def exchange(t, axis):
            self.slots[axis.index] = t.detach().float().clone()
            self.bar.wait()
            out = list(self.slots)
            self.bar.wait()
            return out

        def all_reduce(t, axis, op=None):
            parts = exchange(t, axis)
            if op is not None:
                return torch.stack(parts).amax(0)
            total = parts[0].clone()
            for p in parts[1:]:
                total = total + p
            return total

        def all_gather(t, axis):
            return [p.to(t.dtype) for p in exchange(t, axis)]

        monkeypatch.setattr(sh, "_staged_all_reduce", all_reduce)
        monkeypatch.setattr(sh, "_staged_all_gather", all_gather)

    def run(self, fn):
        """``fn(rank, axis)`` on every rank; the results in rank order."""
        out, err = [None] * self.n, []

        def body(r):
            try:
                out[r] = fn(r, sh.Axis(None, self.n, r, self.log))
            except BaseException as e:   # re-raised below
                err.append(e)
                self.bar.abort()

        threads = [threading.Thread(target=body, args=(r,))
                   for r in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if err:
            raise err[0]
        return out


def _x(shape, seed):
    return torch.from_numpy(np.random.default_rng(seed).standard_normal(
        shape).astype(np.float32))


@pytest.mark.parametrize("k", [1, 8])
def test_column_and_row_split_rule(monkeypatch, k):
    """The rule table puts ``model`` on a column layer's out (p) dim and a
    row layer's in (q) dim; a column layer's slices are the whole
    output's, and a row layer's partials sum to the whole output, grads
    too."""
    from repro_torch.configs.base import SWMConfig

    M = 2
    swm = SWMConfig(block_size=k, impl="freq")
    col = Linear(32, 48, swm=swm, dtype="float32", in_axis="embed",
                 out_axis="mlp")
    row = Linear(48, 32, swm=swm, dtype="float32", in_axis="mlp",
                 out_axis="embed")
    mesh = MeshSpec(("data", "model"), {"data": 1, "model": M})
    rules = sh.make_param_rules(mesh)
    cs = sh.spec_to_pspec(col.specs()["w"].axes, col.specs()["w"].shape,
                          rules, mesh)
    rs = sh.spec_to_pspec(row.specs()["w"].axes, row.specs()["w"].shape,
                          rules, mesh)
    out_dim = 0 if k > 1 else 1
    assert cs[out_dim] == "model" and rs[1 - out_dim] == "model"
    wc = _x(col.specs()["w"].shape, 1) * 0.2
    wr = _x(row.specs()["w"].shape, 2) * 0.2
    x = _x((3, 32), 3).requires_grad_(True)
    col.register_buffer("w", wc.clone().requires_grad_(True))
    row.register_buffer("w", wr.clone().requires_grad_(True))
    y = row(torch.tanh(col(x)))
    y.square().sum().backward()
    full = (y.detach(), x.grad, col._buffers["w"].grad,
            row._buffers["w"].grad)

    def rank(r, axis):
        c = Linear(32, 48, swm=swm, dtype="float32")
        rw = Linear(48, 32, swm=swm, dtype="float32")
        rw.parallel, rw.tp = "row", axis
        cw = sh.local_shard(wc, cs, mesh, coordinate=(0, r))
        rww = sh.local_shard(wr, rs, mesh, coordinate=(0, r))
        c.register_buffer("w", cw.clone().requires_grad_(True))
        rw.register_buffer("w", rww.clone().requires_grad_(True))
        xr = x.detach().clone().requires_grad_(True)
        yr = rw(torch.tanh(c(sh.region_input(xr, axis))))
        yr.square().sum().backward()
        return (yr.detach(), xr.grad, c._buffers["w"].grad,
                rw._buffers["w"].grad)

    outs = _Threads(M, monkeypatch).run(rank)
    for y_r, gx, gc, gr in outs:
        assert _rel(y_r, full[0]) <= REL and _rel(gx, full[1]) <= REL
    assert _rel(torch.cat([o[2] for o in outs], dim=out_dim), full[2]) <= REL
    assert _rel(torch.cat([o[3] for o in outs], dim=1 - out_dim),
                full[3]) <= REL


@pytest.mark.parametrize("activation", ["gelu", "relu"])
def test_row_parallel_epilogue_runs_after_the_reduce(monkeypatch,
                                                     activation):
    """bias + activation on a row-parallel layer apply once, to the summed
    output: the result is the unsharded layer's, not the sum of each
    partial's epilogue."""
    M = 2
    lin = Linear(16, 8, dtype="float32", in_axis="mlp", out_axis="embed")
    w, b, x = _x((16, 8), 4), _x((8,), 5), _x((4, 16), 6)
    lin.register_buffer("w", w)
    want = lin(x, bias=b, activation=activation)

    def rank(r, axis):
        part = Linear(8, 8, dtype="float32")
        part.parallel, part.tp = "row", axis
        part.register_buffer("w", w[8 * r:8 * (r + 1)])
        return part(x[:, 8 * r:8 * (r + 1)], bias=b, activation=activation)

    outs = _Threads(M, monkeypatch).run(rank)
    for o in outs:
        assert _rel(o, want) <= REL
    # applying the epilogue per partial would differ
    wrong = sum(lin._apply(x[:, 8 * r:8 * (r + 1)], {"w": w[8 * r:8 * (
        r + 1)]}, b, activation) for r in range(M))
    assert _rel(wrong, want) > 1e-2


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_vocab_parallel_cross_entropy(monkeypatch, z_loss):
    """The vocab-parallel chunked CE's loss and grads (hidden and table
    rows) against the unsharded one: a global log-sum-exp from the max
    and sum all-reduces, the label logit from its owner, z_loss on the
    global log-sum-exp."""
    M, V, D = 4, 64, 8
    h = _x((2, 11, D), 7).requires_grad_(True)
    table = (_x((V, D), 8) * 2).requires_grad_(True)
    labels = torch.from_numpy(np.random.default_rng(9).integers(
        0, V, (2, 11)))
    mask = (torch.arange(22).reshape(2, 11) % 5 != 0).float()
    loss, _ = losses.chunked_cross_entropy(h, table, labels, mask,
                                           z_loss=z_loss, chunk=4)
    gh, gt = torch.autograd.grad(loss, [h, table])
    n = V // M

    def rank(r, axis):
        hr = h.detach().clone().requires_grad_(True)
        tr = table.detach()[n * r:n * (r + 1)].clone().requires_grad_(True)
        lr, _ = losses.chunked_cross_entropy(hr, tr, labels, mask,
                                             z_loss=z_loss, chunk=4,
                                             vocab_shard=(axis, n * r))
        return (lr.detach(),) + torch.autograd.grad(lr, [hr, tr])

    outs = _Threads(M, monkeypatch).run(rank)
    for lr, ghr, _ in outs:
        assert _rel(lr, loss.detach()) <= REL
        assert _rel(ghr, gh) <= REL
    assert _rel(torch.cat([o[2] for o in outs]), gt) <= REL


def test_vocab_parallel_embedding(monkeypatch):
    """The embedding on vocab rows split over the axis: the masked local
    lookup summed over ranks and the tied head's gathered logits are the
    whole table's, and so are the grads of the rows and of the hidden
    states."""
    from repro_torch.nn.layers import Embedding

    M, V, D = 4, 32, 8
    table, h = _x((V, D), 13), _x((2, 5, D), 14)
    tokens = torch.from_numpy(np.random.default_rng(15).integers(
        0, V, (2, 5)))
    w_x, w_l = _x((2, 5, D), 16), _x((2, 5, V), 17)

    def run(emb, tab, hid):
        emb.register_buffer("table", tab)
        x, logits = emb.encode(tokens), emb.decode(hid)
        loss = (x * w_x).sum() + (logits * w_l).sum()
        return (x.detach(), logits.detach()) + torch.autograd.grad(
            loss, [tab, hid])

    want = run(Embedding(V, D, dtype="float32"), table.clone()
               .requires_grad_(True), h.clone().requires_grad_(True))
    n = V // M

    def rank(r, axis):
        emb = Embedding(V, D, dtype="float32")
        emb.tp = (axis, n * r, n * (r + 1))
        return run(emb, table[n * r:n * (r + 1)].clone().requires_grad_(True),
                   h.clone().requires_grad_(True))

    outs = _Threads(M, monkeypatch).run(rank)
    for x, logits, _, gh in outs:
        assert _rel(x, want[0]) <= REL and _rel(logits, want[1]) <= REL
        assert _rel(gh, want[3]) <= REL
    assert _rel(torch.cat([o[2] for o in outs]), want[2]) <= REL


def test_shard_aware_global_norm():
    """Each element counted once: sharded leaves by every rank, a
    replicated leaf by its owner only, the squares summed over ranks."""
    M = 4
    full = {"a": _x((8, 6), 10), "b": _x((5,), 11), "c": _x((4, 12), 12)}
    ref_g, ref_n = clip_by_global_norm({k: v.clone() for k, v in
                                        full.items()}, 1.0)
    shards = [{"a": full["a"][2 * r:2 * (r + 1)].clone(),
               "b": full["b"].clone(),
               "c": full["c"][:, 3 * r:3 * (r + 1)].clone()}
              for r in range(M)]
    squares = []
    for r, g in enumerate(shards):
        counted = [True, r == 0, True]        # leaves in key order
        norm = clip_by_global_norm(
            {k: v.clone() for k, v in g.items()}, 1.0, counted,
            reduce=lambda s: squares.append(s) or s)[1]
        assert float(norm) <= float(ref_n)
    total = torch.sqrt(sum(squares))
    assert _rel(total, ref_n) <= REL
    # the clip scales each shard by the global norm
    for r, g in enumerate(shards):
        out, _ = clip_by_global_norm(g, 1.0, [True, r == 0, True],
                                     reduce=lambda s: sum(squares))
        assert _rel(out["a"], ref_g["a"][2 * r:2 * (r + 1)]) <= REL
        assert _rel(out["b"], ref_g["b"]) <= REL
