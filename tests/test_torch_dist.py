"""Port parity: gradient compression (``repro_torch.dist.compress``) and
data-parallel training on a real process group
(``repro_torch.dist.data_parallel``, ``launch.mesh``, ``ft`` on a mesh).

Compression is held bit for bit against ``repro.dist.compress`` on the
same numpy inputs, with mirrors of ``tests/test_compress.py``.

The multi-rank half spawns two ``gloo`` ranks on the CPU once for the
module: each builds ``make_local_mesh(device="cpu")`` (a (2, 1) mesh), and
runs a data-parallel ZeRO-1 step of a 3-layer smoke model in f32 (AdamW,
microbatch 2, Adafactor, and qwen3-moe's 2-layer smoke model with
``remat="block"``, its MoE tokens routed over the global batch), the
compressed all-reduce, ``freq_shmap``, an elastic restore of a 1-rank
checkpoint and ``TrainDriver(mesh=)`` through a fault. The ranks' results
come back to the test process, which holds them against one process
training on the full batch (the MoE variant's dropped tokens and aux loss
too), and the Adafactor variant's params against the reference's
Adafactor on the full batch. Tolerance: rel 1e-5 on params and moments,
f32 (the two ranks' halves of the batch are summed in another order than
one process's full batch; every other check is exact).
"""

import dataclasses
import os
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from hypothesis import given, settings, strategies as st

from repro.configs import qwen3_0_6b as jq
from repro.dist import compress as jc
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs import qwen3_moe_235b as tqm
from repro_torch.configs.base import TrainConfig
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.dist import compress as tc
from repro_torch.ft import checkpoint as tck
from repro_torch.launch import train as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params, tree_leaves
from repro_torch.nn.moe import MoE
from repro_torch.train.loop import init_train_state, make_train_step
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

REL = 1e-5
WORLD = 2
CFG = dataclasses.replace(
    tq.SMOKE, swm=dataclasses.replace(tq.SMOKE.swm, impl="freq"))
TCFG = TrainConfig(warmup_steps=1, total_steps=10)
BATCH, SEQ, STEPS = 8, 16, 2


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


# ---------------------------------------------------------------------------
# int8 compression against the reference, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(1000,), (37, 65), (256,), (3, 5, 7),
                                   (1,)])
def test_int8_payload_and_scales_are_the_references(shape):
    rng = np.random.default_rng(len(shape) * 7 + shape[0])
    g = (rng.standard_normal(shape) * 10.0 ** rng.uniform(-3, 3)).astype(
        np.float32)
    g.reshape(-1)[:3] = 0.0
    jq, js = jc.int8_compress(jnp.asarray(g))
    q, s = tc.int8_compress(torch.from_numpy(g))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(
        tc.int8_decompress(q, s, g.shape, g.size).numpy(),
        np.asarray(jc.int8_decompress(jq, js, g.shape, g.size)))
    r = (rng.standard_normal(shape) * 1e-2).astype(np.float32)
    jtx, jr = jc.apply_error_feedback(jnp.asarray(g), jnp.asarray(r))
    tx, nr = tc.apply_error_feedback(torch.from_numpy(g), torch.from_numpy(r))
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jtx))
    np.testing.assert_array_equal(nr.numpy(), np.asarray(jr))


def test_int8_decompress_keeps_bf16():
    g = torch.randn(300, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    q, s = tc.int8_compress(g)
    assert tc.int8_decompress(q, s, g.shape, g.numel(),
                              torch.bfloat16).dtype == torch.bfloat16
    tx, r = tc.apply_error_feedback(g, torch.zeros_like(g))
    assert tx.dtype == r.dtype == torch.bfloat16
    assert tc.CHUNK == jc.CHUNK == 256


def test_int8_roundtrip_error_bound():
    g = torch.randn(3, 700, generator=torch.Generator().manual_seed(0))
    q, s = tc.int8_compress(g)
    deq = tc.int8_decompress(q, s, g.shape, g.numel())
    assert (deq - g).abs().max() <= s.max() * 0.5 + 1e-6


@given(st.integers(0, 5))
@settings(max_examples=5, deadline=None)
def test_error_feedback_telescopes(seed):
    """sum(transmitted_t) == sum(g_t) - residual_T: no gradient is lost."""
    gen = torch.Generator().manual_seed(seed)
    residual = torch.zeros(257)
    total_g = torch.zeros(257)
    total_tx = torch.zeros(257)
    for t in range(6):
        g = torch.randn(257, generator=gen) * (10.0 ** (t % 3))
        tx, residual = tc.apply_error_feedback(g, residual)
        total_g += g
        total_tx += tx
    np.testing.assert_allclose((total_tx + residual).numpy(),
                               total_g.numpy(), rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Two gloo ranks, spawned once for the module
# ---------------------------------------------------------------------------


def _batches():
    data = SyntheticLM(vocab=CFG.vocab, seq_len=SEQ, batch=BATCH)
    return [{"tokens": torch.from_numpy(data.batch_np(i)["tokens"])}
            for i in range(STEPS + 2)]


# the MoE variant: qwen3-moe's 2-layer smoke model, every layer a MoE,
# remat="block" (each MoE call gathers its counts again in the backward),
# capacity factor 0.5 so that the capacity drops tokens
MOE_CFG = dataclasses.replace(
    tqm.SMOKE, remat="block", capacity_factor=0.5,
    swm=dataclasses.replace(tqm.SMOKE.swm, impl="freq"))
VARIANTS = {"adamw": (CFG, TCFG),
            "micro": (CFG, dataclasses.replace(TCFG, microbatch=2)),
            "adafactor": (dataclasses.replace(CFG, optimizer="adafactor"),
                          TCFG),
            "moe": (MOE_CFG, TCFG)}


def _dropped(model) -> int:
    """(token, slot) pairs the MoE layers dropped in the last forward."""
    return sum(int(m.dropped) for m in model.modules()
               if isinstance(m, MoE))


def _train(mesh, tcfg, steps=STEPS, cfg=CFG):
    """``steps`` steps of the smoke model from seed 0; the state, the step,
    its last metrics and the tokens its MoE layers dropped last."""
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, cfg, tcfg, mesh=mesh)
    shards = (step.data_parallel.state_shardings["opt"]
              if mesh is not None else None)
    state = init_train_state(init_params(model.specs(), 0, device="cpu"),
                             tcfg, cfg.optimizer, opt_shardings=shards,
                             mesh=mesh, stacks=convert.layer_stacks(cfg))
    metrics = None
    for b in _batches()[:steps]:
        state, metrics = step(state, b)
    return state, step, metrics, _dropped(model)


def _np(tree):
    return [t.detach().float().numpy().copy() for t in tree_leaves(tree)]


def _rank_main(rank, port, ckpt, q):
    import torch.distributed as dist

    from repro_torch.core import circulant as circ
    from repro_torch.dist import sharding as sh
    from repro_torch.ft.driver import FaultInjector, TrainDriver
    from repro_torch.launch.mesh import make_local_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=WORLD, rank=rank)
    try:
        out = {"rank": rank}
        mesh = make_local_mesh(device="cpu")
        out["placements"] = [str(p) for p in sh.to_placements(
            mesh, ("data", None))]
        out["coord"] = mesh.get_coordinate()
        for name, (cfg, tcfg) in VARIANTS.items():
            state, step, m, dropped = _train(mesh, tcfg, cfg=cfg)
            out[name] = {"params": _np(state["params"]),
                         "opt": _np(state["opt"]), "loss": float(m["loss"]),
                         "aux": float(m["aux"]), "dropped": dropped,
                         "collectives": step.data_parallel.collectives,
                         "shardings": step.data_parallel.state_shardings}
        out["shardings"] = out["adamw"]["shardings"]
        # a state with whole moments is refused on a 2-rank mesh
        model = build_model(CFG, device="cpu")
        whole = init_train_state(init_params(model.specs(), 0,
                                             device="cpu"), TCFG)
        try:
            make_train_step(model, CFG, TCFG, mesh=mesh)(whole,
                                                         _batches()[0])
            out["whole_refused"] = False
        except ValueError as e:
            out["whole_refused"] = "this rank's shard" in str(e)
        # the compressed all-reduce over the data group
        gen = torch.Generator().manual_seed(100 + rank)
        grads = {"a": torch.randn(300, generator=gen),
                 "b": {"c": torch.randn(7, 5, generator=gen)}}
        res = {"a": torch.randn(300, generator=gen) * 1e-2,
               "b": {"c": torch.zeros(7, 5)}}
        red, new_res = tc.compressed_psum_grads(grads, res,
                                                mesh.get_group("data"))
        out["compress"] = (_np(grads), _np(res), _np(red), _np(new_res))
        # freq_shmap under the ambient mesh: the freq path on local rows
        sh.set_ambient_mesh(mesh)
        x = torch.randn(4, 3, 32, generator=gen)
        w = torch.randn(2, 4, 8, generator=gen)
        out["shmap_equal"] = torch.equal(
            circ.block_circulant_apply(x, w, impl="freq_shmap"),
            circ.block_circulant_apply(x, w, impl="freq"))
        sh.set_ambient_mesh(None)
        # elastic restore of the 1-rank checkpoint onto this mesh
        restored = tck.restore_checkpoint(ckpt, STEPS,
                                          shardings=out["shardings"],
                                          mesh=mesh, device="cpu")
        out["restored"] = (_np(restored["params"]), _np(restored["opt"]),
                           int(restored["step"]))
        # TrainDriver on the mesh through a fault, against no fault
        batches = _batches()
        for key, faults in (("driver_fault", FaultInjector(fail_at={3})),
                            ("driver_clean", None)):
            d = os.path.join(os.path.dirname(ckpt), f"{key}")
            tcfg = dataclasses.replace(TCFG, checkpoint_dir=d,
                                       checkpoint_every=2)
            model = build_model(CFG, device="cpu")
            step = make_train_step(model, CFG, tcfg, mesh=mesh)
            state = init_train_state(
                init_params(model.specs(), 0, device="cpu"), tcfg,
                opt_shardings=step.data_parallel.state_shardings["opt"],
                mesh=mesh)
            drv = TrainDriver(step, tcfg, lambda i: batches[i],
                              state_shardings=step.data_parallel
                              .state_shardings, mesh=mesh,
                              fault_injector=faults)
            state = drv.run(state, n_steps=4)
            out[key] = (_np(state["params"]), _np(state["opt"]),
                        drv.restarts)
        q.put(out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results, and the 1-rank checkpoint they restored."""
    root = tmp_path_factory.mktemp("dist")
    ckpt = str(root / "one_rank")
    state, _, _, _ = _train(None, TCFG)
    tck.save_checkpoint(ckpt, STEPS, state)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, port, ckpt, q))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    try:
        outs = [q.get(timeout=240) for _ in range(WORLD)]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    return sorted(outs, key=lambda o: o["rank"]), state


def _cut(full, spec, coord):
    from repro_torch.launch.mesh import MeshSpec
    from repro_torch.dist.sharding import local_shard

    mesh = MeshSpec(("data", "model"), {"data": WORLD, "model": 1})
    return local_shard(torch.from_numpy(full), spec, mesh,
                       coordinate=coord).numpy()


def _moment_specs(shardings):
    return [s for k in sorted(shardings["opt"])
            for s in tree_leaves(shardings["opt"][k])]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_data_parallel_zero1_step_matches_full_batch(ranks, variant):
    outs, _ = ranks
    cfg, tcfg = VARIANTS[variant]
    state, _, m, dropped = _train(None, tcfg, cfg=cfg)
    ref_p, ref_o = _np(state["params"]), _np(state["opt"])
    specs = _moment_specs(outs[0][variant]["shardings"])
    n_sharded = 0
    for o in outs:
        got = o[variant]
        assert got["loss"] == pytest.approx(float(m["loss"]), rel=REL)
        for a, b in zip(got["params"], ref_p):
            assert _rel(a, b) <= REL
        for a, b, spec in zip(got["opt"], ref_o, specs):
            want = _cut(b, spec, o["coord"])
            assert a.shape == want.shape
            n_sharded += a.shape != b.shape
            assert _rel(a, want) <= REL
        if variant != "adafactor":
            # per step: one grad all-reduce, one param all-gather (one
            # param dtype); Adafactor gathers its sharded moments instead;
            # each MoE layer gathers its counts in the forward and again
            # in the remat recompute
            moe = 2 * cfg.n_layers if variant == "moe" else 0
            assert got["collectives"] == (2 + moe) * STEPS
    assert n_sharded > 0
    if variant == "moe":
        # the global batch routed: the ranks' drops add up to the full
        # batch's, and the aux loss (mean over ranks) is the full batch's
        assert dropped > 0
        assert sum(o["moe"]["dropped"] for o in outs) == dropped
        aux = np.mean([o["moe"]["aux"] for o in outs])
        assert aux == pytest.approx(float(m["aux"]), rel=REL)


def test_data_parallel_adafactor_matches_reference(ranks):
    """The two-rank Adafactor step against the reference's Adafactor on
    the full batch (repeated layers updated as one stacked leaf)."""
    from test_torch_repairs import reference_adafactor

    outs, _ = ranks
    cfg, tcfg = VARIANTS["adafactor"]
    jcfg = dataclasses.replace(jq.SMOKE, optimizer="adafactor",
                               swm=dataclasses.replace(jq.SMOKE.swm,
                                                       impl="freq"))
    tparams = init_params(build_model(cfg, device="cpu").specs(), 0,
                          device="cpu")
    ref = convert.to_reference(cfg, tparams)
    kw = {f: getattr(tcfg, f) for f in ("learning_rate", "warmup_steps",
                                         "total_steps")}
    jp, _, _ = reference_adafactor(
        jcfg, kw, ref, [b["tokens"].numpy() for b in _batches()[:STEPS]])
    want = tree_leaves(convert.from_reference(cfg, jp, "cpu"))
    for o in outs:
        for a, b in zip(o["adafactor"]["params"], want):
            assert _rel(a, b.numpy()) <= REL


def test_placements_and_mesh(ranks):
    outs, _ = ranks
    assert [list(o["coord"]) for o in outs] == [[0, 0], [1, 0]]
    assert outs[0]["placements"] == ["S(0)", "R"]
    assert all(o["whole_refused"] for o in outs)


def test_compressed_psum_grads_over_two_ranks(ranks):
    outs, _ = ranks
    total = None
    for o in outs:
        grads, res, red, new_res = o["compress"]
        txs = []
        for g, r, nr in zip(grads, res, new_res):
            jtx, jr = jc.apply_error_feedback(jnp.asarray(g), jnp.asarray(r))
            np.testing.assert_array_equal(nr, np.asarray(jr))
            q, s = jc.int8_compress(jnp.asarray(g + r))
            # the per-element error bound, and the wire payload's size
            assert np.abs(np.asarray(jtx) - (g + r)).max() <= float(
                np.asarray(s).max()) / 2 + 1e-6
            txs.append(np.asarray(jtx))
        total = txs if total is None else [a + b for a, b in zip(total, txs)]
    for o in outs:
        for a, b in zip(o["compress"][2], total):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)


def test_freq_shmap_is_freq_under_the_mesh(ranks):
    assert all(o["shmap_equal"] for o in ranks[0])


def test_elastic_restore_onto_two_ranks(ranks):
    outs, state = ranks
    full_p, full_o = _np(state["params"]), _np(state["opt"])
    specs = _moment_specs(outs[0]["shardings"])
    for o in outs:
        params, opt, step = o["restored"]
        assert step == STEPS
        for a, b in zip(params, full_p):
            np.testing.assert_array_equal(a, b)
        for a, b, spec in zip(opt, full_o, specs):
            np.testing.assert_array_equal(a, _cut(b, spec, o["coord"]))
    # the two ranks' moment shards together are the saved moments
    for a0, a1, b, spec in zip(outs[0]["restored"][1],
                               outs[1]["restored"][1], full_o, specs):
        if a0.shape != b.shape:
            d = next(i for i, e in enumerate(spec) if e == "data")
            np.testing.assert_array_equal(np.concatenate([a0, a1], d), b)


def test_train_driver_on_the_mesh_through_a_fault(ranks):
    outs, _ = ranks
    for o in outs:
        fp, fo, restarts = o["driver_fault"]
        cp, co, clean_restarts = o["driver_clean"]
        assert (restarts, clean_restarts) == (1, 0)
        for a, b in zip(fp + fo, cp + co):
            np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# One process: the launcher, the refusals
# ---------------------------------------------------------------------------


def test_launcher_mesh_local_on_the_cpu(tmp_path, capsys):
    import torch.distributed as dist

    drv = tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "3",
                        "--seq", "16", "--batch", "4", "--device", "cpu",
                        "--mesh", "local", "--ckpt-dir", str(tmp_path),
                        "--ckpt-every", "2"])
    out = capsys.readouterr().out
    assert out.count(" loss ") == 3 and "restarts=0" in out
    assert sorted(os.listdir(tmp_path)) == ["LATEST", "step_00000002"]
    assert drv.mesh is not None and not dist.is_initialized()
    with pytest.raises(SystemExit, match=r"256 ranks.*world of 1"):
        tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                      "--device", "cpu", "--mesh", "single"])
    with pytest.raises(SystemExit, match=r"'pod', 'data', 'model'"):
        tlaunch.main(["--arch", "qwen3-0.6b", "--smoke", "--steps", "1",
                      "--device", "cpu", "--mesh", "multi"])


def test_abstract_mesh_and_recurrent_tensor_parallel_are_refused():
    """An abstract mesh holds no devices; paligemma's vision prefix does
    not run under a ``model`` axis > 1."""
    from repro_torch.configs.registry import get_smoke
    from repro_torch.launch.mesh import MeshSpec, make_production_mesh

    model = build_model(CFG, device="cpu")
    for mesh in (make_production_mesh(),
                 MeshSpec(("data", "model"), {"data": 1, "model": 2})):
        with pytest.raises(TypeError, match="DeviceMesh"):
            make_train_step(model, CFG, TCFG, mesh=mesh)
    mesh = MeshSpec(("data", "model"), {"data": 1, "model": 2})
    cfg = get_smoke("paligemma-3b")
    with pytest.raises(NotImplementedError, match="vision prefix"):
        make_train_step(build_model(cfg, device="cpu"), cfg, TCFG, mesh=mesh)


def test_local_mesh_never_falls_back_to_the_cpu():
    from repro_torch.launch.mesh import make_local_mesh

    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="needs CUDA"):
        make_local_mesh()
