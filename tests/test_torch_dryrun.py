"""Port: the dry-run (``repro_torch.launch.dryrun``), every cell's step on
the ``meta`` device as rank 0 of a fake production world.

The reference's three committed records
(``experiments/dryrun/qwen3-0.6b__{train_4k,prefill_32k,decode_32k}__single.json``)
are reproduced by the port's CLI at production size, one subprocess per
cell, the three at once: ``params``, ``tokens``, ``devices``, ``kind``,
``impl``, the analytic terms (rel 1e-12), this rank's argument bytes and,
for the serve cells, its donated cache bytes are the reference's; the
fields that count what XLA compiled against what the port runs eagerly
(temporaries, flops, collectives) are present and positive. On a fake
``(2, 2)`` mesh the collectives a smoke step logs, by kind, are those of a
real 4-rank ``gloo`` run of the same step. A refused arch's cell is
written with ``error`` and ``traceback`` and counted by ``--all``'s
summary, and ``--out`` defaults to ``experiments/dryrun_torch``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import test_torch_threads  # noqa: F401  (one thread budget per worker)

import pytest
import torch
import torch.multiprocessing as mp

from repro.configs.registry import LONG_CONTEXT_ARCHS as REF_LONG
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs import qwen3_moe_235b as tqm
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.configs.registry import ARCHS, LONG_CONTEXT_ARCHS
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import MeshSpec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = ("train_4k", "prefill_32k", "decode_32k")
# the reference's per-rank donated cache: rows x 32,768 x 28 layers x
# 4,100 B (bf16 K and V of 8 heads x 128, and an int32 position)
CACHE_BYTES = {"decode_32k": 8 * 32768 * 28 * 4100,
               "prefill_32k": 2 * 32768 * 28 * 4100}
EQUAL = ("params", "tokens", "devices", "kind", "impl", "arch", "shape",
         "mesh", "argument_size_in_bytes")
POSITIVE = ("output_size_in_bytes", "temp_size_in_bytes", "flops")
SMOKE_SHAPES = {"train": ShapeConfig("train_smoke", 16, 16, "train"),
                "prefill": ShapeConfig("prefill_smoke", 16, 4, "prefill"),
                "decode": ShapeConfig("decode_smoke", 32, 4, "decode")}
SMOKE_CFGS = {"qwen3": tq.SMOKE, "qwen3-moe": tqm.SMOKE}
MESH22 = MeshSpec(("data", "model"), {"data": 2, "model": 2})


def _cli(args, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *args], cwd=cwd,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


@pytest.fixture(scope="module")
def committed(tmp_path_factory):
    """The port's records of the three committed cells, each made by the
    CLI in a subprocess of its own, the three at once."""
    out = tmp_path_factory.mktemp("dryrun")
    procs = {shape: _cli(["--arch", "qwen3-0.6b", "--shape", shape,
                          "--mesh", "single", "--out", str(out)])
             for shape in COMMITTED}
    logs = {shape: p.communicate(timeout=600)[0]
            for shape, p in procs.items()}
    for shape, p in procs.items():
        assert p.returncode == 0, logs[shape]
        assert "cells: 1 OK, 0 FAIL" in logs[shape], logs[shape]
    records = {}
    for shape in COMMITTED:
        tag = f"qwen3-0.6b__{shape}__single.json"
        with open(os.path.join(out, tag)) as f:
            mine = json.load(f)
        with open(os.path.join(ROOT, "experiments", "dryrun", tag)) as f:
            records[shape] = (mine, json.load(f))
    return records


@pytest.mark.parametrize("shape", COMMITTED)
def test_committed_cell_reproduces_the_reference(committed, shape):
    mine, ref = committed[shape]
    assert "error" not in mine, mine.get("traceback")
    for key in EQUAL:
        assert mine[key] == ref[key], key
    assert mine["analytic"].keys() == ref["analytic"].keys()
    for key, val in ref["analytic"].items():
        assert mine["analytic"][key] == pytest.approx(val, rel=1e-12), key
    if shape in CACHE_BYTES:
        assert mine["alias_size_in_bytes"] == ref["alias_size_in_bytes"] \
            == CACHE_BYTES[shape]
    else:
        # the donated train state: this rank's params, moments and step
        assert 0 < mine["alias_size_in_bytes"] < mine[
            "argument_size_in_bytes"]
    for key in POSITIVE:
        assert mine[key] > 0, key
    for key in ("collective_counts", "collective_bytes_weighted"):
        assert mine[key].keys() == ref[key].keys()
        assert sum(mine[key].values()) > 0
        assert mine[key]["all-to-all"] == mine[key]["collective-permute"] == 0
    assert mine["lower_s"] >= 0
    # what XLA compiled has no counterpart in an eager step
    for key in ("collective_bytes", "bytes_accessed", "hlo_lines"):
        assert key not in mine


def test_cells_skip_long_context_as_the_reference():
    assert LONG_CONTEXT_ARCHS == REF_LONG
    got = list(dryrun.cells())
    assert len(got) == len(ARCHS) * 3 + len(LONG_CONTEXT_ARCHS)
    assert {a for a, s in got if s == "long_500k"} == LONG_CONTEXT_ARCHS
    assert all(s != "long_500k" for _, s in dryrun.cells(include_long=False))


# ---------------------------------------------------------------------------
# The fake world's collectives against a real one's
# ---------------------------------------------------------------------------


def _gloo_counts(cfg, shape):
    """This rank's collectives by kind for one step of ``cfg`` at
    ``shape`` on a real (2, 2) mesh, as ``dryrun.measure`` builds it."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.convert import layer_stacks
    from repro_torch.launch.specs import build_model
    from repro_torch.nn.module import init_params, load_tree
    from repro_torch.serve.engine import make_decode_step, make_prefill_step
    from repro_torch.train.loop import init_train_state, make_train_step

    mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
    model = build_model(cfg, device="cpu")
    params = init_params(model.specs(), 0, device="cpu")
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        tcfg = TrainConfig(microbatch=8)
        step = make_train_step(model, cfg, tcfg, mesh=mesh)
        shard = step.data_parallel.state_shardings
        state = init_train_state(params, tcfg, cfg.optimizer,
                                 opt_shardings=shard["opt"],
                                 param_shardings=shard["params"], mesh=mesh,
                                 stacks=layer_stacks(cfg))
        step(state, {"tokens": torch.zeros((B, S + 1), dtype=torch.int32)})
        return dict(step.data_parallel.log.counts)
    load_tree(model, params)
    make = make_prefill_step if shape.kind == "prefill" else make_decode_step
    step = make(model, cfg, mesh=mesh)
    cache = step.parallel.init_cache(B, S)
    if shape.kind == "prefill":
        step(torch.zeros((B, S), dtype=torch.int32), cache)
    else:
        step(torch.zeros((B, 1), dtype=torch.int32), cache,
             torch.zeros((B,), dtype=torch.int32))
    return dict(step.parallel.log.counts)


def _rank_main(rank, port, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=4, rank=rank)
    out = {"rank": rank}
    try:
        for name, cfg in SMOKE_CFGS.items():
            for kind, shape in SMOKE_SHAPES.items():
                out[(name, kind)] = _gloo_counts(cfg, shape)
    except Exception as e:            # reported by the test, which fails
        import traceback

        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        q.put(out)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def gloo_counts():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, port, q))
             for r in range(4)]
    for p in procs:
        p.start()
    try:
        outs = [q.get(timeout=300) for _ in procs]
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    errors = [o["error"] for o in outs if "error" in o]
    assert not errors, errors[0]
    return sorted(outs, key=lambda o: o["rank"])


@pytest.mark.parametrize("kind", sorted(SMOKE_SHAPES))
@pytest.mark.parametrize("name", sorted(SMOKE_CFGS))
def test_fake_mesh_logs_the_collectives_of_a_real_one(gloo_counts, name,
                                                      kind):
    """A smoke step on the fake (2, 2) mesh logs, by kind, the collectives
    that every rank of a real 4-rank gloo run of it logs."""
    got = dryrun.measure(SMOKE_CFGS[name], SMOKE_SHAPES[kind], MESH22)
    for o in gloo_counts:
        assert o[(name, kind)] == got["collective_counts"]
    assert got["collective_counts"]["all-reduce"] > 0
    assert got["temp_size_in_bytes"] > 0 and got["flops"] > 0


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_refused_cell_is_written_and_counted(tmp_path, monkeypatch, capsys):
    """``--all`` over a refused arch's cell and an lm cell: the refused
    one written as the reference writes a failed cell, both counted."""
    monkeypatch.setattr(dryrun, "cells", lambda include_long=True: iter(
        [("paligemma-3b", "decode_32k"), ("qwen3-0.6b", "decode_32k")]))
    tally = dryrun.main(["--all", "--mesh", "single", "--out",
                         str(tmp_path)])
    assert tally == {"OK": 1, "FAIL": 1, "skip": 0}
    with open(tmp_path / "paligemma-3b__decode_32k__single.json") as f:
        rec = json.load(f)
    assert rec["error"].startswith("NotImplementedError: ")
    assert "vision prefix" in rec["error"]
    assert "Traceback" in rec["traceback"]
    out = capsys.readouterr().out
    assert "[FAIL] paligemma-3b__decode_32k__single" in out
    assert "cells: 1 OK, 1 FAIL, 0 skipped" in out
    # a second run skips what is there
    assert dryrun.main(["--all", "--mesh", "single", "--out",
                        str(tmp_path)]) == {"OK": 0, "FAIL": 0, "skip": 2}


def test_out_defaults_to_dryrun_torch(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(dryrun, "run_cell",
                        lambda *a: {"arch": a[0], "stub": True})
    dryrun.main(["--arch", "qwen3-0.6b", "--shape", "decode_32k"])
    path = tmp_path / "experiments" / "dryrun_torch" / \
        "qwen3-0.6b__decode_32k__single.json"
    assert dryrun.OUT_DIR == "experiments/dryrun_torch"
    with open(path) as f:
        assert json.load(f) == {"arch": "qwen3-0.6b", "stub": True}
