"""Port: the dry-run's rwkv6-7b cells on the single-pod mesh
(``repro_torch.launch.dryrun``), with the RWKV mixer under ``model = 16``,
held to the reference, and the scan replay held to the stepwise run.

The port's CLI runs ``prefill_32k``, ``decode_32k`` and ``long_500k``,
one subprocess per cell, the three at once, and must write each ``OK``
(``train_4k`` takes longer than a test should and runs in
``chip_smoke.py``'s dry-run step, held to the same figures there). A
fourth subprocess asks the reference for its shard bytes as
``tests/test_torch_dryrun_encdec.py`` does. The port's ``params`` and
``analytic`` equal the reference's, and so do its argument bytes apart
from the cache. The cache is not equal: rwkv6's 32 stacked layers divide
the 16-way data axis, so the reference puts the data axes on its layer
stack, while the port's per-layer cache leaves keep their slot axis
whole. Each rank's donated cache bytes are therefore exactly 16 times the
reference's (ROADMAP Queue 3 item 1), which this test pins.

The RWKV time loop (``nn.scan._loop``) runs once per metadata on ``meta``
and is replayed after (``dryrun._replayed_scan``): on a 2-layer rwkv6 cut
at narrow width on a ``(1, 2)`` mesh, a train step (a chunk of 256 steps
and a tail of 44, under ``remat``), a prefill and a decode step give the
same flops and peak bytes with the replay as stepwise.
"""

import contextlib
import dataclasses
import json
import os
import subprocess
import sys

import test_torch_threads  # noqa: F401  (one thread budget per worker)

import pytest

from test_torch_dryrun_encdec import REFERENCE, ROOT, _env

ARCH = "rwkv6-7b"
CELLS = ("prefill_32k", "decode_32k", "long_500k")
# the data axis (16) over the reference's stack of 32 layers, which the
# port's per-layer cache leaves do not have
CACHE_FACTOR = 16


# ---------------------------------------------------------------------------
# The scan replay against the stepwise run
# ---------------------------------------------------------------------------


def _cut():
    from repro_torch.configs.base import LayerGroup, LayerSpec
    from repro_torch.configs.registry import get_config

    return dataclasses.replace(
        get_config(ARCH), n_layers=2, d_model=256, d_ff=512, vocab=512,
        groups=(LayerGroup(layers=(LayerSpec(mixer="rwkv", ffn="dense"),),
                           repeat=2),))


@pytest.mark.parametrize("kind,seq,batch", [("train", 300, 8),
                                            ("prefill", 300, 2),
                                            ("decode", 300, 2)])
def test_scan_replay_keeps_flops_and_peak(monkeypatch, kind, seq, batch):
    """The cut's step measured with the replay and stepwise: flops, peak
    bytes and collectives equal, the replay recording each distinct loop
    (by its inputs' metadata) once."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import MeshSpec

    cfg = _cut()
    spec = MeshSpec(("data", "model"), {"data": 1, "model": 2})
    shape = ShapeConfig(kind, seq, batch, kind)
    records = []
    real = dryrun._record_loop

    def record(*args):
        records.append(args[2].key())
        return real(*args)

    monkeypatch.setattr(dryrun, "_record_loop", record)
    replayed = dryrun.measure(cfg, shape, spec)
    assert records and len(records) == len(set(records))
    monkeypatch.setattr(dryrun, "_replayed_scan",
                        lambda mode: contextlib.nullcontext())
    stepwise = dryrun.measure(cfg, shape, spec)
    for key in ("flops", "temp_size_in_bytes", "argument_size_in_bytes",
                "collective_counts", "collective_bytes_weighted"):
        assert replayed[key] == stepwise[key], key


# ---------------------------------------------------------------------------
# The cells against the reference
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    """The cells' and the reference's subprocesses, started before the
    module's first test (the replay tests run while they do), killed at
    its end if still running."""
    out = tmp_path_factory.mktemp("dryrun_rwkv")
    env = dict(_env(), OMP_NUM_THREADS="1")
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", shape, "--mesh", "single", "--out", str(out)], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for shape in CELLS}
    procs["reference"] = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, ARCH, *CELLS], cwd=ROOT,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    yield out, procs
    for p in procs.values():
        if p.poll() is None:
            p.kill()
            p.communicate()


@pytest.fixture(scope="module")
def cells(started):
    """{cell: (the port's record, the reference's figures)}."""
    out, procs = started
    ref = procs.pop("reference")
    ref_out, ref_err = ref.communicate(timeout=300)
    logs = {shape: p.communicate(timeout=300)[0]
            for shape, p in procs.items()}
    assert ref.returncode == 0, ref_err[-3000:]
    want = json.loads(ref_out.strip().splitlines()[-1])
    records = {}
    for shape, p in procs.items():
        assert p.returncode == 0, logs[shape]
        assert "cells: 1 OK, 0 FAIL" in logs[shape], logs[shape]
        with open(os.path.join(out, f"{ARCH}__{shape}__single.json")) as f:
            records[shape] = (json.load(f), want[shape])
    return records


@pytest.mark.parametrize("shape", CELLS)
def test_rwkv_cell_is_the_references(cells, shape):
    """params and analytic equal; the argument bytes outside the cache
    equal; the donated cache bytes exactly 16 times the reference's."""
    mine, ref = cells[shape]
    assert "error" not in mine, mine.get("traceback")
    assert (mine["arch"], mine["shape"], mine["kind"], mine["devices"]) == (
        ARCH, shape, "prefill" if shape == "prefill_32k" else "decode", 256)
    assert mine["params"] == ref["params"]
    assert mine["analytic"].keys() == ref["analytic"].keys()
    for key, val in ref["analytic"].items():
        assert mine["analytic"][key] == pytest.approx(val, rel=1e-12), key
    cache = mine["alias_size_in_bytes"]
    assert cache == CACHE_FACTOR * ref["cache_bytes"]
    assert (mine["argument_size_in_bytes"] - cache
            == ref["argument_size_in_bytes"] - ref["cache_bytes"])
    for key in ("output_size_in_bytes", "temp_size_in_bytes", "flops"):
        assert mine[key] > 0, key
    counts = mine["collective_counts"]
    # per layer: both shift states all-gathered, o and wv summed
    assert counts["all-gather"] >= 2 * 32 and counts["all-reduce"] >= 2 * 32
    assert counts["all-to-all"] == counts["collective-permute"] == 0
