"""Port: the dry-run's three seamless-m4t-medium cells on the single-pod
mesh (``repro_torch.launch.dryrun``: the step on ``meta`` as rank 0 of a
fake world of 256 ranks), held to the reference.

The port's CLI runs ``train_4k``, ``prefill_32k`` and ``decode_32k``, one
subprocess per cell, the three at once, and must write each ``OK``. A
fourth subprocess asks the reference for the same cells without lowering
anything: ``repro.launch.specs.input_specs`` on a ``(data=16, model=16)``
mesh of 256 fake CPU devices gives every argument's stand-in and its
``NamedSharding``, whose ``shard_shape`` is rank 0's shard, and
``count_params`` and ``analytic.cell_model`` the bookkeeping. The port's
``params`` and ``analytic`` equal the reference's (rel 1e-12), its
argument bytes the sum of the reference's shard bytes, and, for the serve
cells, its donated cache bytes the reference's cache shard bytes.
"""

import json
import os
import subprocess
import sys

import test_torch_threads  # noqa: F401  (one thread budget per worker)

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCH = "seamless-m4t-medium"
CELLS = ("train_4k", "prefill_32k", "decode_32k")

# run by the reference's subprocess: rank 0's shard bytes of every input,
# the cache's apart, params and the analytic terms, as one JSON line
REFERENCE = r"""
import json, sys
import jax
import numpy as np
from repro.configs.base import SHAPES, TrainConfig
from repro.configs.registry import get_config
from repro.launch.analytic import cell_model
from repro.launch.specs import count_params, input_specs

cfg = get_config(sys.argv[1])
mesh = jax.make_mesh((16, 16), ("data", "model"))
out = {}
for name in sys.argv[2:]:
    shape = SHAPES[name]
    specs = input_specs(cfg, shape, mesh, TrainConfig(microbatch=8))

    def local(sds, shardings):
        return sum(int(np.prod(sh.shard_shape(s.shape))) * s.dtype.itemsize
                   for s, sh in zip(jax.tree.leaves(sds),
                                    jax.tree.leaves(shardings)))

    if shape.kind == "train":
        args = (local(specs["state_sds"], specs["state_shardings"])
                + local(specs["batch_sds"], specs["batch_shardings"]))
        cache = None
    else:
        cache = local(specs["cache_sds"], specs["cache_shardings"])
        args = cache + sum(local(specs[k + "_sds"], specs[k + "_shardings"])
                           for k in ("params", "tokens", "extra", "pos")
                           if k + "_sds" in specs)
    out[name] = {"argument_size_in_bytes": args, "cache_bytes": cache,
                 "params": count_params(cfg),
                 "analytic": cell_model(cfg, shape, chips=256)}
print(json.dumps(out))
"""


def _env():
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=256"
    return env


@pytest.fixture(scope="module")
def cells(tmp_path_factory):
    """{cell: (the port's record, the reference's figures)}."""
    out = tmp_path_factory.mktemp("dryrun_encdec")
    procs = {shape: subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", ARCH,
         "--shape", shape, "--mesh", "single", "--out", str(out)], cwd=ROOT,
        env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for shape in CELLS}
    ref = subprocess.run([sys.executable, "-c", REFERENCE, ARCH, *CELLS],
                         cwd=ROOT, env=_env(), capture_output=True,
                         text=True, timeout=300)
    logs = {shape: p.communicate(timeout=300)[0]
            for shape, p in procs.items()}
    assert ref.returncode == 0, ref.stderr[-3000:]
    want = json.loads(ref.stdout.strip().splitlines()[-1])
    records = {}
    for shape, p in procs.items():
        assert p.returncode == 0, logs[shape]
        assert "cells: 1 OK, 0 FAIL" in logs[shape], logs[shape]
        with open(os.path.join(out, f"{ARCH}__{shape}__single.json")) as f:
            records[shape] = (json.load(f), want[shape])
    return records


@pytest.mark.parametrize("shape", CELLS)
def test_seamless_cell_is_the_references(cells, shape):
    mine, ref = cells[shape]
    assert "error" not in mine, mine.get("traceback")
    assert (mine["arch"], mine["shape"], mine["kind"], mine["devices"]) == (
        ARCH, shape, shape.split("_")[0], 256)
    assert mine["params"] == ref["params"]
    assert mine["analytic"].keys() == ref["analytic"].keys()
    for key, val in ref["analytic"].items():
        assert mine["analytic"][key] == pytest.approx(val, rel=1e-12), key
    assert mine["argument_size_in_bytes"] == ref["argument_size_in_bytes"]
    if ref["cache_bytes"] is not None:
        assert mine["alias_size_in_bytes"] == ref["cache_bytes"]
    for key in ("output_size_in_bytes", "temp_size_in_bytes", "flops"):
        assert mine[key] > 0, key
    counts = mine["collective_counts"]
    assert counts["all-reduce"] > 0
    assert counts["all-to-all"] == counts["collective-permute"] == 0
