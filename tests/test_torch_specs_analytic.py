"""Port parity: the cells' stand-ins (``repro_torch.launch.specs``), the
analytic model (``launch.analytic``) and the roofline
(``launch.roofline``) against the JAX package's.

Specs only, no param init: every registry arch x ``SHAPES`` entry on the
reference's fake 16x16 mesh, leaves compared in the port's per-layer
layout (``test_torch_sharding._port_layout``: a stacked reference leaf
loses its leading dim). ``cell_model`` is pure arithmetic on the configs,
so it agrees to rel 1e-12 (float summation in the same order). The
roofline reads the three committed artifacts under ``experiments/dryrun``;
the port's times are the reference's scaled by the ratio of the two
machines' constants, and every count is equal.
"""

import dataclasses
import glob
import os

import jax
import numpy as np
import pytest
import torch

import repro.launch.roofline as jroof
import repro.launch.specs as jspecs
from repro.configs import registry as jreg
from repro.configs.base import SHAPES as JSHAPES
from repro.configs.base import TrainConfig as JTrain
from repro.launch.analytic import cell_model as jcell
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.configs.base import SHAPES
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.launch import roofline as troof
from repro_torch.launch import specs as tspecs
from repro_torch.launch.analytic import cell_model
from test_torch_sharding import ARCHS, MESH1, _flat, _port_layout
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

DRYRUN = os.path.join(os.path.dirname(__file__), "..", "experiments",
                      "dryrun")


@pytest.fixture(autouse=True)
def _pspec_only(monkeypatch):
    import repro.dist.sharding as jsh

    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, p: tuple(p))
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, p: tuple(p))


def _dtype(dt) -> str:
    return str(dt).replace("torch.", "")


def _same_sds(cfg, ref_tree, port_tree, own=None):
    """Leaf by leaf in the port's layout: shape (a stacked reference leaf
    without its leading dim) and dtype name. ``own(path, stacked)`` gives
    the port's own shape where the layouts' rules differ, else None."""
    ref = _port_layout(cfg, ref_tree)
    port = _flat(port_tree)
    assert set(ref) == set(port)
    for path, (js, stacked) in ref.items():
        shape, dt = port[path]
        cut = 1 if stacked else 0
        mine = own(path, stacked) if own else None
        want = mine if mine is not None else tuple(js.shape[cut:])
        assert want == tuple(shape), path
        assert str(js.dtype) == _dtype(dt), path


def _cache_pairs(cfg, tree, ref):
    if cfg.family == "encdec":
        return [(tree[k][i], ref[k]) for k in ("self", "cross")
                for i in range(cfg.n_layers)]
    return [(tree[n], ref[gi][lk]) for n, (gi, lk, _) in
            enumerate(convert._layer_slots(cfg))]


def _same_cache(cfg, tsds, jsds):
    for ts, js in _cache_pairs(cfg, tsds, jsds):
        assert sorted(ts) == sorted(js)
        for leaf, (shape, dt) in ts.items():
            cut = len(js[leaf].shape) - len(shape)
            assert tuple(js[leaf].shape[cut:]) == tuple(shape), leaf
            assert str(js[leaf].dtype) == _dtype(dt), leaf


@pytest.mark.parametrize("arch", ARCHS)
def test_state_specs_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for opt in ("adamw", "adafactor"):
        jc = dataclasses.replace(jcfg, optimizer=opt)
        tc = dataclasses.replace(tcfg, optimizer=opt)
        jsds, jsh = jspecs.state_specs(jc, JTrain(), MESH1)
        tsds, tsh = tspecs.state_specs(tc, TTrain(), MESH1)
        _same_sds(jcfg, jsds["params"], tsds["params"])
        assert sorted(jsds["opt"]) == sorted(tsds["opt"])
        params = _flat(tsds["params"])

        def own(key):
            # Adafactor factors a stack's 1-d per-layer leaves across the
            # layers: the stack's vc (d,) has no layer axis, so every
            # layer's leaf holds the whole of it (a 0-d leaf's (1,) too)
            def f(path, stacked):
                shape = params[path][0]
                if opt == "adafactor" and stacked and len(shape) <= 1 \
                        and key == "vc":
                    return tuple(shape) if shape else (1,)
                return None
            return f

        for k in jsds["opt"]:
            _same_sds(jcfg, jsds["opt"][k], tsds["opt"][k], own(k))
        assert jsds["step"].shape == tsds["step"][0]
        assert str(jsds["step"].dtype) == _dtype(tsds["step"][1])
        ref = _port_layout(jcfg, jsh["params"])
        for path, spec in _flat(tsh["params"]).items():
            rs, stacked = ref[path]
            assert spec == tuple(rs)[1 if stacked else 0:], path


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name, shape in SHAPES.items():
        jout = jspecs.input_specs(jcfg, JSHAPES[name], MESH1)
        tout = tspecs.input_specs(tcfg, shape, MESH1)
        assert tout["kind"] == jout["kind"] == shape.kind
        if shape.kind == "train":
            _same_sds(jcfg, jout["state_sds"]["params"],
                      tout["state_sds"]["params"])
            for k, (shp, dt) in tout["batch_sds"].items():
                js = jout["batch_sds"][k]
                assert (js.shape, str(js.dtype)) == (shp, _dtype(dt))
                assert tout["batch_shardings"][k] == tuple(
                    jout["batch_shardings"][k])
            # the two-argument form keeps its value
            assert tspecs.batch_specs(tcfg, shape) == tout["batch_sds"]
            continue
        _same_sds(jcfg, jout["params_sds"], tout["params_sds"])
        _same_cache(tcfg, tout["cache_sds"], jout["cache_sds"])
        keys = [k for k in jout if k.endswith("_sds")
                and k not in ("params_sds", "cache_sds")]
        assert sorted(keys) == sorted(k for k in tout if k.endswith("_sds")
                                      and k not in ("params_sds",
                                                    "cache_sds"))
        for k in keys:
            js, (shp, dt) = jout[k], tout[k]
            assert (js.shape, str(js.dtype)) == (shp, _dtype(dt)), k
            sk = k.replace("_sds", "_shardings")
            assert tout[sk] == tuple(jout[sk]), sk


def test_cache_sds_allocates_nothing(monkeypatch):
    made = []
    real = torch.zeros

    def spy(*a, **kw):
        t = real(*a, **kw)
        made.append(t.device.type)
        return t

    monkeypatch.setattr(torch, "zeros", spy)
    out = tspecs.cache_sds(treg.get_config("qwen3-0.6b"), 128, 32_768)
    assert out[0]["k"] == ((128, 32_768, 8, 128), torch.bfloat16)
    assert made and set(made) == {"meta"}


@pytest.mark.parametrize("arch", ARCHS)
def test_cell_model_matches_reference(arch):
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name, shape in SHAPES.items():
        for chips, dp, tp in ((256, 16, 16), (512, 32, 16), (1, 1, 1)):
            ref = jcell(jcfg, JSHAPES[name], chips=chips, dp=dp, tp=tp)
            out = cell_model(tcfg, shape, chips=chips, dp=dp, tp=tp)
            assert sorted(out) == sorted(ref)
            for k in ref:
                assert out[k] == pytest.approx(ref[k], rel=1e-12, abs=0), k


def _artifacts():
    return sorted(glob.glob(os.path.join(DRYRUN, "*.json")))


def test_roofline_reads_the_committed_artifacts():
    assert len(_artifacts()) == 3
    jrows = [jroof.analyse(r) for r in jroof.load(DRYRUN)]
    trows = [troof.analyse(r) for r in troof.load(DRYRUN)]
    assert len(trows) == len(jrows) == 3
    for j, t in zip(jrows, trows):
        assert t["status"] == j["status"] == "OK"
        for k in ("model_flops", "useful_ratio"):
            assert t[k] == pytest.approx(j[k], rel=1e-12), k
        assert t["analytic"] == j["analytic"]
        # the same counts over the card's rates
        assert t["t_compute_s"] * troof.PEAK / jroof.PEAK == pytest.approx(
            j["t_compute_s"], rel=1e-12)
        assert t["t_memory_s"] * troof.HBM / jroof.HBM == pytest.approx(
            j["t_memory_s"], rel=1e-12)
        assert (t["t_collective_s"] * troof.LINK / jroof.ICI
                == pytest.approx(j["t_collective_s"], rel=1e-12))
        assert t["hint"] == troof.HINTS[t["dominant"]]


def test_roofline_constants_are_the_cards():
    assert (troof.PEAK, troof.HBM, troof.LINK) == (67e12, 3.35e12, 450e9)
    src = open(troof.__file__).read()
    for name in ("PEAK", "HBM", "LINK"):
        line = next(l for l in src.splitlines() if l.startswith(name + " "))
        assert "NVIDIA H100 80GB HBM3, 700 W" in line


def test_roofline_main_writes_under_dryrun_torch(tmp_path, capsys):
    out = tmp_path / "dryrun_torch" / "roofline.json"
    troof.main(["--dir", DRYRUN, "--json-out", str(out)])
    table = capsys.readouterr().out
    assert table.count("| qwen3-0.6b |") == 3
    assert out.exists()
    import json

    rows = json.loads(out.read_text())
    assert [r["shape"] for r in rows] == [r["shape"] for r in
                                          jroof.load(DRYRUN)]
    assert np.isfinite([r["t_compute_s"] for r in rows]).all()
