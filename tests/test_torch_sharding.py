"""Port parity: logical axes and the sharding rule table
(``repro_torch.dist.sharding``) against the JAX package's
``repro.dist.sharding``.

No device and no JAX param init: both packages build spec trees only, and
the production meshes (16x16 and 2x16x16) are the reference's own
``FakeMesh`` shape (``tests/test_sharding.py``). The reference's
``NamedSharding`` is swapped for its ``PartitionSpec`` entries, so its
rules run on the fake meshes unchanged.

Layouts are mapped as ``convert`` maps params: the reference stacks a
repeated group (and the enc-dec stacks) on a leading ``"layers"`` dim, the
port keeps one leaf per layer, so a port leaf's axes and specs are the
reference's without that leading entry. One departure is asserted as
such: where the reference's ZeRO-1 extension lands on the layer stack
(32 or 48 stacked layers on a 16-way data axis), the port's per-layer
moment takes the data axes on its own first free divisible dim.
"""

import jax
import numpy as np
import pytest

import repro.dist.sharding as jsh
import repro.launch.specs as jspecs
from repro.configs import registry as jreg
from repro.configs.base import SHAPES
from repro.configs.base import TrainConfig as JTrain
from repro.models import paper_models as jpaper
from repro.nn.module import flatten_with_paths as jflatten
from repro.optim.optimizers import adamw_state_specs as jadamw_specs
from repro_torch import convert
from repro_torch.configs import registry as treg
from repro_torch.configs.base import TrainConfig as TTrain
from repro_torch.dist import sharding as sh
from repro_torch.launch import specs as tspecs
from repro_torch.launch.mesh import MeshSpec, make_production_mesh
from repro_torch.models import paper_models as tpaper
from repro_torch.nn.module import ParamSpec, _walk
from repro_torch.optim.optimizers import adamw_state_specs
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

ARCHS = sorted(treg.ARCHS)


class FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH1 = FakeMesh({"data": 16, "model": 16})
MESH2 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = {"single": MESH1, "multi": MESH2}


@pytest.fixture(autouse=True)
def _pspec_only(monkeypatch):
    """The reference's rules wrap each spec in a NamedSharding, which needs
    a real mesh; keep the PartitionSpec entries instead."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, p: tuple(p))
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, p: tuple(p))


def _port_layout(cfg, tree):
    """Reference tree -> {port path: (leaf, stacked)} in the port's
    per-layer layout (the leaf itself not yet cut)."""
    out = {}

    def put(prefix, sub, stacked):
        if isinstance(sub, dict):
            for k, v in sub.items():
                put(prefix + (k,), v, stacked)
        else:
            out[prefix] = (sub, stacked)

    if cfg.family == "encdec":
        for k, v in tree.items():
            if k not in convert.ENCDEC_STACKS:
                put((k,), v, False)
        depths = (cfg.n_enc_layers or cfg.n_layers, cfg.n_layers)
        for name, n in zip(convert.ENCDEC_STACKS, depths):
            for i in range(n):
                put((name, str(i)), tree[name], True)
        return out
    for k, v in tree.items():
        if not k.startswith("group"):
            put((k,), v, False)
    for n, (gi, lkey, r) in enumerate(convert._layer_slots(cfg)):
        put(("layers", str(n)), tree[f"group{gi}"][lkey], r is not None)
    return out


def _flat(tree):
    out = {}

    def rec(t, p):
        if isinstance(t, dict):
            for k, v in t.items():
                rec(v, p + (k,))
        else:
            out[p] = t

    rec(tree, ())
    return out


def _models(arch):
    return (jspecs.build_model(jreg.get_config(arch)),
            tspecs.build_model(treg.get_config(arch), device="cpu"))


# ---------------------------------------------------------------------------
# Logical axes on every param
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_axes_match_reference(arch):
    jm, tm = _models(arch)
    ref = _port_layout(jreg.get_config(arch), jm.specs())
    port = {p: s for p, s in _walk(tm.specs())}
    assert set(ref) == set(port)
    for path, (js, stacked) in ref.items():
        ts = port[path]
        cut = 1 if stacked else 0
        if stacked:
            assert js.axes[0] == "layers"
        assert ts.axes == js.axes[cut:], path
        assert ts.shape == js.shape[cut:], path
        assert ts.dtype.itemsize == np.dtype(js.dtype).itemsize, path


@pytest.mark.parametrize("which", ["mlp", "asic", "cnn", "lstm"])
def test_paper_model_axes_match_reference(which):
    make = {
        "mlp": (lambda m: m.SWMMLP()),
        "asic": (lambda m: m.SWMMLP(dims=(256, 128, 128, 10),
                                    block_size=16)),
        "cnn": (lambda m: m.SWMCNN()),
        "lstm": (lambda m: m.SWMLSTMASR()),
    }[which]
    ref = {tuple(p): s for p, s in jflatten(make(jpaper).specs())}
    port = {p: s for p, s in _walk(make(tpaper).specs())}
    assert set(ref) == set(port)
    for path, js in ref.items():
        assert port[path].axes == js.axes, path
        assert port[path].shape == js.shape, path


def test_param_spec_axes_default_and_rank_check():
    assert ParamSpec((3, 4)).axes == ()
    assert ParamSpec((3, 4), axes=("embed", None)).axes == ("embed", None)
    with pytest.raises(ValueError, match="rank"):
        ParamSpec((3, 4), axes=("embed",))
    # appended last: the positional order (shape, dtype, init, scale,
    # tags) keeps its meaning
    s = ParamSpec((2,), "float32", "zeros", 0.5, ("t",), (None,))
    assert (s.init, s.scale, s.tags, s.axes) == ("zeros", 0.5, ("t",),
                                                 (None,))


def test_map_specs_and_param_bytes_match_reference():
    from repro.nn.module import param_bytes as jbytes
    from repro_torch.nn.module import map_specs, param_bytes

    for arch in ("qwen3-0.6b", "jamba-v0.1-52b", "seamless-m4t-medium"):
        jm, tm = _models(arch)
        assert param_bytes(tm.specs()) == jbytes(jm.specs())
        paths = []
        tree = map_specs(lambda p, s: paths.append(p) or s.shape, tm.specs())
        assert _flat(tree) == {p: s.shape for p, s in _walk(tm.specs())}
        assert sorted(paths) == sorted(p for p, _ in _walk(tm.specs()))


# ---------------------------------------------------------------------------
# Param and ZeRO-1 shardings on the production meshes
# ---------------------------------------------------------------------------


def _dp_entry(mesh):
    dp = sh.data_axes(mesh)
    return dp if len(dp) > 1 else dp[0]


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_shardings_match_reference(arch, mesh):
    m = MESHES[mesh]
    jcfg = jreg.get_config(arch)
    jm, tm = _models(arch)
    jp, tp = jm.specs(), tm.specs()
    jmom, tmom = jadamw_specs(jp, JTrain())["m"], adamw_state_specs(
        tp, TTrain())["m"]
    n_dp = sh.dp_size(m)
    moved = 0
    for fsdp in (False, True):
        for low_tp in (False, True):
            kw = dict(fsdp=fsdp, low_tp=low_tp)
            ref = _port_layout(jcfg, jsh.param_shardings(m, jp, **kw))
            port = _flat(sh.param_shardings(m, tp, **kw))
            for path, (rs, stacked) in ref.items():
                cut = 1 if stacked else 0
                assert rs[:cut] in ((), (None,)), path
                assert port[path] == tuple(rs)[cut:], (path, kw)
            ref = _port_layout(jcfg, jsh.opt_shardings(m, jmom, **kw))
            port = _flat(sh.opt_shardings(m, tmom, **kw))
            specs = _flat(tmom)
            for path, (rs, stacked) in ref.items():
                rs = tuple(rs)
                if not (stacked and rs[0] is not None):
                    assert port[path] == rs[1 if stacked else 0:], (path, kw)
                    continue
                # the reference's ZeRO-1 took the layer stack: the port's
                # per-layer moment takes its first free divisible dim
                moved += 1
                assert rs[0] == _dp_entry(m)
                shape = specs[path].shape
                free = [i for i, (e, d) in enumerate(zip(rs[1:], shape))
                        if e is None and d % n_dp == 0]
                want = list(rs[1:])
                pick = [i for i in free if shape[i] > 1] or free
                if pick:
                    want[pick[0]] = _dp_entry(m)
                assert port[path] == tuple(want), (path, kw)
    stacks = {g.repeat for g in jcfg.layer_groups()} | (
        {jcfg.n_layers} if jcfg.family == "encdec" else set())
    assert (moved > 0) == any(r > 1 and r % n_dp == 0 for r in stacks)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_batch_pspec_matches_reference(mesh):
    m = MESHES[mesh]
    for ndim in (1, 2, 3):
        for batch in (None, 1, 8, 16, 32, 256, 512, 1000):
            assert sh.batch_pspec(m, ndim, batch=batch) == tuple(
                jsh.batch_pspec(m, ndim, batch=batch))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch, mesh):
    m = MESHES[mesh]
    jcfg, tcfg = jreg.get_config(arch), treg.get_config(arch)
    for name, shape in SHAPES.items():
        if shape.kind == "train":
            continue
        B, S = shape.global_batch, shape.seq_len
        jsds = jspecs.cache_sds(jcfg, B, S)
        jshard = jspecs.cache_shardings(jcfg, jsds, m)
        tsds = tspecs.cache_sds(tcfg, B, S)
        tshard = tspecs.cache_shardings(tcfg, tsds, m)
        if tcfg.family == "encdec":
            pairs = [(tsds[k][i], tshard[k][i], jsds[k], jshard[k])
                     for k in ("self", "cross") for i in range(tcfg.n_layers)]
        else:
            pairs = [(tsds[n], tshard[n], jsds[gi][lk], jshard[gi][lk])
                     for n, (gi, lk, _) in
                     enumerate(convert._layer_slots(tcfg))]
        for ts, tsh, js, jsh_ in pairs:
            assert sorted(ts) == sorted(js)
            for leaf in ts:
                (shp, _), rs = ts[leaf], tuple(jsh_[leaf])
                cut = len(js[leaf].shape) - len(shp)
                assert tuple(js[leaf].shape[cut:]) == shp
                assert tsh[leaf] == rs[cut:], (name, leaf)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_sharding.py
# ---------------------------------------------------------------------------


def _pspec(axes, shape, mesh=MESH1, fsdp=False):
    rules = sh.make_param_rules(mesh, fsdp)
    return sh.spec_to_pspec(axes, shape, rules, mesh)


def test_tp_rules():
    assert _pspec(("embed", "mlp"), (4096, 16384)) == (None, "model")
    assert _pspec(("mlp", "embed"), (16384, 4096)) == ("model", None)
    assert _pspec(("vocab", "embed"), (151936, 1024)) == ("model", None)


def test_circulant_tables_inherit_dense_axes():
    assert _pspec(("mlp", "embed", None), (128, 32, 128)) == ("model", None,
                                                              None)


def test_non_divisible_dims_dropped():
    assert _pspec(("vocab", None), (10, 4)) == (None, None)
    assert _pspec(("embed", "kv_heads"), (1024, 8)) == (None, None)


def test_axis_never_reused():
    assert _pspec(("experts", "embed", "mlp"), (128, 7168, 4864)) == (
        "model", None, None)


def test_fsdp_adds_data_axis():
    assert _pspec(("experts", "embed", "mlp"), (128, 7168, 4864),
                  fsdp=True) == ("model", "data", None)


def test_multipod_batch_axes():
    assert sh.data_axes(MESH2) == ("pod", "data")
    assert sh.batch_pspec(MESH2, 2, batch=256) == (("pod", "data"), None)
    assert sh.batch_pspec(MESH2, 2, batch=1) == (None, None)


def test_zero1_extends_moments():
    specs = {"w": ParamSpec((64, 128), axes=("embed", "mlp"))}
    local = MeshSpec(("data", "model"), {"data": 1, "model": 1})
    assert "data" in sh.opt_shardings(local, specs, zero1=True)["w"]
    assert "data" not in sh.opt_shardings(local, specs, zero1=False)["w"]


# ---------------------------------------------------------------------------
# Meshes, slices, the ambient mesh
# ---------------------------------------------------------------------------


def test_production_mesh_descriptions():
    single, multi = make_production_mesh(), make_production_mesh(
        multi_pod=True)
    assert single.axis_names == ("data", "model") and single.size == 256
    assert multi.axis_names == ("pod", "data", "model") and multi.size == 512
    for ours, theirs in ((single, MESH1), (multi, MESH2)):
        assert sh.data_axes(ours) == jsh.data_axes(theirs)
        assert sh.make_param_rules(ours, True) == jsh.make_param_rules(
            theirs, True)
        assert sh.make_act_rules(ours) == jsh.make_act_rules(theirs)


def test_local_slices_cover_the_tensor_once():
    import torch

    t = torch.arange(2 * 32 * 6).reshape(2, 32, 6)
    spec = (None, ("pod", "data"), None)
    seen = torch.zeros_like(t)
    for pod in range(2):
        for data in range(16):
            coord = (pod, data, 0)
            part = sh.local_shard(t, spec, MESH2, coordinate=coord)
            sl = sh.local_slices(t.shape, spec, MESH2, coordinate=coord)
            assert sl[1] == ((pod * 16 + data), (pod * 16 + data) + 1)
            assert torch.equal(part, t[:, sl[1][0]:sl[1][1]])
            seen[:, sl[1][0]:sl[1][1]] += 1
    assert np.all(seen.numpy() == 1)
    assert sh.local_shard(t, (None, None, None), MESH2,
                          coordinate=(0, 0, 0)) is t


def test_ambient_mesh_and_batch_constraint():
    import torch

    assert sh.get_ambient_mesh() is None
    sh.set_ambient_mesh(MESH1)
    try:
        assert sh.get_ambient_mesh() is MESH1
        x = torch.ones(32, 4)
        assert sh.constrain_batch_leading(x) is x
    finally:
        sh.set_ambient_mesh(None)


def test_state_shardings_tree_matches_reference_keys():
    sds, shard = tspecs.state_specs(treg.get_config("qwen3-0.6b"), TTrain(),
                                    MESH1)
    assert sorted(shard) == ["opt", "params", "step"]
    assert sorted(shard["opt"]) == ["m", "v"] and shard["step"] == ()
    assert sds["step"][0] == ()
