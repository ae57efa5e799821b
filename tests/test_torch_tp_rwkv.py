"""Port: the RWKV mixer (rwkv6-7b) trained and served under a ``model``
mesh axis: the time mix's r, k, v and g are column-parallel and ``u``
split on its heads (``dist.tensor_parallel.rwkv_layout``), so each rank
runs the WKV scan, group norm and gate of its heads, and ``o`` sums into
the residual; x and the time mix's whole leaves enter the region; the
channel mix's ``wk`` is column- and ``wv`` row-parallel with only ``wk``'s
input entering the region; the shift states split on their channels and
the WKV state on its heads (``launch.specs.cache_shardings``).

The multi-rank half spawns two ``gloo`` worlds on the CPU at once, of 4
and of 2 ranks. Each rank builds its meshes with ``init_device_mesh`` and
runs rwkv6's smoke config (3 layers, d 64, 4 heads of 16, k = 8) in f32
with ``impl="freq"``:

* training, ``remat="block"``: two AdamW steps on ``(1, 2)``, ``(2, 2)``
  and ``(1, 4)``, against one process on the whole batch (rel 1e-5:
  loss, grad norm, params over the tree; 1e-4 leaf by leaf, params and
  moments); the ``(2, 2)`` step also against the reference's (rel 2e-5);
* serving, frozen f32 and int8 tables: a prefill of left-padded prompts
  (the mask path) and greedy decode steps on ``(1, 2)`` and ``(2, 2)``,
  against one process (logits rel 1e-5, tokens equal, each cache shard
  the one process's cut at the rank's coordinate).

The batch is 6 rows: the cache rule gives ``model`` to the first dim after
the slot axis that equals a head or channel size the config names (4, 64,
128 at smoke size), so a batch of 4 would put it on the slot axis.

In this process: the cache specs against the reference's rule; one time
mix and one channel mix on threaded ranks against the whole module,
forward and every leaf's gradient, with two planted faults the gradients
must show (a LoRA leaf left without its backward sum; x entering the
channel mix's region, which sums the r path's gradient ``model`` times);
and a split that cuts a head, refused by name.
"""

import dataclasses
import socket

import test_torch_threads  # noqa: F401  (one thread budget per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import repro.dist.sharding as jsh
import repro.launch.specs as jspecs
from repro.configs import rwkv6_7b as jmod
from repro.configs.base import TrainConfig as JTrain
from repro.models.decoder import HybridDecoderLM as JLM
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import rwkv6_7b as tmod
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import sharding as sh
from repro_torch.dist.tensor_parallel import (RWKVLayout, ServeParallel,
                                              rwkv_layout, shard_params)
from repro_torch.kernels.block_circulant.plan import freeze_params
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.specs import build_model, cache_sds, cache_shardings
from repro_torch.nn import rwkv
from repro_torch.nn.module import init_params, load_tree, tree_leaves
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.loop import init_train_state, make_train_step

jax.config.update("jax_platform_name", "cpu")

REL = 1e-5
REF_REL = 2e-5          # fp32 vs fp32 (tests/test_torch_train.py REL_TOL)
# leaf by leaf, after 2 f32 steps or in one region's gradients: the time
# mix's gradients are ill-conditioned in f32, so a change of summation
# order alone moves single leaves by more than 1e-5 of their largest
# entry. The controls show it: one process, or one whole time mix, given
# a rounding step (its embedding table, or x, times 1 + NOISE noise) moves
# its own leaves past 1e-5 (test_a_rounding_step_moves_leaves_past_1e5);
# the planted faults move leaves by over 1e-2. This is LEAF_TOL of
# tests/test_torch_train_families.py.
LEAF_REL = 1e-4
NOISE = 6e-8
B, SEQ, STEPS = 6, 16, 2
PROMPT, CACHE_LEN, DECODE = 12, 32, 4
PADS = (0, 3, 5, 1, 2, 0)   # left pads of the served prompts
QUANTIZE = ("off", "int8")
TCFG = TrainConfig(warmup_steps=1, total_steps=10)

RWKV = dataclasses.replace(
    tmod.SMOKE, swm=dataclasses.replace(tmod.SMOKE.swm, impl="freq"),
    remat="block")
HD = RWKV.rwkv_head_dim
TRAIN4 = {"2x2": (2, 2), "1x4": (1, 4)}
TRAIN2 = {"1x2": (1, 2)}
TRAIN = {**TRAIN4, **TRAIN2}
SERVE4 = {"2x2": (2, 2)}
SERVE2 = {"1x2": (1, 2)}
SERVE = {**SERVE4, **SERVE2}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _tree_rel(got, want):
    diff = sum(float(np.square(np.asarray(a, np.float64) - b).sum())
               for a, b in zip(got, want))
    norm = sum(float(np.square(np.asarray(b, np.float64)).sum())
               for b in want)
    return (diff / norm) ** 0.5


def _np(tree):
    return [t.detach().float().numpy().copy() for t in tree_leaves(tree)]


def _batches(cfg):
    return [{"tokens": torch.from_numpy(np.random.default_rng(10 + i).integers(
        0, cfg.vocab, (B, SEQ + 1)).astype(np.int32))} for i in range(STEPS)]


def _noisy(t, seed=1):
    """``t`` times 1 + NOISE seeded noise: a rounding step."""
    noise = np.random.default_rng(seed).standard_normal(t.shape)
    return t * (1 + NOISE * torch.from_numpy(noise.astype(np.float32)))


def _train(cfg, mesh=None, perturb=False):
    """STEPS steps from seed 0's whole params (the embedding table given a
    rounding step with ``perturb``): (state, step, metrics, model)."""
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, cfg, TCFG, mesh=mesh)
    shard = (step.data_parallel.state_shardings if mesh is not None
             else {"params": None, "opt": None})
    params = init_params(model.specs(), 0, device="cpu")
    if perturb:
        params["embed"]["table"] = _noisy(params["embed"]["table"])
    state = init_train_state(params, TCFG, opt_shardings=shard["opt"],
                             param_shardings=shard["params"], mesh=mesh)
    metrics = None
    for b in _batches(cfg):
        state, metrics = step(state, b)
    return state, step, metrics, model


def _prompts(cfg):
    """Left-padded prompts (pad token 0) and their positions, negative on
    the pads."""
    rng = np.random.default_rng(3)
    toks = rng.integers(1, cfg.vocab, (B, PROMPT)).astype(np.int32)
    pads = np.asarray(PADS)[:, None]
    pos = (np.arange(PROMPT)[None, :] - pads).astype(np.int32)
    toks[pos < 0] = 0
    return toks, pos


def _cache_np(cache):
    return [{k: v.float().numpy().copy() for k, v in layer.items()}
            for layer in cache]


def _serve(cfg, quantize, mesh=None, group=None):
    """Prefill and DECODE greedy steps on seed 0's frozen params: (each
    step's logits of this rank's rows, every step's global greedy tokens,
    the final cache, the steps' ServeParallel or None)."""
    model = build_model(cfg, device="cpu")
    specs = model.specs()
    load_tree(model, freeze_params(specs, init_params(specs, 0, device="cpu"),
                                   quantize))
    prefill = make_prefill_step(model, cfg, mesh=mesh)
    decode = make_decode_step(model, cfg, mesh=mesh)
    par = prefill.parallel
    cache = (par.init_cache(B, CACHE_LEN) if par is not None
             else model.init_cache(B, CACHE_LEN))
    toks, pos = _prompts(cfg)
    logits, cache = prefill(torch.from_numpy(toks), cache,
                            positions=torch.from_numpy(pos))
    outs, out_toks = [logits.numpy().copy()], []
    for i in range(DECODE + 1):
        tok = logits.argmax(-1).to(torch.int32)
        if par is not None and tok.shape[0] < B:
            tok = torch.cat(sh.all_gather_list(tok, group))
        out_toks.append(tok.numpy().copy())
        if i == DECODE:
            break
        step_pos = torch.from_numpy(pos[:, -1] + 1 + i)
        logits, cache = decode(tok[:, None], cache, step_pos)
        outs.append(logits.numpy().copy())
    return outs, out_toks, cache, par


# ---------------------------------------------------------------------------
# The spawned ranks
# ---------------------------------------------------------------------------


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _layouts(model):
    """The time mixes' head ranges and the channel mixes' split flags."""
    return (sorted({None if m.tp is None else m.tp.heads
                    for m in model.modules()
                    if isinstance(m, rwkv.RWKV6TimeMix)}, key=str),
            sorted({m.tp is not None for m in model.modules()
                    if isinstance(m, rwkv.RWKV6ChannelMix)}))


def _rank_train(shape):
    mesh = _mesh(shape)
    state, step, m, model = _train(RWKV, mesh)
    dp = step.data_parallel
    return {"coord": tuple(int(c) for c in mesh.get_coordinate()),
            "params": _np(state["params"]), "opt": _np(state["opt"]),
            "shardings": dp.state_shardings,
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "collectives": dp.collectives, "layouts": _layouts(model)}


def _rank_serve(shape):
    mesh = _mesh(shape)
    out = {"coord": tuple(int(c) for c in mesh.get_coordinate())}
    for q in QUANTIZE:
        logits, toks, cache, par = _serve(RWKV, q, mesh,
                                          mesh.get_group("data"))
        out[q] = {"logits": logits, "tokens": toks,
                  "cache": _cache_np(cache),
                  "counts": dict(par.log.counts),
                  "layouts": _layouts(par.model)}
    return out


def _rank_main(world, rank, port, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    out = {"rank": rank}
    try:
        four = world == 4
        for name, shape in (TRAIN4 if four else TRAIN2).items():
            out[("train", name)] = _rank_train(shape)
        for name, shape in (SERVE4 if four else SERVE2).items():
            out[("serve", name)] = _rank_serve(shape)
    except Exception as e:            # reported by the test, which fails
        import traceback

        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        q.put(out)
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks():
    """The ranks' reports, the world of 4's and the world of 2's, both
    worlds run at once."""
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = []
    for world in (4, 2):
        with socket.socket() as s:
            s.bind(("localhost", 0))
            port = s.getsockname()[1]
        procs += [ctx.Process(target=_rank_main, args=(world, r, port, q))
                  for r in range(world)]
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
    return outs


def _outs(ranks, kind, name):
    got = [o for o in ranks if (kind, name) in o]
    return [o[(kind, name)] for o in sorted(got, key=lambda o: o["rank"])]


def _mesh_spec(shape):
    return MeshSpec(("data", "model"), dict(zip(("data", "model"), shape)))


def _cut(full, spec, shape, coord):
    return sh.local_shard(torch.from_numpy(np.asarray(full)), spec,
                          _mesh_spec(shape), coordinate=coord).numpy()


def _specs(shardings, part):
    tree = shardings[part]
    if part == "opt":
        return [s for k in sorted(tree) for s in tree_leaves(tree[k])]
    return tree_leaves(tree)


@pytest.fixture(scope="module")
def one_process():
    """rwkv6 trained and served whole in this process, and trained again
    from a rounding step on its embedding table (the control)."""
    state, _, m, _ = _train(RWKV)
    control = _train(RWKV, perturb=True)[0]
    return {"train": ({"params": _np(state["params"]),
                       "opt": _np(state["opt"])}, m),
            "control": {"params": _np(control["params"]),
                        "opt": _np(control["opt"])},
            "serve": {q: _serve(RWKV, q) for q in QUANTIZE}}


def _heads(shape, coord):
    """The rank's layouts: its H / model heads in every time mix, every
    channel mix split."""
    n = RWKV.d_model // HD // shape[1]
    return ([(coord[1] * n, (coord[1] + 1) * n)], [True])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(TRAIN))
def test_sharded_train_step_matches_one_process(ranks, one_process,
                                                variant):
    """Loss, grad norm and params over the tree within rel 1e-5 of one
    process's on the whole batch after 2 steps, every param and moment
    leaf within 1e-4 (``LEAF_REL``), every rank's shard the one process's
    state cut at its coordinate; every time mix holds the rank's H / model
    heads."""
    shape = TRAIN[variant]
    full, m = one_process["train"]
    outs = _outs(ranks, "train", variant)
    assert len(outs) == shape[0] * shape[1]
    n_split = 0
    for got in outs:
        assert got["loss"] == pytest.approx(float(m["loss"]), rel=REL)
        assert got["grad_norm"] == pytest.approx(float(m["grad_norm"]),
                                                 rel=REL)
        want = {part: [_cut(b, spec, shape, got["coord"]) for b, spec in
                       zip(full[part], _specs(got["shardings"], part))]
                for part in ("params", "opt")}
        for part in ("params", "opt"):
            for a, b, f in zip(got[part], want[part], full[part]):
                assert a.shape == b.shape
                n_split += a.shape != f.shape
        assert _tree_rel(got["params"], want["params"]) <= REL
        for a, b in zip(got["params"] + got["opt"],
                        want["params"] + want["opt"]):
            assert _rel(a, b) <= LEAF_REL
        assert got["collectives"] == outs[0]["collectives"] > 0
        assert got["layouts"] == _heads(shape, got["coord"])
    assert n_split > 0


@pytest.mark.parametrize("variant", sorted(TRAIN))
def test_rwkv_leaves_follow_the_rule(variant):
    """r, k, v and g split on their output blocks, o on its input blocks,
    u on its heads, the channel mix's wk and wv on their ``mlp`` blocks;
    every other RWKV leaf whole."""
    shape = TRAIN[variant]
    specs = build_model(RWKV, device="meta").specs()
    pspecs = sh.param_shardings(_mesh_spec(shape), specs)
    for i in range(RWKV.n_layers):
        mix = pspecs["layers"][str(i)]["mixer"]
        for name in ("r", "k", "v", "g"):
            assert mix[name]["w"] == ("model", None, None)
        assert mix["o"]["w"] == (None, "model", None)
        assert mix["u"] == ("model", None)
        for name in rwkv._WHOLE:
            assert set(mix[name]) == {None}, name
        ffn = pspecs["layers"][str(i)]["ffn_dense"]
        assert ffn["wk"]["w"] == ("model", None, None)
        assert ffn["wv"]["w"] == (None, "model", None)
        assert ffn["wr"]["w"] == (None, None, None)
        for name in ("mu_k", "mu_r"):
            assert ffn[name] == (None,)


def test_a_rounding_step_moves_leaves_past_1e5(one_process):
    """The controls behind LEAF_REL: one process trained from its
    embedding table given a rounding step stays within 1e-5 of itself
    over the params' tree but moves single param or moment leaves past
    1e-5 of their largest entry, and so does one whole time mix's leaf
    gradients when x is given a rounding step; all stay within
    LEAF_REL."""
    full, control = one_process["train"][0], one_process["control"]
    assert _tree_rel(control["params"], full["params"]) <= REL
    train = max(_rel(a, b) for a, b in zip(
        control["params"] + control["opt"], full["params"] + full["opt"]))
    mod = rwkv.RWKV6TimeMix(RWKV)
    params = init_params(mod.specs(), 0, device="cpu")
    x = _region_inputs()[0]
    whole, noisy = _run(mod, params, x), _run(mod, params, _noisy(x))
    region = max(_rel(noisy[2][n], g) for n, g in whole[2].items())
    assert REL < train <= LEAF_REL and REL < region <= LEAF_REL


def test_two_by_two_train_step_matches_the_reference(ranks):
    """(2, 2) against the reference's one-device AdamW step on the same
    numpy tree and batches (rel 2e-5)."""
    tparams = init_params(build_model(RWKV, device="cpu").specs(), 0,
                          device="cpu")
    jcfg = dataclasses.replace(
        jmod.SMOKE, swm=dataclasses.replace(jmod.SMOKE.swm, impl="freq"),
        remat="block")
    jt = JTrain(warmup_steps=TCFG.warmup_steps,
                total_steps=TCFG.total_steps)
    jstate = jinit_state(jax.tree.map(jnp.asarray, convert.to_reference(
        RWKV, tparams)), jt)
    jstep = jax.jit(jmake_step(JLM(jcfg), jcfg, jt))
    for b in _batches(RWKV):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v.numpy())
                                    for k, v in b.items()})
    want = _np(convert.from_reference(
        RWKV, jax.tree.map(np.asarray, jstate["params"]), device="cpu"))
    for got in _outs(ranks, "train", "2x2"):
        assert _rel(got["loss"], jm["loss"]) <= REF_REL
        assert _rel(got["grad_norm"], jm["grad_norm"]) <= REF_REL
        cut = [_cut(b, spec, (2, 2), got["coord"]) for b, spec in
               zip(want, _specs(got["shardings"], "params"))]
        assert _tree_rel(got["params"], cut) <= REF_REL


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def _rows(shape, coord):
    n = B // shape[0]
    return slice(coord[0] * n, (coord[0] + 1) * n)


@pytest.mark.parametrize("quantize", QUANTIZE)
@pytest.mark.parametrize("variant", sorted(SERVE))
def test_sharded_serve_matches_one_process(ranks, one_process, variant,
                                           quantize):
    """Each rank's logits (its rows, whole over the vocabulary) within rel
    1e-5 of one process's at every step, the greedy tokens equal, and its
    cache shards the one process's caches cut by ``cache_shardings`` at
    its coordinate: the shift states 1/model of one process's on their
    channels, the WKV state on its heads."""
    shape = SERVE[variant]
    logits, toks, cache, _ = one_process["serve"][quantize]
    spec = _mesh_spec(shape)
    specs = cache_shardings(RWKV, cache_sds(RWKV, B, CACHE_LEN), spec)
    want_cache = _cache_np(cache)
    outs = _outs(ranks, "serve", variant)
    for o in outs:
        got, coord = o[quantize], o["coord"]
        rows = _rows(shape, coord)
        for a, b in zip(got["logits"], logits):
            assert a.shape == b[rows].shape
            assert _rel(a, b[rows]) <= REL
        for a, b in zip(got["tokens"], toks):
            np.testing.assert_array_equal(a, b)
        assert got["counts"] == outs[0][quantize]["counts"]
        assert got["counts"]["all-gather"] > 0
        assert got["layouts"] == _heads(shape, coord)
        assert len(got["cache"]) == RWKV.n_layers
        for layer, want, lspec in zip(got["cache"], want_cache, specs):
            assert lspec["shift_att"] == lspec["shift_ffn"] == (
                "data" if shape[0] > 1 else None, "model")
            assert lspec["wkv"][1:] == ("model", None, None)
            for name in layer:
                cut = sh.local_shard(torch.from_numpy(want[name]),
                                     lspec[name], spec,
                                     coordinate=coord).numpy()
                assert layer[name].shape == cut.shape, name
                assert _rel(layer[name], cut) <= REL, name
                assert layer[name].shape[1] * shape[1] == \
                    want[name].shape[1], name


def test_padded_prompts_take_the_mask_path():
    """The served prompts carry left pads, so every RWKV layer runs its
    validity mask: the states of the most padded row equal those of its
    prompt prefilled alone, unpadded (rel 1e-5)."""
    toks, pos = _prompts(RWKV)
    r = int(np.argmax(PADS))
    model = build_model(RWKV, device="cpu")
    specs = model.specs()
    load_tree(model, freeze_params(specs, init_params(specs, 0, device="cpu"),
                                   "off"))
    prefill = make_prefill_step(model, RWKV)
    _, padded = prefill(torch.from_numpy(toks), model.init_cache(B, CACHE_LEN),
                        positions=torch.from_numpy(pos))
    _, alone = prefill(torch.from_numpy(toks[r:r + 1, PADS[r]:]),
                       model.init_cache(1, CACHE_LEN))
    assert PADS[r] > 0
    for got, want in zip(padded, alone):
        for name in ("shift_att", "shift_ffn", "wkv"):
            assert _rel(got[name][r], want[name][0]) <= REL, name


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_cache_layouts_are_the_reference_rules(monkeypatch, shape):
    """The port's cache specs for rwkv6 are the reference's
    ``cache_shardings`` on its stacked leaves (the layer stack dropped):
    the shift states split over ``model`` on their channels, the WKV
    state on its heads; a ``ServeParallel`` on a fake world of that shape
    accepts them."""
    from repro_torch.launch.dryrun import fake_world

    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, p: tuple(p))
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, p: tuple(p))
    jcfg = dataclasses.replace(
        jmod.SMOKE, swm=dataclasses.replace(jmod.SMOKE.swm, impl="freq"))
    axes = dict(zip(("data", "model"), shape))
    jsds = jspecs.cache_sds(jcfg, B, CACHE_LEN)
    ref = jspecs.cache_shardings(jcfg, jsds, _FakeMesh(axes))
    got = cache_shardings(RWKV, cache_sds(RWKV, B, CACHE_LEN),
                          _mesh_spec(shape))
    assert len(got) == RWKV.n_layers
    for layer, (gi, lk, _) in zip(got, convert._layer_slots(RWKV)):
        for name, spec in layer.items():
            want = tuple(ref[gi][lk][name])
            assert spec == want[len(want) - len(spec):], (gi, lk, name)
        assert layer["shift_att"][1] == layer["shift_ffn"][1] == "model"
        assert layer["wkv"][1:] == ("model", None, None)
    with fake_world(shape[0] * shape[1]):
        par = ServeParallel(_mesh(shape), build_model(RWKV, device="meta"),
                            RWKV)
        assert par.cache_shardings(B, CACHE_LEN) == got


def test_a_batch_of_a_head_count_is_refused_for_serving():
    """A batch of 4 (the smoke config's head count) puts ``model`` on the
    slot axis under the rule, which a sharded serve step refuses."""
    from repro_torch.launch.dryrun import fake_world

    with fake_world(2):
        par = ServeParallel(_mesh((1, 2)), build_model(RWKV, device="meta"),
                            RWKV)
        with pytest.raises(NotImplementedError, match="dim 0 of"):
            par.cache_shardings(RWKV.d_model // HD, CACHE_LEN)


# ---------------------------------------------------------------------------
# One time mix and one channel mix, the ranks as threads
# ---------------------------------------------------------------------------


class _RankMesh:
    """Rank ``r`` of a ``(1, m)`` mesh, for the layout's slices."""

    def __init__(self, m, r):
        self.axis_names, self.shape = ("data", "model"), {"data": 1,
                                                          "model": m}
        self.r = r

    def get_coordinate(self):
        return (0, self.r)


def _leafy(tree):
    """A copy of ``tree`` whose tensors are leaves that require grads."""
    return {k: _leafy(v) if isinstance(v, dict)
            else v.detach().clone().requires_grad_(True)
            for k, v in tree.items()}


def _named(tree, path=()):
    out = []
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            out += _named(tree[k], path + (k,))
        else:
            out.append((".".join(path + (k,)), tree[k]))
    return out


def _region_inputs():
    """x (2, 9, d), a validity mask with 2 left pads in row 1 and the
    output weights of the scalar whose gradients are taken."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, RWKV.d_model)).astype(
        np.float32))
    mask = torch.from_numpy(np.arange(9)[None, :] >= np.array([[0], [2]]))
    w_out = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    return x, mask, w_out


def _run(module, tree, x, axis=None, fault=None):
    """``module`` on ``tree``: (y, x's grad, {leaf: grad}) of sum(y *
    w_out); ``fault`` 'r_path' lets x enter the region first."""
    _, mask, w_out = _region_inputs()
    tree = _leafy(tree)
    load_tree(module, tree)
    xr = x.clone().requires_grad_(True)
    xin = sh.region_input(xr, axis) if fault == "r_path" else xr
    y, _ = module(xin, mask=mask)
    names = [n for n, _ in _named(tree)]
    ts = [t for _, t in _named(tree)]
    grads = torch.autograd.grad((y * w_out).sum(), [xr] + ts)
    return y.detach(), grads[0], dict(zip(names, grads[1:]))


def _region(monkeypatch, kind, m, fault=None):
    """One time mix (``kind`` 'time') or channel mix ('channel') of the
    smoke config over a (1, m) split with the ranks as threads, against
    the whole module: (the whole forward and grads, each rank's
    (layout, y, x's grad, leaf grads), the param specs). ``fault``:
    'lora' leaves ``mix_A`` without its backward sum; 'r_path' lets x
    enter the channel mix's region."""
    from test_torch_tensor_parallel import _Threads

    cls = rwkv.RWKV6TimeMix if kind == "time" else rwkv.RWKV6ChannelMix
    mod = cls(RWKV)
    specs = mod.specs()
    params = init_params(specs, 0, device="cpu")
    x = _region_inputs()[0]
    whole = _run(mod, params, x)
    mesh = _mesh_spec((1, m))
    pspecs = sh.param_shardings(mesh, specs)
    threads = _Threads(m, monkeypatch)
    if fault == "lora":
        real = rwkv.region_input
        lora = specs["mix_A"].shape

        def region_input(t, axis):     # mix_A enters without its sum
            return t if tuple(t.shape) == tuple(lora) else real(t, axis)

        monkeypatch.setattr(rwkv, "region_input", region_input)

    def rank(r, axis):
        part = cls(RWKV)
        if kind == "time":
            part.tp = rwkv_layout(part, specs, pspecs, _RankMesh(m, r), axis)
            out = part.o
        else:
            part.tp, out = axis, part.wv
        out.parallel, out.tp = "row", axis
        tree = shard_params(params, specs, pspecs, mesh, (0, r))
        return (part.tp,) + _run(part, tree, x, axis, fault)

    return whole, threads.run(rank), pspecs


def _leaf_grads_match(whole, outs, pspecs):
    """Every leaf's gradient: a split leaf's shards concatenated on the
    split dim, a whole leaf's on every rank, against the whole module's;
    {leaf: rel}."""
    spec_of = dict(_named(pspecs))
    rels = {}
    for name, g in whole[2].items():
        d = [i for i, e in enumerate(spec_of[name]) if e == "model"]
        parts = [o[3][name] for o in outs]
        if d:
            rels[name] = _rel(torch.cat(parts, dim=d[0]), g)
        else:
            rels[name] = max(_rel(p, g) for p in parts)
    return rels


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("kind", ["time", "channel"])
def test_rwkv_region_matches_the_whole_module(monkeypatch, kind, m):
    """Every rank's output and input gradient equal the whole module's
    (rel 1e-5), and every leaf's gradient the whole leaf's (``LEAF_REL``);
    rank r of the time mix holds heads [r H/m, (r+1) H/m)."""
    whole, outs, pspecs = _region(monkeypatch, kind, m)
    n = RWKV.d_model // HD // m
    for r, (layout, y, gx, _) in enumerate(outs):
        if kind == "time":
            assert layout.heads == (r * n, (r + 1) * n)
            assert layout.channels == (r * n * HD, (r + 1) * n * HD)
        assert _rel(y, whole[0]) <= REL and _rel(gx, whole[1]) <= REL
    rels = _leaf_grads_match(whole, outs, pspecs)
    assert len(rels) == len(whole[2])
    for name, rel in rels.items():
        assert rel <= LEAF_REL, name


def test_missing_lora_backward_sum_is_caught(monkeypatch):
    """With ``mix_A`` read whole but its gradient not summed over the
    ranks, the forward still matches while mix_A's gradient does not."""
    whole, outs, pspecs = _region(monkeypatch, "time", 2, fault="lora")
    assert _rel(outs[0][1], whole[0]) <= REL
    rels = _leaf_grads_match(whole, outs, pspecs)
    assert rels["mix_A"] > 1e-2
    assert rels["mix_B"] <= LEAF_REL


def test_double_sum_on_the_r_path_is_caught(monkeypatch):
    """With x entering the channel mix's region, the r path's gradient
    (whole on every rank) is summed twice over: the forward still matches
    while x's gradient does not."""
    whole, outs, _ = _region(monkeypatch, "channel", 2, fault="r_path")
    for _, y, gx, _ in outs:
        assert _rel(y, whole[0]) <= REL
        assert _rel(gx, whole[1]) > 1e-2


def test_a_split_that_cuts_a_head_is_refused():
    """On ``model = 8`` the smoke config's tables (8 blocks of 8 channels)
    give each rank half a head of 16 channels, which is refused by name;
    a part whose range differs from r's output is named too."""
    mod = rwkv.RWKV6TimeMix(RWKV)
    specs = mod.specs()
    pspecs = sh.param_shardings(_mesh_spec((1, 8)), specs)
    assert pspecs["r"]["w"] == ("model", None, None)
    with pytest.raises(NotImplementedError,
                       match=r"r's output holds channels \(8, 16\) over "
                             r"'model', which cuts a head of 16"):
        rwkv_layout(mod, specs, pspecs, _RankMesh(8, 1), None)
    pspecs = sh.param_shardings(_mesh_spec((1, 2)), specs)
    assert rwkv_layout(mod, specs, pspecs, _RankMesh(2, 1), None) == \
        RWKVLayout(None, (2, 4), (32, 64))
    pspecs["u"] = (None, None)
    with pytest.raises(NotImplementedError, match="u's heads holds channels "
                                                  r"\(0, 64\) \(whole\)"):
        rwkv_layout(mod, specs, pspecs, _RankMesh(2, 1), None)
    whole = sh.param_shardings(_mesh_spec((1, 1)), specs)
    assert rwkv_layout(mod, specs, whole, _RankMesh(1, 0), None) is None
