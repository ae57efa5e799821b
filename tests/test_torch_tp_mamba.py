"""Port: the Mamba mixer (jamba-v0.1-52b) trained and served under a
``model`` mesh axis: each rank holds one range of the ``d_inner``
channels (``dist.tensor_parallel.mamba_layout``), ``in_proj``'s output is
all-gathered and cut to the rank's channels of both halves, ``x_proj``
is summed forward and backward, ``out_proj`` sums into the residual, and
the Mamba caches split on their channel dims
(``launch.specs.cache_shardings``).

The multi-rank half spawns two ``gloo`` worlds on the CPU at once, of 4
and of 2 ranks. Each rank builds its meshes with ``init_device_mesh`` and
runs jamba's smoke config (8 layers: one full Mamba / attention / MoE
period, ``d_inner`` 128, k = 8) in f32 with ``impl="freq"``:

* training, ``remat="block"``: two AdamW steps on ``(1, 2)``, on
  ``(2, 2)`` with ``fsdp=True`` (``embed`` over the data axis) and on
  ``(1, 4)``, against one process on the whole batch (rel 1e-5: loss,
  grad norm, params over the tree, moments leaf by leaf); the ``(2, 2)``
  step also against the reference's (rel 2e-5);
* serving, frozen f32 and int8 tables: a prefill of left-padded prompts
  (so that the recurrent mixers' mask path runs) and greedy decode steps
  on ``(1, 2)`` and ``(2, 2)``, against one process (logits rel 1e-5,
  tokens equal, each cache shard the one process's cut at the rank's
  coordinate).

In this process: the cache specs against the reference's rule, and one
Mamba region on threaded ranks against its unsharded function, forward
and every leaf's gradient, with a planted fault (no backward sum on
``x_proj``'s output) that the gradients must show.
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
from repro.configs import jamba_52b as jmod
from repro.configs.base import TrainConfig as JTrain
from repro.models.decoder import HybridDecoderLM as JLM
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import jamba_52b as tmod
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import sharding as sh
from repro_torch.dist.tensor_parallel import (MambaLayout, ServeParallel,
                                              mamba_layout, shard_params)
from repro_torch.kernels.block_circulant.plan import freeze_params
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.specs import build_model, cache_sds, cache_shardings
from repro_torch.nn import ssm
from repro_torch.nn.module import (init_params, load_tree, module_tree,
                                   tree_leaves)
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.loop import init_train_state, make_train_step

jax.config.update("jax_platform_name", "cpu")

REL = 1e-5
REF_REL = 2e-5          # fp32 vs fp32 (tests/test_torch_train.py REL_TOL)
B, SEQ, STEPS = 4, 16, 2
PROMPT, CACHE_LEN, DECODE = 12, 32, 4
PADS = (0, 3, 5, 1)     # left pads of the served prompts
QUANTIZE = ("off", "int8")
TCFG = TrainConfig(warmup_steps=1, total_steps=10)


def _cfg(fsdp=False):
    cfg = tmod.SMOKE
    return dataclasses.replace(
        cfg, swm=dataclasses.replace(cfg.swm, impl="freq"), remat="block",
        fsdp=fsdp)


JAMBA = _cfg()
FSDP = _cfg(fsdp=True)
TRAIN4 = {"2x2_fsdp": (FSDP, (2, 2)), "1x4": (JAMBA, (1, 4))}
TRAIN2 = {"1x2": (JAMBA, (1, 2))}
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


def _train(cfg, mesh=None):
    """STEPS steps from seed 0's whole params: (state, step, metrics,
    model)."""
    model = build_model(cfg, device="cpu")
    step = make_train_step(model, cfg, TCFG, mesh=mesh)
    shard = (step.data_parallel.state_shardings if mesh is not None
             else {"params": None, "opt": None})
    state = init_train_state(init_params(model.specs(), 0, device="cpu"),
                             TCFG, opt_shardings=shard["opt"],
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
    return sorted({None if m.tp is None else m.tp.channels
                   for m in model.modules() if isinstance(m, ssm.Mamba)},
                  key=str)


def _rank_train(cfg, shape):
    mesh = _mesh(shape)
    state, step, m, model = _train(cfg, mesh)
    dp = step.data_parallel
    return {"coord": tuple(int(c) for c in mesh.get_coordinate()),
            "params": _np(state["params"]), "opt": _np(state["opt"]),
            "shardings": dp.state_shardings,
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "collectives": dp.collectives,
            "channels": _layouts(model),
            "fsdp": model.fsdp is not None}


def _rank_serve(shape):
    mesh = _mesh(shape)
    out = {"coord": tuple(int(c) for c in mesh.get_coordinate())}
    for q in QUANTIZE:
        logits, toks, cache, par = _serve(JAMBA, q, mesh,
                                          mesh.get_group("data"))
        out[q] = {"logits": logits, "tokens": toks,
                  "cache": _cache_np(cache),
                  "counts": dict(par.log.counts),
                  "channels": _layouts(par.model)}
    return out


def _rank_main(world, rank, port, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    out = {"rank": rank}
    try:
        four = world == 4
        for name, (cfg, shape) in (TRAIN4 if four else TRAIN2).items():
            out[("train", name)] = _rank_train(cfg, shape)
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
    """jamba trained and served whole in this process."""
    state, _, m, _ = _train(JAMBA)
    return {"train": ({"params": _np(state["params"]),
                       "opt": _np(state["opt"])}, m),
            "serve": {q: _serve(JAMBA, q) for q in QUANTIZE}}


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


def _channels(shape, coord):
    di = JAMBA.mamba_expand * JAMBA.d_model
    n = di // shape[1]
    return [(coord[1] * n, (coord[1] + 1) * n)]


@pytest.mark.parametrize("variant", sorted(TRAIN))
def test_sharded_train_step_matches_one_process(ranks, one_process,
                                                variant):
    """Loss and grad norm within rel 1e-5 of one process's on the whole
    batch after 2 steps, params over the tree and moments leaf by leaf,
    every rank's shard the one process's state cut at its coordinate;
    every Mamba layer holds the rank's d_inner / model channels."""
    cfg, shape = TRAIN[variant]
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
        for a, b in zip(got["opt"], want["opt"]):
            assert _rel(a, b) <= REL
        assert got["collectives"] == outs[0]["collectives"] > 0
        assert got["channels"] == _channels(shape, got["coord"])
        assert got["fsdp"] == cfg.fsdp
    assert n_split > 0


@pytest.mark.parametrize("variant", sorted(TRAIN))
def test_mamba_leaves_are_split_on_their_channels(variant):
    """Every Mamba leaf is split over ``model`` on its ``mlp`` dim; under
    ``fsdp=True`` in_proj and out_proj are also split over the data axis
    on ``embed``, which the layer's FSDP unit gathers."""
    cfg, shape = TRAIN[variant]
    specs = build_model(cfg, device="meta").specs()
    pspecs = sh.param_shardings(_mesh_spec(shape), specs, fsdp=cfg.fsdp)
    for i, lspec in enumerate(cfg.layer_specs()):
        if lspec.mixer != "mamba":
            continue
        mamba = pspecs["layers"][str(i)]["mixer"]
        assert mamba["conv_w"] == (None, "model")
        assert mamba["A_log"] == ("model", None)
        for name in ("conv_b", "dt_bias", "D"):
            assert mamba[name] == ("model",)
        assert mamba["dt_proj"]["w"] == (None, "model")
        assert mamba["x_proj"]["w"] == ("model", None)
        data = "data" if cfg.fsdp else None
        assert mamba["in_proj"]["w"] == ("model", data, None)
        assert mamba["out_proj"]["w"] == (data, "model", None)


def test_two_by_two_train_step_matches_the_reference(ranks):
    """(2, 2) with fsdp=True against the reference's one-device AdamW step
    on the same numpy tree and batches (rel 2e-5)."""
    tparams = init_params(build_model(JAMBA, device="cpu").specs(), 0,
                          device="cpu")
    jcfg = dataclasses.replace(
        jmod.SMOKE, swm=dataclasses.replace(jmod.SMOKE.swm, impl="freq"),
        remat="block")
    jt = JTrain(warmup_steps=TCFG.warmup_steps,
                total_steps=TCFG.total_steps)
    jstate = jinit_state(jax.tree.map(jnp.asarray, convert.to_reference(
        JAMBA, tparams)), jt)
    jstep = jax.jit(jmake_step(JLM(jcfg), jcfg, jt))
    for b in _batches(JAMBA):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v.numpy())
                                    for k, v in b.items()})
    want = _np(convert.from_reference(
        JAMBA, jax.tree.map(np.asarray, jstate["params"]), device="cpu"))
    for got in _outs(ranks, "train", "2x2_fsdp"):
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
    its coordinate: each Mamba state 1/model of one process's, on its
    channels."""
    shape = SERVE[variant]
    logits, toks, cache, _ = one_process["serve"][quantize]
    spec = _mesh_spec(shape)
    specs = cache_shardings(JAMBA, cache_sds(JAMBA, B, CACHE_LEN), spec)
    want_cache = _cache_np(cache)
    outs = _outs(ranks, "serve", variant)
    n_mamba = 0
    for o in outs:
        got, coord = o[quantize], o["coord"]
        rows = _rows(shape, coord)
        for a, b in zip(got["logits"], logits):
            assert a.shape == b[rows].shape
            assert _rel(a, b[rows]) <= REL
        for a, b in zip(got["tokens"], toks):
            np.testing.assert_array_equal(a, b)
        assert got["counts"] == outs[0][quantize]["counts"]
        assert got["channels"] == _channels(shape, coord)
        for layer, want, lspec in zip(got["cache"], want_cache, specs):
            for name in layer:
                cut = sh.local_shard(torch.from_numpy(want[name]),
                                     lspec[name], spec,
                                     coordinate=coord).numpy()
                assert layer[name].shape == cut.shape, name
                assert _rel(layer[name], cut) <= REL, name
            if "ssm" in layer:
                n_mamba += 1
                assert layer["ssm"].shape[1] * shape[1] == want["ssm"].shape[1]
                assert layer["conv"].shape[2] * shape[1] == \
                    want["conv"].shape[2]
    assert n_mamba == len(outs) * sum(
        s.mixer == "mamba" for s in JAMBA.layer_specs())


def test_padded_prompts_take_the_mask_path():
    """The served prompts carry left pads, so every Mamba layer runs its
    validity mask: the first layer's Mamba state of the most padded row
    equals that of its prompt prefilled alone, unpadded (rel 1e-5; the
    later layers read MoE outputs, whose capacity depends on the batch)."""
    toks, pos = _prompts(JAMBA)
    r = int(np.argmax(PADS))
    model = build_model(JAMBA, device="cpu")
    specs = model.specs()
    load_tree(model, freeze_params(specs, init_params(specs, 0, device="cpu"),
                                   "off"))
    prefill = make_prefill_step(model, JAMBA)
    _, padded = prefill(torch.from_numpy(toks), model.init_cache(B, CACHE_LEN),
                        positions=torch.from_numpy(pos))
    _, alone = prefill(torch.from_numpy(toks[r:r + 1, PADS[r]:]),
                       model.init_cache(1, CACHE_LEN))
    assert JAMBA.layer_specs()[0].mixer == "mamba" and PADS[r] > 0
    for name in ("conv", "ssm"):
        assert _rel(padded[0][name][r], alone[0][name][0]) <= REL, name


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_cache_layouts_are_the_reference_rules(monkeypatch, shape):
    """The port's cache specs for jamba are the reference's
    ``cache_shardings`` on its stacked leaves (the layer stack dropped),
    the Mamba states split over ``model`` on their channel dims; a
    ``ServeParallel`` on a fake world of that shape accepts them."""
    from repro_torch.launch.dryrun import fake_world

    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, p: tuple(p))
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, p: tuple(p))
    jcfg = dataclasses.replace(
        jmod.SMOKE, swm=dataclasses.replace(jmod.SMOKE.swm, impl="freq"))
    axes = dict(zip(("data", "model"), shape))
    jsds = jspecs.cache_sds(jcfg, B, CACHE_LEN)
    ref = jspecs.cache_shardings(jcfg, jsds, _FakeMesh(axes))
    got = cache_shardings(JAMBA, cache_sds(JAMBA, B, CACHE_LEN),
                          _mesh_spec(shape))
    n_mamba = 0
    for layer, (gi, lk, _) in zip(got, convert._layer_slots(JAMBA)):
        for name, spec in layer.items():
            want = tuple(ref[gi][lk][name])
            assert spec == want[len(want) - len(spec):], (gi, lk, name)
        if "ssm" in layer:
            n_mamba += 1
            assert layer["conv"] == ("data", None, "model")
            assert layer["ssm"] == ("data", "model", None)
    assert n_mamba == 7
    with fake_world(shape[0] * shape[1]):
        par = ServeParallel(_mesh(shape), build_model(JAMBA, device="meta"),
                            JAMBA)
        assert par.cache_shardings(B, CACHE_LEN) == got


# ---------------------------------------------------------------------------
# One Mamba region, the ranks as threads
# ---------------------------------------------------------------------------


class _RankMesh:
    """Rank ``r`` of a ``(1, m)`` mesh, for the layout's slices."""

    def __init__(self, m, r):
        self.axis_names, self.shape = ("data", "model"), {"data": 1,
                                                          "model": m}
        self.r = r

    def get_coordinate(self):
        return (0, self.r)


def _region(monkeypatch, m, x_proj_backward_sum=True):
    """One Mamba of jamba's smoke config (f32, k = 8) over a (1, m) split
    with the ranks as threads, against the whole mixer: (the whole
    forward and grads, each rank's)."""
    from test_torch_tensor_parallel import _Threads

    mod = ssm.Mamba(JAMBA)
    specs = mod.specs()
    params = init_params(specs, 0, device="cpu")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 9, JAMBA.d_model)).astype(
        np.float32))
    mask = torch.from_numpy(np.arange(9)[None, :] >= np.array([[0], [2]]))
    w_out = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))

    def run(module, tree):
        tree = _leafy(tree)
        load_tree(module, tree)
        xr = x.clone().requires_grad_(True)
        y, _ = module(xr, mask=mask)
        names = [n for n, _ in _named(tree)]
        ts = [t for _, t in _named(tree)]
        grads = torch.autograd.grad((y * w_out).sum(), [xr] + ts)
        return y.detach(), grads[0], dict(zip(names, grads[1:]))

    whole = run(mod, params)
    mesh = _mesh_spec((1, m))
    pspecs = sh.param_shardings(mesh, specs)
    threads = _Threads(m, monkeypatch)
    if not x_proj_backward_sum:
        real = ssm.region_input

        def region_input(t, axis):     # x enters; x_proj's sum does not
            return real(t, axis) if t.shape[-1] == JAMBA.d_model else t

        monkeypatch.setattr(ssm, "region_input", region_input)

    def rank(r, axis):
        part = ssm.Mamba(JAMBA)
        part.tp = mamba_layout(part, specs, pspecs, _RankMesh(m, r), axis)
        for lin in ("x_proj", "out_proj"):
            part._modules[lin].parallel = "row"
            part._modules[lin].tp = axis
        tree = shard_params(params, specs, pspecs, mesh, (0, r))
        return (part.tp,) + run(part, tree)

    return whole, threads.run(rank), pspecs


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


def _gathered(outs, name, spec):
    d = [i for i, e in enumerate(spec) if e == "model"]
    parts = [o[3][name] for o in outs]
    return torch.cat(parts, dim=d[0]) if d else parts[0]


@pytest.mark.parametrize("m", [2, 4])
def test_mamba_region_matches_the_whole_mixer(monkeypatch, m):
    """Every rank's output and input gradient equal the whole mixer's, and
    every leaf's gradient, its shards concatenated on the split dim, the
    whole leaf's (rel 1e-5); rank r holds channels [r di/m, (r+1) di/m)."""
    whole, outs, pspecs = _region(monkeypatch, m)
    di = JAMBA.mamba_expand * JAMBA.d_model
    for r, (layout, y, gx, _) in enumerate(outs):
        assert layout.channels == (r * di // m, (r + 1) * di // m)
        assert _rel(y, whole[0]) <= REL and _rel(gx, whole[1]) <= REL
    spec_of = dict(_named(pspecs))
    for name, g in whole[2].items():
        assert _rel(_gathered(outs, name, spec_of[name]), g) <= REL, name


def test_missing_x_proj_backward_sum_is_caught(monkeypatch):
    """With x_proj's output summed forward only, the forward still matches
    while the gradients of in_proj, conv and x_proj do not."""
    whole, outs, pspecs = _region(monkeypatch, 2, x_proj_backward_sum=False)
    assert _rel(outs[0][1], whole[0]) <= REL
    spec_of = dict(_named(pspecs))
    for name in ("in_proj.w", "conv_w", "x_proj.w"):
        assert _rel(_gathered(outs, name, spec_of[name]),
                    whole[2][name]) > 1e-3, name


def test_a_mismatched_channel_split_is_refused():
    """A part whose channel range differs from dt_proj's output is named."""
    mod = ssm.Mamba(JAMBA)
    specs = mod.specs()
    mesh = _mesh_spec((1, 2))
    pspecs = sh.param_shardings(mesh, specs)
    assert mamba_layout(mod, specs, pspecs, _RankMesh(2, 1), None) == \
        MambaLayout(None, (64, 128))
    pspecs["D"] = (None,)
    with pytest.raises(NotImplementedError, match="D holds channels"):
        mamba_layout(mod, specs, pspecs, _RankMesh(2, 1), None)
    whole = sh.param_shardings(_mesh_spec((1, 1)), specs)
    assert mamba_layout(mod, specs, whole, _RankMesh(1, 0), None) is None
