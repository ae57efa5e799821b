"""Port: the enc-dec family (seamless-m4t-medium) trained and served under
a ``model`` mesh axis: encoder self, decoder self and cross attention,
the GeLU MLP and the tied vocab embedding sharded by
``dist.tensor_parallel``, the encoder output entering each cross
attention's region, and the cross cache split on its KV heads or on its
frames (``launch.specs.cache_shardings``).

The multi-rank half spawns two ``gloo`` worlds on the CPU at once, of 4
and of 2 ranks. Each rank builds its meshes with ``init_device_mesh`` and
trains and serves seamless's smoke config in f32 (``impl="freq"``,
``remat="block"``, 3 decoder layers: on ``(2, 2)`` the cache rule then
puts the data axis on the batch, not on a layer stack it divides), on
batches of 6 rows (not one of the rule's channel sizes). The layouts:

* ``heads``, on ``(1, 2)`` and ``(2, 2)``: q, k, v split by head
  (``local``), the self rings and the cross caches split on their KV
  heads (the frames, 16, are no channel size);
* ``frames``, ``enc_seq=128`` (= ``d_ff``, as full width's 4096) on
  ``(1, 2)``: the cross caches split on their frames, read through the
  combine of the ranks' attention partials;
* ``repl``, ``block_size=32`` and ``enc_seq=128`` on ``(1, 4)``: the q
  tables (2 blocks) whole, so attention runs replicated on every rank,
  the self rings split on heads and the cross caches on frames
  (production's layout); ``repl_short`` serves 40 frames of its 128, so
  that two ranks' cross shards hold only masked slots.

Training: 2 AdamW steps against one process on the whole batch (rel
1e-5: loss, grad norm, params over the tree, moments leaf by leaf), the
``(2, 2)`` run also against the reference's step (rel 2e-5). Serving: a
prefill of 12-token prompts with seeded frames into a 32-slot cache and 4
greedy decode steps, frozen f32 and int8 tables, against one process
(logits rel 1e-5, tokens equal, each cache shard the one process's cache
cut at the rank's coordinate), ``heads`` on ``(2, 2)`` also against the
reference's unsharded steps (rel 2e-5). The cache layouts are the
reference's ``cache_shardings`` for the same config and mesh.
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

from repro.configs import seamless_m4t_medium as jmod
from repro.configs.base import TrainConfig as JTrain
from repro.dist import sharding as jsh
from repro.launch import specs as jspecs
from repro.models.encdec import EncDecLM as JEncDec
from repro.serve import engine as jeng
from repro.train.loop import init_train_state as jinit_state
from repro.train.loop import make_train_step as jmake_step
from repro_torch import convert
from repro_torch.configs import seamless_m4t_medium as tmod
from repro_torch.configs.base import TrainConfig
from repro_torch.dist import sharding as sh
from repro_torch.dist.tensor_parallel import shard_params
from repro_torch.kernels.block_circulant.plan import freeze_params
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.specs import build_model, cache_sds, cache_shardings
from repro_torch.nn.module import init_params, load_tree, tree_leaves
from repro_torch.serve.engine import make_decode_step, make_prefill_step
from repro_torch.train.loop import init_train_state, make_train_step

jax.config.update("jax_platform_name", "cpu")

REL = 1e-5
REF_REL = 2e-5          # fp32 vs fp32 (tests/test_torch_train.py REL_TOL)
B, SEQ, STEPS = 6, 16, 2
PROMPT, CACHE_LEN, DECODE = 12, 32, 4
QUANTIZE = ("off", "int8")
TCFG = TrainConfig(warmup_steps=1, total_steps=10)
OVER = dict(remat="block", n_layers=3)


def _cfg(cfg=tmod.SMOKE, enc_seq=None, block_size=8):
    return dataclasses.replace(
        cfg, swm=dataclasses.replace(cfg.swm, impl="freq",
                                     block_size=block_size),
        enc_seq=enc_seq or cfg.enc_seq, **OVER)


HEADS = _cfg()
FRAMES = _cfg(enc_seq=128)
REPL = _cfg(enc_seq=128, block_size=32)
CFGS = {"heads": HEADS, "frames": FRAMES, "repl": REPL}
# name: (config, (data, model))
TRAIN4 = {"heads_2x2": ("heads", (2, 2)), "repl_1x4": ("repl", (1, 4))}
TRAIN2 = {"heads_1x2": ("heads", (1, 2))}
TRAIN = {**TRAIN4, **TRAIN2}
# name: (config, (data, model), frames served, cross cache split on)
SERVE4 = {"heads_2x2": ("heads", (2, 2), 16, "heads"),
          "repl_1x4": ("repl", (1, 4), 128, "frames"),
          "repl_short_1x4": ("repl", (1, 4), 40, "frames")}
SERVE2 = {"heads_1x2": ("heads", (1, 2), 16, "heads"),
          "frames_1x2": ("frames", (1, 2), 128, "frames")}
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
    """STEPS seeded batches: tokens (B, SEQ + 1), frames (B, SEQ, d)."""
    out = []
    for i in range(STEPS):
        rng = np.random.default_rng(10 + i)
        out.append({
            "tokens": torch.from_numpy(rng.integers(
                0, cfg.vocab, (B, SEQ + 1)).astype(np.int32)),
            "frames": torch.from_numpy(rng.standard_normal(
                (B, SEQ, cfg.d_model)).astype(np.float32))})
    return out


def _serve_inputs(cfg, n_frames):
    rng = np.random.default_rng(3)
    return (rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32),
            rng.standard_normal((B, n_frames, cfg.d_model)).astype(
                np.float32))


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


def _cache_np(cache):
    return {k: [{n: t.float().numpy().copy() for n, t in layer.items()}
                for layer in cache[k]] for k in ("self", "cross")}


def _serve(cfg, quantize, n_frames, mesh=None, group=None):
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
    prompts, frames = _serve_inputs(cfg, n_frames)
    logits, cache = prefill(torch.from_numpy(prompts), cache,
                            torch.from_numpy(frames))
    outs, toks = [logits.numpy().copy()], []
    for i in range(DECODE + 1):
        tok = logits.argmax(-1).to(torch.int32)
        if par is not None and tok.shape[0] < B:
            tok = torch.cat(sh.all_gather_list(tok, group))
        toks.append(tok.numpy().copy())
        if i == DECODE:
            break
        pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
        logits, cache = decode(tok[:, None], cache, pos)
        outs.append(logits.numpy().copy())
    return outs, toks, cache, par


# ---------------------------------------------------------------------------
# The spawned ranks
# ---------------------------------------------------------------------------


def _mesh(shape):
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))


def _rank_train(cfg, shape):
    from repro_torch.nn.attention import Attention

    mesh = _mesh(shape)
    state, step, m, model = _train(cfg, mesh)
    dp = step.data_parallel
    return {"coord": tuple(int(c) for c in mesh.get_coordinate()),
            "params": _np(state["params"]), "opt": _np(state["opt"]),
            "shardings": dp.state_shardings,
            "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
            "collectives": dp.collectives,
            "kv": sorted({"whole" if a.tp is None else a.tp.kv
                          for a in model.modules()
                          if isinstance(a, Attention)}),
            "vocab_split": model.vocab_shard is not None}


def _rank_serve(cfg, shape, n_frames):
    mesh = _mesh(shape)
    out = {"coord": tuple(int(c) for c in mesh.get_coordinate())}
    for q in QUANTIZE:
        logits, toks, cache, par = _serve(cfg, q, n_frames, mesh,
                                          mesh.get_group("data"))
        out[q] = {"logits": logits, "tokens": toks,
                  "cache": _cache_np(cache),
                  "counts": dict(par.log.counts)}
    return out


def _rank_main(world, rank, port, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    out = {"rank": rank}
    try:
        four = world == 4
        for name, (key, shape) in (TRAIN4 if four else TRAIN2).items():
            out[("train", name)] = _rank_train(CFGS[key], shape)
        for name, (key, shape, n, _) in (SERVE4 if four else SERVE2).items():
            out[("serve", name)] = _rank_serve(CFGS[key], shape, n)
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
    """Each config trained and served whole in this process."""
    out = {}
    for key, cfg in CFGS.items():
        if any(k == key for k, _ in TRAIN.values()):
            state, _, m, _ = _train(cfg)
            out[("train", key)] = ({"params": _np(state["params"]),
                                    "opt": _np(state["opt"])}, m)
    for key, _, n, _ in SERVE.values():
        if ("serve", key, n) not in out:
            out[("serve", key, n)] = {q: _serve(CFGS[key], q, n)
                                      for q in QUANTIZE}
    return out


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(TRAIN))
def test_sharded_train_step_matches_one_process(ranks, one_process,
                                                variant):
    """Loss and grad norm within rel 1e-5 of one process's on the whole
    batch after 2 steps, params over the tree and moments leaf by leaf,
    every rank's shard the one process's state cut at its coordinate."""
    key, shape = TRAIN[variant]
    full, m = one_process[("train", key)]
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
        # the vocab (256 rows) splits over 2 and 4 ranks
        assert got["vocab_split"]
        assert got["kv"] == (["whole"] if key == "repl" else ["local"])
    assert n_split > 0


def _jcfgs(cfg):
    """The reference's smoke config with ``cfg``'s overrides."""
    return dataclasses.replace(
        jmod.SMOKE, swm=dataclasses.replace(
            jmod.SMOKE.swm, impl="freq", block_size=cfg.swm.block_size),
        enc_seq=cfg.enc_seq, **OVER)


def test_two_by_two_train_step_matches_the_reference(ranks):
    """heads on (2, 2) against the reference's one-device AdamW step on
    the same numpy tree and batches (rel 2e-5)."""
    tparams = init_params(build_model(HEADS, device="cpu").specs(), 0,
                          device="cpu")
    jcfg = _jcfgs(HEADS)
    jt = JTrain(warmup_steps=TCFG.warmup_steps,
                total_steps=TCFG.total_steps)
    jstate = jinit_state(jax.tree.map(jnp.asarray, convert.to_reference(
        HEADS, tparams)), jt)
    jstep = jax.jit(jmake_step(JEncDec(jcfg), jcfg, jt))
    for b in _batches(HEADS):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v.numpy())
                                    for k, v in b.items()})
    want = _np(convert.from_reference(
        HEADS, jax.tree.map(np.asarray, jstate["params"]), device="cpu"))
    for got in _outs(ranks, "train", "heads_2x2"):
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
    its coordinate: the KV heads, or the frames, it gives the rank. With
    40 frames of 128 (``repl_short``) the shards past frame 40 hold only
    masked slots, which the one process's cache (40 frames) does not
    have."""
    key, shape, n_frames, split = SERVE[variant]
    cfg = CFGS[key]
    logits, toks, cache, _ = one_process[("serve", key, n_frames)][quantize]
    spec = _mesh_spec(shape)
    specs = cache_shardings(cfg, cache_sds(cfg, B, CACHE_LEN), spec)
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
        cross = got["cache"]["cross"][0]
        if split == "frames":
            n = cfg.enc_seq // shape[1]
            assert cross["k"].shape[1:3] == (n, cfg.n_kv_heads)
            f0 = coord[1] * n
            valid = max(0, min(n, n_frames - f0))
            np.testing.assert_array_equal(
                cross["pos"][:, :valid],
                np.broadcast_to(np.arange(f0, f0 + valid), (B // shape[0],
                                                            valid)))
            assert (cross["pos"][:, valid:] == -1).all()
            assert not cross["k"][:, valid:].any()
        else:
            assert cross["k"].shape[2] == cfg.n_kv_heads // shape[1]
        if n_frames != cfg.enc_seq:
            continue
        for part in ("self", "cross"):
            for layer, want, lspec in zip(got["cache"][part],
                                          want_cache[part], specs[part]):
                for name in ("k", "v", "pos"):
                    cut = sh.local_shard(torch.from_numpy(want[name]),
                                         lspec[name], spec,
                                         coordinate=coord).numpy()
                    assert layer[name].shape == cut.shape, (part, name)
                    assert _rel(layer[name], cut) <= REL, (part, name)
        # the self rings always split on their KV heads
        assert got["cache"]["self"][0]["k"].shape[2] == \
            cfg.n_kv_heads // shape[1]


def test_frame_split_combines_over_the_model_axis(ranks):
    """A step over a frame-split cross cache all-reduces the attention
    partials (a max and a sum per decoder layer) on top of what a
    head-split one issues: 3 layers x (1 prefill + 4 decode steps)."""
    heads = _outs(ranks, "serve", "heads_1x2")[0]["off"]["counts"]
    frames = _outs(ranks, "serve", "frames_1x2")[0]["off"]["counts"]
    steps = 1 + DECODE
    assert frames["all-reduce"] == heads["all-reduce"] + 2 * 3 * steps
    assert frames["reduce-scatter"] == frames["all-to-all"] == 0


def test_two_by_two_serve_matches_the_reference(ranks):
    """heads on (2, 2) (3 decoder layers) against the reference's
    make_prefill_step / make_decode_step on one device, unsharded and
    unfrozen, on the same numpy params."""
    tparams = init_params(build_model(HEADS, device="cpu").specs(), 0,
                          device="cpu")
    jcfg = _jcfgs(HEADS)
    jparams = jax.tree.map(jnp.asarray, convert.to_reference(HEADS, tparams))
    jmodel = JEncDec(jcfg)
    prefill = jax.jit(jeng.make_prefill_step(jmodel, jcfg))
    decode = jax.jit(jeng.make_decode_step(jmodel, jcfg))
    prompts, frames = _serve_inputs(HEADS, HEADS.enc_seq)
    logits, cache = prefill(jparams, jnp.asarray(prompts),
                            jmodel.init_cache(B, CACHE_LEN),
                            jnp.asarray(frames))
    want, toks = [np.asarray(logits)], []
    for i in range(DECODE + 1):
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        toks.append(tok)
        if i == DECODE:
            break
        logits, cache = decode(jparams, jnp.asarray(tok[:, None]), cache,
                               jnp.full((B,), PROMPT + i, jnp.int32))
        want.append(np.asarray(logits))
    for o in _outs(ranks, "serve", "heads_2x2"):
        got = o["off"]
        rows = _rows((2, 2), o["coord"])
        for a, b in zip(got["logits"], want):
            assert _rel(a, b[rows]) <= REF_REL
        for a, b in zip(got["tokens"], toks):
            np.testing.assert_array_equal(a, b)


class _FakeMesh:
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.mark.parametrize("variant", sorted(SERVE))
def test_cache_layouts_are_the_reference_rules(monkeypatch, variant):
    """The port's cache specs for each served config and mesh are the
    reference's ``cache_shardings`` on its stacked leaves (the layer stack
    dropped), and split where the variant says: the self rings on their
    KV heads, the cross caches on their heads or their frames."""
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, p: tuple(p))
    monkeypatch.setattr(jspecs, "NamedSharding", lambda mesh, p: tuple(p))
    key, shape, _, split = SERVE[variant]
    cfg = CFGS[key]
    jcfg = _jcfgs(cfg)
    axes = dict(zip(("data", "model"), shape))
    jsds = jspecs.cache_sds(jcfg, B, CACHE_LEN)
    ref = jspecs.cache_shardings(jcfg, jsds, _FakeMesh(axes))
    got = cache_shardings(cfg, cache_sds(cfg, B, CACHE_LEN), _mesh_spec(shape))
    data = "data" if shape[0] > 1 else None
    for part in ("self", "cross"):
        for layer in got[part]:
            for name, spec in layer.items():
                assert spec == tuple(ref[part][name])[1:], (part, name)
        k = got[part][0]["k"]
        if part == "cross" and split == "frames":
            assert k == (data, "model", None, None)
            assert got[part][0]["pos"] == (data, "model")
        else:
            assert k == (data, None, "model", None)


@pytest.mark.parametrize("quantize", QUANTIZE)
@pytest.mark.parametrize("key", ["heads", "repl"])
def test_freeze_then_cut_equals_cut_then_freeze(key, quantize):
    """Every rank's shard of seamless's frozen tree (f32 or int8) equals
    the frozen tree of its time-domain shard bit for bit, the fused Q/K/V
    copies (cross attention's, which goes unread, too) rebuilt from the
    cut members."""
    cfg = CFGS[key]
    shape = (2, 2) if key == "heads" else (1, 4)
    model = build_model(cfg, device="cpu")
    specs = model.specs()
    params = init_params(specs, 0, device="cpu")
    spec = _mesh_spec(shape)
    pspecs = sh.param_shardings(spec, specs, fsdp=False)
    whole = freeze_params(specs, params, quantize)
    n_cut = 0
    for coord in np.ndindex(*shape):
        a = shard_params(whole, specs, pspecs, spec, coord)
        b = freeze_params(specs, shard_params(params, specs, pspecs, spec,
                                              coord), quantize)
        la, lb = tree_leaves(a), tree_leaves(b)
        assert len(la) == len(lb)
        for x, y in zip(la, lb):
            assert x.dtype == y.dtype and torch.equal(x, y)
        n_cut += sum(x.shape != y.shape for x, y in zip(
            la, tree_leaves(whole)))
    assert n_cut > 0


def test_fsdp_of_the_encdec_family_is_refused_under_a_model_axis():
    """``fsdp=True`` names what the enc-dec stacks do not run."""
    from repro_torch.launch.dryrun import fake_world

    cfg = dataclasses.replace(HEADS, fsdp=True)
    with fake_world(2):
        mesh = _mesh((1, 2))
        with pytest.raises(NotImplementedError, match="FSDP of the enc-dec"):
            make_train_step(build_model(cfg, device="meta"), cfg, TCFG,
                            mesh=mesh)
