"""Port: tensor-parallel serve steps on a ``(data, model)`` mesh
(``serve.engine.make_prefill_step(mesh=)`` / ``make_decode_step(mesh=)``,
``dist.tensor_parallel.ServeParallel`` and ``shard_params``, the cache
layout of ``launch.specs.cache_shardings``).

The multi-rank half spawns ``gloo`` ranks on the CPU twice for the module,
a world of 4 and then a world of 2. Each rank builds its meshes with
``init_device_mesh`` and serves smoke models in f32 with frozen tables,
f32 and int8: a prefill of 4 prompts of 12 tokens into a 32-slot cache,
then 4 greedy decode steps (the ranks' greedy tokens all-gathered over
the data axis into the next step's global tokens). The pairings of the
K/V tables' layout with the cache's:

* qwen3 on ``(2, 2)`` and ``(1, 2)``: tables ``local``, cache split by KV
  head;
* qwen3-moe on ``(1, 4)`` at its ``k = 8``: tables ``gather`` (4 blocks,
  half a head per rank), cache whole (2 KV heads on 4 ranks);
* qwen3-moe on ``(1, 2)`` at ``k = 32``: tables ``replicated`` (one
  block), cache split by KV head;
* gemma3 on ``(1, 2)``: tables ``local``, cache split, the sliding-window
  rings (of 8) wrapped by the prompts;
* arctic on ``(2, 2)`` with capacity factor 0.5: the experts over
  ``model``, the capacity drops routed over the global batch.

The ranks' logits and cache shards come back to the test process and are
held to one process serving the whole batch (rel 1e-5, greedy tokens
equal, each cache shard the KV heads and rows ``cache_shardings`` gives
the rank); the ``(2, 2)`` qwen3 run also to the reference's unsharded
steps on the same numpy params (rel 2e-5). Freezing and cutting a tree
commute bit for bit, and the refused mixers raise for serving under
``model = 2``.
"""

import dataclasses
import itertools
import socket

import test_torch_threads  # noqa: F401  (one thread budget per worker)

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro.configs import qwen3_0_6b as jq
from repro.models.decoder import HybridDecoderLM as JLM
from repro.serve import engine as jeng
from repro_torch import convert
from repro_torch.configs import arctic_480b as ta
from repro_torch.configs import gemma3_27b as tg
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs import qwen3_moe_235b as tqm
from repro_torch.configs.registry import get_smoke
from repro_torch.dist import sharding as sh
from repro_torch.dist.tensor_parallel import shard_params
from repro_torch.kernels.block_circulant.plan import freeze_params
from repro_torch.launch.mesh import MeshSpec
from repro_torch.launch.specs import build_model, cache_sds, cache_shardings
from repro_torch.nn.module import init_params, load_tree, tree_leaves
from repro_torch.serve.engine import make_decode_step, make_prefill_step

jax.config.update("jax_platform_name", "cpu")

REL = 1e-5
REF_REL = 2e-5          # fp32 vs fp32 (tests/test_torch_train.py REL_TOL)
B, PROMPT, CACHE_LEN, STEPS = 4, 12, 32, 4
QUANTIZE = ("off", "int8")


def _freq(cfg, **kw):
    return dataclasses.replace(
        cfg, swm=dataclasses.replace(cfg.swm, impl="freq", **kw))


QWEN = _freq(tq.SMOKE)
MOE = _freq(tqm.SMOKE)
MOE32 = _freq(tqm.SMOKE, block_size=32)
GEMMA = _freq(tg.SMOKE)
# 3 layers: the cache rule puts the data axis on the slot axis (it takes
# a layer stack that it divides, as 2 layers would be), so the data ranks
# serve halves of the batch
ARCTIC = dataclasses.replace(_freq(ta.SMOKE), n_layers=3,
                             capacity_factor=0.5)
# name: (config, (data, model), K/V tables' layout, cache split by head)
VARIANTS4 = {"qwen3_2x2": (QWEN, (2, 2), "local", True),
             "moe_kv_gather_1x4": (MOE, (1, 4), "gather", False),
             "arctic_2x2": (ARCTIC, (2, 2), "local", True)}
VARIANTS2 = {"qwen3_1x2": (QWEN, (1, 2), "local", True),
             "moe_kv_replicated_1x2": (MOE32, (1, 2), "replicated", True),
             "gemma3_1x2": (GEMMA, (1, 2), "local", True)}
VARIANTS = {**VARIANTS4, **VARIANTS2}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-12))


def _prompts(cfg):
    rng = np.random.default_rng(3)
    return rng.integers(0, cfg.vocab, (B, PROMPT)).astype(np.int32)


def _cache_np(cache):
    return [{k: v.float().numpy().copy() for k, v in layer.items()}
            for layer in cache]


def _serve(cfg, quantize, mesh=None, group=None):
    """Prefill and STEPS greedy decode steps of the smoke prompts on seed
    0's frozen params: (each step's logits of this rank's rows, every
    step's global greedy tokens, the final cache, the step's ServeParallel
    or None)."""
    model = build_model(cfg, device="cpu")
    specs = model.specs()
    load_tree(model, freeze_params(specs, init_params(specs, 0, device="cpu"),
                                   quantize))
    prefill = make_prefill_step(model, cfg, mesh=mesh)
    decode = make_decode_step(model, cfg, mesh=mesh)
    par = prefill.parallel
    cache = (par.init_cache(B, CACHE_LEN) if par is not None
             else model.init_cache(B, CACHE_LEN))
    logits, cache = prefill(torch.from_numpy(_prompts(cfg)), cache)
    outs, toks = [logits.numpy().copy()], []
    for i in range(STEPS + 1):
        tok = logits.argmax(-1).to(torch.int32)
        if par is not None and tok.shape[0] < B:
            tok = torch.cat(sh.all_gather_list(tok, group))
        toks.append(tok.numpy().copy())
        if i == STEPS:
            break
        pos = torch.full((B,), PROMPT + i, dtype=torch.int32)
        logits, cache = decode(tok[:, None], cache, pos)
        outs.append(logits.numpy().copy())
    return outs, toks, cache, par


# ---------------------------------------------------------------------------
# The spawned ranks
# ---------------------------------------------------------------------------


def _variant(cfg, shape):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.nn.attention import Attention

    mesh = init_device_mesh("cpu", shape, mesh_dim_names=("data", "model"))
    out = {"coord": tuple(int(c) for c in mesh.get_coordinate())}
    for q in QUANTIZE:
        logits, toks, cache, par = _serve(cfg, q, mesh,
                                          mesh.get_group("data"))
        out[q] = {"logits": logits, "tokens": toks,
                  "cache": _cache_np(cache),
                  "counts": dict(par.log.counts),
                  "bytes": dict(par.log.kind_bytes)}
    model = par.model
    out["kv"] = sorted({m.tp.kv for m in model.modules()
                        if isinstance(m, Attention) and m.tp is not None})
    return out


def _rank_main(world, rank, port, q):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    out = {"rank": rank}
    try:
        variants = VARIANTS4 if world == 4 else VARIANTS2
        for name, (cfg, shape, _, _) in variants.items():
            out[name] = _variant(cfg, shape)
    except Exception as e:            # reported by the test, which fails
        import traceback

        out["error"] = f"{type(e).__name__}: {e}\n{traceback.format_exc()}"
    finally:
        q.put(out)
        dist.destroy_process_group()


def _spawn(world):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(world, r, port, q))
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
def ranks():
    """The ranks' reports: the world of 4's, then the world of 2's."""
    return _spawn(4), _spawn(2)


def _outs(ranks, name):
    four, two = ranks
    return four if name in VARIANTS4 else two


def _mesh_spec(shape):
    return MeshSpec(("data", "model"), dict(zip(("data", "model"), shape)))


def _rows(shape, coord):
    n = B // shape[0]
    return slice(coord[0] * n, (coord[0] + 1) * n)


@pytest.fixture(scope="module")
def one_process():
    """Each variant's config served whole in this process, f32 and int8."""
    cfgs = {id(cfg): cfg for cfg, _, _, _ in VARIANTS.values()}
    return {key: {q: _serve(cfg, q) for q in QUANTIZE}
            for key, cfg in cfgs.items()}


@pytest.mark.parametrize("quantize", QUANTIZE)
@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_sharded_serve_matches_one_process(ranks, one_process, variant,
                                           quantize):
    """Each rank's logits (its rows, whole over the vocabulary) within rel
    1e-5 of one process's, the greedy tokens equal at every step, and its
    cache shard equal to one process's cache cut by ``cache_shardings``
    at the rank's coordinate: exactly the KV heads and rows it gives the
    rank."""
    cfg, shape, _, heads_split = VARIANTS[variant]
    logits, toks, cache, _ = one_process[id(cfg)][quantize]
    spec = _mesh_spec(shape)
    specs = cache_shardings(cfg, cache_sds(cfg, B, CACHE_LEN), spec)
    for o in _outs(ranks, variant):
        got = o[variant][quantize]
        coord = o[variant]["coord"]
        rows = _rows(shape, coord)
        if shape[0] > 1:
            assert specs[0]["k"][0] == "data"
        for a, b in zip(got["logits"], logits):
            assert a.shape == b[rows].shape
            assert _rel(a, b[rows]) <= REL
        for a, b in zip(got["tokens"], toks):
            np.testing.assert_array_equal(a, b)
        for layer, want, lspec in zip(got["cache"], _cache_np(cache), specs):
            for key in ("k", "v", "pos"):
                cut = sh.local_shard(torch.from_numpy(want[key]), lspec[key],
                                     spec, coordinate=coord).numpy()
                assert layer[key].shape == cut.shape
                assert _rel(layer[key], cut) <= REL
            held = layer["k"].shape[2]
            assert held == (cfg.n_kv_heads // shape[1] if heads_split
                            else cfg.n_kv_heads)
        # every collective by kind, the same on every rank
        assert got["counts"] == _outs(ranks, variant)[0][variant][
            quantize]["counts"]
        assert got["counts"]["all-reduce"] > 0


def test_kv_layouts_pair_with_the_cache_layouts(ranks):
    """The variants cover the K/V tables' three layouts against a cache
    split by KV head and a whole one."""
    for name, (_, _, kv, _) in VARIANTS.items():
        for o in _outs(ranks, name):
            assert o[name]["kv"] == [kv], name
    assert {(kv, split) for _, _, kv, split in VARIANTS.values()} == {
        ("local", True), ("gather", False), ("replicated", True)}


def test_global_routing_in_serving(ranks):
    """arctic on (2, 2): the data ranks route their halves over the global
    batch (one all-gather of the per-expert counts per MoE call)."""
    counts = _outs(ranks, "arctic_2x2")[0]["arctic_2x2"]["off"]["counts"]
    qwen = _outs(ranks, "qwen3_2x2")[0]["qwen3_2x2"]["off"]["counts"]
    moe = sum("moe" in lspec.ffn for lspec in ARCTIC.layer_specs())
    # each MoE layer once in the prefill and every decode step, above the
    # logits' gathers
    assert moe == 3
    assert counts["all-gather"] == qwen["all-gather"] + moe * (STEPS + 1)
    assert counts["reduce-scatter"] == counts["all-to-all"] == 0


def test_two_by_two_serve_matches_the_reference(ranks):
    """qwen3 on (2, 2) against the reference's make_prefill_step /
    make_decode_step on one device, unsharded and unfrozen, on the same
    numpy params (the port's through ``convert.to_reference``)."""
    tparams = init_params(build_model(QWEN, device="cpu").specs(), 0,
                          device="cpu")
    jcfg = dataclasses.replace(
        jq.SMOKE, swm=dataclasses.replace(jq.SMOKE.swm, impl="freq"))
    jparams = jax.tree.map(jnp.asarray, convert.to_reference(QWEN, tparams))
    jmodel = JLM(jcfg)
    prefill = jax.jit(jeng.make_prefill_step(jmodel, jcfg))
    decode = jax.jit(jeng.make_decode_step(jmodel, jcfg))
    logits, cache = prefill(jparams, jnp.asarray(_prompts(QWEN)),
                            jmodel.init_cache(B, CACHE_LEN))
    want, toks = [np.asarray(logits)], []
    for i in range(STEPS + 1):
        tok = np.asarray(jnp.argmax(logits, -1)).astype(np.int32)
        toks.append(tok)
        if i == STEPS:
            break
        logits, cache = decode(jparams, jnp.asarray(tok[:, None]), cache,
                               jnp.full((B,), PROMPT + i, jnp.int32))
        want.append(np.asarray(logits))
    for o in _outs(ranks, "qwen3_2x2"):
        got = o["qwen3_2x2"]["off"]
        rows = _rows((2, 2), o["qwen3_2x2"]["coord"])
        for a, b in zip(got["logits"], want):
            assert _rel(a, b[rows]) <= REF_REL
        for a, b in zip(got["tokens"], toks):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("quantize", QUANTIZE)
@pytest.mark.parametrize("name", ["qwen3_2x2", "moe_kv_gather_1x4",
                                  "moe_kv_replicated_1x2", "gemma3_1x2"])
def test_freeze_then_cut_equals_cut_then_freeze(name, quantize):
    """Every rank's shard of a frozen tree (f32 or int8) equals the
    frozen tree of its time-domain shard, bit for bit, the fused Q/K/V
    copy rebuilt from the cut members included."""
    cfg, shape, _, _ = VARIANTS[name]
    model = build_model(cfg, device="cpu")
    specs = model.specs()
    params = init_params(specs, 0, device="cpu")
    spec = _mesh_spec(shape)
    pspecs = sh.param_shardings(spec, specs, fsdp=False)
    whole = freeze_params(specs, params, quantize)
    n_cut = 0
    for coord in itertools.product(*(range(n) for n in shape)):
        a = shard_params(whole, specs, pspecs, spec, coord)
        b = freeze_params(specs, shard_params(params, specs, pspecs, spec,
                                              coord), quantize)
        assert _keys(a) == _keys(b)
        for x, y in zip(tree_leaves(a), tree_leaves(b)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        n_cut += sum(x.shape != y.shape for x, y in zip(
            tree_leaves(a), tree_leaves(whole)))
    assert n_cut > 0


def _keys(tree, path=()):
    if isinstance(tree, dict):
        return [k for key in sorted(tree) for k in _keys(tree[key],
                                                         path + (key,))]
    return [path]


@pytest.mark.parametrize("arch", ["paligemma-3b"])
def test_refused_for_serving_under_a_model_axis(arch):
    """Paligemma's vision prefix stays refused for serving under ``model =
    2``, as for training (on a fake world of 2 ranks in this process)."""
    from repro_torch.launch.dryrun import fake_world

    cfg = get_smoke(arch)
    with fake_world(2):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (1, 2),
                                mesh_dim_names=("data", "model"))
        for make in (make_prefill_step, make_decode_step):
            with pytest.raises(NotImplementedError, match="'model' mesh"):
                make(build_model(cfg, device="meta"), cfg, mesh=mesh)
