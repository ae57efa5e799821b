"""Port parity: the host prefix store (``repro_torch.serve.prefix_store``)
and the engine's spill on eviction and ``adopt_prefixes``, against the JAX
package's.

Mirrors ``tests/test_supervisor.py``'s ``TestPrefixStore`` and
``TestPrefixSpillAdopt``: both stores fed the same seeded operations under
a tight byte budget keep the same LRU order, bytes and counters (bf16
rows cost 2 bytes per element in both); a store either package saved
loads in the other; a cold engine warm-starts from the store with the
original engine's tokens (run on both engines, qwen3 smoke with the same
JAX-initialised params); rows scrubbed by the NaN guard never reach the
store.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jq
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro.serve import engine as jeng
from repro.serve import prefix_store as jps
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.launch.specs import build_model
from repro_torch.serve import engine as teng
from repro_torch.serve import prefix_store as tps
from repro_torch.serve.guard import flatten_state_tree
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

BATCH, CACHE = 2, 32
BUCKETS = (8, 16)
SIDES = ((jeng, jps), (teng, tps))


# ---------------------------------------------------------------------------
# The store alone
# ---------------------------------------------------------------------------


def _rows(pkg, rng, n32, n16):
    """One entry's rows: an f32 leaf and a bf16 leaf (values exact in
    bf16), as numpy (the reference, bf16 via ml_dtypes) or tensors."""
    a = rng.standard_normal(n32).astype(np.float32)
    b = np.asarray(jnp.asarray(rng.standard_normal(n16), jnp.bfloat16))
    if pkg is jps:
        return {"s00000": a, "s00001": b}
    return {"s00000": torch.from_numpy(a),
            "s00001": torch.from_numpy(b.astype(np.float32)).bfloat16()}


def _ops(seed, n=48):
    """Seeded puts (some prompts repeated, some oversize) and touches."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, size=int(rng.integers(1, 6)))
               .astype(np.int32) for _ in range(7)]
    ops = []
    for _ in range(n):
        p = prompts[int(rng.integers(len(prompts)))]
        kind = ("touch", "put", "put", "big")[int(rng.integers(4))]
        ops.append((kind, p, int(rng.integers(1 << 30))))
    return ops


def _apply(pkg, ops, store):
    log = []
    for kind, p, seed in ops:
        rng = np.random.default_rng(seed)
        if kind == "touch":
            r = store.touch(p)
        else:
            n32, n16 = ((200, 300) if kind == "big"
                        else (int(rng.integers(4, 20)),
                              int(rng.integers(4, 20))))
            r = store.put(p, _rows(pkg, rng, n32, n16), "fp")
        log.append((r, [tuple(q.tolist()) for q, _ in store.hottest()],
                    store.nbytes, store.spills, store.evictions, len(store)))
    return log


def _row_values(store):
    return [(tuple(p.tolist()),
             {k: (str(getattr(v, "dtype", "")).replace("torch.", ""),
                  np.asarray(torch.as_tensor(v).float()
                             if isinstance(v, torch.Tensor)
                             else np.asarray(v, np.float32)).tolist())
              for k, v in rows.items()})
            for p, rows in store.hottest()]


@pytest.mark.parametrize("seed", [0, 1])
def test_store_operations_match_reference(seed):
    """The same puts and touches under a tight budget: equal return
    values, LRU order, bytes (bf16 at 2 bytes an element), spills and
    evictions after every operation."""
    ops = _ops(seed)
    logs = [_apply(pkg, ops, pkg.PrefixStore(capacity_bytes=400))
            for _, pkg in SIDES]
    assert logs[0] == logs[1]
    assert logs[1][-1][4] > 0                     # evictions happened
    assert any(not r for (k, *_), (r, *_) in zip(ops, logs[1])
               if k == "big")                      # oversize refused
    for _, pkg in SIDES:
        st = pkg.PrefixStore(capacity_bytes=1 << 20)
        st.put(np.asarray([1], np.int32), _rows(pkg, np.random.default_rng(0),
                                                4, 4), "geom-A")
        with pytest.raises(ValueError, match="geometry"):
            st.put(np.asarray([2], np.int32),
                   _rows(pkg, np.random.default_rng(1), 4, 4), "geom-B")


@pytest.mark.parametrize("saver", ["jax", "port"])
def test_saved_store_loads_in_the_other_package(tmp_path, saver):
    """A store either package saved loads in the other: the same entries
    in the same LRU order, rows bit for bit with their dtypes, the
    fingerprint and the counters; a smaller budget evicts the same
    coldest entries; an empty directory gives an empty store."""
    ops = _ops(2)
    src_pkg, dst_pkg = (jps, tps) if saver == "jax" else (tps, jps)
    stores = {}
    for pkg in (jps, tps):
        st = pkg.PrefixStore(capacity_bytes=1200,
                             persist_dir=str(tmp_path / pkg.__name__))
        _apply(pkg, ops, st)
        st.touch(next(iter(st._entries.values()))[0])   # reorder the LRU
        stores[pkg] = st
    src = stores[src_pkg]
    src.save(step=3)
    loaded = dst_pkg.PrefixStore.load(src.persist_dir)
    assert loaded.fingerprint == "fp"
    assert loaded.as_dict() == dict(stores[dst_pkg].as_dict(), spills=0)
    assert _row_values(loaded) == _row_values(stores[dst_pkg])
    small = [pkg.PrefixStore.load(src.persist_dir, capacity_bytes=500)
             for pkg in (jps, tps)]
    assert [st.as_dict() for st in small[:1]] == \
        [st.as_dict() for st in small[1:]]
    assert _row_values(small[0]) == _row_values(small[1])
    assert len(small[1]) < len(src)
    empty = tps.PrefixStore.load(str(tmp_path / "none"))
    assert len(empty) == 0 and empty.persist_dir == str(tmp_path / "none")


# ---------------------------------------------------------------------------
# Spill and adoption through the engines
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jcfg, tcfg = jq.SMOKE, tq.SMOKE
    jm = JLM(jcfg)
    jparams = jax.tree.map(np.asarray,
                           jax.jit(lambda: jinit(jm.specs(), 0))())
    return jcfg, tcfg, jm, jparams


def _engine(mod, models, **kw):
    jcfg, tcfg, jm, jparams = models
    kw.setdefault("batch", BATCH)
    kw.setdefault("cache_len", CACHE)
    kw.setdefault("prompt_buckets", BUCKETS)
    if mod is jeng:
        return jeng.ServeEngine(jm, jcfg, jax.tree.map(jnp.asarray, jparams),
                                **kw)
    return teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg,
                            convert.from_reference(tcfg, jparams, "cpu"),
                            **kw)


def _shared(mod, seed, n, tail=3):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, size=16).astype(np.int32)
    return [mod.Request(np.concatenate(
        [shared, rng.integers(0, 256, size=tail).astype(np.int32)]),
        max_new=4) for _ in range(n)]


def _spill_adopt(mod, pkg, models):
    store = pkg.PrefixStore(capacity_bytes=8 << 20)
    hot = _engine(mod, models, prefix_cache=True, prefix_store=store)
    out1 = hot.generate(_shared(mod, 0, 3))
    spilled = [(p.copy(), rows) for p, rows in store.hottest()]
    cold = _engine(mod, models, prefix_cache=True, prefix_store=store)
    adopted = cold.adopt_prefixes()
    adopted_rows = None
    if mod is teng:
        # what adoption placed, read back before any traffic
        slot = next(s for s in range(BATCH)
                    if cold._slot_prompt[s] is not None)
        adopted_rows = flatten_state_tree(cold.runner.gather_state(
            cold.cache, torch.as_tensor([slot])))
    out2 = cold.generate(_shared(mod, 0, 3))
    s = cold.stats
    return (dict(out1=out1, out2=out2, adopted=adopted,
                 spills=hot.stats.prefix_spills,
                 adoptions=s.prefix_adoptions, hits=s.prefix_hits,
                 saved=s.prefill_tokens_saved,
                 store=store.as_dict()), spilled, adopted_rows)


def test_cold_engine_warm_starts_from_store(models):
    """A hot engine spills its evicted donors; a cold engine adopts them
    and serves the same requests with the hot engine's tokens and prefix
    hits — on both engines, with equal tokens and counters; the adopted
    rows are the spilled rows bit for bit."""
    (ref, _, _), (port, spilled, adopted_rows) = (
        _spill_adopt(mod, pkg, models) for mod, pkg in SIDES)
    assert port == ref
    assert port["out2"] == port["out1"]
    assert port["spills"] >= 1 and port["adopted"] >= 1
    assert port["adoptions"] == port["adopted"] and port["hits"] >= 1
    assert port["saved"] > 0
    rows = spilled[0][1]
    assert sorted(rows) == sorted(adopted_rows)
    for k, v in rows.items():
        assert v.dtype == adopted_rows[k].dtype and torch.equal(
            v, adopted_rows[k]), k


def test_store_refusals(models):
    with pytest.raises(ValueError, match="prefix"):
        _engine(teng, models, prefix_store=tps.PrefixStore())
    store = tps.PrefixStore(capacity_bytes=8 << 20)
    _engine(teng, models, prefix_cache=True,
            prefix_store=store).generate(_shared(teng, 1, 3, tail=2))
    assert len(store) >= 1
    other = _engine(teng, models, cache_len=CACHE * 2, prefix_cache=True,
                    prefix_store=store)
    with pytest.raises(ValueError, match="geometry"):
        other.adopt_prefixes()


def _poison_slot(mod, eng, slot):
    """NaN keys at position 0 of every layer of ``slot``: the next decode
    of that slot reads them and gives non-finite logits."""
    if mod is teng:
        for layer in eng.cache:
            layer["k"][slot, 0] = float("nan")
    else:
        eng.cache = [{name: dict(lay, k=lay["k"].at[:, slot, 0].set(
            jnp.nan)) for name, lay in g.items()} for g in eng.cache]


def _scrub_script(mod, pkg, models):
    store = pkg.PrefixStore(capacity_bytes=8 << 20)
    eng = _engine(mod, models, prefix_cache=True, prefix_store=store)
    first = _shared(mod, 3, 2, tail=4)
    rids = [eng.submit(r) for r in first]
    eng.step()                         # both prefilled and indexed
    victim = eng._rid_slot[rids[0]]
    _poison_slot(mod, eng, victim)
    while eng.step():
        pass
    status = [eng.poll(r).status for r in rids]
    after_scrub = (eng.stats.prefix_spills, len(store))
    # new traffic reuses both slots: the clean donor spills, the
    # scrubbed slot holds no donor to spill
    eng.generate(_shared(mod, 4, 2, tail=4))
    prompts = [tuple(p.tolist()) for p, _ in store.hottest()]
    return (status, after_scrub, eng.stats.prefix_spills, prompts,
            eng.stats.aborted), [tuple(r.prompt.tolist()) for r in first]


def test_scrubbed_rows_are_never_spilled(models):
    """A decode NaN fails its request and scrubs its slot without a spill;
    the clean donor beside it spills when its slot is reused. Same on both
    engines."""
    (ref, _), (port, first) = (_scrub_script(mod, pkg, models)
                               for mod, pkg in SIDES)
    assert port == ref
    status, after_scrub, spills, prompts, aborted = port
    assert status == ["FAILED", "FINISHED"] and aborted == 1
    assert after_scrub == (0, 0)
    assert first[0] not in prompts and first[1] in prompts
    assert spills == len(prompts) >= 1
