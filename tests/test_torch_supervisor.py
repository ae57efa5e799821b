"""Port parity: ``repro_torch.serve.supervisor`` against the JAX package's
``repro.serve.supervisor``.

Mirrors ``tests/test_supervisor.py::TestSelfHealChaos`` on both packages,
on its 2-layer, d 32 ``dft`` model with the same params (initialised by
the port, carried to the reference through ``convert.to_reference``): a
mid-stream fatal (the full contract: streams, fairness window, TTFT
counts, the compile budget, drain), a fatal during prefill, the give-up
after ``max_restarts`` (delivered tokens kept), ``require_snapshots``,
replay from scratch, and walking past a corrupt LATEST snapshot. Each
script runs on both packages: every at-most-once stream must equal the
fault-free run's tokens, and restarts, recoveries and messages must be
equal. Then a heal with a ``PrefixStore`` attached (spilled donors
adopted into the replacement), the release of the dead engine, ``retire``
and ``dataclass_replace_rid``.

The reference engines of one geometry share one pair of jitted
executables (the first engine's): every engine here runs the same traced
functions, and sharing them spares a recompile per engine and per heal.
"""

import gc
import tempfile
import types
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JCfg, SWMConfig as JSWM
from repro.ft import checkpoint as jck
from repro.models.decoder import HybridDecoderLM as JLM
from repro.serve import (engine as jeng, guard as jguard,
                         prefix_store as jstore, supervisor as jsup)
from repro_torch import convert
from repro_torch.configs.base import ModelConfig as TCfg, SWMConfig as TSWM
from repro_torch.ft import checkpoint as tck
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.serve import (engine as teng, guard as tguard,
                               prefix_store as tstore, supervisor as tsup)
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

BATCH, CACHE = 2, 32
WEIGHTS = {"a": 2, "b": 1, "c": 1}
FIELDS = dict(name="supervisor", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=1, head_dim=16, d_ff=64, vocab=48, remat="none",
              param_dtype="float32", compute_dtype="float32")


@pytest.fixture(scope="module")
def sides():
    """(reference side, port side): each a namespace with the package's
    engine, guard, supervisor, checkpoint and prefix-store modules and an
    ``engine(**kw)`` constructor over the same params."""
    jcfg = JCfg(**FIELDS, swm=JSWM(block_size=8, impl="dft"))
    tcfg = TCfg(**FIELDS, swm=TSWM(block_size=8, impl="dft"))
    tparams = init_params(build_model(tcfg, device="cpu").specs(), 0,
                          device="cpu")
    ref = convert.to_reference(tcfg, tparams)
    jm, jparams = JLM(jcfg), jax.tree.map(jnp.asarray, ref)
    jits = {}

    def jengine(**kw):
        kw.setdefault("batch", BATCH)
        kw.setdefault("cache_len", CACHE)
        eng = jeng.ServeEngine(jm, jcfg, jparams, **kw)
        key = (eng.batch, eng.cache_len)
        if key in jits:
            eng._prefill, eng._decode = jits[key]
        else:
            jits[key] = (eng._prefill, eng._decode)
        return eng

    def tengine(**kw):
        kw.setdefault("batch", BATCH)
        kw.setdefault("cache_len", CACHE)
        return teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg,
                                convert.from_reference(tcfg, ref, "cpu"),
                                **kw)

    mods = lambda **m: types.SimpleNamespace(**m)
    return (mods(eng=jeng, guard=jguard, sup=jsup, ck=jck, store=jstore,
                 engine=jengine),
            mods(eng=teng, guard=tguard, sup=tsup, ck=tck, store=tstore,
                 engine=tengine))


def _tenant_reqs(side, seed, n_per, max_new=4):
    rng = np.random.default_rng(seed)
    return [side.eng.Request(rng.integers(0, 48, size=5).astype(np.int32),
                             max_new=max_new, tenant=t)
            for t in sorted(WEIGHTS) for _ in range(n_per)]


def _base(side, reqs):
    """The fault-free tokens: a fair engine's ``generate``."""
    return side.engine(policy="fair", tenant_weights=WEIGHTS).generate(reqs)


def _drive_supervised(sup, clk, srids, max_steps=600):
    """Step to idle, collecting each request's at-most-once stream and the
    per-tenant admissions at the first DRR boundary past two rounds."""
    streams = {r: [] for r in srids}
    fair_at = None
    sum_w = sum(WEIGHTS.values())
    n_per = len(srids) // len(WEIGHTS)
    steps = 0
    while True:
        alive = sup.step()
        steps += 1
        clk.advance(0.002)
        for r in srids:
            new, _ = sup.take_new_tokens(r)
            streams[r].extend(new)
        admitted = {t: ts.admitted for t, ts in sup.stats.tenants.items()}
        total = sum(admitted.values())
        if fair_at is None and \
                2 * sum_w <= total <= len(WEIGHTS) * n_per - 2:
            fair_at = dict(admitted)
        if not alive:
            break
        assert steps < max_steps, "supervised engine hang"
    return streams, fair_at, steps


def _both(sides, script):
    """``script(side)`` on the reference and the port: equal results.
    Returns the port's."""
    ref, port = (script(side) for side in sides)
    assert port == ref
    return port


def test_midstream_fatal_full_contract(sides):
    """The reference's acceptance chaos test on both packages: 18
    requests of three tenants, a fatal at decode launch 20."""
    def script(side):
        reqs = _tenant_reqs(side, 0, 6)
        base = _base(side, reqs)
        clk = side.guard.ManualClock()
        inj = side.guard.ServeFaultInjector(fatal_decode_at={20})
        with tempfile.TemporaryDirectory() as snap_dir:
            def factory():
                return side.engine(policy="fair", tenant_weights=WEIGHTS,
                                   snapshot_dir=snap_dir, snapshot_every=2,
                                   clock=clk, fault_injector=inj)

            sup = side.sup.Supervisor(factory)
            budget = (sup.engine.max_prefill_variants,
                      sup.engine.max_decode_variants)
            srids = [sup.submit(r) for r in reqs]
            streams, fair_at, steps = _drive_supervised(sup, clk, srids)
            assert sup.restarts == 1 and sup.stats.recoveries == 1
            for i, r in enumerate(srids):
                assert tuple(streams[r]) == tuple(base[i]), \
                    f"request {i} stream diverged across the heal"
            assert fair_at is not None
            total = sum(fair_at.values())
            for t, w in WEIGHTS.items():
                share = total * w / sum(WEIGHTS.values())
                assert abs(fair_at.get(t, 0) - share) <= w + 1, \
                    f"tenant {t} starved: {fair_at} at boundary {total}"
            assert sup.stats.ttft_ms.count == len(reqs)
            assert sup.stats.ttft_ms.p99 is not None
            if side.eng is teng:
                # the port counts launch shapes; the reference engines
                # here share executables, so their counts are not theirs
                assert sup.engine.prefill_compiles <= budget[0]
                assert sup.engine.decode_compiles <= budget[1]
            out = sup.drain(srids)
            assert [out[r] for r in srids] == [list(b) for b in base]
            return (base, [streams[r] for r in srids], fair_at, steps,
                    sup.stats.ttft_ms.counts, [s[1] for s in
                                               inj.launch_log
                                               if s[2] == "fatal"])
    _both(sides, script)


def test_fatal_during_prefill_requeues_unadmitted(sides):
    def script(side):
        reqs = _tenant_reqs(side, 1, 2)
        base = _base(side, reqs)
        clk = side.guard.ManualClock()
        inj = side.guard.ServeFaultInjector(fatal_prefill_at={1})
        with tempfile.TemporaryDirectory() as snap_dir:
            def factory():
                return side.engine(policy="fair", tenant_weights=WEIGHTS,
                                   snapshot_dir=snap_dir, snapshot_every=1,
                                   clock=clk, fault_injector=inj)

            sup = side.sup.Supervisor(factory)
            srids = [sup.submit(r) for r in reqs]
            streams, _, steps = _drive_supervised(sup, clk, srids)
            assert sup.restarts == 1
            for i, r in enumerate(srids):
                assert tuple(streams[r]) == tuple(base[i])
            return base, steps, sup.stats.recoveries
    _both(sides, script)


def test_gives_up_after_max_restarts(sides):
    def script(side):
        clk = side.guard.ManualClock()
        inj = side.guard.ServeFaultInjector(fatal_decode_at={1, 3})
        with tempfile.TemporaryDirectory() as snap_dir:
            def factory():
                return side.engine(snapshot_dir=snap_dir, snapshot_every=1,
                                   clock=clk, fault_injector=inj)

            sup = side.sup.Supervisor(factory, max_restarts=1)
            srids = [sup.submit(r)
                     for r in _tenant_reqs(side, 2, 2, max_new=6)]
            with pytest.raises(side.sup.SupervisorGaveUp,
                               match="max_restarts") as ei:
                for _ in range(200):
                    sup.step()
                    clk.advance(0.002)
            assert sup.restarts == 2
            # delivered tokens stay delivered: poll works on the dead
            # engine and the at-most-once ledger is intact
            delivered = [sup.take_new_tokens(r)[0] for r in srids]
            assert any(delivered), "no tokens survived the give-up"
            return str(ei.value), delivered
    _both(sides, script)


def test_requires_snapshot_dir_by_default(sides):
    def script(side):
        with pytest.raises(ValueError, match="snapshot_dir") as ei:
            side.sup.Supervisor(lambda: side.engine())
        return str(ei.value)
    _both(sides, script)


def test_replay_from_scratch_mode(sides):
    def script(side):
        reqs = _tenant_reqs(side, 3, 2)
        base = _base(side, reqs)
        clk = side.guard.ManualClock()
        inj = side.guard.ServeFaultInjector(fatal_decode_at={5})
        sup = side.sup.Supervisor(
            lambda: side.engine(policy="fair", tenant_weights=WEIGHTS,
                                clock=clk, fault_injector=inj),
            require_snapshots=False)
        srids = [sup.submit(r) for r in reqs]
        streams, _, steps = _drive_supervised(sup, clk, srids)
        assert sup.restarts == 1
        for i, r in enumerate(srids):
            assert tuple(streams[r]) == tuple(base[i])
        return base, steps, sup.stats.recoveries
    _both(sides, script)


def test_heal_walks_past_corrupt_latest_snapshot(sides):
    """A corrupt newest snapshot (its only leaf ``meta = np.zeros(3,
    np.uint8)``) is refused with ``ValueError`` by both restores, and the
    heal restores the one before it."""
    def script(side):
        reqs = _tenant_reqs(side, 4, 2)
        base = _base(side, reqs)
        clk = side.guard.ManualClock()
        inj = side.guard.ServeFaultInjector(fatal_decode_at={6})
        with tempfile.TemporaryDirectory() as snap_dir:
            sup = side.sup.Supervisor(
                lambda: side.engine(policy="fair", tenant_weights=WEIGHTS,
                                    snapshot_dir=snap_dir, snapshot_every=2,
                                    clock=clk, fault_injector=inj))
            srids = [sup.submit(r) for r in reqs]
            for _ in range(4):
                sup.step()
                clk.advance(0.002)
            good = side.ck.available_steps(snap_dir)
            assert good, "no snapshot written in 4 steps"
            bad = max(good) + 100
            side.ck.save_checkpoint(snap_dir, bad,
                                    {"meta": np.zeros(3, np.uint8)})
            probe = side.engine(snapshot_dir=snap_dir)
            with pytest.raises(ValueError):
                probe.restore(bad)
            streams, _, steps = _drive_supervised(sup, clk, srids)
            assert sup.restarts == 1 and sup.stats.recoveries == 1
            for i, r in enumerate(srids):
                assert tuple(streams[r]) == tuple(base[i]), \
                    "heal did not fall back past the corrupt snapshot"
            return base, steps
    _both(sides, script)


def _head_reqs(side, seed=5, n=8):
    """``n`` requests on two shared 16-token heads (alternating), so the
    prefix index has donors and admission rounds evict (spill) them."""
    rng = np.random.default_rng(seed)
    heads = [rng.integers(0, 48, size=16).astype(np.int32)
             for _ in range(2)]
    return [side.eng.Request(np.concatenate(
        [heads[i % 2], rng.integers(0, 48, size=3).astype(np.int32)]),
        max_new=4, tenant=sorted(WEIGHTS)[i % 3]) for i in range(n)]


@pytest.mark.parametrize("snapshots", [True, False])
def test_heal_with_prefix_store(sides, snapshots):
    """A supervised prefix-cache engine with a ``PrefixStore``: donors
    evicted before the fatal spill to the store; the replacement restores
    (or, without snapshots, replays) and adopts. Streams equal the
    fault-free run, and every prefix counter equals the reference's.
    Replaying from scratch, the replacement starts with every slot free,
    so the heal itself adopts stored donors and the re-queued requests
    hit them."""
    def script(side):
        reqs = _head_reqs(side)
        base = _base(side, reqs)
        clk = side.guard.ManualClock()
        inj = side.guard.ServeFaultInjector(fatal_decode_at={9})
        store = side.store.PrefixStore(capacity_bytes=8 << 20)
        with tempfile.TemporaryDirectory() as snap_dir:
            def factory():
                kw = dict(snapshot_dir=snap_dir, snapshot_every=2) \
                    if snapshots else {}
                return side.engine(policy="fair", tenant_weights=WEIGHTS,
                                   prefix_cache=True, prefix_store=store,
                                   clock=clk, fault_injector=inj, **kw)

            sup = side.sup.Supervisor(factory,
                                      require_snapshots=snapshots)
            srids = [sup.submit(r) for r in reqs]
            spilled = []
            while sup.restarts == 0:
                assert sup.step(), "the fatal never fired"
                clk.advance(0.002)
                spilled.append(store.spills)
            adopted_at_heal = sup.stats.prefix_adoptions
            streams, _, steps = _drive_supervised(sup, clk, srids)
            assert sup.restarts == 1
            for i, r in enumerate(srids):
                assert tuple(streams[r]) == tuple(base[i])
            assert spilled[-1] >= 1, "no donor spilled before the fatal"
            s = sup.stats
            if not snapshots:
                assert adopted_at_heal >= 1, "the heal adopted no donor"
                assert s.prefix_hits >= 1 and s.prefill_tokens_saved > 0
            return (base, steps, spilled, adopted_at_heal, s.prefix_hits,
                    s.prefix_lookups, s.prefill_tokens_saved,
                    s.prefix_spills, s.prefix_adoptions, s.recoveries,
                    len(store))
    _both(sides, script)


def test_heal_releases_the_dead_engine(sides):
    """Nothing keeps the dead engine alive after a heal (not the
    supervisor, not the shared fault injector or its log): its state and
    frozen tables are freed."""
    port = sides[1]
    clk = tguard.ManualClock()
    inj = tguard.ServeFaultInjector(fatal_decode_at={3})
    with tempfile.TemporaryDirectory() as snap_dir:
        sup = tsup.Supervisor(lambda: port.engine(
            snapshot_dir=snap_dir, snapshot_every=2, clock=clk,
            fault_injector=inj))
        first = weakref.ref(sup.engine)
        cache = weakref.ref(sup.engine.cache[0]["k"])
        srids = [sup.submit(r) for r in _tenant_reqs(port, 6, 1)]
        _drive_supervised(sup, clk, srids)
        assert sup.restarts == 1 and sup.engine is not first()
        gc.collect()
        assert first() is None and cache() is None, \
            "the dead engine (or its K/V cache) outlived the heal"


def test_retire_and_rid_namespace(sides):
    """Supervisor rids are the supervisor's own; ``retire`` forgets a
    terminal request and refuses a live one, on both packages."""
    def script(side):
        sup = side.sup.Supervisor(lambda: side.engine(),
                                  require_snapshots=False)
        reqs = _tenant_reqs(side, 7, 1)
        srids = [sup.submit(r) for r in reqs]
        with pytest.raises(ValueError, match="not terminal"):
            sup.retire(srids[0])
        out = sup.drain()
        sup.retire(srids[0])
        with pytest.raises(KeyError):
            sup.poll(srids[0])
        st = side.sup.dataclass_replace_rid(sup.poll(srids[1]), 99)
        return (srids, [out[r] for r in srids], st.req_id, st.tokens,
                st.status, sup.cancel(srids[1]))
    _both(sides, script)
