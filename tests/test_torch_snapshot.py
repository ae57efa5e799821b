"""Port parity: tenants (the ``fair`` deficit round-robin scheduler, per-
tenant stats) and the engine's ``snapshot()``/``restore()``, against the
JAX reference engine.

Mirrors ``tests/test_tenants.py``'s scheduler and engine classes and
``tests/test_chaos.py``'s snapshot tests. Seeded operation sequences go
through both ``Scheduler``s (every policy): the same take order and an
equal ``state_dict()`` after every operation. The whole slice: on the
qwen3 smoke model (the same JAX-initialised params) under a
``ManualClock``, each engine serves greedy, sampled, deadline and
two-tenant ``fair`` requests, snapshots mid-stream and restores into a
replacement; tokens, statuses, counters and histogram counts must equal
the reference's. Then a recurrent (rwkv6) and an enc-dec (seamless, its
``Request.extra`` frames in the snapshot) round trip on the port.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import qwen3_0_6b as jq
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro.serve import engine as jeng, guard as jguard
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.registry import get_smoke
from repro_torch.ft.checkpoint import latest_step
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.serve import engine as teng, guard as tguard
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

BATCH, CACHE = 2, 32
BUCKETS = (8, 16)
WEIGHTS = {"a": 2, "b": 1}
DT = 0.003              # clock tick per step: off the histograms' 1-2-5 bounds


# ---------------------------------------------------------------------------
# Scheduler
# ---------------------------------------------------------------------------


def _sched_ops(seed, n=160):
    rng = np.random.default_rng(seed)
    ops, item = [], 0
    for _ in range(n):
        kind = ("submit", "submit", "submit", "take", "put_front", "purge",
                "drop")[int(rng.integers(7))]
        tenant = "abc"[int(rng.integers(3))]
        plen = int(rng.integers(1, 40))
        if kind in ("submit", "put_front"):
            ops.append((kind, item, plen, tenant))
            item += 1
        elif kind == "take":
            ops.append((kind, int(rng.integers(1, 5))))
        elif kind == "purge":
            ops.append((kind, int(rng.integers(2, 7))))
        else:
            ops.append((kind,))
    return ops


def _run_sched(mod, guard, policy, ops, **kw):
    s = mod.Scheduler(policy, **kw)
    log = []
    for op in ops:
        kind = op[0]
        try:
            if kind == "submit":
                r = s.submit(op[1], op[2], tenant=op[3])
            elif kind == "put_front":
                r = s.put_front(op[1], op[2], tenant=op[3])
            elif kind == "take":
                r = s.take(op[1])
            elif kind == "purge":
                r = s.purge(lambda it, m=op[1]: it % m != 0)
            else:
                r = s.drop_oldest()
        except guard.QueueFullError as e:
            r = ("full", e.depth, e.max_queue)
        except IndexError as e:
            r = ("empty", str(e))
        log.append((r, len(s), json.dumps(s.state_dict())))
    return log, s


@pytest.mark.parametrize("policy,kw", [
    ("fifo", {}), ("sjf", {}), ("fair", {}),
    ("fair", dict(tenant_weights={"a": 3, "b": 1})),
    ("fair", dict(tenant_weights={"c": 2}, max_queue=6,
                  shed_policy="drop-oldest")),
    ("sjf", dict(max_queue=5))])
def test_scheduler_matches_reference(policy, kw):
    """Seeded submits, takes, put_fronts, purges and drops: the same
    results (take order, shed items, rejections) and an equal
    ``state_dict()`` after every operation; a scheduler rebuilt from the
    reference's serialized state continues the reference's order."""
    ops = _sched_ops(len(policy) + len(kw))
    (jlog, js), (tlog, ts) = (
        _run_sched(mod, guard, policy, ops, **kw)
        for mod, guard in ((jeng, jguard), (teng, tguard)))
    assert tlog == jlog
    blob = json.loads(json.dumps(js.state_dict()))
    rebuilt = teng.Scheduler(policy, **kw)
    rebuilt.load_state(blob)
    for _ in range(3):
        js.submit(10_000 + _, 3, tenant="b")
        rebuilt.submit(10_000 + _, 3, tenant="b")
    assert [rebuilt.take(1) for _ in range(len(rebuilt))] == \
        [js.take(1) for _ in range(len(js))]


def test_fair_scheduler_contract():
    s = teng.Scheduler("fair", tenant_weights={"a": 2, "b": 1})
    for i in range(4):
        s.submit(f"a{i}", 4, tenant="a")
    for i in range(2):
        s.submit(f"b{i}", 4, tenant="b")
    assert s.take(6) == ["a0", "a1", "b0", "a2", "a3", "b1"]
    s.submit("a9", 4, tenant="a")
    s.submit("b9", 4, tenant="b")
    s.put_front("a-deferred", 9, tenant="a")
    assert s.take(1) == ["a-deferred"]
    for bad, match in ((dict(policy="fifo", tenant_weights={"a": 2}),
                        "fair"),
                       (dict(policy="fair", tenant_weights={"a": 0}),
                        "weight")):
        for mod in (jeng, teng):
            with pytest.raises(ValueError, match=match):
                mod.Scheduler(**bad)
    with pytest.raises(RuntimeError, match="empty"):
        s.load_state(s.state_dict())


# ---------------------------------------------------------------------------
# The whole slice: both engines, snapshot mid-stream, restore
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def models():
    jm = JLM(jq.SMOKE)
    jparams = jax.tree.map(np.asarray,
                           jax.jit(lambda: jinit(jm.specs(), 0))())
    return jm, jparams


def _engine(mod, models, **kw):
    jm, jparams = models
    kw.setdefault("batch", BATCH)
    kw.setdefault("cache_len", CACHE)
    kw.setdefault("prompt_buckets", BUCKETS)
    if mod is jeng:
        return jeng.ServeEngine(jm, jq.SMOKE,
                                jax.tree.map(jnp.asarray, jparams), **kw)
    return teng.ServeEngine(build_model(tq.SMOKE, device="cpu"), tq.SMOKE,
                            convert.from_reference(tq.SMOKE, jparams, "cpu"),
                            **kw)


def _slice_requests(mod):
    """Greedy, sampled and deadline requests over two tenants."""
    rng = np.random.default_rng(11)

    def prompt():
        return rng.integers(0, 256, size=int(rng.integers(3, 14))
                            ).astype(np.int32)

    reqs = [mod.Request(prompt(), max_new=6, tenant="a") for _ in range(3)]
    reqs += [mod.Request(prompt(), max_new=5, tenant="b") for _ in range(2)]
    reqs.append(mod.Request(prompt(), max_new=7, tenant="b",
                            sampling=mod.SamplingParams(0.8, 50, 7)))
    reqs.append(mod.Request(prompt(), max_new=6, tenant="a",
                            sampling=mod.SamplingParams(1.0, 0, 3)))
    # expires after the restore, on its remaining budget
    reqs.append(mod.Request(prompt(), max_new=8, tenant="a",
                            deadline_ms=40.0))
    reqs.append(mod.Request(prompt(), max_new=4, tenant="b",
                            deadline_ms=1000.0))
    return reqs


def _observe(eng, rids):
    s = eng.stats
    return dict(
        states=[(p.status, p.tokens, p.error)
                for p in (eng.poll(r) for r in rids)],
        stats={f: getattr(s, f) for f in eng._STAT_FIELDS},
        shapes=(sorted(s.prefill_shapes), sorted(s.decode_shapes)),
        ttft=list(s.ttft_ms.counts), tok=list(s.tok_ms.counts),
        tenants={t: dict(ts.as_dict(), ttft=list(ts.ttft_ms.counts))
                 for t, ts in sorted(s.tenants.items())})


def _slice_script(mod, guard, models, d):
    clk = guard.ManualClock(100.0)
    kw = dict(policy="fair", tenant_weights=WEIGHTS, snapshot_dir=d,
              clock=clk)
    eng = _engine(mod, models, **kw)
    rids = [eng.submit(r) for r in _slice_requests(mod)]
    for _ in range(5):
        eng.step()
        clk.advance(DT)
    eng.snapshot()
    at_snapshot = _observe(eng, rids)
    while eng.step():
        clk.advance(DT)
    want = _observe(eng, rids)
    clk.advance(5.0)                 # the replacement starts later
    twin = _engine(mod, models, **kw)
    assert twin.restore() == 5
    restored = _observe(twin, rids)
    while twin.step():
        clk.advance(DT)
    got = _observe(twin, rids)
    return dict(at_snapshot=at_snapshot, want=want, restored=restored,
                got=got)


@pytest.fixture(scope="module")
def slice_runs(models, tmp_path_factory):
    return {name: _slice_script(mod, guard, models,
                                str(tmp_path_factory.mktemp(name)))
            for name, mod, guard in (("jax", jeng, jguard),
                                     ("port", teng, tguard))}


def test_snapshot_restore_slice_matches_reference(slice_runs):
    """The port's original and replacement engines give the reference's
    tokens, statuses, counters and histogram counts, and the replacement
    resumes the original's streams: the sampled ones (their RNG states),
    the deadline's expiry (its remaining budget) and the fair rotation."""
    j, t = slice_runs["jax"], slice_runs["port"]
    assert t == j
    got, want = t["got"], t["want"]
    assert got["states"] == want["states"]
    statuses = [s[0] for s in got["states"]]
    assert statuses.count("EXPIRED") == 1 and statuses.count("FINISHED") == 8
    assert t["restored"]["stats"]["recoveries"] == 1
    # the deadline request was still queued at the snapshot
    assert t["at_snapshot"]["states"][7][0] == "QUEUED"
    assert t["restored"]["ttft"] == t["at_snapshot"]["ttft"]
    # (submitted, admitted, completed, expired): the deadline request
    # expires in the queue, behind tenant a's other work
    counts = ("submitted", "admitted", "completed", "expired")
    assert [got["tenants"]["a"][k] for k in counts] == [5, 4, 4, 1]
    assert [got["tenants"]["b"][k] for k in counts] == [4, 4, 4, 0]


def test_restore_refusals(models, tmp_path):
    """A busy engine, another configuration, an empty snapshot and an
    unknown format version are refused; an idle engine skips its
    auto-snapshot; a dead engine points at restore() and a replacement
    resumes from its last snapshot."""
    d = str(tmp_path)
    reqs = _slice_requests(teng)[:3]
    eng = _engine(teng, models, snapshot_dir=d)
    eng.submit(reqs[0])
    eng.snapshot()
    with pytest.raises(RuntimeError, match="fresh"):
        eng.restore()
    with pytest.raises(ValueError, match="fingerprint"):
        _engine(teng, models, snapshot_dir=d, cache_len=CACHE * 2).restore()
    with pytest.raises(ValueError, match="fingerprint"):
        _engine(teng, models, snapshot_dir=d, policy="fair",
                tenant_weights={"a": 2}).restore()
    e2 = str(tmp_path / "empty")
    _engine(teng, models, snapshot_dir=e2).snapshot()
    with pytest.raises(ValueError, match="EMPTY"):
        _engine(teng, models, snapshot_dir=e2).restore()
    auto = _engine(teng, models, snapshot_dir=str(tmp_path / "auto"),
                   snapshot_every=1)
    for _ in range(2):
        auto.step()
    assert auto.stats.snapshots == 0
    assert latest_step(str(tmp_path / "auto")) is None
    with pytest.raises(ValueError, match="snapshot_every needs"):
        _engine(teng, models, snapshot_every=2)
    # a fatal decode fault after auto-snapshots: the replacement resumes
    inj = tguard.ServeFaultInjector(fatal_decode_at={3})
    f = str(tmp_path / "fatal")
    dead = _engine(teng, models, snapshot_dir=f, snapshot_every=1,
                   fault_injector=inj)
    rids = [dead.submit(r) for r in reqs]
    with pytest.raises(tguard.EngineFatalError, match=r"restore\(\)"):
        while dead.step():
            pass
    with pytest.raises(tguard.EngineFatalError, match=r"restore\(\)"):
        dead.snapshot()
    clean = _engine(teng, models).generate(_slice_requests(teng)[:3])
    twin = _engine(teng, models, snapshot_dir=f)
    twin.restore()
    while twin.step():
        pass
    assert [list(twin.poll(r).tokens) for r in rids] == clean
    assert twin.stats.recoveries == 1


def _round_trip(arch, tmp_path, extra=False):
    cfg = get_smoke(arch)
    model = build_model(cfg, device="cpu")
    params = init_params(model.specs(), 0, device="cpu")

    def reqs():
        r = np.random.default_rng(5)
        out = []
        for i in range(3):
            x = (r.standard_normal((cfg.enc_seq, cfg.d_model))
                 .astype(np.float32) if extra else None)
            out.append(teng.Request(
                r.integers(0, cfg.vocab, size=int(r.integers(3, 9))
                           ).astype(np.int32), max_new=5, extra=x,
                sampling=teng.SamplingParams(0.7 * (i % 2), 20, i)))
        return out

    def engine():
        return teng.ServeEngine(build_model(cfg, device="cpu"), cfg, params,
                                batch=BATCH, cache_len=CACHE,
                                prompt_buckets=BUCKETS,
                                snapshot_dir=str(tmp_path))

    eng = engine()
    rids = [eng.submit(r) for r in reqs()]
    for _ in range(3):
        eng.step()
    eng.snapshot()
    while eng.step():
        pass
    want = [eng.poll(r) for r in rids]
    twin = engine()
    twin.restore()
    if extra:
        for rid, r in zip(rids, reqs()):
            if rid in twin._req:
                np.testing.assert_array_equal(twin._req[rid].extra, r.extra)
                assert twin._req[rid].extra.dtype == np.float32
    while twin.step():
        pass
    assert [twin.poll(r) for r in rids] == want
    assert all(w.status == "FINISHED" for w in want)


@pytest.mark.parametrize("arch,extra", [("rwkv6-7b", False),
                                        ("seamless-m4t-medium", True)])
def test_recurrent_and_encdec_round_trips(arch, extra, tmp_path):
    """The opaque state tree (RWKV's shift and WKV states; the enc-dec
    self and cross caches) and enc-dec ``Request.extra`` survive a
    snapshot: the replacement ends with the original's tokens."""
    _round_trip(arch, tmp_path, extra)
