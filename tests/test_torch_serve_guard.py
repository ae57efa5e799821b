"""Port parity: the engine's failure semantics (``repro_torch.serve.guard``
and the lifecycle of ``ServeEngine``) against the JAX reference engine.

Mirrors ``tests/test_chaos.py`` apart from snapshot/restore, the wave
engine and the supervisor: injected prefill faults isolate their chunk,
a decode fault is retried once and a second one is fatal, NaN logits in
prefill or decode fail only the poisoned request and scrub its rows,
deadlines expire on a ``ManualClock``, running and queued requests
cancel, and the queue sheds (``reject`` with ``QueueFullError``'s
``retry_after_hint``, ``drop-oldest``). Each case runs the same script on
both engines (qwen3 smoke, the kernel impl, the same JAX-initialised
params) and compares statuses, tokens and errors; every case ends with
the no-leak invariants. Also: the state-tree round trip, the ft
primitives against the reference's, and the serve launcher's counters
against the reference launcher's.

NaN poisoning uses an untied-embedding config with one NaN row in the
embedding table: exactly the requests that feed the poison token see
non-finite activations. The poison token is one the fault-free baseline
never emits.
"""

import dataclasses
import re
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import qwen3_0_6b as jq
from repro.configs.base import SWMConfig as JSWM
from repro.ft import driver as jft
from repro.launch import serve as jlaunch
from repro.models.decoder import HybridDecoderLM as JLM
from repro.nn.module import init_params as jinit
from repro.serve import engine as jeng, guard as jguard
from repro_torch import convert
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import SWMConfig as TSWM
from repro_torch.configs.registry import get_smoke
from repro_torch.ft import driver as tft
from repro_torch.launch import serve as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.serve import engine as teng, guard as tguard
from repro_torch.serve.runner import make_runner
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

BATCH, CACHE = 2, 32
BUCKETS = (8, 16)        # + cache_len: a fixed small set of launch shapes
# the two sides of every script: (engine module, guard module)
SIDES = ((jeng, jguard), (teng, tguard))


def _cfgs(**kw):
    jcfg = dataclasses.replace(jq.SMOKE, swm=JSWM(block_size=8,
                                                  impl="pallas"), **kw)
    tcfg = dataclasses.replace(tq.SMOKE, swm=TSWM(block_size=8,
                                                  impl="pallas"), **kw)
    return jcfg, tcfg


def _lm(**kw):
    jcfg, tcfg = _cfgs(**kw)
    jm = JLM(jcfg)
    jparams = jax.tree.map(np.asarray,
                           jax.jit(lambda: jinit(jm.specs(), 0))())
    return jcfg, tcfg, jm, jparams


@pytest.fixture(scope="module")
def lm():
    return _lm()


def _engine(mod, lm, params=None, **kw):
    """An engine of ``mod``'s package on ``lm``'s model (``params``, a
    reference-layout numpy tree, default ``lm``'s)."""
    jcfg, tcfg, jm, jparams = lm
    params = jparams if params is None else params
    kw.setdefault("batch", BATCH)
    kw.setdefault("cache_len", CACHE)
    kw.setdefault("prompt_buckets", BUCKETS)
    if mod is jeng:
        return jeng.ServeEngine(jm, jcfg, jax.tree.map(jax.numpy.asarray,
                                                       params), **kw)
    return teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg,
                            convert.from_reference(tcfg, params, "cpu"),
                            **kw)


def _mix(mod, seed, n, vocab=256, plen_hi=11, new_hi=7):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(0, vocab, size=int(rng.integers(
        1, plen_hi))).astype(np.int32), max_new=int(rng.integers(1, new_hi)))
        for _ in range(n)]


def _drive(eng, clk=None, dt=0.0, max_steps=500):
    """Step to idle with a hard hang guard; optionally tick a ManualClock."""
    steps = 0
    while eng.step():
        steps += 1
        assert steps < max_steps, "engine did not go idle: hang"
        if clk is not None and dt:
            clk.advance(dt)
    return steps


def _no_leaks(eng):
    assert not eng._active.any(), "slot leak: active mask not clear"
    assert (eng._slot_refs == 0).all(), "prefix pin leak"
    assert len(eng._sched) == 0, "scheduler queue not drained"
    assert not eng._rid_slot, "rid->slot map leak"


def _states(eng, rids):
    return [(s.status, s.tokens, s.error)
            for s in (eng.poll(r) for r in rids)]


def _both(script):
    """Run ``script(engine module, guard module)`` for the reference and
    the port; the results must be equal. Returns the port's."""
    ref, port = (script(*side) for side in SIDES)
    assert port == ref
    return port


@pytest.fixture(scope="module")
def base6(lm):
    return _engine(jeng, lm).generate(_mix(jeng, 0, 6))


# ---------------------------------------------------------------------------
# Injected launch faults
# ---------------------------------------------------------------------------


def test_prefill_launch_failure_isolates_chunk(lm, base6):
    def script(mod, guard):
        eng = _engine(mod, lm, fault_injector=guard.ServeFaultInjector(
            fail_prefill_at={0}))
        rids = [eng.submit(r) for r in _mix(mod, 0, 6)]
        _drive(eng)
        _no_leaks(eng)
        return (_states(eng, rids), eng.stats.aborted,
                eng.faults.launch_log)

    states, aborted, log = _both(script)
    failed = [s for s in states if s[0] == "FAILED"]
    assert failed and all("prefill launch failed" in s[2] for s in failed)
    for s, b in zip(states, base6):
        if s[0] == "FINISHED":
            assert list(s[1]) == b
    assert aborted == len(failed) == 6 - sum(s[0] == "FINISHED"
                                             for s in states)
    assert log[0] == ("prefill", 0, "fail", ("default",))


def test_decode_launch_failure_retries_once(lm, base6):
    def script(mod, guard):
        eng = _engine(mod, lm, fault_injector=guard.ServeFaultInjector(
            fail_decode_at={1}))
        outs = eng.generate(_mix(mod, 0, 6))
        _no_leaks(eng)
        return outs, eng.stats.launch_retries, eng.stats.aborted

    outs, retries, aborted = _both(script)
    assert outs == base6, "retried decode launch must not perturb outputs"
    assert (retries, aborted) == (1, 0)


def test_decode_launch_failure_twice_is_fatal(lm):
    def script(mod, guard):
        class AlwaysFailDecode(guard.ServeFaultInjector):
            def on_launch(self, kind, index, tenants=()):
                if kind == "decode":
                    raise guard.InjectedFault(
                        f"decode launch {index} always fails")

        eng = _engine(mod, lm, fault_injector=AlwaysFailDecode())
        for r in _mix(mod, 0, 4):
            eng.submit(r)
        with pytest.raises(guard.EngineFatalError) as e:
            _drive(eng)
        assert isinstance(e.value.__cause__, guard.InjectedFault)
        # a dead engine refuses everything
        with pytest.raises(guard.EngineFatalError, match="engine is dead"):
            eng.submit(_mix(mod, 9, 1)[0])
        with pytest.raises(guard.EngineFatalError, match="engine is dead"):
            eng.step()
        return eng.stats.launch_retries, eng.stats.decode_steps

    assert _both(script) == (1, 0)
    # the dead engine points the caller at restore(), as the reference's
    eng = _engine(teng, lm)
    eng._fatal = "RuntimeError: x"
    with pytest.raises(tguard.EngineFatalError) as e:
        eng.step()
    assert "restore() its latest snapshot" in str(e.value)


def test_fatal_prefill_fault_kills_engine(lm):
    def script(mod, guard):
        eng = _engine(mod, lm, fault_injector=guard.ServeFaultInjector(
            fatal_prefill_at={1}))
        for r in _mix(mod, 0, 6):
            eng.submit(r)
        with pytest.raises(guard.EngineFatalError):
            _drive(eng)
        return eng._fatal, eng.stats.prefill_calls

    fatal, calls = _both(script)
    assert fatal.startswith("InjectedEngineFatal") and calls == 1


# ---------------------------------------------------------------------------
# NaN isolation (per-row finiteness guard)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def poisoned():
    """Untied config + params, the poison token and the fault-free
    baseline of a clean mix whose prompts never touch the poison row."""
    lm_u = _lm(tie_embeddings=False)
    reqs = _mix(jeng, 3, 5, vocab=40)    # prompts < 40: poison in 40..255
    base = _engine(jeng, lm_u).generate(reqs)
    used = {t for o in base for t in o}
    poison = next(t for t in range(255, 39, -1) if t not in used)
    return lm_u, poison, base


def _poison(params, tok):
    pp = jax.tree.map(np.array, params)
    pp["embed"]["table"][tok] = np.nan
    return pp


def test_nan_prefill_aborts_only_poisoned_request(poisoned):
    lm_u, poison, base = poisoned
    pp = _poison(lm_u[3], poison)

    def script(mod, guard):
        eng = _engine(mod, lm_u, pp)
        bad = mod.Request(np.asarray([3, poison, 7], np.int32), max_new=4)
        rids = [eng.submit(r) for r in _mix(mod, 3, 5, vocab=40) + [bad]]
        _drive(eng)
        _no_leaks(eng)
        return (_states(eng, rids), eng.stats.aborted,
                sorted(eng.stats.prefill_shapes),
                sorted(eng.stats.decode_shapes))

    states, aborted, _, _ = _both(script)
    assert states[-1] == ("FAILED", (), "non-finite logits in prefill "
                          "(request aborted; batch continues)")
    assert [(s[0], list(s[1])) for s in states[:-1]] == [
        ("FINISHED", b) for b in base]
    assert aborted == 1


def _decode_victim(base):
    reqs = _mix(jeng, 3, 5, vocab=40)
    for v in range(len(reqs)):
        if len(base[v]) >= 2 and base[v][0] not in np.asarray(
                reqs[v].prompt):
            return v, base[v][0]
    raise AssertionError("workload seed yields no decode-NaN victim")


def test_nan_decode_aborts_and_scrubs_slot(poisoned):
    lm_u, _, base = poisoned
    victim, tok0 = _decode_victim(base)
    pp = _poison(lm_u[3], tok0)
    reqs = _mix(jeng, 3, 5, vocab=40)
    safe = [i for i in range(len(reqs)) if i != victim
            and tok0 not in base[i] and tok0 not in np.asarray(
                reqs[i].prompt)]
    assert safe, "workload seed must leave an unpoisoned request"

    def script(mod, guard):
        eng = _engine(mod, lm_u, pp)
        rids = [eng.submit(r) for r in _mix(mod, 3, 5, vocab=40)]
        _drive(eng)
        _no_leaks(eng)
        again = eng.generate([_mix(mod, 3, 5, vocab=40)[i] for i in safe])
        _no_leaks(eng)
        return _states(eng, rids), again, eng.stats.aborted

    states, again, aborted = _both(script)
    status, toks, err = states[victim]
    assert (status, err) == ("FAILED", "non-finite logits in decode "
                             "(request aborted; batch continues)")
    assert list(toks)[:1] == [tok0]           # partial progress kept
    for i in safe:
        assert states[i][:2] == ("FINISHED", tuple(base[i]))
    assert again == [base[i] for i in safe]
    assert aborted == 1


def test_scrubbed_rows_equal_fresh_rows(poisoned):
    """Right after the decode NaN, the victim's slot holds blank rows (no
    NaN survives anywhere in the state), and the slot left the index."""
    lm_u, _, base = poisoned
    victim, tok0 = _decode_victim(base)
    eng = _engine(teng, lm_u, _poison(lm_u[3], tok0), prefix_cache=True)
    scrubbed = []
    scrub = eng._scrub_slot
    eng._scrub_slot = lambda s: (scrubbed.append(s), scrub(s))
    rids = [eng.submit(r) for r in _mix(teng, 3, 5, vocab=40)]
    while eng.poll(rids[victim]).status != "FAILED":
        assert eng.step()
    (slot,) = scrubbed
    assert eng._slot_prompt[slot] is None
    idx = torch.as_tensor([slot])
    fresh = eng.runner.init_state(1)
    for got, want in zip(eng.runner.gather_state(eng.cache, idx), fresh):
        for n in want:
            assert torch.equal(got[n], want[n]), n
    for layer in eng.cache:
        for t in layer.values():
            assert not torch.isnan(t.float()).any()
    _drive(eng)
    _no_leaks(eng)


# ---------------------------------------------------------------------------
# Deadlines, cancellation, shedding
# ---------------------------------------------------------------------------


def test_deadline_expires_at_step_boundary(lm, base6):
    def script(mod, guard):
        clk = guard.ManualClock()
        eng = _engine(mod, lm, clock=clk)
        reqs = _mix(mod, 0, 6)
        # request 0 lives 5 ms; each engine step takes a simulated 10 ms
        doomed = mod.Request(reqs[0].prompt, max_new=reqs[0].max_new,
                             deadline_ms=5.0)
        rids = [eng.submit(r) for r in [doomed] + reqs[1:]]
        _drive(eng, clk=clk, dt=0.010)
        _no_leaks(eng)
        return (_states(eng, rids), eng.stats.expired,
                eng.stats.ttft_ms.counts, eng.stats.tok_ms.counts)

    states, expired, ttft, tok = _both(script)
    assert states[0][0] == "EXPIRED"
    assert states[0][2] == "deadline_ms=5.0 exceeded at step boundary"
    for s, b in zip(states[1:], base6[1:]):
        assert s[:2] == ("FINISHED", tuple(b))
    assert expired == 1
    assert sum(ttft) >= 5 and sum(tok) > 0


def test_cancel_running_and_queued(lm):
    def script(mod, guard):
        eng = _engine(mod, lm)
        rids = [eng.submit(r) for r in _mix(mod, 0, 6)]
        eng.step()                       # admit the first chunk
        running = next(r for r in rids if eng.poll(r).status == "RUNNING")
        queued = next(r for r in rids if eng.poll(r).status == "QUEUED")
        assert eng.cancel(running) and eng.cancel(queued)
        assert eng.cancel(running) is False      # already terminal
        with pytest.raises(KeyError):
            eng.cancel(10_000)
        _drive(eng)                      # the stale queue entry is skipped
        _no_leaks(eng)
        return _states(eng, rids), (running, queued), eng.stats.cancelled

    states, (running, queued), cancelled = _both(script)
    for rid in (running, queued):
        assert states[rid][0] == "CANCELLED"
        assert states[rid][2] == "cancelled by caller"
    assert all(s[0] in ("FINISHED", "CANCELLED") for s in states)
    assert cancelled == 2


def test_reject_shedding_and_backpressure(lm, base6):
    def script(mod, guard):
        clk = guard.ManualClock()
        eng = _engine(mod, lm, max_queue=2, clock=clk)
        reqs = _mix(mod, 0, 6)
        for r in reqs[:2]:
            eng.submit(r)
        seen = []
        with pytest.raises(guard.QueueFullError) as e:
            eng.submit(reqs[2])
        seen.append((e.value.depth, e.value.max_queue,
                     e.value.retry_after_hint, str(e.value)))
        # once the engine has observed drain, the hint is queue depth over
        # the drain rate
        for r in reqs[2:]:
            while True:
                try:
                    eng.submit(r)
                    break
                except guard.QueueFullError as full:
                    seen.append((full.depth, full.retry_after_hint,
                                 str(full)))
                    eng.step()
                    clk.advance(0.010)
        _drive(eng)
        _no_leaks(eng)
        return seen, eng.stats.rejected, eng.generate(reqs)

    seen, rejected, outs = _both(script)
    assert seen[0][:3] == (2, 2, None)
    assert any(s[1] is not None for s in seen[1:])
    assert rejected == len(seen)
    assert outs == base6     # generate() absorbs the backpressure


def test_drop_oldest_shedding(lm):
    def script(mod, guard):
        eng = _engine(mod, lm, max_queue=2, shed_policy="drop-oldest")
        rids = [eng.submit(r) for r in _mix(mod, 0, 6)[:3]]
        first = eng.poll(rids[0])
        _drive(eng)
        _no_leaks(eng)
        return ((first.status, first.error), _states(eng, rids),
                eng.stats.rejected)

    first, states, rejected = _both(script)
    assert first == ("CANCELLED",
                     "load shed (drop-oldest): queue at max_queue=2")
    assert all(s[0] == "FINISHED" for s in states[1:])
    assert rejected == 1


def test_bad_deadline_and_tenant_rejected():
    for d in (0.0, -5.0):
        msgs = []
        for mod in (jeng, teng):
            with pytest.raises(ValueError) as e:
                mod._validate_request(mod.Request(np.asarray([1], np.int32),
                                                  max_new=2, deadline_ms=d),
                                      CACHE)
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    for mod in (jeng, teng):
        with pytest.raises(ValueError, match="tenant"):
            mod.Request(np.asarray([1], np.int32), tenant="")
    with pytest.raises(ValueError, match="shed policy"):
        teng.Scheduler("fifo", shed_policy="drop-newest")
    with pytest.raises(ValueError, match="max_queue"):
        teng.Scheduler("fifo", max_queue=0)


def test_scheduler_matches_reference():
    """Submit, put_front, purge, drop_oldest and take in both policies give
    the reference's order."""
    def script(mod):
        out = []
        for policy in ("fifo", "sjf"):
            s = mod.Scheduler(policy)
            for i, L in enumerate((5, 3, 9, 3, 7)):
                s.submit(i, L)
            out.append(s.take(2))
            s.put_front(out[-1][1], 3)
            out.append(s.purge(lambda i: i != 4))
            out.append(s.drop_oldest())
            out.append(s.take(9))
        return out

    assert script(teng) == script(jeng)


def test_latency_histogram_matches_reference():
    rng = np.random.default_rng(0)
    th, jh = teng.LatencyHistogram(), jeng.LatencyHistogram()
    for ms in np.exp(rng.uniform(-6, 13, size=200)):
        th.observe(ms)
        jh.observe(ms)
    assert th.counts == jh.counts and th.as_dict() == jh.as_dict()
    assert teng.LatencyHistogram().p99 is None
    with pytest.raises(ValueError, match="bucket counts"):
        teng.LatencyHistogram([0])


# ---------------------------------------------------------------------------
# ft primitives, state trees, launcher
# ---------------------------------------------------------------------------


def test_ft_primitives_match_reference():
    dts = [0.1] * 6 + [0.5, 0.5, 0.5, 0.1, 0.9, 0.1]
    tw, jw = tft.StragglerWatchdog(), jft.StragglerWatchdog()
    assert [tw.observe(i, d) for i, d in enumerate(dts)] == [
        jw.observe(i, d) for i, d in enumerate(dts)]
    assert tw.events == jw.events and "escalate" in [e[2] for e in tw.events]

    def fires(inj):
        out = []
        for step in list(range(12)) * 2:
            try:
                inj.maybe_fire(step)
                out.append(None)
            except RuntimeError as e:
                out.append(str(e))
        return out

    assert fires(tft.FaultInjector(fail_at={2}, p_fail=0.3, seed=4)) == \
        fires(jft.FaultInjector(fail_at={2}, p_fail=0.3, seed=4))
    log = []
    for guard in (jguard, tguard):
        inj = guard.ServeFaultInjector(fail_decode_at={1}, p_fail=0.2,
                                       seed=3)
        for i in range(8):
            try:
                inj.on_launch("decode", i, tenants=("a",))
            except guard.InjectedFault:
                pass
        log.append(inj.launch_log)
    assert log[0] == log[1]
    assert tguard.classify_error(tguard.InjectedFault()) == "request"
    assert tguard.classify_error(RuntimeError()) == "fatal"


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "rwkv6-7b", "jamba-v0.1-52b",
                                  "seamless-m4t-medium"])
def test_state_tree_flatten_roundtrip(arch):
    """The generic serialization round-trips every family's state tree bit
    for bit (canonical leaf order, dtype and device from the template)."""
    cfg = get_smoke(arch)
    runner = make_runner(build_model(cfg, device="cpu"), cfg, 16)
    state = runner.init_state(2)
    gen = torch.Generator().manual_seed(0)
    for leaf in tguard._leaves(state):
        if leaf.is_floating_point():
            leaf.copy_(torch.randn(leaf.shape, generator=gen))
    flat = tguard.flatten_state_tree(state)
    assert list(flat) == [f"s{i:05d}" for i in range(len(flat))]
    numpy_flat = {k: v.float().numpy() for k, v in flat.items()}
    rebuilt = tguard.unflatten_state_tree(runner.init_state(2), numpy_flat)
    a, b = tguard._leaves(state), tguard._leaves(rebuilt)
    assert len(a) == len(b) and type(rebuilt) is type(state)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)
    with pytest.raises(ValueError, match="leaves"):
        tguard.unflatten_state_tree(runner.init_state(2),
                                    {"s00000": np.zeros(3)})


COUNTERS = re.compile(r"(decode-shapes=\[[^\]]*\]|[a-z/-]+=[0-9.]+)")


def _counters(out):
    last = [ln for ln in out.splitlines() if " tokens in " in ln][-1]
    keep = ("decode-shapes", "tokens/decode-step", "decode-rows/token",
            "prefix-hit-rate", "prefill-tokens-saved", "rejected", "expired",
            "aborted", "cancelled")
    return {k: v for k, v in (m.split("=", 1) for m in COUNTERS.findall(last))
            if k in keep}


def test_launcher_counters_match_reference(capsys, monkeypatch):
    args = ["--model", "qwen3-0.6b", "--smoke", "--batch", "2",
            "--cache-len", "64", "--n-requests", "6", "--max-new", "4",
            "--prefix-cache", "on", "--max-queue", "2", "--deadline-ms",
            "60000"]
    outs = tlaunch.main(args + ["--device", "cpu"])
    port = _counters(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["serve"] + args)
    jlaunch.main()
    ref = _counters(capsys.readouterr().out)
    assert port == ref
    assert float(port["prefix-hit-rate"]) > 0 and int(port["rejected"]) > 0
    assert [len(o) for o in outs] == [4] * 6
    with pytest.raises(SystemExit):
        tlaunch.main(args[:11] + ["--prefix-capacity", "4", "--device",
                                  "cpu"])
    with pytest.raises(SystemExit):
        tlaunch.main(args[:11] + ["--shed-policy", "drop-oldest",
                                  "--device", "cpu"])
    with pytest.raises(SystemExit):
        tlaunch.main(["--model", "rwkv6-7b", "--smoke", "--device", "cpu",
                      "--prefix-cache", "on"])
    tlaunch.main(args[:11] + ["--stream", "--max-queue", "1", "--device",
                              "cpu"])
    assert "backpressure: admission queue full" in capsys.readouterr().out


def test_masked_nan_rows_do_not_reach_a_seeded_request(lm):
    """A NaN row at a positive position in a free slot — what a decode pad
    lane writes when it feeds a failed request's last token (the poison)
    back — must not reach the next request seeded from that slot (with the
    prefix cache on, a miss seeds from its own slot). The port's seed
    blanks every masked entry; the reference's leaves the k/v in place, so
    its engine fails the clean request through ``0 · NaN``."""
    def script(mod, guard):
        eng = _engine(mod, lm, prefix_cache=True, prefix_block=64)
        eng.generate([mod.Request(np.asarray([5, 6, 7], np.int32),
                                  max_new=4)])
        row = 20                 # past the next prompt, inside the cache
        if mod is teng:
            for layer in eng.cache:
                layer["k"][0, row] = float("nan")
                layer["pos"][0, row] = row
        else:
            eng.cache = [{name: dict(lay, k=lay["k"].at[:, 0, row].set(
                jax.numpy.nan), pos=lay["pos"].at[:, 0, row].set(row))
                for name, lay in g.items()} for g in eng.cache]
        rid = eng.submit(mod.Request(np.asarray([9, 10, 11], np.int32),
                                     max_new=3))
        assert eng._match_prefix(np.asarray([9, 10, 11], np.int32)) == (
            None, 0)
        _drive(eng)
        _no_leaks(eng)
        s = eng.poll(rid)
        return s.status, s.tokens, s.error

    ref = script(jeng, jguard)
    port = script(teng, tguard)
    assert ref[0] == "FAILED" and "non-finite logits in prefill" in ref[2]
    clean = _engine(teng, lm).generate(
        [teng.Request(np.asarray([9, 10, 11], np.int32), max_new=3)])[0]
    assert port == ("FINISHED", tuple(clean), None)
