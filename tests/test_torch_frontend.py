"""Port parity: ``repro_torch.serve.frontend`` (the asyncio multi-tenant
front-end) and the launcher's tenant parsing, against the JAX package.

Mirrors ``tests/test_tenants.py::TestAsyncFrontend`` and
``TestLauncherTenantParsing``. Both packages' ``AsyncFrontend`` drive the
same stub engine (which raises each package's ``QueueFullError``) with the
same seed, tenants and ``ManualClock``: the recorded sleeps (token-bucket
waits and backoffs, jitter included), the stamped requests, the rejection
counts and the ``TenantRejectedError`` text must be equal. ``run()``,
``stream()`` and ``result()`` then drive the port's engine and its
``Supervisor`` to terminal states, against the JAX engine's tokens; the
model is ``tests/test_tenants.py``'s 2-layer, d 32 ``dft`` config with the
same params in both packages.
"""

import argparse
import asyncio
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs.base import ModelConfig as JCfg, SWMConfig as JSWM
from repro.launch import serve as jlaunch
from repro.models.decoder import HybridDecoderLM as JLM
from repro.serve import (engine as jeng, frontend as jfe, guard as jguard)
from repro_torch import convert
from repro_torch.configs.base import ModelConfig as TCfg, SWMConfig as TSWM
from repro_torch.launch import serve as tlaunch
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.serve import (engine as teng, frontend as tfe,
                               guard as tguard, supervisor as tsup)
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

SIDES = ((jeng, jfe, jguard), (teng, tfe, tguard))
FIELDS = dict(name="tenants", n_layers=2, d_model=32, n_heads=2,
              n_kv_heads=1, head_dim=16, d_ff=64, vocab=48, remat="none",
              param_dtype="float32", compute_dtype="float32")


class _StubEngine:
    """Accepts submits (after ``reject_first`` QueueFullErrors carrying
    ``hint``) and has no work."""

    def __init__(self, guard, reject_first=0, hint=None):
        self.guard = guard
        self.reject_first = reject_first
        self.hint = hint
        self.submitted = []
        self._rid = 0

    def submit(self, request):
        if self.reject_first > 0:
            self.reject_first -= 1
            raise self.guard.QueueFullError(5, 5,
                                            retry_after_hint=self.hint)
        self._rid += 1
        self.submitted.append(request)
        return self._rid

    def step(self):
        return False


def _fe(fe_mod, engine, clk=None, **kw):
    sleeps = []

    async def fake_sleep(s):
        sleeps.append(s)
        if clk is not None and s > 0:
            clk.advance(s)

    kw.setdefault("tenants", {
        "vip": fe_mod.TenantConfig("vip", slo="interactive", rate=10.0,
                                   burst=2),
        "bulk": fe_mod.TenantConfig("bulk", slo="batch", rate=100.0,
                                    burst=50),
    })
    fe = fe_mod.AsyncFrontend(engine, sleep=fake_sleep,
                              clock=(clk if clk is not None
                                     else (lambda: 0.0)), **kw)
    return fe, sleeps


def _stamped(reqs):
    return [(r.tenant, r.deadline_ms, np.asarray(r.prompt).tolist())
            for r in reqs]


def _both(script):
    """``script(engine module, frontend module, guard module)`` on both
    packages; the results must be equal. Returns the port's."""
    ref, port = (script(*side) for side in SIDES)
    assert port == ref
    return port


def test_slo_classes_and_configs_match_reference():
    assert {k: dataclasses.asdict(v) for k, v in tfe.SLO_CLASSES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jfe.SLO_CLASSES.items()}

    def script(eng, fe_mod, guard):
        out = []
        for kw in (dict(slo="gold"), dict(rate=0.0), dict(burst=0)):
            with pytest.raises(ValueError) as ei:
                fe_mod.TenantConfig("t", **kw)
            out.append(str(ei.value))
        with pytest.raises(ValueError, match="at least one tenant") as ei:
            fe_mod.AsyncFrontend(_StubEngine(guard), {})
        return out + [str(ei.value)]
    _both(script)


@pytest.mark.parametrize("tenant,deadline", [
    ("vip", None), ("vip", 123.0), ("bulk", None)])
def test_slo_deadline_stamping(tenant, deadline):
    """The class default deadline is stamped unless the request sets its
    own; the batch class keeps none; the tenant is written in."""
    def script(eng, fe_mod, guard):
        stub = _StubEngine(guard)
        fe, _ = _fe(fe_mod, stub)
        asyncio.run(fe.submit(tenant, eng.Request(
            np.asarray([1, 2, 3], np.int32), deadline_ms=deadline)))
        return _stamped(stub.submitted)
    (stamped,) = _both(script)
    want = (deadline if deadline is not None
            else tfe.SLO_CLASSES["interactive" if tenant == "vip"
                                 else "batch"].deadline_ms)
    assert stamped[:2] == (tenant, want)


def test_unregistered_tenant_rejected():
    def script(eng, fe_mod, guard):
        fe, _ = _fe(fe_mod, _StubEngine(guard))
        with pytest.raises(KeyError, match="unregistered") as ei:
            asyncio.run(fe.submit("ghost",
                                  eng.Request(np.asarray([1], np.int32))))
        return str(ei.value)
    _both(script)


@pytest.mark.parametrize("jitter", [0.0, 0.25])
def test_backoff_uses_retry_after_hint_proportionally(jitter):
    """hint × (attempt + 1), with the seeded jitter: the same sleeps in
    both packages."""
    def script(eng, fe_mod, guard):
        stub = _StubEngine(guard, reject_first=3, hint=0.5)
        fe, sleeps = _fe(fe_mod, stub, max_retries=4, jitter=jitter,
                         seed=3)
        rid = asyncio.run(fe.submit("bulk",
                                    eng.Request(np.asarray([1], np.int32))))
        return rid, sleeps
    rid, sleeps = _both(script)
    assert rid == 1
    if jitter == 0.0:
        assert [s for s in sleeps if s > 0] == [0.5, 1.0, 1.5]


@pytest.mark.parametrize("hint", [None, 0.01])
def test_exhausted_retries_raise_tenant_scoped(hint):
    """Exponential backoff without a hint, proportional with one; the
    retry budget spent, a ``TenantRejectedError`` with the reference's
    text, tenant, attempts and hint."""
    def script(eng, fe_mod, guard):
        stub = _StubEngine(guard, reject_first=99, hint=hint)
        fe, sleeps = _fe(fe_mod, stub, max_retries=2, jitter=0.1)
        with pytest.raises(fe_mod.TenantRejectedError) as ei:
            asyncio.run(fe.submit("bulk",
                                  eng.Request(np.asarray([1], np.int32))))
        e = ei.value
        return (str(e), e.tenant, e.attempts, e.last_hint, sleeps,
                fe.rejections)
    out = _both(script)
    assert out[1:4] == ("bulk", 3, hint) and out[5] == {"vip": 0, "bulk": 1}


def test_token_bucket_throttles_burst():
    """vip: rate 10/s, burst 2: the 3rd submit waits 0.1 s on the clock."""
    def script(eng, fe_mod, guard):
        clk = guard.ManualClock()
        stub = _StubEngine(guard)
        fe, sleeps = _fe(fe_mod, stub, clk=clk)

        async def burst():
            for _ in range(3):
                await fe.submit("vip", eng.Request(np.asarray([1],
                                                              np.int32)))
        asyncio.run(burst())
        return sleeps, len(stub.submitted), clk()
    sleeps, n, _ = _both(script)
    waits = [s for s in sleeps if s > 0]
    assert waits and abs(waits[0] - 0.1) < 1e-6 and n == 3


def test_token_bucket_refills_on_clock():
    def script(eng, fe_mod, guard):
        clk = guard.ManualClock()
        b = fe_mod.TokenBucket(rate=2.0, burst=2, clock=clk)
        out = [b.try_take(), b.try_take(), b.try_take(), b.wait_time()]
        clk.advance(0.5)
        out += [b.try_take(), b.wait_time()]
        clk.advance(10.0)
        return out + [b.tokens]
    out = _both(script)
    assert out[:3] == [True, True, False] and abs(out[3] - 0.5) < 1e-9


def test_tenant_weights_follow_slo_classes():
    def script(eng, fe_mod, guard):
        fe, _ = _fe(fe_mod, _StubEngine(guard))
        return fe.tenant_weights()
    assert _both(script) == {"vip": 4, "bulk": 1}


@pytest.fixture(scope="module")
def lm():
    jcfg = JCfg(**FIELDS, swm=JSWM(block_size=8, impl="dft"))
    tcfg = TCfg(**FIELDS, swm=TSWM(block_size=8, impl="dft"))
    tparams = init_params(build_model(tcfg, device="cpu").specs(), 0,
                          device="cpu")
    return jcfg, tcfg, convert.to_reference(tcfg, tparams)


def _engine(mod, lm, **kw):
    jcfg, tcfg, ref = lm
    if mod is jeng:
        return jeng.ServeEngine(JLM(jcfg), jcfg,
                                jax.tree.map(jnp.asarray, ref), batch=2,
                                cache_len=32, **kw)
    return teng.ServeEngine(build_model(tcfg, device="cpu"), tcfg,
                            convert.from_reference(tcfg, ref, "cpu"),
                            batch=2, cache_len=32, **kw)


def _reqs(mod, seed, n, max_new=3):
    rng = np.random.default_rng(seed)
    return [mod.Request(rng.integers(0, 48, size=5).astype(np.int32),
                        max_new=max_new) for _ in range(n)]


def test_run_drives_engine_submissions_to_terminal(lm):
    """``run()`` steps both packages' engines to idle; every request
    FINISHED with the same tokens (batch-class tenants: no deadlines)."""
    def script(eng, fe_mod, guard):
        engine = _engine(eng, lm, policy="fair",
                         tenant_weights={"vip": 1, "bulk": 1})
        fe = fe_mod.AsyncFrontend(engine, {
            "vip": fe_mod.TenantConfig("vip", slo="batch", rate=1e4,
                                       burst=100),
            "bulk": fe_mod.TenantConfig("bulk", slo="batch", rate=1e4,
                                        burst=100),
        })

        async def main():
            rids = []
            for i, r in enumerate(_reqs(eng, 6, 4)):
                rids.append(await fe.submit("vip" if i % 2 else "bulk", r))
            steps = await fe.run(idle_rounds=2)
            return steps, [await fe.result(rid) for rid in rids]

        steps, states = asyncio.run(main())
        assert all(st.status == "FINISHED" for st in states)
        return steps, [(st.req_id, st.tokens) for st in states]
    _both(script)


def test_stream_over_supervisor_delivers_exactly_once(lm):
    """Three tenants burst 12 requests through the port's front-end into
    a supervisor (no fault), with the real event loop: every request
    terminal, the statuses add up, and each ``stream()`` yields exactly
    its final tokens, which equal a plain engine's."""
    want = _engine(teng, lm).generate(_reqs(teng, 8, 12, max_new=4))
    sup = tsup.Supervisor(lambda: _engine(
        teng, lm, policy="fair", tenant_weights={"i": 4, "s": 2, "b": 1}),
        require_snapshots=False)
    fe = tfe.AsyncFrontend(sup, {
        "i": tfe.TenantConfig("i", slo="batch", rate=4, burst=2),
        "s": tfe.TenantConfig("s", slo="batch"),
        "b": tfe.TenantConfig("b", slo="batch")})
    reqs = _reqs(teng, 8, 12, max_new=4)

    async def main():
        async def feed(t, mine):
            return [(i, await fe.submit(t, reqs[i])) for i in mine]

        async def consume(rid):
            return [tok async for tok in fe.stream(rid)]

        runner = asyncio.ensure_future(fe.run(idle_rounds=2))
        fed = await asyncio.gather(*(feed(t, range(k, 12, 3))
                                     for k, t in enumerate("isb")))
        pairs = sorted(p for f in fed for p in f)
        consumers = [asyncio.ensure_future(consume(r)) for _, r in pairs]
        await runner
        # the throttled tenant's last submits may land after run() idled
        await fe.run(idle_rounds=2)
        return pairs, await asyncio.gather(*consumers)

    pairs, streams = asyncio.run(main())
    states = [sup.poll(rid) for _, rid in pairs]
    assert all(st.status in tguard.TERMINAL_STATES for st in states)
    assert sum(st.status == tguard.FINISHED for st in states) == 12
    for (i, _), st, got in zip(pairs, states, streams):
        assert got == list(st.tokens) == want[i]


# ---------------------------------------------------------------------------
# The launcher's tenant parsing (both launchers' _parse_tenants)
# ---------------------------------------------------------------------------


def _parse(launch, text, default_slo="standard"):
    return launch._parse_tenants(argparse.ArgumentParser(), text,
                                 default_slo)


def test_launcher_tenant_parsing_matches_reference():
    for text, slo in (("app:interactive,jobs:batch,web", "standard"),
                      ("a, b:batch", "interactive"), ("", "batch")):
        got = {n: (c.name, c.slo, c.rate, c.burst)
               for n, c in _parse(tlaunch, text, slo).items()}
        assert got == {n: (c.name, c.slo, c.rate, c.burst)
                       for n, c in _parse(jlaunch, text, slo).items()}
    out = _parse(tlaunch, "app:interactive,jobs:batch,web")
    assert (out["app"].slo, out["jobs"].slo, out["web"].slo) == \
        ("interactive", "batch", "standard")


@pytest.mark.parametrize("text", ["app:gold", "app,app:batch", "app,,jobs"])
def test_launcher_tenant_errors_match_reference(text, capsys):
    errors = []
    for launch in (jlaunch, tlaunch):
        with pytest.raises(SystemExit):
            _parse(launch, text)
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[0] == errors[1] and "error: --tenants" in errors[1]
