"""Port parity: the analysis layer (``repro_torch.analysis``) against the
JAX package's ``repro.analysis``.

Mirrors ``tests/test_analysis.py`` on captures instead of jaxprs: the
capture records a kernel op as one op (never its plain version's
matmuls), a train step's backward and ``file:line``; purity separates
weight from activation data, through a view that activation data writes
into too. Each rule fires in both packages on the same planted fault and
passes on its clean twin: a weight fft, a dense fallback against a
``(q·k, p·k)`` weight operand (an activation ``(B·S, d)`` operand of the
same contraction passes), a weight concat (an activation concat passes), a
launch over budget and an f32 table in int8 mode. Only the port's
``where`` is read: it points at the planted line (the reference's
``source_location`` returns None on this jax). The audit leaves an
engine's ``snapshot()`` bytes and its later tokens, and a train state's
tensors, unchanged. Both packages flag the ``dft`` impl's frozen serve
path (an rfft and an irfft per projection), the port once per layer run.
Then the
lint on planted files and on ``src/repro_torch`` (no finding), and the
CLI. ``audit_config`` and the per-bucket launch counts are held to the
reference's in ``tests/test_torch_analysis_configs*.py``.
"""

import json
import os
import tempfile
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import (DenseFallbackDot as JDense, LaunchBudget as JBudget,
                            NoFFT as JNoFFT, NoWeightConcat as JConcat,
                            NoWeightFFT as JWeightFFT,
                            QuantizedTableDtypes as JQuant)
from repro.configs.base import ModelConfig as JCfg, SWMConfig as JSWM
from repro.kernels.block_circulant import build_plan as jbuild
from repro.models.decoder import HybridDecoderLM as JLM
from repro.serve import engine as jeng
from repro_torch import convert
from repro_torch.analysis import (Contract, DenseFallbackDot, LaunchBudget,
                                  NoDenseDotGeneral, NoFFT, NoWeightConcat,
                                  NoWeightFFT, QuantizedTableDtypes,
                                  StructuralContractError, capture, iter_ops,
                                  run_contract, source_location)
from repro_torch.analysis.contracts import (audit_plan_surfaces,
                                            plan_step_without_dx,
                                            plan_surfaces)
from repro_torch.analysis.lint import ALLOW_BROAD_EXCEPT_MARKER, lint_file
from repro_torch.analysis.lint import lint_paths
from repro_torch.configs import qwen3_0_6b as tq
from repro_torch.configs.base import ModelConfig as TCfg, SWMConfig as TSWM
from repro_torch.configs.base import TrainConfig
from repro_torch.kernels.block_circulant import build_plan
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params, tree_leaves
from repro_torch.serve import engine as teng, guard as tguard
from repro_torch.train.loop import init_train_state, make_train_step
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

HERE = os.path.basename(__file__)


def _np(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _line(marker):
    """This file's line holding ``marker`` (a planted fault)."""
    with open(__file__) as f:
        return next(i for i, line in enumerate(f, 1)
                    if marker in line and "_line(" not in line)


def _both(fn_j, fn_t, args):
    """(reference jaxpr, port capture) of one function pair on the same
    numpy inputs, the first argument the weight (pure) one."""
    jx = jax.make_jaxpr(fn_j)(*[jnp.asarray(a) for a in args])
    ts = [torch.from_numpy(a.copy()) for a in args]
    return jx, capture(fn_t, *ts, pure=ts[:1])


# ---------------------------------------------------------------------------
# The capture
# ---------------------------------------------------------------------------


def test_capture_records_a_kernel_op_as_one_op():
    plan = build_plan(torch.from_numpy(_np((2, 3, 8), 0)))
    trace = capture(plan.apply, torch.from_numpy(_np((4, 24), 1)),
                    pure=[plan.wr, plan.wi])
    names = [op.name for op in iter_ops(trace)]
    assert names.count("repro_torch.bc_matmul") == 1
    # the plain version's DFT matmuls ran inside the op, unrecorded
    assert not any(n in ("aten.mm", "aten.bmm") for n in names)
    (op,) = [o for o in trace if o.name == "repro_torch.bc_matmul"]
    assert op.in_shapes[:3] == ((4, 24), (2, 3, 5), (2, 3, 5))
    assert op.out_shapes == ((4, 16),)
    assert trace.result.shape == (4, 16)


def test_source_location_points_at_user_code():
    trace = capture(lambda w: torch.fft.rfft(w, dim=-1),   # planted: loc
                    torch.from_numpy(_np((2, 8), 0)))
    (op,) = [o for o in trace if o.name == "aten._fft_r2c"]
    assert source_location(op) == f"{__file__}:{_line('planted: loc')}"


def test_capture_holds_the_backward():
    """The plan train step: forward, dx and dw launches (the reference's
    3); an x that needs no grad skips dx (2, a port-only surface)."""
    cfg = tq.SMOKE
    (fwd_c, fwd), (step_c, step) = plan_surfaces(cfg, device="cpu")
    names = [op.name for op in step]
    assert names.count("repro_torch.bc_matmul") == 2
    assert names.count("repro_torch.bc_dw_freq") == 1
    assert run_contract(step_c, step) == []
    nodx_c, nodx = plan_step_without_dx(cfg, device="cpu")
    assert [op.name for op in nodx].count("repro_torch.bc_matmul") == 1
    assert run_contract(nodx_c, nodx) == []
    assert audit_plan_surfaces(cfg, device="cpu") == []


# ---------------------------------------------------------------------------
# Purity
# ---------------------------------------------------------------------------


def _weight_and_activation_ffts(w, x):
    wf = torch.fft.rfft(w, dim=-1)           # planted: weight fft
    xf = torch.fft.rfft(x, dim=-1)
    return torch.fft.irfft(wf[:2] * xf, n=8, dim=-1)


def _j_weight_and_activation_ffts(w, x):
    wf = jnp.fft.rfft(w, axis=-1)
    xf = jnp.fft.rfft(x, axis=-1)
    return jnp.fft.irfft(wf[:2] * xf, n=8, axis=-1)


def test_purity_separates_weight_from_activation():
    jx, trace = _both(_j_weight_and_activation_ffts,
                      _weight_and_activation_ffts,
                      [_np((3, 8), 0), _np((2, 8), 1)])
    ffts = [op for op in trace if op.name.startswith("aten._fft")]
    assert sorted(op.in_pure[0] for op in ffts) == [False, False, True]
    (jv,) = JWeightFFT(n_param_invars=1).check(jx)
    (tv,) = NoWeightFFT().check(trace)
    assert jv.rule == tv.rule == "NoWeightFFT"
    assert tv.where == f"{__file__}:{_line('planted: weight fft')}"


def test_purity_through_a_view_written_by_activation_data():
    """A view of a param written in place by activation data taints the
    param itself: its later fft is not weight-side."""
    w, x = torch.randn(3, 8), torch.randn(2, 8)

    def f(w, x):
        v = w[0]
        before = torch.fft.rfft(w, dim=-1)
        v.add_(x[0])
        return before, torch.fft.rfft(w, dim=-1)

    trace = capture(f, w, x, pure=[w])
    ffts = [op for op in trace if op.name == "aten._fft_r2c"]
    assert [op.in_pure[0] for op in ffts] == [True, False]
    assert len(NoWeightFFT().check(trace)) == 1
    # factory ops and scalars are pure; tensors made outside are not
    trace = capture(lambda x: torch.fft.rfft(torch.ones(4) * 2.0)
                    + torch.fft.rfft(x), torch.ones(4))
    assert [op.in_pure[0] for op in trace
            if op.name == "aten._fft_r2c"] == [True, False]


def test_purity_survives_a_freed_tainted_address():
    """A buffer written by activation data taints its storage's address;
    once it is freed, a weight-derived tensor the allocator places at the
    same address is still weight data, and its fft still fires
    NoWeightFFT."""

    def f(w, x):
        buf = torch.zeros_like(x)
        buf.add_(x)                                  # taints buf's address
        ptr = buf.untyped_storage().data_ptr()
        del buf
        keep = []
        for _ in range(256):
            wc = w * 2.0
            if wc.untyped_storage().data_ptr() == ptr:
                return torch.fft.rfft(wc, dim=-1)    # weight fft, reused address
            keep.append(wc)
        return None

    # whether the CPU allocator hands a freed block back depends on the
    # size and on the heap state the process has reached (at 1024, 2048
    # and 4096 floats alone some heap states reuse none): sizes from 64 B
    # to 512 KiB are tried until one reuses, the small ones in the
    # allocator's per-size free lists, each try well under a second
    reused = 0
    for n in (1 << e for e in range(4, 18)):
        w, x = torch.randn(n), torch.randn(n)
        trace = capture(f, w, x, pure=[w])
        if trace.result is None:
            continue
        reused += 1
        (v,) = NoWeightFFT().check(trace)
        assert v.where == f"{__file__}:{_line('weight fft, reused address')}"
        break
    assert reused, "the allocator reused no freed address: nothing tested"


# ---------------------------------------------------------------------------
# Every rule fires in both packages on the same planted fault
# ---------------------------------------------------------------------------


def test_no_fft_rule_fires_in_both():
    jx, trace = _both(lambda x: jnp.fft.irfft(jnp.fft.rfft(x, axis=-1), n=8,
                                              axis=-1),
                      lambda x: torch.fft.irfft(torch.fft.rfft(x, dim=-1),
                                                n=8, dim=-1),
                      [_np((2, 8), 0)])
    assert len(JNoFFT().check(jx)) == len(NoFFT().check(trace)) == 2
    jx, trace = _both(lambda x: x * 2, lambda x: x * 2, [_np((2,), 0)])
    assert JNoFFT().check(jx) == [] and NoFFT().check(trace) == []


def test_no_weight_fft_clean_twin_passes_in_both():
    jx, trace = _both(lambda w, x: jnp.fft.rfft(x, axis=-1).real.sum() + w,
                      lambda w, x: torch.fft.rfft(x, dim=-1).real.sum() + w,
                      [_np((3,), 0), _np((2, 8), 1)])
    assert JWeightFFT(n_param_invars=1).check(jx) == []
    assert NoWeightFFT().check(trace) == []


def _fallback(w, x):
    return x @ w                              # planted: dense fallback


def _act_side(w, a, b):
    return (a @ b) @ w[:40, :4]


def test_dense_fallback_fires_only_on_the_weight_side():
    """(q·k, p·k) = (24, 40): ``x @ w`` against the weight operand fires
    in both; an activation (B·S, d) = (24, 40) operand passes."""
    jx, trace = _both(lambda w, x: x @ w, _fallback,
                      [_np((24, 40), 1), _np((4, 24), 2)])
    (jv,) = JDense([(24, 40)], n_param_invars=1).check(jx)
    (tv,) = DenseFallbackDot([(24, 40)]).check(trace)
    assert jv.rule == tv.rule == "DenseFallbackDot"
    assert tv.primitive == "aten.mm"
    assert tv.where == f"{__file__}:{_line('planted: dense fallback')}"
    args = [_np((40, 24), 3), _np((24, 24), 4), _np((24, 40), 5)]
    jx, trace = _both(lambda w, a, b: (a @ b) @ w[:40, :4], _act_side, args)
    assert JDense([(24, 40)], n_param_invars=1).check(jx) == []
    assert DenseFallbackDot([(24, 40)]).check(trace) == []
    # without the weight-side filter the activation operands match (b,
    # and a @ b), as the reference's without n_param_invars
    assert len(DenseFallbackDot([(24, 40)],
                                weight_side=False).check(trace)) == 2 == \
        len(JDense([(24, 40)]).check(jx))
    assert len(NoDenseDotGeneral().check(trace)) == 2


def _weight_stack(wa, wb, x):
    return (torch.cat([wa, wb], dim=0) * x).sum()   # planted: weight cat


def test_no_weight_concat_distinguishes_sides():
    wa, wb, x = _np((4, 3, 8), 0), _np((4, 3, 8), 1), _np((8, 3, 8), 2)
    jw = jax.make_jaxpr(lambda wa, wb, x: (jnp.concatenate([wa, wb], axis=0)
                                           * x).sum())(wa, wb, x)
    ja = jax.make_jaxpr(lambda wa, wb, x: jnp.concatenate([x, x], axis=0)
                        .sum() + (wa + wb).sum())(wa, wb, x)
    t = [torch.from_numpy(a) for a in (wa, wb, x)]
    tw = capture(_weight_stack, *t, pure=t[:2])
    ta = capture(lambda wa, wb, x: torch.cat([x, x], dim=0).sum()
                 + (wa + wb).sum(), *t, pure=t[:2])
    jrule = JConcat(table_shapes=[(8, 3, 8)], n_param_invars=2)
    trule = NoWeightConcat(table_shapes=[(8, 3, 8)], weight_side=True)
    assert len(jrule.check(jw)) == len(trule.check(tw)) == 1
    assert trule.check(tw)[0].where == \
        f"{__file__}:{_line('planted: weight cat')}"
    assert jrule.check(ja) == [] and trule.check(ta) == []
    # strict mode flags any concat at all
    assert len(JConcat().check(ja)) == len(NoWeightConcat().check(ta)) == 1


def _two_launches(plan, x):
    return plan.apply(plan.apply(x) * 0 + x)     # planted: second launch


def test_launch_budget_points_at_the_excess_launch():
    w, x = _np((3, 3, 8), 0), _np((4, 24), 1)
    jp = jbuild(jnp.asarray(w))
    jx = jax.make_jaxpr(lambda x: jp.apply(jp.apply(x) * 0 + x))(
        jnp.asarray(x))
    tp = build_plan(torch.from_numpy(w))
    trace = capture(_two_launches, tp, torch.from_numpy(x),
                    pure=[tp.wr, tp.wi])
    assert JBudget(exact=2).check(jx) == LaunchBudget(exact=2).check(
        trace) == []
    (jv,) = JBudget(exact=1).check(jx)
    (tv,) = LaunchBudget(exact=1).check(trace)
    assert jv.message.split(",")[0].split()[0] == \
        tv.message.split(",")[0].split()[0] == "2"
    assert tv.primitive == "repro_torch.bc_matmul" and tv.where
    assert LaunchBudget(max_launches=2).check(trace) == []
    for bad in ({}, {"exact": 1, "max_launches": 2}):
        with pytest.raises(ValueError):
            LaunchBudget(**bad)


def test_quantized_dtype_rule_names_the_bad_path():
    def tree(wr, wi, sc):
        return {"layer": {"wr": wr, "wi": wi, "w_scale": sc}}

    good = [np.zeros((2, 3, 5), np.int8)] * 2 + [np.ones((2, 3), np.float32)]
    bad = [np.zeros((2, 3, 5), np.float32), np.zeros((2, 3, 5), np.int8),
           np.ones((2, 3), np.float16)]
    for rule, conv in ((JQuant("int8"), jnp.asarray),
                       (QuantizedTableDtypes("int8"), torch.from_numpy)):
        assert rule.check_params(tree(*map(conv, good))) == []
        msgs = "\n".join(v.message for v in rule.check_params(
            tree(*map(conv, bad))))
        assert "layer/wr" in msgs and "layer/w_scale" in msgs
    with pytest.raises(ValueError):
        QuantizedTableDtypes("int4")


def test_contract_stamps_surface_and_error_formats():
    trace = capture(lambda x: torch.fft.rfft(x, dim=-1),   # planted: stamp
                    torch.ones(2, 8))
    vs = run_contract(Contract(name="plan_forward[k=8]", rules=(NoFFT(),)),
                      trace)
    assert vs and vs[0].surface == "plan_forward[k=8]"
    err = StructuralContractError(vs)
    assert "plan_forward[k=8]" in str(err) and "NoFFT" in str(err)
    assert f"{HERE}:{_line('planted: stamp')}" in str(err)
    rt = json.loads(json.dumps(vs[0].to_json()))
    assert rt["rule"] == "NoFFT" and rt["surface"] == "plan_forward[k=8]"


# ---------------------------------------------------------------------------
# The audit leaves live state alone; the dft impl's frozen path
# ---------------------------------------------------------------------------

FIELDS = dict(name="audit", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
              head_dim=16, d_ff=64, vocab=48, remat="none",
              param_dtype="float32", compute_dtype="float32")


def _port_engine(impl, **kw):
    cfg = TCfg(**FIELDS, swm=TSWM(block_size=8, impl=impl))
    model = build_model(cfg, device="cpu")
    return teng.ServeEngine(model, cfg, init_params(model.specs(), 0,
                                                    device="cpu"),
                            batch=2, cache_len=32, **kw)


def _snapshot_bytes(eng, d):
    eng.snapshot_dir = d
    path = eng.snapshot()
    out = {}
    for root, _, files in os.walk(path):
        for f in sorted(files):
            with open(os.path.join(root, f), "rb") as fh:
                out[os.path.relpath(os.path.join(root, f), path)] = fh.read()
    return out


def test_audit_leaves_the_engine_untouched():
    """Mid-stream (active slots, a prefix index): an engine that audits
    between two snapshots writes the second with the bytes of an engine
    that does not, and serves the same tokens after it."""
    rng = np.random.default_rng(0)
    head = rng.integers(0, 48, 16).astype(np.int32)
    reqs = [teng.Request(np.concatenate([head, rng.integers(0, 48, 3)
                                         .astype(np.int32)]), max_new=6)
            for _ in range(4)]
    snaps, outs = [], []
    for audit in (True, False):
        eng = _port_engine("pallas", prefix_cache=True,
                           clock=tguard.ManualClock())
        rids = [eng.submit(r) for r in reqs]
        for _ in range(3):
            eng.step()
        with tempfile.TemporaryDirectory() as a, \
                tempfile.TemporaryDirectory() as b:
            _snapshot_bytes(eng, a)
            if audit:
                assert eng.audit() == []
                assert not eng._warm_prefill and not eng._warm_decode
            snaps.append(_snapshot_bytes(eng, b))
        eng.snapshot_dir = None
        outs.append(eng.drain(rids))
    assert snaps[0] == snaps[1]
    assert outs[0] == outs[1]


def test_train_step_audit_leaves_the_state_untouched():
    cfg = tq.SMOKE
    model = build_model(cfg, device="cpu")
    state = init_train_state(init_params(model.specs(), 0, device="cpu"),
                             TrainConfig())
    before = [t.detach().clone() for t in tree_leaves(state)
              if isinstance(t, torch.Tensor)]
    tokens = torch.randint(0, cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    make_train_step(model, cfg, TrainConfig(),
                    audit_args=(state, {"tokens": tokens}))
    after = [t for t in tree_leaves(state) if isinstance(t, torch.Tensor)]
    assert state["step"] == 0
    assert all(torch.equal(a.detach(), b) for a, b in zip(after, before))


class _AlwaysFires:
    """A rule that fails every capture."""

    def check(self, trace):
        from repro_torch.analysis.rules import Violation
        return [Violation(rule="AlwaysFires", message="planted")]


def test_failed_train_step_audit_gives_the_model_back_its_params():
    """A violation raises with the capture attached, and the model holds
    the caller's params again, not the stepped clone's."""
    cfg = tq.SMOKE
    model = build_model(cfg, device="cpu")
    state = init_train_state(init_params(model.specs(), 0, device="cpu"),
                             TrainConfig())
    tokens = torch.randint(0, cfg.vocab, (2, 9),
                           generator=torch.Generator().manual_seed(0))
    with pytest.raises(StructuralContractError) as e:
        make_train_step(model, cfg, TrainConfig(),
                        audit_args=(state, {"tokens": tokens}),
                        audit_rules=(_AlwaysFires(),))
    assert [v.rule for v in e.value.violations] == ["AlwaysFires"]
    assert any(op.name == "aten.mm" for op in e.value.trace)
    held = {id(t) for t in model.buffers()}
    assert all(id(t) in held for t in tree_leaves(state["params"]))


def test_dft_impl_frozen_serve_path_runs_an_irfft_in_both():
    """Both packages flag NoFFT on the ``dft`` impl's serve buckets (its
    frozen-table projections take the ``freq`` path: an rfft of x and an
    irfft each): the reference once per scanned layer group, the port
    once per layer run (2 layers)."""
    jcfg = JCfg(**FIELDS, swm=JSWM(block_size=8, impl="dft"))
    eng = _port_engine("dft")
    ref = convert.to_reference(eng.cfg, init_params(
        build_model(eng.cfg, device="cpu").specs(), 0, device="cpu"))
    jv = jeng.ServeEngine(JLM(jcfg), jcfg, jax.tree.map(jnp.asarray, ref),
                          batch=2, cache_len=32).audit()
    tv = eng.audit()
    assert {v.rule for v in jv} == {v.rule for v in tv} == {"NoFFT"}
    assert len(tv) == FIELDS["n_layers"] * len(jv)
    assert {v.primitive for v in tv} == {"aten._fft_r2c", "aten._fft_c2r"}
    assert {v.message.split(")")[0] for v in jv} == {"fft (RFFT",
                                                     "fft (IRFFT"}


# ---------------------------------------------------------------------------
# The AST lint
# ---------------------------------------------------------------------------


def _lint_src(tmp_path, rel, src):
    p = tmp_path / rel.replace("/", "__")
    p.write_text(textwrap.dedent(src))
    return lint_file(str(p), rel=rel)


def test_lint_fft_outside_core(tmp_path):
    src = """
        import torch
        def f(w):
            return torch.fft.rfft(w, dim=-1)
    """
    vs = _lint_src(tmp_path, "serve/helper.py", src)
    assert [(v.rule, v.where) for v in vs] == [("fft-outside-core",
                                                "serve/helper.py:4")]
    assert _lint_src(tmp_path, "core/circulant.py", src) == []
    assert _lint_src(tmp_path, "kernels/block_circulant/opsx.py", src) == []


def test_lint_nondeterminism_and_sync_only_in_serve(tmp_path):
    src = """
        import random, time, torch
        def step(x, stream):
            t0 = time.monotonic()
            if random.random() < 0.5:
                torch.cuda.synchronize()
            stream.synchronize()
            return x.cpu().numpy().tolist(), t0
        rng = random.Random(0)          # seeded: allowed
    """
    vs = _lint_src(tmp_path, "serve/engine2.py", src)
    assert sorted(v.rule for v in vs) == [
        "blocking-sync-in-serve", "blocking-sync-in-serve",
        "nondeterminism-in-serve", "nondeterminism-in-serve"]
    # .cpu()/.numpy()/.tolist() are the step loop's intended sync points
    assert not any(":8" in v.where for v in vs)
    assert _lint_src(tmp_path, "train/loop2.py", src) == []


def test_lint_broad_except_and_marker(tmp_path):
    bad = """
        def f():
            try:
                return 1
            except Exception:
                return 0
    """
    assert [v.rule for v in _lint_src(tmp_path, "launch/x.py", bad)] == [
        "broad-except"]
    ok = f"""
        def f():
            try:
                return 1
            # {ALLOW_BROAD_EXCEPT_MARKER} — fixture
            except BaseException:
                return 0
    """
    assert _lint_src(tmp_path, "launch/x.py", ok) == []
    assert [v.rule for v in _lint_src(tmp_path, "serve/broken.py",
                                      "def f(:\n")] == ["parse-error"]


def test_lint_of_the_port_is_clean():
    assert lint_paths() == []


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------


def test_cli_single_config_report(tmp_path, capsys):
    from repro_torch.analysis.__main__ import main

    out = tmp_path / "report.json"
    rc = main(["--config", "qwen3-0.6b", "--no-lint", "--json", str(out),
               "--device", "cpu"])
    assert rc == 0
    report = json.loads(out.read_text())
    assert report["schema"] == "repro_torch.analysis/v1"
    assert report["violations_total"] == 0
    (entry,) = report["configs"]
    assert entry["arch"] == "qwen3-0.6b" and entry["violations"] == []
    names = " ".join(entry["surfaces"])
    for expect in ("plan_forward", "plan_train_step", "serve_prefill",
                   "serve_decode", "serve_launch_parity"):
        assert expect in names, names
    assert "ok]" in capsys.readouterr().out


def test_cli_lint_only(tmp_path):
    from repro_torch.analysis.__main__ import main

    (tmp_path / "m.py").write_text("x = 1\n")
    assert main(["--lint-root", str(tmp_path)]) == 0
    (tmp_path / "m.py").write_text(
        "try:\n    pass\nexcept Exception:\n    pass\n")
    assert main(["--lint-root", str(tmp_path)]) == 1


def test_audit_config_rejects_unknown_arch():
    from repro_torch.analysis.contracts import audit_config

    with pytest.raises(KeyError):
        audit_config("no-such-arch", device="cpu")
