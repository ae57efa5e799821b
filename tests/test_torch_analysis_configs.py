"""Port parity: ``repro_torch.analysis.audit_config`` and the serve
buckets' kernel launches against the JAX package's, per registry arch.

``audit_config`` (SMOKE shapes, both quantize legs, on the CPU) gives the
reference's surface names and no violation in both packages. The launch
counts run on each arch's SMOKE config with the kernel impl (``pallas``;
the registry's SMOKE configs take ``paper``, which launches nothing): a
capture counts a launch each time it runs, the reference's jaxpr once per
``scan`` body, so the port's count per bucket equals the reference's with
every launch multiplied by the lengths of the scans around it (a layer
group's repeat; a time scan's chunks). The audits of qwen3-moe and jamba
are in ``test_torch_analysis_configs_hybrid.py``, to keep each file under
90 s serial (the reference's audit takes 10-35 s per arch).
"""

import dataclasses

import jax
import pytest

from repro.analysis.contracts import audit_config as jaudit_config
from repro.analysis.contracts import serve_trace_jaxprs
from repro.analysis.walker import iter_sub_jaxprs
from repro.configs import registry as jreg
from repro.launch.specs import build_model as jbuild_model
from repro.nn.module import init_params as jinit
from repro.serve.engine import ServeEngine as JEngine
from repro_torch.analysis.contracts import audit_config, launch_counts
from repro_torch.configs import registry as treg
from repro_torch.launch.specs import build_model
from repro_torch.nn.module import init_params
from repro_torch.serve.engine import ServeEngine
import test_torch_threads  # noqa: F401  (one thread budget per worker)

jax.config.update("jax_platform_name", "cpu")

AUDIT_ARCHS = ("qwen3-0.6b", "seamless-m4t-medium")
LAUNCH_ARCHS = ("qwen3-0.6b", "seamless-m4t-medium", "qwen3-moe-235b-a22b",
                "jamba-v0.1-52b")


def check_audit_config(arch):
    ref = jaudit_config(arch)
    port = audit_config(arch, device="cpu")
    assert port["surfaces"] == ref["surfaces"]
    assert port["violations"] == [] == ref["violations"]
    assert port["impl"] == ref["impl"]


def run_launches(jaxpr) -> int:
    """The reference's launches as they run: each ``pallas_call`` times
    the lengths of the scans around it (a ``while`` body would have no
    static trip count: none holds a launch in these configs)."""
    n = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "pallas_call":
            n += 1
            continue
        mult = int(eqn.params["length"]) if eqn.primitive.name == "scan" \
            else 1
        for val in eqn.params.values():
            for sub in iter_sub_jaxprs(val):
                assert eqn.primitive.name != "while" or not run_launches(
                    sub), "a launch inside a while loop"
                n += mult * run_launches(sub)
    return n


def check_launch_counts(arch):
    def kernel(cfg):
        return dataclasses.replace(cfg, swm=dataclasses.replace(
            cfg.swm, impl="pallas"))

    jcfg, tcfg = kernel(jreg.get_smoke(arch)), kernel(treg.get_smoke(arch))
    kw = dict(batch=2, cache_len=32, prompt_buckets=(8,),
              decode_buckets=(2,))
    jm = jbuild_model(jcfg)
    jeng = JEngine(jm, jcfg, jax.jit(lambda: jinit(jm.specs(), 0))(), **kw)
    want = {name: run_launches(jp.jaxpr)
            for name, jp in serve_trace_jaxprs(jeng)}
    tm = build_model(tcfg, device="cpu")
    teng = ServeEngine(tm, tcfg, init_params(tm.specs(), 0, device="cpu"),
                       **kw)
    got = launch_counts(teng)
    assert got == want
    assert all(n > 0 for n in got.values())
    return got


@pytest.mark.parametrize("arch", AUDIT_ARCHS)
def test_audit_config_matches_reference(arch):
    check_audit_config(arch)


@pytest.mark.parametrize("arch", LAUNCH_ARCHS)
def test_bucket_launches_match_reference(arch):
    check_launch_counts(arch)
