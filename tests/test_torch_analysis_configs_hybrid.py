"""Port parity: ``audit_config`` of the MoE and hybrid arches
(qwen3-moe-235b-a22b, jamba-v0.1-52b) against the JAX package's; the check
is ``test_torch_analysis_configs``'s."""

import pytest

from test_torch_analysis_configs import check_audit_config
import test_torch_threads  # noqa: F401  (one thread budget per worker)


@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "jamba-v0.1-52b"])
def test_audit_config_matches_reference(arch):
    check_audit_config(arch)
