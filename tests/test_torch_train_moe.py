"""Port parity: training of the MoE archs (qwen3-moe, arctic, jamba) at
their smoke configs against the JAX package, with ``impl="pallas"``: the
experts' three projections run the grouped Functions (one grouped
``bc_matmul`` forward, recompute and dx, one grouped ``bc_dw`` each) under
the MoE's per-expert recompute, the reference's vmapped custom VJPs under
``jax.checkpoint``. The test and its tolerances are
``tests/test_torch_train_families.py``'s, in a file of their own so test
workers take the two halves apart. Also: qwen3-moe on ``impl="paper"``,
whose experts go through ``Linear._per_expert``; the training launcher
trains a MoE arch, and stops an enc-dec arch, whose synthetic batches
carry no frames, with a message that names them.
"""

import numpy as np
import pytest

from repro_torch.launch import train as tlaunch
from test_torch_train_families import (  # noqa: F401  (collected here)
    HERE, MOE_ARCHS, _check_train_steps, test_train_steps_match_reference)
import test_torch_threads  # noqa: F401  (one thread budget per worker)


@pytest.fixture(scope="module", params=MOE_ARCHS)
def arch(request):
    return request.param


def test_the_two_files_cover_every_arch():
    from repro_torch.configs.registry import ARCHS

    assert sorted(HERE + MOE_ARCHS) == sorted(ARCHS)


def test_per_expert_impl_train_steps_match_reference():
    """The stacked experts on an impl without a grouped launch
    (``impl="paper"``, qwen3-moe's smoke config's own) go through
    ``Linear._per_expert``, one single-table call per expert: the same 2
    steps against the JAX package's vmapped experts."""
    _check_train_steps("qwen3-moe-235b-a22b", impl="paper")


def test_train_launcher_trains_a_moe_arch_on_cpu(capsys):
    tlaunch.main(["--arch", "qwen3-moe-235b-a22b", "--smoke", "--steps",
                  "2", "--seq", "16", "--batch", "2", "--device", "cpu"])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("step")]
    assert len(lines) == 2
    assert all(np.isfinite(float(l.split()[3])) for l in lines)


def test_train_launcher_names_the_missing_frames():
    with pytest.raises(KeyError, match="frames"):
        tlaunch.main(["--arch", "seamless-m4t-medium", "--smoke", "--steps",
                      "1", "--seq", "16", "--batch", "2", "--device",
                      "cpu"])
