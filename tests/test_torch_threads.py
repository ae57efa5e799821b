"""One intra-op thread budget for the port's test modules.

The suite runs under ``pytest -n <workers>``; every worker is a process
whose torch OpenMP pool defaults to one thread per core, and the pools'
spinning threads oversubscribe the cores (six workers on eight cores: a
test of the torch serving demo took 340 s instead of 5.5 s). Every port
test module imports this one, which gives each worker ``cores // workers``
threads (all of them in a serial run).
"""

import os

import torch


def thread_budget() -> int:
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, (os.cpu_count() or 1) // max(workers, 1))


torch.set_num_threads(thread_budget())


def test_intra_op_threads_fit_the_workers():
    assert torch.get_num_threads() == thread_budget()
