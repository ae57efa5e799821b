"""Fault tolerance: the straggler watchdog and the deterministic fault
injector (``serve.guard.ServeFaultInjector`` extends it to the serve
path). Checkpoints and ``TrainDriver`` are not ported yet."""

from repro_torch.ft.driver import FaultInjector, StragglerWatchdog

__all__ = ["FaultInjector", "StragglerWatchdog"]
