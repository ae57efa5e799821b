"""Fault tolerance: atomic checkpointing in the reference's format and
the supervised train driver (``TrainDriver`` auto-restart), the straggler
watchdog and the deterministic fault injector. The serving engine's
``snapshot``/``restore`` and the prefix store ride on the same atomic
checkpoint machinery; ``serve.guard.ServeFaultInjector`` extends
``FaultInjector`` to the serve path."""

from repro_torch.ft.checkpoint import (AsyncCheckpointer, available_steps,
                                       latest_step, restore_checkpoint,
                                       save_checkpoint)
from repro_torch.ft.driver import FaultInjector, StragglerWatchdog, TrainDriver

__all__ = [
    "AsyncCheckpointer", "available_steps", "latest_step",
    "restore_checkpoint", "save_checkpoint", "FaultInjector",
    "StragglerWatchdog", "TrainDriver",
]
