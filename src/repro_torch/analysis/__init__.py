"""Static analysis: structural contracts over captures, and a repo AST
lint.

The paper's complexity claims (O(n log n) block-circulant inference and
training, frozen FFT(w) tables) hold only if the programs that run have
the promised structure. Numerics can be right while the structure
regresses: a dense contraction fallback, a weight ``rfft`` on every call,
an extra kernel launch, a per-call weight concat. This package checks the
structure of what the port runs:

* :mod:`repro_torch.analysis.walker` — :func:`capture` runs a function
  under a ``TorchDispatchMode`` and records every op with its shapes,
  dtypes, purity (weight-derived or not) and ``file:line``; a registered
  kernel op is one record. ``kernels.block_circulant.ops``'s probes
  (``count_kernel_launches``/``outer_mm_shapes``) read captures.
* :mod:`repro_torch.analysis.rules` — named rules (``NoFFT``,
  ``NoWeightFFT``, ``NoDenseDotGeneral``, ``DenseFallbackDot``,
  ``LaunchBudget``, ``NoWeightConcat``, ``QuantizedTableDtypes``) that
  return :class:`Violation`\\ s.
* :mod:`repro_torch.analysis.contracts` — rules grouped into per-surface
  contracts (frozen-plan forward and train step, every serve prefill and
  decode bucket, int8 serve and launch parity). ``ServeEngine.audit()``,
  ``prewarm(audit=True)`` and ``train.loop``'s ``audit_args`` gate on
  them; ``audit_config`` audits one registry config end to end.
* :mod:`repro_torch.analysis.lint` — an AST lint for repo-specific
  hazards: fft outside the blessed modules, wall-clock or unseeded rng and
  blocking host syncs inside ``serve/``, unmarked broad ``except``.

CLI: ``python -m repro_torch.analysis --all-configs --json report.json``
audits every registry config's surfaces plus the lint (on the card unless
``--device cpu``) and exits non-zero on any violation.
"""

from repro_torch.analysis.contracts import (Contract,
                                            StructuralContractError,
                                            audit_config, audit_engine,
                                            run_contract)
from repro_torch.analysis.lint import lint_file, lint_paths
from repro_torch.analysis.rules import (DenseFallbackDot, LaunchBudget,
                                        NoDenseDotGeneral, NoFFT,
                                        NoWeightConcat, NoWeightFFT,
                                        QuantizedTableDtypes, Violation)
from repro_torch.analysis.walker import (OpRecord, Trace, capture, iter_ops,
                                         source_location)

__all__ = [
    "Contract",
    "StructuralContractError",
    "Violation",
    "NoFFT",
    "NoWeightFFT",
    "NoDenseDotGeneral",
    "DenseFallbackDot",
    "LaunchBudget",
    "NoWeightConcat",
    "QuantizedTableDtypes",
    "audit_config",
    "audit_engine",
    "run_contract",
    "OpRecord",
    "Trace",
    "capture",
    "iter_ops",
    "source_location",
    "lint_file",
    "lint_paths",
]
