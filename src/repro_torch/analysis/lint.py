"""Repo-specific AST lint: hazards a generic linter cannot know about.

The reference's four rules over ``src/repro_torch``, each encoding a
contract the port depends on:

* ``fft-outside-core`` — ``torch.fft.*``/``np.fft.*`` calls anywhere but
  ``core/circulant.py`` and ``kernels/``. The whole point of the frozen-plan
  architecture is that transforms happen in exactly two blessed places
  (the impl dispatch and the freeze path); an fft call sprouting elsewhere
  bypasses the freeze accounting the no-fft capture contracts audit.
* ``nondeterminism-in-serve`` — calls to wall-clock time
  (``time.time``/``monotonic``/``perf_counter``, ``datetime.now``) or
  unseeded module-level ``random.*`` inside ``serve/``. Snapshot/restore
  bit-equality and the chaos suite depend on injected clocks
  (``ServeEngine(clock=...)``) and seeded rngs (``random.Random(seed)`` and
  ``np.random.default_rng(seed)`` stay allowed; *references* like the
  ``clock=time.monotonic`` default are not calls and pass).
* ``blocking-sync-in-serve`` — ``torch.cuda.synchronize()`` or any
  ``.synchronize()`` call (a stream's, an event's) inside ``serve/``, the
  counterpart of ``block_until_ready``: a host sync in the engine step
  path serializes the launch pipeline the continuous-batching numbers
  depend on. (``.cpu()``, ``.numpy()`` and ``.tolist()`` are deliberately
  NOT flagged, as ``np.asarray`` is not in the reference: their
  device→host reads are the step loop's *intentional* sync points, the
  ones that read logits back to sample tokens and make admission
  decisions.)
* ``broad-except`` — ``except Exception:`` / bare ``except:`` without an
  explicit ``lint: allow-broad-except`` marker comment on the handler line.
  The serve engine's two launch boundaries (which must also stop a
  ``BaseException``) are the marked handlers; everything else must name
  the exceptions it absorbs.

``lint_paths`` walks ``src/repro_torch`` by default and returns
:class:`~repro_torch.analysis.rules.Violation`\\ s with ``file:line``
provenance.
"""

from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence

from repro_torch.analysis.rules import Violation

__all__ = ["lint_file", "lint_paths", "ALLOW_BROAD_EXCEPT_MARKER"]

ALLOW_BROAD_EXCEPT_MARKER = "lint: allow-broad-except"

#: files/dirs (relative to the lint root) where fft calls are legitimate:
#: the impl dispatch and the freeze/kernel layer.
FFT_ALLOWED = ("core/circulant.py", "kernels/")

_FFT_ROOTS = {"torch", "np", "numpy", "scipy", "fft"}
_TIME_CALLS = {
    ("time", "time"), ("time", "monotonic"), ("time", "perf_counter"),
    ("time", "monotonic_ns"), ("time", "time_ns"),
    ("datetime", "now"), ("datetime", "utcnow"),
}
#: random-module constructors that take an explicit seed and are therefore
#: deterministic; anything else on the module is ambient-seeded.
_RANDOM_SEEDED = {"Random", "SystemRandom"}


def _dotted(node: ast.AST) -> Optional[List[str]]:
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return parts[::-1]
    return None


def _v(rule: str, message: str, rel: str, node: ast.AST) -> Violation:
    return Violation(rule=rule, message=message, surface="lint",
                     where=f"{rel}:{node.lineno}")


def _lint_fft(tree: ast.AST, rel: str) -> List[Violation]:
    if any(rel == a or (a.endswith("/") and rel.startswith(a))
           for a in FFT_ALLOWED):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Attribute):
            continue
        parts = _dotted(node)
        if not parts or "fft" not in parts[:-1] or parts[0] not in _FFT_ROOTS:
            continue
        out.append(_v(
            "fft-outside-core",
            f"{'.'.join(parts)} outside core/circulant.py and kernels/ — "
            f"transforms must go through the blessed impl/freeze paths so "
            f"the no-fft trace contracts stay meaningful",
            rel, node))
    return out


def _lint_serve_nondet(tree: ast.AST, rel: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        parts = _dotted(node.func)
        if not parts or len(parts) < 2:
            continue
        pair = (parts[0], parts[-1])
        if pair in _TIME_CALLS:
            out.append(_v(
                "nondeterminism-in-serve",
                f"{'.'.join(parts)}() inside serve/ — use the engine's "
                f"injected clock so snapshot/restore stays bit-equal "
                f"and chaos tests stay reproducible",
                rel, node))
        elif parts[0] == "random" and parts[1] not in _RANDOM_SEEDED:
            out.append(_v(
                "nondeterminism-in-serve",
                f"{'.'.join(parts)}() inside serve/ draws from the "
                f"ambient-seeded global rng — construct a seeded "
                f"random.Random(seed) instead",
                rel, node))
    return out


def _lint_serve_sync(tree: ast.AST, rel: str) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        parts = _dotted(node.func)
        if parts and tuple(parts) == ("torch", "cuda", "synchronize"):
            out.append(_v(
                "blocking-sync-in-serve",
                "torch.cuda.synchronize() in serve/ stalls the launch "
                "pipeline; let the step's data dependency synchronize "
                "instead",
                rel, node))
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr == "synchronize":
            out.append(_v(
                "blocking-sync-in-serve",
                f"{'.'.join(parts) if parts else '.synchronize'}() in "
                f"serve/ is a blocking host sync in the step path",
                rel, node))
    return out


def _lint_broad_except(tree: ast.AST, rel: str,
                       lines: Sequence[str]) -> List[Violation]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        broad = node.type is None or (
            isinstance(node.type, ast.Name) and node.type.id in
            ("Exception", "BaseException"))
        if not broad:
            continue
        # marker on the handler line, or on a comment within the two lines
        # above it (the idiomatic place for a multi-line justification)
        lo = max(0, node.lineno - 3)
        window = lines[lo:node.lineno]
        if any(ALLOW_BROAD_EXCEPT_MARKER in ln for ln in window):
            continue
        out.append(_v(
            "broad-except",
            f"bare `except {'Exception' if node.type else ''}` — name the "
            f"exceptions this handler absorbs, or mark the line with "
            f"`# {ALLOW_BROAD_EXCEPT_MARKER}: <reason>`",
            rel, node))
    return out


def lint_file(path: str, rel: Optional[str] = None) -> List[Violation]:
    """Lint one file; ``rel`` is the path to report (defaults to ``path``)."""
    rel = (rel or path).replace(os.sep, "/")
    with open(path, "r", encoding="utf-8") as f:
        src = f.read()
    try:
        tree = ast.parse(src, filename=path)
    except SyntaxError as e:
        return [Violation(rule="parse-error", surface="lint",
                          message=str(e), where=f"{rel}:{e.lineno or 0}")]
    out = _lint_fft(tree, rel)
    if rel.startswith("serve/") or "/serve/" in rel:
        out += _lint_serve_nondet(tree, rel)
        out += _lint_serve_sync(tree, rel)
    out += _lint_broad_except(tree, rel, src.splitlines())
    return sorted(out, key=lambda v: (v.where or "", v.rule))


def lint_paths(root: Optional[str] = None) -> List[Violation]:
    """Lint every ``.py`` file under ``root`` (default: the installed
    ``repro_torch`` package tree)."""
    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out: List[Violation] = []
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            rel = os.path.relpath(path, root)
            out.extend(lint_file(path, rel))
    return out
