"""CLI: audit registry configs × structural surfaces + the repo AST lint.

    python -m repro_torch.analysis --all-configs --json report.json
    python -m repro_torch.analysis --config qwen3-0.6b --no-lint --device cpu

Exit status 0 iff zero violations. The JSON report (schema
``repro_torch.analysis/v1``) holds per-config surface lists and violations
(rule, surface, message, op, ``file:line``) and the lint findings. The
audits run on the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="structural contract auditor + repo AST lint")
    ap.add_argument("--all-configs", action="store_true",
                    help="audit every registry arch (SMOKE shapes)")
    ap.add_argument("--config", action="append", default=[],
                    metavar="ARCH", help="audit one arch (repeatable)")
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="write the report artifact here")
    ap.add_argument("--no-lint", action="store_true",
                    help="skip the AST lint pass")
    ap.add_argument("--lint-root", default=None,
                    help="lint this tree instead of the repro_torch package")
    ap.add_argument("--device", default="cuda",
                    help="where the audited programs run (cuda or cpu)")
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import ARCHS

    archs = list(ARCHS) if args.all_configs else list(args.config)
    if not archs and args.no_lint:
        ap.error("nothing to do: pass --all-configs, --config, or lint")

    report = {"schema": "repro_torch.analysis/v1", "configs": [], "lint": []}
    n_viol = 0

    from repro_torch.analysis.contracts import audit_config

    for arch in archs:
        t0 = time.perf_counter()
        entry = audit_config(arch, device=args.device)
        entry["seconds"] = round(time.perf_counter() - t0, 3)
        report["configs"].append(entry)
        bad = entry["violations"]
        n_viol += len(bad)
        status = "FAIL" if bad else "ok"
        print(f"[{status:>4}] {arch:<22} impl={entry['impl']:<7} "
              f"{len(entry['surfaces'])} surfaces, "
              f"{len(bad)} violation(s), {entry['seconds']:.1f}s",
              flush=True)
        for v in bad:
            print(f"       - {v['surface']}: {v['rule']}: {v['message']}"
                  + (f" [{v['where']}]" if v.get("where") else ""))

    if not args.no_lint:
        from repro_torch.analysis.lint import lint_paths

        lint = lint_paths(args.lint_root)
        report["lint"] = [v.to_json() for v in lint]
        n_viol += len(lint)
        print(f"[{'FAIL' if lint else 'ok':>4}] lint"
              f"{'' if args.lint_root is None else ' ' + args.lint_root}: "
              f"{len(lint)} violation(s)")
        for v in lint:
            print(f"       - {v.rule}: {v.message} [{v.where}]")

    report["violations_total"] = n_viol
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=1)
        print(f"wrote {args.json}")
    print(f"total: {n_viol} violation(s) across "
          f"{len(archs)} config(s)" + ("" if args.no_lint else " + lint"))
    return 1 if n_viol else 0


if __name__ == "__main__":
    sys.exit(main())
