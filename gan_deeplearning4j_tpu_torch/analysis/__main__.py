"""torchlint CLI.

    python -m gan_deeplearning4j_tpu_torch.analysis gan_deeplearning4j_tpu_torch chip_smoke.py

Exit codes: 0 clean (modulo baseline + suppressions), 1 active findings or
stale baseline entries, 2 usage error. ``--format json`` emits one machine-
readable object and ``--format sarif`` emits SARIF 2.1.0 for CI annotators;
default text output is one ``path:line:col: CODE message`` row per finding —
the same shape compiler diagnostics use, so editors annotate it for free.

Modes beyond plain analysis:

- ``--changed-only [--diff-base REF]`` runs rules only on .py files
  changed vs the merge base with REF (plus untracked files) — the fast
  pre-commit shape ``analysis/lint_gate.sh`` wraps. The full target set
  is still parsed and indexed (cross-module rules need real context);
  with ``--cache-dir`` that parse is warm, so the run costs roughly
  rules-on-the-diff;
- ``--cache-dir DIR`` persists parsed modules keyed by content hash
  (``LINT_CACHE=off`` is the escape hatch; hit/miss counts under
  ``--profile``);
- ``--fix`` applies the mechanical rewrites (JG003 asserts, JG007
  discarded updates) and re-reports what remains; ``--fix-suppress``
  instead inserts per-line suppressions for every remaining active
  finding and REQUIRES ``--justification``;
- ``--prune-baseline`` rewrites the baseline file dropping entries whose
  fingerprint no longer matches any finding (stale entries otherwise FAIL
  the gate — a fixed bug must leave the baseline, not haunt it);
- ``--write-baseline`` snapshots the CURRENT active findings into the
  baseline file with a placeholder justification that the loader will
  refuse until a human edits it — regenerating a baseline is deliberately
  a two-step act.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from gan_deeplearning4j_tpu_torch.analysis import engine
from gan_deeplearning4j_tpu_torch.analysis.rules import RULES


def _render_profile(report, rules) -> str:
    """Wall-time table for --profile: phases first, then every rule that
    ran, slowest first. Times are wall seconds of this run; the phase-1
    indexes built lazily by a rule (the concurrency index under JG024)
    are charged to the rule that triggered the build."""
    prof = report.profile or {"phases": {}, "rules": {}}
    names = {r.code: r.name for r in rules}
    lines = ["# torchlint --profile (wall seconds)"]
    phases = prof.get("phases", {})
    for key in ("parse", "index", "rules"):
        if key in phases:
            lines.append(f"#   phase {key:<8s} {phases[key]:8.3f}s")
    cache = prof.get("cache")
    if cache is not None:
        lines.append(f"#   cache hits {cache.get('hits', 0)} / "
                     f"misses {cache.get('misses', 0)}")
    per_rule = prof.get("rules", {})
    for code in sorted(per_rule, key=lambda c: (-per_rule[c], c)):
        lines.append(f"#   {code} {names.get(code, '?'):<34s} "
                     f"{per_rule[code]:8.3f}s")
    return "\n".join(lines)


def _emit(report, fmt: str, rules, baseline) -> None:
    if fmt == "json":
        print(json.dumps(report.to_json(), indent=2))
    elif fmt == "sarif":
        from gan_deeplearning4j_tpu_torch.analysis import sarif

        print(json.dumps(sarif.to_sarif(report, rules, baseline), indent=2))
    else:
        print(report.render_text())


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m gan_deeplearning4j_tpu_torch.analysis",
        description="torchlint: static analysis for the port's CUDA hazards",
    )
    p.add_argument("paths", nargs="*", default=None,
                   help="files or directories to analyze")
    p.add_argument("--format", choices=["text", "json", "sarif"],
                   default="text")
    p.add_argument("--baseline", default=engine.DEFAULT_BASELINE_PATH,
                   help="baseline file (default: the checked-in "
                        "analysis/_baseline.json)")
    p.add_argument("--no-baseline", action="store_true",
                   help="report every finding, ignoring the baseline")
    p.add_argument("--write-baseline", action="store_true",
                   help="snapshot current active findings into --baseline "
                        "with TODO justifications (edit before committing)")
    p.add_argument("--prune-baseline", action="store_true",
                   help="rewrite --baseline without entries whose "
                        "fingerprint matches no current finding")
    p.add_argument("--rules", default=None,
                   help="comma-separated rule codes to run (default: all)")
    p.add_argument("--list-rules", action="store_true")
    p.add_argument("--changed-only", action="store_true",
                   help="only analyze .py files changed vs --diff-base "
                        "(merge base) plus untracked files")
    p.add_argument("--diff-base", default="HEAD",
                   help="git ref --changed-only diffs against via the merge "
                        "base (default: HEAD = uncommitted changes only)")
    p.add_argument("--fix", action="store_true",
                   help="apply mechanical rewrites for fixable findings "
                        "(JG003 asserts, JG007 discarded out-of-place "
                        "results), then re-report")
    p.add_argument("--fix-suppress", action="store_true",
                   help="insert justified per-line suppressions for every "
                        "remaining active finding (requires --justification)")
    p.add_argument("--justification", default=None,
                   help="human reason recorded by --fix-suppress")
    p.add_argument("--profile", action="store_true",
                   help="print a per-phase/per-rule wall-time table to "
                        "stderr (the report itself is unchanged)")
    p.add_argument("--cache-dir", default=os.environ.get("TORCHLINT_CACHE_DIR"),
                   help="persist parsed modules here keyed by content hash "
                        "so repeat runs skip the parse phase for unchanged "
                        "files (default: $TORCHLINT_CACHE_DIR, else no cache; "
                        "LINT_CACHE=off disables even an explicit dir)")
    p.add_argument("--lifecycle-stats", default=None, metavar="FILE",
                   help="write lifecycle-index stats (pairs discovered, "
                        "opens, transfers resolved) as JSON to FILE — the "
                        "campaign preflight snapshot")
    args = p.parse_args(argv)

    if args.list_rules:
        for r in RULES:
            print(f"{r.code}  {r.name}: {r.summary}")
        return 0
    if not args.paths:
        p.error("no paths given")
    if args.fix_suppress and not (args.justification or "").strip():
        p.error("--fix-suppress requires --justification (a suppression "
                "must say why)")

    rules = RULES
    if args.rules:
        wanted = {c.strip().upper() for c in args.rules.split(",")}
        rules = [r for r in RULES if r.code in wanted]
        unknown = wanted - {r.code for r in rules}
        if unknown:
            p.error(f"unknown rule codes: {sorted(unknown)}")

    try:
        baseline = None if args.no_baseline else engine.load_baseline(args.baseline)
    except ValueError as exc:
        print(f"torchlint: {exc}", file=sys.stderr)
        return 2

    try:
        targets = engine.collect_files(args.paths)
    except FileNotFoundError as exc:
        print(f"torchlint: {exc}", file=sys.stderr)
        return 2

    # --changed-only still PARSES every target (phase 1 indexes the full
    # tree, so cross-module rules see real context — the cache makes that
    # cheap) but runs rules only on the changed files
    check_paths = None
    if args.changed_only:
        try:
            changed = set(engine.changed_files(base=args.diff_base))
        except RuntimeError as exc:
            print(f"torchlint: --changed-only needs a usable git checkout: "
                  f"{exc}", file=sys.stderr)
            return 2
        check_paths = {t for t in targets if t in changed}
        if not check_paths:
            print("# torchlint: no changed .py files under the given paths",
                  file=sys.stderr)
            return 0

    cache = None
    if args.cache_dir and os.environ.get("LINT_CACHE", "").lower() != "off":
        try:
            cache = engine.ParseCache(args.cache_dir)
        except OSError as exc:
            print(f"torchlint: cache disabled ({exc})", file=sys.stderr)

    def run():
        return engine.analyze_paths(targets, rules=rules, baseline=baseline,
                                    cache=cache, check_paths=check_paths)

    report = run()

    if report.baseline_migrations and not args.no_baseline:
        # entries matched under the legacy fingerprint scheme: rewrite
        # them in place so the next run matches directly
        entries = engine.load_baseline(args.baseline)
        moved = 0
        for e in entries:
            new_fp = report.baseline_migrations.get(e.get("fingerprint"))
            if new_fp is not None:
                e["fingerprint"] = new_fp
                moved += 1
        if moved:
            engine.write_baseline(entries, args.baseline)
            print(f"torchlint: migrated {moved} baseline "
                  f"entr{'y' if moved == 1 else 'ies'} to context-aware "
                  f"fingerprints in {args.baseline}", file=sys.stderr)
            baseline = engine.load_baseline(args.baseline)

    if args.lifecycle_stats and report.index is not None:
        with open(args.lifecycle_stats, "w") as fh:
            json.dump(report.index.lifecycle.stats(), fh, indent=2,
                      sort_keys=True)
            fh.write("\n")

    if args.write_baseline:
        entries = [
            {
                "fingerprint": f.fingerprint,
                "rule": f.code,
                "path": f.path,
                "line": f.line,
                "snippet": f.snippet,
                "justification": "TODO: justify or fix",
            }
            for f in report.active
        ]
        engine.write_baseline(entries, args.baseline)
        print(f"torchlint: wrote {len(entries)} entries to {args.baseline} — "
              f"replace every TODO justification before committing",
              file=sys.stderr)
        return 0

    if args.prune_baseline:
        removed = engine.prune_baseline(report, baseline or [], args.baseline)
        print(f"torchlint: pruned {removed} stale baseline "
              f"entr{'y' if removed == 1 else 'ies'} from {args.baseline}",
              file=sys.stderr)
        baseline = engine.load_baseline(args.baseline)
        report = run()

    if args.fix or args.fix_suppress:
        from gan_deeplearning4j_tpu_torch.analysis import fix as _fix

        result = _fix.apply_fixes(
            report,
            suppress=args.fix_suppress,
            justification=args.justification,
        )
        print(
            f"torchlint: rewrote {result.rewritten}, suppressed "
            f"{result.suppressed} finding(s) in {len(result.files)} file(s)",
            file=sys.stderr,
        )
        for s in result.skipped:
            print(f"torchlint: not mechanically fixable: {s}", file=sys.stderr)
        report = run()  # re-analyze: the output reflects the tree on disk

    if args.profile:
        print(_render_profile(report, rules), file=sys.stderr)
    _emit(report, args.format, rules, baseline)
    return 0 if report.gate_ok else 1


if __name__ == "__main__":
    sys.exit(main())
