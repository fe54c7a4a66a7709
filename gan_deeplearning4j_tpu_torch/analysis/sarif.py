"""SARIF 2.1.0 output for torchlint.

SARIF (Static Analysis Results Interchange Format) is the lingua franca CI
annotators speak — GitHub code scanning, VS Code's SARIF viewer, Gerrit
checks all ingest it directly, so ``--format sarif`` makes the gate's
findings appear inline on changed lines with zero glue code.

Mapping choices:

- ``active`` findings are ``level: error`` (they fail the gate);
  ``baselined`` ones are included as ``level: note`` with a
  ``suppressions`` entry (state ``accepted``, the human justification as
  the text) so reviewers see the debt without the gate re-flagging it;
  engine warnings ride along as tool-level notifications.
- the content-based fingerprint goes into ``partialFingerprints`` under
  ``torchlint/v1`` — the same stability contract the baseline uses (survives
  line drift, invalidated by edits to the offending line), which is
  exactly what SARIF asks of a partial fingerprint.
- columns are converted to SARIF's 1-based convention.
"""

from __future__ import annotations

_SCHEMA = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/master/"
           "Schemata/sarif-schema-2.1.0.json")


def _result(finding, level: str, justification=None) -> dict:
    out = {
        "ruleId": finding.code,
        "level": level,
        "message": {"text": finding.message},
        "locations": [{
            "physicalLocation": {
                "artifactLocation": {
                    "uri": finding.path.replace("\\", "/"),
                },
                "region": {
                    "startLine": max(finding.line, 1),
                    "startColumn": finding.col + 1,
                },
            },
        }],
        "partialFingerprints": {"torchlint/v1": finding.fingerprint},
    }
    if justification is not None:
        out["suppressions"] = [{
            "kind": "external",
            "status": "accepted",
            "justification": justification,
        }]
    return out


def to_sarif(report, rules, baseline_entries=None) -> dict:
    """One SARIF run for a :class:`~.engine.Report`."""
    by_fp = {e.get("fingerprint"): e for e in (baseline_entries or [])}
    results = [_result(f, "error") for f in report.active]
    for f in report.baselined:
        entry = by_fp.get(f.fingerprint, {})
        results.append(_result(
            f, "note", justification=entry.get("justification", "baselined")))
    return {
        "$schema": _SCHEMA,
        "version": "2.1.0",
        "runs": [{
            "tool": {
                "driver": {
                    "name": "torchlint",
                    "informationUri": "gan_deeplearning4j_tpu_torch/analysis/CATALOGUE.md",
                    "rules": [
                        {
                            "id": r.code,
                            "name": r.name,
                            "shortDescription": {"text": r.summary},
                        }
                        for r in rules
                    ],
                },
            },
            "invocations": [{
                "executionSuccessful": report.gate_ok,
                "toolExecutionNotifications": [
                    {"level": "warning", "message": {"text": w}}
                    for w in report.warnings
                ],
            }],
            "results": results,
        }],
    }
