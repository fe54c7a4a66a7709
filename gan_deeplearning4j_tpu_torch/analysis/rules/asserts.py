"""JG003 — bare ``assert`` enforcing runtime invariants in non-test code.

``python -O`` strips every assert. A protocol guard written as an assert —
like the pre-round-6 ``bench.py`` line-length check protecting the driver's
2,000-char stdout tail window — simply vanishes in optimized deployments,
and the failure it guarded (an unparseable oversize line voiding a whole
bench round) comes back silently. Runtime invariants in production code must
be explicit ``if ...: raise``/handle blocks.

Tests are exempt (``skip_tests``): pytest rewrites asserts, they are the
assertion mechanism there. ``assert False`` variants used as unreachable
markers are still flagged — ``raise AssertionError`` spells that intent
survivably.
"""

from __future__ import annotations

import ast


class BareAssert:
    code = "JG003"
    name = "bare-assert"
    summary = "assert enforces a runtime invariant — stripped under python -O"
    skip_tests = True

    def check(self, mod):
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Assert):
                f = mod.finding(
                    self.code,
                    "bare assert is stripped under `python -O` — enforce "
                    "this invariant with an explicit check that raises or "
                    "handles the violation",
                    node,
                )
                yield f, node
