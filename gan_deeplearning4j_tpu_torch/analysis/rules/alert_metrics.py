"""JG023 — alert rule naming a metric family the tree never creates.

The alerting plane (telemetry/alerts.py, docs/OBSERVABILITY.md
"Alerting") is declarative: an :class:`AlertRule` names the metric
family it evaluates as a string. That string is looked up in a snapshot
dict at runtime — so a typo does not error, it makes the rule evaluate
over a family that is never there. A ``threshold``/``burn``/``anomaly``
rule then sees no series and sits at undefined/pending forever (the
fail-closed design hides the typo perfectly), and an ``absence`` rule
fires forever on a family that was never going to exist. Either way the
alert an operator thinks they have is not the alert they have — the
exact silent-typo failure mode a static check can kill.

The rule: every **literal** metric name passed to an ``AlertRule``
construction (the ``metric=`` keyword or its positional slot) must
resolve against the set of metric families the analyzed tree actually
creates:

- literal first arguments of ``<registry>.counter(...)`` /
  ``.gauge(...)`` / ``.histogram(...)`` calls anywhere in the project
  index (the one get-or-create surface every family goes through);
- f-string family names (``f"{metric_prefix}_slo_burn_rate"`` — the
  SLOTracker's prefix-scoped gauges) matched as wildcard patterns, so
  ``fleet_slo_burn_rate`` and ``mux_slo_burn_rate`` both resolve;
- module-level UPPER_CASE string constants that look like metric names
  (``MEMBER_UP = "fleet_member_up"`` — the aggregate module's
  synthesized families are declared this way).

Non-literal metrics (variables, computed names) are out of scope —
silence, not a guess. True negatives: rules naming any family the tree
creates (directly, via an f-string pattern, or via a declared
constant), and test modules (``skip_tests`` — fixture rules point at
fixture metrics on purpose).
"""

from __future__ import annotations

import ast
import re
from typing import Iterable, Optional, Set, Tuple

from gan_deeplearning4j_tpu_torch.analysis import _common

#: the registry's get-or-create family methods
_FAMILY_METHODS = {"counter", "gauge", "histogram"}

#: shapes that read as a metric family name (prom-ish snake_case)
_METRIC_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*_[a-z0-9_]*$")


def _family_literals(tree: ast.AST) -> Tuple[Set[str], Set[str]]:
    """``(exact, patterns)`` of family names one module creates: exact
    string literals, and regex sources for f-string names (formatted
    fields become ``.*``)."""
    exact: Set[str] = set()
    patterns: Set[str] = set()
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in _FAMILY_METHODS and node.args):
            first = node.args[0]
            if isinstance(first, ast.Constant) and isinstance(
                    first.value, str):
                exact.add(first.value)
            elif isinstance(first, ast.JoinedStr):
                parts = []
                for piece in first.values:
                    if isinstance(piece, ast.Constant):
                        parts.append(re.escape(str(piece.value)))
                    else:
                        parts.append(".*")
                patterns.add("^" + "".join(parts) + "$")
        elif isinstance(node, ast.Assign):
            # module-level ALL_CAPS string constants declaring synthetic
            # family names (aggregate.MEMBER_UP)
            value = node.value
            if not (isinstance(value, ast.Constant)
                    and isinstance(value.value, str)
                    and _METRIC_NAME_RE.match(value.value)):
                continue
            for target in node.targets:
                if (isinstance(target, ast.Name)
                        and target.id.isupper()):
                    exact.add(value.value)
    return exact, patterns


def _known_families(mod) -> Tuple[Set[str], Set[str]]:
    """Every family the analyzed tree creates — the whole project index
    when phase 1 ran, this module alone otherwise."""
    exact: Set[str] = set()
    patterns: Set[str] = set()
    index = getattr(mod, "project", None)
    trees: Iterable[ast.AST]
    if index is not None and getattr(index, "modules", None):
        trees = (info.srcmod.tree for info in index.modules.values()
                 if info.srcmod is not None)
    else:
        trees = (mod.tree,)
    for tree in trees:
        e, p = _family_literals(tree)
        exact |= e
        patterns |= p
    return exact, patterns


def _rule_metric(call: ast.Call) -> Optional[ast.Constant]:
    """The literal ``metric`` argument of an AlertRule construction —
    keyword or positional slot 2 (name, kind, metric) — or None when it
    is absent/non-literal (out of scope)."""
    node: Optional[ast.AST] = None
    for kw in call.keywords:
        if kw.arg == "metric":
            node = kw.value
            break
    else:
        if len(call.args) > 2:
            node = call.args[2]
    if (isinstance(node, ast.Constant) and isinstance(node.value, str)
            and node.value):
        return node
    return None


class UnknownMetricInAlertRule:
    code = "JG023"
    name = "unknown-metric-in-alert-rule"
    summary = ("alert rule names a metric family the tree never creates — "
               "the rule silently evaluates nothing forever")
    skip_tests = True

    def check(self, mod):
        rules = []
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            resolved = _common.resolve_call(node, mod.imports) or ""
            if resolved.split(".")[-1] != "AlertRule":
                continue
            metric = _rule_metric(node)
            if metric is not None:
                rules.append((node, metric))
        if not rules:
            return
        exact, patterns = _known_families(mod)
        compiled = [re.compile(p) for p in patterns]
        for call, metric in rules:
            name = metric.value
            if name in exact:
                continue
            if any(p.match(name) for p in compiled):
                continue
            yield mod.finding(
                self.code,
                f"alert rule names metric {name!r}, but no registry "
                f"family with that name is created anywhere in the "
                f"analyzed tree — a threshold/burn/anomaly rule over it "
                f"evaluates nothing forever and an absence rule fires "
                f"forever; fix the name or create the family",
                metric,
            ), call
