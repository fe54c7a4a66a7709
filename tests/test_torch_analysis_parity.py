"""The port's analyzer against the JAX package's on the 14 rules they share.

``gan_deeplearning4j_tpu_torch/analysis`` copies the JAX analyzer's engine
and its 14 rules that are not tied to JAX (JG003, JG016, JG017, JG021-JG029,
JG031, JG032). Both analyzers run each of them over the same inputs:

- (i) the JAX package, ``bench.py`` and ``scripts``, under the JAX
  package's baseline (its three JG026 entries in ``fleet/manager.py`` are
  real positives);
- (ii) the port, ``gan_deeplearning4j_tpu_torch`` and ``chip_smoke.py``;
- (iii) every true-positive and true-negative source of the rule's class in
  ``tests/test_analysis.py`` (read as data), through ``analyze_sources``.

Rule, path, line, column, message and fingerprint, and the active /
suppressed / baselined partition, must be identical. The inputs of (i) and
(iii) carry ``# jaxlint: disable=`` comments, so the port's engine reads
them in that dialect here (its suppression pattern is swapped for the
test): the comparison is of the analyzers, on byte-identical inputs.

Each tree is analyzed once per package, in module-scoped fixtures (about a
minute here), and every rule is a case of its own.
"""

import ast
import os
import re

import pytest

from gan_deeplearning4j_tpu.analysis import engine as jax_engine
from gan_deeplearning4j_tpu.analysis.rules import RULES_BY_CODE as JAX_RULES
from gan_deeplearning4j_tpu_torch.analysis import engine as torch_engine
from gan_deeplearning4j_tpu_torch.analysis.rules import RULES_BY_CODE as TORCH_RULES
from gan_deeplearning4j_tpu_torch.analysis.rules import SHARED_CODES

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the classes of tests/test_analysis.py that hold each shared rule's fixtures
FIXTURE_CLASSES = {
    "JG003": ("TestBareAssert",),
    "JG016": ("TestSwapSeamUnguardedAccess",),
    "JG017": ("TestUnboundedNetworkCall",),
    "JG021": ("TestUnboundedRespawnLoop",),
    "JG022": ("TestCrossGenerationEngineSharing",),
    "JG023": ("TestUnknownMetricInAlertRule",),
    "JG024": ("TestUnguardedSharedMutableState",),
    "JG025": ("TestLockOrderInversion", "TestCrossClassLockOrder"),
    "JG026": ("TestBlockingCallUnderLock",),
    "JG027": ("TestLeakedPairedResource",),
    "JG028": ("TestUnbalancedRelease",),
    "JG029": ("TestHandoffWithoutTransfer",),
    "JG031": ("TestHardcodedLadderLiteral",),
    "JG032": ("TestDoubleBufferMisuse",),
}


def _partition(report):
    def rows(findings):
        return [(f.code, f.path, f.line, f.col, f.message, f.fingerprint) for f in findings]

    return {"active": rows(report.active), "suppressed": rows(report.suppressed),
            "baselined": rows(report.baselined), "stale": report.stale_baseline}


def _by_code(part, code):
    return {k: ([r for r in v if r[0] == code] if k != "stale" else
                [e for e in v if e.get("rule") in (None, code)])
            for k, v in part.items()}


@pytest.fixture(scope="module")
def jaxlint_dialect():
    """The port's engine reading ``# jaxlint: disable=`` comments."""
    saved = torch_engine._SUPPRESS_RE
    torch_engine._SUPPRESS_RE = re.compile(
        saved.pattern.replace("torchlint", "jaxlint"))
    yield
    torch_engine._SUPPRESS_RE = saved


def _both(targets, baseline):
    jax = jax_engine.analyze_paths(
        targets, rules=[JAX_RULES[c] for c in SHARED_CODES], baseline=baseline, root=REPO)
    port = torch_engine.analyze_paths(
        targets, rules=[TORCH_RULES[c] for c in SHARED_CODES], baseline=baseline, root=REPO)
    return jax, port


@pytest.fixture(scope="module")
def jax_tree(jaxlint_dialect):
    return _both(["gan_deeplearning4j_tpu", "bench.py", "scripts"], jax_engine.load_baseline())


@pytest.fixture(scope="module")
def port_tree():
    return _both(["gan_deeplearning4j_tpu_torch", "chip_smoke.py"], None)


def _literal(node):
    try:
        return ast.literal_eval(node)
    except (ValueError, SyntaxError, TypeError):
        return None


def fixture_sources():
    """``{code: [(test name, {path: source})]}``: every ``run(src, ...)``
    and ``analyze_sources({...})`` of the shared rules' test classes whose
    arguments are literals."""
    with open(os.path.join(REPO, "tests", "test_analysis.py"), encoding="utf-8") as fh:
        tree = ast.parse(fh.read())
    classes = {c: code for code, names in FIXTURE_CLASSES.items() for c in names}
    out = {code: [] for code in FIXTURE_CLASSES}
    for cls in tree.body:
        if not (isinstance(cls, ast.ClassDef) and cls.name in classes):
            continue
        code = classes[cls.name]
        consts = {t.id: _literal(s.value) for s in cls.body if isinstance(s, ast.Assign)
                  for t in s.targets if isinstance(t, ast.Name)}
        for fn in cls.body:
            if not (isinstance(fn, ast.FunctionDef) and fn.name.startswith("test_")):
                continue
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Name)
                        and call.args):
                    continue
                first = call.args[0]
                value = (consts.get(first.attr) if isinstance(first, ast.Attribute)
                         and isinstance(first.value, ast.Name) and first.value.id == "self"
                         else _literal(first))
                if call.func.id == "run" and isinstance(value, str):
                    path = next((_literal(k.value) for k in call.keywords if k.arg == "path"),
                                "fx/mod.py")
                    out[code].append((fn.name, {path: value}))
                elif call.func.id == "analyze_sources" and isinstance(value, dict):
                    out[code].append((fn.name, value))
    return out


@pytest.fixture(scope="module")
def fixture_reports(jaxlint_dialect):
    out = {}
    for code, cases in fixture_sources().items():
        rows = []
        for name, sources in cases:
            jax = jax_engine.analyze_sources(sources, rules=[JAX_RULES[code]])
            port = torch_engine.analyze_sources(sources, rules=[TORCH_RULES[code]])
            rows.append((name, jax, port))
        out[code] = rows
    return out


@pytest.mark.parametrize("code", SHARED_CODES)
def test_jax_tree_findings_are_identical(jax_tree, code):
    jax, port = jax_tree
    assert jax.files == port.files > 100
    assert _by_code(_partition(port), code) == _by_code(_partition(jax), code)


def test_jax_tree_baseline_entries_match_in_both():
    # the JAX baseline's three JG026 entries are real positives, baselined
    # by both analyzers alike (the per-rule cases above hold the rows equal)
    entries = jax_engine.load_baseline()
    assert [e["rule"] for e in entries] == ["JG026"] * 3
    assert torch_engine.load_baseline(jax_engine.DEFAULT_BASELINE_PATH) == entries


@pytest.mark.parametrize("code", SHARED_CODES)
def test_port_tree_findings_are_identical(port_tree, code):
    jax, port = port_tree
    assert jax.files == port.files > 100
    assert _by_code(_partition(port), code) == _by_code(_partition(jax), code)


@pytest.mark.parametrize("code", SHARED_CODES)
def test_fixture_findings_are_identical(fixture_reports, code):
    rows = fixture_reports[code]
    positives = [name for name, jax, _ in rows if jax.active]
    negatives = [name for name, jax, _ in rows if not jax.active and not jax.suppressed]
    # every shared rule keeps at least one source it fires on and one it
    # stays silent on
    assert positives and negatives, (positives, negatives)
    for name, jax, port in rows:
        assert _partition(port) == _partition(jax), name
