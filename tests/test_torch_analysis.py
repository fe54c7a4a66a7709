"""torchlint, the port's static analyzer (``gan_deeplearning4j_tpu_torch/analysis``).

- hygiene: importing it, or running its CLI, loads no torch, no jax and
  nothing of the JAX package;
- the engine against the JAX analyzer's, through both CLIs on the same
  temporary trees (suppressions, the baseline's migration, staleness and
  pruning, JSON and SARIF, ``--changed-only``, ``--fix``, ``--fix-suppress``,
  the parse cache): the same exit codes and output, the tool's name apart;
- ten of the 18 torch counterparts: a true positive and a true negative
  each, showing the hazard in torch code (the other eight, the flow rules,
  are in ``tests/test_torch_analysis_flow.py``); a coverage test holds
  every code of the registry to both (the 14 shared rules' fixtures are the
  JAX package's, run by ``tests/test_torch_analysis_parity.py``);
- the clean tree: no active finding and no suppression over the port,
  ``chip_smoke.py`` and the analyzer's own package;
- ``analysis/lint_gate.sh``.

Every true positive is the shape of a hazard the port met or guards
against (``analysis/CATALOGUE.md``); every true negative is the port's own
idiom.
"""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest

from gan_deeplearning4j_tpu.analysis.__main__ import main as jax_main
from gan_deeplearning4j_tpu_torch.analysis import (
    DEFAULT_BASELINE_PATH,
    RULES,
    analyze_paths,
    analyze_sources,
    load_baseline,
)
from gan_deeplearning4j_tpu_torch.analysis import fix as fix_mod
from gan_deeplearning4j_tpu_torch.analysis.__main__ import main as torch_main
from gan_deeplearning4j_tpu_torch.analysis.rules import RULES_BY_CODE, SHARED_CODES
from test_torch_analysis_flow import FLOW_COUNTERPARTS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = os.path.join(REPO, "gan_deeplearning4j_tpu_torch", "analysis")
HEADER = ("import time\n"
          "import torch\n"
          "from gan_deeplearning4j_tpu_torch.runtime.capture import capture_guard\n")


def codes(report):
    return [f.code for f in report.active]


def run(src, path="fx/mod.py"):
    return analyze_sources({path: src})


# ===========================================================================
# hygiene
# ===========================================================================

class TestHygiene:
    FORBIDDEN = ("torch", "jax", "gan_deeplearning4j_tpu")

    def test_import_and_cli_load_no_accelerator_stack(self):
        proc = subprocess.run(
            [sys.executable, "-c",
             "import sys\n"
             "import gan_deeplearning4j_tpu_torch.analysis as a\n"
             "from gan_deeplearning4j_tpu_torch.analysis.__main__ import main\n"
             "r = a.analyze_sources({'p.py': 'def f(x):\\n    assert x\\n'})\n"
             "rc = main(['--list-rules'])\n"
             "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
             f"{self.FORBIDDEN!r})\n"
             "print(len(r.active), rc, bad)"],
            capture_output=True, text=True, cwd=REPO,
        )
        assert proc.returncode == 0, proc.stderr
        assert proc.stdout.strip().splitlines()[-1] == "1 0 []"

    def test_module_cli_lists_every_rule_without_torch(self):
        proc = subprocess.run(
            [sys.executable, "-c",
             "import runpy, sys\n"
             "sys.modules['torch'] = None\nsys.modules['jax'] = None\n"
             "sys.argv = ['torchlint', '--list-rules']\n"
             "runpy.run_module('gan_deeplearning4j_tpu_torch.analysis', run_name='__main__')"],
            capture_output=True, text=True, cwd=REPO,
        )
        # run_module exits through sys.exit(main()): 0 with every code listed
        assert proc.returncode == 0, proc.stderr
        listed = [line.split()[0] for line in proc.stdout.splitlines()]
        assert listed == [r.code for r in RULES]

    def test_no_source_imports_the_accelerator_stack(self):
        offenders = []
        for dirpath, _, files in os.walk(PACKAGE):
            for name in files:
                if not name.endswith(".py"):
                    continue
                path = os.path.join(dirpath, name)
                with open(path, encoding="utf-8") as fh:
                    tree = ast.parse(fh.read())
                for node in ast.walk(tree):
                    names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                             else [node.module or ""] if isinstance(node, ast.ImportFrom)
                             else [])
                    offenders += [f"{path}:{node.lineno} {n}" for n in names
                                  if n.split(".")[0] in self.FORBIDDEN]
        assert offenders == []

    def test_registry_is_fourteen_shared_and_ten_counterparts(self):
        # and the eight flow counterparts: 18 in all
        assert len(SHARED_CODES) == 14 and len(COUNTERPARTS) == 18
        assert set(SHARED_CODES) <= set(RULES_BY_CODE)
        assert sorted(set(RULES_BY_CODE) - set(SHARED_CODES)) == sorted(COUNTERPARTS)


# ===========================================================================
# the engine, against the JAX analyzer's, through both CLIs
# ===========================================================================

DIRTY = ("import urllib.request\n"
         "MAX = 10\n"
         "def emit(line):\n"
         "    assert len(line) < MAX, 'oversize'\n"
         "    return line\n"
         "def probe(url):\n"
         "    return urllib.request.urlopen(url).read()\n")
ASSERT_ONLY = ("MAX = 10\n"
               "def emit(line):\n"
               "    assert len(line) < MAX, 'oversize'\n"
               "    return line\n")
SUPPRESSED = ("def check(x):\n"
              "    assert x  # {tool}: disable=JG003 -- a fixture asserts on purpose\n"
              "    assert x  # {tool}: disable=JG999\n"
              "    return x\n")
SHARED = "JG003,JG017"


class _Pair:
    """One temp tree per CLI, byte-identical but for the suppression
    comments' tool name, and both CLIs run in-process."""

    def __init__(self, tmp_path, monkeypatch, capsys, files):
        self.monkeypatch, self.capsys = monkeypatch, capsys
        self.dirs = {"jax": tmp_path / "jax", "torch": tmp_path / "torch"}
        for tool, root in self.dirs.items():
            root.mkdir()
            for name, text in files.items():
                (root / name).write_text(text.replace("{tool}", f"{tool}lint"))

    def run(self, tool, *argv):
        self.monkeypatch.chdir(self.dirs[tool])
        try:
            rc = (jax_main if tool == "jax" else torch_main)(list(argv))
        except SystemExit as exc:  # argparse's usage errors
            rc = exc.code
        out, err = self.capsys.readouterr()
        return rc, self.norm(out), self.norm(err)

    def norm(self, text):
        for root in self.dirs.values():
            text = text.replace(str(root), "<tree>")
        return (text.replace("jaxlint", "torchlint")
                .replace("gan_deeplearning4j_tpu.analysis",
                         "gan_deeplearning4j_tpu_torch.analysis"))

    def both(self, *argv):
        jax, port = self.run("jax", *argv), self.run("torch", *argv)
        assert port == jax
        return port

    def read(self, name):
        texts = {tool: (root / name).read_text().replace(f"{tool}lint", "torchlint")
                 for tool, root in self.dirs.items()}
        assert texts["torch"] == texts["jax"]
        return texts["torch"]


@pytest.fixture
def pair(tmp_path, monkeypatch, capsys):
    return lambda files: _Pair(tmp_path, monkeypatch, capsys, files)


class TestEngineParity:
    def test_findings_suppression_and_unknown_code(self, pair):
        p = pair({"prod.py": DIRTY, "supp.py": SUPPRESSED})
        rc, out, err = p.both("--no-baseline", "--rules", SHARED, ".")
        assert rc == 1
        assert "prod.py:4:4: JG003" in out and "prod.py:7:11: JG017" in out
        assert "suppression names unknown rule code 'JG999'" in out
        assert "# torchlint: 2 files, 3 active, 1 suppressed, 0 baselined" in out

    def test_json_and_sarif(self, pair):
        # a suppression comment names its tool, so its line's fingerprint
        # differs by design: JSON and SARIF are compared on prod.py alone
        p = pair({"prod.py": DIRTY})
        rc, out, _ = p.both("--no-baseline", "--rules", SHARED, "--format", "json", ".")
        assert rc == 1 and len(json.loads(out)["active"]) == 2
        sarif = {}
        for tool in ("jax", "torch"):
            rc, out, _ = p.run(tool, "--no-baseline", "--rules", SHARED, "--format", "sarif", ".")
            assert rc == 1
            sarif[tool] = json.loads(out)
            sarif[tool]["runs"][0]["tool"]["driver"].pop("informationUri")
        assert sarif["torch"] == sarif["jax"]
        fps = [r["partialFingerprints"] for r in sarif["torch"]["runs"][0]["results"]]
        assert all(set(fp) == {"torchlint/v1"} for fp in fps) and len(fps) == 2

    def test_baseline_migration_staleness_and_prune(self, pair):
        finding = analyze_sources({"prod.py": ASSERT_ONLY}).active[0]
        legacy = {"entries": [
            {"fingerprint": finding.legacy_fingerprint, "rule": "JG003", "path": "prod.py",
             "justification": "a v1 entry"},
            {"fingerprint": "deadbeefdeadbeef", "rule": "JG003", "path": "prod.py",
             "justification": "fixed long ago"}]}
        p = pair({"prod.py": ASSERT_ONLY, "baseline.json": json.dumps(legacy)})
        rc, out, err = p.both("--baseline", "baseline.json", "--rules", SHARED, "prod.py")
        # the v1 entry matches and migrates to v2; the stale one fails the gate
        assert rc == 1 and "migrated 1 baseline entry" in err
        assert "stale baseline entry deadbeefdeadbeef" in out
        assert "0 active, 0 suppressed, 1 baselined" in out
        migrated = json.loads(p.read("baseline.json"))["entries"]
        assert migrated[0]["fingerprint"] == finding.fingerprint != finding.legacy_fingerprint
        rc, out, err = p.both("--baseline", "baseline.json", "--rules", SHARED,
                              "--prune-baseline", "prod.py")
        assert rc == 0 and "pruned 1 stale baseline entry" in err
        assert [e["justification"] for e in json.loads(p.read("baseline.json"))["entries"]] \
            == ["a v1 entry"]

    def test_baseline_entry_without_justification_is_refused(self, pair):
        bad = {"entries": [{"fingerprint": "0123456789abcdef", "rule": "JG003"}]}
        p = pair({"prod.py": DIRTY, "baseline.json": json.dumps(bad)})
        rc, _, err = p.both("--baseline", "baseline.json", "prod.py")
        assert rc == 2 and "justification" in err

    def test_changed_only(self, pair):
        p = pair({"prod.py": DIRTY})
        # not a git checkout: the gate cannot see the diff and fails loudly
        rc, _, err = p.both("--changed-only", "--rules", SHARED, ".")
        assert rc == 2 and "needs a usable git checkout" in err
        for root in p.dirs.values():
            git = ["git", "-C", str(root), "-c", "user.name=t", "-c", "user.email=t@t"]
            subprocess.run(git[:3] + ["init", "-q"], check=True)
            subprocess.run(git + ["add", "-A"], check=True)
            subprocess.run(git + ["commit", "-q", "-m", "seed"], check=True)
        rc, out, err = p.both("--changed-only", "--rules", SHARED, ".")
        assert rc == 0 and "no changed .py files" in err
        for root in p.dirs.values():
            (root / "prod.py").write_text(DIRTY + "def more(x):\n    assert x\n")
        rc, out, _ = p.both("--changed-only", "--rules", SHARED, ".")
        assert rc == 1 and "prod.py:9:4: JG003" in out

    def test_fix_on_jg003_is_idempotent(self, pair):
        p = pair({"prod.py": DIRTY})
        rc, _, err = p.both("--no-baseline", "--rules", "JG003", "--fix", "prod.py")
        assert rc == 0 and "rewrote 1" in err
        once = p.read("prod.py")
        assert "raise AssertionError('oversize')" in once
        rc, _, err = p.both("--no-baseline", "--rules", "JG003", "--fix", "prod.py")
        assert rc == 0 and "rewrote 0" in err and p.read("prod.py") == once

    def test_fix_suppress(self, pair):
        p = pair({"prod.py": DIRTY})
        # argparse wraps its usage lines by the program name's length
        usage = [p.run(tool, "--no-baseline", "--fix-suppress", "prod.py") for tool in p.dirs]
        assert [(rc, err.splitlines()[-1]) for rc, _, err in usage] == [
            (2, "python -m gan_deeplearning4j_tpu_torch.analysis: error: --fix-suppress "
                "requires --justification (a suppression must say why)")] * 2
        rc, out, _ = p.both("--no-baseline", "--rules", SHARED, "--fix-suppress",
                            "--justification", "fixture", "prod.py")
        assert rc == 0 and "0 active, 2 suppressed" in out
        assert p.read("prod.py").count("# torchlint: disable=") == 2

    def test_parse_cache_hits_on_a_second_pass(self, pair, tmp_path):
        p = pair({"prod.py": DIRTY, "supp.py": SUPPRESSED})
        outs = []
        for attempt in range(2):
            for tool in ("jax", "torch"):
                cache = tmp_path / f"cache_{tool}"
                rc, out, err = p.run(tool, "--no-baseline", "--rules", SHARED, "--profile",
                                     "--cache-dir", str(cache), ".")
                hits = re.search(r"cache hits (\d+) / misses (\d+)", err).groups()
                outs.append((tool, attempt, rc, out, hits))
        by = {(t, a): (rc, out, hits) for t, a, rc, out, hits in outs}
        assert by[("torch", 0)] == by[("jax", 0)] and by[("torch", 0)][2] == ("0", "2")
        assert by[("torch", 1)] == by[("jax", 1)] and by[("torch", 1)][2] == ("2", "0")

    def test_a_code_only_the_jax_registry_has_is_unknown_here(self):
        # the registries hold the same codes: a code neither has is unknown
        # to both engines, in the same words but the tool's name; a code
        # both have is known to both
        from gan_deeplearning4j_tpu.analysis import analyze_sources as jax_sources

        src = "def f(x):\n    return x  # {tool}: disable={code}\n"
        for code, known in (("JG099", False), ("JG010", True), ("JG005", True)):
            port = run(src.format(tool="torchlint", code=code)).warnings
            jax = jax_sources({"fx/mod.py": src.format(tool="jaxlint", code=code)}).warnings
            assert [w.replace("jaxlint", "torchlint") for w in jax] == port
            assert any(f"unknown rule code '{code}'" in w for w in port) is not known

    def test_cache_variable_is_torchlints_own(self, monkeypatch, tmp_path, capsys):
        (tmp_path / "prod.py").write_text(DIRTY)
        monkeypatch.chdir(tmp_path)
        monkeypatch.setenv("TORCHLINT_CACHE_DIR", str(tmp_path / "cache"))
        monkeypatch.delenv("JAXLINT_CACHE_DIR", raising=False)
        torch_main(["--no-baseline", "--profile", "prod.py"])
        assert "cache hits 0 / misses 1" in capsys.readouterr().err


# ===========================================================================
# JG005 — host sync inside a capture
# ===========================================================================

class TestHostSyncInCapture:
    def test_true_positive_item_in_graph_body(self):
        # (aa2)'s true positive: on the card the capture dies with
        # "operation not permitted when stream is capturing"
        r = run(HEADER +
                "def capture(x):\n"
                "    graph = torch.cuda.CUDAGraph()\n"
                "    with capture_guard(), torch.cuda.graph(graph):\n"
                "        y = x * 2\n"
                "        n = y.sum().item()\n"
                "    return graph, y, n\n")
        assert codes(r) == ["JG005"]
        assert ".item()" in r.active[0].message

    def test_true_positive_pinned_alloc_between_begin_and_end(self):
        # the serving engine's spelling of a capture; a pinned host buffer
        # made inside it is a cudaHostAlloc, which ends the capture
        r = run(HEADER +
                "def capture(graph, x):\n"
                "    with capture_guard():\n"
                "        graph.capture_begin()\n"
                "        try:\n"
                "            y = x + 1\n"
                "            host = torch.empty(y.shape, pin_memory=True)\n"
                "        finally:\n"
                "            graph.capture_end()\n"
                "    return y, host\n")
        assert codes(r) == ["JG005"]
        assert "pinned" in r.active[0].message

    def test_true_positive_gc_collect_in_a_callee_a_module_away(self):
        # the PR 7 incident's shape: a helper the captured body calls
        # collects garbage, destroying another graph mid-capture
        r = analyze_sources({
            "fx/helpers.py": "import gc\n"
                             "def forward(model, x):\n"
                             "    gc.collect()\n"
                             "    return model(x)\n",
            "fx/cap.py": HEADER +
                         "from fx.helpers import forward\n"
                         "def capture(model, x):\n"
                         "    graph = torch.cuda.CUDAGraph()\n"
                         "    with capture_guard(), torch.cuda.graph(graph):\n"
                         "        y = forward(model, x)\n"
                         "    return graph, y\n",
        })
        assert codes(r) == ["JG005"]
        assert r.active[0].path == "fx/helpers.py"
        assert "runs inside the capture at fx/cap.py:7" in r.active[0].message

    def test_true_positive_capture_outside_the_guard(self):
        r = run(HEADER +
                "def capture(x):\n"
                "    graph = torch.cuda.CUDAGraph()\n"
                "    with torch.cuda.graph(graph):\n"
                "        y = x * 2\n"
                "    return graph, y\n")
        assert codes(r) == ["JG005"]
        assert "capture_guard" in r.active[0].message

    def test_true_negative_read_after_the_replay(self):
        r = run(HEADER +
                "def capture(x):\n"
                "    graph = torch.cuda.CUDAGraph()\n"
                "    with capture_guard(), torch.cuda.graph(graph):\n"
                "        y = x * 2\n"
                "        total = y.sum()\n"
                "    graph.replay()\n"
                "    print(total.item())\n"
                "    return graph\n")
        assert codes(r) == []

    def test_true_negative_pinned_buffer_made_before_the_capture(self):
        # serving/engine.py: the pinned host buffer is allocated per launch,
        # outside capture_begin/capture_end
        r = run(HEADER +
                "def capture(graph, x):\n"
                "    host = torch.empty(x.shape, pin_memory=True)\n"
                "    with capture_guard():\n"
                "        graph.capture_begin()\n"
                "        try:\n"
                "            y = x + 1\n"
                "        finally:\n"
                "            graph.capture_end()\n"
                "    torch.cuda.synchronize()\n"
                "    return y, host\n")
        assert codes(r) == []


# ===========================================================================
# JG006 — static buffer read after a replay
# ===========================================================================

class TestStaticBufferReadAfterReplay:
    def test_true_positive_alias_read_after_a_later_replay(self):
        # (aa2)'s true positive: on the card `a` reads 6 where 2 was meant
        r = run(HEADER +
                "def run(x):\n"
                "    graph = torch.cuda.CUDAGraph()\n"
                "    with capture_guard(), torch.cuda.graph(graph):\n"
                "        y = x * 2\n"
                "    x.fill_(1)\n"
                "    graph.replay()\n"
                "    a = y\n"
                "    x.fill_(3)\n"
                "    graph.replay()\n"
                "    return float(a[0])\n")
        assert codes(r) == ["JG006"]
        assert "`a` aliases `graph`'s static output `y`" in r.active[0].message

    def test_true_positive_view_alias_through_capture_begin(self):
        r = run(HEADER +
                "def run(graph, x, outs):\n"
                "    with capture_guard():\n"
                "        graph.capture_begin()\n"
                "        y = x + 1\n"
                "        graph.capture_end()\n"
                "    graph.replay()\n"
                "    first = y[:1].view(-1)\n"
                "    graph.replay()\n"
                "    outs.append(first)\n")
        assert codes(r) == ["JG006"]

    def test_true_negative_clone_at_bind_time(self):
        r = run(HEADER +
                "def run(x):\n"
                "    graph = torch.cuda.CUDAGraph()\n"
                "    with capture_guard(), torch.cuda.graph(graph):\n"
                "        y = x * 2\n"
                "    graph.replay()\n"
                "    a = y.clone()\n"
                "    graph.replay()\n"
                "    return float(a[0]), float(y[0])\n")
        assert codes(r) == []

    def test_true_negative_copy_into_own_buffer_under_the_replay(self):
        # serving/engine.py::_launch: host.copy_(cap.y) right after replay()
        r = run(HEADER +
                "def run(graph, x, y, rows):\n"
                "    outs = []\n"
                "    for row in rows:\n"
                "        x.copy_(row)\n"
                "        graph.replay()\n"
                "        host = torch.empty(y.shape)\n"
                "        host.copy_(y)\n"
                "        outs.append(host)\n"
                "    return outs\n")
        assert codes(r) == []


# ===========================================================================
# JG004 — recapture hazard
# ===========================================================================

class TestRecaptureHazard:
    def test_true_positive_capture_in_a_loop(self):
        # (aa2)'s true positive: 4 graphs, memory_reserved rising each time
        r = run(HEADER +
                "def run(x):\n"
                "    graphs = []\n"
                "    for _ in range(4):\n"
                "        graph = torch.cuda.CUDAGraph()\n"
                "        with capture_guard(), torch.cuda.graph(graph):\n"
                "            y = x * 2\n"
                "        graph.replay()\n"
                "        graphs.append(graph)\n"
                "    return graphs\n")
        assert codes(r) == ["JG004", "JG004"]

    def test_true_positive_keyed_by_the_input_shape(self):
        r = run(HEADER +
                "class Runner:\n"
                "    def __init__(self, fn):\n"
                "        self.fn, self._graphs = fn, {}\n"
                "    def capture(self, x):\n"
                "        key = (x.shape[0], x.dtype)\n"
                "        graph = torch.cuda.CUDAGraph()\n"
                "        with capture_guard(), torch.cuda.graph(graph):\n"
                "            y = self.fn(x)\n"
                "        self._graphs[key] = graph\n"
                "        return y\n")
        assert codes(r) == ["JG004"]
        assert "x.shape[0]" in r.active[0].message

    def test_true_negative_capture_once_replay_in_the_loop(self):
        r = run(HEADER +
                "def run(x):\n"
                "    graph = torch.cuda.CUDAGraph()\n"
                "    with capture_guard(), torch.cuda.graph(graph):\n"
                "        y = x * 2\n"
                "    for _ in range(4):\n"
                "        graph.replay()\n"
                "    return y\n")
        assert codes(r) == []

    def test_true_negative_cached_in_the_loop_and_keyed_by_bucket(self):
        # harness/graphs.py (`if entry.graph is None`) and serving/engine.py
        # (graphs keyed by kind, bucket and replica)
        r = run(HEADER +
                "class Runner:\n"
                "    def __init__(self, ladder):\n"
                "        self.ladder, self._graphs = ladder, {}\n"
                "    def run(self, entries):\n"
                "        for entry in entries:\n"
                "            if entry.graph is None:\n"
                "                entry.graph = torch.cuda.CUDAGraph()\n"
                "            entry.graph.replay()\n"
                "    def capture(self, kind, x):\n"
                "        bucket = next(b for b in self.ladder if b >= len(x))\n"
                "        graph = torch.cuda.CUDAGraph()\n"
                "        self._graphs[(kind, bucket)] = graph\n"
                "        return graph\n")
        assert codes(r) == []


# ===========================================================================
# JG002 — stale or missing fence
# ===========================================================================

class TestStaleOrMissingFence:
    def test_true_positive_matmuls_timed_without_a_fence(self):
        # (aa2)'s true positive: the delta reads 2.0 ms over 53 ms of work
        r = run(HEADER +
                "def run(a, b):\n"
                "    t0 = time.perf_counter()\n"
                "    for _ in range(20):\n"
                "        c = a @ b\n"
                "    return time.perf_counter() - t0, c\n")
        assert codes(r) == ["JG002"]

    def test_true_positive_replays_timed_by_two_clock_reads(self):
        r = run(HEADER +
                "def time_replay(graph, runs):\n"
                "    t0 = time.perf_counter()\n"
                "    for _ in range(runs):\n"
                "        graph.replay()\n"
                "    t1 = time.perf_counter()\n"
                "    return (t1 - t0) / runs\n")
        assert codes(r) == ["JG002"]

    def test_true_positive_stale_fence_in_the_timed_loop(self):
        r = run(HEADER +
                "def bench(step, x, runs):\n"
                "    out = step(x)\n"
                "    times = []\n"
                "    for _ in range(runs):\n"
                "        t0 = time.perf_counter()\n"
                "        step(x)\n"
                "        out.sum().item()\n"
                "        times.append(time.perf_counter() - t0)\n"
                "    return times\n")
        assert codes(r) == ["JG002"]
        assert "stale value" in r.active[0].message

    def test_true_negative_synchronize_before_the_second_read(self):
        # (aa2)'s true negative: the fenced delta reads the work's 53 ms
        r = run(HEADER +
                "def run(a, b):\n"
                "    t0 = time.perf_counter()\n"
                "    for _ in range(20):\n"
                "        c = a @ b\n"
                "    torch.cuda.synchronize()\n"
                "    return time.perf_counter() - t0, c\n")
        assert codes(r) == []

    def test_true_negative_fence_on_this_iterations_output(self):
        r = run(HEADER +
                "def bench(step, graph, loss, runs):\n"
                "    times = []\n"
                "    for _ in range(runs):\n"
                "        t0 = time.perf_counter()\n"
                "        graph.replay()\n"
                "        value = loss.item()\n"
                "        out = step(value)\n"
                "        out.cpu()\n"
                "        times.append(time.perf_counter() - t0)\n"
                "    return times\n")
        assert codes(r) == []

    def test_true_negative_bool_of_a_reduction_is_the_fence(self):
        # zoo/drill.py::train_conditional: all() reads each tensor's truth
        # value on the host before the second clock read
        r = run(HEADER +
                "def train(exp, feats, labels):\n"
                "    t0 = time.perf_counter()\n"
                "    losses = exp.train_iterations(feats, labels)\n"
                "    finite = bool(all(torch.isfinite(v).all() for v in losses.values()))\n"
                "    return finite, time.perf_counter() - t0\n")
        assert codes(r) == []

    def test_true_negative_fence_through_a_callee_and_host_work(self):
        r = analyze_sources({
            "fx/sync.py": "import torch\n"
                          "def wait(stream):\n"
                          "    stream.synchronize()\n",
            "fx/bench.py": HEADER +
                           "import json\n"
                           "from fx.sync import wait\n"
                           "def run(graph, stream, rows):\n"
                           "    t0 = time.perf_counter()\n"
                           "    graph.replay()\n"
                           "    wait(stream)\n"
                           "    dt = time.perf_counter() - t0\n"
                           "    t1 = time.perf_counter()\n"
                           "    text = json.dumps(rows)\n"
                           "    return dt, time.perf_counter() - t1, text\n",
        })
        assert codes(r) == []


# ===========================================================================
# JG015 — unfenced delta fed to a telemetry sink
# ===========================================================================

class TestTelemetryUnfencedTiming:
    def test_true_positive_replay_delta_observed(self):
        r = run(HEADER +
                "def serve(graph, hist):\n"
                "    t0 = time.perf_counter()\n"
                "    graph.replay()\n"
                "    hist.observe(time.perf_counter() - t0)\n")
        # JG002 names the window, JG015 the metric it poisons
        assert codes(r) == ["JG002", "JG015"]
        assert [f.line for f in r.active] == [7, 7]

    def test_true_positive_project_launch_through_a_named_delta(self):
        r = analyze_sources({
            "fx/model.py": "import torch\n"
                           "def forward(w, x):\n"
                           "    return torch.relu(x @ w)\n",
            "fx/serve.py": HEADER +
                           "from fx.model import forward\n"
                           "def handle(w, x, stats):\n"
                           "    t0 = time.perf_counter()\n"
                           "    y = forward(w, x)\n"
                           "    dt = time.perf_counter() - t0\n"
                           "    stats.add('device', dt)\n"
                           "    return y\n",
        })
        assert codes(r) == ["JG002", "JG015"]
        assert r.active[1].line == 9

    def test_true_negative_fenced_before_the_second_read(self):
        r = run(HEADER +
                "def serve(graph, event, hist):\n"
                "    t0 = time.perf_counter()\n"
                "    graph.replay()\n"
                "    event.record()\n"
                "    event.synchronize()\n"
                "    hist.observe(time.perf_counter() - t0)\n")
        assert codes(r) == []

    def test_true_negative_host_work_and_plain_dicts(self):
        r = analyze_sources({
            "fx/store.py": "import os\n"
                           "def publish(path):\n"
                           "    with open(path, 'w') as fh:\n"
                           "        fh.write('x')\n"
                           "        os.fsync(fh.fileno())\n",
            "fx/serve.py": HEADER +
                           "from fx.store import publish\n"
                           "def run(graph, path, hist, summary):\n"
                           "    t0 = time.perf_counter()\n"
                           "    publish(path)\n"
                           "    hist.observe(time.perf_counter() - t0)\n"
                           "    t1 = time.perf_counter()\n"
                           "    graph.replay()\n"
                           "    torch.cuda.synchronize()\n"
                           "    summary['device'] = time.perf_counter() - t1\n",
        })
        assert codes(r) == []


# ===========================================================================
# JG001 — generator reuse
# ===========================================================================

class TestGeneratorReuse:
    def test_true_positive_twin_generators_from_one_seed(self):
        # z_fake == z_gan: the discriminator and the generator phases see
        # the same latents forever
        r = run("import torch\n"
                "def latents(seed, n, z):\n"
                "    g_dis = torch.Generator().manual_seed(seed)\n"
                "    g_gen = torch.Generator().manual_seed(seed)\n"
                "    z_fake = torch.randn(n, z, generator=g_dis)\n"
                "    z_gan = torch.randn(n, z, generator=g_gen)\n"
                "    return z_fake, z_gan\n")
        assert codes(r) == ["JG001"]
        assert r.active[0].line == 4

    def test_true_positive_two_generator_objects_seeded_alike(self):
        r = run("import torch\n"
                "def draws(seed, n):\n"
                "    a = torch.Generator()\n"
                "    a.manual_seed(seed)\n"
                "    b = torch.Generator()\n"
                "    b.manual_seed(seed)\n"
                "    return torch.rand(n, generator=a), torch.rand(n, generator=b)\n")
        assert codes(r) == ["JG001"]

    def test_true_positive_reseeded_in_the_loop(self):
        r = run("import torch\n"
                "def noise(seed, steps, n):\n"
                "    out = []\n"
                "    for step in range(steps):\n"
                "        g = torch.Generator().manual_seed(seed)\n"
                "        out.append(torch.randn(n, generator=g))\n"
                "    for step in range(steps):\n"
                "        torch.manual_seed(0)\n"
                "        out.append(torch.randn(n))\n"
                "    return out\n")
        assert codes(r) == ["JG001", "JG001"]

    def test_true_negative_one_generator_for_every_draw(self):
        # nn/graph.py::init and parallel/drill.py (one seed on every rank
        # on purpose: one generator per process)
        r = run("import torch\n"
                "def init(shapes, seed):\n"
                "    generator = torch.Generator().manual_seed(seed)\n"
                "    return [torch.randn(s, generator=generator) for s in shapes]\n"
                "def same_tree_on_every_rank(shapes):\n"
                "    g = torch.Generator().manual_seed(0)\n"
                "    return [torch.randn(s, generator=g) for s in shapes]\n")
        assert codes(r) == []

    def test_true_negative_distinct_seeds_and_step_keyed_generators(self):
        # harness/experiment.py::step_generator: one generator per
        # (seed, step), the step mixed into the seed
        r = run("import numpy as np\n"
                "import torch\n"
                "def latents(seed, n, z):\n"
                "    g_dis = torch.Generator().manual_seed(seed)\n"
                "    g_gen = torch.Generator().manual_seed(seed + 1)\n"
                "    return torch.randn(n, z, generator=g_dis), torch.randn(n, z, generator=g_gen)\n"
                "def noise(seed, steps, n):\n"
                "    out = []\n"
                "    for step in range(steps):\n"
                "        state = np.random.SeedSequence([seed, step]).generate_state(1)[0]\n"
                "        g = torch.Generator().manual_seed(int(state))\n"
                "        out.append(torch.randn(n, generator=g))\n"
                "    return out\n")
        assert codes(r) == []


# ===========================================================================
# JG008 — weak-scalar drift
# ===========================================================================

class TestWeakScalarDrift:
    def test_the_drift_is_real(self):
        # jnp rounds a Python scalar to a bf16 operand's dtype; torch keeps
        # it in full precision and rounds the product only
        import torch

        from gan_deeplearning4j_tpu_torch.runtime.dtype import weak_scalar

        x = torch.linspace(1, 2, 1000).to(torch.bfloat16)
        assert weak_scalar(0.99, torch.bfloat16) == 0.98828125
        differ = int((x * 0.99 != x * weak_scalar(0.99, torch.bfloat16)).sum())
        assert differ == 445

    def test_true_positive_literal_in_an_updater_rule(self):
        r = run("import dataclasses\n"
                "import torch\n"
                "from fx.updaters import UpdaterSpec\n"
                "@dataclasses.dataclass(frozen=True)\n"
                "class Momentum(UpdaterSpec):\n"
                "    def apply_group(self, states, grads, params):\n"
                "        vs = torch._foreach_mul([s['v'] for s in states], 0.9)\n"
                "        vs = torch._foreach_add(vs, grads)\n"
                "        return vs, [{'v': v} for v in vs]\n")
        assert codes(r) == ["JG008"]

    def test_true_positive_carry_in_the_compute_scope(self):
        r = run("import torch\n"
                "from gan_deeplearning4j_tpu_torch.runtime.dtype import compute_dtype_scope\n"
                "def smooth(params, steps):\n"
                "    ema = params.clone()\n"
                "    with compute_dtype_scope(torch.bfloat16):\n"
                "        for _ in range(steps):\n"
                "            ema = ema * 0.99 + params\n"
                "    return ema\n")
        assert codes(r) == ["JG008"]

    def test_true_positive_carry_in_a_captured_callee(self):
        r = run(HEADER +
                "def decay(state):\n"
                "    state *= 0.5\n"
                "    return state\n"
                "def capture(state):\n"
                "    graph = torch.cuda.CUDAGraph()\n"
                "    with capture_guard(), torch.cuda.graph(graph):\n"
                "        decay(state)\n"
                "    return graph\n")
        assert codes(r) == ["JG008"]
        assert "runs inside the capture" in r.active[0].message

    def test_true_negative_weak_scalar_and_pinned_literals(self):
        # optim/updaters.py and ops/norm.py: every scalar through weak_scalar
        r = run("import dataclasses\n"
                "import torch\n"
                "from gan_deeplearning4j_tpu_torch.runtime.dtype import weak_scalar as _w\n"
                "from gan_deeplearning4j_tpu_torch.runtime.dtype import compute_dtype_scope\n"
                "from fx.updaters import UpdaterSpec\n"
                "@dataclasses.dataclass(frozen=True)\n"
                "class RmsProp(UpdaterSpec):\n"
                "    rms_decay: float = 0.95\n"
                "    def apply_group(self, states, grads, params):\n"
                "        dt = grads[0].dtype\n"
                "        return torch._foreach_mul(grads, _w(1.0 - self.rms_decay, dt)), states\n"
                "def smooth(params, steps):\n"
                "    ema = params.clone()\n"
                "    with compute_dtype_scope(torch.bfloat16):\n"
                "        for _ in range(steps):\n"
                "            ema = ema * _w(0.99, ema.dtype) + params\n"
                "            ema = ema * torch.tensor(0.5, dtype=ema.dtype)\n"
                "            ema = ema * 2\n"
                "    return ema\n")
        assert codes(r) == []

    def test_true_negative_literal_outside_scope_and_updaters(self):
        r = run("import torch\n"
                "def loss(x):\n"
                "    x = x * 0.5\n"
                "    return x.mean() * 0.5\n")
        assert codes(r) == []


# ===========================================================================
# JG009 — host read in a timed region
# ===========================================================================

class TestHostReadInTimedRegion:
    def test_true_positive_a_read_per_iteration_in_a_helper(self):
        r = run(HEADER +
                "def log_loss(loss):\n"
                "    return loss.item()\n"
                "def bench(graph, loss, runs):\n"
                "    t0 = time.perf_counter()\n"
                "    for _ in range(runs):\n"
                "        graph.replay()\n"
                "        log_loss(loss)\n"
                "    torch.cuda.synchronize()\n"
                "    return time.perf_counter() - t0\n")
        assert codes(r) == ["JG009"]
        assert "in a loop inside" in r.active[0].message

    def test_true_positive_a_sync_a_module_away_mid_window(self):
        r = analyze_sources({
            "fx/drain.py": "import torch\n"
                           "def drain(x):\n"
                           "    torch.cuda.synchronize()\n"
                           "    return x\n",
            "fx/bench.py": HEADER +
                           "from fx.drain import drain\n"
                           "def bench(a, b):\n"
                           "    t0 = time.perf_counter()\n"
                           "    y = drain(a @ b)\n"
                           "    z = y @ b\n"
                           "    torch.cuda.synchronize()\n"
                           "    return time.perf_counter() - t0, z\n",
        })
        assert codes(r) == ["JG009"]
        assert "fx.drain.drain" in r.active[0].message

    def test_true_negative_the_windows_final_fence(self):
        r = run(HEADER +
                "def finish(out):\n"
                "    return out.cpu()\n"
                "def bench(graph, out):\n"
                "    t0 = time.perf_counter()\n"
                "    graph.replay()\n"
                "    host = finish(out)\n"
                "    return time.perf_counter() - t0, host\n")
        assert codes(r) == []

    def test_true_negative_a_phase_seconds_window(self):
        # chip_smoke.py's phase timers: the window holds no device work of
        # its own, only phases that read their results on the host
        r = run(HEADER +
                "def phase_a(x):\n"
                "    return x.sum().item()\n"
                "def main(x):\n"
                "    t0 = time.perf_counter()\n"
                "    for _ in range(3):\n"
                "        phase_a(x)\n"
                "    return time.perf_counter() - t0\n")
        assert codes(r) == []


# ===========================================================================
# JG007 — discarded out-of-place result
# ===========================================================================

class TestDiscardedOutOfPlace:
    def test_true_positive_add_on_a_tensor(self):
        r = run("import torch\n"
                "def step(n):\n"
                "    total = torch.zeros(n)\n"
                "    total.add(1)\n"
                "    return total\n")
        assert codes(r) == ["JG007"]
        assert "total = total.add(1)" in r.active[0].message

    def test_true_positive_tensor_only_methods_on_any_receiver(self):
        r = run("def mask(self, scores, pad):\n"
                "    scores.masked_fill(pad, -1e9)\n"
                "    self.buf.clamp(min=0)\n"
                "    return scores\n")
        assert codes(r) == ["JG007", "JG007"]

    def test_true_negative_rebound_in_place_and_other_types(self):
        r = run("import logging\n"
                "import torch\n"
                "def step(n, x: torch.Tensor):\n"
                "    total = torch.zeros(n)\n"
                "    total = total.add(1)\n"
                "    total.add_(1)\n"
                "    seen = set()\n"
                "    seen.add(n)\n"
                "    logging.getLogger('x').log(20, 'ok')\n"
                "    return total, x.clamp_(min=0)\n")
        assert codes(r) == []

    def test_fix_rebinds_and_is_idempotent(self, tmp_path):
        p = tmp_path / "prod.py"
        p.write_text("import torch\n"
                     "def step(self, n, pad):\n"
                     "    total = torch.zeros(n)\n"
                     "    total.add(1)\n"
                     "    self.scores.masked_fill(pad, 0.0)\n"
                     "    return total\n")
        report = analyze_paths([str(p)], root=str(tmp_path))
        assert codes(report) == ["JG007", "JG007"]
        result = fix_mod.apply_fixes(report, root=str(tmp_path))
        assert result.rewritten == 2
        fixed = p.read_text()
        assert "    total = total.add(1)\n" in fixed
        assert "    self.scores = self.scores.masked_fill(pad, 0.0)\n" in fixed
        again = fix_mod.apply_fixes(analyze_paths([str(p)], root=str(tmp_path)),
                                    root=str(tmp_path))
        assert again.rewritten == 0 and p.read_text() == fixed


# ===========================================================================
# JG030 — quantized-variant precision / cast mismatch
# ===========================================================================

class TestQuantPrecisionCastMismatch:
    def test_true_positive_declares_bf16_casts_half(self):
        r = run("import torch\n"
                "def build_variant(params, manifest):\n"
                "    manifest['precision'] = 'bf16'\n"
                "    return {k: v.half() for k, v in params.items()}, manifest\n")
        assert codes(r) == ["JG030"]

    def test_true_positive_int8_kwarg_with_uint8_dtype(self):
        r = run("import torch\n"
                "def build(w, write):\n"
                "    q = torch.empty(w.shape, dtype=torch.uint8)\n"
                "    return write(q, precision='int8')\n")
        assert codes(r) == ["JG030"]

    def test_true_negative_matching_casts(self):
        # quant/variants.py: int8 weights by .to(torch.int8), bf16 leaves
        # by cast_float_leaves(params, torch.bfloat16)
        r = run("import torch\n"
                "def int8_layer(w, scale):\n"
                "    w_q = torch.round(w / scale).to(torch.int8)\n"
                "    return {'W_q': w_q, 'precision': 'int8', 'b': w.to(torch.float32)}\n"
                "def bf16_variant(params, manifest):\n"
                "    manifest['precision'] = 'bf16'\n"
                "    return {k: v.to(torch.bfloat16) for k, v in params.items()}\n"
                "def copy_only(params):\n"
                "    return dict(params, precision='int8')\n")
        assert codes(r) == []


# ===========================================================================
# coverage, the chip's pairs, the clean tree, the gate script
# ===========================================================================

#: code -> the class holding its true positives and true negatives
COUNTERPARTS = {
    "JG001": TestGeneratorReuse, "JG002": TestStaleOrMissingFence,
    "JG004": TestRecaptureHazard, "JG005": TestHostSyncInCapture,
    "JG006": TestStaticBufferReadAfterReplay, "JG007": TestDiscardedOutOfPlace,
    "JG008": TestWeakScalarDrift, "JG009": TestHostReadInTimedRegion,
    "JG015": TestTelemetryUnfencedTiming, "JG030": TestQuantPrecisionCastMismatch,
    **FLOW_COUNTERPARTS,
}


def test_rules_all_have_fixture_coverage():
    # every counterpart has a true positive asserting it fires and a true
    # negative, here or in test_torch_analysis_flow.py; the shared codes'
    # fixtures are the JAX package's, run in test_torch_analysis_parity.py
    # for each code
    here = ""
    for name in (__file__, os.path.join(os.path.dirname(__file__), "test_torch_analysis_flow.py")):
        with open(name, encoding="utf-8") as fh:
            here += fh.read()
    assert len(RULES) == 32
    for rule in RULES:
        if rule.code in SHARED_CODES:
            continue
        cls = COUNTERPARTS[rule.code]
        names = [n for n in vars(cls) if n.startswith("test_")]
        assert any(n.startswith("test_true_positive") for n in names), rule.code
        assert any(n.startswith("test_true_negative") for n in names), rule.code
        assert f'"{rule.code}"]' in here, f"no fixture asserts {rule.code} fires"
    from test_torch_analysis_parity import FIXTURE_CLASSES

    assert tuple(FIXTURE_CLASSES) == SHARED_CODES


def test_the_chip_pairs_fire_and_stay_silent():
    # chip_smoke.py (aa2) runs these sources on the card; here, the
    # analyzer's half of each pair
    sys.path.insert(0, REPO)
    import chip_smoke

    for code, (tp, tn) in chip_smoke.AA_PAIRS.items():
        assert chip_smoke._aa_codes(code, tp) == code.split("+"), code
        assert chip_smoke._aa_codes(code, tn) == [], code


class TestTreeIsClean:
    def test_port_and_chip_smoke_are_clean_with_every_rule(self):
        report = analyze_paths(["gan_deeplearning4j_tpu_torch", "chip_smoke.py"],
                               baseline=load_baseline(), root=REPO)
        assert report.files > 100
        assert [f.render() for f in report.active] == []
        assert report.suppressed == [] and report.stale_baseline == []

    def test_analyzer_package_is_clean_by_itself(self):
        report = analyze_paths(["gan_deeplearning4j_tpu_torch/analysis"],
                               baseline=load_baseline(), root=REPO)
        assert [f.render() for f in report.active] == [] and report.suppressed == []

    def test_no_suppression_comment_in_the_port(self):
        hits = []
        for dirpath, _, files in os.walk(os.path.join(REPO, "gan_deeplearning4j_tpu_torch")):
            for name in files:
                if name.endswith(".py") and not dirpath.startswith(PACKAGE):
                    path = os.path.join(dirpath, name)
                    with open(path, encoding="utf-8") as fh:
                        hits += [path for line in fh if re.search(r"(torch|jax)lint:\s*disable",
                                                                 line)]
        with open(os.path.join(REPO, "chip_smoke.py"), encoding="utf-8") as fh:
            hits += ["chip_smoke.py" for line in fh if "lint: disable" in line]
        assert hits == []

    def test_checked_in_baseline_loads_and_every_entry_is_justified(self):
        entries = load_baseline()
        assert entries == [] or all(e["justification"].strip() for e in entries)
        assert DEFAULT_BASELINE_PATH.startswith(PACKAGE)


class TestLintGateScript:
    GATE = "gan_deeplearning4j_tpu_torch/analysis/lint_gate.sh"

    def _gate(self, *args, env=None):
        if shutil.which("bash") is None:  # pragma: no cover
            pytest.skip("no bash in container")
        return subprocess.run(["bash", self.GATE, *args], capture_output=True, text=True,
                              cwd=REPO, env={**os.environ, **(env or {})})

    def test_full_gate_fails_on_stale_baseline(self, tmp_path):
        bl = tmp_path / "stale.json"
        bl.write_text(json.dumps({"entries": [
            {"fingerprint": "deadbeefdeadbeef", "rule": "JG003", "path": "chip_smoke.py",
             "justification": "fixed long ago"}]}))
        proc = self._gate("--full", "--rules", "JG003", "--baseline", str(bl))
        assert proc.returncode == 1, proc.stdout + proc.stderr
        assert "stale baseline entry" in proc.stdout

    def test_profile_env_passthrough(self):
        proc = self._gate("--full", "--rules", "JG003", env={"LINT_PROFILE": "1"})
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "# torchlint --profile (wall seconds)" in proc.stderr
        assert "files" in proc.stdout

    def test_gate_wires_the_parse_cache(self, tmp_path):
        proc = self._gate("--full", "--rules", "JG003",
                          env={"LINT_PROFILE": "1", "TORCHLINT_CACHE_DIR": str(tmp_path)})
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "cache hits" in proc.stderr and os.listdir(tmp_path)

    def test_lint_cache_off_and_sarif(self, tmp_path):
        proc = self._gate("--full", "--rules", "JG003",
                          env={"LINT_PROFILE": "1", "LINT_CACHE": "off", "LINT_FORMAT": "sarif",
                               "TORCHLINT_CACHE_DIR": str(tmp_path)})
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "cache hits" not in proc.stderr and os.listdir(tmp_path) == []
        assert json.loads(proc.stdout)["runs"][0]["tool"]["driver"]["name"] == "torchlint"
