"""torchlint engine: file walking, suppression comments, baseline, reporting
(jaxlint's engine, with the port's tool name in its comments and output).

Fingerprints are content-based — ``sha1(rule|path|normalized source line|
neighbor-context hash)`` — so a baseline entry survives unrelated edits
that shift line numbers, and goes stale (reported as such) the moment the
offending line itself (or its immediate neighborhood) changes. The
neighbor-context component disambiguates two textually identical lines in
one file; entries written under the older line-only scheme still match
(legacy fallback) and are auto-migrated to the current scheme by the CLI
on first run. Every baseline entry must carry a human ``justification``;
the engine refuses entries without one, so "baseline it" can never
silently become "ignore it".

The incremental cache (:class:`ParseCache`) persists parsed modules —
AST, suppression table, import map — keyed by per-file content hash, so
repeat runs (and ``--changed-only`` runs, which parse the FULL target set
for project-index fidelity but run rules only on the changed files) skip
the parse phase for unchanged files. Rules always re-run: findings are
cross-module facts and caching them per-file would be wrong the moment an
edit in one file changes what a rule reports about another.
"""

from __future__ import annotations

import ast
import dataclasses
import hashlib
import io
import json
import os
import pickle
import re
import time
import tokenize
from typing import Iterable, List, Optional

from gan_deeplearning4j_tpu_torch.analysis import _common

DEFAULT_BASELINE_PATH = os.path.join(os.path.dirname(__file__), "_baseline.json")

#: bump to invalidate every ParseCache entry (pickle layout, SourceModule
#: fields, suppression scanning — anything that changes parsed artifacts)
CACHE_VERSION = 1

# directories never worth descending into
_SKIP_DIRS = {".git", "__pycache__", ".jax_cache", "artifacts", ".pytest_cache",
              "node_modules", ".eggs", "build", "dist"}

_SUPPRESS_RE = re.compile(r"torchlint:\s*disable=([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One diagnostic. ``path`` is the engine-relative path (repo-relative
    when run from the repo root — the convention the checked-in baseline
    and the tier-1 test both use)."""

    code: str
    message: str
    path: str
    line: int
    col: int
    snippet: str
    #: hash of the nearest non-blank neighbor lines (above + below),
    #: normalized — disambiguates identical offending lines in one file
    #: without re-introducing raw line numbers. "" for findings built
    #: outside a SourceModule (parse failures, direct construction).
    context: str = ""

    @property
    def fingerprint(self) -> str:
        norm = " ".join(self.snippet.split())
        digest = hashlib.sha1(
            f"{self.code}|{self.path}|{norm}|{self.context}".encode()
        ).hexdigest()
        return digest[:16]

    @property
    def legacy_fingerprint(self) -> str:
        """The pre-context scheme — matched as a fallback so baselines
        written before the migration keep working, then rewritten."""
        norm = " ".join(self.snippet.split())
        digest = hashlib.sha1(
            f"{self.code}|{self.path}|{norm}".encode()
        ).hexdigest()
        return digest[:16]

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.code} {self.message}"

    def to_json(self) -> dict:
        return {**dataclasses.asdict(self), "fingerprint": self.fingerprint}


@dataclasses.dataclass
class SourceModule:
    """Parsed module handed to every rule."""

    path: str
    text: str
    tree: ast.AST
    lines: List[str]
    suppressions: dict  # line number -> set of codes (or {"all"})
    imports: dict  # local name -> dotted prefix (see _common.build_import_map)
    is_test: bool
    project: Optional[object] = None  # ProjectIndex, set by analyze_modules

    def resolve(self, node: ast.AST) -> Optional[str]:
        return _common.resolve_name(node, self.imports)

    def line_text(self, lineno: int) -> str:
        if 1 <= lineno <= len(self.lines):
            return self.lines[lineno - 1]
        return ""

    def finding(self, code: str, message: str, node: ast.AST) -> Finding:
        lineno = getattr(node, "lineno", 1)
        col = getattr(node, "col_offset", 0)
        return Finding(
            code=code,
            message=message,
            path=self.path,
            line=lineno,
            col=col,
            snippet=self.line_text(lineno).strip(),
            context=self._neighbor_context(lineno),
        )

    def _neighbor_context(self, lineno: int) -> str:
        """Short hash of the nearest non-blank line above and below
        ``lineno`` (whitespace-normalized). Blank lines are skipped so a
        spacing-only edit does not stale a fingerprint; edits to the
        actual surrounding code do."""
        def nearest(rng) -> str:
            for ln in rng:
                text = " ".join(self.line_text(ln).split())
                if text:
                    return text
            return ""
        above = nearest(range(lineno - 1, 0, -1))
        below = nearest(range(lineno + 1, len(self.lines) + 1))
        return hashlib.sha1(f"{above}\n{below}".encode()).hexdigest()[:8]

    def suppressed(self, finding: Finding, node: ast.AST = None) -> bool:
        """A ``# torchlint: disable=JG00x`` on the finding's line — or, when
        the node spans several physical lines, any line of the span."""
        start = finding.line
        end = getattr(node, "end_lineno", None) or start
        for ln in range(start, end + 1):
            codes = self.suppressions.get(ln)
            if codes and ("all" in codes or finding.code in codes):
                return True
        return False


@dataclasses.dataclass
class Report:
    """Partitioned analysis result. ``active`` is what gates CI; so do stale
    baseline entries (:attr:`gate_ok`) — a baseline that matches nothing is
    a fixed bug still being excused, and carrying it silently would let the
    next occurrence of the same fingerprint slip through."""

    active: List[Finding]
    suppressed: List[Finding]
    baselined: List[Finding]
    stale_baseline: List[dict]  # baseline entries that matched nothing
    files: int
    warnings: List[str] = dataclasses.field(default_factory=list)
    # wall-time breakdown: {"phases": {...}, "rules": {code: seconds},
    # "cache": {"hits": .., "misses": ..} when a ParseCache was used}.
    # Deliberately NOT part of to_json()/render_text() — timings vary run
    # to run and every emission format must be byte-stable for identical
    # inputs. The CLI renders it separately under --profile.
    profile: Optional[dict] = None
    #: legacy fingerprint -> current fingerprint, for baseline entries
    #: that matched only under the pre-context scheme; the CLI rewrites
    #: the baseline file from this map (auto-migration). Not part of
    #: to_json() — it describes the baseline FILE, not the tree.
    baseline_migrations: dict = dataclasses.field(default_factory=dict)
    #: the run's ProjectIndex (transient — CLI-side consumers like
    #: ``--lifecycle-stats`` read it; never serialized)
    index: Optional[object] = None

    @property
    def clean(self) -> bool:
        return not self.active

    @property
    def gate_ok(self) -> bool:
        """What CI keys on: no active findings AND no stale baseline."""
        return self.clean and not self.stale_baseline

    def to_json(self) -> dict:
        return {
            "clean": self.clean,
            "gate_ok": self.gate_ok,
            "files": self.files,
            "active": [f.to_json() for f in self.active],
            "suppressed": [f.to_json() for f in self.suppressed],
            "baselined": [f.to_json() for f in self.baselined],
            "stale_baseline": self.stale_baseline,
            "warnings": self.warnings,
        }

    def render_text(self) -> str:
        out = [f.render() for f in self.active]
        for entry in self.stale_baseline:
            out.append(
                f"# stale baseline entry {entry.get('fingerprint')} "
                f"({entry.get('rule')} {entry.get('path')}) — offending line "
                f"changed or was fixed; remove it from the baseline "
                f"(or run --prune-baseline)"
            )
        for w in self.warnings:
            out.append(f"# warning: {w}")
        out.append(
            f"# torchlint: {self.files} files, {len(self.active)} active, "
            f"{len(self.suppressed)} suppressed, "
            f"{len(self.baselined)} baselined"
        )
        return "\n".join(out)


def _scan_suppressions(text: str) -> dict:
    """Line -> codes from ``# torchlint: disable=...`` comments, via tokenize
    (comments only — the pattern inside a string literal does not count);
    regex fallback for files tokenize rejects."""
    supp: dict = {}

    def record(lineno: int, raw: str) -> None:
        m = _SUPPRESS_RE.search(raw)
        if not m:
            return
        codes = {c.strip().upper() if c.strip().lower() != "all" else "all"
                 for c in m.group(1).split(",") if c.strip()}
        if codes:
            supp.setdefault(lineno, set()).update(codes)

    try:
        for tok in tokenize.generate_tokens(io.StringIO(text).readline):
            if tok.type == tokenize.COMMENT:
                record(tok.start[0], tok.string)
    except (tokenize.TokenError, IndentationError, SyntaxError):
        for i, line in enumerate(text.splitlines(), 1):
            if "#" in line:
                record(i, line[line.index("#"):])
    return supp


def _looks_like_test(relpath: str) -> bool:
    parts = relpath.replace(os.sep, "/").split("/")
    base = parts[-1]
    return (
        "tests" in parts[:-1]
        or base.startswith("test_")
        or base == "conftest.py"
    )


def parse_module(text: str, relpath: str, is_test: Optional[bool] = None):
    """SourceModule, or a parse-failure Finding (code JG000)."""
    try:
        tree = ast.parse(text)
    except SyntaxError as exc:
        return Finding(
            code="JG000",
            message=f"could not parse: {exc.msg}",
            path=relpath,
            line=exc.lineno or 1,
            col=exc.offset or 0,
            snippet="",
        )
    return SourceModule(
        path=relpath,
        text=text,
        tree=tree,
        lines=text.splitlines(),
        suppressions=_scan_suppressions(text),
        imports=_common.build_import_map(tree),
        is_test=_looks_like_test(relpath) if is_test is None else is_test,
    )


def collect_files(paths: Iterable[str], root: Optional[str] = None) -> List[str]:
    """Expand files/directories into a sorted list of .py paths, relative to
    ``root`` (default: cwd) when possible — relative paths keep fingerprints
    machine-independent. A path that is neither an existing directory nor an
    existing ``.py`` file raises: a typo in a CI invocation must fail the
    gate loudly, not shrink it to the paths that happened to resolve."""
    root = os.path.abspath(root or os.getcwd())
    found = []
    for p in paths:
        ap = os.path.abspath(os.path.join(root, p) if not os.path.isabs(p) else p)
        if not (os.path.isdir(ap) or (os.path.isfile(ap) and ap.endswith(".py"))):
            raise FileNotFoundError(
                f"torchlint target {p!r} is neither a directory nor an "
                f"existing .py file (resolved to {ap})"
            )
        if os.path.isdir(ap):
            for dirpath, dirnames, filenames in os.walk(ap):
                dirnames[:] = sorted(
                    d for d in dirnames if d not in _SKIP_DIRS
                )
                for fn in sorted(filenames):
                    if fn.endswith(".py"):
                        found.append(os.path.join(dirpath, fn))
        elif ap.endswith(".py"):
            found.append(ap)
    rel = []
    for ap in found:
        try:
            rp = os.path.relpath(ap, root)
        except ValueError:  # different drive (windows) — keep absolute
            rp = ap
        rel.append(rp if not rp.startswith("..") else ap)
    return sorted(set(rel))


def load_baseline(path: Optional[str] = None) -> List[dict]:
    """Baseline entries (list of dicts). Every entry MUST have fingerprint +
    justification; malformed entries raise — a baseline that cannot explain
    itself is worse than none."""
    path = path or DEFAULT_BASELINE_PATH
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return []
    entries = data.get("entries", []) if isinstance(data, dict) else data
    for e in entries:
        if not e.get("fingerprint") or not str(e.get("justification", "")).strip():
            raise ValueError(
                f"baseline entry {e!r} in {path} lacks a fingerprint or a "
                f"justification — every baselined finding must say why"
            )
    return entries


def write_baseline(entries: List[dict], path: Optional[str] = None) -> None:
    path = path or DEFAULT_BASELINE_PATH
    with open(path, "w") as fh:
        json.dump({"entries": entries}, fh, indent=2)
        fh.write("\n")


def prune_baseline(report: "Report", baseline: List[dict],
                   path: Optional[str] = None) -> int:
    """Drop the baseline entries ``report`` found stale (their fingerprint
    matched no finding) and rewrite the baseline file. Returns the number of
    entries removed. The surviving entries keep their order and their
    human-written justifications untouched."""
    stale_fps = {e.get("fingerprint") for e in report.stale_baseline}
    if not stale_fps:
        return 0
    kept = [e for e in baseline if e.get("fingerprint") not in stale_fps]
    write_baseline(kept, path)
    return len(baseline) - len(kept)


def changed_files(root: Optional[str] = None, base: str = "HEAD") -> List[str]:
    """Python files changed relative to ``base`` (``git diff`` against the
    merge base) plus untracked ones — the ``--changed-only`` working set.
    Raises RuntimeError when git is unusable: a pre-commit gate that cannot
    see the diff must fail loudly, not pass on an empty file list."""
    import subprocess

    root = os.path.abspath(root or os.getcwd())

    def git(*args: str) -> str:
        proc = subprocess.run(
            ["git", "-C", root, *args],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"git {' '.join(args)} failed: {proc.stderr.strip()}"
            )
        return proc.stdout

    merge_base = git("merge-base", "HEAD", base).strip() if base != "HEAD" \
        else "HEAD"
    # `git diff --name-only` emits repo-TOPLEVEL-relative paths while
    # `ls-files --others` emits cwd-relative ones — normalize both against
    # the toplevel, then re-relativize to ``root`` so a run from a repo
    # subdirectory still sees every changed tracked file (a silent drop
    # here is exactly the empty-file-list pass this function must prevent)
    top = git("rev-parse", "--show-toplevel").strip()
    out = git("diff", "--name-only", "-z", merge_base, "--")
    out += git("ls-files", "--others", "--exclude-standard", "--full-name",
               "-z")
    files = set()
    for f in out.split("\0"):
        if not f.endswith(".py"):
            continue
        ap = os.path.join(top, f)
        if not os.path.isfile(ap):
            continue
        rp = os.path.relpath(ap, root)
        if not rp.startswith(".."):
            files.add(rp)
    return sorted(files)


def _run_rules(mod: SourceModule, rules,
               rule_times: Optional[dict] = None) -> List[tuple]:
    """[(finding, node)] for one module, rule errors converted to findings
    (an analyzer crash must be visible, not a silent pass). ``rule_times``
    accumulates per-rule wall seconds across modules; a rule that lazily
    builds a shared index (the concurrency index under JG024) is charged
    for that build on its first run — the honest attribution."""
    out = []
    for rule in rules:
        if mod.is_test and getattr(rule, "skip_tests", False):
            continue
        t0 = time.perf_counter()
        try:
            for item in rule.check(mod):
                if isinstance(item, tuple):
                    out.append(item)
                else:
                    out.append((item, None))
        except Exception as exc:  # pragma: no cover - rule bug guard
            out.append((
                Finding(
                    code="JG000",
                    message=(
                        f"rule {rule.code} crashed on this file: "
                        f"{type(exc).__name__}: {exc}"
                    ),
                    path=mod.path,
                    line=1,
                    col=0,
                    snippet="",
                ),
                None,
            ))
        if rule_times is not None:
            rule_times[rule.code] = (rule_times.get(rule.code, 0.0)
                                     + time.perf_counter() - t0)
    return out


def analyze_modules(mods, rules=None, baseline=None,
                    check_paths=None, cache_stats=None) -> Report:
    """Two-phase analysis: materialize every module, build the project
    index (phase 1), then run the rules (phase 2). Cross-module rules may
    attribute a finding to a DIFFERENT file than the one being iterated
    (e.g. a scan body defined a module away) — suppression is therefore
    checked against the module that owns the finding's path.

    ``check_paths`` (a set, or None for all) restricts phase 2 to those
    modules while phase 1 still indexes everything — the ``--changed-only``
    shape: full cross-module context, rules paid only for the changed
    files. ``cache_stats`` is a ``{"hits": .., "misses": ..}`` dict from a
    :class:`ParseCache`, surfaced in the profile."""
    from gan_deeplearning4j_tpu_torch.analysis import project as _project
    from gan_deeplearning4j_tpu_torch.analysis.rules import RULES, RULES_BY_CODE

    rules = RULES if rules is None else rules
    baseline = baseline or []
    by_fp = {e["fingerprint"]: e for e in baseline}
    matched_fps = set()
    migrations: dict = {}
    active, suppressed, baselined = [], [], []
    warnings: List[str] = []
    seen = set()  # scope overlap can surface one defect twice — keep first
    t0 = time.perf_counter()
    mods = list(mods)  # consuming the generator = reading + parsing
    t_parse = time.perf_counter() - t0
    parsed = [m for m in mods if isinstance(m, SourceModule)]
    t0 = time.perf_counter()
    index = _project.build_index(parsed)
    t_index = time.perf_counter() - t0
    mod_by_path = {}
    for m in parsed:
        m.project = index
        mod_by_path[m.path] = m
    checked = [m for m in mods
               if check_paths is None
               or getattr(m, "path", None) in check_paths]
    known_codes = set(RULES_BY_CODE) | {"all", "JG000"}
    for m in checked:
        if not isinstance(m, SourceModule):
            continue
        for line, codes in sorted(m.suppressions.items()):
            for code in sorted(codes - known_codes):
                warnings.append(
                    f"{m.path}:{line}: suppression names unknown rule code "
                    f"{code!r} — it suppresses nothing; check for a typo"
                )
    files = 0
    rule_times: dict = {}
    t0 = time.perf_counter()
    for mod in checked:
        files += 1
        if isinstance(mod, Finding):  # parse failure
            active.append(mod)
            continue
        for finding, node in _run_rules(mod, rules, rule_times):
            key = (finding.code, finding.path, finding.line, finding.col)
            if key in seen:
                continue
            seen.add(key)
            owner = mod_by_path.get(finding.path, mod)
            if owner.suppressed(finding, node):
                suppressed.append(finding)
            elif finding.fingerprint in by_fp:
                matched_fps.add(finding.fingerprint)
                baselined.append(finding)
            elif finding.legacy_fingerprint in by_fp:
                # pre-context-scheme entry: still honored, and recorded
                # for auto-migration to the current fingerprint
                matched_fps.add(finding.legacy_fingerprint)
                migrations[finding.legacy_fingerprint] = finding.fingerprint
                baselined.append(finding)
            else:
                active.append(finding)
    # Staleness is judged ONLY within this run's scope: an entry whose path
    # was not analyzed (or not rule-checked — --changed-only indexes the
    # full tree but checks a subset) or whose rule did not run might still
    # match on the next full run — calling it stale here would fail every
    # scoped run (--changed-only, path subsets, --rules) and let
    # --prune-baseline delete still-valid entries. Entries without
    # path/rule metadata are conservatively treated as in-scope.
    analyzed = {m.path for m in checked if hasattr(m, "path")}
    rule_codes = {r.code for r in rules}
    stale = [
        e for e in baseline
        if e["fingerprint"] not in matched_fps
        and (not e.get("path") or e["path"] in analyzed)
        and (not e.get("rule") or e["rule"] in rule_codes)
    ]
    t_rules = time.perf_counter() - t0
    # Deterministic emission order for EVERY partition, not just active:
    # findings surface in module-iteration order, which depends on how the
    # caller enumerated paths — two runs over the same tree must render
    # byte-identical text/JSON/SARIF regardless.
    order = lambda f: (f.path, f.line, f.code)  # noqa: E731
    active.sort(key=order)
    suppressed.sort(key=order)
    baselined.sort(key=order)
    warnings.sort()
    stale.sort(key=lambda e: (e.get("path") or "", e["fingerprint"]))
    profile = {
        "phases": {"parse": t_parse, "index": t_index, "rules": t_rules},
        "rules": rule_times,
    }
    if cache_stats is not None:
        profile["cache"] = dict(cache_stats)
    return Report(active, suppressed, baselined, stale, files,
                  warnings=warnings, profile=profile,
                  baseline_migrations=migrations, index=index)


class ParseCache:
    """Per-file persistence of parsed modules, keyed by content hash.

    One pickle per file under ``dirpath``, named by
    ``sha256(version|relpath|content)`` — an edited file simply misses
    (its old entry is overwritten on store, so the directory does not
    grow per edit), and any unpicklable/corrupt entry degrades to a miss.
    Only the parse phase is cached; rules always re-run (findings are
    cross-module facts). ``stats`` feeds the ``--profile`` table."""

    def __init__(self, dirpath: str) -> None:
        self.dir = dirpath
        self.stats = {"hits": 0, "misses": 0}
        os.makedirs(dirpath, exist_ok=True)

    def _key(self, relpath: str, text: str) -> str:
        norm = relpath.replace(os.sep, "/")
        return hashlib.sha256(
            f"{CACHE_VERSION}|{norm}\0{text}".encode()
        ).hexdigest()

    def _entry(self, relpath: str) -> str:
        # stable per-PATH filename (content hash verified inside): an
        # edit REPLACES the file's entry instead of accreting stale blobs
        name = hashlib.sha256(
            relpath.replace(os.sep, "/").encode()).hexdigest()
        return os.path.join(self.dir, f"{name}.pkl")

    def load(self, relpath: str, text: str):
        """Cached parse_module() result (SourceModule or Finding), or
        None on miss."""
        try:
            with open(self._entry(relpath), "rb") as fh:
                key, obj = pickle.load(fh)
        except Exception:
            self.stats["misses"] += 1
            return None
        if key != self._key(relpath, text):
            self.stats["misses"] += 1
            return None
        self.stats["hits"] += 1
        return obj

    def store(self, relpath: str, text: str, obj) -> None:
        """Best-effort write (a read-only cache dir must not fail the
        lint run); ``obj.project`` is never persisted."""
        if isinstance(obj, SourceModule):
            obj = dataclasses.replace(obj, project=None)
        try:
            tmp = self._entry(relpath) + f".tmp.{os.getpid()}"
            with open(tmp, "wb") as fh:
                pickle.dump((self._key(relpath, text), obj), fh,
                            protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp, self._entry(relpath))
        except Exception:
            pass


def analyze_paths(paths, rules=None, baseline=None, root=None,
                  cache: Optional[ParseCache] = None,
                  check_paths=None) -> Report:
    """Analyze files/directories. ``baseline`` is a loaded entry list (use
    :func:`load_baseline`), or None for no baseline. ``cache`` short-cuts
    the parse phase for unchanged files; ``check_paths`` restricts the
    rule phase (phase 1 still indexes every collected file)."""
    root = os.path.abspath(root or os.getcwd())

    def gen():
        for rp in collect_files(paths, root):
            ap = rp if os.path.isabs(rp) else os.path.join(root, rp)
            try:
                with open(ap, encoding="utf-8", errors="replace") as fh:
                    text = fh.read()
            except OSError as exc:
                yield Finding("JG000", f"unreadable: {exc}", rp, 1, 0, "")
                continue
            if cache is not None:
                hit = cache.load(rp, text)
                if hit is not None:
                    yield hit
                    continue
            mod = parse_module(text, rp)
            if cache is not None:
                cache.store(rp, text, mod)
            yield mod

    return analyze_modules(
        gen(), rules=rules, baseline=baseline, check_paths=check_paths,
        cache_stats=None if cache is None else cache.stats)


def analyze_source(text: str, path: str = "<string>", rules=None,
                   baseline=None, is_test=None) -> Report:
    """Analyze one in-memory module — the fixture entry point for tests.
    ``is_test=None`` derives test-ness from ``path`` like the file walker."""
    mod = parse_module(text, path, is_test=is_test)
    return analyze_modules([mod], rules=rules, baseline=baseline)


def analyze_sources(sources: dict, rules=None, baseline=None) -> Report:
    """Analyze several in-memory modules TOGETHER (one project index) —
    the fixture entry point for cross-module rules. ``sources`` maps
    engine-relative paths to module text; paths determine module names
    (``pkg/mod.py`` -> ``pkg.mod``), so imports between the sources
    resolve exactly as they would on disk."""
    mods = [parse_module(text, path) for path, text in sorted(sources.items())]
    return analyze_modules(mods, rules=rules, baseline=baseline)
