"""torchlint ``--fix``: mechanical, idempotent source rewrites.

The autofix contract (the JAX analyzer's, ``analysis/CATALOGUE.md``):

- Only rewrites whose semantics are fully determined by the finding are
  applied — no judgement calls, no formatting beyond the touched lines:

  * **JG003** ``assert test[, msg]`` → ``if not (test): raise
    AssertionError(msg)`` — the explicit form survives ``python -O``;
  * **JG007** a discarded out-of-place ``x.add(v)`` statement →
    ``x = x.add(v)`` — only when the receiver is a plain name or dotted
    attribute (anything else is reported but left to a human);
  * **suppression insertion** (``--fix-suppress``, requires a
    ``--justification``): appends ``# torchlint: disable=<code> -- <why>``
    to each remaining active finding's line. The justification is
    mandatory for the same reason baseline entries require one: "suppress
    it" must never silently become "ignore it".

- **Idempotency**: a fixed line no longer matches its rule, and a
  suppressed finding is categorized as suppressed, so running any fix mode
  twice is a no-op (tested in tests/test_torch_analysis.py).
- Fixes apply to ACTIVE findings only — suppressed and baselined findings
  are someone's recorded decision and are left alone.
- Statements that do not start their line (``if x: assert y``) are skipped:
  a rewrite there would need to restructure the compound statement, which
  is not mechanical.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional

from gan_deeplearning4j_tpu_torch.analysis import engine
from gan_deeplearning4j_tpu_torch.analysis.rules import out_of_place as _out_of_place

#: rules --fix can rewrite (suppression insertion covers every code)
FIXABLE_CODES = ("JG003", "JG007")

_DISABLE_RE = re.compile(r"(#\s*torchlint:\s*disable=)([A-Za-z0-9_,\s]+)")


@dataclasses.dataclass
class FixResult:
    rewritten: int          # findings fixed by rewriting code
    suppressed: int         # findings fixed by inserting suppressions
    skipped: List[str]      # findings seen but not mechanically fixable
    files: List[str]        # files actually modified


def _starts_line(lines: List[str], lineno: int, col: int) -> bool:
    line = lines[lineno - 1] if 1 <= lineno <= len(lines) else ""
    return line[:col].strip() == ""


def _fix_assert(node: ast.Assert, lines: List[str]) -> Optional[List[str]]:
    """Replacement lines for a bare assert, or None when not mechanical."""
    if not _starts_line(lines, node.lineno, node.col_offset):
        return None
    indent = " " * node.col_offset
    test = ast.unparse(node.test)
    msg = ast.unparse(node.msg) if node.msg is not None else ""
    return [
        f"{indent}if not ({test}):",
        f"{indent}    raise AssertionError({msg})",
    ]


def _fix_out_of_place(node: ast.Expr, lines: List[str],
                      tensors: set) -> Optional[List[str]]:
    """Prepend ``base = `` to a discarded out-of-place statement."""
    hit = _out_of_place.discarded_call(node.value, tensors)
    if hit is None:
        return None
    base, _ = hit
    base_text = _out_of_place.fixable_base_text(base)
    if base_text is None or not _starts_line(lines, node.lineno,
                                             node.col_offset):
        return None
    first = lines[node.lineno - 1]
    patched = (first[: node.col_offset] + f"{base_text} = "
               + first[node.col_offset:])
    out = [patched]
    out.extend(lines[node.lineno: (node.end_lineno or node.lineno)])
    return out


def _scope_tensors(mod: engine.SourceModule, node: ast.AST) -> set:
    """The tensor names of the innermost scope holding ``node`` (the set
    JG007 judged the statement with)."""
    scope = mod.tree
    for n in ast.walk(mod.tree):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)) and any(
                sub is node for sub in ast.walk(n)):
            scope = n  # ast.walk is breadth-first: the last hit is innermost
    return _out_of_place.tensor_names(scope, mod)


def _node_at(tree: ast.AST, kind, lineno: int):
    for n in ast.walk(tree):
        if isinstance(n, kind) and getattr(n, "lineno", None) == lineno:
            return n
    return None


def _apply_rewrites(path: str, findings: List[engine.Finding]) -> tuple:
    """Rewrite one file bottom-up. Returns (n_fixed, skipped_renders)."""
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    lines = text.splitlines()
    mod = engine.parse_module(text, path)
    if not isinstance(mod, engine.SourceModule):
        return 0, [f.render() for f in findings]
    tree = mod.tree
    fixed, skipped = 0, []
    for f in sorted(findings, key=lambda f: -f.line):
        if f.code == "JG003":
            node = _node_at(tree, ast.Assert, f.line)
            repl = _fix_assert(node, lines) if node is not None else None
        elif f.code == "JG007":
            node = _node_at(tree, ast.Expr, f.line)
            repl = None if node is None else _fix_out_of_place(
                node, lines, _scope_tensors(mod, node))
        else:
            skipped.append(f.render())
            continue
        if repl is None:
            skipped.append(f.render())
            continue
        lines[node.lineno - 1: (node.end_lineno or node.lineno)] = repl
        fixed += 1
    if fixed:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + ("\n" if text.endswith("\n") else ""))
    return fixed, skipped


def _suppression_line(lines: List[str], lineno: int) -> int:
    """The physical line a suppression comment may legally land on: skip
    past backslash continuations (a comment after ``\\`` is a syntax
    error); any line of the statement's span suppresses (engine rule)."""
    i = lineno
    while i <= len(lines) and lines[i - 1].rstrip().endswith("\\"):
        i += 1
    return min(i, len(lines))


def _insert_suppressions(path: str, findings: List[engine.Finding],
                         justification: str) -> int:
    with open(path, encoding="utf-8") as fh:
        text = fh.read()
    lines = text.splitlines()
    by_line: Dict[int, set] = {}
    for f in findings:
        target = _suppression_line(lines, f.line)
        by_line.setdefault(target, set()).add(f.code)
    n = 0
    for lineno, codes in sorted(by_line.items()):
        line = lines[lineno - 1]
        m = _DISABLE_RE.search(line)
        if m:
            merged = {c.strip() for c in m.group(2).split(",") if c.strip()}
            merged |= codes
            lines[lineno - 1] = (line[: m.start(2)]
                                 + ",".join(sorted(merged))
                                 + line[m.end(2):])
        else:
            lines[lineno - 1] = (
                f"{line}  # torchlint: disable={','.join(sorted(codes))}"
                f" -- {justification}"
            )
        n += len(codes)
    if n:
        with open(path, "w", encoding="utf-8") as fh:
            fh.write("\n".join(lines) + ("\n" if text.endswith("\n") else ""))
    return n


def apply_fixes(report: engine.Report, root: Optional[str] = None,
                suppress: bool = False,
                justification: Optional[str] = None) -> FixResult:
    """Apply mechanical fixes for ``report``'s ACTIVE findings.

    Default mode rewrites the FIXABLE_CODES subset; ``suppress=True``
    instead inserts justified suppression comments for every active
    finding (``justification`` is then required)."""
    if suppress and not (justification or "").strip():
        raise ValueError(
            "suppression insertion requires a justification — a suppression "
            "that cannot say why is a bug tracker with the entries deleted"
        )
    root = os.path.abspath(root or os.getcwd())
    by_path: Dict[str, List[engine.Finding]] = {}
    for f in report.active:
        if f.code == "JG000":
            continue  # parse failures have no mechanical fix
        by_path.setdefault(f.path, []).append(f)
    rewritten = suppressed = 0
    skipped: List[str] = []
    files: List[str] = []
    for relpath, findings in sorted(by_path.items()):
        path = relpath if os.path.isabs(relpath) else os.path.join(root, relpath)
        if suppress:
            n = _insert_suppressions(path, findings, justification.strip())
            suppressed += n
            if n:
                files.append(relpath)
        else:
            fixable = [f for f in findings if f.code in FIXABLE_CODES]
            skipped.extend(f.render() for f in findings
                           if f.code not in FIXABLE_CODES)
            if not fixable:
                continue
            n, skip = _apply_rewrites(path, fixable)
            rewritten += n
            skipped.extend(skip)
            if n:
                files.append(relpath)
    return FixResult(rewritten, suppressed, skipped, files)
