"""JG032 — double-buffer consumed while its overlapped fill is in flight.

The streaming input pipeline (zoo/streaming.py) overlaps the next block's
fill with consumption of the current block: a worker is handed the buffer
(``executor.submit(self._fill, back)``) while the consumer slices batches
out of the front buffer. The discipline that makes this safe is the FENCE:
the future's ``result()`` (or a ``join()``/``wait()``, or the tuple swap
that retires the front buffer) must happen before anything READS the
buffer the fill was issued against. Dropping the fence is the classic
double-buffering bug — the consumer reads rows the worker is still
writing, producing silently torn batches that train fine and converge
wrong. It is also invisible to tests at small scale, where the fill wins
the race by accident.

Queued in ROADMAP since PR 10 introduced the ``DevicePrefetchIterator``
``transform=`` seam; the streaming pipeline makes the shape load-bearing.

The rule is scope-local and flow-free, in the house style:

1. an *overlapped fill* is ``<pool>.submit(f, buf, ...)`` or
   ``Thread(target=f, args=(buf, ...))`` where ``f``'s terminal
   identifier contains ``fill``, ``refill``, or ``prefetch`` — the repo's
   naming seam for background buffer writers;
2. its *buffers* are the Name/Attribute arguments handed to ``f``
   (matched by dotted path, so ``self._back`` is tracked);
3. a *consumption read* is a later subscript of the buffer
   (``back[i]``, ``back[lo:hi]``) or iteration over it
   (``for row in back:``) in the same scope — a bare mention (len(),
   passing it along) is not consumption and does not fire;
4. a *fence* clears the hazard: any ``.result()``/``.join()``/``.wait()``
   call, or a swap assignment whose targets include the buffer
   (``front, back = back, front`` — the read-after names then refer to
   retired storage), between the issue and the read.

True negatives: fence-then-read (zoo/streaming.py's ``_promote``), reads
that precede the issue (consume-then-refill, the other legal ordering),
non-buffer arguments (``submit(self._fill, start_index)`` where the index
is never subscripted), and worker callees without the naming seam.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from gan_deeplearning4j_tpu_torch.analysis import _common

_FILL_TOKENS = ("fill", "refill", "prefetch")
_FENCE_ATTRS = ("result", "join", "wait")


def _terminal(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _dotted(node: ast.AST) -> Optional[str]:
    """``buf`` / ``self._back`` as a stable dotted path (None for anything
    more dynamic — calls, subscripts — which this flow-free rule skips)."""
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = _dotted(node.value)
        return None if base is None else f"{base}.{node.attr}"
    return None


def _is_fill_callee(node: ast.AST) -> bool:
    name = _terminal(node)
    return name is not None and any(t in name.lower() for t in _FILL_TOKENS)


class DoubleBufferMisuse:
    code = "JG032"
    name = "double-buffer-misuse"
    summary = ("buffer read after its overlapped fill was issued, with no "
               "fence or swap in between")

    # -- issue sites -------------------------------------------------------
    def _fill_buffers(self, call: ast.Call) -> Optional[List[ast.AST]]:
        """The buffer arguments of an overlapped-fill call, or None when
        this call is not one."""
        # <pool>.submit(fill_fn, buf, ...)
        if (_terminal(call.func) == "submit" and call.args
                and _is_fill_callee(call.args[0])):
            return list(call.args[1:])
        # Thread(target=fill_fn, args=(buf, ...))
        if _terminal(call.func) == "Thread":
            target = None
            args: List[ast.AST] = []
            for kw in call.keywords:
                if kw.arg == "target":
                    target = kw.value
                elif kw.arg == "args" and isinstance(kw.value, ast.Tuple):
                    args = list(kw.value.elts)
            if target is not None and _is_fill_callee(target):
                return args
        return None

    # -- the check ---------------------------------------------------------
    def check(self, mod):
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            nodes = sorted(
                _common.walk_excluding_defs(body),
                key=lambda n: getattr(n, "lineno", 0),
            )
            # issued[buffer dotted path] = issue line
            issued: Dict[str, int] = {}
            flagged: set = set()
            for n in nodes:
                line = getattr(n, "lineno", 0)
                # fences first: a .result()/.join()/.wait() clears every
                # outstanding issue (flow-free: any fence on the path
                # counts), a swap assignment retires the swapped buffers
                if isinstance(n, ast.Call) \
                        and isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _FENCE_ATTRS:
                    issued.clear()
                    continue
                if isinstance(n, ast.Assign):
                    for tgt in n.targets:
                        elts = tgt.elts if isinstance(tgt, ast.Tuple) else [tgt]
                        for e in elts:
                            path = _dotted(e)
                            if path is not None:
                                issued.pop(path, None)
                if isinstance(n, ast.Call):
                    buffers = self._fill_buffers(n)
                    if buffers:
                        for b in buffers:
                            path = _dotted(b)
                            if path is not None:
                                issued.setdefault(path, line)
                        continue
                if not issued:
                    continue
                # consumption reads of an issued buffer
                read: Optional[Tuple[str, ast.AST]] = None
                if isinstance(n, ast.Subscript):
                    path = _dotted(n.value)
                    if path in issued and line > issued[path]:
                        read = (path, n)
                elif isinstance(n, (ast.For, ast.AsyncFor)):
                    path = _dotted(n.iter)
                    if path in issued and line > issued[path]:
                        read = (path, n)
                if read is None or read[0] in flagged:
                    continue
                path, node = read
                flagged.add(path)
                yield mod.finding(
                    self.code,
                    f"`{path}` is read here, but its overlapped fill was "
                    f"issued on line {issued[path]} and nothing fences the "
                    f"worker in between — the consumer can observe a "
                    f"half-written buffer (torn batches that train wrong "
                    f"silently); call the future's .result() (or "
                    f".join()/.wait(), or swap the buffers) before reading",
                    node,
                ), node
