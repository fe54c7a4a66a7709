"""torchlint phase 1½ — the lifecycle index (paired-resource summaries).

Every hardening round in this repo's history hand-caught the same bug
shape: a paired operation whose second half can be skipped on an exception
path — the engine's replica in-flight ledger needed a release-exactly-once
fix (PR 4), the router's retry token needed a refund when no routable
worker remained (PR 8), the device-capture lock needed explicit ownership
handoff to its worker thread (PR 6). The class is mechanical, and with
83 acquire/release-shaped call pairs across the tree it is exactly what an
analyzer should police. This module discovers **paired-resource
protocols** and summarizes, per function, which resources are opened, on
which control-flow paths they are guaranteed closed, and where ownership
is handed to another thread or callback so the closing obligation
transfers. Rules JG027–JG029 consume the summaries.

Protocols come from three sources:

- a **seeded pair table** — lock ``acquire``/``release``, trace
  ``async_begin``/``async_end``, engine ``dispatch``/``finalize``, token
  ``take``/``refund``, ``register``/``unregister``. A seeded open is only
  tracked when its close-half name appears somewhere in the same module
  (``atexit.register`` in a module that never unregisters is a
  fire-and-forget API, not half of a protocol);
- **inferred project-local pairs** — a class whose methods are textual
  duals (``open_stream``/``close_stream``, ``checkout``/``checkin`` — the
  first ``_``-segment swapped through :data:`DUAL_SEGMENTS`) and both
  touch a common ``self`` attribute defines a protocol; use sites are only
  tracked where the receiver's class is statically resolvable (a local or
  ``self`` attribute assigned ``Cls(...)``), so ``thread.start()`` never
  reads as an un-stopped resource;
- **in-flight counters** — ``self.<attr> += n`` paired with
  ``self.<attr> -= n`` in the *same function* of a class that uses both
  halves; the increment opens a reservation the decrement must release on
  every path (the PR 4 ledger bug). Cross-method counter halves are the
  normal dispatch/finalize ledger and are not modeled.

Per open event the forward path analysis classifies the outcome:

- ``closed`` — a matching close (same receiver) dominates every path out
  of the open's scope: same-statement pairing, ``try``/``finally`` whose
  finally closes, or a close on every branch. A close reached only after
  a *raise-capable* statement (one containing a call) records an
  exception-path hazard — the JG027 shape;
- ``transferred`` — the receiver or the open's bound token is returned,
  raised, stored into ``self``/a container, or passed to another call:
  the closing obligation moved with it. ``threading.Thread(target=...)``
  and callback-registration calls additionally record a :class:`Handoff`
  with the resolved receiver function, and whether that function contains
  the close (JG029's input). A ``self.<attr>`` (or module-global) open
  whose close-half lives in a *different* method of the same class
  (module) is likewise a transfer — the instance holds the resource
  between its ``start``/``stop``-shaped halves;
- ``leak`` — an early ``return``/``raise``/``continue`` escape, a
  fall-through off the end of the function, or a loop boundary crossed
  with the resource open.

Everything is statically visible facts only. Known approximations
(documented once here, referenced by the rules): ``try`` bodies are
combined with their handlers branch-wise, not edge-exact (an exception
mid-try that a handler swallows without closing can slip through); a
close reached only through an unresolvable helper call is invisible (the
generic token-transfer rule usually covers it); ``with`` context managers
are balanced by construction and never count as opens.
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from gan_deeplearning4j_tpu_torch.analysis import _common

#: (open, close) method-name pairs tracked wherever the close-half name
#: appears in the same module
SEEDED_PAIRS: Tuple[Tuple[str, str], ...] = (
    ("acquire", "release"),
    ("async_begin", "async_end"),
    ("dispatch", "finalize"),
    ("take", "refund"),
    ("register", "unregister"),
)

#: first-``_``-segment duals used to infer project-local pairs from class
#: method names (both methods must touch a common ``self`` attribute)
DUAL_SEGMENTS: Dict[str, str] = {
    "open": "close", "start": "stop", "begin": "end", "enter": "exit",
    "attach": "detach", "connect": "disconnect", "checkout": "checkin",
    "borrow": "restore", "reserve": "unreserve", "lease": "unlease",
}

_SEEDED_OPEN = {o: c for o, c in SEEDED_PAIRS}
_SEEDED_CLOSE = {c: o for o, c in SEEDED_PAIRS}


@dataclasses.dataclass(frozen=True)
class PairProtocol:
    """One open/close discipline. ``kind`` is "seeded", "inferred" or
    "counter"; inferred pairs carry the defining class' canonical name."""

    open: str
    close: str
    kind: str
    cls: Optional[str] = None


@dataclasses.dataclass
class Handoff:
    """The open resource handed to a thread target / registered callback."""

    target: str                 # surface name of the receiver function
    node: ast.AST
    resolved: bool              # the receiver's body was found and scanned
    target_closes: bool         # ... and it contains the closing call


@dataclasses.dataclass
class OpenEvent:
    """One tracked open, with the outcome of the forward path analysis."""

    pair: PairProtocol
    recv: str                   # receiver text ("self._lock", "tok")
    node: ast.AST
    method: str
    outcome: str                # "closed" | "transferred" | "leak"
    leak_kind: Optional[str] = None   # "exception-path" | "early-exit" |
    #                                   "fall-through" | "loop-carried"
    hazard_node: Optional[ast.AST] = None  # the raising / escaping stmt
    transfer_kind: Optional[str] = None    # "returned"|"stored"|"argument"|
    #                                        "handoff"|"cross-method"
    handoff: Optional[Handoff] = None


@dataclasses.dataclass
class BalanceIssue:
    """A JG028 shape found by the block-linear balance pass."""

    pair: PairProtocol
    recv: str
    kind: str                   # "double-close" | "close-without-open" |
    #                             "loop-carried-release"
    node: ast.AST
    method: str
    prior: Optional[ast.AST] = None  # the earlier close / the open outside


@dataclasses.dataclass
class FunctionLifecycle:
    """Per-function slice handed to the rules."""

    name: str                   # qualname ("Cls.m" or "fn")
    node: ast.AST
    opens: List[OpenEvent] = dataclasses.field(default_factory=list)
    issues: List[BalanceIssue] = dataclasses.field(default_factory=list)


class LifecycleIndex:
    """Lazy per-path cache of :class:`FunctionLifecycle` summaries, built
    from the project index's parsed modules on first use by a rule, so
    runs that exclude JG027–JG029 pay nothing for it."""

    def __init__(self, project) -> None:
        self._project = project
        self._cache: Dict[str, List[FunctionLifecycle]] = {}
        self._inferred: Optional[Dict[str, List[PairProtocol]]] = None

    def functions(self, path: str) -> List[FunctionLifecycle]:
        if path not in self._cache:
            info = self._project.by_path.get(path)
            self._cache[path] = (
                [] if info is None
                else _build_module(info.srcmod, self._project,
                                   self.inferred_pairs()))
        return self._cache[path]

    def inferred_pairs(self) -> Dict[str, List[PairProtocol]]:
        """Canonical class name -> inferred protocols, discovered once
        over every indexed module (cross-module use sites resolve through
        the importing module's absolutized imports)."""
        if self._inferred is None:
            self._inferred = {}
            for info in self._project.modules.values():
                for cls in ast.walk(info.srcmod.tree):
                    if not isinstance(cls, ast.ClassDef):
                        continue
                    for proto in _infer_class_pairs(cls):
                        canon = f"{info.name}.{cls.name}"
                        proto = dataclasses.replace(proto, cls=canon)
                        self._inferred.setdefault(canon, []).append(proto)
        return self._inferred

    def stats(self) -> dict:
        """Index-wide totals (the campaign preflight snapshot): protocols
        discovered, opens analyzed, and how each open resolved."""
        counts = {"files": 0, "functions": 0, "opens": 0,
                  "closed": 0, "transferred": 0, "leaked": 0,
                  "handoffs": 0, "handoffs_resolved": 0,
                  "balance_issues": 0,
                  "pairs_seeded": len(SEEDED_PAIRS),
                  "pairs_inferred": sum(
                      len(v) for v in self.inferred_pairs().values())}
        for path in sorted(self._project.by_path):
            fls = self.functions(path)
            counts["files"] += 1
            counts["functions"] += len(fls)
            for fl in fls:
                counts["opens"] += len(fl.opens)
                counts["balance_issues"] += len(fl.issues)
                for ev in fl.opens:
                    key = {"closed": "closed",
                           "transferred": "transferred",
                           "leak": "leaked"}[ev.outcome]
                    counts[key] += 1
                    if ev.handoff is not None:
                        counts["handoffs"] += 1
                        if ev.handoff.resolved:
                            counts["handoffs_resolved"] += 1
        return counts


def build(project) -> LifecycleIndex:
    return LifecycleIndex(project)


# -- protocol discovery -----------------------------------------------------

def _dual_name(name: str) -> Optional[str]:
    """``open_stream`` -> ``close_stream`` via the first-segment dual
    table, else None."""
    head, sep, rest = name.partition("_")
    dual = DUAL_SEGMENTS.get(head)
    if dual is None:
        return None
    return f"{dual}{sep}{rest}"


def _self_attrs_touched(fn) -> Set[str]:
    out: Set[str] = set()
    for n in ast.walk(fn):
        if (isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name)
                and n.value.id == "self"):
            out.add(n.attr)
    return out


def _infer_class_pairs(cls: ast.ClassDef) -> List[PairProtocol]:
    methods = {n.name: n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}
    out = []
    for name, fn in sorted(methods.items()):
        if name in _SEEDED_OPEN:
            continue  # seeded pairs already track these names everywhere
        dual = _dual_name(name)
        if dual is None or dual not in methods:
            continue
        if _self_attrs_touched(fn) & _self_attrs_touched(methods[dual]):
            out.append(PairProtocol(open=name, close=dual, kind="inferred"))
    return out


def _module_attr_names(tree: ast.AST) -> Set[str]:
    """Every attribute name called anywhere in the module — the gate for
    seeded pairs (open tracked only when the close-half is in play)."""
    out: Set[str] = set()
    for n in ast.walk(tree):
        if isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute):
            out.add(n.func.attr)
    return out


def _counter_attrs(cls: ast.ClassDef) -> Set[str]:
    """``self`` attributes the class both ``+=``s and ``-=``s — the
    in-flight-ledger shape."""
    plus: Set[str] = set()
    minus: Set[str] = set()
    for n in ast.walk(cls):
        if (isinstance(n, ast.AugAssign)
                and isinstance(n.target, ast.Attribute)
                and isinstance(n.target.value, ast.Name)
                and n.target.value.id == "self"):
            if isinstance(n.op, ast.Add):
                plus.add(n.target.attr)
            elif isinstance(n.op, ast.Sub):
                minus.add(n.target.attr)
    return plus & minus


# -- receiver typing (inferred-pair use sites) ------------------------------

class _TypeEnv:
    """Receiver text -> canonical class name, from ``x = Cls(...)`` local
    assignments and ``self.attr = Cls(...)`` in the enclosing class."""

    def __init__(self, project, mod) -> None:
        self._project = project
        self._mod = mod
        self._info = project.by_path.get(mod.path)
        self.types: Dict[str, str] = {}

    def canonical_class(self, ctor: ast.AST) -> Optional[str]:
        resolved = self._mod.resolve(ctor)
        if resolved is None or self._info is None:
            return None
        canon = self._project._canonical_call(self._info, resolved)
        return canon

    def learn(self, target_text: str, value: ast.AST) -> None:
        if isinstance(value, ast.Call):
            canon = self.canonical_class(value.func)
            if canon is not None:
                self.types[target_text] = canon


def _recv_text(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - unparse handles all exprs
        return "<expr>"


# -- per-module construction ------------------------------------------------

def _build_module(mod, project, inferred: Dict[str, List[PairProtocol]]):
    out: List[FunctionLifecycle] = []
    module_attrs = _module_attr_names(mod.tree)
    # module-level functions
    for n in mod.tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(_analyze_function(
                mod, project, inferred, module_attrs, n, qualprefix="",
                counter_attrs=frozenset(), scope_body=mod.tree.body))
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        counters = frozenset(_counter_attrs(cls))
        for n in cls.body:
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append(_analyze_function(
                    mod, project, inferred, module_attrs, n,
                    qualprefix=cls.name + ".", counter_attrs=counters,
                    scope_body=cls.body))
    return out


def _closes_in_tree(tree: ast.AST, recv: str, close: str,
                    counter: bool = False) -> bool:
    """Does ``tree`` contain ``<recv>.<close>()`` (or ``<recv> -= ...``
    for counters)? ``self.``-qualified receivers match across methods."""
    for n in ast.walk(tree):
        if counter:
            if (isinstance(n, ast.AugAssign) and isinstance(n.op, ast.Sub)
                    and _recv_text(n.target) == recv):
                return True
        elif (isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute)
                and n.func.attr == close
                and _recv_text(n.func.value) == recv):
            return True
    return False


class _FnAnalysis:
    """The forward path analysis for one function body."""

    # scan outcomes
    CLOSED, TRANSFER, LEAK, FALL, BREAK = range(5)

    def __init__(self, mod, project, inferred, module_attrs, fn,
                 qualname, counter_attrs, scope_body):
        self.mod = mod
        self.project = project
        self.inferred = inferred
        self.module_attrs = module_attrs
        self.fn = fn
        self.qualname = qualname
        self.counter_attrs = counter_attrs
        self.scope_body = scope_body  # class body / module body (transfer
        #                               downgrade + handoff resolution)
        self.env = _TypeEnv(project, mod)
        self.result = FunctionLifecycle(name=qualname, node=fn)
        # seed the type env from the enclosing class' __init__ so
        # ``self.pool = StreamPool()`` types later ``self.pool.open_*``
        for stmt in scope_body:
            if (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and stmt.name == "__init__"):
                for n in ast.walk(stmt):
                    if (isinstance(n, ast.Assign) and len(n.targets) == 1
                            and isinstance(n.targets[0], ast.Attribute)):
                        self.env.learn(_recv_text(n.targets[0]), n.value)

    # -- open/close matching ------------------------------------------------
    def _match_open(self, call: ast.Call) -> Optional[Tuple[PairProtocol, str]]:
        if not isinstance(call.func, ast.Attribute):
            return None
        name = call.func.attr
        recv = _recv_text(call.func.value)
        close = _SEEDED_OPEN.get(name)
        if close is not None and close in self.module_attrs:
            return PairProtocol(open=name, close=close, kind="seeded"), recv
        cls = self.env.types.get(recv)
        if cls is not None:
            for proto in self.inferred.get(cls, ()):
                if proto.open == name:
                    return proto, recv
        return None

    def _is_close_call(self, node: ast.AST, pair: PairProtocol,
                       recv: str) -> bool:
        return (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == pair.close
                and _recv_text(node.func.value) == recv)

    def _stmt_closes(self, stmt: ast.stmt, pair: PairProtocol,
                     recv: str) -> bool:
        if pair.kind == "counter":
            return any(
                isinstance(n, ast.AugAssign) and isinstance(n.op, ast.Sub)
                and _recv_text(n.target) == recv
                for n in _common.walk_excluding_defs(stmt))
        return any(self._is_close_call(n, pair, recv)
                   for n in _common.walk_excluding_defs(stmt))

    def _block_closes(self, stmts, pair, recv) -> bool:
        return any(self._stmt_closes(s, pair, recv) for s in stmts)

    # -- transfer / handoff -------------------------------------------------
    def _token_names(self, stmt: ast.stmt, call: ast.Call,
                     pair: PairProtocol, recv: str) -> Set[str]:
        """Names that carry the closing obligation: the open's bound
        result, the receiver's base name, and — for ``async_begin`` — the
        span-id argument (the token the matching ``async_end`` needs)."""
        names: Set[str] = set()
        base = _common.base_name(call.func.value) if isinstance(
            call.func, ast.Attribute) else None
        if base is not None and base != "self":
            names.add(base)
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
        if pair.open == "async_begin" and len(call.args) >= 2:
            b = _common.base_name(call.args[1])
            if b is not None:
                names.add(b)
        return names

    def _handoff_target(self, call: ast.Call) -> Optional[ast.AST]:
        """The receiver-function expression of a thread spawn or callback
        registration, else None."""
        resolved = self.mod.resolve(call.func)
        if resolved in ("threading.Thread", "threading.Timer"):
            for kw in call.keywords:
                if kw.arg in ("target", "function"):
                    return kw.value
            if resolved == "threading.Thread" and call.args:
                return call.args[0]
            if resolved == "threading.Timer" and len(call.args) >= 2:
                return call.args[1]
        if isinstance(call.func, ast.Attribute) and call.func.attr in (
                "add_done_callback", "register_callback", "on_complete",
                "submit"):
            if call.args:
                return call.args[0]
        return None

    def _resolve_callable_body(self, expr: ast.AST) -> Optional[ast.AST]:
        """AST body of a handoff receiver: a same-class ``self._m``, a
        module function, or a project-indexed import."""
        attr = None
        if (isinstance(expr, ast.Attribute) and isinstance(expr.value, ast.Name)
                and expr.value.id == "self"):
            attr = expr.attr
            for stmt in self.scope_body:
                if (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                        and stmt.name == attr):
                    return stmt
            return None
        summary = self.project.resolve_function(self.mod, expr)
        if summary is not None:
            return summary.node
        return None

    def _make_handoff(self, call: ast.Call, pair: PairProtocol,
                      recv: str) -> Optional[Handoff]:
        target_expr = self._handoff_target(call)
        if target_expr is None:
            return None
        body = self._resolve_callable_body(target_expr)
        target_name = _recv_text(target_expr)
        if body is None:
            return Handoff(target=target_name, node=call,
                           resolved=False, target_closes=False)
        closes = _closes_in_tree(body, recv, pair.close,
                                 counter=(pair.kind == "counter"))
        return Handoff(target=target_name, node=call, resolved=True,
                       target_closes=closes)

    def _stmt_transfers(self, stmt: ast.stmt, tokens: Set[str],
                        pair: PairProtocol, recv: str):
        """(kind, handoff) when ``stmt`` moves the closing obligation,
        else None. Handoffs are checked first so JG029 sees them even when
        the generic argument rule would also match."""
        for n in _common.walk_excluding_defs(stmt):
            if isinstance(n, ast.Call):
                h = self._make_handoff(n, pair, recv)
                if h is not None:
                    hand_args = {a for arg in n.args
                                 for a in [_common.base_name(arg)] if a}
                    hand_args |= {a for kw in n.keywords
                                  for a in [_common.base_name(kw.value)] if a}
                    recv_base = recv.split(".")[0].split("[")[0]
                    if (tokens & hand_args
                            or h.target_closes
                            or (h.resolved and recv_base in ("self",))):
                        return "handoff", h
        if not tokens:
            return None
        for n in _common.walk_excluding_defs(stmt):
            if isinstance(n, (ast.Return, ast.Raise)):
                val = n.value if isinstance(n, ast.Return) else (
                    n.exc if n.exc is not None else None)
                if val is not None and tokens & _common.loaded_names(val):
                    return "returned", None
            if isinstance(n, ast.Assign):
                for t in n.targets:
                    if isinstance(t, (ast.Attribute, ast.Subscript)):
                        if tokens & _common.loaded_names(n.value):
                            return "stored", None
            if isinstance(n, ast.Call):
                if self._is_close_call(n, pair, recv):
                    continue
                arg_names = set()
                for arg in n.args:
                    b = _common.base_name(arg)
                    if b:
                        arg_names.add(b)
                    arg_names |= _common.loaded_names(arg)
                for kw in n.keywords:
                    arg_names |= _common.loaded_names(kw.value)
                if tokens & arg_names:
                    return "argument", None
        return None

    @staticmethod
    def _stmt_raises(stmt: ast.stmt) -> Optional[ast.AST]:
        """The first call inside ``stmt`` (nested defs excluded) — the
        statically visible "this statement can raise" marker."""
        for n in _common.walk_excluding_defs(stmt):
            if isinstance(n, ast.Call):
                return n
        return None

    # -- the forward scan ---------------------------------------------------
    def _scan_block(self, stmts, start, st) -> int:
        """Scan ``stmts[start:]`` with shared state ``st`` (dict carrying
        raising/hazard/partial-close info). Returns a scan outcome."""
        for stmt in stmts[start:]:
            out = self._scan_stmt(stmt, st)
            if out != self.FALL:
                return out
        return self.FALL

    def _scan_stmt(self, stmt, st) -> int:
        pair, recv, tokens = st["pair"], st["recv"], st["tokens"]
        # compound statements dispatch FIRST: a close buried in one arm of
        # an if/try or inside a loop body is not "this statement closes" —
        # the branch logic owns partial-close, loop-carried, and finally
        # semantics
        if isinstance(stmt, ast.If):
            return self._scan_if(stmt, st)
        if isinstance(stmt, ast.Try):
            return self._scan_try(stmt, st)
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                if self._stmt_raises(ast.Expr(item.context_expr)) is not None:
                    st.setdefault("raising", item.context_expr)
            return self._scan_block(stmt.body, 0, st)
        if isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            return self._scan_loop(stmt, st)
        if self._stmt_closes(stmt, pair, recv):
            if st.get("partial") is not None:
                self.result.issues.append(BalanceIssue(
                    pair=pair, recv=recv, kind="double-close", node=stmt,
                    method=self.qualname, prior=st["partial"]))
            st["closed_at"] = stmt
            return self.CLOSED
        tr = self._stmt_transfers(stmt, tokens, pair, recv)
        if tr is not None:
            st["transfer"], st["handoff"] = tr
            return self.TRANSFER
        if isinstance(stmt, (ast.Return, ast.Raise)):
            st["leak"] = ("early-exit", stmt)
            return self.LEAK
        if isinstance(stmt, ast.Continue):
            st["leak"] = ("loop-carried", stmt)
            return self.LEAK
        if isinstance(stmt, ast.Break):
            return self.BREAK
        r = self._stmt_raises(stmt)
        if r is not None:
            st.setdefault("raising", r)
        return self.FALL

    def _branch(self, stmts, st) -> Tuple[int, dict]:
        sub = {"pair": st["pair"], "recv": st["recv"],
               "tokens": st["tokens"]}
        if "raising" in st:
            sub["raising"] = st["raising"]
        out = self._scan_block(stmts, 0, sub)
        return out, sub

    @staticmethod
    def _block_departs(stmts) -> bool:
        """The block's last statement leaves the enclosing scope — a
        ``close(); return`` branch is DONE with the resource, so a close
        on the surviving path is not a double-close."""
        return bool(stmts) and isinstance(
            stmts[-1], (ast.Return, ast.Raise, ast.Continue, ast.Break))

    def _scan_if(self, stmt: ast.If, st) -> int:
        r = self._stmt_raises(ast.Expr(stmt.test))
        if r is not None:
            st.setdefault("raising", r)
        results = [(self._branch(stmt.body, st), stmt.body),
                   (self._branch(stmt.orelse, st), stmt.orelse)]
        for (out, sub), _stmts in results:
            if out == self.LEAK:
                st["leak"] = sub["leak"]
                return self.LEAK
        outs = [out for (out, _), _stmts in results]
        if all(o in (self.CLOSED, self.TRANSFER, self.BREAK) for o in outs):
            # BREAK branches jump past the loop; the close after the loop
            # still runs for them only if it is outside — approximated as
            # closed-with-the-others (the balance pass owns loop shapes)
            for (out, sub), _stmts in results:
                if out == self.CLOSED:
                    st["closed_at"] = sub.get("closed_at")
                    return self.CLOSED
            st["transfer"] = next(
                sub.get("transfer") for (out, sub), _stmts in results
                if out == self.TRANSFER)
            st["handoff"] = next(
                (sub.get("handoff") for (out, sub), _stmts in results
                 if out == self.TRANSFER), None)
            return self.TRANSFER
        for (out, sub), stmts in results:
            if out == self.CLOSED and not self._block_departs(stmts):
                # closed on one path, open on the other: remember — a
                # later close is a double-close on this path (JG028); an
                # end-of-function without one is a partial leak (JG027).
                # A branch that closes then EXITS already left the scope
                # and constrains nothing downstream.
                st["partial"] = sub.get("closed_at")
            if out == self.BREAK:
                return self.BREAK
            if "raising" in sub:
                st.setdefault("raising", sub["raising"])
        return self.FALL

    def _scan_try(self, stmt: ast.Try, st) -> int:
        pair, recv = st["pair"], st["recv"]
        if self._block_closes(stmt.finalbody, pair, recv):
            # finally closes: every path through the try is covered; a
            # hazard only exists in the gap BEFORE the try
            st["closed_at"] = stmt
            return self.CLOSED
        results = [(self._branch(stmt.body + stmt.orelse, st),
                    stmt.body + stmt.orelse)]
        for handler in stmt.handlers:
            results.append((self._branch(handler.body, st), handler.body))
        for (out, sub), _stmts in results:
            if out == self.LEAK:
                st["leak"] = sub["leak"]
                return self.LEAK
        outs = [out for (out, _), _stmts in results]
        if all(o in (self.CLOSED, self.TRANSFER) for o in outs):
            for (out, sub), _stmts in results:
                if out == self.CLOSED:
                    st["closed_at"] = sub.get("closed_at")
                    return self.CLOSED
            st["transfer"] = results[0][0][1].get("transfer") or "argument"
            st["handoff"] = results[0][0][1].get("handoff")
            return self.TRANSFER
        for (out, sub), stmts in results:
            if out == self.CLOSED and not self._block_departs(stmts):
                st["partial"] = sub.get("closed_at")
            if "raising" in sub:
                st.setdefault("raising", sub["raising"])
        if self._block_closes(stmt.finalbody, pair, recv):
            return self.CLOSED  # pragma: no cover - handled above
        out = self._scan_block(stmt.finalbody, 0, st)
        if out != self.FALL:
            return out
        return self.FALL

    def _scan_loop(self, stmt, st) -> int:
        pair, recv = st["pair"], st["recv"]
        if self._block_closes(stmt.body, pair, recv):
            # close inside a loop body for a resource opened outside it:
            # released 0 times if the body never runs, N times if it
            # iterates — the loop-carried-release shape (JG028)
            close_node = next(
                s for s in stmt.body if self._stmt_closes(s, pair, recv))
            self.result.issues.append(BalanceIssue(
                pair=pair, recv=recv, kind="loop-carried-release",
                node=close_node, method=self.qualname, prior=st["node"]))
            st["closed_at"] = close_node
            return self.CLOSED
        out, sub = self._branch(stmt.body, st)
        if out == self.TRANSFER:
            st["transfer"] = sub.get("transfer")
            st["handoff"] = sub.get("handoff")
            return self.TRANSFER
        if out == self.LEAK and sub["leak"][0] != "loop-carried":
            st["leak"] = sub["leak"]
            return self.LEAK
        if "raising" in sub:
            st.setdefault("raising", sub["raising"])
        return self.FALL

    # -- driving ------------------------------------------------------------
    def analyze(self) -> FunctionLifecycle:
        self._walk_block(self.fn.body, stack=[])
        self._balance_pass(self.fn.body, state={}, in_loop=False)
        return self.result

    def _enclosing_finally_closes(self, stack, pair, recv) -> bool:
        for stmts, idx, kind, node in stack:
            if (isinstance(node, ast.Try)
                    and self._block_closes(node.finalbody, pair, recv)):
                return True
        return False

    def _open_in_stmt(self, stmt):
        """(call, effective_position) for a tracked open in ``stmt``:
        ``"after"`` for ``if not x.acquire(...): <exit>`` conditional
        acquires (the open survives only past the guard), ``"here"``
        otherwise. Opens in other condition shapes are not tracked."""
        if isinstance(stmt, ast.If):
            test = stmt.test
            if (isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not)
                    and isinstance(test.operand, ast.Call)):
                m = self._match_open(test.operand)
                if m is not None and stmt.body and isinstance(
                        stmt.body[-1], (ast.Return, ast.Raise, ast.Continue)):
                    return test.operand, m, "after"
            return None
        if isinstance(stmt, (ast.Expr, ast.Assign)):
            val = stmt.value
            if isinstance(val, ast.Call):
                m = self._match_open(val)
                if m is not None:
                    # open consumed by its close in the same expression
                    # (``finalize(dispatch(...))``) is balanced inline
                    return val, m, "here"
        if (isinstance(stmt, ast.AugAssign) and isinstance(stmt.op, ast.Add)
                and isinstance(stmt.target, ast.Attribute)
                and isinstance(stmt.target.value, ast.Name)
                and stmt.target.value.id == "self"
                and stmt.target.attr in self.counter_attrs):
            pair = PairProtocol(open="+=", close="-=", kind="counter")
            return stmt, (pair, _recv_text(stmt.target)), "here"
        return None

    def _record_open(self, call, pair, recv, stmt, stack, effective_idx):
        # inline-balanced: the close call wraps the open in one statement
        if pair.kind != "counter" and any(
                self._is_close_call(n, pair, recv)
                for n in _common.walk_excluding_defs(stmt)):
            self.result.opens.append(OpenEvent(
                pair=pair, recv=recv, node=call, method=self.qualname,
                outcome="closed"))
            return
        if self._enclosing_finally_closes(stack, pair, recv):
            self.result.opens.append(OpenEvent(
                pair=pair, recv=recv, node=call, method=self.qualname,
                outcome="closed"))
            return
        tokens = (self._token_names(stmt, call, pair, recv)
                  if isinstance(call, ast.Call) else set())
        st = {"pair": pair, "recv": recv, "tokens": tokens, "node": call}
        out = self.FALL
        # innermost-out: scan the rest of each enclosing block
        for level in range(len(stack) - 1, -1, -1):
            stmts, idx, kind, node = stack[level]
            start = idx + 1 if level == len(stack) - 1 else idx + 1
            out = self._scan_block(stmts, start, st)
            if out == self.BREAK:
                # jump past the innermost enclosing loop
                while level > 0 and kind != "loop":
                    level -= 1
                    stmts, idx, kind, node = stack[level]
                out = self.FALL
                continue
            if out != self.FALL:
                break
            if kind == "loop":
                # fell off a loop body with the resource open: the next
                # iteration re-opens without closing
                st["leak"] = ("loop-carried", node)
                out = self.LEAK
                break
        ev = OpenEvent(pair=pair, recv=recv, node=call,
                       method=self.qualname, outcome="closed")
        if out == self.CLOSED:
            if "raising" in st:
                ev.outcome = "leak"
                ev.leak_kind = "exception-path"
                ev.hazard_node = st["raising"]
        elif out == self.TRANSFER:
            ev.outcome = "transferred"
            ev.transfer_kind = st.get("transfer")
            ev.handoff = st.get("handoff")
            if "raising" in st:
                # a raise-capable gap BEFORE the ownership moved: the
                # handoff never happens on the exception path
                ev.outcome = "leak"
                ev.leak_kind = "exception-path"
                ev.hazard_node = st["raising"]
        else:  # LEAK or fall-through
            kind_, node_ = st.get("leak", ("fall-through", call))
            if self._cross_scope_close(pair, recv):
                ev.outcome = "transferred"
                ev.transfer_kind = "cross-method"
            else:
                ev.outcome = "leak"
                ev.leak_kind = kind_
                ev.hazard_node = node_
        if st.get("partial") is not None and ev.outcome == "leak":
            ev.leak_kind = ev.leak_kind or "fall-through"
        self.result.opens.append(ev)

    def _cross_scope_close(self, pair: PairProtocol, recv: str) -> bool:
        """Close-half for ``recv`` in a *different* function of the same
        class/module scope — the instance-holds-the-resource idiom
        (``start``/``stop``): the obligation transfers to the peer."""
        if not (recv.startswith("self.") or "." not in recv):
            return False
        if self._stmt_closes_anywhere(self.fn, pair, recv):
            return False  # close in THIS function: protocol is local
        for stmt in self.scope_body:
            if (isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef))
                    and stmt is not self.fn
                    and self._stmt_closes_anywhere(stmt, pair, recv)):
                return True
        return False

    def _stmt_closes_anywhere(self, tree, pair, recv) -> bool:
        return _closes_in_tree(tree, recv, pair.close,
                               counter=(pair.kind == "counter"))

    def _walk_block(self, stmts, stack) -> None:
        for i, stmt in enumerate(stmts):
            found = self._open_in_stmt(stmt)
            if found is not None:
                call, (pair, recv), pos = found
                frame = stack + [(stmts, i, "body", stmt)]
                self._record_open(call, pair, recv, stmt, frame, i)
            # learn local constructor types in source order
            if isinstance(stmt, ast.Assign) and len(stmt.targets) == 1:
                self.env.learn(_recv_text(stmt.targets[0]), stmt.value)
            for child_stmts, kind in self._child_blocks(stmt):
                self._walk_block(
                    child_stmts, stack + [(stmts, i, kind, stmt)])

    @staticmethod
    def _child_blocks(stmt):
        if isinstance(stmt, ast.If):
            yield stmt.body, "body"
            yield stmt.orelse, "body"
        elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
            yield stmt.body, "loop"
            yield stmt.orelse, "body"
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            yield stmt.body, "body"
        elif isinstance(stmt, ast.Try):
            yield stmt.body, "try"
            for h in stmt.handlers:
                yield h.body, "body"
            yield stmt.orelse, "body"
            yield stmt.finalbody, "body"

    # -- the block-linear balance pass (JG028) ------------------------------
    def _balance_pass(self, stmts, state, in_loop) -> None:
        """Per-receiver open/closed state machine over straight-line
        blocks: a close in the CLOSED state is a double-close; a close in
        a state only opened by SOME preceding branch is a
        close-without-open. State resets to unknown at control joins the
        machine cannot follow."""
        for stmt in stmts:
            if isinstance(stmt, (ast.Expr, ast.Assign)) and isinstance(
                    getattr(stmt, "value", None), ast.Call):
                call = stmt.value
                m = self._match_open(call)
                if m is not None:
                    state[m[1] + "|" + m[0].close] = ("open", call)
                elif isinstance(call.func, ast.Attribute):
                    name = call.func.attr
                    recv = _recv_text(call.func.value)
                    opened = _SEEDED_CLOSE.get(name)
                    key = recv + "|" + name
                    if opened is not None and name in self.module_attrs:
                        pair = PairProtocol(open=opened, close=name,
                                            kind="seeded")
                        prev = state.get(key)
                        if prev is not None and prev[0] == "closed":
                            self.result.issues.append(BalanceIssue(
                                pair=pair, recv=recv, kind="double-close",
                                node=call, method=self.qualname,
                                prior=prev[1]))
                        elif prev is not None and prev[0] == "maybe":
                            self.result.issues.append(BalanceIssue(
                                pair=pair, recv=recv,
                                kind="close-without-open", node=call,
                                method=self.qualname, prior=prev[1]))
                        if prev is not None:
                            state[key] = ("closed", call)
            elif isinstance(stmt, ast.If):
                # a branch that opens without closing leaves the receiver
                # maybe-open at the join
                pre = dict(state)
                self._balance_pass(stmt.body, state, in_loop)
                other = dict(pre)
                self._balance_pass(stmt.orelse, other, in_loop)
                branch_exits = bool(stmt.body) and isinstance(
                    stmt.body[-1], (ast.Return, ast.Raise,
                                    ast.Continue, ast.Break))
                for key in set(state) | set(other):
                    a, b = state.get(key), other.get(key)
                    if branch_exits:
                        state[key] = b if b is not None else None
                        if state[key] is None:
                            state.pop(key, None)
                    elif a != b:
                        if a is not None and a[0] == "open" and (
                                b is None or b[0] != "open"):
                            state[key] = ("maybe", a[1])
                        elif b is not None and b[0] == "open" and (
                                a is None or a[0] != "open"):
                            state[key] = ("maybe", b[1])
                        else:
                            state.pop(key, None)
            elif isinstance(stmt, (ast.For, ast.AsyncFor, ast.While)):
                self._balance_pass(stmt.body, dict(state), True)
                state.clear()
            elif isinstance(stmt, ast.Try):
                self._balance_pass(stmt.body, state, in_loop)
                for h in stmt.handlers:
                    self._balance_pass(h.body, dict(state), in_loop)
                self._balance_pass(stmt.orelse, state, in_loop)
                self._balance_pass(stmt.finalbody, state, in_loop)
            elif isinstance(stmt, (ast.With, ast.AsyncWith)):
                self._balance_pass(stmt.body, state, in_loop)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue  # nested scopes analyzed separately
            elif isinstance(stmt, (ast.Return, ast.Raise)):
                state.clear()


def _analyze_function(mod, project, inferred, module_attrs, fn, qualprefix,
                      counter_attrs, scope_body) -> FunctionLifecycle:
    return _FnAnalysis(mod, project, inferred, module_attrs, fn,
                       qualprefix + fn.name, counter_attrs,
                       scope_body).analyze()
