"""torchlint phase 1½ — the concurrency index (thread-safety summaries).

PRs 11–15 made nearly every plane of this repo run its own threads: the
micro-batcher's worker/completer pair, the router's health loop, the
autoscaler tick, the reload controller, the alert evaluator, the engine
warm-up thread. Lock discipline across those planes was policed statically
in exactly two narrow slices (JG016's ``swap*`` classes, JG022's variant
tables) and dynamically by drills that only catch races probabilistically.
This module generalizes the static side: a whole-program summary of *who
runs on which thread* and *which lock each shared access sits under*, so
rules JG024–JG026 can check synchronization invariants mechanically.

Per analyzed module it discovers **thread entry points**:

- ``threading.Thread(target=self.m, ...)`` / ``threading.Timer(dt, self.m)``
  anywhere in a class (the daemon-loop-launched-in-``__init__``/``start``
  idiom every plane here uses) marks ``m`` as running on a spawned thread;
- ``run`` of a ``threading.Thread`` subclass;
- ``do_*``/``handle*`` methods of ``BaseHTTPRequestHandler`` subclasses
  (each request runs them on a ``ThreadingHTTPServer`` pool thread; the
  handler *instance* is per-request, so these mark the class as threaded
  without making its instance attributes shared state — see
  :attr:`ClassConcurrency.instance_shared`).

and computes a :class:`MethodConcurrency` per method: every ``self.<attr>``
load/store with the set of locks lexically held at that point (``with
self._lock:`` scopes; condition variables constructed over a lock alias to
that lock), the ordered lock-acquisition sequence with the held-set at each
acquisition, the same-class calls made with locks held (the one-hop lens
JG025/JG026 follow), and every known *blocking* call (JG017's network set,
``time.sleep``, thread/process ``.join``, ``subprocess``, device sync) with
the locks held around it. A call-site propagation pass marks private
helpers whose every in-class call site holds lock L as guarded-by-L, so
the ``_flush_locked``-style convention does not read as an escape.

Lock identities **unify across classes** where the sharing is statically
visible: a lock passed through a constructor (``Worker(lock=self._lock)``
where ``Worker.__init__`` does ``self._lk = lock``) and a lock planted by
attribute assignment (``worker._lk = self._lock`` on an object whose
class resolves) collapse into one canonical id in a project-wide
union-find, so JG025's acquisition graph spans planes instead of
stopping at the class boundary — the false-negative class the first
concurrency PR documented.

Everything is statically visible facts only. Known false-negative classes
(documented here once, referenced by the rules): ``.acquire()``/
``.release()`` pairs outside ``with`` are not tracked (the *lifecycle*
index owns that pairing — JG027/JG028); module-global state shared by
module-level thread targets is not modeled (only classes are); locks
reached through cross-class attribute chains (``self.registry.lock`` vs
the registry's own ``self.lock``) unify only via the constructor/
assignment routes above, not by chained attribute typing; nested
``def``/``lambda`` bodies are separate scopes (a closure may run on
another thread after the ``with`` exited — the same rule JG022 applies).
"""

from __future__ import annotations

import ast
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.rules.net_timeout import NETWORK_CALLS

#: with-context attribute names that count as a lock even without "lock"
#: in the name (JG016's set, kept in sync)
LOCK_NAMES = {"_cv", "cv", "_cond", "cond", "_condition", "condition",
              "_mutex", "mutex"}

#: threading constructors whose instances are locks (assignment to
#: ``self.<attr>`` in any method makes ``<attr>`` a known lock attribute)
_LOCK_CTORS = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore",
}

#: method names on a container that mutate it — a load of ``self._queue``
#: that feeds ``.append`` is a *mutating use* even though the attribute is
#: never rebound. Only counted on attributes initialized to a container
#: (literal or known ctor): ``self.watcher.discard(...)`` on a domain
#: object shares a name with ``set.discard`` but mutates no shared dict.
_MUTATORS = {
    "append", "appendleft", "add", "insert", "extend", "update", "remove",
    "discard", "pop", "popleft", "popitem", "clear", "setdefault", "sort",
    "reverse", "put", "put_nowait",
}

#: resolved constructors whose result is a mutable container
_CONTAINER_CTORS = {
    "list", "dict", "set", "collections.deque", "collections.defaultdict",
    "collections.Counter", "collections.OrderedDict", "queue.Queue",
    "queue.SimpleQueue", "queue.PriorityQueue", "queue.LifoQueue",
}

#: resolved callables that block the calling thread (JG026's direct set):
#: JG017's network calls, process spawns, sleeps, and device sync
BLOCKING_CALLS = (
    set(NETWORK_CALLS)
    | _common.SPAWN_CALLS
    | {"time.sleep", "jax.block_until_ready",
       "subprocess.Popen.wait", "os.waitpid"}
)


@dataclasses.dataclass
class Access:
    """One ``self.<attr>`` touch inside a method."""

    attr: str
    node: ast.AST
    method: str
    is_store: bool       # rebind / aug-assign / subscript-store target
    is_mutating: bool    # is_store OR a mutator-method call on the attr
    held: FrozenSet[str]  # canonical lock ids lexically held at the access


@dataclasses.dataclass
class LockAcquisition:
    """One ``with <lock>:`` entry, with what was already held."""

    lock: str
    node: ast.AST
    method: str
    held_before: FrozenSet[str]


@dataclasses.dataclass
class SelfCall:
    """A ``self.m(...)`` call site, with the locks held around it."""

    callee: str
    node: ast.AST
    method: str
    held: FrozenSet[str]


@dataclasses.dataclass
class BlockingCall:
    """A known-blocking call, with the locks held around it."""

    label: str
    node: ast.AST
    method: str
    held: FrozenSet[str]


@dataclasses.dataclass
class MethodConcurrency:
    """What the rules may assume about one method without re-reading it."""

    name: str
    node: ast.AST
    accesses: List[Access] = dataclasses.field(default_factory=list)
    acquisitions: List[LockAcquisition] = dataclasses.field(
        default_factory=list)
    self_calls: List[SelfCall] = dataclasses.field(default_factory=list)
    blocking: List[BlockingCall] = dataclasses.field(default_factory=list)
    #: locks every in-class call site provably holds (call-site propagation)
    caller_held: FrozenSet[str] = frozenset()


@dataclasses.dataclass
class ClassConcurrency:
    """Per-class (or per-module-scope) concurrency summary."""

    name: str
    path: str
    node: Optional[ast.AST]
    methods: Dict[str, MethodConcurrency] = dataclasses.field(
        default_factory=dict)
    #: method name -> how it becomes a thread entry ("thread-target",
    #: "timer", "run-override", "http-handler")
    entry_points: Dict[str, str] = dataclasses.field(default_factory=dict)
    lock_attrs: Set[str] = dataclasses.field(default_factory=set)
    #: Condition-over-lock / rebinding aliases, attr -> canonical attr
    lock_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)
    #: attrs initialized to a mutable container — the only attrs a
    #: ``.append``-style call counts as mutating
    container_attrs: Set[str] = dataclasses.field(default_factory=set)
    #: False for BaseHTTPRequestHandler subclasses: instances are
    #: per-request, so ``self.<attr>`` is NOT cross-thread shared state
    instance_shared: bool = True
    #: ``__init__`` positional parameter names (self excluded), for
    #: matching constructor-injection call sites positionally
    init_params: List[str] = dataclasses.field(default_factory=list)
    #: ``__init__`` param name -> ``self`` attr it is forwarded into
    #: (``self._lk = lock``) — the receiving half of lock injection
    init_param_attrs: Dict[str, str] = dataclasses.field(
        default_factory=dict)
    #: ``self`` attr -> resolved constructor dotted name (``self.worker =
    #: Worker(...)``), for typing ``self.worker._lk = ...`` assignments
    attr_types: Dict[str, str] = dataclasses.field(default_factory=dict)

    def canonical_lock(self, attr: str) -> str:
        seen = set()
        while attr in self.lock_aliases and attr not in seen:
            seen.add(attr)
            attr = self.lock_aliases[attr]
        return attr

    def lock_id(self, attr: str) -> str:
        """Index-wide id for a ``self.<attr>`` lock of this class."""
        return f"{self.name}.{self.canonical_lock(attr)}"

    # -- thread contexts ---------------------------------------------------
    def call_closure(self, start: str) -> Set[str]:
        """``start`` plus every same-class method reachable from it."""
        out, stack = set(), [start]
        while stack:
            m = stack.pop()
            if m in out:
                continue
            out.add(m)
            mc = self.methods.get(m)
            if mc is not None:
                stack.extend(c.callee for c in mc.self_calls
                             if c.callee in self.methods)
        return out

    def thread_contexts(self) -> List[Tuple[str, Set[str]]]:
        """(label, method set) per concurrent context: one per spawned
        entry point, plus ``<caller>`` for everything not exclusively
        reached from a spawned thread (public API runs on whatever thread
        calls it). Empty when the class spawns nothing."""
        if not self.entry_points:
            return []
        ctxs: List[Tuple[str, Set[str]]] = []
        covered: Set[str] = set()
        for ep in sorted(self.entry_points):
            closure = self.call_closure(ep)
            ctxs.append((ep, closure))
            covered |= closure
        external = set(self.methods) - covered - {"__init__"}
        if external:
            ctxs.append(("<caller>", external))
        return ctxs


def _self_attr(node: ast.AST) -> Optional[str]:
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def _is_lockish_name(name: str) -> bool:
    return "lock" in name.lower() or name in LOCK_NAMES


class ConcurrencyIndex:
    """Lazy per-path cache of :class:`ClassConcurrency` summaries. Built
    from the project index's parsed modules on first use by a rule, so
    runs that exclude JG024–JG026 pay nothing for it."""

    def __init__(self, project) -> None:
        self._project = project
        self._cache: Dict[str, List[ClassConcurrency]] = {}
        self._lock_parent: Optional[dict] = None  # union-find forest
        self._global_edges: Optional[dict] = None
        #: (path, class name) -> attrs taught to be locks by cross-class
        #: plants (``worker._lk = self._lock`` where ``_lk`` is never
        #: constructed locally)
        self._extra_locks: Dict[tuple, Set[str]] = {}
        self._new_extras: Dict[tuple, Set[str]] = {}

    def classes(self, path: str) -> List[ClassConcurrency]:
        """Summaries for every class in ``path`` (nested classes included)
        plus one module-scope pseudo-entry holding the module-level
        functions (for lock-order analysis over module-global locks)."""
        if path not in self._cache:
            info = self._project.by_path.get(path)
            extras = {cls: attrs for (p, cls), attrs
                      in self._extra_locks.items() if p == path}
            self._cache[path] = (
                [] if info is None
                else _build_module(info.srcmod, extras))
        return self._cache[path]

    # -- cross-class lock unification ---------------------------------------
    # Lock ids are per-module pairs ``(module_name, short_id)`` so two
    # unrelated classes that happen to share a name never collide; the
    # union-find collapses pairs that provably alias ONE runtime lock:
    # constructor injection (``Worker(lock=self._lock)`` forwarded into
    # ``self._lk``) and attribute planting (``worker._lk = self._lock``
    # on an object whose class resolves through the project index).

    def _all(self) -> List[tuple]:
        out = []
        for path in sorted(self._project.by_path):
            info = self._project.by_path[path]
            for cc in self.classes(path):
                out.append((info, cc))
        return out

    def _find(self, key: tuple) -> tuple:
        p = self._lock_parent
        while p.get(key, key) != key:
            p[key] = p.get(p[key], p[key])  # path halving
            key = p[key]
        return key

    def _union(self, a: tuple, b: tuple) -> None:
        ra, rb = self._find(a), self._find(b)
        if ra == rb:
            return
        # deterministic root: lexicographically smallest key wins, so
        # canonical ids are stable across module orderings
        root, child = (ra, rb) if ra <= rb else (rb, ra)
        self._lock_parent[child] = root

    def canonical(self, module_name: str, lock_id: str) -> tuple:
        """Project-wide canonical identity of a per-module lock id."""
        self._ensure_unified()
        return self._find((module_name, lock_id))

    def _ensure_unified(self) -> None:
        if self._lock_parent is not None:
            return
        # a plant can TEACH a class that an attr it never constructs is
        # a lock (``worker._lk = self._lock`` into ``self._lk = None``) —
        # its summary must be rebuilt so ``with self._lk:`` registers as
        # an acquisition, then the scan repeats; bounded because plants
        # of planted locks are rare and each round only adds attrs
        for _ in range(4):
            self._lock_parent = {}
            self._new_extras = {}
            everything = self._all()
            class_map: Dict[str, tuple] = {}
            for info, cc in everything:
                if cc.node is not None:
                    class_map[f"{info.name}.{cc.name}"] = (info, cc)
            for info, cc in everything:
                encl = cc if cc.node is not None else None
                for name in sorted(cc.methods):
                    self._scan_sharing(info, encl, cc.methods[name].node,
                                       class_map)
            fresh = {k: v - self._extra_locks.get(k, set())
                     for k, v in self._new_extras.items()}
            fresh = {k: v for k, v in fresh.items() if v}
            if not fresh:
                break
            for key, attrs in fresh.items():
                self._extra_locks.setdefault(key, set()).update(attrs)
                self._cache.pop(key[0], None)

    def _resolve_class(self, info, func_expr: ast.AST,
                       class_map: dict) -> Optional[tuple]:
        resolved = info.srcmod.resolve(func_expr)
        if resolved is None:
            return None
        canon = self._project._canonical_call(info, resolved)
        return class_map.get(canon)

    def _lock_expr_id(self, info, encl: Optional[ClassConcurrency],
                      expr: ast.AST) -> Optional[tuple]:
        """(module, short_id) when ``expr`` denotes a known lock in the
        enclosing scope, else None."""
        attr = _self_attr(expr)
        if attr is not None:
            if encl is not None and (attr in encl.lock_attrs
                                     or _is_lockish_name(attr)):
                return (info.name, encl.lock_id(attr))
            return None
        if isinstance(expr, ast.Name) and _is_lockish_name(expr.id):
            return (info.name, expr.id)
        return None

    def _scan_sharing(self, info, encl, fn, class_map: dict) -> None:
        # local var -> (info, cc) of its constructed class, in source
        # order (good enough: sharing sites follow their constructions)
        local_types: Dict[str, tuple] = {}
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and len(node.targets) == 1:
                tgt = node.targets[0]
                if isinstance(node.value, ast.Call) and isinstance(
                        tgt, ast.Name):
                    owner = self._resolve_class(info, node.value.func,
                                                class_map)
                    if owner is not None:
                        local_types[tgt.id] = owner
                if isinstance(tgt, ast.Attribute):
                    lock = self._lock_expr_id(info, encl, node.value)
                    if lock is not None:
                        owner = self._owner_of(tgt.value, local_types,
                                               info, encl, class_map)
                        if owner is not None:
                            oinfo, occ = owner
                            self._union(lock, (oinfo.name,
                                               occ.lock_id(tgt.attr)))
                            if tgt.attr not in occ.lock_attrs:
                                self._new_extras.setdefault(
                                    (oinfo.path, occ.name),
                                    set()).add(tgt.attr)
            if isinstance(node, ast.Call):
                target = self._resolve_class(info, node.func, class_map)
                if target is None:
                    continue
                tinfo, tcc = target
                for i, arg in enumerate(node.args):
                    if i < len(tcc.init_params):
                        self._unify_arg(info, encl, arg, tinfo, tcc,
                                        tcc.init_params[i])
                for kw in node.keywords:
                    if kw.arg is not None:
                        self._unify_arg(info, encl, kw.value, tinfo, tcc,
                                        kw.arg)

    def _unify_arg(self, info, encl, arg, tinfo, tcc, param: str) -> None:
        lock = self._lock_expr_id(info, encl, arg)
        attr = tcc.init_param_attrs.get(param)
        if lock is None or attr is None:
            return
        self._union(lock, (tinfo.name, tcc.lock_id(attr)))

    def _owner_of(self, expr, local_types, info, encl,
                  class_map) -> Optional[tuple]:
        """(info, cc) of the class of ``expr`` (a receiver being planted
        with a lock): a local constructed in this function, or a ``self``
        attr the enclosing class constructed."""
        if isinstance(expr, ast.Name):
            return local_types.get(expr.id)
        attr = _self_attr(expr)
        if attr is not None and encl is not None:
            ctor = encl.attr_types.get(attr)
            if ctor is not None:
                canon = self._project._canonical_call(info, ctor)
                return class_map.get(canon)
        return None

    def global_lock_edges(self) -> dict:
        """The project-wide acquisition graph over canonical lock ids:
        ``(A, B) -> (path, node, where)`` of the first site that takes B
        while holding A (lexical nesting plus the one-hop same-class call
        lens). Deterministic: modules in sorted-path order, methods
        sorted, so "first" is stable across runs."""
        self._ensure_unified()
        if self._global_edges is not None:
            return self._global_edges
        edges: dict = {}

        def add(mname, path, held, lock, node, where):
            lk = self._find((mname, lock))
            for h in held:
                hh = self._find((mname, h))
                if hh != lk and (hh, lk) not in edges:
                    edges[(hh, lk)] = (path, node, where)

        for info, cc in self._all():
            for name in sorted(cc.methods):
                mc = cc.methods[name]
                for acq in mc.acquisitions:
                    add(info.name, info.path, acq.held_before, acq.lock,
                        acq.node, f"{cc.name}.{name}")
                for call in mc.self_calls:
                    if not call.held:
                        continue
                    callee = cc.methods.get(call.callee)
                    if callee is None:
                        continue
                    for acq in callee.acquisitions:
                        add(info.name, info.path, call.held, acq.lock,
                            call.node, f"{cc.name}.{name} -> {call.callee}")
        self._global_edges = edges
        return edges


def build(project) -> ConcurrencyIndex:
    return ConcurrencyIndex(project)


# -- construction -----------------------------------------------------------

def _build_module(mod, extra_locks=None) -> List[ClassConcurrency]:
    out: List[ClassConcurrency] = []
    class_nodes: List[ast.ClassDef] = [
        n for n in ast.walk(mod.tree) if isinstance(n, ast.ClassDef)]
    for cls in class_nodes:
        out.append(_build_class(
            mod, cls, (extra_locks or {}).get(cls.name, set())))
    # module-scope pseudo-class: top-level functions + module locks, so
    # JG025 sees ``with _capture_lock:`` nesting outside any class
    scope = ClassConcurrency(name="<module>", path=mod.path, node=None)
    for n in mod.tree.body:
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            scope.methods[n.name] = _analyze_function(mod, scope, n)
    if scope.methods:
        out.append(scope)
    return out


def _build_class(mod, cls: ast.ClassDef,
                 extra_locks=frozenset()) -> ClassConcurrency:
    cc = ClassConcurrency(name=cls.name, path=mod.path, node=cls)
    # attrs taught to be locks by cross-class plants (unification pass)
    cc.lock_attrs.update(extra_locks)
    methods = [n for n in cls.body
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    method_names = {m.name for m in methods}

    # base classes: Thread subclasses run ``run`` on a spawned thread;
    # HTTP handler subclasses run ``do_*`` on server pool threads with a
    # fresh instance per request
    for base in cls.bases:
        resolved = mod.resolve(base) or ""
        if resolved == "threading.Thread" and "run" in method_names:
            cc.entry_points["run"] = "run-override"
        if resolved.endswith("BaseHTTPRequestHandler"):
            cc.instance_shared = False
            for m in method_names:
                if m.startswith("do_") or m.startswith("handle"):
                    cc.entry_points[m] = "http-handler"

    # lock attributes + aliases, from assignments in any method
    for m in methods:
        for node in ast.walk(m):
            if not (isinstance(node, ast.Assign) and len(node.targets) == 1):
                continue
            attr = _self_attr(node.targets[0])
            if attr is None:
                continue
            if isinstance(node.value, (ast.List, ast.Dict, ast.Set,
                                       ast.ListComp, ast.DictComp,
                                       ast.SetComp)):
                cc.container_attrs.add(attr)
            if isinstance(node.value, ast.Call):
                ctor = mod.resolve(node.value.func)
                if ctor in _CONTAINER_CTORS:
                    cc.container_attrs.add(attr)
                if ctor in _LOCK_CTORS:
                    cc.lock_attrs.add(attr)
                    # Condition(self._lock): holding the condition IS
                    # holding the lock — alias them
                    if (ctor == "threading.Condition" and node.value.args):
                        inner = _self_attr(node.value.args[0])
                        if inner is not None:
                            cc.lock_aliases[attr] = inner
                            cc.lock_attrs.add(inner)
            other = _self_attr(node.value)
            if other is not None and (other in cc.lock_attrs
                                      or _is_lockish_name(other)):
                cc.lock_aliases[attr] = other

    # __init__ signature + param->attr forwarding and attr constructor
    # types — the raw material of cross-class lock unification
    for m in methods:
        if m.name == "__init__":
            names = [a.arg for a in m.args.posonlyargs + m.args.args]
            if names and names[0] in ("self", "cls"):
                names = names[1:]
            cc.init_params = names
            valid = set(names) | {a.arg for a in m.args.kwonlyargs}
            for node in ast.walk(m):
                if (isinstance(node, ast.Assign) and len(node.targets) == 1
                        and isinstance(node.value, ast.Name)
                        and node.value.id in valid):
                    attr = _self_attr(node.targets[0])
                    if attr is not None:
                        cc.init_param_attrs[node.value.id] = attr
                        # a lockish PARAM forwarded into any attr makes
                        # that attr a lock (``self._lk = lock``) — the
                        # receiving half of constructor injection
                        if _is_lockish_name(node.value.id):
                            cc.lock_attrs.add(attr)
        for node in ast.walk(m):
            if (isinstance(node, ast.Assign) and len(node.targets) == 1
                    and isinstance(node.value, ast.Call)):
                attr = _self_attr(node.targets[0])
                ctor = mod.resolve(node.value.func)
                if attr is not None and ctor is not None:
                    cc.attr_types.setdefault(attr, ctor)

    # spawned-thread entry points: Thread(target=self.m) / Timer(dt, self.m)
    for m in methods:
        for node in ast.walk(m):
            if not isinstance(node, ast.Call):
                continue
            resolved = mod.resolve(node.func)
            target = None
            if resolved == "threading.Thread":
                for kw in node.keywords:
                    if kw.arg == "target":
                        target = _self_attr(kw.value)
                if node.args:
                    target = target or _self_attr(node.args[0])
                kind = "thread-target"
            elif resolved == "threading.Timer":
                for kw in node.keywords:
                    if kw.arg == "function":
                        target = _self_attr(kw.value)
                if len(node.args) >= 2:
                    target = target or _self_attr(node.args[1])
                kind = "timer"
            else:
                continue
            if target is not None and target in method_names:
                cc.entry_points.setdefault(target, kind)

    for m in methods:
        cc.methods[m.name] = _analyze_function(mod, cc, m)
    _propagate_callsite_guards(cc)
    return cc


def _lock_id_for_context(cc: ClassConcurrency,
                         expr: ast.AST) -> Optional[str]:
    """Canonical lock id for a ``with`` context expression, else None.
    ``self.<attr>`` locks are class-qualified; other expressions (module
    globals, ``registry.lock``) use their source text."""
    attr = _self_attr(expr)
    if attr is not None:
        if attr in cc.lock_attrs or _is_lockish_name(attr):
            return cc.lock_id(attr)
        return None
    if isinstance(expr, ast.Name) and _is_lockish_name(expr.id):
        return expr.id
    if isinstance(expr, ast.Attribute) and _is_lockish_name(expr.attr):
        try:
            return ast.unparse(expr)
        except Exception:  # pragma: no cover - unparse handles these
            return None
    return None


def _blocking_label(mod, node: ast.Call) -> Optional[str]:
    """Label when ``node`` is a known-blocking call, else None."""
    resolved = mod.resolve(node.func)
    if resolved in BLOCKING_CALLS:
        return resolved
    if isinstance(node.func, ast.Attribute):
        name = node.func.attr
        if name == "block_until_ready":
            return ".block_until_ready"
        if name == "join":
            # thread/process join, not str.join: str.join always takes the
            # iterable positionally, so no-arg / numeric-timeout / kwarg
            # shapes are unambiguous
            base_is_str = (isinstance(node.func.value, ast.Constant)
                           and isinstance(node.func.value.value, str))
            numeric = (len(node.args) == 1
                       and isinstance(node.args[0], ast.Constant)
                       and isinstance(node.args[0].value, (int, float)))
            timeout_kw = any(kw.arg == "timeout" for kw in node.keywords)
            if not base_is_str and (not node.args or numeric or timeout_kw):
                return ".join"
    return None


def _analyze_function(mod, cc: ClassConcurrency,
                      fn) -> MethodConcurrency:
    mc = MethodConcurrency(name=fn.name, node=fn)

    def visit(node: ast.AST, held: FrozenSet[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)) and node is not fn:
            return  # closures are separate scopes (may run on any thread)
        if isinstance(node, (ast.With, ast.AsyncWith)):
            acquired = []
            for item in node.items:
                visit(item.context_expr, held)
                lock = _lock_id_for_context(cc, item.context_expr)
                if lock is not None:
                    mc.acquisitions.append(LockAcquisition(
                        lock=lock, node=item.context_expr, method=fn.name,
                        held_before=held))
                    acquired.append(lock)
            inner = held | frozenset(acquired)
            for child in node.body:
                visit(child, inner)
            return
        if isinstance(node, ast.Call):
            label = _blocking_label(mod, node)
            if label is not None:
                mc.blocking.append(BlockingCall(
                    label=label, node=node, method=fn.name, held=held))
            if isinstance(node.func, ast.Attribute):
                base_attr = _self_attr(node.func.value)
                if (base_attr is not None and node.func.attr in _MUTATORS
                        and base_attr in cc.container_attrs):
                    # self._queue.append(x): mutating use of _queue
                    mc.accesses.append(Access(
                        attr=base_attr, node=node.func.value,
                        method=fn.name, is_store=False, is_mutating=True,
                        held=held))
                    for arg in node.args:
                        visit(arg, held)
                    for kw in node.keywords:
                        visit(kw.value, held)
                    return
                callee = _self_attr(node.func)
                if callee is not None:
                    mc.self_calls.append(SelfCall(
                        callee=callee, node=node, method=fn.name,
                        held=held))
        if isinstance(node, ast.Subscript):
            attr = _self_attr(node.value)
            if attr is not None and isinstance(node.ctx, (ast.Store, ast.Del)):
                # self._tbl[k] = v: mutating use of _tbl
                mc.accesses.append(Access(
                    attr=attr, node=node.value, method=fn.name,
                    is_store=False, is_mutating=True, held=held))
                visit(node.slice, held)
                return
        attr = _self_attr(node)
        if attr is not None:
            is_store = isinstance(node.ctx, (ast.Store, ast.Del))
            mc.accesses.append(Access(
                attr=attr, node=node, method=fn.name,
                is_store=is_store, is_mutating=is_store, held=held))
        for child in ast.iter_child_nodes(node):
            visit(child, held)

    for stmt in fn.body:
        visit(stmt, frozenset())
    return mc


def _propagate_callsite_guards(cc: ClassConcurrency) -> None:
    """Fixpoint: a private (or ``*_locked``) non-entry method whose EVERY
    in-class call site holds lock L is itself guarded by L — its accesses
    are not escapes. Public methods never inherit guards (they are
    callable from anywhere, lockless)."""
    sites: Dict[str, List[SelfCall]] = {}
    for mc in cc.methods.values():
        for call in mc.self_calls:
            if call.callee in cc.methods:
                sites.setdefault(call.callee, []).append(call)
    for _ in range(len(cc.methods) or 1):
        changed = False
        for name, mc in cc.methods.items():
            if name in cc.entry_points:
                continue
            if not (name.startswith("_") or name.endswith("_locked")):
                continue
            own = sites.get(name)
            if not own:
                continue
            inter: Optional[FrozenSet[str]] = None
            for call in own:
                eff = call.held | cc.methods[call.method].caller_held
                inter = eff if inter is None else (inter & eff)
            inter = inter or frozenset()
            if inter != mc.caller_held:
                mc.caller_held = inter
                changed = True
        if not changed:
            break
