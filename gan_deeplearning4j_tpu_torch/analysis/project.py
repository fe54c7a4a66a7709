"""torchlint phase 1 — the project index.

A single-file pass cannot see the hazards the port's rules look for: a host
read two calls below a captured body, a timed window whose device work sits
in a helper a module away, a capture constructed in a helper that a loop
calls. This module builds the cross-module picture:

- a **module graph**: every analyzed file gets a dotted module name derived
  from its path, and its import map is absolutized against that name (so
  ``from .capture import capture_guard`` inside
  ``gan_deeplearning4j_tpu_torch.runtime`` resolves to
  ``gan_deeplearning4j_tpu_torch.runtime.capture.capture_guard``);
- a **symbol table** of top-level functions/classes/methods per module;
- a :class:`FunctionSummary` per function: positional parameters, which of
  them are generators, which resolved callables it calls (and which of
  those it calls inside a capture region), whether it reads a device value
  on the host or fences (``.item()``/``.cpu()``/``.tolist()``/``.numpy()``,
  ``torch.cuda.synchronize``, an event's or a stream's ``synchronize``),
  whether it launches device work (a ``torch.*`` op, a ``@`` product or a
  graph replay),
  and which names it binds to a captured graph's static inputs and
  outputs;
- **transitive facts** over the intra-project call graph: the host-read
  taint, the device-work taint and the synchronous-I/O taint (a function
  that reaches one through its callees), the parameters whose value
  reaches ``manual_seed`` (directly or handed down), and whether a function
  runs inside a capture (it is called, transitively, from a
  ``with torch.cuda.graph(...)`` body or from between ``capture_begin``
  and ``capture_end``);
- **replayers**: functions that ``replay()`` a captured graph and return
  its static output (or an alias of it) with no copy between, where the
  output outlives the call: an attribute the module binds inside a capture
  (``cap.y``, ``self.y``) read off the object whose graph was replayed, or
  a module global bound inside a capture. A caller that holds one call's
  result across a second call reads the second call's result. Module-level
  names bound to a replayer, or to a ``functools.partial`` over one, are
  recorded per module.

Phase 2 (the rules) receives the index as ``mod.project`` on every
:class:`~.engine.SourceModule`. Everything here is stdlib-only and purely
syntactic — the index records what is *statically visible*, and rules are
expected to treat absence of a summary as "unknown", never as "safe".
"""

from __future__ import annotations

import ast
import dataclasses
import functools
import os
from typing import Dict, FrozenSet, List, Optional, Set, Tuple

from gan_deeplearning4j_tpu_torch.analysis import _common

_GENERATOR_PARAM_SUFFIXES = ("_generator",)

#: ``torch.*`` callables that run on the host only: no kernel is queued
_HOST_ONLY_TORCH = {
    "torch.device", "torch.dtype", "torch.Generator", "torch.Size",
    "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
    "torch.is_tensor", "torch.is_floating_point", "torch.manual_seed",
    "torch.get_default_dtype", "torch.set_default_dtype",
    "torch.set_num_threads", "torch.get_num_threads", "torch.finfo",
    "torch.iinfo", "torch.set_grad_enabled", "torch.is_grad_enabled",
    "torch.use_deterministic_algorithms", "torch.compile",
}


def module_name_for_path(relpath: str) -> str:
    """Dotted module name for an engine-relative path:
    ``gan_deeplearning4j_tpu_torch/harness/config.py`` ->
    ``gan_deeplearning4j_tpu_torch.harness.config``; a package
    ``__init__.py`` names the package itself; ``chip_smoke.py`` ->
    ``chip_smoke``."""
    norm = relpath.replace(os.sep, "/")
    if norm.endswith(".py"):
        norm = norm[:-3]
    parts = [p for p in norm.split("/") if p not in ("", ".")]
    if parts and parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def looks_like_generator_param(arg: ast.arg, resolve) -> bool:
    """A parameter annotated ``torch.Generator`` or named ``generator`` /
    ``*_generator``."""
    if arg.annotation is not None:
        ann = arg.annotation
        if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
            if ann.value.rpartition(".")[2] == "Generator":
                return True
        elif resolve(ann) in _common.GENERATOR_CONSTRUCTORS:
            return True
    low = arg.arg.lower()
    return low == "generator" or low.endswith(_GENERATOR_PARAM_SUFFIXES)


def is_device_call(call: ast.Call, resolve) -> bool:
    """A call that queues device work, as far as a glance can tell: a
    graph's ``replay()``, or a ``torch.*`` callable outside the host-only
    set and outside ``torch.cuda``'s queries."""
    if (isinstance(call.func, ast.Attribute) and call.func.attr == "replay"
            and not call.args):
        return True
    resolved = resolve(call.func) or ""
    if not resolved.startswith("torch.") or resolved in _HOST_ONLY_TORCH:
        return False
    if resolved.startswith(("torch.cuda.", "torch.distributed.",
                            "torch.utils.", "torch.backends.",
                            "torch.profiler.", "torch.autograd.profiler.")):
        return False
    return not _common.is_host_read(call, resolve)


def capture_regions(body, resolve) -> List[Tuple[ast.AST, List[ast.AST], str]]:
    """``(anchor, nodes, graph_text)`` for every capture region in a
    statement list, nested defs excluded: the body of each
    ``with torch.cuda.graph(g)`` (``anchor`` the ``with``), and the nodes
    strictly between ``g.capture_begin(...)`` and the matching
    ``g.capture_end()`` in the same function (``anchor`` the begin call).
    ``graph_text`` is the source text of ``g``."""
    out = []
    nodes = list(_common.walk_excluding_defs(body))
    for n in nodes:
        if isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                ctx = item.context_expr
                if (isinstance(ctx, ast.Call)
                        and resolve(ctx.func) in _common.CAPTURE_CONTEXTS):
                    graph = ast.unparse(ctx.args[0]) if ctx.args else "?"
                    inner = list(_common.walk_excluding_defs(n.body))
                    out.append((n, inner, graph))
                    break
    begins = [n for n in nodes if isinstance(n, ast.Call)
              and isinstance(n.func, ast.Attribute)
              and n.func.attr == _common.CAPTURE_BEGIN_METHOD]
    for begin in begins:
        graph = ast.unparse(begin.func.value)
        ends = [n.lineno for n in nodes if isinstance(n, ast.Call)
                and isinstance(n.func, ast.Attribute)
                and n.func.attr == _common.CAPTURE_END_METHOD
                and ast.unparse(n.func.value) == graph
                and n.lineno > begin.lineno]
        stop = min(ends) if ends else float("inf")
        inner = [n for n in nodes
                 if begin.lineno < getattr(n, "lineno", 0) < stop]
        out.append((begin, inner, graph))
    return out


def graphed_callable_names(body, resolve) -> List[Tuple[str, int]]:
    """``(name, line)`` of the callables handed to
    ``make_graphed_callables`` (a bare name, or the names in a tuple/list
    literal)."""
    out = []
    for n in _common.walk_excluding_defs(body):
        if (isinstance(n, ast.Call)
                and resolve(n.func) in _common.GRAPHED_CALLABLES and n.args):
            first = n.args[0]
            elts = first.elts if isinstance(first, (ast.Tuple, ast.List)) else [first]
            out.extend((ast.unparse(e), n.lineno) for e in elts
                       if isinstance(e, (ast.Name, ast.Attribute)))
    return out


#: ``open`` modes that write
_WRITE_MODES = set("wax+")


def is_sync_io(call: ast.Call, resolve) -> bool:
    """A call in :data:`_common.SYNC_IO_CALLS`, an ``open`` only when its
    literal mode writes (``open(p)`` and ``open(p, "rb")`` read)."""
    resolved = resolve(call.func)
    if resolved not in _common.SYNC_IO_CALLS:
        return False
    if resolved not in ("open", "io.open"):
        return True
    mode = call.args[1] if len(call.args) > 1 else next(
        (kw.value for kw in call.keywords if kw.arg == "mode"), None)
    return (isinstance(mode, ast.Constant) and isinstance(mode.value, str)
            and bool(_WRITE_MODES & set(mode.value)))


def seed_argument(call: ast.Call, resolve) -> Optional[ast.AST]:
    """The seed expression of a seeding call (``torch.manual_seed(E)``,
    ``g.manual_seed(E)``, ``torch.Generator().manual_seed(E)``), else
    None."""
    if not call.args:
        return None
    if resolve(call.func) in _common.GLOBAL_SEED_CALLS or (
            isinstance(call.func, ast.Attribute)
            and call.func.attr in _common.SEED_METHODS):
        return call.args[0]
    return None


def seed_reaches(expr: ast.AST, name: str) -> bool:
    """Whether ``name``'s value is the seed ``expr`` gives: the name
    itself, ``int(name)``, or a branch of a conditional that is."""
    if isinstance(expr, ast.Name):
        return expr.id == name
    if (isinstance(expr, ast.Call) and isinstance(expr.func, ast.Name)
            and expr.func.id == "int" and len(expr.args) == 1):
        return seed_reaches(expr.args[0], name)
    if isinstance(expr, ast.IfExp):
        return seed_reaches(expr.body, name) or seed_reaches(expr.orelse, name)
    return False


#: tensor methods whose result shares storage with the receiver
VIEW_METHODS = {
    "view", "view_as", "reshape", "detach", "narrow", "squeeze",
    "unsqueeze", "t", "transpose", "permute", "expand", "expand_as",
    "flatten", "unflatten", "select", "as_strided", "contiguous",
}


def alias_root(value: ast.AST) -> Optional[ast.AST]:
    """The Name or Attribute an expression is a view of (``y``, ``y[:n]``,
    ``cap.y.view(...)``), else None."""
    node = value
    while True:
        if isinstance(node, (ast.Name, ast.Attribute)):
            return node
        if isinstance(node, ast.Subscript):
            node = node.value
        elif (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
              and node.func.attr in VIEW_METHODS):
            node = node.func.value
        else:
            return None


def _captured_bindings(mod) -> Tuple[Set[str], Set[str]]:
    """(attribute names, ``global`` names) bound inside a capture region
    of any function of ``mod``."""
    attrs: Set[str] = set()
    names: Set[str] = set()
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        declared = {n for g in ast.walk(fn) if isinstance(g, ast.Global) for n in g.names}
        for _, nodes, _ in capture_regions(fn.body, mod.resolve):
            for n in nodes:
                if not isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    continue
                targets = n.targets if isinstance(n, ast.Assign) else [n.target]
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Attribute) and isinstance(sub.ctx, ast.Store):
                            attrs.add(sub.attr)
                names |= _common.assignment_targets(n) & declared
    return attrs, names


def _replayer_facts(fn, params, info) -> Tuple[bool, Tuple[int, ...]]:
    """``(replayer, buffer param positions)`` of one function: it replays a
    graph (``X.replay()``) and then returns, with no copy between, an alias
    of a static output that outlives the call — ``B.attr`` where the module
    binds ``attr`` inside a capture and ``B`` is the base of a replayed
    graph's expression, or a module global bound inside a capture and not
    rebound here. The buffer params are those that ``B`` names."""
    nodes = list(_common.walk_excluding_defs(fn.body))
    replays = [n for n in nodes if isinstance(n, ast.Call)
               and isinstance(n.func, ast.Attribute) and n.func.attr == "replay"
               and not n.args]
    if not replays:
        return False, ()
    first = min(n.lineno for n in replays)
    bases = {_common.base_name(n.func.value) for n in replays}
    local = _common.bound_names(ast.Module(body=fn.body, type_ignores=[]))
    local |= set(params)
    globals_here = {n for g in nodes if isinstance(g, ast.Global) for n in g.names}
    static_globals = info.captured_globals - (local - globals_here)
    buffers: Set[int] = set()
    found = False
    for ret in nodes:
        if not (isinstance(ret, ast.Return) and ret.value is not None
                and ret.lineno > first):
            continue
        root = alias_root(ret.value)
        if isinstance(root, ast.Attribute) and root.attr in info.captured_attrs:
            base = _common.base_name(root.value)
            if base in bases:
                found = True
                if base in params:
                    buffers.add(params.index(base))
        elif isinstance(root, ast.Name) and root.id in static_globals:
            found = True
    return found, tuple(sorted(buffers))


@dataclasses.dataclass
class FunctionSummary:
    """What phase 2 may assume about one function without re-reading it."""

    module: str
    qualname: str          # "train_step" or "Trainer.fit_round"
    name: str
    lineno: int
    params: Tuple[str, ...]          # positional params, self/cls stripped
    is_method: bool
    generator_params: Tuple[str, ...]
    calls: Tuple[str, ...]           # resolved names this function calls
    #: (resolved name, capture line) of the calls made inside a capture
    capture_calls: Tuple[Tuple[str, int], ...]
    has_host_read: bool              # DIRECT .item()/.cpu()/synchronize...
    launches_device: bool            # DIRECT torch op, @ or graph replay
    #: graph source text -> (static input names, static output names)
    static_names: Dict[str, Tuple[FrozenSet[str], FrozenSet[str]]] = \
        dataclasses.field(default_factory=dict)
    has_spawn: bool = False          # DIRECT subprocess.Popen/run/os.fork...
    has_sync_io: bool = False        # DIRECT open-for-writing/fsync/socket...
    #: returns a captured graph's static output after replaying it
    replayer: bool = False
    #: positions of the parameters that carry the replayed graph's buffers
    #: (the object whose graph is replayed and whose output is returned)
    buffer_params: Tuple[int, ...] = ()
    #: params whose value reaches ``manual_seed`` in this function's own body
    seed_params: Tuple[str, ...] = ()
    #: (callee, ((position or keyword, param), ...)): params handed on whole
    param_handoffs: Tuple[Tuple[str, Tuple[Tuple[object, str], ...]], ...] = ()
    #: called, transitively, from a capture region (filled by the index)
    in_capture: bool = False
    #: one capture region it is reached from, "path:line" (for messages)
    capture_site: str = ""
    node: ast.AST = dataclasses.field(repr=False, default=None)

    @property
    def fq(self) -> str:
        return f"{self.module}.{self.qualname}"

    def param_at(self, key) -> Optional[str]:
        """The parameter a call argument lands on: a position of
        :func:`_common.call_args_with_keywords`, or a keyword's name."""
        if isinstance(key, int):
            return self.params[key] if key < len(self.params) else None
        return key


@dataclasses.dataclass
class ModuleInfo:
    """Per-module slice of the index."""

    name: str
    path: str
    srcmod: object = dataclasses.field(repr=False, default=None)
    is_package: bool = False
    functions: Dict[str, FunctionSummary] = dataclasses.field(default_factory=dict)
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)  # absolutized
    #: attribute names and ``global`` names bound inside a capture region
    captured_attrs: Set[str] = dataclasses.field(default_factory=set)
    captured_globals: Set[str] = dataclasses.field(default_factory=set)
    #: module-level name -> the replayer it is bound to (directly or
    #: through ``functools.partial``)
    replayer_aliases: Dict[str, str] = dataclasses.field(default_factory=dict)

    @property
    def package(self) -> str:
        """The package context relative imports resolve against."""
        if self.is_package:
            return self.name
        return self.name.rpartition(".")[0]


class ProjectIndex:
    """The cross-module picture, built once per analysis run (phase 1)."""

    def __init__(self, srcmods) -> None:
        self.modules: Dict[str, ModuleInfo] = {}
        self.by_path: Dict[str, ModuleInfo] = {}
        self._host_read_cache: Dict[str, bool] = {}
        self._device_cache: Dict[str, bool] = {}
        self._spawn_taint_cache: Dict[str, bool] = {}
        self._io_taint_cache: Dict[str, bool] = {}
        self._seed_cache: Dict[str, FrozenSet[str]] = {}
        self._concurrency = None
        self._lifecycle = None
        for mod in srcmods:
            self._index_module(mod)
        # second pass: what runs inside a capture, and the module-level
        # replayer aliases, need every summary
        self._mark_captured()
        for info in self.modules.values():
            self._collect_replayer_aliases(info)

    @property
    def concurrency(self):
        """The thread-safety extension (:mod:`.concurrency`), built lazily
        on first use so runs that exclude JG024–JG026 pay nothing for it;
        per-path summaries are cached inside the returned index."""
        if self._concurrency is None:
            from gan_deeplearning4j_tpu_torch.analysis import concurrency as _conc

            self._concurrency = _conc.build(self)
        return self._concurrency

    @property
    def lifecycle(self):
        """The paired-resource extension (:mod:`.lifecycle`), built lazily
        on first use so runs that exclude JG027–JG029 pay nothing for it;
        per-path summaries are cached inside the returned index."""
        if self._lifecycle is None:
            from gan_deeplearning4j_tpu_torch.analysis import lifecycle as _life

            self._lifecycle = _life.build(self)
        return self._lifecycle

    # -- construction -------------------------------------------------------
    def _index_module(self, mod) -> None:
        name = module_name_for_path(mod.path)
        info = ModuleInfo(
            name=name,
            path=mod.path,
            srcmod=mod,
            is_package=os.path.basename(mod.path) == "__init__.py",
        )
        info.imports = {
            local: self._absolutize(info, dotted)
            for local, dotted in mod.imports.items()
        }
        info.captured_attrs, info.captured_globals = _captured_bindings(mod)
        for node in mod.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._summarize(info, mod, node, qualprefix="", is_method=False)
            elif isinstance(node, ast.ClassDef):
                for sub in node.body:
                    if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef)):
                        self._summarize(info, mod, sub,
                                        qualprefix=node.name + ".",
                                        is_method=True)
        self.modules[name] = info
        self.by_path[mod.path] = info

    @staticmethod
    def _absolutize(info: ModuleInfo, dotted: str) -> str:
        """Resolve the import map's ``.``-prefixed relative targets against
        the importing module's package."""
        if not dotted.startswith("."):
            return dotted
        level = len(dotted) - len(dotted.lstrip("."))
        rest = dotted[level:]
        base_parts = info.package.split(".") if info.package else []
        # level 1 = the containing package; each extra dot climbs one
        base_parts = base_parts[: len(base_parts) - (level - 1)] if level > 1 else base_parts
        base = ".".join(p for p in base_parts if p)
        return f"{base}.{rest}" if base and rest else (base or rest)

    def _summarize(self, info: ModuleInfo, mod, fn, qualprefix: str,
                   is_method: bool) -> None:
        a = fn.args
        args = a.posonlyargs + a.args
        if is_method and args and args[0].arg in ("self", "cls"):
            args = args[1:]
        params = [p.arg for p in args]
        calls: List[str] = []
        has_read = has_device = has_spawn = has_io = False
        seeded: Set[str] = set()
        handoffs: List[Tuple[str, Tuple[Tuple[object, str], ...]]] = []
        for n in ast.walk(fn):
            if isinstance(n, ast.BinOp) and isinstance(n.op, ast.MatMult):
                has_device = True
            if not isinstance(n, ast.Call):
                continue
            resolved = mod.resolve(n.func)
            if _common.is_host_read(n, mod.resolve):
                has_read = True
            elif is_device_call(n, mod.resolve):
                has_device = True
            if resolved in _common.SPAWN_CALLS:
                has_spawn = True
            if is_sync_io(n, mod.resolve):
                has_io = True
            seed = seed_argument(n, mod.resolve)
            if seed is not None:
                seeded |= {p for p in params if seed_reaches(seed, p)}
            if resolved is None:
                continue
            canonical = self._canonical_call(info, resolved)
            calls.append(canonical)
            passed = tuple((k, v.id) for k, v in _common.call_args_with_keywords(n)
                           if isinstance(v, ast.Name) and v.id in params)
            if passed:
                handoffs.append((canonical, passed))
        capture_calls: List[Tuple[str, int]] = []
        static: Dict[str, Tuple[FrozenSet[str], FrozenSet[str]]] = {}
        for anchor, nodes, graph in capture_regions(fn.body, mod.resolve):
            outs: Set[str] = set()
            ins: Set[str] = set()
            for n in nodes:
                if isinstance(n, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                    outs |= _common.assignment_targets(n)
            for n in nodes:
                if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load) \
                        and n.id not in outs:
                    ins.add(n.id)
                if isinstance(n, ast.Call):
                    resolved = mod.resolve(n.func)
                    if resolved is not None:
                        capture_calls.append((
                            self._canonical_call(info, resolved),
                            anchor.lineno))
            prev_in, prev_out = static.get(graph, (frozenset(), frozenset()))
            static[graph] = (prev_in | frozenset(ins), prev_out | frozenset(outs))
        for name, line in graphed_callable_names(fn.body, mod.resolve):
            capture_calls.append((self._canonical_call(info, name), line))
        replayer, buffers = _replayer_facts(fn, params, info)
        summary = FunctionSummary(
            module=info.name,
            qualname=qualprefix + fn.name,
            name=fn.name,
            lineno=fn.lineno,
            params=tuple(params),
            is_method=is_method,
            generator_params=tuple(
                p.arg for p in args
                if looks_like_generator_param(p, mod.resolve)),
            calls=tuple(dict.fromkeys(calls)),
            capture_calls=tuple(dict.fromkeys(capture_calls)),
            has_host_read=has_read,
            launches_device=has_device,
            static_names=static,
            has_spawn=has_spawn,
            has_sync_io=has_io,
            replayer=replayer,
            buffer_params=buffers,
            seed_params=tuple(p for p in params if p in seeded),
            param_handoffs=tuple(handoffs),
            node=fn,
        )
        info.functions[summary.qualname] = summary

    def _canonical_call(self, info: ModuleInfo, resolved: str) -> str:
        """Normalize a resolved call target into an index-wide name:
        relative-import targets are absolutized against the module's
        package, imported names become absolute module paths, bare local
        names become ``<module>.<name>``; ``self.m`` attribute calls keep
        their surface form and are matched per-module later."""
        if resolved.startswith("."):
            # the import map's '.'-prefixed pseudo-root (from .steps import
            # step) — without this hop the name never matches the index
            return self._absolutize(info, resolved)
        first, _, rest = resolved.partition(".")
        if first == "self":
            return f"{info.name}.self.{rest}" if rest else resolved
        mapped = info.imports.get(first)
        if mapped is not None:
            return f"{mapped}.{rest}" if rest else mapped
        if "." not in resolved:
            return f"{info.name}.{resolved}"
        return resolved

    def _mark_captured(self) -> None:
        """Flag every function reached, through project calls, from a
        capture region (breadth-first over the call graph)."""
        queue: List[Tuple[str, str]] = []
        for info in self.modules.values():
            for s in info.functions.values():
                for callee, line in s.capture_calls:
                    queue.append((callee, f"{info.path}:{line}"))
        seen: Set[str] = set()
        while queue:
            callee, site = queue.pop(0)
            target = self._resolve_callee(callee)
            if target is None or target.fq in seen:
                continue
            seen.add(target.fq)
            target.in_capture = True
            target.capture_site = site
            for nxt in target.calls:
                queue.append((nxt, site))

    def _resolve_callee(self, callee: str) -> Optional[FunctionSummary]:
        """Summary for a canonical call name; a ``<module>.self.m`` call
        matches a method ``m`` of any class in that module."""
        module, sep, mname = callee.partition(".self.")
        if sep and module in self.modules:
            for qual, s in self.modules[module].functions.items():
                if s.is_method and qual.endswith("." + mname):
                    return s
            return None
        return self.lookup(callee)

    # -- lookups ------------------------------------------------------------
    def lookup(self, fq: str) -> Optional[FunctionSummary]:
        """Find a summary by canonical name (``pkg.mod.fn`` or
        ``pkg.mod.Class.method``) by longest-module-prefix match."""
        parts = fq.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            module = ".".join(parts[:cut])
            info = self.modules.get(module)
            if info is not None:
                qual = ".".join(parts[cut:])
                return info.functions.get(qual)
        return None

    def resolve_function(self, mod, node_or_name) -> Optional[FunctionSummary]:
        """Summary for a Name/Attribute expression in ``mod``'s namespace —
        local functions, imported functions, one re-export hop through a
        package ``__init__``."""
        info = self.by_path.get(mod.path)
        if info is None:
            return None
        if isinstance(node_or_name, str):
            dotted = node_or_name
        else:
            dotted = _common.dotted_name(node_or_name)
        if dotted is None:
            return None
        canonical = self._canonical_call(info, self._local_resolve(mod, dotted))
        found = self.lookup(canonical)
        if found is not None:
            return found
        # one re-export hop: pkg.__init__ imported the symbol from a submodule
        parts = canonical.split(".")
        for cut in range(len(parts) - 1, 0, -1):
            pkg = self.modules.get(".".join(parts[:cut]))
            if pkg is not None and pkg.is_package:
                tail = ".".join(parts[cut:])
                head = tail.split(".")[0]
                re_target = pkg.imports.get(head)
                if re_target:
                    rest = tail[len(head) + 1:]
                    return self.lookup(
                        f"{re_target}.{rest}" if rest else re_target)
        return None

    def _collect_replayer_aliases(self, info: ModuleInfo) -> None:
        """Module-level ``name = replayer`` and ``name = functools.partial(
        replayer, ...)`` bindings, in source order (an alias may name an
        earlier one)."""
        mod = info.srcmod
        for stmt in mod.tree.body:
            if not (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)):
                continue
            value = stmt.value
            if (isinstance(value, ast.Call) and value.args
                    and mod.resolve(value.func) == "functools.partial"):
                value = value.args[0]
            if not isinstance(value, (ast.Name, ast.Attribute)):
                continue
            target = self.replayer(mod, value)
            if target is not None:
                info.replayer_aliases[stmt.targets[0].id] = target.fq

    @functools.cached_property
    def replayer_names(self) -> FrozenSet[str]:
        """The last names of every replayer and replayer alias (a module
        that mentions none of them calls none)."""
        names = {s.name for info in self.modules.values()
                 for s in info.functions.values() if s.replayer}
        names |= {a for info in self.modules.values() for a in info.replayer_aliases}
        return frozenset(names)

    @functools.cached_property
    def seeding_names(self) -> FrozenSet[str]:
        """The last names of every function with a seeding parameter."""
        return frozenset(s.name for info in self.modules.values()
                         for s in info.functions.values() if self.seeding_params(s))

    def replayer(self, mod, node) -> Optional[FunctionSummary]:
        """The replayer a callee expression of ``mod`` names: a project
        function the index marks as one, or a module-level alias of one
        (``run = functools.partial(replay, cap)``) bound in ``mod`` or
        imported from the module that binds it."""
        summary = self.resolve_function(mod, node)
        if summary is not None:
            return summary if summary.replayer else None
        info = self.by_path.get(mod.path)
        dotted = _common.dotted_name(node)
        if info is None or dotted is None or "." in dotted:
            return None
        fq = info.replayer_aliases.get(dotted)
        if fq is None:
            owner, _, symbol = info.imports.get(dotted, "").rpartition(".")
            source = self.modules.get(owner)
            fq = source.replayer_aliases.get(symbol) if source is not None else None
        return self.lookup(fq) if fq else None

    @staticmethod
    def _local_resolve(mod, dotted: str) -> str:
        first, _, rest = dotted.partition(".")
        root = mod.imports.get(first)
        if root is None:
            return dotted
        return f"{root}.{rest}" if rest else root

    # -- transitive taints --------------------------------------------------
    def host_read_tainted(self, summary: FunctionSummary) -> bool:
        """True when ``summary`` reads a device value on the host or fences
        (``.item()``/``.cpu()``/``.tolist()``/``.numpy()``, a
        ``synchronize``) itself or reaches one through statically
        resolvable project calls (fixpoint over the call graph; cycles
        resolve to False-unless-proven)."""
        return self._tainted(summary.fq, frozenset(),
                             "has_host_read", self._host_read_cache)

    def device_tainted(self, summary: FunctionSummary) -> bool:
        """Same closure, another mark: the function queues device work (a
        ``torch.*`` op or a graph replay) itself or through its callees."""
        return self._tainted(summary.fq, frozenset(),
                             "launches_device", self._device_cache)

    def spawn_tainted(self, summary: FunctionSummary) -> bool:
        """Same closure: True when ``summary`` launches an OS process (the
        :data:`_common.SPAWN_CALLS` set) itself or reaches one through
        project calls. JG021's input: the relaunch helper a supervision
        loop calls is where the ``Popen`` actually lives."""
        return self._tainted(summary.fq, frozenset(),
                             "has_spawn", self._spawn_taint_cache)

    def io_tainted(self, summary: FunctionSummary) -> bool:
        """Same closure: True when ``summary`` does synchronous host I/O
        (:func:`is_sync_io`: a file opened for writing, an fsync, a
        replace, a socket, a URL, a copy) itself or through project calls.
        JG020's input: the write sits in a logging helper two calls below
        the timed loop."""
        return self._tainted(summary.fq, frozenset(),
                             "has_sync_io", self._io_taint_cache)

    def seeding_params(self, summary: FunctionSummary,
                       seen: frozenset = frozenset()) -> FrozenSet[str]:
        """The parameters of ``summary`` whose value reaches
        ``manual_seed``: in its own body (the seed expression is the
        parameter, ``int(param)``, or a branch of a conditional that is),
        or handed whole to a project function at one of its seeding
        parameters. Unresolvable callees add nothing."""
        if summary.fq in self._seed_cache:
            return self._seed_cache[summary.fq]
        if summary.fq in seen:
            return frozenset(summary.seed_params)
        seen = seen | {summary.fq}
        out = set(summary.seed_params)
        for callee, passed in summary.param_handoffs:
            target = self._resolve_callee(callee)
            if target is None:
                continue
            inner = self.seeding_params(target, seen)
            if not inner:
                continue
            out |= {param for key, param in passed if target.param_at(key) in inner}
        result = frozenset(out)
        self._seed_cache[summary.fq] = result
        return result

    def _tainted(self, fq: str, seen: frozenset, mark: str,
                 cache: Dict[str, bool]) -> bool:
        if fq in cache:
            return cache[fq]
        if fq in seen:
            return False
        summary = self.lookup(fq)
        if summary is None:
            return False
        if getattr(summary, mark):
            cache[fq] = True
            return True
        seen = seen | {fq}
        for callee in summary.calls:
            target = callee
            # `self.m` calls match a method of any class in the same module
            marker = f"{summary.module}.self."
            if callee.startswith(marker):
                mname = callee[len(marker):]
                owner = self.modules[summary.module]
                target = None
                for qual, s in owner.functions.items():
                    if s.is_method and qual.endswith("." + mname):
                        target = f"{summary.module}.{qual}"
                        break
                if target is None:
                    continue
            if self.lookup(target) is not None and self._tainted(
                    target, seen, mark, cache):
                cache[fq] = True
                return True
        cache[fq] = False
        return False


def build_index(srcmods) -> ProjectIndex:
    """Phase-1 entry point used by the engine."""
    return ProjectIndex([m for m in srcmods if hasattr(m, "tree")])
