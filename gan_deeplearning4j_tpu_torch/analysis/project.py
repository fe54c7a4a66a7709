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
  taint and the device-work taint (a function that reaches one through
  its callees), and whether a function
  runs inside a capture (it is called, transitively, from a
  ``with torch.cuda.graph(...)`` body or from between ``capture_begin``
  and ``capture_end``).

Phase 2 (the rules) receives the index as ``mod.project`` on every
:class:`~.engine.SourceModule`. Everything here is stdlib-only and purely
syntactic — the index records what is *statically visible*, and rules are
expected to treat absence of a summary as "unknown", never as "safe".
"""

from __future__ import annotations

import ast
import dataclasses
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
    #: called, transitively, from a capture region (filled by the index)
    in_capture: bool = False
    #: one capture region it is reached from, "path:line" (for messages)
    capture_site: str = ""
    node: ast.AST = dataclasses.field(repr=False, default=None)

    @property
    def fq(self) -> str:
        return f"{self.module}.{self.qualname}"


@dataclasses.dataclass
class ModuleInfo:
    """Per-module slice of the index."""

    name: str
    path: str
    srcmod: object = dataclasses.field(repr=False, default=None)
    is_package: bool = False
    functions: Dict[str, FunctionSummary] = dataclasses.field(default_factory=dict)
    imports: Dict[str, str] = dataclasses.field(default_factory=dict)  # absolutized

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
        self._concurrency = None
        self._lifecycle = None
        for mod in srcmods:
            self._index_module(mod)
        # second pass: what runs inside a capture needs every summary
        self._mark_captured()

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
        has_read = has_device = has_spawn = False
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
            if resolved is None:
                continue
            calls.append(self._canonical_call(info, resolved))
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
