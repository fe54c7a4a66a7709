"""Shared AST plumbing for torchlint rules (stdlib-only).

The one piece of real machinery here is import-alias resolution: rules match
on *resolved* dotted names (``torch.cuda.synchronize``), not surface
spellings, so ``import torch.cuda as tc; tc.synchronize()`` and
``from torch import cuda; cuda.synchronize()`` both hit — while a local
``synchronize`` in a module that never imports torch does not.

The tables below are the port's: capture entry points, host reads and
fences, generator constructors, and the names of the bf16 compute scope
and of ``weak_scalar`` (``runtime/dtype.py``). The sync-I/O, spawn and
sleep tables are the JAX package's, unchanged.
"""

from __future__ import annotations

import ast
from typing import Iterator, Optional

# -- shared name sets (single source of truth for every rule) ---------------

#: wall-clock reads that mark a region as "timed"
CLOCK_CALLS = {
    "time.perf_counter", "time.perf_counter_ns", "time.monotonic",
    "time.monotonic_ns", "time.time", "timeit.default_timer",
}

#: capture entry points: a ``with torch.cuda.graph(g):`` body, the span
#: between ``g.capture_begin()`` and ``g.capture_end()``, and the callables
#: handed to ``make_graphed_callables`` are captured once and replayed
CAPTURE_CONTEXTS = {"torch.cuda.graph"}
CAPTURE_BEGIN_METHOD = "capture_begin"
CAPTURE_END_METHOD = "capture_end"
GRAPHED_CALLABLES = {"torch.cuda.make_graphed_callables"}
#: constructors of a graph object (what a capture fills)
GRAPH_CONSTRUCTORS = {"torch.cuda.CUDAGraph"}
#: the port's guard every capture runs under (``runtime/capture.py``),
#: matched by its last name component so relative imports resolve too
CAPTURE_GUARD = "capture_guard"

#: host reads: tensor methods that copy device data to the host and so
#: wait for every kernel that produces it
HOST_READ_METHODS = {"item", "cpu", "tolist", "numpy"}
#: host reads spelled as calls
HOST_READ_CALLS = {"numpy.asarray", "numpy.array", "numpy.ascontiguousarray"}
#: fences: the host waits for queued device work (``Event.synchronize``,
#: ``Stream.synchronize`` and ``torch.cuda.synchronize``)
FENCE_CALLS = {"torch.cuda.synchronize"}
FENCE_METHODS = {"synchronize"}

#: generator constructors and seeders
GENERATOR_CONSTRUCTORS = {"torch.Generator"}
SEED_METHODS = {"manual_seed"}
GLOBAL_SEED_CALLS = {"torch.manual_seed", "torch.cuda.manual_seed",
                     "torch.cuda.manual_seed_all"}

#: the bf16 compute scope and the weak-scalar rounding helper
#: (``runtime/dtype.py``), matched by last name component
COMPUTE_SCOPE = "compute_dtype_scope"
WEAK_SCALAR = "weak_scalar"


def last_component(resolved) -> str:
    """``a.b.c`` -> ``c`` (``None`` -> ``""``)."""
    return (resolved or "").rpartition(".")[2]


def is_host_read(call: ast.Call, resolve) -> bool:
    """A call that copies a device value to the host or waits for the
    device: ``.item()``/``.cpu()``/``.tolist()``/``.numpy()``,
    ``np.asarray(t)``, ``torch.cuda.synchronize()`` or a ``.synchronize()``
    of an event or a stream."""
    resolved = resolve(call.func)
    if resolved in HOST_READ_CALLS or resolved in FENCE_CALLS:
        return True
    return (isinstance(call.func, ast.Attribute)
            and call.func.attr in (HOST_READ_METHODS | FENCE_METHODS)
            and not call.args)


#: synchronous host I/O — file writes/fsyncs and blocking network calls.
#: On the step path every one of these idles the accelerator while the
#: host blocks (the measured checkpoint-write stall: 34% of wall on the
#: toy workload, BENCH_resilience_r01.json); JG020 flags them when a
#: timed train-step region reaches one through the call graph.
SYNC_IO_CALLS = {
    "open", "io.open", "os.fsync", "os.fdatasync", "os.write",
    "os.replace", "os.rename",
    "shutil.copy", "shutil.copy2", "shutil.copyfile", "shutil.copytree",
    "urllib.request.urlopen",
    "socket.socket", "socket.create_connection",
    "http.client.HTTPConnection", "http.client.HTTPSConnection",
}

#: process-spawning entry points — each one launches an OS process. A
#: supervision loop that reaches one of these with neither an attempt cap
#: nor a backoff sleep on its failure path is a fork bomb with extra
#: steps; JG021 flags the loop (the fleet manager's spawn-failure backoff
#: is the corrected idiom).
SPAWN_CALLS = {
    "subprocess.Popen", "subprocess.run", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
    "os.fork", "os.posix_spawn", "os.spawnv", "os.spawnl",
    "multiprocessing.Process",
}

#: direct backoff-sleep shapes a respawn loop may pace itself with
SLEEP_CALLS = {"time.sleep"}


def build_import_map(tree: ast.AST) -> dict:
    """Local name -> fully-qualified dotted prefix, from import statements.

    ``import jax`` -> {"jax": "jax"}; ``import jax.random as jr`` ->
    {"jr": "jax.random"}; ``from jax import random`` ->
    {"random": "jax.random"}; ``from jax.random import split as sp`` ->
    {"sp": "jax.random.split"}. Relative imports map into a ``.``-prefixed
    pseudo-root so they never collide with real top-level packages.
    """
    mapping: dict = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.asname:
                    mapping[alias.asname] = alias.name
                else:
                    # "import jax.random" binds the name "jax"
                    first = alias.name.split(".")[0]
                    mapping[first] = first
        elif isinstance(node, ast.ImportFrom):
            base = ("." * node.level) + (node.module or "")
            for alias in node.names:
                if alias.name == "*":
                    continue
                local = alias.asname or alias.name
                mapping[local] = f"{base}.{alias.name}" if base else alias.name
    return mapping


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve_name(node: ast.AST, imports: dict) -> Optional[str]:
    """Resolved dotted name of an expression through the import map."""
    dotted = dotted_name(node)
    if dotted is None:
        return None
    first, _, rest = dotted.partition(".")
    root = imports.get(first)
    if root is None:
        return dotted
    return f"{root}.{rest}" if rest else root


def resolve_call(call: ast.Call, imports: dict) -> Optional[str]:
    return resolve_name(call.func, imports)


def base_name(node: ast.AST) -> Optional[str]:
    """Leftmost Name id of an expression (``ks[0].foo`` -> ``ks``)."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    if isinstance(node, ast.Name):
        return node.id
    return None


def loaded_names(node: ast.AST) -> set:
    """All Name ids read anywhere inside an expression."""
    return {
        n.id
        for n in ast.walk(node)
        if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)
    }


def _target_names(target: ast.AST, out: set) -> None:
    if isinstance(target, ast.Name):
        out.add(target.id)
    elif isinstance(target, (ast.Tuple, ast.List)):
        for elt in target.elts:
            _target_names(elt, out)
    elif isinstance(target, ast.Starred):
        _target_names(target.value, out)
    # Attribute/Subscript targets mutate an object, they don't bind a name


def bound_names(node: ast.AST) -> set:
    """Every name BOUND anywhere under ``node``: assignments (incl. walrus,
    aug/ann-assign), for targets, with-as, def/class statements, imports,
    except-as. Used for "was this rebound inside the loop/body?" checks."""
    out: set = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                _target_names(t, out)
        elif isinstance(n, (ast.AugAssign, ast.AnnAssign)):
            _target_names(n.target, out)
        elif isinstance(n, ast.NamedExpr):
            _target_names(n.target, out)
        elif isinstance(n, (ast.For, ast.AsyncFor)):
            _target_names(n.target, out)
        elif isinstance(n, (ast.With, ast.AsyncWith)):
            for item in n.items:
                if item.optional_vars is not None:
                    _target_names(item.optional_vars, out)
        elif isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(n.name)
        elif isinstance(n, (ast.Import, ast.ImportFrom)):
            for alias in n.names:
                out.add((alias.asname or alias.name).split(".")[0])
        elif isinstance(n, ast.ExceptHandler) and n.name:
            out.add(n.name)
    return out


def assignment_targets(stmt: ast.stmt) -> set:
    """Names bound by THIS statement's own targets (not descendants)."""
    out: set = set()
    if isinstance(stmt, ast.Assign):
        for t in stmt.targets:
            _target_names(t, out)
    elif isinstance(stmt, (ast.AugAssign, ast.AnnAssign)):
        _target_names(stmt.target, out)
    return out


def walk_excluding_defs(roots) -> Iterator[ast.AST]:
    """Walk node(s) without descending into nested function/lambda bodies —
    their execution is deferred, so they are not part of the enclosing
    statement/loop's own evaluation (and defs are separate rule scopes)."""
    stack = list(roots) if isinstance(roots, (list, tuple)) else [roots]
    while stack:
        n = stack.pop()
        yield n
        for child in ast.iter_child_nodes(n):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)):
                continue
            stack.append(child)


def iter_scopes(tree: ast.AST) -> Iterator[ast.AST]:
    """The module plus every (async) function def, outermost first."""
    yield tree
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node


def iter_loops(tree: ast.AST) -> Iterator[ast.AST]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.For, ast.AsyncFor, ast.While)):
            yield node


def call_args_with_keywords(call: ast.Call) -> Iterator:
    """(position_or_name, value_node) for every argument of a call."""
    for i, arg in enumerate(call.args):
        yield i, arg
    for kw in call.keywords:
        if kw.arg is not None:
            yield kw.arg, kw.value


def literal_int_tuple(node: ast.AST):
    """Value of an int / tuple-or-list-of-ints literal, else None."""
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        vals = []
        for elt in node.elts:
            if not (isinstance(elt, ast.Constant) and isinstance(elt.value, int)):
                return None
            vals.append(elt.value)
        return tuple(vals)
    return None
