"""JG019 — host sync in a prefetch transform, consumed in a timed window.

The torch counterpart of the JAX package's ``prefetch_callback.py`` (a
host callback in a prefetch callback). ``DevicePrefetchIterator(inner,
transform=f)`` (``data/iterator.py``) calls ``f`` on every batch it pulls,
from inside the consumer's ``has_next()`` / ``next()``, on the consumer's
thread and stream. A transform that reads a device value on the host
(``.item()``, ``.cpu()``, ``.tolist()``, ``.numpy()``), synchronizes, or
prints a tensor waits there for every kernel queued so far: the side
stream's copy, which prefetching exists to overlap with the step, is
serialised with it, and the host can no longer run ahead. JG009 sees a
host read the timed window calls; the transform is handed over at
construction, screens away, and the window's own calls never name it.

1. a *pipeline construction* is a call whose callee's last name contains
   ``prefetch`` or ``pipeline``, assigned whole to one name;
2. its *transform* — the ``transform=`` keyword, or a positional argument
   that is a lambda or names a function — is tainted when its body does a
   host read, a synchronize or a ``print`` of a ``torch.*`` result, or the
   project index marks the function it names as host-read tainted (a read
   two calls down);
3. the finding is anchored at the construction when the pipeline is
   consumed, in the same scope, inside a timed window (JG009's ``clock() -
   t0`` windows): a method call on it, iteration over it, or the pipeline
   handed to another call.

Pure host transforms, pipelines with no transform (the experiment's own
``DevicePrefetchIterator``) and tainted pipelines consumed only outside a
timed window are silent.
"""

from __future__ import annotations

import ast
from typing import Dict

from gan_deeplearning4j_tpu_torch.analysis import _common
from gan_deeplearning4j_tpu_torch.analysis.project import is_device_call
from gan_deeplearning4j_tpu_torch.analysis.rules.timing import timed_windows

_SEAM_TOKENS = ("prefetch", "pipeline")


def _direct_sync(mod, roots) -> bool:
    for n in _common.walk_excluding_defs(roots):
        if not isinstance(n, ast.Call):
            continue
        if _common.is_host_read(n, mod.resolve):
            return True
        if (isinstance(n.func, ast.Name) and n.func.id == "print"
                and any(isinstance(a, ast.Call) and is_device_call(a, mod.resolve)
                        for a in n.args)):
            return True
    return False


class HostSyncInPrefetchTransform:
    code = "JG019"
    name = "host-sync-in-prefetch-transform"
    summary = ("a prefetch pipeline whose transform reads a device value on the "
               "host or synchronizes, consumed inside a timed window")

    def check(self, mod):
        low = mod.text.lower()
        if not any(tok in low for tok in _SEAM_TOKENS):
            return
        defs = self._local_defs(mod)
        for scope in _common.iter_scopes(mod.tree):
            body = getattr(scope, "body", None)
            if not body:
                continue
            pipelines = self._tainted_pipelines(mod, body, defs)
            if not pipelines:
                continue
            flagged = set()
            for window in timed_windows(body, mod):
                for node in window.nodes:
                    var = self._consumed(node, pipelines)
                    if var is None or var in flagged:
                        continue
                    flagged.add(var)
                    ctor = pipelines[var]
                    yield mod.finding(
                        self.code,
                        f"`{var}` is consumed inside the timed window ending at "
                        f"line {window.end} (line {node.lineno}), and its "
                        f"transform reads a device value on the host or "
                        f"synchronizes — every refill waits for the queued "
                        f"steps, so the prefetch copy no longer overlaps them "
                        f"and the host cannot run ahead; keep the transform on "
                        f"the host's data, or read the value after the window",
                        ctor,
                    ), ctor

    @staticmethod
    def _local_defs(mod) -> Dict[str, ast.AST]:
        """name -> def or lambda node for every function the module
        defines (``f = lambda ...`` included)."""
        defs: Dict[str, ast.AST] = {}
        for n in ast.walk(mod.tree):
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
                defs.setdefault(n.name, n)
            elif (isinstance(n, ast.Assign) and len(n.targets) == 1
                  and isinstance(n.targets[0], ast.Name)
                  and isinstance(n.value, ast.Lambda)):
                defs.setdefault(n.targets[0].id, n.value)
        return defs

    def _tainted(self, mod, defs, node) -> bool:
        if isinstance(node, ast.Lambda):
            return _direct_sync(mod, [node.body])
        if isinstance(node, ast.Name) and node.id in defs:
            fn = defs[node.id]
            if _direct_sync(mod, fn.body if isinstance(fn.body, list) else [fn.body]):
                return True
        if mod.project is not None and isinstance(node, (ast.Name, ast.Attribute)):
            summary = mod.project.resolve_function(mod, node)
            return summary is not None and mod.project.host_read_tainted(summary)
        return False

    def _tainted_pipelines(self, mod, body, defs) -> Dict[str, ast.Call]:
        out: Dict[str, ast.Call] = {}
        for n in _common.walk_excluding_defs(body):
            if not (isinstance(n, ast.Assign) and len(n.targets) == 1
                    and isinstance(n.targets[0], ast.Name)
                    and isinstance(n.value, ast.Call)):
                continue
            callee = _common.last_component(_common.dotted_name(n.value.func))
            if not any(tok in callee.lower() for tok in _SEAM_TOKENS):
                continue
            hooks = [kw.value for kw in n.value.keywords if kw.arg == "transform"]
            hooks += [a for a in n.value.args
                      if isinstance(a, ast.Lambda)
                      or (isinstance(a, ast.Name) and a.id in defs)]
            if any(self._tainted(mod, defs, h) for h in hooks):
                out[n.targets[0].id] = n.value
        return out

    @staticmethod
    def _consumed(node, pipelines):
        """The pipeline variable ``node`` consumes, else None."""
        if isinstance(node, (ast.For, ast.AsyncFor)) and isinstance(node.iter, ast.Name) \
                and node.iter.id in pipelines:
            return node.iter.id
        if isinstance(node, (ast.GeneratorExp, ast.ListComp, ast.SetComp, ast.DictComp)):
            for gen in node.generators:
                if isinstance(gen.iter, ast.Name) and gen.iter.id in pipelines:
                    return gen.iter.id
            return None
        if not isinstance(node, ast.Call):
            return None
        if (isinstance(node.func, ast.Attribute) and isinstance(node.func.value, ast.Name)
                and node.func.value.id in pipelines):
            return node.func.value.id
        for _, arg in _common.call_args_with_keywords(node):
            if isinstance(arg, ast.Name) and arg.id in pipelines:
                return arg.id
        return None
