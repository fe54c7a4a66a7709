"""JG026 — blocking call while holding a lock in a threaded class.

The silent latency/deadlock hazard in health-loop-shaped code: a probe,
sleep, join, or subprocess executed inside ``with self._lock:`` stalls
every thread contending for that lock for the full duration of the block —
on the serve path that is the batcher's submit thread, on the route path
the request handlers. Worse than latency: if the blocked operation itself
waits on work that needs the lock (joining the worker thread that is
parked on ``with self._lock``), the class deadlocks. JG017 bounds the
network wait; this rule says even a *bounded* wait does not belong under
a lock other threads turn around on.

The model (phase-1 concurrency index): in any class that spawns threads
(``Thread(target=...)``, ``Timer``, ``run`` override) or serves HTTP
handler methods — the statically visible serve/route-path classes — a
known blocking call executed with ≥1 lock held is flagged. The blocking
set is JG017's network calls plus ``time.sleep``, thread/process
``.join`` (disambiguated from ``str.join`` by argument shape),
``subprocess``/``os`` spawn-and-wait entry points, and device sync
(``jax.block_until_ready`` / ``.block_until_ready()``). One resolved
same-class call hop is followed: ``with self._lock: self._probe()``
where ``_probe`` calls ``urlopen`` is flagged at the call site.

Not flagged: blocking calls with no lock held (the correct idiom —
snapshot under the lock, block outside it); classes with no threads
(single-threaded blocking is just I/O); ``Condition.wait``/``wait_for``
(they *release* the lock while waiting — that is the point of a CV);
``str.join``. Known false negatives: blocking reached through more than
one call hop or through cross-class calls; ``.acquire()`` held regions.
"""

from __future__ import annotations


class BlockingCallUnderLock:
    code = "JG026"
    name = "blocking-call-under-lock"
    summary = ("network/sleep/join/subprocess/device-sync call executed "
               "while holding a lock other threads contend for")
    skip_tests = True

    def check(self, mod):
        if mod.project is None:
            return
        for cc in mod.project.concurrency.classes(mod.path):
            if not cc.entry_points:
                continue
            for name, mc in sorted(cc.methods.items()):
                for b in mc.blocking:
                    # lexically-held locks only: a block held purely via
                    # propagated call-site guards (caller_held) is charged
                    # at the call site by the hop loop below — reporting
                    # it here too would double-count one defect
                    if not b.held:
                        continue
                    held = b.held | mc.caller_held
                    yield self._finding(mod, cc, b.method, b.label,
                                        sorted(held), b.node)
                for call in mc.self_calls:
                    if not (call.held or mc.caller_held):
                        continue
                    callee = cc.methods.get(call.callee)
                    if callee is None:
                        continue
                    held = sorted(call.held | mc.caller_held)
                    for b in callee.blocking:
                        yield self._finding(
                            mod, cc, call.method, b.label, held,
                            call.node, via=call.callee)
                        break  # one finding per call site is enough

    def _finding(self, mod, cc, method, label, held, node, via=None):
        locks = ", ".join(f"`{h}`" for h in held)
        through = f" (via `self.{via}()`)" if via else ""
        return mod.finding(
            self.code,
            f"`{method}` calls blocking `{label}`{through} while holding "
            f"{locks} — `{cc.name}` runs threads that contend for the "
            f"lock, so every one of them stalls for the full wait (and "
            f"deadlocks if the awaited work needs the lock); snapshot "
            f"state under the lock and block outside it",
            node,
        ), node
