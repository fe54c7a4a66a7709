"""JG027 — paired resource leaked on an exception or early-exit path.

The bug class every hardening round has hand-caught at least once: a
paired operation (lock ``acquire``/``release``, trace span
``async_begin``/``async_end``, engine ``dispatch``/``finalize``, token
``take``/``refund``, in-flight counter ``+=``/``-=``, a project-local
``open_x``/``close_x`` dual) whose closing half is skipped when a
statement between the two raises, or when an early ``return``/``raise``/
``continue`` leaves the scope, or when control simply falls off the end
of the function. The engine's replica ledger (PR 4), the router's retry
refund (PR 8), and the device-capture lock (PR 6) were all this shape.

The model (phase-1½ lifecycle index): every tracked open is classified
``closed`` (a matching same-receiver close dominates every exit —
``try/finally``, close on every branch, same-statement pairing),
``transferred`` (the receiver or bound token is returned, raised, stored
into ``self``/a container, passed to another call or thread — the
closing obligation moved with it; a ``self`` resource whose close-half
lives in a sibling method is the ``start``/``stop`` instance-holds-it
idiom and also transfers), or ``leak``. Leaks are flagged with the
escaping statement: the raise-capable call in the unprotected gap, the
early exit, the loop boundary, or the function end.

Not flagged: ``with``-statement acquisition (balanced by construction);
seeded opens in modules that never name the close-half (``atexit
.register`` is fire-and-forget, not half a protocol); cross-method
counters (the dispatch/finalize ledger is ownership-by-design). Known
false negatives (see :mod:`..lifecycle`): closes reached only through
unresolvable helper calls; handlers that swallow a mid-``try`` exception
without closing.
"""

from __future__ import annotations


class LeakedPairedResource:
    code = "JG027"
    name = "leaked-paired-resource"
    summary = ("paired open (acquire/begin/dispatch/take/+=) reachable by "
               "an exception or early-exit path with no guaranteed close "
               "and no ownership transfer")
    skip_tests = True

    _KINDS = {
        "exception-path": ("an exception between the open and the close "
                           "skips the close"),
        "early-exit": "an early exit leaves the scope with it open",
        "loop-carried": ("the loop re-enters and re-opens without the "
                         "close running"),
        "fall-through": "control falls off the end with it still open",
    }

    def check(self, mod):
        if mod.project is None:
            return
        for fl in mod.project.lifecycle.functions(mod.path):
            for ev in fl.opens:
                if ev.outcome != "leak":
                    continue
                why = self._KINDS.get(ev.leak_kind,
                                      self._KINDS["fall-through"])
                opener = ("`self.%s += ...`" % ev.recv.split(".")[-1]
                          if ev.pair.kind == "counter"
                          else f"`{ev.recv}.{ev.pair.open}(...)`")
                closer = (f"`{ev.recv} -= ...`" if ev.pair.kind == "counter"
                          else f"`{ev.recv}.{ev.pair.close}()`")
                yield mod.finding(
                    self.code,
                    f"`{fl.name}` opens {opener} but {why}: {closer} is "
                    f"not guaranteed on every path and ownership never "
                    f"transfers — close it in a `finally` (or hand it off "
                    f"explicitly) so the {ev.pair.kind} pair balances",
                    ev.node,
                ), ev.node
