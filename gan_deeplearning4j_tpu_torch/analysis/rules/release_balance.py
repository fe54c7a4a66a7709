"""JG028 — unbalanced release: double-close or close-without-open.

The dual of JG027: instead of a close that can be skipped, a close that
can run *twice* (releasing a lock another thread now holds — on
``threading.Lock`` a ``RuntimeError``, on a semaphore a silently grown
permit pool) or run with nothing open (a refund without a take inflates
the budget; a ``-=`` without the ``+=`` drives the in-flight ledger
negative, which is how the PR 4 ledger corrupted). The loop variant is
the sneakiest: a single open before a loop with the close inside the
body releases once per iteration.

The model (phase-1½ lifecycle index, balance pass): a per-receiver
open/closed state machine over straight-line blocks. A close in the
``closed`` state is a **double-close**; a close when only *some*
preceding branch opened (the maybe-open join state) is a
**close-without-open** on the branch that didn't; a close inside a loop
body for a resource opened outside the loop is a **loop-carried
release**. The machine resets to unknown at joins it cannot follow
(loops over the whole pair, cross-function halves), so only statically
certain shapes are flagged.

Not flagged: close-then-reopen sequences (the state machine tracks
order); branch-exits (``if ...: close(); return`` followed by a second
close on the surviving path — the first path already left); the partial
close of an ``if``/``else`` where the *other* arm leaks (that is
JG027's finding, not a balance defect). Known false negatives: halves
split across helper calls; receiver aliasing (``lk = self._lock``
closed via both names).
"""

from __future__ import annotations


class UnbalancedRelease:
    code = "JG028"
    name = "unbalanced-release"
    summary = ("double-close or close-without-open on some path, "
               "including loop-carried releases")
    skip_tests = True

    def check(self, mod):
        if mod.project is None:
            return
        for fl in mod.project.lifecycle.functions(mod.path):
            for issue in fl.issues:
                closer = (f"`{issue.recv} -= ...`"
                          if issue.pair.kind == "counter"
                          else f"`{issue.recv}.{issue.pair.close}()`")
                if issue.kind == "double-close":
                    msg = (f"`{fl.name}` closes {closer} twice on one "
                           f"path — the second release frees a resource "
                           f"this frame no longer owns (another taker may "
                           f"already hold it); close exactly once per "
                           f"open")
                elif issue.kind == "close-without-open":
                    msg = (f"`{fl.name}` reaches {closer} on a path where "
                           f"the matching `{issue.pair.open}` never ran — "
                           f"the unconditional close after a conditional "
                           f"open over-releases; mirror the condition or "
                           f"close inside the branch that opened")
                else:  # loop-carried-release
                    msg = (f"`{fl.name}` closes {closer} inside a loop "
                           f"body for an open made outside the loop — "
                           f"zero iterations never release it and N "
                           f"iterations release it N times; move the "
                           f"close out of the loop")
                yield mod.finding(self.code, msg, issue.node), issue.node
