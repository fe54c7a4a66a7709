"""JG029 — resource handed to a thread/callback that never closes it.

The subtle third act of the pair family: the opening function does
everything right locally — it opens the resource and hands it to a
worker thread or completion callback, transferring the closing
obligation — but the *receiver* never closes it. Locally both functions
look fine (the opener transferred, the receiver just uses what it was
given); the leak only exists in the pairing. The device-capture plane
hit exactly this before PR 6 made ``_swallow_owned`` release the capture
lock in its ``finally``.

The model (phase-1½ lifecycle index + project call summaries): an open
whose outcome is a handoff — the receiver or its token passed into
``threading.Thread(target=...)`` / ``Timer`` / ``add_done_callback`` /
callback registration — where the receiver function *resolves* through
the project index (same-class ``self._m``, module function, or imported
function) and its body does **not** contain the closing call on the
same receiver. An unresolvable target stays a silent transfer: the
analyzer only indicts code it can actually read.

Not flagged: handoffs whose resolved receiver closes (the correct
ownership-transfer idiom — flagging it would punish the fix); handoffs
of resources the *spawning* function also closes on every path (the
thread only borrows it); unresolvable targets (lambdas wrapping foreign
calls, ``functools.partial`` chains, cross-process queues). Known false
negatives: a receiver that closes only via its own helper call; a
receiver resolved through more than one re-export hop.
"""

from __future__ import annotations


class HandoffWithoutTransfer:
    code = "JG029"
    name = "handoff-without-transfer"
    summary = ("resource opened then passed to Thread(target=...)/callback "
               "whose resolved body never makes the closing call")
    skip_tests = True

    def check(self, mod):
        if mod.project is None:
            return
        for fl in mod.project.lifecycle.functions(mod.path):
            for ev in fl.opens:
                h = ev.handoff
                if (ev.outcome != "transferred" or h is None
                        or not h.resolved or h.target_closes):
                    continue
                yield mod.finding(
                    self.code,
                    f"`{fl.name}` opens `{ev.recv}.{ev.pair.open}(...)` "
                    f"and hands it to `{h.target}`, but that receiver "
                    f"never calls `{ev.recv}.{ev.pair.close}()` — the "
                    f"closing obligation was transferred to code that "
                    f"doesn't discharge it; close it in the receiver's "
                    f"`finally` (or keep ownership here and close after "
                    f"the handoff completes)",
                    h.node,
                ), h.node
