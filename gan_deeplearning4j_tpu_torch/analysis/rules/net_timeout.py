"""JG017 — blocking network call without an explicit timeout.

The fleet plane (fleet/router, fleet/health, fleet/manager, the deploy
watcher's HTTP paths, the drills) is built on stdlib blocking I/O —
``urllib.request.urlopen``, ``http.client.HTTPConnection``,
``socket.create_connection``. Each of these blocks FOREVER by default: a
SIGSTOPped worker, a half-open TCP connection, or a dropped tunnel turns
the caller into a second hung process — the exact failure the router
exists to contain. The fleet drill proved it the hard way: one probe
without a timeout and the health loop wedges behind the very worker it
was supposed to eject, so ejection never happens and every request hangs.

The rule: a call to a known blocking network entry point must bound its
wait — an explicit ``timeout=`` keyword, or a positional argument in the
callable's documented timeout slot (``urlopen(url, data, 5.0)``,
``create_connection(addr, 5.0)``). A bare ``socket.socket()`` is not
flagged (bind/listen shapes are legitimate); resolution goes through the
import map, so aliased imports are still caught and a project-local
``urlopen`` helper is not.

True negatives: any of the calls with ``timeout=`` (or the positional
slot filled), non-network callables, and test modules (``skip_tests`` —
tests pin their own harness timeouts).
"""

from __future__ import annotations

import ast

from gan_deeplearning4j_tpu_torch.analysis import _common

#: blocking network callables -> index of their positional timeout slot
NETWORK_CALLS = {
    "urllib.request.urlopen": 2,          # url, data, timeout
    "http.client.HTTPConnection": 2,      # host, port, timeout
    "http.client.HTTPSConnection": 2,
    "socket.create_connection": 1,        # address, timeout
}


class UnboundedNetworkCall:
    code = "JG017"
    name = "unbounded-network-call"
    summary = ("blocking network call without an explicit timeout — a dead "
               "peer hangs the caller forever")
    skip_tests = True

    def check(self, mod):
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            resolved = _common.resolve_call(node, mod.imports)
            slot = NETWORK_CALLS.get(resolved)
            if slot is None:
                continue
            if any(kw.arg == "timeout" for kw in node.keywords):
                continue
            if len(node.args) > slot:
                continue  # timeout passed positionally
            yield mod.finding(
                self.code,
                f"`{resolved}` blocks forever without a timeout — a hung "
                f"or half-open peer wedges this thread (and anything "
                f"waiting on it); pass an explicit `timeout=`",
                node,
            ), node
