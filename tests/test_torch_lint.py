"""The port's lint gate: the JAX package's static analyzer (stdlib-only)
over ``gan_deeplearning4j_tpu_torch`` with the rules that are not tied to
JAX. No finding may be active, and none is suppressed to get there.

- JG003 (asserts), JG017 (network timeouts) and JG024-JG029 (shared state,
  lock order, blocking under a lock, resource leaks, release balance,
  hand-offs): the port's threads, signal handlers and locks;
- JG016 (engine swap), JG022 (mux sharing), JG031 (literal ladders) and
  JG032 (the streaming iterator's double buffer): seams the port copied;
- JG021 (respawn loops): the resilience drill's relaunch loop and the
  fleet manager's supervise loop;
- JG023 (alert metrics): the families ``default_fleet_rules`` names exist,
  now that the port's fleet router creates them.
"""

import os

from gan_deeplearning4j_tpu.analysis.engine import analyze_paths
from gan_deeplearning4j_tpu.analysis.rules import RULES_BY_CODE

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT_RULES = ("JG003", "JG016", "JG017", "JG021", "JG022", "JG023", "JG024", "JG025", "JG026",
              "JG027", "JG028", "JG029", "JG031", "JG032")


def test_port_has_no_active_finding():
    report = analyze_paths(["gan_deeplearning4j_tpu_torch"],
                           rules=[RULES_BY_CODE[code] for code in PORT_RULES], root=REPO)
    assert report.files > 50  # the whole package was read
    assert [f.render() for f in report.active] == []
    assert [f.render() for f in report.suppressed] == []
