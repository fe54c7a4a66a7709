"""The port's alerting and aggregation plane (``telemetry/alerts.py``,
``telemetry/aggregate.py``), copies of the JAX package's stdlib-only
modules, and the rest of its telemetry surface.

- the cases of ``tests/test_alerts.py`` run on the port's modules: the
  rule kinds, the pending → firing → resolved lifecycle with hysteresis,
  fail-closed evaluation, exemplars, sinks, the prom rendering, the
  default packs and the registry's series removal;
- the aggregate cases of ``tests/test_telemetry.py::TestFleetAggregate``
  that need no fleet;
- held against the JAX package on the same inputs: one rule set, one
  sequence of snapshots and injected clocks give identical transitions,
  ``snapshot()``, ``health_block()`` and ``to_prometheus()``; the default
  packs describe alike; ``merge_snapshots``, ``merge_traces`` and
  ``snapshot_to_prometheus`` agree;
- the mux service with an ``AlertManager`` over ``default_mux_rules``;
  SIGUSR2's background capture; the lazy package surface imports no torch.

Everything here is clock-injected; the only socket is the webhook test's
local receiver.
"""


import json
import os
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from gan_deeplearning4j_tpu_torch.telemetry.alerts import (
    AlertManager,
    AlertRule,
    ExemplarStore,
    WebhookSink,
    default_fleet_rules,
    default_mux_rules,
)
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry


@pytest.fixture(autouse=True)
def _port_registry():
    """A fresh port metrics registry per test (tests/conftest.py resets only
    the JAX package's)."""
    from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry

    previous = set_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_registry(previous)


def gauge_snap(name, value, labels=None):
    return {name: {"type": "gauge", "help": "",
                   "series": [{"labels": labels or {}, "value": value}]}}


def manager(rules, **kw):
    clockbox = kw.pop("clockbox", [0.0])

    def clock():
        clockbox[0] += 1.0
        return clockbox[0]

    return AlertManager(rules, clock=clock, wall_clock=clock, **kw), clockbox


def states_for(mgr, name="r"):
    active = [e for e in mgr.active() if e["alert"] == name]
    return active[0]["state"] if active else "inactive"


THRESHOLD = dict(name="r", kind="threshold", metric="g", op=">", bound=5.0,
                 for_ticks=2, keep_firing_ticks=2, resolved_hold_ticks=2)


# ===========================================================================
# lifecycle
# ===========================================================================

class TestLifecycle:
    def test_full_cycle_with_hysteresis(self):
        mgr, _ = manager([AlertRule(**THRESHOLD)])
        seen = []
        for v in [1, 9, 9, 9, 1, 1, 1, 1]:
            mgr.evaluate(gauge_snap("g", v))
            seen.append(states_for(mgr))
        # 1 breach = pending (not firing: for_ticks=2); 2 clears to leave
        # firing; resolved visible for resolved_hold_ticks then inactive
        assert seen == ["inactive", "pending", "firing", "firing",
                        "firing", "resolved", "resolved", "inactive"]

    def test_flap_cannot_reach_firing(self):
        # breach/clear alternation never accumulates for_ticks=2
        mgr, _ = manager([AlertRule(**THRESHOLD)])
        for v in [9, 1, 9, 1, 9, 1, 9, 1]:
            mgr.evaluate(gauge_snap("g", v))
            assert states_for(mgr) in ("pending", "inactive")

    def test_breach_while_firing_rearms_the_resolve_hysteresis(self):
        mgr, _ = manager([AlertRule(**THRESHOLD)])
        for v in [9, 9]:
            mgr.evaluate(gauge_snap("g", v))
        assert states_for(mgr) == "firing"
        # one clear, then a breach: the clear streak resets, still firing
        for v in [1, 9, 1]:
            mgr.evaluate(gauge_snap("g", v))
        assert states_for(mgr) == "firing"

    def test_transitions_counted_per_alertname_and_state(self):
        mgr, _ = manager([AlertRule(**THRESHOLD)])
        for v in [9, 9, 1, 1]:
            mgr.evaluate(gauge_snap("g", v))
        fam = {tuple(sorted(labels.items())): series.value
               for labels, series in get_registry()
               ._families["fleet_alerts_total"].series()}
        assert fam[(("alertname", "r"), ("state", "pending"))] == 1
        assert fam[(("alertname", "r"), ("state", "firing"))] == 1
        assert fam[(("alertname", "r"), ("state", "resolved"))] == 1

    def test_incident_ring_bounded_and_ordered(self):
        mgr, _ = manager([AlertRule(**THRESHOLD)], max_incidents=4)
        for v in [9, 9, 1, 1, 9, 9, 1, 1]:
            mgr.evaluate(gauge_snap("g", v))
        incidents = mgr.snapshot()["incidents"]
        assert len(incidents) == 4  # bounded, newest kept
        assert [i["to"] for i in incidents][-1] in ("resolved", "inactive")

    def test_per_series_instances_with_labels(self):
        # one rule over a labeled family fans out per series
        mgr, _ = manager([AlertRule(**THRESHOLD)])
        snap = {"g": {"type": "gauge", "help": "", "series": [
            {"labels": {"worker": "w0"}, "value": 9.0},
            {"labels": {"worker": "w1"}, "value": 1.0},
        ]}}
        mgr.evaluate(snap)
        mgr.evaluate(snap)
        active = mgr.active()
        assert [(e["labels"], e["state"]) for e in active] == [
            ({"worker": "w0"}, "firing")]

    def test_arm_on_first_clear_suppresses_boot_breaches(self):
        rule = AlertRule(**{**THRESHOLD, "op": "<", "bound": 1.0,
                            "arm_on_first_clear": True})
        mgr, _ = manager([rule])
        # "down" from the first evaluation — boot, not a regression
        for _ in range(5):
            mgr.evaluate(gauge_snap("g", 0.0))
        assert states_for(mgr) == "inactive"
        mgr.evaluate(gauge_snap("g", 1.0))  # first healthy eval arms
        for _ in range(2):
            mgr.evaluate(gauge_snap("g", 0.0))
        assert states_for(mgr) == "firing"


# ===========================================================================
# fail-closed evaluation
# ===========================================================================

class TestFailClosed:
    def test_nan_reaches_pending_never_firing(self):
        mgr, _ = manager([AlertRule(**THRESHOLD)])
        for _ in range(10):
            mgr.evaluate(gauge_snap("g", float("nan")))
            assert states_for(mgr) == "pending"

    def test_none_value_reads_as_nan(self):
        # a JSON-sanitized snapshot (null for NaN) evaluates identically
        mgr, _ = manager([AlertRule(**THRESHOLD)])
        mgr.evaluate(gauge_snap("g", None))
        assert states_for(mgr) == "pending"

    def test_no_data_never_resolves_a_firing_alert(self):
        mgr, _ = manager([AlertRule(**THRESHOLD)])
        for v in [9, 9]:
            mgr.evaluate(gauge_snap("g", v))
        assert states_for(mgr) == "firing"
        for _ in range(10):
            mgr.evaluate(gauge_snap("g", float("nan")))
            assert states_for(mgr) == "firing"

    def test_data_gap_resets_the_clear_streak(self):
        # review-caught: keep_firing_ticks means CONSECUTIVE clears —
        # two clears separated by a blind spot (the scrape wedging
        # during the very incident being alerted on) must not sum up
        # and resolve a live breach
        mgr, _ = manager([AlertRule(**THRESHOLD)])  # keep_firing_ticks=2
        for v in [9, 9]:
            mgr.evaluate(gauge_snap("g", v))
        assert states_for(mgr) == "firing"
        for v in [1, float("nan"), 1]:  # clear, gap, clear — not 2 in a row
            mgr.evaluate(gauge_snap("g", v))
        assert states_for(mgr) == "firing"
        mgr.evaluate(gauge_snap("g", 1))  # the second CONSECUTIVE clear
        assert states_for(mgr) == "resolved"

    def test_vanished_series_resolves_after_hysteresis(self):
        # the series being GONE (a retired worker) is not an ongoing
        # breach: firing resolves after keep_firing_ticks unobserved
        mgr, _ = manager([AlertRule(**THRESHOLD)])
        for v in [9, 9]:
            mgr.evaluate(gauge_snap("g", v))
        assert states_for(mgr) == "firing"
        empty = {"g": {"type": "gauge", "help": "", "series": []}}
        mgr.evaluate(empty)
        assert states_for(mgr) == "firing"
        mgr.evaluate(empty)
        assert states_for(mgr) == "resolved"

    def test_anomaly_empty_baseline_pending_never_firing(self):
        mgr, _ = manager([AlertRule(
            name="r", kind="anomaly", metric="h", field="p99",
            window=50, min_points=10, for_ticks=1)])
        for _ in range(5):
            mgr.evaluate({"h": {"type": "histogram", "help": "", "series": [
                {"labels": {}, "count": 1, "sum": 1.0, "p99": 0.01}]}})
            assert states_for(mgr) == "pending"

    def test_burn_nan_window_pending_never_firing(self):
        mgr, _ = manager([AlertRule(
            name="r", kind="burn", metric="b", objective="availability",
            for_ticks=1)])
        snap = {"b": {"type": "gauge", "help": "", "series": [
            {"labels": {"objective": "availability", "window": "fast"},
             "value": 5.0},
            {"labels": {"objective": "availability", "window": "slow"},
             "value": float("nan")},
        ]}}
        for _ in range(3):
            mgr.evaluate(snap)
            assert states_for(mgr) == "pending"


# ===========================================================================
# rule kinds
# ===========================================================================

class TestRuleKinds:
    def test_absence_fires_on_missing_series(self):
        mgr, _ = manager([AlertRule(
            name="r", kind="absence", metric="g",
            labels={"worker": "w0"}, for_ticks=2, keep_firing_ticks=1)])
        mgr.evaluate({})
        mgr.evaluate({})
        assert states_for(mgr) == "firing"
        mgr.evaluate(gauge_snap("g", 1.0, labels={"worker": "w0"}))
        assert states_for(mgr) == "resolved"

    def test_threshold_rate_on_counter(self):
        mgr, clockbox = manager([AlertRule(
            name="r", kind="threshold", metric="c", rate=True,
            op=">", bound=0.0, for_ticks=1, keep_firing_ticks=1)])
        counter = lambda v: {"c": {"type": "counter", "help": "",  # noqa: E731
                                   "series": [{"labels": {}, "value": v}]}}
        mgr.evaluate(counter(0))      # first point: rate undefined
        assert states_for(mgr) == "pending"
        mgr.evaluate(counter(0))      # rate 0 — clear
        assert states_for(mgr) == "inactive"
        mgr.evaluate(counter(3))      # climbing
        assert states_for(mgr) == "firing"

    def test_threshold_rate_counter_reset_is_undefined(self):
        mgr, _ = manager([AlertRule(
            name="r", kind="threshold", metric="c", rate=True,
            op=">", bound=0.0, for_ticks=1, keep_firing_ticks=1)])
        counter = lambda v: {"c": {"type": "counter", "help": "",  # noqa: E731
                                   "series": [{"labels": {}, "value": v}]}}
        mgr.evaluate(counter(10))
        mgr.evaluate(counter(11))
        assert states_for(mgr) == "firing"
        # a restarted process resets the counter: dv < 0 is undefined,
        # not negative traffic — and no data never resolves
        mgr.evaluate(counter(0))
        assert states_for(mgr) == "firing"

    def test_burn_requires_both_windows(self):
        mgr, _ = manager([AlertRule(
            name="r", kind="burn", metric="b", objective="availability",
            burn_threshold=1.0, for_ticks=1, keep_firing_ticks=1)])
        snap = lambda fast, slow: {"b": {  # noqa: E731
            "type": "gauge", "help": "", "series": [
                {"labels": {"objective": "availability",
                            "window": "fast"}, "value": fast},
                {"labels": {"objective": "availability",
                            "window": "slow"}, "value": slow}]}}
        mgr.evaluate(snap(5.0, 0.1))   # fast only: the blip case
        assert states_for(mgr) == "inactive"
        mgr.evaluate(snap(5.0, 2.0))   # both: the page case
        assert states_for(mgr) == "firing"

    def test_burn_groups_per_model(self):
        # the mux scoping: one rule, one instance per model label set
        mgr, _ = manager([AlertRule(
            name="r", kind="burn", metric="mux_slo_burn_rate",
            objective="availability", for_ticks=1)])
        series = []
        for model, fast, slow in (("a", 9, 9), ("b", 0.1, 0.1)):
            for window, value in (("fast", fast), ("slow", slow)):
                series.append({"labels": {"model": model,
                                          "objective": "availability",
                                          "window": window},
                               "value": value})
        mgr.evaluate({"mux_slo_burn_rate": {"type": "gauge", "help": "",
                                            "series": series}})
        active = mgr.active()
        assert [(e["labels"]["model"], e["state"]) for e in active] == [
            ("a", "firing")]

    def test_burn_ignores_other_objective(self):
        mgr, _ = manager([AlertRule(
            name="r", kind="burn", metric="b", objective="availability",
            for_ticks=1)])
        mgr.evaluate({"b": {"type": "gauge", "help": "", "series": [
            {"labels": {"objective": "latency", "window": "fast"},
             "value": 9.0},
            {"labels": {"objective": "latency", "window": "slow"},
             "value": 9.0}]}})
        assert mgr.active() == []

    def test_anomaly_fires_on_drift_and_resolves(self):
        mgr, _ = manager([AlertRule(
            name="r", kind="anomaly", metric="h", field="p99",
            window=50, min_points=5, z_max=6.0, for_ticks=2,
            keep_firing_ticks=2, mad_floor_frac=0.05)])
        hist = lambda p99: {"h": {"type": "histogram", "help": "",  # noqa: E731
                                  "series": [{"labels": {}, "count": 9,
                                              "sum": 1.0, "p99": p99}]}}
        seen = []
        for v in [0.01, 0.011, 0.01, 0.012, 0.01, 0.011,
                  0.2, 0.2, 0.2, 0.01, 0.011]:
            mgr.evaluate(hist(v))
            seen.append(states_for(mgr))
        assert seen[6:9] == ["pending", "firing", "firing"]
        assert seen[-1] == "resolved"

    def test_anomaly_baseline_not_contaminated_by_breaches(self):
        mgr, _ = manager([AlertRule(
            name="r", kind="anomaly", metric="h", field="p99",
            window=50, min_points=5, z_max=6.0, for_ticks=1,
            keep_firing_ticks=1)])
        hist = lambda p99: {"h": {"type": "histogram", "help": "",  # noqa: E731
                                  "series": [{"labels": {}, "count": 9,
                                              "sum": 1.0, "p99": p99}]}}
        for v in [0.01, 0.011, 0.01, 0.012, 0.01]:
            mgr.evaluate(hist(v))
        for _ in range(30):  # a long incident
            mgr.evaluate(hist(0.5))
        state = list(mgr._states["r"].values())[0]
        assert max(state.baseline) < 0.1  # anomalous points never joined
        mgr.evaluate(hist(0.01))  # recovery reads against the CLEAN base
        assert states_for(mgr) == "resolved"

    def test_anomaly_mad_floor_abs_for_zero_median(self):
        # queue-depth-shaped series: median 0 + a blip of 1 must not be
        # an infinite z
        mgr, _ = manager([AlertRule(
            name="r", kind="anomaly", metric="g", field=None,
            window=50, min_points=5, z_max=8.0, mad_floor_abs=1.0,
            for_ticks=1, keep_firing_ticks=1)])
        for _ in range(6):
            mgr.evaluate(gauge_snap("g", 0.0))
        mgr.evaluate(gauge_snap("g", 2.0))
        assert states_for(mgr) in ("inactive", "pending")
        mgr.evaluate(gauge_snap("g", 50.0))
        assert states_for(mgr) == "firing"

    def test_gauge_anomaly_reads_value_when_field_none(self):
        mgr, _ = manager([AlertRule(
            name="r", kind="anomaly", metric="g", field=None,
            window=50, min_points=3, z_max=6.0, for_ticks=1,
            keep_firing_ticks=1)])
        for v in [1.0, 1.1, 1.0, 0.9]:
            mgr.evaluate(gauge_snap("g", v))
        mgr.evaluate(gauge_snap("g", 100.0))
        assert states_for(mgr) == "firing"


# ===========================================================================
# exemplars, annotations, sinks, surfaces
# ===========================================================================

class TestEvidenceAndSurfaces:
    def test_firing_captures_matching_exemplars(self):
        store = ExemplarStore()
        store.record("worker_failure", "tid-1", worker="w0", pid=11)
        store.record("worker_failure", "tid-2", worker="w1", pid=22)
        store.record("worker_failure", "tid-3", worker="w0", pid=11)
        mgr, _ = manager([AlertRule(
            **{**THRESHOLD, "op": "<", "bound": 1.0,
               "exemplar_category": "worker_failure",
               "for_ticks": 1})], exemplars=store)
        mgr.evaluate(gauge_snap("g", 0.0, labels={"worker": "w0"}))
        [entry] = mgr.active()
        ids = [e["trace_id"] for e in entry["exemplars"]]
        assert ids == ["tid-3", "tid-1"]  # newest first, w1's excluded

    def test_exemplar_store_bounded(self):
        store = ExemplarStore(per_category=3)
        for i in range(10):
            store.record("latency", f"t{i}")
        assert [e["trace_id"] for e in store.recent("latency", k=99)] == [
            "t9", "t8", "t7"]

    def test_annotate_hook_runs_at_pending(self):
        mgr, _ = manager([AlertRule(
            **{**THRESHOLD, "for_ticks": 1,
               "annotate": lambda labels: {"pid": 4242}})])
        mgr.evaluate(gauge_snap("g", 9.0))
        [entry] = mgr.active()
        assert entry["annotations"] == {"pid": 4242}
        assert mgr.snapshot()["incidents"][0]["annotations"] == {"pid": 4242}

    def test_sink_receives_transitions_and_bugs_are_contained(self):
        seen = []

        def bad_sink(record):
            raise RuntimeError("sink bug")

        mgr, _ = manager([AlertRule(**{**THRESHOLD, "for_ticks": 1})],
                         sinks=(bad_sink, seen.append))
        mgr.evaluate(gauge_snap("g", 9.0))
        assert [r["to"] for r in seen] == ["pending", "firing"]

    def test_prometheus_alerts_rendering(self):
        mgr, _ = manager([AlertRule(**{**THRESHOLD, "for_ticks": 1})])
        mgr.evaluate(gauge_snap("g", 9.0, labels={"worker": "w0"}))
        text = mgr.to_prometheus()
        assert '# TYPE ALERTS gauge' in text
        assert ('ALERTS{alertname="r",severity="page",state="firing",'
                'worker="w0"} 1') in text
        # resolved instances leave the prom surface
        for _ in range(2):
            mgr.evaluate(gauge_snap("g", 1.0, labels={"worker": "w0"}))
        assert "ALERTS{" not in mgr.to_prometheus()

    def test_snapshot_and_health_block_shapes(self):
        mgr, _ = manager([AlertRule(**{**THRESHOLD, "for_ticks": 1})])
        mgr.evaluate(gauge_snap("g", 9.0))
        snap = mgr.snapshot()
        assert snap["rules"][0]["name"] == "r"
        assert snap["counts"]["firing"] == 1
        assert json.dumps(snap)  # JSON-safe (no NaN leaks)
        block = mgr.health_block()
        assert block["ok"] is False
        assert block["firing"][0]["alert"] == "r"

    def test_webhook_sink_delivers_with_bounded_retry(self):
        hits = []

        class Hook(BaseHTTPRequestHandler):
            fail_first = [True]

            def do_POST(self):  # noqa: N802
                n = int(self.headers.get("Content-Length") or 0)
                body = json.loads(self.rfile.read(n))
                if self.fail_first[0]:
                    self.fail_first[0] = False
                    self.send_response(500)
                    self.end_headers()
                    return
                hits.append(body)
                self.send_response(200)
                self.end_headers()

            def log_message(self, *args):
                pass

        srv = ThreadingHTTPServer(("127.0.0.1", 0), Hook)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            sink = WebhookSink(
                f"http://127.0.0.1:{srv.server_address[1]}/hook",
                timeout=2.0, retries=2, backoff_s=0.01)
            sink({"alert": "r", "to": "firing"})
            deadline = 50
            while not hits and deadline:
                deadline -= 1
                threading.Event().wait(0.1)
            assert hits and hits[0]["alert"] == "r"
            assert sink.sent == 1
            sink.close()
        finally:
            srv.shutdown()
            srv.server_close()

    def test_webhook_thread_survives_non_oserror(self):
        # review-caught: a malformed URL raises ValueError from urlopen
        # — it must count as a failed delivery, not kill the daemon
        # thread (which would silently drop every FUTURE page)
        from gan_deeplearning4j_tpu_torch.telemetry.alerts import WebhookSink

        sink = WebhookSink("localhost:9/hook",  # no scheme: ValueError
                           timeout=0.5, retries=0, backoff_s=0.0)
        try:
            sink({"alert": "a", "to": "firing"})
            deadline = 50
            while sink.failed < 1 and deadline:
                deadline -= 1
                threading.Event().wait(0.05)
            assert sink.failed == 1
            assert sink._thread.is_alive()  # the channel is still up
            sink({"alert": "b", "to": "firing"})
            deadline = 50
            while sink.failed < 2 and deadline:
                deadline -= 1
                threading.Event().wait(0.05)
            assert sink.failed == 2  # later records still processed
        finally:
            sink.close()

    def test_duplicate_rule_names_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            AlertManager([AlertRule(**THRESHOLD),
                          AlertRule(**THRESHOLD)])

    def test_rule_validation(self):
        with pytest.raises(ValueError, match="kind"):
            AlertRule(name="x", kind="nope", metric="m").validate()
        with pytest.raises(ValueError, match="bound"):
            AlertRule(name="x", kind="threshold", metric="m").validate()
        with pytest.raises(ValueError, match="for_ticks"):
            AlertRule(name="x", kind="absence", metric="m",
                      for_ticks=0).validate()
        with pytest.raises(ValueError, match="min_points"):
            AlertRule(name="x", kind="anomaly", metric="m", window=2,
                      min_points=8).validate()


# ===========================================================================
# default packs + evaluation over a real merged snapshot
# ===========================================================================

class TestDefaultPacks:
    def test_packs_validate_and_are_distinct(self):
        fleet = default_fleet_rules()
        mux = default_mux_rules()
        assert {r.name for r in fleet} >= {
            "worker_down", "scrape_stale", "slo_availability_burn",
            "brownout_latched", "spawn_failures_climbing",
            "latency_anomaly", "queue_pressure_anomaly"}
        assert {r.name for r in mux} == {"model_slo_burn",
                                         "model_queue_anomaly"}
        AlertManager(fleet)  # constructs (validates every rule)

    def test_evaluator_consumes_a_real_merged_snapshot(self):
        # shape compatibility with telemetry/aggregate.merge_snapshots:
        # the evaluator reads the fleet-scope payload unchanged
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import (
            merge_snapshots,
        )

        part = {
            "fleet_member_routable": {
                "type": "gauge", "help": "",
                "series": [{"labels": {"worker": "w0"}, "value": 0.0}]},
        }
        merged = merge_snapshots({"router": part})
        rule = AlertRule(name="down", kind="threshold",
                         metric="fleet_member_routable", op="<",
                         bound=1.0, for_ticks=1, keep_firing_ticks=1)
        mgr, _ = manager([rule])
        mgr.evaluate(merged)
        [entry] = mgr.active()
        # the member's own worker label survived the merge (setdefault)
        assert entry["labels"]["worker"] == "w0"
        assert entry["state"] == "firing"


# ===========================================================================
# registry series removal (the member-gauge seam)
# ===========================================================================

class TestSeriesRemoval:
    def test_family_remove_drops_one_series(self):
        fam = get_registry().gauge("removal_g", "x",
                                   labelnames=("worker",))
        fam.labels(worker="w0").set(1.0)
        fam.labels(worker="w1").set(2.0)
        assert fam.remove(worker="w0") is True
        assert fam.remove(worker="w0") is False  # already gone
        assert [labels for labels, _ in fam.series()] == [{"worker": "w1"}]

    def test_remove_validates_labels(self):
        fam = get_registry().gauge("removal_g2", "x",
                                   labelnames=("worker",))
        with pytest.raises(ValueError):
            fam.remove(nope="x")


# ===========================================================================
# fleet aggregation: the cases of tests/test_telemetry.py that need no fleet
# ===========================================================================

class TestFleetAggregate:
    def _snap(self, build):
        from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

        reg = MetricsRegistry()
        build(reg)
        return reg.snapshot(include_samples=True)

    def test_counters_sum_exactly(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots

        def w0(reg):
            fam = reg.counter("serve_requests_total", "x", labelnames=("kind", "status"))
            fam.labels(kind="sample", status="ok").inc(7)
            fam.labels(kind="classify", status="ok").inc(2)

        def w1(reg):
            fam = reg.counter("serve_requests_total", "x", labelnames=("kind", "status"))
            fam.labels(kind="sample", status="ok").inc(5)
            fam.labels(kind="sample", status="error").inc(1)

        merged = merge_snapshots({"w0": self._snap(w0), "w1": self._snap(w1)})
        series = {tuple(sorted(s["labels"].items())): s["value"]
                  for s in merged["serve_requests_total"]["series"]}
        assert series[(("kind", "sample"), ("status", "ok"))] == 12
        assert series[(("kind", "classify"), ("status", "ok"))] == 2
        assert series[(("kind", "sample"), ("status", "error"))] == 1

    def test_counter_exactness_under_concurrent_scrapes(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots
        from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

        regs = [MetricsRegistry(), MetricsRegistry()]
        counters = [r.counter("c", "x").labels() for r in regs]
        stop = threading.Event()

        def hammer(c):
            while not stop.is_set():
                c.inc()

        threads = [threading.Thread(target=hammer, args=(c,), daemon=True)
                   for c in counters for _ in range(2)]
        for t in threads:
            t.start()
        try:
            for _ in range(50):
                snaps = [r.snapshot(include_samples=True) for r in regs]
                expected = sum(s["c"]["series"][0]["value"] for s in snaps)
                merged = merge_snapshots({"a": snaps[0], "b": snaps[1]})
                assert merged["c"]["series"][0]["value"] == expected
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=5.0)

    def test_gauges_labeled_per_worker_not_summed(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots

        def w(depth):
            def build(reg):
                reg.gauge("serve_queue_depth", "x").set(depth)
            return build

        merged = merge_snapshots({"w0": self._snap(w(3)), "w1": self._snap(w(0))})
        series = {s["labels"]["worker"]: s["value"]
                  for s in merged["serve_queue_depth"]["series"]}
        assert series == {"w0": 3.0, "w1": 0.0}

    def test_histogram_percentile_parity_vs_single_stream(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots
        from gan_deeplearning4j_tpu_torch.telemetry.registry import percentiles

        values = np.random.default_rng(11).exponential(0.05, size=301)
        split = 117

        def member(chunk):
            def build(reg):
                h = reg.histogram("lat", "x").labels()
                for v in chunk:
                    h.observe(float(v))
            return build

        merged = merge_snapshots({"w0": self._snap(member(values[:split])),
                                  "w1": self._snap(member(values[split:]))})
        got = merged["lat"]["series"][0]
        want = percentiles([float(v) for v in values])
        assert got["count"] == len(values)
        assert got["sum"] == pytest.approx(float(values.sum()))
        for key in ("p50", "p95", "p99"):
            assert got[key] == want[key]

    def test_histogram_merge_with_empty_samples_member(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots

        full = {"lat": {"type": "histogram", "help": "", "series": [
            {"labels": {}, "count": 4, "sum": 4.0, "samples": [0.5, 1.0, 1.0, 1.5]}]}}
        truncated = {"lat": {"type": "histogram", "help": "", "series": [
            {"labels": {}, "count": 3, "sum": 30.0, "samples": []}]}}
        [series] = merge_snapshots({"w0": full, "w1": truncated})["lat"]["series"]
        assert series["count"] == 7 and series["sum"] == 34.0
        assert series["p50"] == 1.0 and series["p99"] == 1.5

    def test_histogram_merge_all_members_sampleless(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots

        part = {"lat": {"type": "histogram", "help": "", "series": [
            {"labels": {}, "count": 2, "sum": 6.0, "samples": []}]}}
        [series] = merge_snapshots({"w0": part, "w1": part})["lat"]["series"]
        assert series["count"] == 4 and series["sum"] == 12.0
        assert not any(k.startswith("p") for k in series if k != "labels")

    def test_histogram_merge_missing_samples_key(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots

        with_samples = {"lat": {"type": "histogram", "help": "", "series": [
            {"labels": {}, "count": 2, "sum": 2.0, "samples": [0.9, 1.1]}]}}
        without = {"lat": {"type": "histogram", "help": "", "series": [
            {"labels": {}, "count": 5, "sum": 5.0}]}}
        [series] = merge_snapshots({"w0": with_samples, "w1": without})["lat"]["series"]
        assert series["count"] == 7 and series["sum"] == 7.0
        assert series["p50"] == 0.9

    def test_gauge_keeps_its_own_worker_label(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots

        part = {"fleet_member_routable": {"type": "gauge", "help": "", "series": [
            {"labels": {"worker": "w7"}, "value": 0.0}]}}
        [series] = merge_snapshots({"router": part})["fleet_member_routable"]["series"]
        assert series["labels"] == {"worker": "w7"}

    def test_partial_fleet_scrape_degrades_to_labeled_gap(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots

        def w(reg):
            reg.counter("c", "x").inc(4)

        merged = merge_snapshots({"w0": self._snap(w)}, gaps=["w1", "w2"])
        up = {s["labels"]["worker"]: s["value"] for s in merged["fleet_member_up"]["series"]}
        assert up == {"w0": 1.0, "w1": 0.0, "w2": 0.0}
        assert merged["_fleet"]["gaps"] == ["w1", "w2"]
        assert merged["c"]["series"][0]["value"] == 4

    def test_malformed_member_never_crashes(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import merge_snapshots

        def w(reg):
            reg.counter("c", "x").inc(1)

        merged = merge_snapshots({
            "good": self._snap(w),
            "junk": ["not", "a", "snapshot"],
            "halfjunk": {"c": {"type": "gauge", "series": [{"labels": {}, "value": 9}]},
                         "bad": 42},
        })
        assert merged["c"]["series"][0]["value"] == 1
        conflicts = "\n".join(merged["_fleet"]["conflicts"])
        assert "junk" in conflicts and "halfjunk" in conflicts

    def test_prometheus_rendering_of_merged_snapshot(self):
        from gan_deeplearning4j_tpu_torch.telemetry.aggregate import (
            merge_snapshots,
            snapshot_to_prometheus,
        )

        def w0(reg):
            reg.counter("fleet_c", "help text").inc(3)
            reg.histogram("lat", "l").labels().observe(0.25)

        def w1(reg):
            reg.counter("fleet_c", "help text").inc(4)

        text = snapshot_to_prometheus(merge_snapshots(
            {"w0": self._snap(w0), "w1": self._snap(w1)}, gaps=["w2"]))
        assert "# TYPE fleet_c counter" in text
        assert "fleet_c 7" in text
        assert 'lat{quantile="0.5"} 0.25' in text
        assert "lat_count 1" in text
        assert 'fleet_member_up{worker="w2"} 0' in text
        assert "_fleet" not in text

    def test_fmt_handles_nan_and_inf(self):
        from gan_deeplearning4j_tpu_torch.telemetry.registry import _fmt

        assert _fmt(float("nan")) == "NaN"
        assert _fmt(float("inf")) == "+Inf"
        assert _fmt(float("-inf")) == "-Inf"
        assert _fmt(3.0) == "3"

    def test_registry_snapshot_include_samples(self):
        from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry

        reg = MetricsRegistry()
        h = reg.histogram("h", "x").labels()
        h.observe(1.0)
        h.observe(2.0)
        assert "samples" not in reg.snapshot()["h"]["series"][0]
        assert reg.snapshot(include_samples=True)["h"]["series"][0]["samples"] == [1.0, 2.0]


# ===========================================================================
# the port against the JAX package, on the same inputs
# ===========================================================================

def _modules(pkg):
    import importlib

    return (importlib.import_module(f"{pkg}.telemetry.alerts"),
            importlib.import_module(f"{pkg}.telemetry.aggregate"))


PACKAGES = ("gan_deeplearning4j_tpu", "gan_deeplearning4j_tpu_torch")


def _parity_rules(alerts):
    """One rule of every kind, with exemplars and an annotation."""
    return [
        alerts.AlertRule(name="gauge_high", kind="threshold", metric="g", op=">", bound=5.0,
                         for_ticks=2, keep_firing_ticks=2, resolved_hold_ticks=2,
                         exemplar_category="slow"),
        alerts.AlertRule(name="rate_up", kind="threshold", metric="c", rate=True, op=">",
                         bound=0.5, for_ticks=1, keep_firing_ticks=1, severity="warn"),
        alerts.AlertRule(name="gone", kind="absence", metric="g", labels={"worker": "w1"},
                         for_ticks=2, keep_firing_ticks=1),
        alerts.AlertRule(name="burn", kind="burn", metric="b_slo_burn_rate",
                         objective="availability", burn_threshold=1.0, for_ticks=1,
                         annotate=lambda labels: {"model": labels.get("model")}),
        alerts.AlertRule(name="drift", kind="anomaly", metric="h", field="p99", window=50,
                         min_points=5, z_max=6.0, for_ticks=2, keep_firing_ticks=2),
    ]


def _parity_snapshots():
    """A seeded script of fleet-shaped snapshots: gauges per worker (w1
    vanishing for a while), a counter with a reset, burn windows per model,
    NaN windows, and a drifting histogram percentile."""
    rng = np.random.default_rng(5)
    snaps, count = [], 0.0
    for tick in range(40):
        count = 0.0 if tick == 25 else count + float(rng.integers(0, 3))
        g_series = [{"labels": {"worker": "w0"}, "value": float(rng.choice([1.0, 9.0]))}]
        if not 10 <= tick < 16:
            g_series.append({"labels": {"worker": "w1"}, "value": float(rng.random() * 10)})
        burn = []
        for model in ("a", "b"):
            fast = float("nan") if tick % 7 == 3 else float(rng.random() * 3)
            slow = float(rng.random() * 2)
            burn += [{"labels": {"model": model, "objective": "availability", "window": "fast"},
                      "value": fast},
                     {"labels": {"model": model, "objective": "availability", "window": "slow"},
                      "value": slow}]
        p99 = 0.2 if 18 <= tick < 22 else 0.01 + 0.001 * float(rng.random())
        snaps.append({
            "g": {"type": "gauge", "help": "", "series": g_series},
            "c": {"type": "counter", "help": "", "series": [{"labels": {}, "value": count}]},
            "b_slo_burn_rate": {"type": "gauge", "help": "", "series": burn},
            "h": {"type": "histogram", "help": "", "series": [
                {"labels": {}, "count": 9, "sum": 1.0, "p99": p99}]},
        })
    return snaps


def _drive(pkg):
    alerts, _ = _modules(pkg)
    ticks = [0.0]

    def clock():
        ticks[0] += 1.5
        return ticks[0]

    exemplars = alerts.ExemplarStore(wall_clock=clock)
    for i in range(5):
        exemplars.record("slow", f"tid-{i}", worker=f"w{i % 2}")
    seen = []
    mgr = alerts.AlertManager(_parity_rules(alerts), clock=clock, wall_clock=clock,
                              exemplars=exemplars, sinks=(seen.append,))
    per_tick = []
    for snap in _parity_snapshots():
        mgr.evaluate(snap)
        per_tick.append(mgr.active())
    return {"transitions": seen, "active": per_tick, "snapshot": mgr.snapshot(),
            "health": mgr.health_block(), "prom": mgr.to_prometheus()}


def test_alert_manager_equals_jax_on_one_script():
    jax_run, port_run = (_drive(pkg) for pkg in PACKAGES)
    assert port_run["transitions"], "the script must move some alert"
    assert {t["to"] for t in port_run["transitions"]} >= {"pending", "firing", "resolved"}
    for key in ("transitions", "active", "snapshot", "health", "prom"):
        assert port_run[key] == jax_run[key], key


def test_default_packs_describe_alike():
    (jax_alerts, _), (pt_alerts, _) = (_modules(pkg) for pkg in PACKAGES)
    for pack in ("default_fleet_rules", "default_mux_rules"):
        jax_pack = [r.describe() for r in getattr(jax_alerts, pack)()]
        pt_pack = [r.describe() for r in getattr(pt_alerts, pack)()]
        assert pt_pack == jax_pack, pack


def test_merges_and_exposition_equal_jax():
    parts = {}
    for member, seed in (("w0", 1), ("w1", 2), ("router", 3)):
        rng = np.random.default_rng(seed)
        samples = [float(v) for v in rng.exponential(0.05, 40)]
        parts[member] = {
            "serve_requests_total": {"type": "counter", "help": "requests", "series": [
                {"labels": {"kind": "sample"}, "value": float(rng.integers(1, 50))}]},
            "serve_queue_depth": {"type": "gauge", "help": "depth", "series": [
                {"labels": {}, "value": float(rng.integers(0, 4))}]},
            "lat": {"type": "histogram", "help": "latency", "series": [
                {"labels": {"kind": "sample"}, "count": len(samples), "sum": sum(samples),
                 "samples": samples}]},
            "burn": {"type": "gauge", "help": "", "series": [
                {"labels": {"window": "fast"}, "value": float("nan")}]},
        }
    parts["junk"] = ["not", "a", "snapshot"]
    traces = {"w0": {"traceEvents": [{"name": "a", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 1}]},
              "w1": None,
              "w2": {"traceEvents": [{"name": "b", "ph": "i", "ts": 3.0, "pid": 2}]}}
    out = []
    for pkg in PACKAGES:
        _, agg = _modules(pkg)
        merged = agg.merge_snapshots(parts, gaps=["w9"],
                                     member_labels={"w0": {"generation": "4"}})
        out.append((merged, agg.snapshot_to_prometheus(merged), agg.json_sanitize(merged),
                    agg.merge_traces(traces, metadata={"scope": "fleet"})))
    jax_out, pt_out = out
    assert json.dumps(pt_out[2], sort_keys=True) == json.dumps(jax_out[2], sort_keys=True)
    assert pt_out[1] == jax_out[1]
    assert pt_out[3] == jax_out[3]


# ===========================================================================
# the mux service's alert plane
# ===========================================================================

class _Engine:
    """Engine-shaped fake: dispatch/finalize doubling the rows."""

    def __init__(self, generation=None):
        self.generation = generation
        self.warmed, self.warm_failed, self.kinds = True, False, ("sample",)

    def warmup(self, background=False):
        return {}

    def input_width(self, kind):
        return 4

    def dispatch(self, kind, rows_list):
        import types

        return types.SimpleNamespace(lane=0, rows=[np.asarray(r) for r in rows_list])

    def finalize(self, flight):
        return np.concatenate(flight.rows) * 2.0


def _mux(alerts=None):
    from gan_deeplearning4j_tpu_torch.serving import mux

    reg = mux.MuxRegistry(buckets=(1, 8), budget=4, build=lambda v: _Engine(v.generation),
                          batcher_kwargs={"max_latency": 0.0, "default_timeout": 2.0})
    reg.add("heavy", bundle_path="/h", cost=4.0, weight=0.8)
    reg.add("lite", bundle_path="/l", cost=1.0, weight=0.2)
    return mux.MuxService(reg, alerts=alerts)


def test_mux_model_burn_rule_scopes_per_variant():
    mgr = AlertManager(default_mux_rules())
    svc = _mux(mgr)
    try:
        code, hz = svc.handle("GET", "/healthz")
        assert hz["alerts"]["ok"] is True and hz["alerts"]["rules"] == 2
        for _ in range(50):
            svc.tracker_for("heavy").record(False)
            svc.tracker_for("lite").record(True, 0.01)
        for _ in range(6):
            svc.control_tick()
        firing = [e for e in mgr.active() if e["state"] == "firing"]
        assert {e["labels"].get("model") for e in firing} == {"heavy"}
        assert {e["alert"] for e in firing} == {"model_slo_burn"}
        code, body = svc.handle("GET", "/alerts")
        assert code == 200 and body["counts"]["firing"] >= 1
        code, hz = svc.handle("GET", "/healthz")
        assert hz["alerts"]["ok"] is False
    finally:
        svc.close()


def test_mux_without_alert_plane_is_a_404():
    svc = _mux()
    try:
        code, _ = svc.handle("GET", "/alerts")
        assert code == 404
        svc.control_tick()
    finally:
        svc.close()


# ===========================================================================
# SIGUSR2 captures, and the package surface
# ===========================================================================

def test_sigusr2_triggers_background_capture(tmp_path):
    import os
    import signal
    import time

    from gan_deeplearning4j_tpu_torch.telemetry.device import TRACE_NAME, install_signal_capture

    artifacts = str(tmp_path / "sig")
    old = signal.getsignal(signal.SIGUSR2)
    try:
        install_signal_capture(artifacts, duration_ms=30)
        os.kill(os.getpid(), signal.SIGUSR2)
        deadline = time.monotonic() + 60.0
        files = []
        while time.monotonic() < deadline and not files:
            files = [f for _, _, fs in os.walk(artifacts) for f in fs if f == TRACE_NAME]
            time.sleep(0.05)
        assert files, "SIGUSR2 produced no capture"
    finally:
        signal.signal(signal.SIGUSR2, old)


def test_signal_landing_mid_capture_is_dropped(tmp_path, caplog):
    import logging
    import os
    import signal
    import time

    from gan_deeplearning4j_tpu_torch.telemetry import device

    old = signal.getsignal(signal.SIGUSR2)
    assert device._capture_lock.acquire(blocking=False)  # a capture is "running"
    try:
        with caplog.at_level(logging.WARNING, logger=device.__name__):
            device.install_signal_capture(str(tmp_path), duration_ms=30)
            os.kill(os.getpid(), signal.SIGUSR2)
            deadline = time.monotonic() + 10.0
            while time.monotonic() < deadline and "SIGUSR2 ignored" not in caplog.text:
                time.sleep(0.02)
        assert "SIGUSR2 ignored" in caplog.text
        assert not os.listdir(str(tmp_path))
    finally:
        device._capture_lock.release()
        signal.signal(signal.SIGUSR2, old)


def test_telemetry_surface_is_lazy_and_matches_jax():
    import subprocess
    import sys

    import gan_deeplearning4j_tpu.telemetry as jax_telemetry
    import gan_deeplearning4j_tpu_torch.telemetry as pt_telemetry

    assert sorted(pt_telemetry.__all__) == sorted(jax_telemetry.__all__)
    code = ("import sys\n"
            "import gan_deeplearning4j_tpu_torch.telemetry as t\n"
            "t.AlertManager, t.merge_snapshots, t.TRACER, t.get_registry, t.SLOTracker\n"
            "assert 'torch' not in sys.modules, 'the telemetry surface imported torch'\n"
            "t.install_signal_capture\n"
            "assert 'torch' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    assert proc.returncode == 0, proc.stderr


def test_first_signal_inside_a_graph_capture_is_dropped(tmp_path, caplog, monkeypatch):
    """The first SIGUSR2 primes the profiler on the main thread; one that
    lands inside a CUDA-graph capture there is dropped instead (priming
    would run profiler work mid-capture)."""
    import logging
    import os
    import signal

    from gan_deeplearning4j_tpu_torch.runtime.capture import capture_guard, capturing
    from gan_deeplearning4j_tpu_torch.telemetry import device

    monkeypatch.setattr(device, "_primed", False)
    old = signal.getsignal(signal.SIGUSR2)
    try:
        with caplog.at_level(logging.WARNING, logger=device.__name__):
            device.install_signal_capture(str(tmp_path), duration_ms=30)
            with capture_guard():
                assert capturing()
                os.kill(os.getpid(), signal.SIGUSR2)  # the handler runs before the next line
            assert not capturing()
        assert "being captured" in caplog.text
        assert not device._primed and not os.listdir(str(tmp_path))
    finally:
        signal.signal(signal.SIGUSR2, old)
