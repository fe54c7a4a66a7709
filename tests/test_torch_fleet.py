"""The PyTorch port's fleet (``gan_deeplearning4j_tpu_torch/fleet``): the
JAX package's fleet tests run on the port's classes, parity with the JAX
classes on the same scripted inputs, and the port's drills.

- The JAX cases (``tests/test_fleet.py``), one for one: circuit-breaker
  state machine, retry budget, router proxying + ejection + re-admission
  against fake HTTP workers, the draining-restart handshake, trace
  propagation, aggregation endpoints, SLO and staleness surfaces, the
  telemetry flag, review hardening, autoscaler decisions, the brownout
  router, spawn-failure backoff and the alert plane. The fake workers are
  real stdlib HTTP servers with scripted behavior (answer / die
  mid-request / shed / hang), so every router path runs over real sockets.
- Parity: the breaker's states under a ``FakeClock``, the retry budget's
  tokens, ``Autoscaler.decide`` over scripted signals, the router's picks
  at one seed, the manager's events on one fake-spawn script, ``fold()`` of
  one merged trace, the fleet CLIs' option sets, and a JAX-written store
  generation served and rolled by the port's fleet.
- Real processes on the CPU: the port's reload drill ``--smoke --cpu`` and
  the fleet CLI over two CPU workers with one SIGKILL'd, relaunched and
  re-admitted with zero lost; the four fleet drill smokes are ``slow``, as
  the JAX package marks its own.
"""

import json
import socket
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest

from gan_deeplearning4j_tpu_torch.fleet import (
    Autoscaler,
    AutoscalerConfig,
    CircuitBreaker,
    FleetManager,
    FleetRouter,
    RetryBudget,
    make_router_server,
)

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the port's subprocesses on the CPU, one intra-op thread each
CPU_ENV = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "1"}


# ===========================================================================
# fake workers
# ===========================================================================

class _Behavior:
    """Scripted worker behavior, mutable mid-test."""

    def __init__(self):
        self.health = "ok"
        self.generation = 1
        self.queue_depth = 0
        self.in_flight = 0
        self.mode = "ok"  # ok | die | shed
        self.draining = False
        self.lock = threading.Lock()
        self.hits = 0  # /v1 requests that reached this worker
        self.trace_ids = []  # X-Trace-Id headers seen on /v1 requests
        self.payloads = []  # parsed /v1 request bodies (brownout rewrites)
        # what GET /metrics?scope=registry answers (the aggregation feed);
        # None = 404, exercising the labeled-gap path
        self.registry_snapshot = {
            "serve_requests_total": {
                "type": "counter", "help": "x",
                "series": [{"labels": {"kind": "sample", "status": "ok"},
                            "value": 0.0}],
            },
        }
        # what GET /debug/spans answers (the merged-trace feed)
        self.spans = {"traceEvents": []}


class _FakeWorkerHandler(BaseHTTPRequestHandler):
    behavior: _Behavior = None  # bound per spawn

    def _send(self, code, body):
        data = json.dumps(body).encode()
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def do_GET(self):  # noqa: N802
        b = self.behavior
        if self.path.startswith("/healthz"):
            status = "draining" if b.draining else b.health
            self._send(200, {"status": status, "generation": b.generation})
        elif self.path.startswith("/debug/spans"):
            self._send(200, b.spans)
        elif "scope=registry" in self.path:
            if b.registry_snapshot is None:
                self._send(404, {"status": "error", "error": "no registry"})
            else:
                self._send(200, b.registry_snapshot)
        else:
            self._send(200, {
                "queue_depth": b.queue_depth,
                "generation": b.generation,
                "draining": b.draining,
                "pipeline": {"in_flight": b.in_flight},
                "engine": {"serve_compile_counts": {"sample": 0}},
            })

    def do_POST(self):  # noqa: N802
        b = self.behavior
        n = int(self.headers.get("Content-Length") or 0)
        raw = self.rfile.read(n)
        if self.path.startswith("/admin/drain"):
            b.draining = True
            self._send(200, {"status": "ok", "draining": True})
            return
        with b.lock:
            b.hits += 1
            tid = self.headers.get("X-Trace-Id")
            if tid:
                b.trace_ids.append(tid)
            try:
                b.payloads.append(json.loads(raw))
            except ValueError:
                pass
        if b.mode == "die":
            # the mid-request death shape: the connection drops with no
            # response bytes — the client sees a reset/BadStatusLine
            self.close_connection = True
            try:
                self.connection.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            return
        if b.mode == "shed":
            self._send(503, {"status": "overloaded", "error": "queue full"})
            return
        self._send(200, {"status": "ok", "data": [[1.0, 2.0]]})

    def log_message(self, *args):
        pass


@pytest.fixture
def spawn_worker():
    servers = []

    def spawn():
        behavior = _Behavior()
        handler = type("BoundFake", (_FakeWorkerHandler,),
                       {"behavior": behavior})
        srv = ThreadingHTTPServer(("127.0.0.1", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return behavior, srv.server_address[1]

    yield spawn
    for srv in servers:
        srv.shutdown()
        srv.server_close()


def _router(**kw):
    kw.setdefault("request_timeout", 2.0)
    kw.setdefault("backoff_base", 0.005)
    kw.setdefault("backoff_max", 0.01)
    return FleetRouter(**kw)


def _post_sample(router):
    return router.handle("POST", "/v1/sample",
                         json.dumps({"data": [[0.5]]}).encode())


# ===========================================================================
# the circuit breaker
# ===========================================================================

class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


class TestCircuitBreaker:
    def test_init_requires_probe_admission(self):
        br = CircuitBreaker(clock=FakeClock())
        assert br.state == "init" and not br.routable
        assert br.probe_due()
        assert br.probe_result(True) == "admitted"
        assert br.routable

    def test_init_probe_failure_stays_init(self):
        # a warming worker is not FAILING, it is not ready yet — keep
        # probing, never back off
        br = CircuitBreaker(clock=FakeClock())
        br.probe_result(False)
        assert br.state == "init" and br.probe_due()

    def test_consecutive_failures_trip(self):
        br = CircuitBreaker(consecutive_failures=3, clock=FakeClock())
        br.probe_result(True)
        assert br.record(False) is None
        assert br.record(False) is None
        assert br.record(False) == "tripped"
        assert br.state == "open" and not br.routable

    def test_success_resets_the_streak(self):
        br = CircuitBreaker(consecutive_failures=3, clock=FakeClock())
        br.probe_result(True)
        br.record(False)
        br.record(False)
        br.record(True)
        assert br.record(False) is None  # streak restarted
        assert br.state == "closed"

    def test_error_rate_trips_despite_interleaved_successes(self):
        # the flaky-worker path: never 3 in a row, but 60% failing
        br = CircuitBreaker(consecutive_failures=10, error_rate=0.5,
                            rate_window=10, rate_min_samples=10,
                            clock=FakeClock())
        br.probe_result(True)
        tripped = None
        for i in range(20):
            tripped = tripped or br.record(i % 5 == 0)  # 80% failures
        assert tripped == "tripped"

    def test_half_open_single_probe_readmission(self):
        clock = FakeClock()
        br = CircuitBreaker(consecutive_failures=1, reopen_after=5.0,
                            clock=clock)
        br.probe_result(True)
        br.record(False)
        assert br.state == "open" and not br.probe_due()
        clock.now = 5.1
        assert br.state == "half_open" and br.probe_due()
        assert not br.routable  # half-open is probe-only, never routable
        assert br.probe_result(True) == "admitted"
        assert br.routable

    def test_half_open_failure_doubles_backoff(self):
        clock = FakeClock()
        br = CircuitBreaker(consecutive_failures=1, reopen_after=1.0,
                            reopen_max=30.0, clock=clock)
        br.probe_result(True)
        br.record(False)
        clock.now = 1.1
        assert br.state == "half_open"
        br.probe_result(False)
        assert br.state == "open"
        clock.now = 2.1  # 1.0s after the failed probe: doubled, not due
        assert br.state == "open"
        clock.now = 3.2
        assert br.state == "half_open"

    def test_outcomes_while_open_do_not_re_trip(self):
        clock = FakeClock()
        br = CircuitBreaker(consecutive_failures=1, reopen_after=10.0,
                            clock=clock)
        br.probe_result(True)
        br.record(False)
        trips = br.trips
        br.record(False)
        br.record(False)
        assert br.trips == trips

    def test_reset_demands_re_admission(self):
        br = CircuitBreaker(clock=FakeClock())
        br.probe_result(True)
        br.reset()
        assert br.state == "init" and not br.routable


class TestRetryBudget:
    def test_spend_to_exhaustion(self):
        b = RetryBudget(ratio=0.0, burst=2)
        assert b.spend() and b.spend()
        assert not b.spend()

    def test_deposit_caps_at_burst(self):
        b = RetryBudget(ratio=0.5, burst=2)
        for _ in range(10):
            b.deposit()
        assert b.tokens == 2.0
        assert b.spend() and b.spend() and not b.spend()
        b.deposit()  # 0.5 tokens: not enough for a whole retry
        assert not b.spend()
        b.deposit()
        assert b.spend()


# ===========================================================================
# the router (edge cases from the satellite checklist)
# ===========================================================================

class TestRouterProxy:
    def test_round_trip_and_p2c_distribution(self, spawn_worker):
        b1, p1 = spawn_worker()
        b2, p2 = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", f"http://127.0.0.1:{p2}")
        r.health_pass()
        for _ in range(20):
            status, payload = _post_sample(r)
            assert status == 200
            assert json.loads(payload)["data"] == [[1.0, 2.0]]
        # p2c with equal load must not starve either worker
        assert b1.hits > 0 and b2.hits > 0
        assert r.metrics()["ok"] == 20

    def test_worker_dies_mid_request_client_still_gets_one_answer(
            self, spawn_worker):
        dying, p1 = spawn_worker()
        healthy, p2 = spawn_worker()
        dying.mode = "die"
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", f"http://127.0.0.1:{p2}")
        r.health_pass()
        answered = 0
        for _ in range(12):
            status, payload = _post_sample(r)
            assert status == 200, payload  # every request got ONE answer
            answered += 1
        assert answered == 12
        m = r.metrics()
        # the deaths were absorbed by retries, each consuming budget
        assert dying.hits >= 1
        assert m["retries"] >= dying.hits
        assert m["retry_budget_tokens"] < r.budget.burst

    def test_all_workers_ejected_answers_fast_503(self, spawn_worker):
        b1, p1 = spawn_worker()
        b2, p2 = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", f"http://127.0.0.1:{p2}")
        for w in r.workers():
            w.breaker.eject()
        t0 = time.monotonic()
        status, payload = _post_sample(r)
        elapsed = time.monotonic() - t0
        assert status == 503
        assert b"no routable worker" in payload
        assert elapsed < 0.5  # O(1) shed, no dead-socket wait
        assert r.metrics()["no_worker"] == 1

    def test_shed_storm_exhausts_budget_to_honest_503(self, spawn_worker):
        b1, p1 = spawn_worker()
        b2, p2 = spawn_worker()
        b1.mode = b2.mode = "shed"
        r = _router(retry_ratio=0.0, retry_burst=1.0, max_attempts=4)
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", f"http://127.0.0.1:{p2}")
        r.health_pass()
        status, payload = _post_sample(r)
        assert status == 503
        assert b"retry budget exhausted" in payload
        m = r.metrics()
        assert m["budget_exhausted"] == 1
        assert m["retries"] == 1  # the single token, then the honest 503

    def test_no_worker_retry_refunds_its_budget_token(self, spawn_worker):
        # 2 workers, one ejected: a connect-failure on the survivor finds
        # nowhere to retry — the token spent for that retry must come
        # back, or a brownout drains the shared bucket on retries that
        # never happen
        dying, p1 = spawn_worker()
        _, p2 = spawn_worker()
        dying.mode = "die"
        r = _router(breaker_kwargs={"consecutive_failures": 100})
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", f"http://127.0.0.1:{p2}")
        r.health_pass()
        r.worker("w1").breaker.eject()
        tokens_before = r.budget.tokens
        status, payload = _post_sample(r)
        assert status == 503
        assert b"no routable worker" in payload
        # deposit happens per request; the retry token was refunded
        assert r.budget.tokens >= tokens_before
        assert r.metrics()["no_worker"] == 1

    def test_self_drained_worker_leaves_the_pool(self, spawn_worker):
        # a worker drained directly (POST /admin/drain on the worker, not
        # through the manager) reports draining in /metrics: the router
        # must stop routing to it even though its breaker stays closed
        behavior, p1 = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.health_pass()
        assert r.worker("w0").routable
        behavior.draining = True  # the worker marks itself
        r.health_pass()  # scrape picks the flag up
        assert not r.worker("w0").routable
        status, payload = _post_sample(r)
        assert status == 503
        assert b"no routable worker" in payload

    def test_ejection_then_half_open_readmission(self, spawn_worker):
        flaky, p1 = spawn_worker()
        steady, p2 = spawn_worker()
        flaky.mode = "die"
        r = _router(breaker_kwargs={"consecutive_failures": 1,
                                    "reopen_after": 0.05})
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", f"http://127.0.0.1:{p2}")
        r.health_pass()
        for _ in range(6):
            status, _ = _post_sample(r)
            assert status == 200
        ref = r.worker("w0")
        assert not ref.routable  # ejected after its first death
        assert r.metrics()["ejections"] == 1
        # worker recovers; after the reopen window one probe re-admits it
        flaky.mode = "ok"
        time.sleep(0.06)
        assert ref.breaker.state == "half_open"
        r.health_pass()
        assert ref.routable
        hits_before = flaky.hits
        for _ in range(10):
            assert _post_sample(r)[0] == 200
        assert flaky.hits > hits_before  # traffic actually returned

    def test_warming_worker_admitted_only_when_ok(self, spawn_worker):
        b, p = spawn_worker()
        b.health = "warming"
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        assert not r.worker("w0").routable
        status, _ = _post_sample(r)
        assert status == 503  # nothing admittable yet
        b.health = "ok"
        r.health_pass()
        assert r.worker("w0").routable
        assert _post_sample(r)[0] == 200

    def test_draining_worker_gets_no_new_requests(self, spawn_worker):
        b1, p1 = spawn_worker()
        b2, p2 = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", f"http://127.0.0.1:{p2}")
        r.health_pass()
        r.mark_draining("w0")
        for _ in range(10):
            assert _post_sample(r)[0] == 200
        assert b1.hits == 0 and b2.hits == 10
        # healthz shows the drain; un-draining restores routing
        snap = [w for w in r.healthz()["workers"] if w["id"] == "w0"][0]
        assert snap["draining"] and not snap["routable"]
        r.mark_draining("w0", False)
        for _ in range(20):
            if _post_sample(r)[0] == 200 and b1.hits:
                break
        assert b1.hits > 0

    def test_hung_scrape_ejects_an_idle_worker(self, spawn_worker):
        # passive ejection must not require traffic: the health loop's
        # scrape failing repeatedly trips the breaker too
        b, p = spawn_worker()
        r = _router(probe_timeout=0.5,
                    breaker_kwargs={"consecutive_failures": 2})
        ref = r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        assert ref.routable
        # simulate the hang by pointing the scrape at a dead port
        ref.base_url = "http://127.0.0.1:1"
        r.health_pass()
        r.health_pass()
        assert not ref.routable

    def test_http_front_end_serves_health_and_proxy(self, spawn_worker):
        import urllib.request

        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()  # pass 1 admits the worker...
        r.health_pass()  # ...pass 2 scrapes its /metrics (generation)
        srv = make_router_server(r, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            with urllib.request.urlopen(f"{base}/healthz",
                                        timeout=5.0) as resp:
                health = json.loads(resp.read())
            assert health["status"] == "ok" and health["routable"] == 1
            assert health["generation"] == 1
            req = urllib.request.Request(
                f"{base}/v1/sample",
                data=json.dumps({"data": [[0.5]]}).encode(),
                headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=5.0) as resp:
                body = json.loads(resp.read())
            assert body["status"] == "ok"
            with urllib.request.urlopen(f"{base}/metrics",
                                        timeout=5.0) as resp:
                metrics = json.loads(resp.read())
            assert metrics["ok"] == 1
        finally:
            srv.shutdown()
            srv.server_close()


# ===========================================================================
# the manager's draining restart (fake processes, real drain scrapes)
# ===========================================================================

class _FakeProc:
    def __init__(self):
        self._alive = True
        self.pid = 4242
        self.stopped = 0

    def alive(self):
        return self._alive

    def stop(self, grace: float = 10.0):
        self._alive = False
        self.stopped += 1


class TestDrainingRestart:
    def _manager(self, tmp_path, router, port, **kw):
        kw.setdefault("drain_timeout", 0.6)
        kw.setdefault("warm_timeout", 5.0)
        spawned = []

        def spawn(slot, bundle_path):
            proc = _FakeProc()
            spawned.append((slot.id, bundle_path, proc))
            return proc

        mgr = FleetManager(router, str(tmp_path / "store"), num_workers=1,
                           ports=[port], spawn=spawn, **kw)
        mgr._spawned = spawned
        return mgr

    def test_drain_completes_when_pipeline_empties(self, tmp_path,
                                                   spawn_worker):
        behavior, port = spawn_worker()
        behavior.in_flight = 2
        r = _router()
        mgr = self._manager(tmp_path, r, port, drain_timeout=5.0)
        slot = mgr.slots[0]
        mgr._launch(slot, "bundle-a")

        def empty_soon():
            time.sleep(0.3)
            behavior.in_flight = 0
            behavior.queue_depth = 0

        threading.Thread(target=empty_soon, daemon=True).start()
        assert mgr.drain_worker(slot) is True
        assert behavior.draining  # the worker was told (POST /admin/drain)
        assert r.worker("w0").draining  # and unrouted at the router

    def test_drain_with_stuck_inflight_is_bounded_then_forced(
            self, tmp_path, spawn_worker):
        behavior, port = spawn_worker()
        behavior.in_flight = 1  # never drains
        r = _router()
        mgr = self._manager(tmp_path, r, port, drain_timeout=0.5)
        slot = mgr.slots[0]
        mgr._launch(slot, "bundle-a")
        t0 = time.monotonic()
        assert mgr.drain_worker(slot) is False
        assert time.monotonic() - t0 < 3.0  # bounded, not a hang

    def test_rotate_forces_restart_and_waits_for_readmission(
            self, tmp_path, spawn_worker):
        behavior, port = spawn_worker()
        behavior.in_flight = 1  # stuck: the rotation must force it
        r = _router(probe_interval=0.05)
        mgr = self._manager(tmp_path, r, port, drain_timeout=0.3)
        slot = mgr.slots[0]
        mgr._launch(slot, "bundle-a")
        old_proc = slot.process
        # a relaunched process starts fresh: not draining, empty pipeline
        # (the fake worker server survives the "restart", so reset it at
        # spawn time the way a real exec would)
        orig_spawn = mgr._spawn

        def spawn_fresh(slot_, bundle_path):
            behavior.draining = False
            behavior.in_flight = 0
            return orig_spawn(slot_, bundle_path)

        mgr._spawn = spawn_fresh
        r.start_health_loop()
        try:
            ok = mgr.rotate_worker(slot, "bundle-b")
        finally:
            r.stop()
        assert ok  # relaunched worker was re-admitted (healthz ok)
        assert old_proc.stopped == 1  # the stuck process was torn down
        assert slot.process is not old_proc
        assert slot.bundle_path == "bundle-b"
        assert slot.restarts == 1
        assert not r.worker("w0").draining  # rotation cleared the mark

    def test_probe_cmd_pins_feature_space_to_boot_incumbent(self, tmp_path):
        # dis-feature probes must embed in ONE classifier space across
        # rolls: the pin is the boot incumbent, not the rolling bundle
        r = _router()
        mgr = FleetManager(r, str(tmp_path / "store"), num_workers=1,
                           ports=[1], spawn=lambda s, b: _FakeProc(),
                           canary_data="canary.npz",
                           canary_feature="dis_features")
        mgr._feature_bundle = "bundle-gen0"  # pinned at boot
        mgr.bundle_path = "bundle-gen5"  # the fleet rolled since
        cmd = mgr._probe_cmd("bundle-gen6")
        assert cmd[cmd.index("--feature-bundle") + 1] == "bundle-gen0"

    def test_halted_roll_rolls_back_already_rotated_workers(
            self, tmp_path, spawn_worker):
        # 2-worker fleet rolling to a candidate: w0 rotates fine, w1
        # fails to come back healthy — the candidate is quarantined AND
        # w0 (already on the candidate) must roll back to the incumbent,
        # never keep serving a quarantined generation
        from gan_deeplearning4j_tpu_torch.deploy.watcher import BundleCandidate

        _, p0 = spawn_worker()
        _, p1 = spawn_worker()
        r = _router()
        mgr = FleetManager(r, str(tmp_path / "store"), num_workers=2,
                           ports=[p0, p1],
                           spawn=lambda slot, bundle: _FakeProc(),
                           drain_timeout=0.2, warm_timeout=0.2)
        for slot in mgr.slots:
            mgr._launch(slot, "bundle-old")
        mgr.generation, mgr.bundle_path = 1, "bundle-old"
        discards = []
        mgr.watcher = type("W", (), {"discard": staticmethod(
            lambda cand, reason, quarantine=False: discards.append(
                (cand.generation, quarantine)))})()
        rotations = []

        def fake_rotate(slot, bundle_path):
            rotations.append((slot.id, bundle_path))
            if slot is mgr.slots[1] and bundle_path == "bundle-new":
                return False  # w1 cannot boot the candidate
            slot.bundle_path = bundle_path
            return True

        mgr.rotate_worker = fake_rotate
        cand = BundleCandidate(path="bundle-new", generation=2,
                               token="gen-2", manifest={})
        assert mgr._admit_and_roll(cand) is True
        assert discards == [(2, True)]  # quarantined fleet-wide, once
        assert ("w0", "bundle-old") in rotations  # w0 rolled back
        assert all(s.bundle_path == "bundle-old" for s in mgr.slots)
        assert mgr.generation == 1  # fleet stays on the incumbent
        assert mgr.status()["state"] == "halted"

    def test_feature_repin_falls_back_to_candidate_when_incumbent_gone(
            self, tmp_path, spawn_worker):
        # dis_features mode with BOTH the pinned feature bundle and the
        # incumbent GC'd: the re-pin must land on the candidate (the only
        # embedding space still on disk) — a missing pin would fail every
        # candidate probe and quarantine good generations forever
        from gan_deeplearning4j_tpu_torch.deploy.watcher import BundleCandidate

        _, p0 = spawn_worker()
        r = _router()
        mgr = FleetManager(r, str(tmp_path / "store"), num_workers=1,
                           ports=[p0],
                           spawn=lambda slot, bundle: _FakeProc(),
                           canary_data="canary.npz",
                           canary_feature="dis_features",
                           drain_timeout=0.2, warm_timeout=0.2)
        mgr._launch(mgr.slots[0], "bundle-old")
        mgr.generation = 1
        mgr.bundle_path = str(tmp_path / "gc-ed-incumbent")  # gone
        mgr._feature_bundle = str(tmp_path / "gc-ed-pin")  # gone too
        cand_dir = tmp_path / "cand"
        cand_dir.mkdir()
        mgr._sidecar_probe = lambda path: {"fid": 1.0, "accuracy": None}
        mgr.rotate_worker = lambda slot, bundle: True
        cand = BundleCandidate(path=str(cand_dir), generation=2,
                               token="gen-2", manifest={})
        assert mgr._admit_and_roll(cand) is True
        assert mgr._feature_bundle == str(cand_dir)
        assert mgr.generation == 2  # rolled (ungated — no baseline exists)
        events = [e["event"] for e in mgr.events]
        assert "ungated_roll" in events

    def test_halted_roll_keeps_incumbent_probe_baseline(
            self, tmp_path, spawn_worker):
        # the candidate passes the canary but the roll halts: the cached
        # incumbent baseline must survive — rolling the cache forward
        # before the roll completes would discard the real incumbent's
        # probe (and, once its bundle is GC'd, admit the next candidate
        # ungated despite a baseline having been measured)
        from gan_deeplearning4j_tpu_torch.deploy.watcher import BundleCandidate

        _, p0 = spawn_worker()
        r = _router()
        mgr = FleetManager(r, str(tmp_path / "store"), num_workers=1,
                           ports=[p0],
                           spawn=lambda slot, bundle: _FakeProc(),
                           canary_data="canary.npz",
                           drain_timeout=0.2, warm_timeout=0.2)
        mgr._launch(mgr.slots[0], "bundle-old")
        mgr.generation, mgr.bundle_path = 1, "bundle-old"
        incumbent_probe = {"fid": 1.0, "accuracy": 0.9}
        mgr._incumbent_probes = {1: incumbent_probe}
        mgr._sidecar_probe = lambda path: {"fid": 1.0, "accuracy": 0.9}
        mgr.watcher = type("W", (), {"discard": staticmethod(
            lambda cand, reason, quarantine=False: None)})()
        mgr.rotate_worker = lambda slot, bundle: bundle != "bundle-new"
        cand = BundleCandidate(path="bundle-new", generation=2,
                               token="gen-2", manifest={})
        assert mgr._admit_and_roll(cand) is True
        assert mgr.status()["state"] == "halted"
        assert mgr._incumbent_probes == {1: incumbent_probe}

    def test_stop_mid_roll_neither_quarantines_nor_converges(
            self, tmp_path, spawn_worker):
        # shutdown killing a worker mid-rotation must read as
        # infrastructure, not a canary verdict: the candidate generation
        # is NOT quarantined and the fleet does not claim convergence
        from gan_deeplearning4j_tpu_torch.deploy.watcher import BundleCandidate

        _, p0 = spawn_worker()
        r = _router()
        mgr = FleetManager(r, str(tmp_path / "store"), num_workers=1,
                           ports=[p0],
                           spawn=lambda slot, bundle: _FakeProc(),
                           drain_timeout=0.2, warm_timeout=0.2)
        mgr._launch(mgr.slots[0], "bundle-old")
        mgr.generation, mgr.bundle_path = 1, "bundle-old"
        discards = []
        mgr.watcher = type("W", (), {"discard": staticmethod(
            lambda cand, reason, quarantine=False: discards.append(
                cand.generation))})()

        def rotate_during_shutdown(slot, bundle):
            mgr._stop.set()  # stop() landed while this rotation ran
            return False

        mgr.rotate_worker = rotate_during_shutdown
        cand = BundleCandidate(path="bundle-new", generation=2,
                               token="gen-2", manifest={})
        assert mgr._admit_and_roll(cand) is True
        assert discards == []  # no quarantine verdict on shutdown
        assert mgr.generation == 1  # and no convergence claim
        events = [e["event"] for e in mgr.events]
        assert "roll_interrupted" in events

    def test_supervise_relaunches_a_dead_process(self, tmp_path,
                                                 spawn_worker):
        behavior, port = spawn_worker()
        r = _router()
        mgr = self._manager(tmp_path, r, port)
        slot = mgr.slots[0]
        mgr._launch(slot, "bundle-a")
        mgr.bundle_path = "bundle-a"
        # the worker earns admission (probe -> closed) and supervision
        # observes it: a ROUTABLE worker's death relaunches immediately
        # (the spawn-failure backoff is only for never-admitted boots)
        r.health_pass()
        mgr._supervise_once()
        assert slot.ever_routable
        slot.process._alive = False  # SIGKILL shape
        mgr._supervise_once()
        assert slot.restarts == 1
        assert slot.process.alive()
        assert r.worker("w0").breaker.state == "init"  # must re-earn entry

    def test_supervise_restarts_a_worker_stuck_in_init(self, tmp_path,
                                                       spawn_worker):
        # SIGSTOP (or a wedged warmup) BEFORE the first admission: the
        # breaker sits in init forever — init probe failures never trip
        # it — so hang detection must bound the launch→admission window
        _, port = spawn_worker()
        r = _router()
        mgr = self._manager(tmp_path, r, port, warm_timeout=0.1)
        slot = mgr.slots[0]
        mgr._launch(slot, "bundle-a")
        mgr.bundle_path = "bundle-a"
        assert r.worker("w0").breaker.state == "init"
        mgr._supervise_once()  # inside the allowance: left alone
        assert slot.restarts == 0
        time.sleep(0.15)
        mgr._supervise_once()
        assert slot.restarts == 1  # never-healthy worker forced out
        # the relaunch re-arms the clock: no immediate second restart
        mgr._supervise_once()
        assert slot.restarts == 1


# ===========================================================================
# the subprocess drill (slow)
# ===========================================================================

def _port_drill(tmp_path, *flags, timeout=1500):
    out = tmp_path / "drill.json"
    proc = subprocess.run(
        [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.fleet.drill",
         "--smoke", "--cpu", *flags, "--output", str(out),
         "--workdir", str(tmp_path / "work")],
        cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=CPU_ENV,
    )
    assert proc.returncode == 0, (
        f"drill {flags} breached invariants:\n{proc.stdout[-4000:]}\n"
        f"{proc.stderr[-2000:]}")
    payload = json.loads(out.read_text())
    assert payload["ok"]
    assert payload["config"]["platform"] == "cpu"
    return payload


@pytest.mark.slow
class TestFleetDrill:
    def test_drill_smoke(self, tmp_path):
        payload = _port_drill(tmp_path, timeout=1800)
        assert payload["invariants"]["exactly_one_answer_zero_lost"]
        assert payload["invariants"]["poison_never_served"]
        assert payload["invariants"]["every_boot_on_expected_platform"]

    def test_autoscale_drill_smoke(self, tmp_path):
        # the elasticity story end-to-end against real subprocesses:
        # ~10x burst -> grow to max (mid-resize SIGKILL recovered) ->
        # brownout only at max -> quiesce -> drain back to min, with the
        # zero-lost ledger and bounded p99 held throughout
        payload = _port_drill(tmp_path, "--autoscale")
        assert payload["invariants"]["exactly_one_answer_zero_lost"]
        assert payload["invariants"]["brownout_only_at_max"]
        assert payload["invariants"]["quiesce_shrinks_to_min"]

    def test_alerts_drill_smoke(self, tmp_path):
        # the fire-and-resolve story end-to-end against real
        # subprocesses: SIGKILL -> worker_down with the dead pid + an
        # exemplar trace id resolvable in the merged /debug/trace,
        # overload -> latency anomaly, quiesce -> both resolve, zero
        # false fires in the calm audit windows, zero-lost ledger
        payload = _port_drill(tmp_path, "--alerts")
        assert payload["invariants"]["worker_down_fires"]
        assert payload["invariants"]["exemplar_trace_in_merged_trace"]
        assert payload["invariants"]["latency_anomaly_fires"]
        assert payload["invariants"]["all_alerts_resolve"]
        assert payload["results"]["false_fires"] == 0

    def test_mux_drill_smoke(self, tmp_path):
        # in process: the 10/90 split, the injected burn's exact rollback
        # and the clean re-ramp, the costly variant shedding first
        payload = _port_drill(tmp_path, "--mux")
        assert payload["invariants"]["split_matches_weights"]
        assert payload["invariants"]["rollback_restores_weights"]
        assert payload["invariants"]["ramp_completes"]
        assert payload["invariants"]["brownout_sheds_expensive_first"]
        assert payload["invariants"]["zero_lost"]


# ===========================================================================
# fleet observability: trace propagation, aggregation, SLO, staleness
# ===========================================================================

class TestTracePropagation:
    def test_client_trace_id_forwarded_to_worker(self, spawn_worker):
        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        status, _ = r.handle("POST", "/v1/sample",
                             json.dumps({"data": [[0.5]]}).encode(),
                             trace_id="client-abc.1")
        assert status == 200
        assert b.trace_ids == ["client-abc.1"]

    def test_minted_id_when_client_sends_none_or_garbage(self, spawn_worker):
        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        r.handle("POST", "/v1/sample",
                 json.dumps({"data": [[0.5]]}).encode())
        r.handle("POST", "/v1/sample",
                 json.dumps({"data": [[0.5]]}).encode(),
                 trace_id="bad id\nwith junk")
        assert len(b.trace_ids) == 2
        for tid in b.trace_ids:
            assert tid and "\n" not in tid and " " not in tid
        assert "bad id\nwith junk" not in b.trace_ids

    def test_retried_request_carries_one_id_across_workers(
            self, spawn_worker):
        from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

        shedding, p1 = spawn_worker()
        healthy, p2 = spawn_worker()
        shedding.mode = "shed"
        TRACER.enable()
        r = _router(seed=3)
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", f"http://127.0.0.1:{p2}")
        r.health_pass()
        # drive until a request lands on the shedder first and is retried
        # onto the healthy worker (p2c randomness; bounded attempts)
        for i in range(40):
            tid = f"retry-case-{i}"
            status, _ = r.handle(
                "POST", "/v1/sample",
                json.dumps({"data": [[0.5]]}).encode(), trace_id=tid)
            assert status == 200
            if tid in shedding.trace_ids and tid in healthy.trace_ids:
                break
        else:
            pytest.fail("no request was retried across both workers")
        # the router's own spans carry the same id: route + 2 attempts
        events = [e for e in TRACER.events()
                  if (e.get("args") or {}).get("trace_id") == tid]
        names = {e["name"] for e in events}
        assert "fleet.route" in names
        assert "fleet.attempt" in names
        attempts = [e for e in events if e["name"] == "fleet.attempt"]
        assert {a["args"]["worker"] for a in attempts} == {"w0", "w1"}

    def test_http_front_end_echoes_trace_id_header(self, spawn_worker):
        import http.client as hc

        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        srv = make_router_server(r, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            conn = hc.HTTPConnection("127.0.0.1", srv.server_address[1],
                                     timeout=5.0)
            conn.request("POST", "/v1/sample",
                         body=json.dumps({"data": [[0.5]]}),
                         headers={"X-Trace-Id": "hdr-1"})
            resp = conn.getresponse()
            resp.read()
            assert resp.status == 200
            assert resp.getheader("X-Trace-Id") == "hdr-1"
            conn.close()
            assert b.trace_ids == ["hdr-1"]
        finally:
            srv.shutdown()
            srv.server_close()


class TestFleetAggregationEndpoints:
    def test_fleet_scope_merges_workers_and_router(self, spawn_worker):
        b1, p1 = spawn_worker()
        b2, p2 = spawn_worker()
        b1.registry_snapshot["serve_requests_total"]["series"][0][
            "value"] = 7.0
        b2.registry_snapshot["serve_requests_total"]["series"][0][
            "value"] = 5.0
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", f"http://127.0.0.1:{p2}")
        r.health_pass()
        snap = r.fleet_metrics_snapshot()
        assert snap["_fleet"]["gaps"] == []
        assert sorted(snap["_fleet"]["members"]) == ["router", "w0", "w1"]
        [series] = snap["serve_requests_total"]["series"]
        assert series["value"] == 12.0
        # the router's own registry families ride along
        assert "fleet_slo_burn_rate" in snap

    def test_failed_worker_scrape_is_a_labeled_gap(self, spawn_worker):
        b1, p1 = spawn_worker()
        b1.registry_snapshot = None  # scrape 404s
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p1}")
        r.add_worker("w1", "http://127.0.0.1:1")  # nothing listens
        r.health_pass()
        snap = r.fleet_metrics_snapshot()
        assert snap["_fleet"]["gaps"] == ["w0", "w1"]
        up = {s["labels"]["worker"]: s["value"]
              for s in snap["fleet_member_up"]["series"]}
        assert up["w0"] == 0.0 and up["w1"] == 0.0 and up["router"] == 1.0

    def test_http_fleet_scope_json_and_prom(self, spawn_worker):
        import urllib.request

        b, p = spawn_worker()
        b.registry_snapshot["serve_requests_total"]["series"][0][
            "value"] = 3.0
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        srv = make_router_server(r, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{srv.server_address[1]}"
        try:
            with urllib.request.urlopen(f"{base}/metrics?scope=fleet",
                                        timeout=5.0) as resp:
                snap = json.loads(resp.read())
            assert snap["serve_requests_total"]["series"][0]["value"] == 3.0
            with urllib.request.urlopen(
                    f"{base}/metrics?scope=fleet&format=prom",
                    timeout=5.0) as resp:
                assert "text/plain" in resp.getheader("Content-Type")
                text = resp.read().decode()
            assert 'serve_requests_total{kind="sample",status="ok"} 3' in text
            assert 'fleet_member_up{worker="w0"} 1' in text
        finally:
            srv.shutdown()
            srv.server_close()

    def test_debug_trace_merges_router_and_worker_spans(self, spawn_worker):
        from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

        b, p = spawn_worker()
        b.spans = {"traceEvents": [
            {"name": "serve.request", "ph": "X", "ts": 1.0, "dur": 2.0,
             "pid": 4242, "tid": 1, "args": {"trace_id": "t-1"}},
        ]}
        TRACER.enable()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        status, _ = r.handle("POST", "/v1/sample",
                             json.dumps({"data": [[0.5]]}).encode(),
                             trace_id="t-1")
        assert status == 200
        merged = r.fleet_trace()
        names = {e["name"] for e in merged["traceEvents"]}
        assert "serve.request" in names  # the worker's span
        assert "fleet.route" in names    # the router's own
        pids = {e["pid"] for e in merged["traceEvents"]
                if (e.get("args") or {}).get("trace_id") == "t-1"}
        assert 4242 in pids and len(pids) >= 2
        assert merged["metadata"]["gaps"] == []

    def test_debug_trace_tolerates_dead_worker(self, spawn_worker):
        r = _router()
        r.add_worker("w0", "http://127.0.0.1:1")
        merged = r.fleet_trace()
        assert merged["metadata"]["gaps"] == ["w0"]
        assert isinstance(merged["traceEvents"], list)


class TestSLOAndStalenessSurfaces:
    def test_healthz_surfaces_slo_and_scrape_age(self, spawn_worker):
        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()  # pass 1 admits (probe); pass 2 scrapes /metrics
        r.health_pass()
        for _ in range(5):
            assert _post_sample(r)[0] == 200
        body = r.healthz()
        assert body["slo"]["totals"]["requests"] == 5
        assert body["slo"]["totals"]["failed"] == 0
        [worker] = body["workers"]
        assert isinstance(worker["last_scrape_age_s"], float)
        assert worker["last_scrape_age_s"] >= 0.0

    def test_scrape_age_absent_before_first_scrape(self, spawn_worker):
        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        [worker] = [w.snapshot() for w in r.workers()]
        assert worker["last_scrape_age_s"] is None

    def test_brownout_burns_availability(self, spawn_worker):
        from gan_deeplearning4j_tpu_torch.telemetry.slo import SLOConfig

        r = _router(slo_config=SLOConfig(availability_target=0.9,
                                         fast_window_s=30.0,
                                         slow_window_s=60.0))
        # no workers registered: every request is an honest 503
        for _ in range(10):
            status, _ = _post_sample(r)
            assert status == 503
        slo = r.healthz()["slo"]
        assert slo["ok"] is False
        assert slo["burn_rates"]["availability"]["fast"] == pytest.approx(
            1.0 / (1.0 - 0.9))
        assert slo["totals"] == {"requests": 10, "failed": 10, "slow": 0}


class TestManagerTelemetryFlag:
    def test_worker_cmd_carries_telemetry(self, tmp_path):
        r = _router()
        m = FleetManager(r, str(tmp_path), num_workers=1, ports=[1],
                         spawn=lambda slot, bundle: None, telemetry=True)
        cmd = m._worker_cmd(m.slots[0], "/bundle")
        assert "--telemetry" in cmd
        m2_router = _router()
        m2 = FleetManager(m2_router, str(tmp_path), num_workers=1, ports=[2],
                          spawn=lambda slot, bundle: None)
        assert "--telemetry" not in m2._worker_cmd(m2.slots[0], "/bundle")


class TestReviewHardening:
    def test_fleet_json_is_strict_json_with_empty_slo_windows(
            self, spawn_worker):
        # an idle router's SLO gauges hold NaN (empty windows, fails
        # closed) — the JSON fleet surface must carry null, not a NaN
        # token strict parsers reject
        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        srv = make_router_server(r, port=0)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            import urllib.request

            with urllib.request.urlopen(
                    f"http://127.0.0.1:{srv.server_address[1]}"
                    f"/metrics?scope=fleet", timeout=5.0) as resp:
                text = resp.read().decode()
            # parse with NaN acceptance DISABLED — the strict-parser view
            body = json.loads(
                text, parse_constant=lambda c: pytest.fail(
                    f"non-JSON constant {c!r} in fleet payload"))
            burn = {
                (s["labels"]["objective"], s["labels"]["window"]):
                    s["value"]
                for s in body["fleet_slo_burn_rate"]["series"]
            }
            assert burn[("availability", "fast")] is None
        finally:
            srv.shutdown()
            srv.server_close()

    def test_route_exception_records_slo_failure(self, monkeypatch):
        r = _router()

        def boom(method, path, body):
            raise RuntimeError("router bug")

        monkeypatch.setattr(r, "_route", boom)
        with pytest.raises(RuntimeError):
            r.handle("POST", "/v1/sample", b"{}")
        slo = r.slo.snapshot()
        assert slo["totals"] == {"requests": 1, "failed": 1, "slow": 0}

    def test_fleet_snapshot_with_no_workers(self):
        r = _router()
        snap = r.fleet_metrics_snapshot()
        assert snap["_fleet"]["members"] == ["router"]
        assert snap["_fleet"]["gaps"] == []


# ===========================================================================
# autoscaler + brownout + resize edges
# ===========================================================================

def _signals(routable=1, queue=0, inflight=0, burn=0.0):
    """A healthy scrape: burn on both windows of both objectives."""
    return {
        "routable": routable, "queue_depth": queue, "in_flight": inflight,
        "burn_rates": {
            "availability": {"fast": burn, "slow": burn},
            "latency": {"fast": burn, "slow": burn},
        },
    }


class _ScriptedScrape:
    def __init__(self):
        self.value = _signals()

    def __call__(self):
        return self.value


class TestAutoscalerDecisions:
    def _fleet(self, tmp_path, *, slots=1, spawn=None, **cfg_kw):
        cfg_kw.setdefault("min_workers", 1)
        cfg_kw.setdefault("max_workers", 3)
        cfg_kw.setdefault("up_consecutive", 2)
        cfg_kw.setdefault("down_consecutive", 2)
        cfg_kw.setdefault("interval_s", 1.0)
        cfg_kw.setdefault("up_cooldown_s", 5.0)
        cfg_kw.setdefault("down_cooldown_s", 5.0)
        cfg_kw.setdefault("brownout_exit_ticks", 2)
        r = _router()
        mgr = FleetManager(
            r, str(tmp_path / "store"), num_workers=slots,
            ports=list(range(20001, 20001 + slots)),
            spawn=spawn or (lambda slot, bundle: _FakeProc()))
        mgr.bundle_path = "bundle-a"
        clock = FakeClock()
        scrape = _ScriptedScrape()
        auto = Autoscaler(mgr, AutoscalerConfig(**cfg_kw),
                          clock=clock, scrape=scrape)
        mgr.autoscaler = auto
        return mgr, auto, clock, scrape

    def _tick(self, auto, clock, interval=1.0):
        clock.now += interval
        return auto.tick()

    def test_unreachable_scrape_fails_closed_and_resets_streaks(
            self, tmp_path):
        # the satellite edge: an autoscaler that cannot see the router
        # HOLDS — and evidence gathered before the blackout is stale, so
        # the streak restarts from zero afterwards
        mgr, auto, clock, scrape = self._fleet(tmp_path)
        scrape.value = _signals(routable=1, queue=8)  # overloaded tick 1/2
        assert self._tick(auto, clock) == "hold"
        scrape.value = None  # router unreachable
        assert self._tick(auto, clock) == "hold_no_signals"
        assert len(mgr.slots) == 1  # held, not resized
        scrape.value = _signals(routable=1, queue=8)
        assert self._tick(auto, clock) == "hold"  # streak restarted
        assert self._tick(auto, clock) == "up"  # full streak re-earned

    def test_missing_or_nan_signals_hold(self, tmp_path):
        mgr, auto, clock, scrape = self._fleet(tmp_path)
        scrape.value = {"routable": 1, "queue_depth": None, "in_flight": 0}
        assert self._tick(auto, clock) == "hold_no_signals"
        scrape.value = {"routable": 1, "queue_depth": float("nan"),
                        "in_flight": 0}
        assert self._tick(auto, clock) == "hold_no_signals"
        # every field fails closed the same way — a NaN in_flight must
        # not slip through as pressure=NaN (which compares False both
        # ways and would quietly accumulate calm ticks)
        scrape.value = {"routable": 1, "queue_depth": 0,
                        "in_flight": float("nan")}
        assert self._tick(auto, clock) == "hold_no_signals"
        scrape.value = {"routable": None, "queue_depth": 0, "in_flight": 0}
        assert self._tick(auto, clock) == "hold_no_signals"
        # NaN burn rates (empty SLO windows) qualify nothing: with calm
        # queues they neither scale up nor block a hold
        scrape.value = {
            "routable": 1, "queue_depth": 9, "in_flight": 0,
            "burn_rates": {
                "availability": {"fast": float("nan"), "slow": 9.0},
                "latency": {"fast": float("nan"), "slow": float("nan")},
            },
        }
        # pressure 9 still qualifies the tick (queues are real data) —
        # but a NaN-mixed burn alone must not
        assert self._tick(auto, clock) == "hold"
        assert auto.status()["up_streak"] == 1

    def test_sustained_pressure_scales_up_with_cooldown(self, tmp_path):
        spawned = []

        def spawn(slot, bundle):
            spawned.append((slot.id, bundle))
            return _FakeProc()

        mgr, auto, clock, scrape = self._fleet(tmp_path, spawn=spawn)
        scrape.value = _signals(routable=1, queue=8)
        assert self._tick(auto, clock) == "hold"  # hysteresis tick 1/2
        assert self._tick(auto, clock) == "up"
        assert len(mgr.slots) == 2
        assert spawned == [("w1", "bundle-a")]  # current bundle, new id
        # cooldown: pressure stays high but the next resize must wait
        scrape.value = _signals(routable=2, queue=12)
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "hold_cooldown"
        clock.now += 5.0  # past up_cooldown_s
        assert self._tick(auto, clock) == "up"
        assert len(mgr.slots) == 3

    def test_burn_rate_alone_scales_up(self, tmp_path):
        # shallow queues but the SLO burning on BOTH windows: the fleet
        # is failing its objectives — add capacity
        mgr, auto, clock, scrape = self._fleet(tmp_path)
        scrape.value = _signals(routable=1, queue=0, burn=2.0)
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "up"
        assert len(mgr.slots) == 2

    def test_calm_scales_down_to_min_and_stops(self, tmp_path, spawn_worker):
        # two live fake workers so scale-down's drain path has a real
        # /metrics to watch; both idle -> the drain completes instantly
        b0, p0 = spawn_worker()
        b1, p1 = spawn_worker()
        mgr, auto, clock, scrape = self._fleet(tmp_path, slots=2,
                                               down_cooldown_s=0.5)
        mgr.slots[0].port, mgr.slots[0].base_url = (
            p0, f"http://127.0.0.1:{p0}")
        mgr.slots[1].port, mgr.slots[1].base_url = (
            p1, f"http://127.0.0.1:{p1}")
        mgr.drain_timeout = 2.0
        for slot in mgr.slots:
            mgr._launch(slot, "bundle-a")
        mgr.router.health_pass()
        mgr.router.health_pass()
        assert sum(1 for w in mgr.router.workers() if w.routable) == 2
        scrape.value = _signals(routable=2, queue=0)
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "down"
        assert len(mgr.slots) == 1
        # at min: calm ticks keep holding, never below min_workers
        clock.now += 5.0
        scrape.value = _signals(routable=1, queue=0)
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "hold"
        assert len(mgr.slots) == 1

    def test_scale_down_drains_the_least_loaded_worker(self, tmp_path,
                                                       spawn_worker):
        # the satellite edge: w0 is busy (queue 7), w1 idle — the retire
        # pick must be w1, through the drain handshake
        busy, p0 = spawn_worker()
        idle, p1 = spawn_worker()
        busy.queue_depth = 7
        mgr, auto, clock, scrape = self._fleet(tmp_path, slots=2)
        mgr.slots[0].port, mgr.slots[0].base_url = (
            p0, f"http://127.0.0.1:{p0}")
        mgr.slots[1].port, mgr.slots[1].base_url = (
            p1, f"http://127.0.0.1:{p1}")
        mgr.drain_timeout = 2.0
        for slot in mgr.slots:
            mgr._launch(slot, "bundle-a")
        mgr.router.health_pass()  # admit
        mgr.router.health_pass()  # scrape loads
        assert mgr.scale_down_one() is True
        assert [s.id for s in mgr.slots] == ["w0"]  # the busy one stayed
        assert idle.draining  # the retired worker got POST /admin/drain
        assert not busy.draining
        with pytest.raises(KeyError):
            mgr.router.worker("w1")  # removed from the router

    def test_resize_queues_behind_a_rolling_upgrade(self, tmp_path):
        # the satellite edge: a roll holds the cycle lock for minutes —
        # a resize decided mid-roll must defer, not interleave
        mgr, auto, clock, scrape = self._fleet(tmp_path)
        scrape.value = _signals(routable=1, queue=8)
        assert self._tick(auto, clock) == "hold"
        assert mgr._cycle_lock.acquire(blocking=False)  # "roll in flight"
        try:
            assert self._tick(auto, clock) == "deferred_roll"
            assert len(mgr.slots) == 1  # nothing interleaved
        finally:
            mgr._cycle_lock.release()
        # first post-roll tick applies the queued resize
        assert self._tick(auto, clock) == "up"
        assert len(mgr.slots) == 2

    def test_brownout_enters_escalates_and_exits_only_at_max(
            self, tmp_path):
        mgr, auto, clock, scrape = self._fleet(tmp_path, slots=3)
        r = mgr.router
        scrape.value = _signals(routable=3, queue=30)
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "brownout_enter"
        assert r.brownout_level == 1
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "brownout_escalate"
        assert r.brownout_level == 2
        assert self._tick(auto, clock) == "hold"  # deepest tier: hold
        # scale-down is forbidden while browned out; calm ticks release
        # the tiers one by one instead
        scrape.value = _signals(routable=3, queue=0)
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "brownout_exit"
        assert r.brownout_level == 1
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "brownout_exit"
        assert r.brownout_level == 0
        assert len(mgr.slots) == 3  # no resize happened under brownout

    def test_brownout_does_not_latch_on_its_own_sheds(self, tmp_path):
        # the self-inflicted-burn trap: tier-1 sheds are honest 503s the
        # SLO rightly counts as failures — if the controller read that
        # burn as "still overloaded", a trickle of large slabs would
        # hold brownout (and max size) forever after the real overload
        # ended. Under brownout, pressure alone is the evidence.
        mgr, auto, clock, scrape = self._fleet(tmp_path, slots=3)
        r = mgr.router
        scrape.value = _signals(routable=3, queue=30)
        self._tick(auto, clock)
        assert self._tick(auto, clock) == "brownout_enter"
        assert r.brownout_level == 1
        # overload over, but our own sheds keep the burn >= 1 on both
        # windows: calm ticks must still accumulate and release the tier
        scrape.value = _signals(routable=3, queue=0, burn=5.0)
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "brownout_exit"
        assert r.brownout_level == 0
        # out of brownout the burn signal re-arms: sustained burn counts
        # as overload again (and at max size that means re-entry)
        assert self._tick(auto, clock) == "hold"
        assert self._tick(auto, clock) == "brownout_enter"

    def test_status_surfaces_the_loop_state(self, tmp_path):
        mgr, auto, clock, scrape = self._fleet(tmp_path)
        scrape.value = _signals(routable=1, queue=8)
        self._tick(auto, clock)
        body = mgr.status()["autoscaler"]
        assert body["min_workers"] == 1 and body["max_workers"] == 3
        assert body["up_streak"] == 1
        assert body["last_decision"] == "hold"
        assert body["signals"]["queue_depth"] == 8

    def test_config_validation(self):
        with pytest.raises(ValueError):
            AutoscalerConfig(min_workers=3, max_workers=2).validate()
        with pytest.raises(ValueError):
            AutoscalerConfig(up_pressure=1.0, down_pressure=2.0).validate()
        with pytest.raises(ValueError):
            AutoscalerConfig(interval_s=0.0).validate()
        with pytest.raises(ValueError):
            AutoscalerConfig(brownout_exit_ticks=0).validate()
        with pytest.raises(ValueError):
            AutoscalerConfig(up_cooldown_s=-1.0).validate()


class TestBrownoutRouter:
    def test_tier1_sheds_large_sample_slabs_only(self, spawn_worker):
        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        r.set_brownout(1, max_rows=2)
        big = json.dumps({"data": [[0.5]] * 3}).encode()
        status, payload = r.handle("POST", "/v1/sample", big)
        assert status == 503
        assert b"brownout" in payload
        # small slabs still flow, and classify is never slab-shed
        assert r.handle("POST", "/v1/sample",
                        json.dumps({"data": [[0.5]]}).encode())[0] == 200
        assert r.handle("POST", "/v1/classify", big)[0] == 200
        m = r.metrics()
        assert m["brownout_shed"] == 1 and m["brownout_level"] == 1

    def test_tier2_caps_effective_deadlines(self, spawn_worker):
        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        r.set_brownout(2, max_rows=64, deadline_s=0.25)
        r.handle("POST", "/v1/sample",
                 json.dumps({"data": [[0.5]], "timeout": 9.0}).encode())
        r.handle("POST", "/v1/sample",
                 json.dumps({"data": [[0.5]]}).encode())
        r.handle("POST", "/v1/sample",
                 json.dumps({"data": [[0.5]], "timeout": 0.1}).encode())
        touts = [pl.get("timeout") for pl in b.payloads]
        # 9.0 clamped, missing injected, 0.1 (already tighter) untouched
        assert touts == [0.25, 0.25, 0.1]

    def test_brownout_surfaces_in_healthz_and_gauge(self, spawn_worker):
        from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry

        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        assert r.healthz()["status"] == "ok"
        r.set_brownout(1, max_rows=16)
        body = r.healthz()
        assert body["status"] == "brownout"
        assert body["brownout"] == {"active": True, "level": 1,
                                    "max_sample_rows": 16,
                                    "deadline_cap_s": 1.0}
        snap = get_registry().snapshot()
        [series] = snap["fleet_brownout"]["series"]
        assert series["value"] == 1.0
        r.set_brownout(0)
        assert r.healthz()["status"] == "ok"
        assert r.healthz()["brownout"]["active"] is False

    def test_brownout_off_passes_everything_through(self, spawn_worker):
        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        big = json.dumps({"data": [[0.5]] * 100}).encode()
        assert r.handle("POST", "/v1/sample", big)[0] == 200
        assert r.metrics()["brownout_shed"] == 0

    def test_malformed_body_passes_to_the_worker(self, spawn_worker):
        # admission control must not eat the worker's 400: garbage bodies
        # pass through untouched even in brownout
        b, p = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        r.set_brownout(2)
        status, _ = r.handle("POST", "/v1/sample", b"not json{{{")
        assert status == 200  # the fake worker answers everything
        assert b.hits == 1

    def test_brownout_shed_burns_the_slo(self, spawn_worker):
        from gan_deeplearning4j_tpu_torch.telemetry.slo import SLOConfig

        b, p = spawn_worker()
        r = _router(slo_config=SLOConfig(availability_target=0.9,
                                         fast_window_s=30.0,
                                         slow_window_s=60.0))
        r.add_worker("w0", f"http://127.0.0.1:{p}")
        r.health_pass()
        r.set_brownout(1, max_rows=1)
        big = json.dumps({"data": [[0.5]] * 4}).encode()
        for _ in range(4):
            assert r.handle("POST", "/v1/sample", big)[0] == 503
        slo = r.slo.snapshot()
        assert slo["totals"]["failed"] == 4  # honest 503s burn budget


class TestSpawnFailureBackoff:
    def _manager(self, tmp_path, port, procs):
        def spawn(slot, bundle):
            proc = _FakeProc()
            proc._alive = False  # dies before ever becoming routable
            procs.append(proc)
            return proc

        r = _router()
        return FleetManager(r, str(tmp_path / "store"), num_workers=1,
                            ports=[port], spawn=spawn,
                            spawn_backoff_base=0.05,
                            spawn_backoff_max=0.08)

    def test_never_routable_death_backs_off_not_hot_loops(
            self, tmp_path, spawn_worker):
        from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry

        _, port = spawn_worker()
        procs = []
        mgr = self._manager(tmp_path, port, procs)
        slot = mgr.slots[0]
        mgr._launch(slot, "bundle-a")
        mgr.bundle_path = "bundle-a"
        assert len(procs) == 1
        # first supervise pass observes the death: schedules, no relaunch
        mgr._supervise_once()
        assert slot.spawn_failures == 1
        assert len(procs) == 1  # NOT relaunched in the same pass
        # hammering supervise inside the backoff window stays a no-op —
        # the hot-loop shape JG021 polices
        for _ in range(5):
            mgr._supervise_once()
        assert len(procs) == 1
        time.sleep(0.06)  # past the 0.05s base backoff
        mgr._supervise_once()
        assert len(procs) == 2  # one relaunch, after the delay
        # it died again: the delay doubles (0.1 -> capped at 0.08)
        mgr._supervise_once()
        assert slot.spawn_failures == 2
        time.sleep(0.09)
        mgr._supervise_once()
        assert len(procs) == 3
        events = [e for e in mgr.events if e["event"] == "spawn_failure"]
        assert [e["failures"] for e in events] == [1, 2]
        assert events[1]["retry_in_s"] == 0.08  # capped
        snap = get_registry().snapshot()
        [series] = snap["fleet_spawn_failures_total"]["series"]
        assert series["value"] == 2.0

    def test_admission_resets_the_backoff_ladder(self, tmp_path,
                                                 spawn_worker):
        behavior, port = spawn_worker()
        r = _router()
        flaky = {"n": 0}

        def spawn(slot, bundle):
            flaky["n"] += 1
            proc = _FakeProc()
            proc._alive = flaky["n"] >= 2  # first boot dies, second lives
            return proc

        mgr = FleetManager(r, str(tmp_path / "store"), num_workers=1,
                           ports=[port], spawn=spawn,
                           spawn_backoff_base=0.02, spawn_backoff_max=1.0)
        slot = mgr.slots[0]
        mgr._launch(slot, "bundle-a")
        mgr.bundle_path = "bundle-a"
        mgr._supervise_once()  # death observed, backoff scheduled
        assert slot.spawn_failures == 1
        time.sleep(0.03)
        mgr._supervise_once()  # relaunch — this process lives
        r.health_pass()  # probe admits it
        mgr._supervise_once()  # supervision observes "closed"
        assert slot.ever_routable
        assert slot.spawn_failures == 0  # the ladder reset
        assert slot.next_launch_at is None


# ===========================================================================
# the alert plane on the router (telemetry/alerts.py)
# ===========================================================================

def _attach_default_alerts(router, **rule_kw):
    from gan_deeplearning4j_tpu_torch.telemetry.alerts import (
        AlertManager,
        default_fleet_rules,
    )

    mgr = AlertManager(default_fleet_rules(
        annotate_member=router.annotate_member, **rule_kw))
    router.attach_alerts(mgr)
    return mgr


class TestAlertPlane:
    def test_disabled_plane_costs_zero_new_series(self, spawn_worker):
        from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry

        behavior, port = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{port}")
        r.health_pass()
        r.health_pass()
        for _ in range(3):
            assert _post_sample(r)[0] == 200
        baseline = get_registry().series_count()
        for _ in range(3):
            _post_sample(r)
            r.health_pass()
        # no alert manager attached: serving + health traffic allocates
        # nothing new (the member gauges' series already exist from the
        # first pass — they belong to the member surface, not the alerts)
        assert get_registry().series_count() == baseline

    def test_member_gauges_refreshed_and_removed(self, spawn_worker):
        behavior, port = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{port}")
        r.health_pass()  # probe admits
        r.health_pass()  # scrape lands
        view = r.alert_view()
        [up] = view["fleet_member_routable"]["series"]
        assert up["labels"] == {"worker": "w0"} and up["value"] == 1.0
        [age] = view["fleet_member_scrape_age_seconds"]["series"]
        assert age["value"] >= 0.0
        r.remove_worker("w0")
        assert r.alert_view()["fleet_member_routable"]["series"] == []
        assert (r.alert_view()["fleet_member_scrape_age_seconds"]["series"]
                == [])

    def test_member_signals_prunes_series_recreated_by_a_race(
            self, spawn_worker):
        # review-caught: a member_signals pass racing remove_worker can
        # re-create the retired member's gauge series AFTER the removal
        # — with the ref gone nothing would ever touch it again, and
        # worker_down would page forever on a scale-down. The next pass
        # must reconcile the series set against the live worker set.
        behavior, port = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{port}")
        r.health_pass()
        r.remove_worker("w0")
        # simulate the race's leftovers: stray series for a gone member
        r._g_member_routable.labels(worker="w0").set(0.0)
        r._g_member_scrape_age.labels(worker="w0").set(42.0)
        r.member_signals()
        assert r.alert_view()["fleet_member_routable"]["series"] == []
        assert (r.alert_view()["fleet_member_scrape_age_seconds"]["series"]
                == [])

    def test_autoscaler_scrape_shares_member_signals(self, spawn_worker):
        behavior, port = spawn_worker()
        behavior.queue_depth = 3
        behavior.in_flight = 2
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{port}")
        r.health_pass()
        r.health_pass()
        mgr = FleetManager(r, "/nonexistent-store-root",
                           num_workers=1, ports=[port],
                           spawn=lambda slot, bundle: _FakeProc(),
                           autoscale=AutoscalerConfig(min_workers=1,
                                                      max_workers=2))
        signals = mgr.autoscaler._default_scrape()
        expected = r.member_signals()
        assert signals["routable"] == expected["routable"] == 1
        assert signals["queue_depth"] == expected["queue_depth"] == 3
        # in_flight is the ROUTER-side count (requests it is running
        # there now), same as the pre-seam scrape read — none here
        assert signals["in_flight"] == expected["in_flight"] == 0
        assert "availability" in signals["burn_rates"]

    def test_worker_down_fires_with_exemplar_and_annotations(
            self, spawn_worker):
        behavior, port = spawn_worker()
        # long reopen: the fake's /healthz still answers while its /v1
        # path drops connections, so a half-open probe would re-admit it
        # mid-test and clear the very alert being asserted
        r = _router(max_attempts=2,
                    breaker_kwargs={"reopen_after": 30.0})
        ref = r.add_worker("w0", f"http://127.0.0.1:{port}", pid=4242)
        _attach_default_alerts(r, probe_interval_s=1.0)
        r.health_pass()
        r.health_pass()
        assert _post_sample(r)[0] == 200  # arms worker_down (healthy once)
        behavior.mode = "die"  # connection drops mid-request from now on
        for _ in range(4):
            _post_sample(r)  # failures: breaker trips + exemplars record
        assert not ref.routable
        for _ in range(4):
            r.health_pass()  # evaluation ticks: pending -> firing
        [entry] = [e for e in r.alerts.active()
                   if e["alert"] == "worker_down"]
        assert entry["state"] == "firing"
        assert entry["labels"] == {"worker": "w0"}
        assert entry["annotations"]["pid"] == 4242
        exemplars = entry["exemplars"]
        assert exemplars and all(e["worker"] == "w0" for e in exemplars)
        assert all(e["pid"] == 4242 for e in exemplars)
        assert all(e["trace_id"] for e in exemplars)
        # healthz carries the compact block
        block = r.healthz()["alerts"]
        assert block["ok"] is False
        # the failed proxies also burn the availability SLO — both fire
        assert "worker_down" in {f["alert"] for f in block["firing"]}

    def test_alert_http_routes(self, spawn_worker):
        import urllib.request

        behavior, port = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{port}")
        srv = make_router_server(r, port=0)
        rport = srv.server_address[1]
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        try:
            # without the plane: an honest 404, not a crash
            try:
                urllib.request.urlopen(
                    f"http://127.0.0.1:{rport}/alerts", timeout=5.0)
                assert False, "expected 404"
            except urllib.error.HTTPError as exc:
                assert exc.code == 404
            _attach_default_alerts(r)
            r.health_pass()
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rport}/alerts",
                    timeout=5.0) as resp:
                doc = json.loads(resp.read())
            assert {x["name"] for x in doc["rules"]} >= {"worker_down"}
            with urllib.request.urlopen(
                    f"http://127.0.0.1:{rport}/alerts?format=prom",
                    timeout=5.0) as resp:
                assert b"# TYPE ALERTS gauge" in resp.read()
        finally:
            srv.shutdown()
            srv.server_close()

    def test_fleet_scope_keeps_member_labeled_gauges(self, spawn_worker):
        # the aggregate setdefault fix end-to-end: the router's
        # per-member gauges survive the fleet merge with their own
        # worker labels instead of being relabeled worker="router"
        behavior, port = spawn_worker()
        r = _router()
        r.add_worker("w0", f"http://127.0.0.1:{port}")
        r.health_pass()
        r.health_pass()
        snap = r.fleet_metrics_snapshot()
        routable = {s["labels"]["worker"]: s["value"]
                    for s in snap["fleet_member_routable"]["series"]}
        assert routable == {"w0": 1.0}
        ages = {s["labels"]["worker"]
                for s in snap["fleet_member_scrape_age_seconds"]["series"]}
        assert ages == {"w0"}


# ===========================================================================
# parity with the JAX package's fleet, on the same scripted inputs
# ===========================================================================

def _pkg(name):
    """The fleet package of ``name`` ("jax" or "torch")."""
    import importlib

    return importlib.import_module({"jax": "gan_deeplearning4j_tpu.fleet",
                                    "torch": "gan_deeplearning4j_tpu_torch.fleet"}[name])


def _breaker_trace(pkg, seed: int) -> list:
    rng = np.random.default_rng(seed)
    clock = FakeClock()
    br = pkg.CircuitBreaker(consecutive_failures=3, error_rate=0.5, rate_window=6,
                            rate_min_samples=4, reopen_after=1.0, reopen_max=8.0,
                            clock=clock)
    out = []
    for _ in range(300):
        op = rng.choice(["ok", "fail", "fail", "probe_ok", "probe_fail", "eject",
                         "reset", "advance", "advance"])
        if op == "ok":
            ret = br.record(True)
        elif op == "fail":
            ret = br.record(False)
        elif op == "probe_ok":
            ret = br.probe_result(True)
        elif op == "probe_fail":
            ret = br.probe_result(False)
        elif op == "eject":
            ret = br.eject()
        elif op == "reset":
            ret = br.reset()
        else:
            clock.now += float(rng.uniform(0.0, 3.0))
            ret = None
        out.append((str(op), ret, br.snapshot(), br.routable, br.probe_due()))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_breaker_states_match_jax(seed):
    jax_trace = _breaker_trace(_pkg("jax"), seed)
    assert _breaker_trace(_pkg("torch"), seed) == jax_trace
    # the script reaches every state
    assert {s["state"] for _, _, s, _, _ in jax_trace} == {"init", "closed", "open",
                                                          "half_open"}


def _budget_trace(pkg, ratio, burst, seed) -> list:
    rng = np.random.default_rng(seed)
    budget = pkg.RetryBudget(ratio, burst)
    out = []
    for _ in range(200):
        op = rng.choice(["deposit", "spend", "spend", "refund"])
        ret = getattr(budget, op)()
        out.append((str(op), ret, budget.tokens))
    return out


@pytest.mark.parametrize("ratio, burst", [(0.2, 10.0), (0.5, 3.0), (0.0, 1.0)])
def test_retry_budget_tokens_match_jax(ratio, burst):
    assert (_budget_trace(_pkg("torch"), ratio, burst, 5)
            == _budget_trace(_pkg("jax"), ratio, burst, 5))


#: the scripted signals of TestAutoscalerDecisions, as (slots, [signals])
AUTOSCALER_SCRIPTS = {
    "pressure_and_cooldown": (1, [_signals(routable=1, queue=8)] * 2
                              + [_signals(routable=2, queue=12)] * 6
                              + [None, _signals(routable=3, queue=30)]
                              + [_signals(routable=3, queue=0)] * 4),
    "fail_closed": (1, [_signals(routable=1, queue=8), None,
                        {"routable": 1, "queue_depth": None, "in_flight": 0},
                        {"routable": 1, "queue_depth": float("nan"), "in_flight": 0},
                        {"routable": 1, "queue_depth": 0, "in_flight": float("nan")},
                        {"routable": None, "queue_depth": 0, "in_flight": 0},
                        {"routable": 1, "queue_depth": 9, "in_flight": 0,
                         "burn_rates": {"availability": {"fast": float("nan"), "slow": 9.0},
                                        "latency": {"fast": float("nan"),
                                                    "slow": float("nan")}}},
                        _signals(routable=1, queue=8), _signals(routable=1, queue=0, burn=2.0),
                        _signals(routable=1, queue=0, burn=2.0)]),
    "brownout_at_max": (3, [_signals(routable=3, queue=30)] * 5
                        + [_signals(routable=3, queue=0, burn=5.0)] * 3
                        + [_signals(routable=3, queue=0)] * 6),
}


def _autoscaler_trace(pkg, tmp_path, slots, script) -> list:
    r = pkg.FleetRouter(request_timeout=2.0, backoff_base=0.005, backoff_max=0.01)
    mgr = pkg.FleetManager(r, str(tmp_path / "store"), num_workers=slots,
                           ports=list(range(20001, 20001 + slots)),
                           spawn=lambda slot, bundle: _FakeProc())
    mgr.bundle_path = "bundle-a"
    clock = FakeClock()
    scrape = _ScriptedScrape()
    auto = pkg.Autoscaler(mgr, pkg.AutoscalerConfig(
        min_workers=1, max_workers=3, up_consecutive=2, down_consecutive=2,
        interval_s=1.0, up_cooldown_s=5.0, down_cooldown_s=5.0,
        brownout_exit_ticks=2), clock=clock, scrape=scrape)
    mgr.autoscaler = auto
    out = []
    for signals in script:
        scrape.value = signals
        decided = auto.decide(signals)
        clock.now += 1.0
        out.append((decided, auto.tick(), len(mgr.slots), r.brownout_level,
                    {k: v for k, v in auto.status().items() if k != "signals"}))
    return out


@pytest.mark.parametrize("script", sorted(AUTOSCALER_SCRIPTS))
def test_autoscaler_decisions_match_jax(tmp_path, script):
    slots, signals = AUTOSCALER_SCRIPTS[script]
    jax_trace = _autoscaler_trace(_pkg("jax"), tmp_path / "jax", slots, signals)
    assert _autoscaler_trace(_pkg("torch"), tmp_path / "torch", slots, signals) == jax_trace
    assert len({action for _, action, *_ in jax_trace}) >= 3  # the script moves the loop


def _router_picks(pkg, seed) -> list:
    r = pkg.FleetRouter(seed=seed)
    for i in range(5):
        r.add_worker(f"w{i}", f"http://127.0.0.1:{30001 + i}").breaker.probe_result(True)
    rng = np.random.default_rng(seed)
    picks = []
    for _ in range(200):
        for ref in r.workers():
            ref.update_scrape({"queue_depth": int(rng.integers(0, 4))})
        exclude = {f"w{i}" for i in range(5) if rng.random() < 0.6}
        try:
            picks.append(r._pick(exclude).id)
        except pkg.NoWorkerAvailable:
            picks.append(None)
    return picks


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_router_picks_match_jax_at_one_seed(seed):
    picks = _router_picks(_pkg("torch"), seed)
    assert picks == _router_picks(_pkg("jax"), seed)
    assert set(picks) == {"w0", "w1", "w2", "w3", "w4", None}  # every worker, the refusal


def _manager_events(pkg, tmp_path, behaviors: dict) -> list:
    """One fake-spawn script: a SIGKILL'd worker relaunched, a hung one
    force-restarted, a roll onto a candidate, a candidate rejected by the
    canary. Returns the manager's events without their timings."""
    from gan_deeplearning4j_tpu_torch.deploy.watcher import BundleCandidate

    def spawn(slot, bundle_path):
        behaviors[slot.port].draining = False
        behaviors[slot.port].in_flight = 0
        return _FakeProc()

    r = pkg.FleetRouter(request_timeout=2.0, backoff_base=0.005, backoff_max=0.01,
                        probe_interval=0.05)
    mgr = pkg.FleetManager(r, str(tmp_path / "store"), num_workers=2,
                           ports=sorted(behaviors), spawn=spawn, drain_timeout=2.0,
                           warm_timeout=10.0, hang_restart_after=0.0)
    discards = []
    mgr.watcher = type("W", (), {"discard": staticmethod(
        lambda cand, reason, quarantine=False: discards.append(
            (cand.generation, reason, quarantine)))})()

    def all_routable():
        return wait_until(lambda: all(r.worker(s.id).routable for s in mgr.slots))

    # bundle directories named alike in both fleets (the incumbent's probe
    # needs its bundle on disk)
    os.chdir(tmp_path)
    for name in ("bundle-0", "bundle-1", "bundle-2"):
        os.makedirs(name, exist_ok=True)
    for slot in mgr.slots:
        mgr._launch(slot, "bundle-0")
    mgr.generation, mgr.bundle_path = 0, "bundle-0"
    r.start_health_loop()
    try:
        assert all_routable()
        mgr._supervise_once()  # first admissions
        mgr.slots[0].process._alive = False  # SIGKILL
        mgr._supervise_once()
        assert all_routable()
        mgr._supervise_once()
        r.worker("w1").breaker.eject()  # a hang: breaker open, process alive
        mgr._supervise_once()
        mgr._supervise_once()
        assert all_routable()
        mgr._supervise_once()
        assert mgr._admit_and_roll(BundleCandidate(
            path="bundle-1", generation=1, token="gen-1", manifest={}))
        mgr.canary_data = "canary.npz"
        probes = {"bundle-1": {"fid": 10.0, "accuracy": 0.9},
                  "bundle-2": {"fid": 99.0, "accuracy": 0.9}}
        mgr._sidecar_probe = lambda path: dict(probes[path])
        assert mgr._admit_and_roll(BundleCandidate(
            path="bundle-2", generation=2, token="gen-2", manifest={}))
    finally:
        r.stop()
    status = mgr.status()
    return ([{k: v for k, v in e.items() if k != "seconds"} for e in mgr.events],
            discards, status["rolls"], status["rejected"], status["generation"])


def wait_until(predicate, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.02)
    return False


def test_manager_events_match_jax(tmp_path, spawn_worker, monkeypatch):
    monkeypatch.chdir(tmp_path)  # _manager_events works in its own directory
    traces = {}
    for name in ("jax", "torch"):
        behaviors = {}
        for _ in range(2):
            behavior, port = spawn_worker()
            behaviors[port] = behavior
        os.makedirs(tmp_path / name)
        traces[name] = _manager_events(_pkg(name), tmp_path / name, behaviors)
    events = [e["event"] for e in traces["torch"][0]]
    assert events == ["routable", "routable", "restart", "routable", "restart",
                      "routable", "restart", "restart", "roll", "reject"], events
    # the ports differ between the two fleets; nothing else may
    assert traces["torch"] == traces["jax"]


def _trace_report_modules():
    import importlib.util

    from gan_deeplearning4j_tpu_torch.telemetry import trace_report as port

    spec = importlib.util.spec_from_file_location(
        "_jax_trace_report", os.path.join(REPO, "scripts", "trace_report.py"))
    jax_module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_module)
    return jax_module, port


def _merged_trace(seed: int) -> list:
    """A fleet-shaped merged trace: router and worker spans on three pids,
    async pairs, mesh stage / commit-wait spans, instants."""
    rng = np.random.default_rng(seed)
    events = []
    for pid in (100, 200, 300):
        t = 1.7e15 + float(rng.uniform(0, 1e5))
        for i in range(40):
            name = str(rng.choice(["serve.request", "serve.batcher.flush",
                                   "fleet.route", "deploy.swap"]))
            dur = float(rng.uniform(5, 5e3))
            events.append({"name": name, "ph": "X", "ts": t, "dur": dur, "pid": pid,
                           "tid": 1, "args": {"trace_id": f"t{i % 7}"}})
            t += dur + float(rng.uniform(0, 500))
        for gen in range(3):
            stage = float(rng.uniform(1e3, 9e3))
            events.append({"name": "resilience.mesh_stage", "ph": "X", "ts": t, "dur": stage,
                           "pid": pid, "tid": 2, "args": {"gen": gen, "worker": pid // 100}})
            events.append({"name": "resilience.mesh_commit_wait", "ph": "X", "ts": t + stage,
                           "dur": float(rng.uniform(1e2, 5e3)), "pid": pid, "tid": 2,
                           "args": {"gen": gen, "worker": pid // 100}})
            t += 1e4
        events.append({"name": "fleet.roll", "ph": "b", "ts": t, "pid": pid, "tid": 3,
                       "id": f"r{pid}", "cat": "fleet"})
        events.append({"name": "fleet.roll", "ph": "e", "ts": t + 7e3, "pid": pid, "tid": 3,
                       "id": f"r{pid}", "cat": "fleet"})
        events.append({"name": "fleet.autoscale", "ph": "i", "ts": t, "pid": pid, "tid": 3,
                       "s": "p"})
    return events


@pytest.mark.parametrize("seed", range(3))
def test_trace_fold_matches_jax(seed):
    jax_module, port = _trace_report_modules()
    events = _merged_trace(seed)
    assert port.validate(events) == jax_module.validate(events)
    report = port.fold(events, top_n=5)
    assert report == jax_module.fold(events, top_n=5)
    assert port.render(report) == jax_module.render(report)
    assert report["workers"]  # three pids: the per-worker tables are there


def test_trace_report_cli_matches_jax(tmp_path):
    jax_module, port = _trace_report_modules()
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": _merged_trace(9)}))
    alerts = tmp_path / "alerts.json"
    alerts.write_text(json.dumps({"incidents": [
        {"alert": "worker_down", "state": "firing", "t": 1.7e9, "labels": {"worker": "w0"}},
        {"alert": "worker_down", "state": "resolved", "t": 1.7e9 + 3, "labels": {}}]}))
    outs = {}
    for name, module in (("jax", jax_module), ("torch", port)):
        out = tmp_path / f"{name}.json"
        assert module.main([str(trace), "--alerts", str(alerts), "--json", str(out)]) == 0
        outs[name] = json.loads(out.read_text())
    assert outs["torch"] == outs["jax"]
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"traceEvents": []}))
    assert port.main([str(empty)]) != 0  # an empty trace fails the gate


def _cli_options(main) -> set:
    """The option strings of a CLI whose parser is built inside ``main``."""
    import argparse

    class _Parsed(Exception):
        pass

    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    original = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = capture
    try:
        with pytest.raises(_Parsed):
            main([])
    finally:
        argparse.ArgumentParser.parse_args = original
    return {opt for action in seen["parser"]._actions for opt in action.option_strings}


def test_fleet_cli_options_match_jax_but_the_cache_and_device():
    from gan_deeplearning4j_tpu.fleet.__main__ import main as jax_main
    from gan_deeplearning4j_tpu_torch.fleet.__main__ import main as port_main

    jax_opts, port_opts = _cli_options(jax_main), _cli_options(port_main)
    assert jax_opts - port_opts == {"--compilation-cache"}
    assert port_opts - jax_opts == {"--device"}


def test_manager_passes_the_device_to_workers_and_probes(tmp_path):
    r = _router()
    mgr = FleetManager(r, str(tmp_path / "store"), num_workers=1, ports=[1],
                       spawn=lambda s, b: _FakeProc(), canary_data="c.npz",
                       device="cpu")
    cmd = mgr._worker_cmd(mgr.slots[0], "/bundle")
    assert cmd[:3] == [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.serving"]
    assert cmd[cmd.index("--device") + 1] == "cpu"
    assert "--compilation-cache" not in cmd
    probe = mgr._probe_cmd("/bundle")
    assert probe[:3] == [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.deploy"]
    assert probe[probe.index("--device") + 1] == "cpu"
    default = FleetManager(r, str(tmp_path / "store2"), num_workers=1, ports=[2],
                           spawn=lambda s, b: _FakeProc())
    worker_cmd = default._worker_cmd(default.slots[0], "/bundle")
    assert worker_cmd[worker_cmd.index("--device") + 1] == "cuda"  # the card by default
    assert "compilation_cache" not in default.status()


def test_the_cycle_lock_is_tried_never_waited_for(tmp_path):
    # a roll holds the cycle lock for minutes: status() answers meanwhile,
    # a resize defers, and a forced blocking poll answers busy at once
    # instead of waiting the roll out; once the roll ends it runs
    mgr = FleetManager(_router(), str(tmp_path / "store"), num_workers=1, ports=[1],
                       spawn=lambda s, b: _FakeProc())
    polls = []
    mgr._poll_cycle = lambda: polls.append(time.monotonic()) or False
    assert mgr._cycle_lock.acquire(blocking=False)  # "roll in flight"
    try:
        assert mgr.status()["state"] == "idle"
        t0 = time.monotonic()
        body = mgr.poll_now(wait=True)
        assert time.monotonic() - t0 < 1.0
        assert body["busy"] is True and polls == []
    finally:
        mgr._cycle_lock.release()
    body = mgr.poll_now(wait=True)
    assert body["busy"] is False and len(polls) == 1
    assert not mgr._cycle_lock.locked()


# ===========================================================================
# real processes on the CPU
# ===========================================================================

def _tabular_config(tmp_path, seed=3):
    """The drill's toy tabular workload, for both packages' experiments."""
    from gan_deeplearning4j_tpu_torch.resilience.drill import make_workload

    return make_workload(str(tmp_path), seed, use_accelerator=False)


def test_port_fleet_serves_and_rolls_a_jax_store_generation(tmp_path):
    """Generations the JAX package's ``publish_for_serving(store=)`` wrote:
    the port's fleet boots a CPU worker on the first, answers, and rolls
    onto the second when it lands."""
    from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
    from gan_deeplearning4j_tpu.harness import GanExperiment as JaxExperiment
    from gan_deeplearning4j_tpu.resilience import CheckpointStore as JaxStore
    from gan_deeplearning4j_tpu_torch.fleet.drill import worker_platforms

    workload = _tabular_config(tmp_path)
    store_root = str(tmp_path / "store")
    jax_exp = JaxExperiment(JaxConfig.from_json(workload["config"]))
    first = jax_exp.publish_for_serving(store=JaxStore(store_root))
    r = FleetRouter(request_timeout=10.0, probe_interval=0.1)
    mgr = FleetManager(r, store_root, num_workers=1, log_dir=str(tmp_path),
                       poll_interval=0.3, worker_args=["--buckets", "1,8"], device="cpu",
                       env=CPU_ENV)
    server = make_router_server(r, "127.0.0.1", 0)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        mgr.start(boot_wait=30.0)
        assert wait_until(lambda: r.worker("w0").routable, 90.0)
        assert mgr.generation == first["generation"] == 0
        z = np.zeros((3, 4), np.float32).tolist()
        req = urllib_request(f"{base}/v1/sample", {"data": z})
        assert req["status"] == "ok" and np.asarray(req["data"]).shape == (3, 16)
        assert worker_platforms([mgr.slots[0].port]) == {str(mgr.slots[0].port): "cpu"}
        second = jax_exp.publish_for_serving(store=JaxStore(store_root))
        assert wait_until(lambda: mgr.status()["rolls"] >= 1
                          and r.worker("w0").routable, 120.0)
        assert mgr.generation == second["generation"] == 1
        after = urllib_request(f"{base}/v1/sample", {"data": z})
        assert after["status"] == "ok"
        assert wait_until(lambda: r.worker("w0").generation == 1, 10.0)
    finally:
        server.shutdown()
        server.server_close()
        mgr.stop()


def urllib_request(url, payload):
    import urllib.request

    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=30.0) as resp:
        return json.loads(resp.read())


@pytest.mark.parametrize("poison", ["saturate", "diverge"])
def test_reload_drill_smoke_cpu(tmp_path, monkeypatch, poison):
    # "saturate" is the CLI's, the JAX drill's poison and bars; "diverge",
    # the full-width run's (a NaN generator against bars that admit every
    # finite probe), is a parameter of run_reload_drill alone
    out = tmp_path / "reload.json"
    if poison == "saturate":
        proc = subprocess.run(
            [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.deploy.drill", "--smoke",
             "--cpu", "--output", str(out), "--workdir", str(tmp_path / "work")],
            cwd=REPO, capture_output=True, text=True, timeout=300, env=CPU_ENV)
        assert proc.returncode == 0, f"{proc.stdout[-4000:]}\n{proc.stderr[-2000:]}"
        payload = json.loads(out.read_text())
    else:
        from gan_deeplearning4j_tpu_torch.deploy import drill as reload_drill
        from gan_deeplearning4j_tpu_torch.resilience.drill import make_workload

        monkeypatch.setattr(reload_drill, "_ENV", {**reload_drill._ENV, "OMP_NUM_THREADS": "1"})
        workdir = str(tmp_path / "work")
        os.makedirs(workdir)
        payload = reload_drill.run_reload_drill(
            make_workload(workdir, 1, use_accelerator=False), workdir, total=24,
            serve_every=2, publish_every=6, smoke=True, poison=poison)
        poisoned = payload["results"]["poison_phase"]["poisoned_generation"]
        probe = payload["results"]["canary_probes"][str(poisoned)]
        assert not probe["passed"] and probe["fid"] != probe["fid"]  # NaN
    assert payload["ok"]
    assert payload["config"]["poison"] == poison
    # the JAX drill's nine, and where the server and the trainer ran
    assert len(payload["invariants"]) == 11
    assert payload["config"]["platform"] == payload["config"]["trainer_platform"] == "cpu"
    assert payload["results"]["swap_phase"]["swaps_observed"] >= 2


def test_fleet_cli_relaunches_a_sigkilled_worker_with_zero_lost(tmp_path):
    """The fleet CLI over two CPU workers: one SIGKILL'd under closed-loop
    load, relaunched on its port and re-admitted; every request answered."""
    import signal

    from gan_deeplearning4j_tpu_torch.deploy.drill import free_port, seed_bundle
    from gan_deeplearning4j_tpu_torch.fleet.drill import (
        LoadGenerator,
        boot_splits,
        fleet_health,
        start_fleet,
        stop_process,
        worker_by_id,
    )

    workload = _tabular_config(tmp_path)
    store = str(tmp_path / "store")
    assert seed_bundle(workload, store, keep_last=5) == 0
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    fleet = start_fleet(workload, store, str(tmp_path), port, [
        "--workers", "2", "--probe-interval", "0.1", "--request-timeout", "3.0",
        "--retry-ratio", "0.5", "--eject-failures", "2", "--reopen-after", "0.3",
        "--buckets", "1,8", "--max-latency", "0.002", "--boot-wait", "30"])
    load = None
    try:
        assert wait_until(lambda: fleet_health(base).get("routable") == 2, 90.0)
        load = LoadGenerator(base, z_size=4, threads=2)
        load.start()
        time.sleep(0.5)
        victim = worker_by_id(fleet_health(base), "w0")
        os.kill(victim["pid"], signal.SIGKILL)
        assert wait_until(lambda: (
            (h := fleet_health(base)).get("routable") == 2
            and worker_by_id(h, "w0").get("restarts") == 1
            and worker_by_id(h, "w0").get("pid") not in (None, victim["pid"])), 90.0)
        time.sleep(0.5)  # traffic on the relaunched pool
        counts = load.finish()
        load = None
        assert counts["lost"] == 0 and counts["error"] == 0
        assert counts["ok"] + counts["shed"] == counts["sent"] > 20
        health = fleet_health(base)
        assert health["fleet"]["device"] == "cpu"
        w0 = worker_by_id(health, "w0")
        assert w0["port"] == victim["port"] and w0["routable_s"] > 0
        boots = boot_splits(str(tmp_path))
        assert len(boots) == 3 and all(b["platform"] == "cpu" and b["warmed"] for b in boots)
    finally:
        if load is not None:
            load.finish()
        stop_process(fleet)


def test_the_fleet_cli_loads_without_torch():
    """The router and manager only decide: their process imports no torch
    (it would add seconds to every fleet's boot on the card), while the
    workers it spawns do."""
    code = ("import sys\n"
            "import gan_deeplearning4j_tpu_torch.fleet.__main__\n"
            "from gan_deeplearning4j_tpu_torch.deploy import CanaryThresholds, StoreWatcher\n"
            "from gan_deeplearning4j_tpu_torch.resilience import CheckpointStore\n"
            "assert 'torch' not in sys.modules\n"
            "from gan_deeplearning4j_tpu_torch.resilience import tree_digest\n"
            "import numpy as np\n"
            "assert tree_digest({'a': np.zeros(2, np.float32)}).startswith('sha256:')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
