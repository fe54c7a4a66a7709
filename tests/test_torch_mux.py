"""PyTorch port, the mux plane (``serving/mux``, ``telemetry/slo.py``)
against the JAX package's, on the CPU:

- the splitter's assignment of 10,000 keys, before and after a weight
  change, key for key, with the same minimal reassignment;
- ``SLOTracker`` burn rates and the ``RampController`` state sequence under
  an injected clock and a scripted health signal;
- a mux over tiny bundles (an fp32 bundle and its int8 variant) in both
  packages: each key goes to the same variant, each variant's rows agree
  (fp32: 1e-5; int8: two code steps, the bound of
  ``tests/test_torch_quant.py``), the brownout shed order is the same, and
  ``/healthz`` and ``/metrics`` carry the same keys;
- the port's own mux: the shared staging pool reused across variants,
  demote and re-warm, and the HTTP front end over it.

The engines run with ``device="cpu"``: there is no capture on the CPU.
"""

import json
import math
import os
import threading
import types
import urllib.request

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.nn import DenseLayer as JaxDense
from gan_deeplearning4j_tpu.nn import GraphBuilder as JaxBuilder
from gan_deeplearning4j_tpu.nn import GraphConfig as JaxConfig
from gan_deeplearning4j_tpu.nn import InputType as JaxInputType
from gan_deeplearning4j_tpu.nn import OutputLayer as JaxOutput
from gan_deeplearning4j_tpu.serving import mux as jax_mux
from gan_deeplearning4j_tpu.telemetry import slo as jax_slo
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu_torch.quant import QuantDenseLayer, build_int8_variant
from gan_deeplearning4j_tpu_torch.serving import make_server
from gan_deeplearning4j_tpu_torch.serving import mux as pt_mux
from gan_deeplearning4j_tpu_torch.telemetry import slo as pt_slo
from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry
from gan_deeplearning4j_tpu_torch.utils import serializer as pt_ser

Z, FEAT, CLASSES, HIDDEN = 4, 6, 3, 5
FP32_TOL = 1e-5


@pytest.fixture(autouse=True)
def _port_registry():
    """A fresh port metrics registry per test (tests/conftest.py resets only
    the JAX package's)."""
    previous = set_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_registry(previous)


# -- the splitter ---------------------------------------------------------------

KEYS = [f"user-{i}" for i in range(10_000)]


def _assign_all(splitter, among=None):
    return [splitter.assign(k, among=among) for k in KEYS]


def test_splitter_assigns_10000_keys_as_jax_before_and_after_a_weight_change():
    weights = {"fp32": 0.5, "bf16": 0.3, "int8": 0.2}
    pt, jx = pt_mux.WeightedSplitter(weights), jax_mux.WeightedSplitter(weights)
    before = _assign_all(pt)
    assert before == _assign_all(jx)
    assert _assign_all(pt, among=["bf16", "int8"]) == _assign_all(jx, among=["bf16", "int8"])
    pt.set_weight("int8", 0.6)
    jx.set_weight("int8", 0.6)
    after = _assign_all(pt)
    assert after == _assign_all(jx)
    moved = [i for i, (a, b) in enumerate(zip(before, after)) if a != b]
    # minimal reassignment: raising one weight only moves keys onto it
    assert moved and all(after[i] == "int8" for i in moved)
    assert pt.shares() == jx.shares()
    pt.set_weights({"fp32": 0.0, "bf16": 1.0})
    jx.set_weights({"fp32": 0.0, "bf16": 1.0})
    assert _assign_all(pt) == _assign_all(jx)
    pt.remove("bf16")
    jx.remove("bf16")
    assert _assign_all(pt) == _assign_all(jx) == ["int8"] * len(KEYS)
    assert pt.snapshot() == jx.snapshot()


def test_splitter_refusals_match_jax():
    for mod in (pt_mux, jax_mux):
        s = mod.WeightedSplitter()
        with pytest.raises(ValueError):
            s.set_weight("a", -1.0)
        with pytest.raises(ValueError):
            s.set_weight("a", math.nan)
        with pytest.raises(LookupError):
            s.assign("k")


# -- SLO burn rates and the ramp --------------------------------------------------

def _slo_script(seed=11):
    """(dt, ok, latency_s) events drawn with numpy: healthy, then a burst of
    failures and slow answers, then healthy again."""
    rng = np.random.default_rng(seed)
    out = []
    for n, p_fail, slow in ((120, 0.0, 0.01), (60, 0.3, 0.9), (120, 0.0, 0.02)):
        for _ in range(n):
            ok = bool(rng.random() >= p_fail)
            out.append((float(rng.uniform(0.05, 0.4)), ok, float(rng.uniform(0.0, slow))))
    return out


def test_slo_burn_rates_equal_jax_under_an_injected_clock():
    clock = {"t": 1000.0}
    config = dict(fast_window_s=10.0, slow_window_s=60.0, latency_threshold_s=0.5)
    pt = pt_slo.SLOTracker(pt_slo.SLOConfig(**config), clock=lambda: clock["t"],
                           metric_prefix="mux", labels={"model": "cand"})
    jx = jax_slo.SLOTracker(jax_slo.SLOConfig(**config), clock=lambda: clock["t"],
                            metric_prefix="mux", labels={"model": "cand"})
    assert json.dumps(pt.burn_rates(), sort_keys=True) == json.dumps(jx.burn_rates(), sort_keys=True)
    seen_unhealthy = False
    for i, (dt, ok, lat) in enumerate(_slo_script()):
        clock["t"] += dt
        if i == 150:
            clock["t"] -= 5.0  # a clock that steps back: both clamp it
        pt.record(ok, lat if ok else None)
        jx.record(ok, lat if ok else None)
        if i % 7 == 0:
            a, b = pt.burn_rates(), jx.burn_rates()
            assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
            assert pt.ok() == jx.ok()
            seen_unhealthy |= not pt.ok()
    assert seen_unhealthy
    assert json.dumps(pt.snapshot(), sort_keys=True) == json.dumps(jx.snapshot(), sort_keys=True)


class _FakeEngine:
    """Engine-shaped fake: dispatch/finalize doubling the rows."""

    def __init__(self, generation=None):
        self.generation = generation
        self.warmed, self.warm_failed, self.kinds = True, False, ("sample",)

    def warmup(self, background=False):
        return {}

    def input_width(self, kind):
        return Z

    def dispatch(self, kind, rows_list):
        return types.SimpleNamespace(lane=0, rows=[np.asarray(r) for r in rows_list])

    def finalize(self, flight):
        return np.concatenate(flight.rows) * 2.0


def _fake_registry(mod, budget=8):
    reg = mod.MuxRegistry(buckets=(1, 8), budget=budget,
                          build=lambda v: _FakeEngine(v.generation),
                          batcher_kwargs={"max_latency": 0.0, "default_timeout": 2.0})
    reg.add("inc", bundle_path="/i", weight=0.9)
    reg.add("can", bundle_path="/c", weight=0.0)
    return reg


HEALTH_SCRIPTS = {
    "completes": [True] * 12,
    "holds_then_completes": [True, None, None, True, True, None, True, True, True, True, True],
    "rolls_back": [True, True, True, None, False, True, True],
}


@pytest.mark.parametrize("script", sorted(HEALTH_SCRIPTS))
def test_ramp_state_sequence_equals_jax(script):
    runs = []
    for mod in (pt_mux, jax_mux):
        reg = _fake_registry(mod)
        health = iter(HEALTH_SCRIPTS[script])
        ramp = mod.RampController(reg, "can", stages=(0.01, 0.1, 0.5, 1.0), hold_ticks=2,
                                  health=lambda: next(health))
        ramp.start()
        seq = [(ramp.state, reg.splitter.weights())]
        for _ in HEALTH_SCRIPTS[script]:
            seq.append((ramp.tick(), reg.splitter.weights()))
        seq.append((ramp.rollbacks, ramp.snapshot()))
        runs.append(seq)
        reg.close()
    assert runs[0] == runs[1]
    states = [s for s, _ in runs[0][1:-1]]
    assert states[-1] == ("rolled_back" if script == "rolls_back" else "complete")


def test_health_from_tracker_matches_jax():
    clock = {"t": 100.0}
    out = []
    for slo_mod, mux_mod in ((pt_slo, pt_mux), (jax_slo, jax_mux)):
        tracker = slo_mod.SLOTracker(slo_mod.SLOConfig(fast_window_s=10.0, slow_window_s=60.0),
                                     clock=lambda: clock["t"], metric_prefix="mux", labels={"model": "c"})
        health = mux_mod.health_from_tracker(tracker)
        seq = [health()]
        for ok in [True] * 20 + [False] * 20:
            tracker.record(ok, 0.01 if ok else None)
            seq.append(health())
        out.append(seq)
    assert out[0] == out[1] and None in out[0] and True in out[0] and False in out[0]


# -- a mux over real tiny bundles, both packages ----------------------------------

def _tiny_jax_bundle(directory, generation):
    """A tiny fp32 bundle (dense generator and classifier with tanh), written
    by the JAX serializer."""
    os.makedirs(directory, exist_ok=True)
    g = JaxBuilder(JaxConfig(seed=1))
    g.add_inputs("z").set_input_types(JaxInputType.feed_forward(Z))
    g.add_layer("g_dense_1", JaxDense(n_out=8, activation="tanh"), "z")
    g.add_layer("g_out", JaxOutput(n_out=FEAT, activation="sigmoid", loss="xent"), "g_dense_1")
    g.set_outputs("g_out")
    gen = g.build()
    c = JaxBuilder(JaxConfig(seed=2))
    c.add_inputs("x").set_input_types(JaxInputType.feed_forward(FEAT))
    c.add_layer("feat_1", JaxDense(n_out=HIDDEN, activation="tanh"), "x")
    c.add_layer("cv_out", JaxOutput(n_out=CLASSES, activation="softmax", loss="mcxent"), "feat_1")
    c.set_outputs("cv_out")
    cv = c.build()
    jax_ser.write_model(os.path.join(directory, "gen.zip"), gen, gen.init(), save_updater=False)
    jax_ser.write_model(os.path.join(directory, "cv.zip"), cv, cv.init(), save_updater=False)
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump({"format_version": 1, "generator": "gen.zip", "classifier": "cv.zip",
                   "feature_vertex": "feat_1", "generation": generation, "step": 0}, fh)
    return directory


def _code_step(bundle):
    """What one moved activation code can change a quantized output by: max
    over the int8 classifier's layers of 127·max(w_scale)·act_scale."""
    graph, params, _, _ = pt_ser.read_model(os.path.join(bundle, "cv.zip"), device="cpu")
    return max(127.0 * float(params[v.name]["w_scale"].max()) * v.layer.act_scale
               for v in graph.vertices if isinstance(v.layer, QuantDenseLayer))


@pytest.fixture(scope="module")
def variants(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mux_variants")
    fp32 = _tiny_jax_bundle(str(tmp / "fp32"), generation=0)
    int8 = str(tmp / "int8")
    rows = np.random.default_rng(1).random((32, FEAT), dtype=np.float32)
    build_int8_variant(fp32, int8, calibration_rows=rows, device="cpu")
    return {"fp32": fp32, "int8": int8}


WEIGHTS = {"fp32": 0.6, "int8": 0.4}
COSTS = {"fp32": 2.0, "int8": 1.0}


def _mux_service(mod, variants, **registry_kwargs):
    reg = mod.MuxRegistry(buckets=(1, 8), budget=3,
                          batcher_kwargs={"max_latency": 0.0, "default_timeout": 10.0},
                          **registry_kwargs)
    for name in ("fp32", "int8"):
        reg.add(name, bundle_path=variants[name], cost=COSTS[name], weight=WEIGHTS[name])
    return mod.MuxService(reg)


@pytest.fixture(scope="module")
def both_services(variants):
    previous = set_registry(MetricsRegistry())
    pt = _mux_service(pt_mux, variants, device="cpu")
    jx = _mux_service(jax_mux, variants)
    yield pt, jx
    pt.close()
    jx.close()
    set_registry(previous)


def test_both_muxes_route_each_key_alike_and_serve_agreeing_rows(both_services, variants):
    pt, jx = both_services
    rng = np.random.default_rng(3)
    step = _code_step(variants["int8"])
    seen = set()
    for i in range(60):
        kind = ("sample", "classify", "features")[i % 3]
        width = Z if kind == "sample" else FEAT
        rows = rng.random((1 + i % 5, width), dtype=np.float32)
        payload = {"data": rows.tolist(), "key": f"session-{i}"}
        code_p, body_p = pt.handle("POST", f"/v1/{kind}", payload)
        code_j, body_j = jx.handle("POST", f"/v1/{kind}", payload)
        assert code_p == code_j == 200, (body_p, body_j)
        assert body_p["model"] == body_j["model"] == pt.registry.splitter.assign(f"session-{i}")
        got, want = np.asarray(body_p["data"]), np.asarray(body_j["data"])
        assert got.shape == want.shape == (rows.shape[0], {"sample": FEAT, "classify": CLASSES,
                                                           "features": HIDDEN}[kind])
        model = body_p["model"]
        seen.add(model)
        atol = FP32_TOL if model == "fp32" or kind == "sample" else 2.0 * step + FP32_TOL
        assert float(np.max(np.abs(got - want))) <= atol, (model, kind)
        # and the variant's own engine, unbatched
        own = pt.registry.engine_for(model).run_host(kind, rows)
        np.testing.assert_allclose(got, own, rtol=0, atol=FP32_TOL)
    assert seen == {"fp32", "int8"}


def test_brownout_shed_order_and_health_keys_match_jax(both_services):
    pt, jx = both_services
    for level in (0, 1, 2, 0):
        assert pt.set_brownout(level) == jx.set_brownout(level)
        assert pt._shed_set() == jx._shed_set()
    pt.set_brownout(1)
    jx.set_brownout(1)
    assert pt._shed_set() == {"fp32"}  # the costliest sheds first
    code, body = pt.handle("POST", "/v1/sample", {"data": [[0.1] * Z], "model": "fp32"})
    assert code == 503 and body["model"] == "fp32" and "brownout" in body["error"]
    pt.set_brownout(0)
    jx.set_brownout(0)
    for path in ("/healthz", "/mux/status"):
        (cp, hp), (cj, hj) = pt.handle("GET", path), jx.handle("GET", path)
        assert cp == cj == 200 and set(hp) == set(hj)
        assert hp["primary"] == hj["primary"] == "fp32"
    mp, mj = pt.metrics(), jx.metrics()
    assert set(mp) == set(mj) and set(mp["mux"]) == set(mj["mux"])
    assert set(mp["mux"]["registry"]) == set(mj["mux"]["registry"])
    assert set(mp["mux"]["registry"]["variants"]["int8"]) == set(mj["mux"]["registry"]["variants"]["int8"])
    assert mp["mux"]["costs"] == mj["mux"]["costs"]


def test_the_shared_staging_pool_serves_every_variant(variants):
    pool = pt_mux.SharedStagingPool()
    svc = _mux_service(pt_mux, variants, device="cpu", staging_pool=pool)
    try:
        assert pool.pin is torch.cuda.is_available()
        rng = np.random.default_rng(9)
        for i in range(40):
            rows = rng.random((3, FEAT), dtype=np.float32)
            code, _ = svc.handle("POST", "/v1/classify", {"data": rows.tolist(), "key": f"k{i}"})
            assert code == 200
        stats = pool.stats()
        # both variants stage (bucket 8, width 6) rows: a handful of
        # buffers serve forty flushes across them
        assert 1 <= stats["allocated_total"] <= 4 and stats["keys"] == 1
        assert svc.registry.snapshot()["staging_pool"] == stats
    finally:
        svc.close()


def test_demote_then_ensure_resident_rewarms_the_variant(variants):
    svc = _mux_service(pt_mux, variants, device="cpu")
    reg = svc.registry
    try:
        rows = np.random.default_rng(2).random((2, FEAT), dtype=np.float32)
        before = reg.engine_for("int8").run_host("classify", rows)
        assert reg.demote("int8") and reg.variant("int8").state == "cold"
        code, body = svc.handle("POST", "/v1/classify", {"data": rows.tolist(), "model": "int8"})
        assert code == 503 and "not resident" in body["error"]
        reg.ensure_resident("int8")
        engine = reg.engine_for("int8")
        assert engine.warmed and engine.serve_compile_counts == {k: 0 for k in engine.kinds}
        code, body = svc.handle("POST", "/v1/classify", {"data": rows.tolist(), "model": "int8"})
        assert code == 200
        np.testing.assert_array_equal(np.asarray(body["data"], np.float32), before)
        assert [e["event"] for e in reg.events][-2:] == ["demote", "warm"]
    finally:
        svc.close()


def test_the_http_front_end_serves_the_mux(variants):
    svc = _mux_service(pt_mux, variants, device="cpu")
    server = make_server(svc, port=0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        req = urllib.request.Request(f"{base}/v1/classify",
                                     data=json.dumps({"data": [[0.2] * FEAT], "key": "u1"}).encode(),
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=30) as r:
            body = json.loads(r.read())
        assert body["status"] == "ok" and body["model"] == svc.registry.splitter.assign("u1")
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as r:
            assert json.loads(r.read())["status"] == "ok"
        with urllib.request.urlopen(f"{base}/metrics?format=prom", timeout=30) as r:
            assert b"mux_requests_total" in r.read()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
        svc.close()
    assert not thread.is_alive()
