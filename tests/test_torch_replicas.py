"""PyTorch port, serving across replicas: the engine's replica set, least-
loaded routing, completion lanes, the bulk lane and the release of every
reservation on failure, on the CPU.

The JAX tests run replicas on XLA's forced host devices (``tests/
conftest.py``: eight CPU "devices" in one process); the port's counterpart
is an explicit device pool in which a device repeats: ``devices=("cpu",
"cpu"), replicas=2`` (``runtime/device.py::resolve_devices``). Each JAX
multi-replica test of ``tests/test_serving.py`` is ported here, and the
port at two replicas is held against the JAX engine at ``replicas=2`` on
the same JAX-written bundle within 1e-5 (float32 on the CPU on both sides),
as ``tests/test_torch_serving.py`` holds one replica. The reload plane's
swap and the mux registry run at two replicas too.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from gan_deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu_torch.deploy import ReloadController, StoreWatcher
from gan_deeplearning4j_tpu_torch.nn import DenseLayer, GraphBuilder, GraphConfig, InputType, OutputLayer
from gan_deeplearning4j_tpu_torch.quant import measure_bundle_cost
from gan_deeplearning4j_tpu_torch.resilience import store as pt_store
from gan_deeplearning4j_tpu_torch.runtime.device import resolve_devices
from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine
from gan_deeplearning4j_tpu_torch.serving.mux import MuxRegistry
from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, get_registry, set_registry

TOL = dict(rtol=1e-5, atol=1e-5)
Z, FEAT, CLASSES, HIDDEN = 4, 6, 3, 5
TWO = dict(replicas=2, devices=("cpu", "cpu"))
#: the JAX parity sizes at buckets (1, 4): 16 is one top × 2 bulk slab
SIZES = (1, 3, 4, 6, 16, 21)


@pytest.fixture(autouse=True)
def _port_registry():
    """A fresh port metrics registry per test (tests/conftest.py resets only
    the JAX package's)."""
    previous = set_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_registry(previous)


def _graphs():
    g = GraphBuilder(GraphConfig(seed=1))
    g.add_inputs("z").set_input_types(InputType.feed_forward(Z))
    g.add_layer("g_dense_1", DenseLayer(n_out=8, activation="tanh"), "z")
    g.add_layer("g_out", OutputLayer(n_out=FEAT, activation="sigmoid", loss="xent"), "g_dense_1")
    g.set_outputs("g_out")
    c = GraphBuilder(GraphConfig(seed=2))
    c.add_inputs("x").set_input_types(InputType.feed_forward(FEAT))
    c.add_layer("feat_1", DenseLayer(n_out=HIDDEN, activation="tanh"), "x")
    c.add_layer("cv_out", OutputLayer(n_out=CLASSES, activation="softmax", loss="mcxent"), "feat_1")
    c.set_outputs("cv_out")
    return g.build(), c.build()


def _write_bundle(directory, seed, number=None):
    """A gen + cv serving bundle written by the JAX serializer, params drawn
    with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    os.makedirs(directory, exist_ok=True)
    for name, graph in zip(("gen.zip", "cv.zip"), _graphs()):
        tree = {layer: {leaf: (rng.standard_normal(shape) * 0.8).astype(np.float32)
                        for leaf, shape in leaves.items()}
                for layer, leaves in graph.param_shapes().items()}
        jax_ser.write_model(os.path.join(directory, name), JaxGraph.from_dict(graph.to_dict()), tree,
                            save_updater=False)
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump({"format_version": 1, "generator": "gen.zip", "classifier": "cv.zip",
                   "feature_vertex": "feat_1", "generation": number, "step": 0}, fh)
    return directory


@pytest.fixture(scope="module")
def bundle(tmp_path_factory):
    return _write_bundle(str(tmp_path_factory.mktemp("replicas") / "bundle"), 1)


def _engine(bundle, buckets=(1, 8), **kw):
    return ServingEngine.from_bundle(bundle, buckets=buckets, **{**TWO, **kw})


def _rows(kind, n, rng):
    return rng.random((n, Z if kind == "sample" else FEAT), dtype=np.float32)


# -- the device pool ----------------------------------------------------------------

@pytest.mark.parametrize("kwargs,want", [
    (dict(device="cpu"), ("cpu",)),
    (dict(device="cpu", replicas="all"), ("cpu",)),
    (dict(device="cpu", replicas=None), ("cpu",)),
    (dict(devices=("cpu", "cpu")), ("cpu",)),
    (dict(devices=("cpu", "cpu"), replicas=2), ("cpu", "cpu")),
    (dict(devices=("cpu", "cpu", "cpu"), replicas="all"), ("cpu",) * 3),
])
def test_resolve_devices_takes_the_first_replicas_of_the_pool(kwargs, want):
    assert resolve_devices(**kwargs) == tuple(torch.device(d) for d in want)


@pytest.mark.parametrize("kwargs,available", [
    (dict(device="cpu", replicas=2), 1),
    (dict(devices=("cpu", "cpu"), replicas=3), 2),
    (dict(devices=("cpu", "cpu"), replicas=0), 2),
])
def test_replicas_beyond_the_devices_are_rejected_with_the_jax_message(bundle, kwargs, available):
    replicas = kwargs["replicas"]
    message = rf"^replicas={replicas} but {available} local device\(s\) are available$"
    with pytest.raises(ValueError, match=message):
        resolve_devices(**kwargs)
    with pytest.raises(ValueError, match=message):
        ServingEngine.from_bundle(bundle, buckets=(1,), **kwargs)


def test_a_replica_pool_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for kwargs in (dict(), dict(replicas="all"), dict(devices=("cuda:0", "cuda:0"), replicas=2)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_devices(**kwargs)


def test_each_replica_holds_its_params_on_its_device(bundle):
    """On a repeated device ``Tensor.to`` returns the tensor itself: the
    replicas share their (read-only) params, and the resident bytes stay
    one replica's."""
    eng = _engine(bundle)
    one = ServingEngine.from_bundle(bundle, buckets=(1, 8), device="cpu")
    assert eng.devices == (torch.device("cpu"),) * 2 and eng.replica_count == 2
    for rep, dev in zip(eng._replicas, eng.devices):
        leaves = [t for p in rep.params.values() for lv in p.values() for t in lv.values()]
        assert leaves and all(t.device == dev for t in leaves)
    first, second = (rep.params["classifier"]["feat_1"]["W"] for rep in eng._replicas)
    assert first is second
    assert eng.resident_param_bytes() == one.resident_param_bytes()
    assert eng.default_pipeline_depth == 2 * one.default_pipeline_depth == 2


# -- the JAX engine's multi-replica tests, ported -------------------------------

def test_multi_replica_routing_and_parity(bundle):
    """Results stay bit-identical to the host path, dispatches spread over
    both replicas, first runs stay within the ladder per (kind, replica),
    and none happens after warmup."""
    eng = _engine(bundle)
    assert eng.replica_count == 2
    eng.warmup()
    rng = np.random.default_rng(10)
    for i in range(8):
        rows = rng.random((1 + i % 6, FEAT), dtype=np.float32)
        np.testing.assert_array_equal(eng.run("classify", rows), eng.run_host("classify", rows))
    stats = eng.stats()
    assert sum(stats["replica_dispatches"]) == 8
    assert all(d > 0 for d in stats["replica_dispatches"])
    assert stats["compiled_per_replica"] == [len(eng.buckets) * len(eng.kinds)] * 2
    assert eng.compile_counts == {k: eng.expected_max_compiles for k in eng.kinds}
    assert eng.serve_compile_counts == {k: 0 for k in eng.kinds}
    children = get_registry().snapshot()["serve_engine_dispatches_total"]
    assert {c["labels"]["replica"]: c["value"] for c in children["series"]} == {"0": 4.0, "1": 4.0}


def test_flight_lane_follows_the_routed_replica(bundle):
    """Two back-to-back flights take both replicas, each lane the replica
    of its chunk; a replica freed first is the least loaded next."""
    eng = _engine(bundle)
    eng.warmup()
    rows = np.zeros((1, Z), np.float32)
    f1 = eng.dispatch("sample", [rows])
    f2 = eng.dispatch("sample", [rows])
    assert {f1.lane, f2.lane} == {0, 1}
    for f in (f1, f2):
        assert f.lane == f.parts[0][4]
    assert eng.stats()["replica_in_flight"] == [1, 1] and eng.in_flight == 2
    eng.finalize(f1)
    f3 = eng.dispatch("sample", [rows])
    assert f3.lane == f1.lane  # least loaded beats round-robin
    for f in (f2, f3):
        eng.finalize(f)
    assert eng.stats()["replica_in_flight"] == [0, 0]


def test_bulk_lane_splits_oversized_batches_across_replicas(bundle):
    """A slab of top × replicas rows from one rider runs on every replica's
    top bucket at once, reserving none, capturing nothing, and still equals
    the host path bit for bit."""
    eng = _engine(bundle, buckets=(1, 4))
    eng.warmup()
    before = eng.compile_counts
    rows = np.random.default_rng(11).random((10, FEAT), dtype=np.float32)  # 8-slab + 2 tail
    flight = eng.dispatch("classify", [rows])
    assert [p[4] for p in flight.parts][:2] == [None, None] and flight.parts[2][4] is not None
    assert flight.lane == flight.parts[2][4]
    assert eng.stats()["replica_in_flight"] == [1 if r == flight.lane else 0 for r in range(2)]
    np.testing.assert_array_equal(eng.finalize(flight), eng.run_host("classify", rows))
    slab = eng.dispatch("classify", [rows[:8]])
    assert slab.lane == 0 and [p[4] for p in slab.parts] == [None, None]
    np.testing.assert_array_equal(eng.finalize(slab), eng.run_host("classify", rows[:8]))
    assert eng.compile_counts == before
    assert eng.serve_compile_counts == {k: 0 for k in eng.kinds}
    assert sum(eng.stats()["replica_dispatches"]) == 1  # the tail alone
    # two riders of 4: a slab spans riders, so it is chunked, not bulk
    two = eng.dispatch("classify", [rows[:4], rows[4:8]])
    assert all(p[4] is not None for p in two.parts)
    np.testing.assert_array_equal(eng.finalize(two), eng.run_host("classify", rows[:8]))


@pytest.mark.parametrize("replicas,n,fail_at", [
    (1, 6, 2),   # the JAX test: chunk 2 of 4 + 2 fails
    (2, 6, 2),   # two chunks on two replicas
    (2, 10, 3),  # the bulk slab's two parts, then the tail fails
    (2, 10, 2),  # the slab's second replica fails
])
def test_failed_chunk_releases_all_replica_reservations(bundle, replicas, n, fail_at):
    """A multi-chunk dispatch that dies on a later chunk undoes EVERY
    chunk's reservation and returns every staging buffer, or least-loaded
    routing counts phantom load forever."""
    eng = ServingEngine.from_bundle(bundle, buckets=(1, 4), replicas=replicas,
                                    devices=("cpu",) * replicas)
    eng.warmup()
    real = eng._launch
    calls = {"n": 0}

    def flaky(kind, bucket, buf, replica):
        calls["n"] += 1
        if calls["n"] >= fail_at:
            raise RuntimeError("chunk boom")
        return real(kind, bucket, buf, replica)

    eng._launch = flaky
    try:
        with pytest.raises(RuntimeError, match="chunk boom"):
            eng.dispatch("classify", [np.zeros((n, FEAT), np.float32)])
    finally:
        eng._launch = real
    assert eng.stats()["replica_in_flight"] == [0] * replicas and eng.in_flight == 0
    assert sum(len(pool) for pool in eng._staging.values()) == fail_at
    rows = np.random.default_rng(12).random((n, FEAT), dtype=np.float32)
    np.testing.assert_array_equal(eng.run("classify", rows), eng.run_host("classify", rows))


def test_eager_warmup_two_replicas_twenty_mixed_requests(bundle):
    """Engine on two devices, eager background warmup, 20 mixed-kind
    requests from four threads: zero lost, no capture after warmup, the
    batcher's depth one per replica on the CPU (two on the card), and
    /healthz and /metrics report both replicas."""
    eng = _engine(bundle)
    svc = InferenceService(eng, warmup="eager", max_latency=0.002, default_timeout=30.0)
    try:
        assert eng.wait_warm(120.0)
        assert svc.batcher.pipeline_depth == eng.default_pipeline_depth == 2
        statuses, lock = [], threading.Lock()

        def client(widx):
            rng = np.random.default_rng(100 + widx)
            for _ in range(5):
                kind = eng.kinds[rng.integers(len(eng.kinds))]
                res = svc.batcher.submit(kind, _rows(kind, int(rng.integers(1, 9)), rng))
                with lock:
                    statuses.append(res)

        threads = [threading.Thread(target=client, args=(w,)) for w in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert len(statuses) == 20
        assert all(r.ok for r in statuses), [(r.status, r.error) for r in statuses if not r.ok]
        assert eng.serve_compile_counts == {k: 0 for k in eng.kinds}
        stats = eng.stats()
        assert sum(stats["replica_dispatches"]) >= 1 and stats["replica_in_flight"] == [0, 0]
        assert stats["compiled_per_replica"] == [len(eng.buckets) * len(eng.kinds)] * 2
        code, health = svc.handle("GET", "/healthz")
        assert code == 200 and health["status"] == "ok" and health["replicas"] == 2
        metrics = svc.metrics()["engine"]
        assert metrics["replicas"] == 2 and len(metrics["replica_dispatches"]) == 2
    finally:
        svc.close()


# -- against the JAX engine at replicas=2 ----------------------------------------------

@pytest.fixture(scope="module")
def jax_two(bundle):
    ref = JaxEngine.from_bundle(bundle, buckets=(1, 4), replicas=2)
    ref.warmup()
    return ref


@pytest.mark.parametrize("kind", ["sample", "classify", "features"])
def test_two_replicas_match_the_jax_engine_at_two_replicas(bundle, jax_two, kind):
    """Every size through chunks, the 16-row bulk slab and a slab plus a
    tail, within 1e-5 of the JAX engine's replicas on the forced host
    devices; the port's staged path equals its host path bit for bit."""
    eng = _engine(bundle, buckets=(1, 4))
    eng.warmup()
    rng = np.random.default_rng(5)
    for n in SIZES:
        rows = _rows(kind, n, rng)
        out = eng.run(kind, rows)
        assert out.shape[0] == n
        np.testing.assert_allclose(out, jax_two.run(kind, rows), **TOL)
        np.testing.assert_array_equal(out, eng.run_host(kind, rows))


def test_stats_and_routing_agree_with_the_jax_engine(bundle):
    """One fixed sequence of single-threaded dispatches routes alike in both
    engines; the port's stats carry the JAX keys; its first-run ledger is
    the JAX one less the bulk executable per kind."""
    eng = _engine(bundle, buckets=(1, 4))
    ref = JaxEngine.from_bundle(bundle, buckets=(1, 4), replicas=2)
    eng.warmup()
    ref.warmup()
    rng = np.random.default_rng(6)
    for kind in ("sample", "classify", "features", "classify"):
        for n in SIZES:
            rows = _rows(kind, n, rng)
            for engine in (eng, ref):
                engine.finalize(engine.dispatch(kind, [rows]))
    mine, theirs = eng.stats(), ref.stats()
    assert set(theirs) <= set(mine)
    for key in ("replicas", "replica_dispatches", "replica_in_flight", "buckets", "padded_rows_wasted",
                "serve_compile_counts", "warmup", "precision", "generation"):
        assert mine[key] == theirs[key], key
    assert mine["replica_dispatches"] == [14, 14]  # 7 routed chunks a kind; slabs route none
    assert eng.expected_max_compiles == ref.expected_max_compiles - 1 == 4
    assert mine["compile_counts"] == {k: c - 1 for k, c in theirs["compile_counts"].items()}
    assert mine["compiled_per_replica"] == theirs["compiled_per_replica"] == [6, 6]


# -- the planes around the engine at two replicas ----------------------------------------

def test_a_reload_swap_at_two_replicas_keeps_the_device_tuple(tmp_path):
    """A singleton swap under four clients: zero non-ok, the candidate built
    on the live engine's device tuple (not a re-resolution of its count and
    first device), and no capture after its warmup."""
    store = pt_store.CheckpointStore(str(tmp_path / "store"), keep_last=10)
    g0 = store.publish(lambda d: _write_bundle(d, 1, number=0), step=1, extra={"kind": "serving"})
    live = _engine(g0.path)
    service = InferenceService(live, warmup="sync", max_latency=0.001, default_timeout=20.0)
    controller = ReloadController(service, StoreWatcher(store=store))
    service.attach_reloader(controller)
    stop, results = threading.Event(), []

    def client(i):
        rng = np.random.default_rng(i)
        while not stop.is_set():
            kind = ("sample", "classify")[len(results) % 2]
            results.append(service.batcher.submit(kind, _rows(kind, 1 + i, rng)))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(4)]
    try:
        for t in threads:
            t.start()
        g1 = store.publish(lambda d: _write_bundle(d, 2, number=1), step=2, extra={"kind": "serving"})
        status = controller.poll_now(wait=True)
        before = len(results)
        while len(results) < before + 20:
            service.batcher.submit("sample", np.zeros((1, Z), np.float32))
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert status["swaps"] == 1 and status["rejected"] == 0
        assert results and not [r for r in results if not r.ok]
        engine = service.engine
        assert engine is not live and engine.generation == g1.number
        assert engine.devices == live.devices and engine.replica_count == 2
        assert engine.serve_compile_counts == {k: 0 for k in engine.kinds}
        assert engine.stats()["compiled_per_replica"] == [len(engine.buckets) * 3] * 2
    finally:
        stop.set()
        service.close()


def test_a_mux_registry_at_two_replicas(bundle, tmp_path):
    """The registry builds every variant on its device pool: two replicas
    each, both routed, one shared staging pool; the cost block reports the
    replicas it was measured on."""
    other = _write_bundle(str(tmp_path / "other"), 3)
    registry = MuxRegistry(buckets=(1, 4), budget=2, **TWO,
                           batcher_kwargs={"max_latency": 0.001, "default_timeout": 20.0})
    try:
        registry.add("a", bundle_path=bundle, weight=0.5)
        registry.add("b", bundle_path=other, weight=0.5)
        rng = np.random.default_rng(7)
        for i in range(24):
            name, batcher = registry.route(f"key-{i}")
            rows = _rows("classify", 1 + i % 3, rng)
            res = batcher.submit("classify", rows)
            assert res.ok
            np.testing.assert_array_equal(res.data, registry.engine_for(name).run_host("classify", rows))
        for name in ("a", "b"):
            engine = registry.engine_for(name)
            assert engine.devices == (torch.device("cpu"),) * 2
            assert engine._shared_staging is registry.pool
        dispatches = [registry.engine_for(n).stats()["replica_dispatches"] for n in ("a", "b")]
        assert all(d > 0 for per in dispatches for d in per), dispatches
        assert registry.snapshot()["replicas"] == 2
    finally:
        registry.close()
    block = measure_bundle_cost(bundle, buckets=(1, 4), rounds=1, write=False, **TWO)
    assert block["replicas"] == 2 and block["platform"] == "cpu"


def test_the_serving_cli_refuses_more_replicas_than_devices(bundle):
    """``--replicas`` parses an int; a count above the host's devices fails
    at engine construction with the JAX engine's message."""
    from gan_deeplearning4j_tpu_torch.serving.__main__ import main

    with pytest.raises(ValueError, match=r"^replicas=2 but 1 local device\(s\) are available$"):
        main(["--bundle", bundle, "--device", "cpu", "--replicas", "2", "--port", "0"])
