"""PyTorch port, the reload plane (``resilience/store.py``,
``deploy/{watcher,reloader}.py``) and the service's admin and trace routes,
on the CPU:

- a checkpoint store the JAX package writes reads in the port, and one the
  port writes reads in the JAX package (verification, quarantine, the
  watcher's walk), and ``tree_digest`` digests one tree alike in both;
- a singleton swap and a mux-mode adoption, each under 4 client threads,
  with zero non-ok results, the new engine equal to a fresh engine of its
  bundle;
- a canary rejection (the real ``CanaryGate``: a classifier whose logits
  are negated loses its accuracy) quarantines the generation;
- ``/admin/reload`` answers 409 with no reloader and 202 / 200 with one;
  ``/admin/drain`` reports ``draining``; ``/debug/trace?block=1`` writes a
  ``torch.profiler`` trace.

Engines run with ``device="cpu"``. Cycles run synchronously through
``poll_now`` (no controller thread), so no test sleeps for a swap.
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.resilience import store as jax_store
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu_torch.deploy import CanaryGate, CanaryThresholds, ReloadController, StoreWatcher
from gan_deeplearning4j_tpu_torch.nn import DenseLayer, GraphBuilder, GraphConfig, InputType, OutputLayer
from gan_deeplearning4j_tpu_torch.parallel.trainer import TrainState
from gan_deeplearning4j_tpu_torch.resilience import store as pt_store
from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine
from gan_deeplearning4j_tpu_torch.serving.mux import MuxRegistry
from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry
from gan_deeplearning4j_tpu_torch.utils import write_model

Z, FEAT, CLASSES, HIDDEN = 4, 6, 3, 5
BUCKETS = (1, 8)
CLIENTS = 4


@pytest.fixture(autouse=True)
def _port_registry():
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


def _tree(graph, seed):
    """Params drawn with numpy (seeded), as torch tensors."""
    rng = np.random.default_rng(seed)
    return {layer: {name: torch.from_numpy((rng.standard_normal(shape) * 0.8).astype(np.float32))
                    for name, shape in leaves.items()}
            for layer, leaves in graph.param_shapes().items()}


def _bundle_writer(seed, *, writer="port", poison=False, number=None):
    """``writer(directory)`` for ``store.publish``: a gen + cv bundle from
    ``seed``; ``poison`` negates the classifier's output layer."""
    gen, cv = _graphs()
    gen_tree, cv_tree = _tree(gen, seed), _tree(cv, seed + 100)
    if poison:
        cv_tree["cv_out"] = {k: -v for k, v in cv_tree["cv_out"].items()}

    def write(directory):
        if writer == "port":
            write_model(os.path.join(directory, "gen.zip"), gen, gen_tree, save_updater=False)
            write_model(os.path.join(directory, "cv.zip"), cv, cv_tree, save_updater=False)
        else:
            from gan_deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph

            for name, graph, tree in (("gen.zip", gen, gen_tree), ("cv.zip", cv, cv_tree)):
                jax_ser.write_model(os.path.join(directory, name), JaxGraph.from_dict(graph.to_dict()),
                                    {k: {n: t.numpy() for n, t in v.items()} for k, v in tree.items()},
                                    save_updater=False)
        with open(os.path.join(directory, "serving.json"), "w") as fh:
            json.dump({"format_version": 1, "generator": "gen.zip", "classifier": "cv.zip",
                       "feature_vertex": "feat_1", "generation": number, "step": 0}, fh)
    return write


def _publish(store, seed, **kw):
    number = store.next_number()
    return store.publish(_bundle_writer(seed, number=number, **kw), step=seed,
                         extra={"kind": "serving"})


# -- the store, both ways -------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_store_either_package_writes_reads_in_the_other(tmp_path, writer):
    root = str(tmp_path / "store")
    w_mod, r_mod = (jax_store, pt_store) if writer == "jax" else (pt_store, jax_store)
    w = w_mod.CheckpointStore(root, keep_last=10)
    g0 = _publish(w, 1, writer=writer)
    g1 = _publish(w, 2, writer=writer)
    w.publish(lambda d: open(os.path.join(d, "model.zip"), "wb").write(b"weights" * 8), step=3,
              extra={"kind": "training"})
    r = r_mod.CheckpointStore(root, keep_last=10)
    assert r.published() == w.published() == [0, 1, 2]
    assert r.verify(g0.number) is None and r.verify(g1.number) is None
    assert r.load(g1.number).manifest == g1.manifest
    assert r.latest_valid().number == 2
    # a flipped byte: the reader quarantines; the writer's ledger sees it
    with open(os.path.join(g1.path, "cv.zip"), "r+b") as fh:
        fh.seek(40)
        byte = fh.read(1)
        fh.seek(40)
        fh.write(bytes([byte[0] ^ 0xFF]))
    watcher = StoreWatcher(store=pt_store.CheckpointStore(root, keep_last=10)) if writer == "jax" else None
    if watcher is not None:
        # the port's watcher: skips the training generation, quarantines
        # the corrupt one, offers generation 0
        cand = watcher.poll_once(current_generation=None)
        assert cand.generation == 0 and cand.manifest["kind"] == "serving"
    else:
        assert r.verify(g1.number) is not None
        r.quarantine(g1.number, "digest mismatch")
    assert w.quarantined() == [1] and w.entry(1)["status"] == "quarantined"
    assert w_mod.CheckpointStore(root).published() == [0, 2]
    # the port's engine serves generation 0 of either store
    engine = ServingEngine.from_bundle(g0.path, buckets=BUCKETS, device="cpu")
    assert engine.generation == 0 and set(engine.kinds) == {"sample", "classify", "features"}


def test_tree_digest_is_the_same_in_both_packages():
    rng = np.random.default_rng(4)
    params = {"a": {"W": rng.standard_normal((3, 4)).astype(np.float32),
                    "b": rng.standard_normal(4).astype(np.float32)},
              "z": {"s": np.float32(2.5)}}
    bf16 = torch.from_numpy(rng.standard_normal((2, 5)).astype(np.float32)).to(torch.bfloat16)
    import ml_dtypes

    jax_params = dict(params, h={"W": bf16.view(torch.int16).numpy().view(ml_dtypes.bfloat16)})
    pt_params = {k: {n: torch.as_tensor(np.asarray(v)) for n, v in leaves.items()}
                 for k, leaves in params.items()}
    pt_params["h"] = {"W": bf16}
    assert pt_store.tree_digest(pt_params) == jax_store.tree_digest(jax_params)
    state = TrainState(pt_params, {"a": {"W": pt_params["a"]["W"] * 0}}, 7)
    jax_state = TrainState(jax_params, {"a": {"W": params["a"]["W"] * 0}}, 7)
    assert pt_store.tree_digest(state) == jax_store.tree_digest(jax_state)
    assert pt_store.tree_digest(state) != pt_store.tree_digest(TrainState(pt_params, state.opt_state, 8))


# -- swaps under load ---------------------------------------------------------------

class _Clients:
    """``CLIENTS`` closed-loop threads submitting ``sample`` and ``classify``
    until stopped; every result is kept."""

    def __init__(self, submit):
        self._submit = submit
        self.stop = threading.Event()
        self.results, self.started = [], threading.Barrier(CLIENTS + 1)
        self._threads = [threading.Thread(target=self._run, args=(i,)) for i in range(CLIENTS)]

    def _run(self, i):
        rng = np.random.default_rng(i)
        self.started.wait(timeout=30)
        while not self.stop.is_set():
            kind = ("sample", "classify")[len(self.results) % 2]
            rows = rng.random((1 + i, Z if kind == "sample" else FEAT), dtype=np.float32)
            self.results.append(self._submit(kind, rows))

    def __enter__(self):
        for t in self._threads:
            t.start()
        self.started.wait(timeout=30)
        return self

    def __exit__(self, *exc):
        self.stop.set()
        for t in self._threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in self._threads)


def _service(path):
    engine = ServingEngine.from_bundle(path, buckets=BUCKETS, device="cpu")
    return InferenceService(engine, warmup="sync", max_latency=0.001, default_timeout=20.0)


def test_a_singleton_swap_under_four_clients_loses_nothing(tmp_path):
    store = pt_store.CheckpointStore(str(tmp_path / "store"), keep_last=10)
    g0 = _publish(store, 1)
    service = _service(g0.path)
    controller = ReloadController(service, StoreWatcher(store=store))
    service.attach_reloader(controller)
    try:
        with _Clients(lambda kind, rows: service.batcher.submit(kind, rows)) as clients:
            g1 = _publish(store, 2)
            status = controller.poll_now(wait=True)
            before = len(clients.results)
            # keep the clients going until they have ridden the new engine
            while len(clients.results) < before + 20:
                service.batcher.submit("sample", np.zeros((1, Z), np.float32))
        assert status["swaps"] == 1 and status["rejected"] == 0
        bad = [r for r in clients.results if not r.ok]
        assert not bad and len(clients.results) > 20, bad[:3]
        engine = service.engine
        assert engine.generation == g1.number
        assert engine.serve_compile_counts == {k: 0 for k in engine.kinds}
        # the candidate was built on a ladder learned from the incumbent's traffic
        fresh = ServingEngine.from_bundle(g1.path, buckets=engine.buckets, device="cpu", export_gauge=False)
        rng = np.random.default_rng(8)
        for kind in engine.kinds:
            for n in (1, 3, 8, 21):
                rows = rng.random((n, engine.input_width(kind)), dtype=np.float32)
                # the CPU's matmul may round the last ulp apart between two
                # loads of one bundle (their buffers' alignment differs):
                # the JAX reload test's bound; chip_smoke.py (t) holds the
                # card's swap bit-equal
                np.testing.assert_allclose(service.batcher.submit(kind, rows).data,
                                           fresh.run_host(kind, rows), rtol=1e-6, atol=1e-7)
        assert service.healthz()["reload"]["swaps"] == 1
    finally:
        service.close()


def test_a_mux_mode_adoption_under_four_clients_loses_nothing(tmp_path):
    store = pt_store.CheckpointStore(str(tmp_path / "store"), keep_last=10)
    g0 = _publish(store, 1)
    registry = MuxRegistry(buckets=BUCKETS, budget=3, device="cpu",
                           batcher_kwargs={"max_latency": 0.001, "default_timeout": 20.0})
    registry.add("gen-0", bundle_path=g0.path, weight=1.0, generation=0)
    controller = ReloadController(None, StoreWatcher(store=store), registry=registry, adopt_weight=0.5)

    def submit(kind, rows):
        _, batcher = registry.route(f"key-{rows.shape[0]}-{float(rows[0, 0]):.6f}")
        return batcher.submit(kind, rows)

    try:
        with _Clients(submit) as clients:
            g1 = _publish(store, 2)
            status = controller.poll_now(wait=True)
            before = len(clients.results)
            while len(clients.results) < before + 20:
                registry.batcher_for("gen-0").submit("sample", np.zeros((1, Z), np.float32))
        assert status["adopted"] == 1 and status["rejected"] == 0
        assert not [r for r in clients.results if not r.ok]
        assert registry.resident_names() == ["gen-0", "gen-1"]
        adopted = registry.engine_for("gen-1")
        assert adopted.generation == g1.number
        assert adopted.serve_compile_counts == {k: 0 for k in adopted.kinds}
        fresh = ServingEngine.from_bundle(g1.path, buckets=BUCKETS, device="cpu", export_gauge=False)
        rows = np.random.default_rng(3).random((5, FEAT), dtype=np.float32)
        np.testing.assert_allclose(registry.batcher_for("gen-1").submit("classify", rows).data,
                                   fresh.run_host("classify", rows), rtol=1e-6, atol=1e-7)
    finally:
        registry.close()


def test_a_canary_rejection_quarantines_the_generation(tmp_path):
    store = pt_store.CheckpointStore(str(tmp_path / "store"), keep_last=10)
    g0 = _publish(store, 1)
    service = _service(g0.path)
    rows = np.random.default_rng(6).random((48, FEAT), dtype=np.float32)
    labels = np.argmax(service.engine.run_host("classify", rows), axis=1)
    gate = CanaryGate(rows, labels, num_samples=32, thresholds=CanaryThresholds(fid_slack=1e6))
    controller = ReloadController(service, StoreWatcher(store=store), canary=gate)
    service.attach_reloader(controller)
    try:
        g1 = _publish(store, 1, poison=True)
        status = controller.poll_now(wait=True)
        assert status["rejected"] == 1 and status["state"] == "rejected"
        assert service.engine.generation == g0.number
        entry = store.entry(g1.number)
        assert entry["status"] == "quarantined" and "accuracy" in entry["reason"]
        assert store.quarantined() == [g1.number]
        # never offered again; a good generation after it (the incumbent's
        # weights, republished) swaps in
        g2 = _publish(store, 1)
        assert controller.poll_now(wait=True)["swaps"] == 1
        assert service.engine.generation == g2.number
    finally:
        service.close()


# -- the admin and trace routes ----------------------------------------------------

def test_admin_reload_drain_and_debug_trace_routes(tmp_path):
    store = pt_store.CheckpointStore(str(tmp_path / "store"), keep_last=10)
    g0 = _publish(store, 1)
    service = _service(g0.path)
    service.artifacts_dir = str(tmp_path / "traces")
    try:
        code, body = service.handle("POST", "/admin/reload")
        assert code == 409 and "no reload plane" in body["error"]
        controller = ReloadController(service, StoreWatcher(store=store))
        service.attach_reloader(controller)
        code, body = service.handle("POST", "/admin/reload")
        assert code == 202 and body["reload"]["state"] == "idle"
        _publish(store, 2)
        code, body = service.handle("POST", "/admin/reload?block=1")
        assert code == 200 and body["reload"]["swaps"] == 1
        assert service.healthz()["reload"]["swaps"] == 1

        code, body = service.handle("POST", "/admin/drain")
        assert code == 200 and body["draining"] is True
        assert service.healthz()["status"] == "draining" and service.metrics()["draining"] is True
        assert service.sample(np.zeros((1, Z), np.float32)).ok  # drain sheds nothing
        code, body = service.handle("POST", "/admin/drain?off=1")
        assert body["draining"] is False and service.healthz()["status"] == "ok"

        assert service.handle("POST", "/debug/trace?ms=0")[0] == 400
        code, body = service.handle("POST", "/debug/trace?ms=50&block=1")
        assert code == 200 and body["artifact"].startswith(service.artifacts_dir)
        with open(os.path.join(body["artifact"], "trace.json")) as fh:
            trace = json.load(fh)
        assert isinstance(trace.get("traceEvents"), list)
    finally:
        service.close()


# -- the CLIs ------------------------------------------------------------------------

def test_the_serving_cli_takes_the_reload_canary_and_telemetry_flags(tmp_path, capsys):
    from gan_deeplearning4j_tpu_torch.serving.__main__ import _build_parser

    parser = _build_parser()
    args = parser.parse_args([
        "--reload-store", "s", "--reload-poll", "0.5", "--reload-wait", "3", "--replicas", "all",
        "--pipeline-depth", "3", "--telemetry", "--debug-artifacts", "t", "--canary-data", "c.npz",
        "--canary-samples", "64", "--canary-feature", "dis_features", "--canary-fid-ratio", "2",
        "--canary-fid-slack", "1", "--canary-acc-drop", "0.1", "--device", "cpu"])
    assert (args.reload_store, args.reload_poll, args.reload_wait, args.replicas) == ("s", 0.5, 3.0, "all")
    assert (args.pipeline_depth, args.telemetry, args.debug_artifacts) == (3, True, "t")
    assert (args.canary_samples, args.canary_feature, args.canary_fid_ratio,
            args.canary_fid_slack, args.canary_acc_drop) == (64, "dis_features", 2.0, 1.0, 0.1)
    assert parser.parse_args(["--replicas", "1"]).replicas == 1
    with pytest.raises(SystemExit):
        parser.parse_args(["--replicas", "2"])
    assert "'Serving, the rest'" in capsys.readouterr().err


def test_the_deploy_probe_cli_prints_one_probe(tmp_path, capsys):
    from gan_deeplearning4j_tpu_torch.deploy.__main__ import main

    store = pt_store.CheckpointStore(str(tmp_path / "store"))
    g0 = _publish(store, 1)
    rows = np.random.default_rng(2).random((24, FEAT), dtype=np.float32)
    np.savez(str(tmp_path / "probe.npz"), features=rows, labels=np.arange(24) % CLASSES)
    assert main(["probe", "--bundle", g0.path, "--data", str(tmp_path / "probe.npz"),
                 "--samples", "16", "--device", "cpu"]) == 0
    probe = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert probe["generation"] == 0 and probe["feature"] == "raw"
    assert np.isfinite(probe["fid"]) and 0.0 <= probe["accuracy"] <= 1.0
