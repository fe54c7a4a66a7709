"""PyTorch port, serving path: the engine's staged path against its host
oracle, the bucket ladder's first-run ledger, JAX-published bundles served
by the port against the JAX engine and graphs, the HTTP wire contract, the
no-fallback device rule, and the no-jax import rule.

Engine tests run on the CPU (``device="cpu"``) over tiny dense graphs, as
``tests/test_serving.py`` does for the JAX engine; one test serves the
full-width DCGAN-MNIST bundle. Port-vs-JAX tolerance: 1e-5 (float32 on the
CPU on both sides).
"""

import json
import os
import re
import subprocess
import sys
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.models import dcgan_mnist as jax_models
from gan_deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from gan_deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as pt_models
from gan_deeplearning4j_tpu_torch.nn import DenseLayer, GraphBuilder, GraphConfig, InputType, OutputLayer
from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine, make_server
from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry
from gan_deeplearning4j_tpu_torch.utils import write_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = dict(rtol=1e-5, atol=1e-5)
Z, FEAT, CLASSES, HIDDEN = 4, 6, 3, 5


@pytest.fixture(autouse=True)
def _port_registry():
    """A fresh port metrics registry per test (tests/conftest.py resets only
    the JAX package's)."""
    previous = set_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_registry(previous)


def tiny_generator():
    b = GraphBuilder(GraphConfig(seed=1))
    b.add_inputs("z").set_input_types(InputType.feed_forward(Z))
    b.add_layer("g_dense_1", DenseLayer(n_out=8), "z")
    b.add_layer("g_out", OutputLayer(n_out=FEAT, activation="sigmoid", loss="xent"), "g_dense_1")
    b.set_outputs("g_out")
    return b.build()


def tiny_classifier():
    b = GraphBuilder(GraphConfig(seed=2))
    b.add_inputs("x").set_input_types(InputType.feed_forward(FEAT))
    b.add_layer("feat_1", DenseLayer(n_out=HIDDEN), "x")
    b.add_layer("cv_out", OutputLayer(n_out=CLASSES, activation="softmax", loss="mcxent"), "feat_1")
    b.set_outputs("cv_out")
    return b.build()


def _random_tree(shapes, seed):
    """Xavier-scaled weights, small biases, BatchNorm gains/variances in
    [0.5, 1.5], drawn with numpy."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, leaves in shapes.items():
        out[layer] = {}
        for name, shape in leaves.items():
            if name == "W":
                fan_in = int(np.prod(shape[:-1]))
                v = rng.standard_normal(shape) * np.sqrt(2.0 / (fan_in + shape[-1]))
            elif name in ("gamma", "var"):
                v = rng.uniform(0.5, 1.5, shape)
            else:
                v = rng.standard_normal(shape) * 0.1
            out[layer][name] = v.astype(np.float32)
    return out


def _write_bundle(directory, gen, gen_tree, cv, cv_tree, feature_vertex, **extra):
    """A serving bundle as the JAX package publishes it, written by the JAX
    serializer."""
    os.makedirs(directory, exist_ok=True)
    jax_ser.write_model(os.path.join(directory, "gen.zip"), gen, gen_tree, save_updater=False)
    jax_ser.write_model(os.path.join(directory, "cv.zip"), cv, cv_tree, save_updater=False)
    manifest = {"format_version": 1, "family": "mnist", "generator": "gen.zip",
                "classifier": "cv.zip", "feature_vertex": feature_vertex,
                "generation": None, **extra}
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump(manifest, fh)
    return directory


@pytest.fixture(scope="module")
def tiny_bundle(tmp_path_factory):
    gen, cv = tiny_generator(), tiny_classifier()
    jax_gen = JaxGraph.from_dict(json.loads(json.dumps(gen.to_dict())))
    jax_cv = JaxGraph.from_dict(json.loads(json.dumps(cv.to_dict())))
    return _write_bundle(str(tmp_path_factory.mktemp("tiny") / "bundle"),
                         jax_gen, _random_tree(gen.param_shapes(), 1),
                         jax_cv, _random_tree(cv.param_shapes(), 2), "feat_1")


@pytest.fixture
def engine(tmp_path):
    gen, cv = tiny_generator(), tiny_classifier()
    write_model(str(tmp_path / "gen.zip"), gen, gen.init(device="cpu"))
    write_model(str(tmp_path / "cv.zip"), cv, cv.init(device="cpu"))
    eng = ServingEngine.from_checkpoints(
        generator=str(tmp_path / "gen.zip"), classifier=str(tmp_path / "cv.zip"),
        buckets=(1, 4, 8), feature_vertex="feat_1", device="cpu",
    )
    eng.warmup()
    return eng


@pytest.mark.parametrize("kind", ["sample", "classify", "features"])
def test_run_equals_run_host_bit_for_bit(engine, kind):
    rng = np.random.default_rng(0)
    width = engine.input_width(kind)
    for n in (1, 3, 4, 6, 16, 21):
        rows = rng.standard_normal((n, width)).astype(np.float32)
        out = engine.run(kind, rows)
        assert out.shape[0] == n
        np.testing.assert_array_equal(out, engine.run_host(kind, rows))


def test_first_runs_are_bounded_by_the_ladder(engine):
    assert engine.compile_counts == {k: 3 for k in engine.kinds}
    assert engine.expected_max_compiles == 3
    for n in (1, 2, 3, 5, 7, 8, 4, 6, 20):
        engine.run("sample", np.zeros((n, Z), np.float32))
        engine.run("features", np.zeros((n, FEAT), np.float32))
    assert engine.compile_counts == {k: 3 for k in engine.kinds}
    assert engine.serve_compile_counts == {k: 0 for k in engine.kinds}
    stats = engine.stats()
    assert stats["warmup"] == "warm" and stats["replica_in_flight"] == [0]
    assert stats["padded_rows_wasted"]["sample"] > 0


def test_cold_engine_counts_serve_time_first_runs(tmp_path):
    gen = tiny_generator()
    write_model(str(tmp_path / "gen.zip"), gen, gen.init(device="cpu"))
    eng = ServingEngine.from_checkpoints(generator=str(tmp_path / "gen.zip"), buckets=(2,), device="cpu")
    eng.run("sample", np.zeros((1, Z), np.float32))
    assert eng.compile_counts == {"sample": 1} and eng.serve_compile_counts == {"sample": 0}
    eng.warmup()
    assert eng.compile_counts == {"sample": 1}


def test_dispatch_finalize_coalesces_riders(engine):
    a = np.random.default_rng(1).standard_normal((3, FEAT)).astype(np.float32)
    b = np.random.default_rng(2).standard_normal((2, FEAT)).astype(np.float32)
    flight = engine.dispatch("classify", [a, b])
    assert engine.in_flight == 1
    out = engine.finalize(flight)
    assert engine.in_flight == 0
    np.testing.assert_array_equal(out, engine.run_host("classify", np.concatenate([a, b])))
    with pytest.raises(ValueError, match="expected"):
        engine.run("classify", np.zeros((2, FEAT + 1), np.float32))
    with pytest.raises(KeyError, match="unknown request kind"):
        engine.run("bogus", np.zeros((2, FEAT), np.float32))


def test_port_engine_matches_jax_engine_on_a_jax_bundle(tiny_bundle):
    port = ServingEngine.from_bundle(tiny_bundle, buckets=(1, 8), device="cpu")
    ref = JaxEngine.from_bundle(tiny_bundle, buckets=(1, 8))
    port.warmup()
    ref.warmup()
    assert set(port.kinds) == set(ref.kinds) == {"sample", "classify", "features"}
    rng = np.random.default_rng(5)
    for kind in port.kinds:
        for n in (1, 5, 11):
            rows = rng.standard_normal((n, port.input_width(kind))).astype(np.float32)
            np.testing.assert_allclose(port.run(kind, rows), ref.run(kind, rows), **TOL)


def test_full_width_dcgan_bundle_serves_like_the_jax_graphs(tmp_path):
    jax_gen = jax_models.build_generator()
    jax_dis = jax_models.build_discriminator()
    jax_cv, _ = jax_models.build_transfer_classifier(jax_dis, jax_dis.init())
    pt_dis = pt_models.build_discriminator()
    pt_cv, _ = pt_models.build_transfer_classifier(pt_dis, pt_dis.init(device="cpu"))
    gen_tree = _random_tree(pt_models.build_generator().param_shapes(), 7)
    cv_tree = _random_tree(pt_cv.param_shapes(), 8)
    bundle = _write_bundle(str(tmp_path / "b"), jax_gen, gen_tree, jax_cv, cv_tree,
                           "dis_dense_layer_6", z_size=2, num_features=784, num_classes=10)
    eng = ServingEngine.from_bundle(bundle, buckets=(4,), device="cpu")
    rng = np.random.default_rng(9)
    z = rng.standard_normal((3, 2)).astype(np.float32)
    x = rng.random((3, 784), dtype=np.float32)
    sample = eng.run("sample", z)
    assert sample.shape == (3, 784)
    np.testing.assert_allclose(sample, np.asarray(jax_gen.output(gen_tree, z)).reshape(3, -1), **TOL)
    probs = eng.run("classify", x)
    np.testing.assert_allclose(probs, np.asarray(jax_cv.output(cv_tree, x)), **TOL)
    np.testing.assert_allclose(probs.sum(-1), 1.0, atol=1e-5)
    np.testing.assert_allclose(
        eng.run("features", x), np.asarray(jax_cv.feed_forward(cv_tree, x)["dis_dense_layer_6"]), **TOL)


@pytest.mark.parametrize("extra,ok", [
    ({"precision": "bf16"}, True),
    ({"precision": "int8"}, True),
    ({"zoo": {"conditioning": "class", "num_classes": 3, "z_size": 1}}, True),
    ({"zoo": {"conditioning": "none", "dataset": "mnist"}}, True),
    ({"ladder": {"buckets": [2, 16]}}, True),
    ({"precision": "fp16"}, True),
])
def test_bundles_this_slice_refuses_or_loads(tmp_path, tiny_bundle, extra, ok):
    """Each bundle loads in the port as it loads in the JAX engine, or is
    refused naming its ROADMAP item. A loaded one serves every kind as the
    JAX engine does, within the file's tolerance, and reports the same
    precision: a precision the engines do not know ("fp16") is recorded and
    served in fp32, as the reference serves it. A conditional zoo block
    (z 1 + 3 classes = the generator's 4 inputs) makes both engines
    conditional with the same latent widths."""
    directory = str(tmp_path / "b")
    os.makedirs(directory)
    for name in ("gen.zip", "cv.zip"):
        with open(os.path.join(tiny_bundle, name), "rb") as src, open(os.path.join(directory, name), "wb") as dst:
            dst.write(src.read())
    with open(os.path.join(tiny_bundle, "serving.json")) as fh:
        manifest = {**json.load(fh), **extra}
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump(manifest, fh)
    if not ok:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            ServingEngine.from_bundle(directory, device="cpu")
        return
    eng = ServingEngine.from_bundle(directory, device="cpu")
    ref = JaxEngine.from_bundle(directory)
    assert eng.buckets == tuple(extra.get("ladder", {}).get("buckets", (1, 8, 32, 128)))
    assert eng.stats()["precision"] == ref.stats()["precision"] == extra.get("precision", "fp32")
    # it serves: an fp32-leaved bundle computes in fp32 whatever it declares
    # (the JAX engine's rule; int8 variants are tests/test_torch_quant.py's)
    probs = eng.run("classify", np.random.default_rng(3).random((3, FEAT), dtype=np.float32))
    assert probs.shape == (3, CLASSES) and np.allclose(probs.sum(-1), 1.0, atol=1e-5)
    assert set(eng.kinds) == set(ref.kinds) == {"sample", "classify", "features"}
    assert (eng.conditional, eng.class_count) == (ref.conditional, ref.class_count)
    assert eng.conditional == (extra.get("zoo", {}).get("conditioning") == "class")
    assert all(eng.latent_width(k) == ref.latent_width(k) for k in eng.kinds)
    rng = np.random.default_rng(4)
    for kind in eng.kinds:
        rows = rng.standard_normal((5, eng.input_width(kind))).astype(np.float32)
        np.testing.assert_allclose(eng.run(kind, rows), ref.run(kind, rows), **TOL)


def test_more_than_one_replica_is_refused(engine):
    with pytest.raises(ValueError, match="ROADMAP"):
        ServingEngine({"generator": (tiny_generator(), tiny_generator().init(device="cpu"))},
                      replicas=2, device="cpu")


def test_default_device_is_the_card_with_no_fallback(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device resolves to it")
    gen = tiny_generator()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gen.init()
    write_model(str(tmp_path / "gen.zip"), gen, gen.init(device="cpu"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine.from_checkpoints(generator=str(tmp_path / "gen.zip"))


def _http(base, path, payload=None):
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(base + path, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=10) as r:
            raw = r.read()
            code = r.status
    except urllib.error.HTTPError as err:
        raw, code = err.read(), err.code
    try:
        return code, json.loads(raw)
    except ValueError:
        return code, raw.decode()


def test_http_round_trip_and_error_contract(engine):
    svc = InferenceService(engine, warmup=False, max_latency=0.002)
    server = make_server(svc, port=0)
    base = f"http://127.0.0.1:{server.server_address[1]}"
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    try:
        code, body = _http(base, "/healthz")
        assert code == 200 and body["status"] == "ok" and body["platform"] == "cpu"
        results = {}

        def client(i):
            kind = ("sample", "classify", "features")[i % 3]
            width = Z if kind == "sample" else FEAT
            results[i] = (kind, _http(base, f"/v1/{kind}", {"data": [[0.1 * i] * width] * (1 + i % 4)}))

        threads = [threading.Thread(target=client, args=(i,)) for i in range(12)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
        widths = {"sample": FEAT, "classify": CLASSES, "features": HIDDEN}
        for i, (kind, (code, body)) in results.items():
            assert code == 200 and body["status"] == "ok"
            assert np.asarray(body["data"]).shape == (1 + i % 4, widths[kind])
        assert _http(base, "/v1/bogus", {"data": [[0.0] * Z]})[0] == 404
        assert _http(base, "/nope")[0] == 404
        assert _http(base, "/v1/sample", {})[0] == 400
        assert _http(base, "/v1/sample", {"data": [[0.0] * (Z + 1)]})[0] == 400
        assert _http(base, "/v1/sample", {"data": [[0.0] * Z], "timeout": "x"})[0] == 400
        code, body = _http(base, "/v1/sample?class=1", {"data": [[0.0] * Z]})
        assert code == 400 and "unconditional" in body["error"]
        assert _http(base, "/v1/classify?class=1", {"data": [[0.0] * FEAT]})[0] == 400
        code, metrics = _http(base, "/metrics")
        assert code == 200 and sum(metrics["completed"].values()) == 12
        assert metrics["engine"]["serve_compile_counts"] == {k: 0 for k in engine.kinds}
        code, prom = _http(base, "/metrics?format=prom")
        assert code == 200 and "serve_requests_total" in prom
        assert _http(base, "/debug/spans")[0] == 200
    finally:
        server.shutdown()
        server.server_close()
        svc.close()


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys\n"
        "import gan_deeplearning4j_tpu_torch.serving\n"
        "import gan_deeplearning4j_tpu_torch.serving.__main__\n"
        "import gan_deeplearning4j_tpu_torch.models\n"
        "import gan_deeplearning4j_tpu_torch.__main__\n"
        "import gan_deeplearning4j_tpu_torch.harness\n"
        "import gan_deeplearning4j_tpu_torch.harness.wgan_experiment\n"
        "import gan_deeplearning4j_tpu_torch.models.dcgan_image\n"
        "import gan_deeplearning4j_tpu_torch.models.mlp_gan\n"
        "import gan_deeplearning4j_tpu_torch.models.wgan_gp\n"
        "import gan_deeplearning4j_tpu_torch.data\n"
        "import gan_deeplearning4j_tpu_torch.eval\n"
        "import gan_deeplearning4j_tpu_torch.optim\n"
        "import gan_deeplearning4j_tpu_torch.parallel\n"
        "import gan_deeplearning4j_tpu_torch.zoo\n"
        "import gan_deeplearning4j_tpu_torch.zoo.drill\n"
        "import gan_deeplearning4j_tpu_torch.quant\n"
        "import gan_deeplearning4j_tpu_torch.quant.bench\n"
        "import gan_deeplearning4j_tpu_torch.deploy\n"
        "import gan_deeplearning4j_tpu_torch.eval.fid\n"
        "import gan_deeplearning4j_tpu_torch.eval.quality\n"
        "import gan_deeplearning4j_tpu_torch.ops._native\n"
        "import gan_deeplearning4j_tpu_torch.serving.mux\n"
        "import gan_deeplearning4j_tpu_torch.serving.mux.splitter\n"
        "import gan_deeplearning4j_tpu_torch.serving.mux.registry\n"
        "import gan_deeplearning4j_tpu_torch.serving.mux.ramp\n"
        "import gan_deeplearning4j_tpu_torch.serving.mux.service\n"
        "import gan_deeplearning4j_tpu_torch.serving.ladder\n"
        "import gan_deeplearning4j_tpu_torch.deploy.watcher\n"
        "import gan_deeplearning4j_tpu_torch.deploy.reloader\n"
        "import gan_deeplearning4j_tpu_torch.deploy.__main__\n"
        "import gan_deeplearning4j_tpu_torch.resilience\n"
        "import gan_deeplearning4j_tpu_torch.resilience.store\n"
        "import gan_deeplearning4j_tpu_torch.telemetry.slo\n"
        "import gan_deeplearning4j_tpu_torch.telemetry.device\n"
        "import gan_deeplearning4j_tpu_torch.runtime.capture\n"
        "import gan_deeplearning4j_tpu_torch.runtime.environment\n"
        "import gan_deeplearning4j_tpu_torch.parallel.collectives\n"
        "import gan_deeplearning4j_tpu_torch.parallel.param_averaging\n"
        "import gan_deeplearning4j_tpu_torch.parallel.update_sharding\n"
        "import gan_deeplearning4j_tpu_torch.parallel.launch\n"
        "import gan_deeplearning4j_tpu_torch.parallel.drill\n"
        "import gan_deeplearning4j_tpu_torch.runtime.threefry\n"
        "import gan_deeplearning4j_tpu_torch.runtime.prng\n"
        "import gan_deeplearning4j_tpu_torch.runtime.factory\n"
        "import gan_deeplearning4j_tpu_torch.eval.quality_run\n"
        "import gan_deeplearning4j_tpu_torch as port\n"
        "port.factory\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "       or m == 'gan_deeplearning4j_tpu' or m.startswith('gan_deeplearning4j_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_port_sources_never_import_jax_or_the_jax_package():
    pattern = re.compile(
        r"^\s*(import jax|from jax|import gan_deeplearning4j_tpu[.\s]|"
        r"from gan_deeplearning4j_tpu[.\s]|from gan_deeplearning4j_tpu import|"
        r"import scripts|from scripts)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "gan_deeplearning4j_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    offenders = [f for f in files if pattern.search(open(f).read())]
    assert not offenders
