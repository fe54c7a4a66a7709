"""The port's hand-written CUDA kernels against their plain PyTorch
versions, and the training iteration captured as a CUDA graph against the
same device body run eagerly, on the card. Every test here is marked
``cuda`` and skips where no NVIDIA GPU is present (a CUDA kernel has no CPU
mode, nor has a CUDA graph). This file imports neither jax nor the JAX
package, so it runs on a machine with the card and without jax:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels_cuda.py

(``--noconftest``: ``tests/conftest.py`` sets up jax for the other tests.)
The kernels build at first use (``gan_deeplearning4j_tpu_torch/ops/_native.py``).
"""

import os

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment
from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states
from gan_deeplearning4j_tpu_torch.ops import linear


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode")
    # before the first cuBLAS handle (the trainer sets the same)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    return torch.device("cuda")


def _operands(rng, card, k, m):
    w_q = torch.from_numpy(rng.integers(-127, 128, (k, m)).astype(np.int8)).to(card)
    w_scale = torch.from_numpy((rng.random(m) * 0.01 + 1e-3).astype(np.float32)).to(card)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(card)
    return w_q, w_scale, b


def _rows(rng, n, k, a):
    """Rows uniform over ±1.3·127·a (past the clip) whose first 20 values
    lie on half codes."""
    x = rng.uniform(-1.3, 1.3, (n, k)).astype(np.float32) * np.float32(127 * a)
    x[:, : min(k, 20)] = ((np.arange(min(k, 20)) - 10 + 0.5) * a).astype(np.float32)
    return x


def _launch_once(x, w_q, w_scale, b, a):
    before = linear.KERNEL_LAUNCHES["quant_dense"]
    y = linear.quant_dense(x, w_q, w_scale, b, a)
    assert linear.KERNEL_LAUNCHES["quant_dense"] == before + 1
    return y


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", [(1152, 1024), (1024, 10), (6, 5), (37, 12), (1000, 48), (1001, 20)])
def test_quant_dense_kernel_equals_its_plain_version(card, k, m):
    """Bit-equal at the int8 bundle's shapes and ragged ones, through both
    load routes (TMA where out is a multiple of 16, else one bulk copy),
    with K-chunks that are not multiples of 32 (1000, 1001: the last chunk
    is ragged; 1001 also lands x without bulk copies) and n past one row
    tile (130, 257), on rows holding half codes and values past the clip;
    the launch count rises by one per call."""
    rng = np.random.default_rng(k * 1000 + m)
    a = 0.021
    w_q, w_scale, b = _operands(rng, card, k, m)
    assert linear.quant_dense_plan(1, k, m).route == ("tma" if m % 16 == 0 else "bulk")
    for n in (1, 3, 8, 21, 32, 128, 130, 257):
        x = torch.from_numpy(_rows(rng, n, k, a)).to(card)
        for bias in (b, None):
            y = _launch_once(x, w_q, w_scale, bias, a)
            assert torch.equal(y, linear.quant_dense_plain(x, w_q, w_scale, bias, a)), (n, bias is None)


@pytest.mark.cuda
def test_quant_dense_kernel_sums_exactly_across_the_cluster(card):
    """All-±127 codes and weights at K = 1152: |acc| reaches 127 · 127 · 1152
    = 18,580,608 > 2^24, split over 8 CTAs of a cluster; any lossy step of
    the cross-CTA reduction shows."""
    k, m, a = 1152, 1024, 0.01
    rng = np.random.default_rng(3)
    signs = np.where(rng.random((k, m)) < 0.5, -1, 1)
    signs[:, :4] = 1
    signs[:, 4:8] = -1
    w_q = torch.from_numpy((127 * signs).astype(np.int8)).to(card)
    w_scale = torch.full((m,), 3e-4, device=card)
    b = torch.from_numpy(rng.standard_normal(m).astype(np.float32)).to(card)
    for n in (1, 130):
        x = np.full((n, k), 2.0 * 127 * a, np.float32)  # past the clip: code +127
        x[1::2] *= -1.0
        x = torch.from_numpy(x).to(card)
        y = _launch_once(x, w_q, w_scale, b, a)
        plain = linear.quant_dense_plain(x, w_q, w_scale, b, a)
        assert torch.equal(y, plain)
        acc = torch.matmul(linear.quantize_activations(x, a).double(), w_q.double())
        assert float(acc.abs().max()) == 127 * 127 * k


@pytest.mark.cuda
def test_quant_dense_kernel_takes_x_at_any_alignment(card):
    """x as a contiguous view whose storage is 4 bytes past a 16-byte
    boundary: the kernel loads it without bulk copies, to the same bits."""
    k, m, a = 1152, 1024, 0.021
    rng = np.random.default_rng(5)
    w_q, w_scale, b = _operands(rng, card, k, m)
    for n in (1, 21, 130):
        flat = torch.empty(n * k + 1, device=card)
        x = flat[1:].view(n, k)
        x.copy_(torch.from_numpy(_rows(rng, n, k, a)))
        assert x.is_contiguous() and x.data_ptr() % 16 == 4
        y = _launch_once(x, w_q, w_scale, b, a)
        assert torch.equal(y, linear.quant_dense_plain(x, w_q, w_scale, b, a))


@pytest.mark.cuda
def test_quant_dense_kernel_refuses_views_it_would_misread(card):
    """A non-contiguous W_q view, and a contiguous one off the 16-byte
    alignment the kernel's copies need, raise and launch nothing."""
    rng = np.random.default_rng(6)
    w_q, w_scale, b = _operands(rng, card, 64, 32)
    x = torch.zeros((2, 64), device=card)
    before = linear.KERNEL_LAUNCHES["quant_dense"]
    with pytest.raises(ValueError, match="contiguous"):
        linear.quant_dense(x, w_q.t().contiguous().t(), w_scale, b, 0.1)
    flat = torch.zeros(64 * 32 + 1, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="16-byte aligned"):
        linear.quant_dense(x, flat[1:].view(64, 32), w_scale, b, 0.1)
    assert linear.KERNEL_LAUNCHES["quant_dense"] == before


@pytest.mark.cuda
def test_quant_dense_kernel_refuses_other_dtypes(card):
    x = torch.zeros((2, 8), dtype=torch.bfloat16, device=card)
    w_q = torch.zeros((8, 4), dtype=torch.int8, device=card)
    w_scale = torch.ones(4, device=card)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        linear.quant_dense(x, w_q, w_scale, None, 0.1)


# -- the training iteration as CUDA-graph replays ------------------------------------

#: reduced widths (MNIST at the reference's), batch 16
TRAIN_SHAPES = {
    "mnist": dict(model_family="mnist"),
    "tabular": dict(model_family="tabular", num_features=32, z_size=8),
    "cifar10": dict(model_family="cifar10", height=8, width=8, channels=3, num_features=192),
    "wgan_gp": dict(model_family="wgan_gp", height=8, width=8, channels=3, num_features=192,
                    z_size=4, n_critic=2),
}


def _train_experiment(family, **dtypes):
    return make_experiment(ExperimentConfig(**TRAIN_SHAPES[family], batch_size_train=16,
                                            latent_grid=2, save_models=False, **dtypes))


def _eager_iterations(exp, x, y):
    """The device body applied straight to the trees, uncaptured."""
    rows = []
    for k in range(x.shape[0]):
        inputs = {"features": torch.from_numpy(x[k]).to(exp.device),
                  "draws": exp._window_draws(1, x.shape[1])[0]}
        if exp.cv is not None or exp._cond_classes:
            inputs["labels"] = torch.from_numpy(y[k]).to(exp.device)
        trees, row = exp._body(exp._trees(), inputs)
        exp._set_trees(trees)
        rows.append(row)
    return torch.stack(rows)


def _assert_same_states(a, b):
    fa, fb = flatten_states(a.digest_states()), flatten_states(b.digest_states())
    assert sorted(fa) == sorted(fb)
    for key, value in fa.items():
        if isinstance(value, torch.Tensor):
            assert value.dtype == fb[key].dtype and torch.equal(value, fb[key]), key
        else:
            assert value == fb[key], key


@pytest.mark.cuda
@pytest.mark.parametrize("family,dtypes", [
    ("mnist", {}), ("mnist", {"compute_dtype": "bf16"}), ("mnist", {"param_dtype": "bf16"}),
    ("tabular", {}), ("cifar10", {}), ("wgan_gp", {}), ("wgan_gp", {"compute_dtype": "bf16"}),
    ("wgan_gp", {"param_dtype": "bf16"}),
    ("mnist", {"conditioning": "class"}), ("cifar10", {"conditioning": "class"}),
])
def test_a_captured_window_equals_the_eager_body_and_captures_each_key_once(card, family, dtypes):
    """Two windows of 4 iterations (WGAN-GP rounds, the gradient penalty's
    double backward inside the graph) as graph replays, against the device
    body applied eagerly from the same init and draws: every leaf, dtype,
    step counter and loss bit-equal. Each key is captured once; the second
    window captures nothing. A class-conditional run reads its one-hot from
    the window's labels, which differ between the windows: a one-hot frozen
    at capture would show in the second."""
    captured, eager = _train_experiment(family, **dtypes), _train_experiment(family, **dtypes)
    assert captured.graphs.captured
    x = captured.family.synthetic_data(8 * 16, captured.model_cfg, 3).reshape(2, 4, 16, -1)
    y = np.eye(10, dtype=np.float32)[np.arange(8 * 16) % 10].reshape(2, 4, 16, 10)
    for w in range(2):
        rows = captured.train_iterations(x[w], y[w])
        want = _eager_iterations(eager, x[w], y[w])
        got = torch.stack([rows["d_loss"], rows["g_loss"], rows["cv_loss"]], dim=1)
        assert torch.equal(got.nan_to_num(7.0), want.nan_to_num(7.0))
        _assert_same_states(captured, eager)
        if w == 0:
            counts = dict(captured.graphs.capture_counts)
            assert counts and set(counts.values()) == {1}
    assert captured.graphs.capture_counts == counts


@pytest.mark.cuda
@pytest.mark.parametrize("overrides", [{}, {"update_sharding": True}])
def test_an_nccl_world_one_pmean_window_equals_the_eager_body(card, tmp_path, overrides):
    """Per-step gradient sync on an NCCL mesh of one rank: two windows of 4
    MNIST iterations as graph replays, the NCCL all-reduces of the
    gradients and of BatchNorm's statistics inside the graph, against the
    same distributed body run eagerly from the same init and draws: every
    leaf and loss bit-equal, each key captured once."""
    import torch.distributed as dist

    from gan_deeplearning4j_tpu_torch.runtime.environment import initialize_distributed, make_mesh

    initialize_distributed(rank=0, world_size=1, init_file=str(tmp_path / "store"), backend="nccl")
    try:
        _nccl_window_case(make_mesh(), overrides)
    finally:
        dist.destroy_process_group()


def _nccl_window_case(mesh, overrides):
    assert mesh.backend == "nccl" and mesh.capturable

    def experiment():
        return make_experiment(ExperimentConfig(batch_size_train=16, save_models=False,
                                                distributed="pmean", **overrides), mesh=mesh)

    captured, eager = experiment(), experiment()
    eager.graphs.captured = False
    assert captured.graphs.captured
    x = captured.family.synthetic_data(8 * 16, captured.model_cfg, 3).reshape(2, 4, 16, -1)
    y = np.eye(10, dtype=np.float32)[np.arange(8 * 16) % 10].reshape(2, 4, 16, 10)
    for w in range(2):
        a, b = captured.train_iterations(x[w], y[w]), eager.train_iterations(x[w], y[w])
        for key in ("d_loss", "g_loss", "cv_loss"):
            assert torch.equal(a[key], b[key]), key
        _assert_same_states(captured, eager)
        if w == 0:
            counts = dict(captured.graphs.capture_counts)
            assert counts and set(counts.values()) == {1}
    assert captured.graphs.capture_counts == counts


# -- serving: one captured graph per (kind, bucket) ----------------------------------

def _serving_engine(precision, warm=True):
    """The full-width DCGAN-MNIST ``gen`` and ``cv`` (seed 666) served on the
    card; ``precision="int8"`` quantizes the classifier's dense layers
    (``quant_dense`` inside the graphs), calibrated on seeded rows."""
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist
    from gan_deeplearning4j_tpu_torch.quant.variants import quantize_classifier
    from gan_deeplearning4j_tpu_torch.serving import ServingEngine

    gen, dis = dcgan_mnist.build_generator(), dcgan_mnist.build_discriminator()
    cv, cv_params = dcgan_mnist.build_transfer_classifier(dis, dis.init(seed=666, device="cpu"))
    if precision == "int8":
        rows = torch.from_numpy(np.random.default_rng(1).random((64, 784), dtype=np.float32))
        cv, cv_params, _ = quantize_classifier(cv, cv_params, rows)
    engine = ServingEngine({"generator": (gen, gen.init(seed=666, device="cpu")), "classifier": (cv, cv_params)},
                           feature_vertex="dis_dense_layer_6", precision=precision, device="cuda",
                           export_gauge=False)
    if warm:
        engine.warmup()
    return engine


@pytest.mark.cuda
@pytest.mark.parametrize("precision", [None, "int8"])
def test_concurrent_dispatch_replays_bit_equal_to_run_host(card, precision):
    """8 threads dispatch and finalize at once, every kind and n in 1-130
    (130 spans two chunks): every answer equals ``run_host`` (the eager
    forward on the default stream) bit for bit, and nothing is captured
    after warmup. The H2D, replay and D2H of one flight are enqueued under
    the engine's lock; a flight that read another's rows would show."""
    import threading

    engine = _serving_engine(precision)
    assert engine.compile_counts == {k: len(engine.buckets) for k in engine.kinds}
    rng = np.random.default_rng(5)
    cases = []
    for i in range(48):
        kind = engine.kinds[i % 3]
        n = (1, 3, 8, 21, 130, 32)[i % 6]
        rows = rng.random((n, engine.input_width(kind)), dtype=np.float32)
        if kind == "sample":
            rows = rows * 4.0 - 2.0
        cases.append((kind, rows, engine.run_host(kind, rows)))
    before = engine.kernel_launches().get("quant_dense", 0)
    errors, barrier = [], threading.Barrier(8)

    def worker(t):
        barrier.wait(timeout=60)
        for kind, rows, want in cases[t::8] * 3:
            got = engine.finalize(engine.dispatch(kind, [rows]))
            if not np.array_equal(got, want):
                errors.append((kind, rows.shape[0]))

    threads = [threading.Thread(target=worker, args=(t,)) for t in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads) and not errors, errors[:5]
    assert engine.serve_compile_counts == {k: 0 for k in engine.kinds}
    if precision == "int8":
        # replays launch quant_dense where no wrapper call counts it: two
        # quantized layers per classifier graph
        launched = engine.kernel_launches()["quant_dense"] - before
        chunks = sum(3 * -(-rows.shape[0] // 128) for kind, rows, _ in cases if kind != "sample")
        assert launched == 2 * chunks
        assert {g["launches_per_replay"].get("quant_dense", 0)
                for key, g in engine.graph_stats().items() if not key.startswith("sample")} == {2}


@pytest.mark.cuda
def test_a_capture_during_background_warmup_while_run_host_runs(card):
    """A background warmup captures every (kind, bucket) while another
    thread runs ``run_host`` (eager, default stream) and a second engine
    replays: captures run in ``"thread_local"`` mode under the process-wide
    lock, so the other threads' work neither enters nor breaks them."""
    import threading

    serving = _serving_engine(None)
    engine = _serving_engine(None, warm=False)
    rows = np.random.default_rng(2).random((21, 784), dtype=np.float32)
    want = serving.run_host("classify", rows)
    stop, errors = threading.Event(), []

    def busy():
        while not stop.is_set():
            if not np.array_equal(engine.run_host("classify", rows), want):
                errors.append("run_host")
            if not np.array_equal(serving.run("classify", rows), want):
                errors.append("replay")

    t = threading.Thread(target=busy)
    t.start()
    try:
        engine.warmup(background=True)
        assert engine.wait_warm(timeout=300)
    finally:
        stop.set()
        t.join(timeout=120)
    assert not t.is_alive() and not errors and not engine.warm_failed
    assert engine.compile_counts == {k: len(engine.buckets) for k in engine.kinds}
    for kind in engine.kinds:
        x = np.random.default_rng(3).random((130, engine.input_width(kind)), dtype=np.float32)
        assert np.array_equal(engine.run(kind, x), engine.run_host(kind, x))
    assert engine.serve_compile_counts == {k: 0 for k in engine.kinds}
    stats = engine.stats()
    assert stats["captured"] and stats["graph_pool_bytes"] > 0
    engine.close()
    assert engine.graph_stats() == {}


@pytest.mark.cuda
def test_sample_by_class_replays_the_captured_graphs_and_captures_nothing(card):
    """A conditional bundle's ``sample?class=k`` for every class, through
    the service: the one-hot rides the padded bucket, so the engine captures
    one graph per (kind, bucket) in warmup and none after, and every answer
    equals ``run_host`` on the latent + one-hot rows bit for bit."""
    from gan_deeplearning4j_tpu_torch.models import dcgan_mnist
    from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine
    from gan_deeplearning4j_tpu_torch.zoo import ScenarioManifest

    scenario = ScenarioManifest(conditioning="class", num_classes=10, z_size=2)
    gen = dcgan_mnist.build_generator(dcgan_mnist.DcganConfig(z_size=scenario.sample_input_width))
    engine = ServingEngine({"generator": (gen, gen.init(seed=666, device="cpu"))},
                           scenario=scenario.to_dict(), device="cuda", export_gauge=False)
    engine.warmup()
    captures = dict(engine.compile_counts)
    assert captures == {"sample": len(engine.buckets)}
    service = InferenceService(engine, warmup=False)
    rng = np.random.default_rng(4)
    try:
        for k in range(10):
            for n in (1, 3, 21, 130):
                z = rng.random((n, 2), dtype=np.float32) * 2 - 1
                status, body = service.handle("POST", f"/v1/sample?class={k}", {"data": z.tolist()})
                assert status == 200, body
                onehot = np.zeros((n, 10), dtype=np.float32)
                onehot[:, k] = 1.0
                want = engine.run_host("sample", np.concatenate([z, onehot], axis=1))
                assert np.array_equal(np.asarray(body["data"], dtype=np.float32), want)
    finally:
        service.close()
    assert engine.compile_counts == captures
    assert engine.serve_compile_counts == {"sample": 0}
    engine.close()
