"""PyTorch port, the device loop on the CPU: the device-resident and
prefetch iterators against the JAX package's, and the device body that a
CUDA graph replays on the card (``harness/graphs.py``), run here
uncaptured on the same static buffers.

What is held, and how:
- the iterators: batch values, shuffle orders, ``next_window`` sizes and
  slices (a misaligned cursor and the ragged tail included) and the
  epoch change on ``reset()`` equal the JAX iterators' on the same rows
  and seed, exactly;
- windows: K windowed iterations equal K ``train_iteration`` calls bit for
  bit, and K applications of the device body straight on the trees, with
  no static buffer (the eager iteration this slice replaced), bit for bit;
  the trees alias as after those eager iterations;
- returned losses are not overwritten by the next window; a state assigned
  from outside between calls is copied in;
- ``run()`` over ``DeviceResidentIterator(device="cpu")`` in windows of 4
  against the JAX package's sequential ``run()`` (windows of 1) with its z
  injected, at ``test_run_matches_jax_files_metrics_and_losses``'s
  tolerances;
- the CLI trains with ``--prefetch 2``.

Tiny widths as in ``tests/test_torch_families.py``; MNIST is at the
reference's width, batch 8.
"""

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data import ArrayDataSetIterator as JaxArrayIterator
from gan_deeplearning4j_tpu.data import DevicePrefetchIterator as JaxPrefetch
from gan_deeplearning4j_tpu.data import DeviceResidentIterator as JaxResident
from gan_deeplearning4j_tpu.data.dataset import DataSet as JaxDataSet
from gan_deeplearning4j_tpu.data.mnist import synthetic_mnist
from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
from gan_deeplearning4j_tpu.harness import GanExperiment as JaxExperiment
from gan_deeplearning4j_tpu_torch.__main__ import main as pt_main
from gan_deeplearning4j_tpu_torch.data import (
    ArrayDataSetIterator,
    DataSet,
    DevicePrefetchIterator,
    DeviceResidentIterator,
    one_hot_np,
)
from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment
from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states
from gan_deeplearning4j_tpu_torch.harness.graphs import CapturedIterations
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy, train_state_from_numpy
from tests.test_torch_train import ITER_LOSS_RTOL, FREE_LOSS_RTOL, jax_z_source

B = 8
SHAPES = {
    "mnist": dict(model_family="mnist"),
    "tabular": dict(model_family="tabular", num_features=32, z_size=8),
    "wgan_gp": dict(model_family="wgan_gp", height=8, width=8, channels=3, num_features=192,
                    z_size=4, n_critic=2),
}
# the cases of the window tests: (family, config overrides, entries). An
# entry is one source layout: init and the steady state where an iteration
# changes the trees' aliasing (mnist, tabular), one per Adam promotion
# under bf16 storage (params, then the generator's moments)
CASES = {
    "mnist_lr_decay": ("mnist", dict(dis_lr_decay_every=1, dis_lr_decay_rate=0.9), 2),
    "mnist_resampled_noise": ("mnist", dict(resample_label_noise=True), 2),
    "tabular": ("tabular", {}, 2),
    "wgan_gp": ("wgan_gp", {}, 1),
    "wgan_gp_bf16_storage": ("wgan_gp", dict(param_dtype="bf16"), 3),
}


def _experiment(family, **overrides):
    cfg = dict(SHAPES[family], batch_size_train=B, batch_size_pred=B, latent_grid=2,
               save_models=False, use_accelerator=False)
    cfg.update(overrides)
    return make_experiment(ExperimentConfig(**cfg))


def _data(exp, k, seed):
    """``k`` batches ``(k, B, F)`` of the family's rows and one-hot labels."""
    x = exp.family.synthetic_data(k * B, exp.model_cfg, seed).reshape(k, B, -1)
    y = np.eye(10, dtype=np.float32)[np.arange(k * B) % 10].reshape(k, B, 10)
    return x.astype(np.float32), y


def _assert_bit_equal(a_states, b_states):
    a, b = flatten_states(a_states), flatten_states(b_states)
    assert sorted(a) == sorted(b)
    for key in a:
        if isinstance(a[key], torch.Tensor):
            assert a[key].dtype == b[key].dtype and torch.equal(a[key], b[key]), key
        else:
            assert a[key] == b[key], key


def _alias_groups(exp):
    """The groups of ``flatten_states`` paths that hold one tensor."""
    by_id = {}
    for key, value in flatten_states(exp.digest_states()).items():
        if isinstance(value, torch.Tensor):
            by_id.setdefault(id(value), []).append(key)
    return sorted(tuple(g) for g in by_id.values() if len(g) > 1)


def _eager(exp, x, y):
    """The iterations as the eager loop ran them: the device body applied
    straight to the trees, no static buffer, no copy."""
    rows = []
    for k in range(x.shape[0]):
        inputs = {"features": torch.from_numpy(x[k]),
                  "draws": exp._window_draws(1, x.shape[1])[0]}
        if exp.cv is not None:
            inputs["labels"] = torch.from_numpy(y[k])
        trees, row = exp._body(exp._trees(), inputs)
        exp._set_trees(trees)
        rows.append(row)
    return torch.stack(rows)


# -- the iterators ----------------------------------------------------------------

def _rows(n=21, f=3, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, f), dtype=np.float32), np.eye(4, dtype=np.float32)[rng.integers(0, 4, n)]


def _same_batch(port, jax_batch):
    np.testing.assert_array_equal(port.features.numpy(), np.asarray(jax_batch.features))
    if jax_batch.labels is None:
        assert port.labels is None
    else:
        np.testing.assert_array_equal(port.labels.numpy(), np.asarray(jax_batch.labels))


@pytest.mark.parametrize("shuffle", [False, True])
@pytest.mark.parametrize("drop_remainder", [False, True])
def test_resident_iterator_serves_the_jax_iterators_batches_over_epochs(shuffle, drop_remainder):
    """Two epochs of ``next()`` (with ``reset()`` between, which draws the
    next epoch's order): the same rows in the same order as the JAX
    iterator's, the ragged tail included unless dropped."""
    x, y = _rows()
    kw = dict(batch_size=5, shuffle=shuffle, seed=11, drop_remainder=drop_remainder)
    port, ref = DeviceResidentIterator(x, y, device="cpu", **kw), JaxResident(x, y, **kw)
    assert port.features.device.type == "cpu"
    orders = []
    for _ in range(2):
        batches = 0
        while ref.has_next():
            assert port.has_next()
            _same_batch(port.next(), ref.next())
            batches += 1
        assert not port.has_next() and batches == (4 if drop_remainder else 5)
        orders.append(None if port._order is None else port._order.numpy().copy())
        if shuffle:
            np.testing.assert_array_equal(orders[-1], np.asarray(ref._order))
        port.reset()
        ref.reset()
    if shuffle:
        assert not np.array_equal(orders[0], orders[1])


@pytest.mark.parametrize("shuffle", [False, True])
def test_resident_next_window_matches_jax_sizes_and_slices(shuffle):
    """Windows are the largest power of two of whole batches that fit: 2
    when 3 are asked, then the 2 left of the 21 rows' 4 full batches when
    8 are asked; a cursor with no full batch left and a misaligned cursor
    give None; the labels may be absent."""
    x, y = _rows()
    for labels in (y, None):
        kw = dict(batch_size=5, shuffle=shuffle, seed=3)
        port, ref = DeviceResidentIterator(x, labels, device="cpu", **kw), JaxResident(x, labels, **kw)
        sizes = []
        for ask in (3, 8, 8):
            got, want = port.next_window(ask), ref.next_window(ask)
            if want is None:
                assert got is None
                sizes.append(None)
                continue
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
            assert (got[1] is None) == (want[1] is None)
            if want[1] is not None:
                np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            sizes.append(int(got[0].shape[0]))
        assert sizes == [2, 2, None]
        _same_batch(port.next(), ref.next())  # the ragged tail, one row
        assert not port.has_next() and not ref.has_next()

        port.reset()
        ref.reset()
        _same_batch(port.next(), ref.next())
        port._cursor = ref._cursor = 3  # misaligned: no window
        assert port.next_window(2) is None and ref.next_window(2) is None
        assert port.next_window(0) is None


def test_resident_iterator_refuses_a_sharding_and_mismatched_rows():
    x, y = _rows()
    with pytest.raises(NotImplementedError, match="'Parallel training'"):
        DeviceResidentIterator(x, y, device="cpu", sharding=object())
    with pytest.raises(ValueError, match="row mismatch"):
        DeviceResidentIterator(x, y[:-1], device="cpu")


@pytest.mark.parametrize("depth", [1, 3])
@pytest.mark.parametrize("transform", [False, True])
def test_prefetch_iterator_matches_jax_and_its_inner_iterator(depth, transform):
    """Every batch of ``DevicePrefetchIterator`` (as tensors on the device)
    equals the JAX prefetcher's and its inner iterator's; ``transform``
    runs once per batch, before placement; ``reset()`` starts the inner
    iterator's next epoch."""
    x, y = _rows(n=12, f=2)
    seen = []

    def hook(cls):
        def scale(batch):
            seen.append(batch.num_examples())
            return cls(batch.features * 2.0, batch.labels)
        return scale if transform else None

    port = DevicePrefetchIterator(ArrayDataSetIterator(x, y, batch_size=5), depth=depth,
                                  device="cpu", transform=hook(DataSet))
    ref = JaxPrefetch(JaxArrayIterator(x, y, batch_size=5), depth=depth, transform=hook(JaxDataSet))
    inner = list(ArrayDataSetIterator(x, y, batch_size=5))
    got, want = list(port), list(ref)
    assert len(got) == len(want) == len(inner) == 3
    for g, w, i in zip(got, want, inner):
        assert isinstance(g.features, torch.Tensor)
        _same_batch(g, w)
        np.testing.assert_array_equal(g.features.numpy(), i.features * (2.0 if transform else 1.0))
    assert seen == ([5, 5, 2] * 2 if transform else [])
    port.reset()
    assert port.has_next() and port.next().num_examples() == 5
    with pytest.raises(ValueError, match="depth must be >= 1"):
        DevicePrefetchIterator(ArrayDataSetIterator(x, y), depth=0, device="cpu")


def test_dataset_to_device_keeps_values_and_refuses_a_sharding():
    x, y = _rows(n=4)
    placed = DataSet(x, y).to_device("cpu")
    assert isinstance(placed.features, torch.Tensor) and placed.features.device.type == "cpu"
    np.testing.assert_array_equal(placed.labels.numpy(), y)
    assert DataSet(x).to_device("cpu").labels is None
    with pytest.raises(NotImplementedError, match="'Parallel training'"):
        DataSet(x, y).to_device("cpu", sharding=object())


# -- the device body and its static buffers ------------------------------------------

@pytest.mark.parametrize("case", sorted(CASES))
def test_a_window_equals_single_iterations_and_the_eager_body_bit_for_bit(case):
    """K = 3 iterations three ways from the same init and draws: one window
    (``train_iterations``), three ``train_iteration`` calls, and the device
    body applied straight to the trees. States, dtypes, step counters and
    losses bit-equal; the trees alias as the eager ones do; every window
    but the first reuses its entries."""
    family, overrides, entries = CASES[case]
    window, single, eager = (_experiment(family, **overrides) for _ in range(3))
    x, y = _data(window, 3, seed=5)
    rows = window.train_iterations(x, y)
    singles = [single.train_iteration(x[k], y[k]) for k in range(3)]
    eager_rows = _eager(eager, x, y)
    _assert_bit_equal(window.digest_states(), eager.digest_states())
    _assert_bit_equal(single.digest_states(), eager.digest_states())
    for i, key in enumerate(("d_loss", "g_loss", "cv_loss")):
        want = eager_rows[:, i]
        assert torch.equal(rows[key], want) or (torch.isnan(want).all() and torch.isnan(rows[key]).all())
        got = torch.stack([s[key] for s in singles])
        assert torch.equal(got, want) or (torch.isnan(want).all() and torch.isnan(got).all())
    assert _alias_groups(window) == _alias_groups(single) == _alias_groups(eager)
    assert len(window.graphs.entry_stats()) == entries
    window.train_iterations(*_data(window, 2, seed=6))
    assert len(window.graphs.entry_stats()) == entries
    assert window.graphs.runs == 5 and window.graphs.capture_counts == {}


def test_aliasing_after_each_iteration_matches_the_eager_trees():
    """Init (dis and the classifier share layers), after one iteration and
    after two (gan and gen share layers): the same id-groups as the eager
    loop's, and the steady state updates the same buffers in place."""
    runner, eager = _experiment("mnist"), _experiment("mnist")
    x, y = _data(runner, 2, seed=7)
    assert _alias_groups(runner) == _alias_groups(eager)
    assert any(g[0].startswith("dis/") and g[1].startswith("CV/") for g in _alias_groups(runner))
    buffers = []
    for k in range(2):
        runner.train_iteration(x[k], y[k])
        _eager(eager, x[k:k + 1], y[k:k + 1])
        assert _alias_groups(runner) == _alias_groups(eager)
        assert any(g[0].startswith("gan/") and g[1].startswith("gen/") for g in _alias_groups(runner))
        buffers.append(_tensor_ids(runner))
    runner.train_iteration(x[0], y[0])
    assert _tensor_ids(runner) == buffers[1]


def _tensor_ids(exp):
    return {k: id(v) for k, v in flatten_states(exp.digest_states()).items()
            if isinstance(v, torch.Tensor)}


def test_returned_losses_survive_the_next_window():
    """Each call returns freshly allocated losses: the next window (which
    rewrites the static loss buffer) leaves them as they were."""
    exp = _experiment("tabular")
    x, y = _data(exp, 3, seed=8)
    first = exp.train_iteration(x[0], y[0])
    kept = {k: float(v) for k, v in first.items() if k != "cv_loss"}
    window = exp.train_iterations(x[1:], y[1:])
    kept_window = window["d_loss"].clone()
    exp.train_iteration(x[0], y[0])
    assert {k: float(first[k]) for k in kept} == kept
    assert torch.equal(window["d_loss"], kept_window)
    assert float(first["d_loss"]) != float(window["d_loss"][0])


@pytest.mark.parametrize("family", ["mnist", "wgan_gp"])
def test_a_state_assigned_from_outside_between_calls_is_picked_up(family):
    """``a`` trains on batches 0 and 1. ``b`` trains on batch 2, is handed
    clones of ``a``'s trees after batch 0 (as a test or ``load_models``
    would assign them), then trains on batch 1: it ends bit-equal to ``a``,
    so the new values were copied into the static buffers."""
    a, b = _experiment(family), _experiment(family)
    x, y = _data(a, 3, seed=9)
    a.train_iteration(x[0], y[0])
    after_one = {k: _clone(v) for k, v in a._trees().items()}
    b.train_iteration(x[2], y[2])
    copied = b.graphs.copies_in
    b._set_trees(after_one)
    a.train_iteration(x[1], y[1])
    b.train_iteration(x[1], y[1])
    assert b.graphs.copies_in > copied
    _assert_bit_equal(a.digest_states(), b.digest_states())


def _clone(tree):
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if hasattr(tree, "opt_state"):
        return type(tree)(_clone(tree.params), _clone(tree.opt_state), tree.step)
    return {k: _clone(v) for k, v in tree.items()}


def test_the_runner_refuses_a_body_that_returns_an_input_at_another_position():
    """Updated in place, such an output would be read after its buffer was
    written."""

    def shifted(trees, inputs):  # the new "a" is the old "b": a hazard in place
        return {"a": trees["b"], "b": trees["b"] * 2}, torch.zeros(3)

    runner = CapturedIterations(shifted, torch.device("cpu"))
    trees = {"a": torch.zeros(2), "b": torch.ones(2)}
    with pytest.raises(RuntimeError, match="view of a static input"):
        runner.run(trees, {"x": torch.zeros(1, 1)})


# -- run() and the CLI ---------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX package's sequential ``run()`` (windows of 1: no scan) over
    5 iterations of MNIST at batch 8."""
    (x, y), _ = synthetic_mnist(8 * B, 8, seed=12)
    y = one_hot_np(y, 10)
    cfg = JaxConfig(batch_size_train=B, latent_grid=2, num_iterations=5, print_every=100,
                    loss_fetch_every=1, save_models=False,
                    output_dir=str(tmp_path_factory.mktemp("jax_run")))
    exp = JaxExperiment(cfg)
    init = {"dis": exp.dis_state, "gan": exp.gan_state, "CV": exp.cv_state, "gen": exp.gen_params}
    init = {k: _to_numpy(v) for k, v in init.items()}
    return exp.run(JaxArrayIterator(x, y, batch_size=B)), init, x, y


def _to_numpy(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _port_from(init, **overrides):
    exp = _experiment("mnist", print_every=100, num_iterations=5, **overrides)
    exp.dis_state = train_state_from_numpy(init["dis"], "cpu", graph=exp.dis)
    exp.gan_state = train_state_from_numpy(init["gan"], "cpu", graph=exp.gan)
    exp.cv_state = train_state_from_numpy(init["CV"], "cpu", graph=exp.cv)
    exp.gen_params = params_from_numpy(init["gen"], "cpu", graph=exp.gen)
    exp.z_source = jax_z_source(exp.config.seed)
    return exp


def test_run_over_the_resident_iterator_in_windows_matches_jax_sequential_run(jax_run, tmp_path):
    """The port's ``run()`` (``loss_fetch_every=4``) takes iteration 0 alone
    (the manifold export ends a window) and iterations 1-4 as one window
    of 4 from ``next_window``; the JAX package ran the same 5 iterations
    one by one. The first iteration's losses within 1e-4 relative, the
    second's within 1e-3 (free-running from there), all finite; the same
    metrics keys. Through ``DevicePrefetchIterator`` (``prefetch=2``) over
    the same rows, windows assembled from prefetched batches, the port's
    history and states are bit-equal."""
    jres, init, x, y = jax_run
    resident = _port_from(init, loss_fetch_every=4, output_dir=str(tmp_path / "resident"))
    windows = []
    resident.train_iterations = lambda f, l, run=resident.train_iterations: (
        windows.append(int(f.shape[0])) or run(f, l))
    pres = resident.run(DeviceResidentIterator(x, y, batch_size=B, device="cpu"))
    assert pres["iterations"] == jres["iterations"] == 5
    assert windows == [4] and resident.graphs.runs == 5
    assert [sorted(h) for h in pres["history"]] == [sorted(h) for h in jres["history"]]
    keys = ("d_loss", "g_loss", "cv_loss")
    for rtol, got, want in ((ITER_LOSS_RTOL, pres["history"][0], jres["history"][0]),
                            (FREE_LOSS_RTOL, pres["history"][1], jres["history"][1])):
        for k in keys:
            np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=0, err_msg=k)
    assert np.isfinite([h[k] for h in pres["history"] for k in keys]).all()

    prefetched = _port_from(init, loss_fetch_every=4, prefetch=2, output_dir=str(tmp_path / "pre"))
    qres = prefetched.run(ArrayDataSetIterator(x, y, batch_size=B))
    assert [[h[k] for k in keys] for h in qres["history"]] == \
        [[h[k] for k in keys] for h in pres["history"]]
    _assert_bit_equal(prefetched.digest_states(), resident.digest_states())


def test_run_carries_a_ragged_tail_of_the_resident_iterator_to_a_window_of_one(tmp_path):
    """20 rows at batch 8: each epoch is a window of 2 from ``next_window``
    and a ragged batch of 4 through ``next()``, which gets its own entry
    once and reuses it in the next epoch; the result equals the same
    batches fed one by one."""
    windowed = _experiment("tabular", num_iterations=6, loss_fetch_every=4, print_every=100,
                           output_dir=str(tmp_path / "a"))
    x, y = _data(windowed, 3, seed=13)
    x, y = x.reshape(-1, x.shape[-1])[:20], y.reshape(-1, 10)[:20]
    res = windowed.run(DeviceResidentIterator(x, y, batch_size=B, device="cpu"))
    assert res["iterations"] == 6
    stats = windowed.graphs.entry_stats()
    assert sorted({name.split(" |")[0] for name in stats}) == [
        "features[4, 32] draws[72]", "features[8, 32] draws[144]"]
    assert [v["runs"] for k, v in stats.items() if k.startswith("features[4, ")] == [2]
    one_by_one = _experiment("tabular", output_dir=str(tmp_path / "b"))
    for _ in range(2):
        for lo in (0, 8, 16):
            one_by_one.train_iteration(x[lo:lo + B], y[lo:lo + B])
    _assert_bit_equal(windowed.digest_states(), one_by_one.digest_states())


def test_cli_trains_with_prefetch_on_the_cpu(tmp_path, capsys):
    """``--prefetch 2`` validates and trains end to end (tabular, 2
    iterations: checkpoints and the manifold CSVs written; tabular rows
    are no image, so no PNG)."""
    args = ["--model-family", "tabular", "--num-features", "32", "--z-size", "8",
            "--batch-size-train", str(B), "--batch-size-pred", str(B), "--num-iterations", "2",
            "--latent-grid", "2", "--prefetch", "2", "--use-accelerator", "false",
            "--data-dir", str(tmp_path / "data"), "--output-dir", str(tmp_path / "out")]
    assert pt_main(args) == 0
    assert "'--prefetch', '2'" in capsys.readouterr().out
    assert sorted(f.name for f in (tmp_path / "out").iterdir()) == [
        "mnist_dis_model.zip", "mnist_gan_model.zip", "mnist_gen_model.zip",
        "mnist_out_1.csv", "mnist_out_2.csv"]
