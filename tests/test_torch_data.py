"""PyTorch port, the data surface's rest, ``GraphTrainer.fit`` and
``ServingEngine.scenario_manifest`` against the JAX package on the CPU.

- ``DataSet`` (``get_features``, ``get_labels``, ``merge``), ``one_hot``
  and ``train_test_split``: equal to the JAX package's;
- ``ClassPathResource``, ``FileSplit`` over a resource,
  ``InMemoryRecordReader`` and the record-at-a-time iterator path (a
  reader without ``next_block``): the same batches as the JAX package's;
- ``GraphTrainer.fit`` on the MNIST transfer classifier, 3 batches: losses
  1e-4 relative, every leaf 5e-3 by ``state_divergence`` (the tolerance
  of ``tests/test_torch_train.py``), and bit-equal to 3 ``train_step``s;
- ``scenario_manifest()``: equal to the JAX engine's, None without a zoo
  block.

Run with ``JAX_PLATFORMS=cpu``.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_deeplearning4j_tpu.data import dataset as jax_dataset
from gan_deeplearning4j_tpu.data import iterator as jax_iterator
from gan_deeplearning4j_tpu.data import records as jax_records
from gan_deeplearning4j_tpu.models import dcgan_mnist as jax_models
from gan_deeplearning4j_tpu.nn import DenseLayer as JaxDense
from gan_deeplearning4j_tpu.nn import GraphBuilder as JaxBuilder
from gan_deeplearning4j_tpu.nn import GraphConfig as JaxConfig
from gan_deeplearning4j_tpu.nn import InputType as JaxInputType
from gan_deeplearning4j_tpu.nn import OutputLayer as JaxOutput
from gan_deeplearning4j_tpu.parallel.trainer import GraphTrainer as JaxTrainer
from gan_deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from gan_deeplearning4j_tpu.zoo.manifest import ScenarioManifest as JaxManifest
from gan_deeplearning4j_tpu_torch.data import dataset as pt_dataset
from gan_deeplearning4j_tpu_torch.data import iterator as pt_iterator
from gan_deeplearning4j_tpu_torch.data import records as pt_records
from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states, state_divergence
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy, train_state_from_numpy
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as pt_models
from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph as PtGraph
from gan_deeplearning4j_tpu_torch.parallel import GraphTrainer
from gan_deeplearning4j_tpu_torch.serving import ServingEngine
from gan_deeplearning4j_tpu_torch.zoo.manifest import ScenarioManifest

FEAT, CLASSES = 6, 3


def _host(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- DataSet, one_hot, train_test_split ------------------------------------------------

def test_dataset_accessors_and_merge_match_jax():
    rng = np.random.default_rng(0)
    parts = [(rng.random((n, FEAT), dtype=np.float32),
              jax_dataset.one_hot_np(rng.integers(0, CLASSES, n), CLASSES)) for n in (3, 5, 2)]
    ref = jax_dataset.DataSet.merge([jax_dataset.DataSet(jnp.asarray(f), jnp.asarray(l))
                                     for f, l in parts])
    # numpy rows stay numpy; tensors stay tensors on their device
    for wrap in (np.asarray, torch.from_numpy):
        mine = pt_dataset.DataSet.merge([pt_dataset.DataSet(wrap(f), wrap(l)) for f, l in parts])
        assert isinstance(mine.get_features(), np.ndarray if wrap is np.asarray else torch.Tensor)
        assert mine.get_features() is mine.features and mine.get_labels() is mine.labels
        np.testing.assert_array_equal(_host(mine.get_features()), np.asarray(ref.get_features()))
        np.testing.assert_array_equal(_host(mine.get_labels()), np.asarray(ref.get_labels()))
        assert mine.num_examples() == len(mine) == 10
    unlabeled = pt_dataset.DataSet.merge([pt_dataset.DataSet(f) for f, _ in parts])
    assert unlabeled.labels is None and unlabeled.features.shape == (10, FEAT)
    mixed = pt_dataset.DataSet.merge([pt_dataset.DataSet(torch.from_numpy(parts[0][0])),
                                      pt_dataset.DataSet(parts[1][0])])
    assert isinstance(mixed.features, torch.Tensor) and mixed.features.shape == (8, FEAT)


def test_one_hot_matches_jax():
    labels = np.array([0, 2, 1, 2, 5, -1])  # the last two are out of range
    ref = np.asarray(jax_dataset.one_hot(labels, CLASSES))
    mine = pt_dataset.one_hot(labels, CLASSES, device="cpu")
    assert isinstance(mine, torch.Tensor) and mine.dtype == torch.float32
    np.testing.assert_array_equal(mine.numpy(), ref)
    # a tensor's own device by default
    np.testing.assert_array_equal(pt_dataset.one_hot(torch.tensor([[1], [0]]), 2).numpy(),
                                  [[0.0, 1.0], [1.0, 0.0]])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            pt_dataset.one_hot(labels, CLASSES)


@pytest.mark.parametrize("n,fraction,seed", [(50, 0.2, 666), (7, 0.5, 1), (10, 0.0, 3)])
def test_train_test_split_matches_jax(n, fraction, seed):
    x = np.arange(n * 2, dtype=np.float32).reshape(n, 2)
    y = np.arange(n)
    ref = jax_dataset.train_test_split(x, y, fraction, seed=seed)
    mine = pt_dataset.train_test_split(x, y, fraction, seed=seed)
    for (a, b), (c, d) in zip(mine, ref):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


# -- records ------------------------------------------------------------------------------

def test_class_path_resource_resolves_as_the_reference(tmp_path, monkeypatch):
    root, env_root, cwd = tmp_path / "root", tmp_path / "env", tmp_path / "cwd"
    for d in (root, env_root, cwd / "resources"):
        d.mkdir(parents=True)
    (root / "a.csv").write_text("1,2\n")
    (env_root / "b.csv").write_text("3,4\n")
    (cwd / "resources" / "c.csv").write_text("5,6\n")
    monkeypatch.chdir(cwd)
    monkeypatch.setenv("GAN_DL4J_TPU_DATA", str(env_root))
    for name in ("a.csv", "b.csv", "c.csv", str(root / "a.csv")):
        mine = pt_records.ClassPathResource(name, roots=[str(root)])
        ref = jax_records.ClassPathResource(name, roots=[str(root)])
        assert mine.roots == ref.roots
        assert mine.get_file() == ref.get_file()
    with pytest.raises(FileNotFoundError, match="'missing.csv' not found"):
        pt_records.ClassPathResource("missing.csv").get_file()
    # a FileSplit takes the resource and resolves it
    reader = pt_records.CSVRecordReader()
    reader.initialize(pt_records.FileSplit(pt_records.ClassPathResource("b.csv")))
    np.testing.assert_array_equal(reader.data, [[3.0, 4.0]])
    assert pt_records.FileSplit(str(root / "a.csv")).path == str(root / "a.csv")


class _RecordsOnly:
    """A reader with ``has_next`` / ``next_record`` / ``reset`` only."""

    def __init__(self, data):
        self._data, self._cursor = np.asarray(data, np.float32), 0

    def has_next(self):
        return self._cursor < len(self._data)

    def next_record(self):
        self._cursor += 1
        return self._data[self._cursor - 1]

    def reset(self):
        self._cursor = 0


def _labelled_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.random((n, FEAT), dtype=np.float32),
                           rng.integers(0, CLASSES, (n, 1)).astype(np.float32)], axis=1)


@pytest.mark.parametrize("reader", ["in_memory", "records_only"])
@pytest.mark.parametrize("labelled", [True, False])
def test_record_iterators_batch_as_the_reference(reader, labelled):
    rows = _labelled_rows(11)
    make = {"in_memory": (pt_records.InMemoryRecordReader, jax_records.InMemoryRecordReader),
            "records_only": (_RecordsOnly, _RecordsOnly)}[reader]
    kwargs = {"label_index": FEAT, "num_classes": CLASSES} if labelled else {}
    mine = pt_iterator.RecordReaderDataSetIterator(make[0](rows), 4, **kwargs)
    ref = jax_iterator.RecordReaderDataSetIterator(make[1](rows), 4, **kwargs)
    for _ in range(2):  # two epochs: reset rewinds both
        got, want = list(mine), list(ref)
        assert [len(b) for b in got] == [len(b) for b in want] == [4, 4, 3]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(_host(a.features), np.asarray(b.features))
            if labelled:
                np.testing.assert_array_equal(_host(a.labels), np.asarray(b.labels))
            else:
                assert a.labels is None and b.labels is None
    with pytest.raises(StopIteration):
        mine.next()


def test_in_memory_reader_surface():
    rows = _labelled_rows(5)
    mine, ref = pt_records.InMemoryRecordReader(rows), jax_records.InMemoryRecordReader(rows)
    for r in (mine, ref):
        r.initialize()
    np.testing.assert_array_equal(mine.next_block(3), ref.next_block(3))
    assert mine.remaining() == ref.remaining() == 2
    np.testing.assert_array_equal(mine.next_record(), ref.next_record())
    mine.reset()
    assert [list(r) for r in mine] == [list(r) for r in rows.astype(np.float32)]


# -- GraphTrainer.fit -------------------------------------------------------------------

B, STEPS = 8, 3


@pytest.fixture(scope="module")
def classifier():
    jax_dis = jax_models.build_discriminator()
    jax_cv, params = jax_models.build_transfer_classifier(jax_dis, jax_dis.init())
    jax_trainer = JaxTrainer(jax_cv)
    state = jax.tree_util.tree_map(np.asarray, jax_trainer.init_state(params=params))
    pt_dis = pt_models.build_discriminator()
    pt_cv, _ = pt_models.build_transfer_classifier(pt_dis, pt_dis.init(device="cpu"))
    rng = np.random.default_rng(12)
    rows = np.concatenate([rng.random((B * STEPS + 2, 784), dtype=np.float32),
                           rng.integers(0, 10, (B * STEPS + 2, 1)).astype(np.float32)], axis=1)
    return jax_cv, jax_trainer, state, pt_cv, rows


def _port_iterator(rows):
    return pt_iterator.RecordReaderDataSetIterator(pt_records.InMemoryRecordReader(rows), B,
                                                   label_index=784, num_classes=10)


def test_fit_matches_jax(classifier):
    jax_cv, jax_trainer, state, pt_cv, rows = classifier
    reowned = jax.jit(lambda t: jax.tree_util.tree_map(lambda a: a * 1, t))(state)
    jax_it = jax_iterator.RecordReaderDataSetIterator(jax_records.InMemoryRecordReader(rows), B,
                                                      label_index=784, num_classes=10)
    jax_state, jax_losses = jax_trainer.fit(reowned, jax_it, num_batches=STEPS)
    trainer = GraphTrainer(pt_cv)
    pt_state, pt_losses = trainer.fit(train_state_from_numpy(state, "cpu", graph=pt_cv),
                                      _port_iterator(rows), num_batches=STEPS)
    assert len(pt_losses) == len(jax_losses) == STEPS and pt_state.step == STEPS
    assert all(isinstance(v, float) for v in pt_losses)
    np.testing.assert_allclose(pt_losses, jax_losses, rtol=1e-4)
    ref = flatten_states({"cv": jax.tree_util.tree_map(np.asarray, {
        "params": jax_state.params, "opt_state": jax_state.opt_state})})
    mine = flatten_states({"cv": {"params": pt_state.params, "opt_state": pt_state.opt_state}})
    assert state_divergence(mine, ref)["max_leaf_rel"] <= 5e-3


def test_fit_is_train_steps(classifier):
    _, _, state, pt_cv, rows = classifier
    trainer = GraphTrainer(pt_cv)
    fitted, losses = trainer.fit(train_state_from_numpy(state, "cpu", graph=pt_cv),
                                 _port_iterator(rows), num_batches=STEPS)
    stepped = train_state_from_numpy(state, "cpu", graph=pt_cv)
    it = _port_iterator(rows)
    for i in range(STEPS):
        batch = it.next()
        stepped, loss = trainer.train_step(stepped, torch.from_numpy(batch.features),
                                           torch.from_numpy(batch.labels))
        assert float(loss) == losses[i]
    a = flatten_states({"cv": {"params": fitted.params, "opt_state": fitted.opt_state}})
    b = flatten_states({"cv": {"params": stepped.params, "opt_state": stepped.opt_state}})
    assert all(torch.equal(a[k], b[k]) for k in b)
    # the whole iterator when no count is given: 26 rows are 4 batches
    _, every = trainer.fit(train_state_from_numpy(state, "cpu", graph=pt_cv), _port_iterator(rows))
    assert len(every) == 4 and every[:STEPS] == losses
    empty = _port_iterator(rows[:0])
    assert trainer.fit(stepped, empty) == (stepped, [])


# -- ServingEngine.scenario_manifest ----------------------------------------------------------

def _tiny_generator(z):
    b = JaxBuilder(JaxConfig(seed=1))
    b.add_inputs("z").set_input_types(JaxInputType.feed_forward(z))
    b.add_layer("g_dense_1", JaxDense(n_out=8, activation="tanh"), "z")
    b.add_layer("g_out", JaxOutput(n_out=784, activation="sigmoid", loss="xent"), "g_dense_1")
    b.set_outputs("g_out")
    return b.build()


@pytest.mark.parametrize("scenario", [None, {"conditioning": "none"},
                                      {"conditioning": "class", "dataset": "fashion_mnist"}])
def test_scenario_manifest_matches_jax(scenario):
    block = None if scenario is None else JaxManifest(**scenario).to_dict()
    width = 2 + (10 if scenario and scenario["conditioning"] == "class" else 0)
    jgen = _tiny_generator(width)
    tree = {k: {n: np.asarray(v) for n, v in lp.items()} for k, lp in jgen.init().items()}
    pgen = PtGraph.from_dict(json.loads(json.dumps(jgen.to_dict())))
    ref = JaxEngine({"generator": (jgen, jax.tree_util.tree_map(jnp.asarray, tree))},
                    buckets=(4,), scenario=block)
    mine = ServingEngine({"generator": (pgen, params_from_numpy(tree, "cpu", graph=pgen))},
                         buckets=(4,), scenario=block, device="cpu")
    if scenario is None:
        assert mine.scenario_manifest() is None and ref.scenario_manifest() is None
        return
    got = mine.scenario_manifest()
    assert isinstance(got, ScenarioManifest)
    assert got.to_dict() == ref.scenario_manifest().to_dict()
    assert got.conditional == mine.conditional == ref.conditional
