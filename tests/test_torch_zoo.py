"""PyTorch port, the model zoo and class conditioning against the JAX
package on the CPU.

- the scenario manifest: round trips, family mapping, derived widths,
  ``experiment_config`` and every rejection, message for message;
- ``validate()``'s class-conditioning rules, in the JAX package's order;
- the dataset loaders, bit-equal at one seed;
- the streaming iterator, byte-identical to the port's in-memory iterator
  and to the JAX package's streaming iterator (shuffled over two epochs
  with a ragged tail, drop-remainder, unshuffled and unlabeled,
  ``npz_source``), and on a device;
- one conditional fused iteration of the MNIST family (full width, batch
  8) and of the image family (8×8×3) from the JAX experiment's initial
  states with its z draws injected: losses within 1e-4 relative and every
  leaf within 5e-3 by ``state_divergence`` (the one-iteration tolerance of
  ``tests/test_torch_train.py``);
- conditional checkpoints crossing both ways bit for bit;
- a JAX-published conditional bundle served by the port's engine and
  service, and a port-published one by the JAX package's: every class of
  ``sample?class=k`` within 1e-5, every error status and message equal;
- the canary's conditional probe reaching the JAX gate's decision;
- ``register`` / ``unregister`` and their errors;
- the port's zoo drill under ``--smoke`` on the CPU.
"""

import dataclasses
import json
import os
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.data import ArrayDataSetIterator as JaxArrayIterator
from gan_deeplearning4j_tpu.deploy.canary import CanaryGate as JaxCanaryGate
from gan_deeplearning4j_tpu.deploy.canary import CanaryThresholds as JaxThresholds
from gan_deeplearning4j_tpu.harness import ExperimentConfig as JaxConfig
from gan_deeplearning4j_tpu.harness import make_experiment as jax_make_experiment
from gan_deeplearning4j_tpu.models import registry as jax_registry
from gan_deeplearning4j_tpu.serving import InferenceService as JaxService
from gan_deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from gan_deeplearning4j_tpu.zoo import datasets as jax_datasets
from gan_deeplearning4j_tpu.zoo import manifest as jax_manifest
from gan_deeplearning4j_tpu.zoo import streaming as jax_streaming
from gan_deeplearning4j_tpu_torch.data import ArrayDataSetIterator
from gan_deeplearning4j_tpu_torch.deploy.canary import CanaryGate, CanaryThresholds
from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment
from gan_deeplearning4j_tpu_torch.harness.experiment import state_divergence
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy, train_state_from_numpy
from gan_deeplearning4j_tpu_torch.models import registry
from gan_deeplearning4j_tpu_torch.serving import InferenceService, ServingEngine
from gan_deeplearning4j_tpu_torch.zoo import datasets, drill, manifest, streaming

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
B = 8
TOL = dict(rtol=1e-5, atol=1e-5)
EXACT = dict(rtol=0, atol=0)
ITER_LOSS_RTOL, ITER_LEAF_REL = 1e-4, 5e-3
#: conditional experiments: the MNIST family at the reference's width, the
#: image family at 8×8×3
SHAPES = {
    "mnist": dict(model_family="mnist"),
    "image": dict(model_family="cifar10", height=8, width=8, channels=3, num_features=192),
}


# -- the scenario manifest -----------------------------------------------------------

VALID = [
    dict(),
    dict(conditioning="class"),
    dict(dataset="fashion_mnist", conditioning="class", num_classes=4, z_size=3),
    dict(dataset="cifar_shaped", resolution=32),
    dict(dataset="cifar_shaped", resolution=32, conditioning="class"),
    dict(architecture="wgan_gp", dataset="cifar_shaped", resolution=32, z_size=128),
]
INVALID = [
    dict(architecture="stylegan"),
    dict(conditioning="text"),
    dict(dataset="imagenet"),
    dict(resolution=32),
    dict(architecture="wgan_gp"),
    dict(architecture="wgan_gp", dataset="cifar_shaped", resolution=32, conditioning="class"),
    dict(conditioning="class", num_classes=1),
    dict(z_size=0),
]


@pytest.mark.parametrize("fields", VALID)
def test_manifest_identities_and_round_trips_match_jax(fields):
    port, ref = manifest.ScenarioManifest(**fields), jax_manifest.ScenarioManifest(**fields)
    assert port.to_dict() == ref.to_dict()
    for name in ("shape", "num_features", "family_name", "conditional", "sample_input_width"):
        assert getattr(port, name) == getattr(ref, name), name
    assert manifest.ScenarioManifest.from_dict(ref.to_dict()) == port
    assert jax_manifest.ScenarioManifest.from_dict(port.to_dict()) == ref
    # the config each materialises, field for field (the port's own fields
    # beside: prefetch, use_accelerator)
    pcfg = dataclasses.asdict(port.experiment_config(seed=3, batch_size_train=10))
    jcfg = dataclasses.asdict(ref.experiment_config(seed=3, batch_size_train=10))
    assert {k: pcfg[k] for k in jcfg if k in pcfg} == {k: jcfg[k] for k in jcfg if k in pcfg}
    assert manifest.scenario_from_config(port.experiment_config()) == port


@pytest.mark.parametrize("fields", INVALID)
def test_manifest_rejections_match_jax(fields):
    with pytest.raises(ValueError) as ref:
        jax_manifest.ScenarioManifest(**fields)
    with pytest.raises(ValueError) as port:
        manifest.ScenarioManifest(**fields)
    assert str(port.value) == str(ref.value)


def test_from_dict_rejects_unknown_keys_as_jax_does():
    doc = {**manifest.ScenarioManifest().to_dict(), "colour": "red", "alpha": 1}
    with pytest.raises(ValueError) as ref:
        jax_manifest.ScenarioManifest.from_dict(doc)
    with pytest.raises(ValueError) as port:
        manifest.ScenarioManifest.from_dict(doc)
    assert str(port.value) == str(ref.value) == "unknown scenario manifest keys ['alpha', 'colour']"


def test_scenario_from_bundle_matches_jax(tmp_path):
    for name, zoo in (("with", manifest.ScenarioManifest(conditioning="class").to_dict()), ("without", None)):
        directory = tmp_path / name
        directory.mkdir()
        doc = {"format_version": 1, "generator": "gen.zip"}
        if zoo is not None:
            doc["zoo"] = zoo
        (directory / "serving.json").write_text(json.dumps(doc))
        port, ref = manifest.scenario_from_bundle(str(directory)), jax_manifest.scenario_from_bundle(str(directory))
        assert (port is None) == (ref is None) == (zoo is None)
        if zoo is not None:
            assert port.to_dict() == ref.to_dict() == zoo


# -- validate(): class conditioning -------------------------------------------------

@pytest.mark.parametrize("overrides", [
    dict(conditioning="class", num_classes=1),
    dict(conditioning="class", distributed="param_averaging"),
    dict(conditioning="class", model_family="wgan_gp", height=8, width=8, channels=3,
         num_features=192, batch_size_train=10, n_critic=5),
    dict(conditioning="label"),
])
def test_conditioning_rules_raise_the_jax_packages_errors_first(overrides):
    """``param_averaging`` + class raises JAX's ``ValueError``, before the
    port's 'Parallel training' refusal."""
    with pytest.raises(ValueError) as ref:
        JaxConfig(**overrides).validate()
    with pytest.raises(ValueError) as port:
        ExperimentConfig(**overrides).validate()
    assert str(port.value) == str(ref.value)


# -- the dataset loaders --------------------------------------------------------------

@pytest.mark.parametrize("name", ["mnist", "fashion_mnist", "cifar_shaped"])
@pytest.mark.parametrize("seed", [666, 3])
def test_loaders_are_bit_equal_to_jax(name, seed):
    port = datasets.load_dataset(name, num_train=40, num_test=12, seed=seed)
    ref = jax_datasets.load_dataset(name, num_train=40, num_test=12, seed=seed)
    for (px, py), (rx, ry) in zip(port, ref):
        assert px.dtype == rx.dtype == np.float32 and py.dtype == ry.dtype == np.int64
        assert px.shape == (40 if px is port[0][0] else 12, manifest.ScenarioManifest(
            dataset=name, resolution=manifest.DATASET_SHAPES[name][0]).num_features)
        assert px.tobytes() == rx.tobytes() and py.tobytes() == ry.tobytes()
    direct = {"mnist": datasets.load_mnist, "fashion_mnist": datasets.load_fashion_mnist,
              "cifar_shaped": datasets.load_cifar_shaped}[name](num_train=40, num_test=12, seed=seed)
    assert direct[0][0].tobytes() == port[0][0].tobytes()


def test_unknown_dataset_raises_as_jax_does():
    with pytest.raises(ValueError) as ref:
        jax_datasets.load_dataset("imagenet")
    with pytest.raises(ValueError) as port:
        datasets.load_dataset("imagenet")
    assert str(port.value) == str(ref.value)


# -- the streaming iterator -----------------------------------------------------------

def _batches(it, epochs=1):
    out = []
    for e in range(epochs):
        if e:
            it.reset()
        while it.has_next():
            b = it.next()
            out.append((np.asarray(b.features).tobytes(),
                        None if b.labels is None else np.asarray(b.labels).tobytes()))
    return out


@pytest.mark.parametrize("case", [
    dict(batch_size=16, shuffle=True, labels=True, block_batches=3),
    dict(batch_size=16, shuffle=True, labels=True, block_batches=1, drop_remainder=True),
    dict(batch_size=7, shuffle=False, labels=False, block_batches=2),
    dict(batch_size=50, shuffle=True, labels=False, block_batches=8),
])
def test_streaming_batches_are_byte_identical_to_both_iterators(case):
    """Two epochs over 101 rows (a ragged tail at every batch size here):
    the port's stream, the port's in-memory iterator and the JAX stream
    give the same bytes in the same order."""
    rng = np.random.default_rng(5)
    x = rng.random((101, 6))  # float64: the cast happens in the source
    y = np.eye(4)[rng.integers(0, 4, 101)] if case["labels"] else None
    kw = dict(batch_size=case["batch_size"], shuffle=case["shuffle"], seed=9,
              drop_remainder=case.get("drop_remainder", False))
    port = streaming.StreamingDataSetIterator(*streaming.array_source(x, y), block_batches=case["block_batches"], **kw)
    ref = jax_streaming.StreamingDataSetIterator(*jax_streaming.array_source(x, y),
                                                 block_batches=case["block_batches"], **kw)
    memory = ArrayDataSetIterator(x, y, **kw)
    jax_memory = JaxArrayIterator(x, y, **kw)
    try:
        got = _batches(port, 2)
        assert got == _batches(ref, 2) == _batches(memory, 2) == _batches(jax_memory, 2)
        full = 101 // case["batch_size"]
        assert len(got) == 2 * (full + (0 if kw["drop_remainder"] or 101 % case["batch_size"] == 0 else 1))
    finally:
        port.close()
        ref.close()


def test_npz_source_and_device_placement(tmp_path):
    rng = np.random.default_rng(6)
    x, y = rng.random((30, 5)).astype(np.float32), np.eye(3, dtype=np.float32)[rng.integers(0, 3, 30)]
    path = str(tmp_path / "rows.npz")
    np.savez(path, features=x, labels=y)
    kw = dict(batch_size=8, shuffle=True, seed=2)
    port = streaming.StreamingDataSetIterator(*streaming.npz_source(path), **kw)
    ref = jax_streaming.StreamingDataSetIterator(*jax_streaming.npz_source(path), **kw)
    host = streaming.StreamingDataSetIterator(*streaming.npz_source(path), **kw)
    placed = streaming.StreamingDataSetIterator(*streaming.npz_source(path), device="cpu", **kw)
    try:
        assert _batches(port, 2) == _batches(ref, 2)
        while placed.has_next():
            want, got = host.next(), placed.next()
            assert isinstance(got.features, torch.Tensor) and got.features.device.type == "cpu"
            assert got.features.numpy().tobytes() == want.features.tobytes()
            assert got.labels.numpy().tobytes() == want.labels.tobytes()
    finally:
        for it in (port, ref, host, placed):
            it.close()
    np.savez(path, features=x)
    unlabeled = streaming.StreamingDataSetIterator(*streaming.npz_source(path), batch_size=8)
    try:
        assert all(lab is None for _, lab in _batches(unlabeled))
    finally:
        unlabeled.close()


def test_streaming_rejects_what_jax_rejects():
    with pytest.raises(ValueError, match="block_batches must be >= 1"):
        streaming.StreamingDataSetIterator(*streaming.array_source(np.zeros((4, 2))), block_batches=0)
    with pytest.raises(ValueError, match="features/labels row mismatch"):
        streaming.array_source(np.zeros((4, 2)), np.zeros((3, 1)))
    it = streaming.StreamingDataSetIterator(*streaming.array_source(np.zeros((4, 2))), batch_size=4)
    it.next()
    with pytest.raises(StopIteration):
        it.next()
    it.close()
    it.close()  # twice is safe


# -- conditional training ------------------------------------------------------------

def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _reown(tree):
    return jax.jit(lambda t: jax.tree_util.tree_map(lambda a: a * 1, t))(tree)


def _flat(state, prefix=""):
    out = {}
    if hasattr(state, "opt_state"):
        out.update(_flat(state.params, prefix + "params/"))
        out.update(_flat(state.opt_state, prefix + "opt_state/"))
        out[prefix + "step"] = np.asarray(int(np.asarray(state.step)))
        return out
    for key, value in state.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{key}/"))
        else:
            out[prefix + key] = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) \
                else np.asarray(value)
    return out


def _jax_states(exp):
    out = {"dis": _np(exp.dis_state), "gan": _np(exp.gan_state), "gen": _np(exp.gen_params)}
    if exp.cv is not None:
        out["CV"] = _np(exp.cv_state)
    return out


def _config(cls, family, **overrides):
    cfg = dict(SHAPES[family], conditioning="class", batch_size_train=B, batch_size_pred=16,
               latent_grid=2, save_models=False)
    if cls is ExperimentConfig:
        cfg["use_accelerator"] = False
    cfg.update(overrides)
    return cls(**cfg)


def jax_z_source(seed, z_size):
    """The JAX fused iteration's base-z draws (``fold_in(PRNGKey(seed + 2),
    dis_step)`` split six ways); the one-hot is the batch's labels."""
    base = jax.random.PRNGKey(seed + 2)

    def source(dis_step, batch):
        k_fake, k_gan, *_ = jax.random.split(jax.random.fold_in(base, dis_step), 6)
        return np.stack([np.asarray(jax.random.uniform(k, (batch, z_size), jnp.float32, -1.0, 1.0))
                         for k in (k_fake, k_gan)])

    return source


@pytest.fixture(scope="module")
def jax_cond(tmp_path_factory):
    """One conditional JAX experiment per family (module-scoped: XLA:CPU
    compiles the fused iteration once) and its initial states."""
    cache = {}

    def get(family):
        if family not in cache:
            exp = jax_make_experiment(_config(JaxConfig, family,
                                              output_dir=str(tmp_path_factory.mktemp(f"jax_{family}"))))
            cache[family] = (exp, _jax_states(exp))
        return cache[family]

    return get


def _reset_jax(exp, init):
    exp.dis_state, exp.gan_state = _reown(init["dis"]), _reown(init["gan"])
    exp.gen_params = _reown(init["gen"])
    if "CV" in init:
        exp.cv_state = _reown(init["CV"])
    exp.batch_counter = 0


def _port(family, init, **overrides):
    exp = make_experiment(_config(ExperimentConfig, family, **overrides))
    exp.dis_state = train_state_from_numpy(init["dis"], "cpu", graph=exp.dis)
    exp.gan_state = train_state_from_numpy(init["gan"], "cpu", graph=exp.gan)
    exp.gen_params = params_from_numpy(init["gen"], "cpu", graph=exp.gen)
    if "CV" in init:
        exp.cv_state = train_state_from_numpy(init["CV"], "cpu", graph=exp.cv)
    exp.z_source = jax_z_source(exp.config.seed, exp.model_cfg.z_size)
    return exp


def _data(family, n, seed):
    fam = registry.get(SHAPES[family]["model_family"])
    cfg = _config(ExperimentConfig, family)
    x = fam.synthetic_data(n, fam.make_model_config(cfg), seed)
    labels = np.random.default_rng(seed).integers(0, 10, n)
    return x, np.eye(10, dtype=np.float32)[labels]


@pytest.mark.parametrize("family", ["mnist", "image"])
def test_one_conditional_iteration_matches_jax(jax_cond, family):
    """The generator and gan take z + 10 one-hot inputs, the discriminator
    (and the classifier) stay as they were; one fused iteration from the
    same states and draws matches the JAX package's."""
    jexp, init = jax_cond(family)
    _reset_jax(jexp, init)
    x, y = _data(family, B, seed=1)
    jlosses = jexp.train_iteration(x, y)
    pexp = _port(family, init)
    assert pexp.gen.input_types[0].features == jexp.gen.input_types[0].features == pexp.model_cfg.z_size + 10
    assert pexp.dis.to_dict() == json.loads(json.dumps(jexp.dis.to_dict()))
    assert pexp._z_grid.tobytes() == np.asarray(jexp._z_grid).tobytes()
    plosses = pexp.train_iteration(x, y)
    for k in ("d_loss", "g_loss") + (("cv_loss",) if family == "mnist" else ()):
        np.testing.assert_allclose(float(plosses[k]), float(jlosses[k]), rtol=ITER_LOSS_RTOL, atol=0, err_msg=k)
    port = {f"{m}/{k}": v for m, st in pexp.digest_states().items() for k, v in _flat(st).items()}
    ref = {f"{m}/{k}": v for m, st in _jax_states(jexp).items() for k, v in _flat(st).items()}
    assert state_divergence(port, ref)["max_leaf_rel"] <= ITER_LEAF_REL
    assert pexp.dis_state.step == 2 and pexp.gan_state.step == 1


@pytest.mark.parametrize("family", ["mnist", "image"])
def test_conditional_labels_are_required_and_checked(jax_cond, family):
    """The body reads the labels: none, or labels of another width, fail
    before anything runs (the JAX iteration fails on the width too)."""
    _, init = jax_cond(family)
    pexp = _port(family, init)
    x, y = _data(family, B, seed=2)
    with pytest.raises(ValueError, match="labels"):
        pexp.train_iteration(x, None)
    with pytest.raises(ValueError, match="width 10"):
        pexp.train_iteration(x, y[:, :7])
    assert pexp.dis_state.step == 0


def test_conditional_checkpoints_cross_both_ways_bit_for_bit(jax_cond, tmp_path):
    jexp, init = jax_cond("mnist")
    _reset_jax(jexp, init)
    x, y = _data("mnist", B, seed=3)
    jexp.train_iteration(x, y)
    jexp.save_models(str(tmp_path / "from_jax"))
    pexp = _port("mnist", init)
    assert pexp.load_models(str(tmp_path / "from_jax")) == 1
    for model, state in pexp.digest_states().items():
        p, r = _flat(state), _flat(_jax_states(jexp)[model])
        assert sorted(p) == sorted(r)
        for key in r:
            np.testing.assert_array_equal(p[key], r[key], err_msg=f"{model}/{key}")
    pexp.train_iteration(x, y)
    pexp.save_models(str(tmp_path / "from_port"))
    assert jexp.load_models(str(tmp_path / "from_port")) == 2
    for model, state in pexp.digest_states().items():
        p, r = _flat(state), _flat(_jax_states(jexp)[model])
        for key in r:
            np.testing.assert_array_equal(p[key], r[key], err_msg=f"{model}/{key}")


# -- conditional serving --------------------------------------------------------------

def _bad_requests(latent, width, classes):
    z = np.zeros((2, latent), np.float32).tolist()
    return [
        ("/v1/sample", {"data": z}),  # bare latent rows
        (f"/v1/sample?class={classes}", {"data": z}),
        ("/v1/sample?class=-1", {"data": z}),
        ("/v1/sample?class=seven", {"data": z}),
        ("/v1/sample?class=1", {"data": np.zeros((2, latent + 1)).tolist()}),
        ("/v1/sample?class=1", {"data": []}),
        ("/v1/classify?class=1", {"data": np.zeros((1, 784)).tolist()}),
        ("/v1/sample", {"data": np.zeros((1, width + 1)).tolist()}),
    ]


@pytest.fixture(scope="module")
def conditional_bundles(jax_cond, tmp_path_factory):
    """A conditional MNIST bundle published by each package after one
    iteration from the same states and draws."""
    jexp, init = jax_cond("mnist")
    _reset_jax(jexp, init)
    x, y = _data("mnist", B, seed=4)
    jexp.train_iteration(x, y)
    out = str(tmp_path_factory.mktemp("cond_bundles"))
    jexp.publish_for_serving(os.path.join(out, "jax"))
    pexp = _port("mnist", init)
    pexp.train_iteration(x, y)
    pexp.publish_for_serving(os.path.join(out, "port"))
    return os.path.join(out, "jax"), os.path.join(out, "port")


@pytest.mark.parametrize("publisher", ["jax", "port"])
def test_a_conditional_bundle_serves_every_class_in_both_packages(conditional_bundles, publisher):
    directory = conditional_bundles[0 if publisher == "jax" else 1]
    with open(os.path.join(directory, "serving.json")) as fh:
        doc = json.load(fh)
    assert doc["z_size"] == 2 and doc["zoo"]["conditioning"] == "class"
    port = ServingEngine.from_bundle(directory, buckets=(4,), device="cpu")
    ref = JaxEngine.from_bundle(directory, buckets=(4,))
    assert port.conditional and port.class_count == ref.class_count == 10
    assert port.latent_width("sample") == ref.latent_width("sample") == 2
    assert port.input_width("sample") == ref.input_width("sample") == 12
    assert port.latent_width("classify") == port.input_width("classify") == 784
    assert manifest.ScenarioManifest.from_dict(port.scenario).to_dict() == ref.scenario_manifest().to_dict()
    psvc, jsvc = InferenceService(port, warmup=False), JaxService(ref, warmup=False)
    rng = np.random.default_rng(7)
    try:
        for k in range(10):
            z = (rng.random((3, 2), dtype=np.float32) * 2 - 1).tolist()
            ps, pbody = psvc.handle("POST", f"/v1/sample?class={k}", {"data": z})
            js, jbody = jsvc.handle("POST", f"/v1/sample?class={k}", {"data": z})
            assert ps == js == 200
            got = np.asarray(pbody["data"], np.float32)
            np.testing.assert_allclose(got, np.asarray(jbody["data"], np.float32), **TOL)
            onehot = np.zeros((3, 10), np.float32)
            onehot[:, k] = 1.0
            assert np.array_equal(got, port.run_host("sample", np.concatenate([z, onehot], axis=1)))
        full = np.concatenate([np.zeros((2, 2)), np.eye(10)[[3, 4]]], axis=1).tolist()
        ps, pbody = psvc.handle("POST", "/v1/sample", {"data": full})
        js, jbody = jsvc.handle("POST", "/v1/sample", {"data": full})
        assert ps == js == 200
        np.testing.assert_allclose(pbody["data"], jbody["data"], **TOL)
        for path, payload in _bad_requests(2, 12, 10):
            ps, pbody = psvc.handle("POST", path, payload)
            js, jbody = jsvc.handle("POST", path, payload)
            assert (ps, pbody["error"]) == (js, jbody["error"]) and ps == 400, path
        ps, pbody = psvc.handle("GET", "/healthz")
        js, jbody = jsvc.handle("GET", "/healthz")
        assert pbody["scenario"] == jbody["scenario"] == doc["zoo"]
    finally:
        psvc.close()
        jsvc.close()
    assert port.serve_compile_counts == {k: 0 for k in port.kinds}


def test_the_declared_width_must_match_the_generator(conditional_bundles, tmp_path):
    directory = str(tmp_path / "b")
    os.makedirs(directory)
    src = conditional_bundles[1]
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as a, open(os.path.join(directory, name), "wb") as b:
            b.write(a.read())
    with open(os.path.join(directory, "serving.json")) as fh:
        doc = json.load(fh)
    doc["zoo"]["z_size"] = 3
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump(doc, fh)
    with pytest.raises(ValueError) as ref:
        JaxEngine.from_bundle(directory, buckets=(4,))
    with pytest.raises(ValueError) as port:
        ServingEngine.from_bundle(directory, buckets=(4,), device="cpu")
    assert str(port.value) == str(ref.value) and "disagree" in str(port.value)


def test_class_on_an_unconditional_bundle_answers_as_jax(conditional_bundles, tmp_path):
    directory = str(tmp_path / "plain")
    os.makedirs(directory)
    src = conditional_bundles[1]
    for name in os.listdir(src):
        with open(os.path.join(src, name), "rb") as a, open(os.path.join(directory, name), "wb") as b:
            b.write(a.read())
    with open(os.path.join(directory, "serving.json")) as fh:
        doc = json.load(fh)
    doc["zoo"]["conditioning"] = "none"
    doc["zoo"]["z_size"] = 12  # the generator's width, now all latent
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump(doc, fh)
    port = ServingEngine.from_bundle(directory, buckets=(4,), device="cpu")
    ref = JaxEngine.from_bundle(directory, buckets=(4,))
    assert not port.conditional and port.class_count == 0 and port.latent_width("sample") == 12
    psvc, jsvc = InferenceService(port, warmup=False), JaxService(ref, warmup=False)
    z = np.zeros((1, 12), np.float32).tolist()
    try:
        for path in ("/v1/sample?class=1", "/v1/sample"):
            ps, pbody = psvc.handle("POST", path, {"data": z})
            js, jbody = jsvc.handle("POST", path, {"data": z})
            assert ps == js
            assert pbody.get("error") == jbody.get("error")
        assert ps == 200
    finally:
        psvc.close()
        jsvc.close()


def test_the_canary_probes_a_conditional_bundle_as_jax_does(conditional_bundles):
    """Base-z latents and a cycling one-hot: the FIDs agree and so do the
    decisions, admitting a bundle against itself and rejecting it under
    bars it cannot meet."""
    jax_dir, port_dir = conditional_bundles
    (x, labels), _ = datasets.load_mnist(num_train=48, num_test=1, seed=1)
    reals, onehot = x, np.eye(10, dtype=np.float32)[labels]
    port = {d: ServingEngine.from_bundle(d, buckets=(8,), device="cpu") for d in (jax_dir, port_dir)}
    ref = {d: JaxEngine.from_bundle(d, buckets=(8,)) for d in (jax_dir, port_dir)}
    for thresholds in ((1.5, 10.0), (0.5, -1.0)):
        pgate = CanaryGate(reals, onehot, num_samples=16, dataset="mnist",
                           thresholds=CanaryThresholds(*thresholds))
        jgate = JaxCanaryGate(reals, onehot, num_samples=16, dataset="mnist",
                              thresholds=JaxThresholds(*thresholds))
        pdec = pgate.evaluate(port[port_dir], port[jax_dir])
        jdec = jgate.evaluate(ref[port_dir], ref[jax_dir])
        assert pdec.passed == jdec.passed
        np.testing.assert_allclose(pdec.candidate["fid"], jdec.candidate["fid"], rtol=1e-3)
        np.testing.assert_allclose(pdec.incumbent["fid"], jdec.incumbent["fid"], rtol=1e-3)
        assert pdec.candidate["accuracy"] == jdec.candidate["accuracy"]
    assert not pdec.passed  # the second bars reject


# -- the registry's extension point ----------------------------------------------------

def test_register_and_unregister_raise_as_jax_does():
    mnist = registry.get("mnist")
    jmnist = jax_registry.get("mnist")
    for name in ("cifar10", "mnist"):
        with pytest.raises(ValueError) as ref:
            jax_registry.register(dataclasses.replace(jmnist, name=name))
        with pytest.raises(ValueError) as port:
            registry.register(dataclasses.replace(mnist, name=name))
        assert str(port.value) == str(ref.value)
    with pytest.raises(ValueError) as ref:
        jax_registry.unregister("image")
    with pytest.raises(ValueError) as port:
        registry.unregister("image")
    assert str(port.value) == str(ref.value)
    mine = dataclasses.replace(mnist, name="mnist_user")
    try:
        assert registry.register(mine) is mine and registry.get("mnist_user") is mine
        assert "mnist_user" in registry.names()
        with pytest.raises(ValueError, match="already registered"):
            registry.register(mine)
        assert registry.register(mine, overwrite=True) is mine
        exp = make_experiment(ExperimentConfig(model_family="mnist_user", batch_size_train=4,
                                               use_accelerator=False, save_models=False))
        assert exp.family is mine
    finally:
        registry.unregister("mnist_user")
    registry.unregister("mnist_user")  # absent: a no-op, as in the JAX package
    with pytest.raises(KeyError):
        registry.get("mnist_user")


# -- the drill --------------------------------------------------------------------------

def _jax_drill_keys():
    """The invariants and result blocks the JAX drill reports, read from its
    source."""
    with open(os.path.join(_REPO, "scripts", "zoo_drill.py")) as fh:
        text = fh.read()
    return (set(re.findall(r'invariants\["(\w+)"\]', text)), set(re.findall(r'results\["(\w+)"\]', text)))


def test_the_port_drill_passes_under_smoke_on_the_cpu(tmp_path, capsys):
    """The drill runs on one intra-op thread: the suite runs several
    workers at once, and with a thread per core in each the CPU is
    oversubscribed (the drill then took 70 s, against 5 s alone)."""
    out = str(tmp_path / "drill.json")
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        t0 = time.perf_counter()
        assert drill.main(["--smoke", "--device", "cpu", "--output", out]) == 0
        assert time.perf_counter() - t0 < 60
    finally:
        torch.set_num_threads(threads)
    with open(out) as fh:
        payload = json.load(fh)
    invariants, blocks = _jax_drill_keys()
    # the JAX drill's invariants, and the int8 variant's zoo block (the
    # port's mux also serves the conditional bundle's int8 variant)
    assert set(payload["invariants"]) == invariants | {"int8_variant_inherits_zoo"}
    assert payload["ok"] and all(payload["invariants"].values())
    assert set(payload["results"]["mux"]["widths"]) == {"cond_mnist", "wgan_cifar", "cond_mnist_int8"}
    assert set(payload["results"]) == blocks
    assert json.loads(capsys.readouterr().out) == payload
    cond = payload["results"]["conditional"]
    assert cond["parity_classes"] == cond["classes"] == 10 and cond["serve_compiles_total"] == 0
    assert payload["config"]["platform"] == "cpu"
    assert not any(name.startswith("BENCH_zoo") and name != "BENCH_zoo_r01.json" for name in os.listdir(_REPO))
