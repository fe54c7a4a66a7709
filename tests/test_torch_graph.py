"""PyTorch port, graph layer: the full-width DCGAN-MNIST ``gen`` (~6.7M
params) and transfer classifier ``cv`` (~1.4M params) against the JAX
package's, at batch 4, with the same params handed to both.

Params are drawn with numpy (the two packages' RNGs differ) with non-trivial
BatchNorm statistics, and carried into the port by ``params_from_numpy``.
Tolerance: 1e-5 absolute and relative (float32 on the CPU on both sides;
only the summation order differs).
"""

import json

import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.models import dcgan_mnist as jax_models
from gan_deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as pt_models
from gan_deeplearning4j_tpu_torch.nn import layers as pt_layers
from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph as PtGraph

TOL = dict(rtol=1e-5, atol=1e-5)


def random_params(shapes, seed):
    """``{layer: {name: ndarray}}`` for a graph's param shapes: Xavier-scaled
    weights, small biases, BatchNorm gains/variances in [0.5, 1.5]."""
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


@pytest.fixture(scope="module")
def graphs():
    jax_gen = jax_models.build_generator()
    jax_dis = jax_models.build_discriminator()
    jax_cv, _ = jax_models.build_transfer_classifier(jax_dis, jax_dis.init())
    pt_gen = pt_models.build_generator()
    pt_dis = pt_models.build_discriminator()
    pt_cv, _ = pt_models.build_transfer_classifier(pt_dis, pt_dis.init(device="cpu"))
    return {"gen": (jax_gen, pt_gen), "cv": (jax_cv, pt_cv)}


def _norm(d):
    return json.loads(json.dumps(d))


@pytest.mark.parametrize("name", ["gen", "cv"])
def test_topology_round_trips_between_packages(graphs, name):
    jax_graph, pt_graph = graphs[name]
    assert _norm(pt_graph.to_dict()) == _norm(jax_graph.to_dict())
    # each package builds the other's topology.json into the same graph
    assert _norm(PtGraph.from_dict(_norm(jax_graph.to_dict())).to_dict()) == _norm(jax_graph.to_dict())
    assert _norm(JaxGraph.from_dict(_norm(pt_graph.to_dict())).to_dict()) == _norm(pt_graph.to_dict())


@pytest.mark.parametrize("name,count", [("gen", 6663433), ("cv", 1401614)])
def test_param_shapes_and_count_match_jax(graphs, name, count):
    jax_graph, pt_graph = graphs[name]
    jax_shapes = {
        layer: {k: tuple(v.shape) for k, v in leaves.items()}
        for layer, leaves in jax_graph.param_shapes().items()
    }
    assert pt_graph.param_shapes() == jax_shapes
    assert pt_graph.param_count() == jax_graph.param_count() == count


def test_generator_output_matches_jax(graphs):
    jax_gen, pt_gen = graphs["gen"]
    tree = random_params(pt_gen.param_shapes(), seed=11)
    z = np.random.default_rng(12).standard_normal((4, 2)).astype(np.float32)
    ref = np.asarray(jax_gen.output(tree, z))
    out = pt_gen.output(params_from_numpy(tree, "cpu", graph=pt_gen), torch.from_numpy(z))
    assert out.shape == (4, 28, 28, 1)
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


@pytest.mark.parametrize("vertex", ["dis_output_layer_7", "dis_dense_layer_6"])
def test_classifier_output_and_features_match_jax(graphs, vertex):
    jax_cv, pt_cv = graphs["cv"]
    tree = random_params(pt_cv.param_shapes(), seed=21)
    x = np.random.default_rng(22).random((4, 784), dtype=np.float32)
    params = params_from_numpy(tree, "cpu", graph=pt_cv)
    if vertex == "dis_output_layer_7":
        ref, out = np.asarray(jax_cv.output(tree, x)), pt_cv.output(params, torch.from_numpy(x))
        np.testing.assert_allclose(out.sum(-1).numpy(), 1.0, atol=1e-5)
    else:
        ref = np.asarray(jax_cv.feed_forward(tree, x)[vertex])
        out = pt_cv.feed_forward(params, torch.from_numpy(x))[vertex]
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_transfer_classifier_freezes_features_and_carries_params():
    dis = pt_models.build_discriminator()
    dis_params = dis.init(device="cpu")
    cv, cv_params = pt_models.build_transfer_classifier(dis, dis_params)
    assert cv.vertex("dis_dense_layer_6").layer.updater.learning_rate == 0.0
    assert cv.vertex("dis_output_layer_7").layer.updater.learning_rate == 0.002
    assert cv.vertex("dis_output_layer_7").layer.n_out == 10
    assert cv_params["dis_conv2d_layer_2"]["W"] is dis_params["dis_conv2d_layer_2"]["W"]
    assert set(cv_params) == set(cv.param_shapes())


def test_init_is_seeded_and_shaped():
    gen = pt_models.build_generator()
    a, b = gen.init(device="cpu"), gen.init(device="cpu")
    c = gen.init(seed=1, device="cpu")
    for layer, leaves in gen.param_shapes().items():
        for name, shape in leaves.items():
            assert tuple(a[layer][name].shape) == shape
            assert torch.equal(a[layer][name], b[layer][name])
    assert not torch.equal(a["gen_dense_layer_3"]["W"], c["gen_dense_layer_3"]["W"])


def test_params_from_numpy_checks_keys_shapes_and_dtypes():
    gen = pt_models.build_generator()
    tree = random_params(gen.param_shapes(), seed=3)
    with pytest.raises(KeyError, match="missing"):
        params_from_numpy({k: v for k, v in tree.items() if k != "gen_batch_1"}, "cpu", graph=gen)
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy({**tree, "bogus": {}}, "cpu", graph=gen)
    with pytest.raises(KeyError, match="extra"):
        params_from_numpy({**tree, "gen_batch_1": {**tree["gen_batch_1"], "x": np.zeros(2)}},
                          "cpu", graph=gen)
    bad = {**tree, "gen_conv2d_6": {**tree["gen_conv2d_6"], "W": np.zeros((5, 5, 64, 128), np.float32)}}
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(bad, "cpu", graph=gen)
    bad = {**tree, "gen_conv2d_6": {**tree["gen_conv2d_6"], "b": np.zeros(64, np.int32)}}
    with pytest.raises(ValueError, match="dtype"):
        params_from_numpy(bad, "cpu", graph=gen)
    params = params_from_numpy(tree, "cpu", graph=gen)
    assert np.array_equal(params["gen_dense_layer_3"]["W"].numpy(), tree["gen_dense_layer_3"]["W"])


def test_training_mode_and_unported_layers_raise():
    # train=True runs now (tests/test_torch_train.py), a dropout layer
    # builds (tests/test_torch_family_ops.py) and so does QuantDenseLayer; a
    # topology with a vertex the port lacks still refuses to build, naming
    # its ROADMAP item
    topology = pt_models.build_generator().to_dict()
    topology["nodes"][1]["layer"] = {"type": "DropoutLayer", "rate": 0.5}
    assert isinstance(PtGraph.from_dict(topology).vertices[1].layer, pt_layers.DropoutLayer)
    topology["nodes"][1] = {"name": "merge", "inputs": ["gen_batch_1"],
                            "vertex": {"type": "MergeVertex"}}
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1, 'Other families'"):
        PtGraph.from_dict(topology)
    # the int8 QuantDenseLayer builds, resolved lazily from quant/layers.py
    quant = pt_layers.layer_from_dict({"type": "QuantDenseLayer", "n_out": 4, "act_scale": 0.5})
    assert type(quant).__name__ == "QuantDenseLayer" and quant.act_scale == 0.5
    assert pt_layers.layer_from_dict(quant.to_dict()) == quant
    with pytest.raises(KeyError, match="unknown layer type"):
        pt_layers.layer_from_dict({"type": "Bogus"})
