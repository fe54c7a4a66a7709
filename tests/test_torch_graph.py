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
    # topology with a combining vertex builds as it does in the JAX package
    topology = pt_models.build_generator().to_dict()
    topology["nodes"][1]["layer"] = {"type": "DropoutLayer", "rate": 0.5}
    assert isinstance(PtGraph.from_dict(topology).vertices[1].layer, pt_layers.DropoutLayer)
    topology = pt_models.build_generator().to_dict()
    topology["nodes"].insert(1, {"name": "merge", "inputs": ["gen_batch_1", "gen_batch_1"],
                                 "vertex": {"type": "MergeVertex"}})
    topology["nodes"][2]["inputs"] = ["merge"]
    port, ref = PtGraph.from_dict(topology), JaxGraph.from_dict(_norm(topology))
    assert _norm(port.to_dict()) == _norm(ref.to_dict())
    assert port.param_shapes()["gen_dense_layer_2"]["W"] == (4, 1024)
    assert port.layer_names() == ref.layer_names() and "merge" not in port.layer_names()
    # the int8 QuantDenseLayer builds, resolved lazily from quant/layers.py
    quant = pt_layers.layer_from_dict({"type": "QuantDenseLayer", "n_out": 4, "act_scale": 0.5})
    assert type(quant).__name__ == "QuantDenseLayer" and quant.act_scale == 0.5
    assert pt_layers.layer_from_dict(quant.to_dict()) == quant
    with pytest.raises(KeyError, match="unknown layer type"):
        pt_layers.layer_from_dict({"type": "Bogus"})


# -- combining vertices -----------------------------------------------------------

def _vertex_graph(kind):
    """A small graph with a combining vertex, built by the JAX package:
    two dense branches (or two conv branches) on one input, combined, then
    an output layer."""
    from gan_deeplearning4j_tpu.nn import graph as jg
    from gan_deeplearning4j_tpu.nn import layers as jl
    from gan_deeplearning4j_tpu.nn.input_type import InputType as JaxInputType

    b = jg.GraphBuilder(jg.GraphConfig(seed=3, l2=1e-4))
    b.add_inputs("x")
    if kind == "merge_cnn":
        b.set_input_types(JaxInputType.convolutional_flat(6, 6, 2))
        b.add_layer("c1", jl.ConvolutionLayer(kernel=3, n_out=3), "x")
        b.add_layer("c2", jl.ConvolutionLayer(kernel=3, n_out=2), "x")
        b.add_vertex("combine", jg.MergeVertex(), "c1", "c2")
    else:
        b.set_input_types(JaxInputType.feed_forward(5))
        b.add_layer("d1", jl.DenseLayer(n_out=4), "x")
        b.add_layer("d2", jl.DenseLayer(n_out=4, activation="sigmoid"), "x")
        vertex = jg.MergeVertex() if kind == "merge" else jg.ElementWiseVertex(kind)
        b.add_vertex("combine", vertex, "d1", "d2", *(("d1",) if kind == "product" else ()))
    b.add_layer("out", jl.OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "combine")
    b.set_outputs("out")
    return b.build()


@pytest.mark.parametrize("kind", ["merge", "merge_cnn", "add", "subtract", "product"])
def test_combining_vertices_match_jax_forward_and_gradients(kind):
    """``MergeVertex`` (feature and channel concatenation) and
    ``ElementWiseVertex`` (add, subtract, and a three-input product): the
    topology crosses between the packages, and outputs, loss and every
    param gradient agree within 1e-5; the vertex owns no params."""
    import jax

    jgraph = _vertex_graph(kind)
    port = PtGraph.from_dict(_norm(jgraph.to_dict()))
    assert _norm(port.to_dict()) == _norm(jgraph.to_dict())
    assert port.layer_names() == jgraph.layer_names() and "combine" not in port.layer_names()
    assert port.vertex("combine").out_type.to_dict() == jgraph.vertex("combine").out_type.to_dict()
    assert "combine" not in port.param_shapes() and "(" + type(port.vertex("combine").vertex).__name__ in \
        port.summary()
    tree = random_params({k: dict(v) for k, v in port.param_shapes().items()}, 4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((4, port.input_types[0].features)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[rng.integers(0, 3, 4)]
    (jloss, _), jgrads = jax.value_and_grad(lambda p: jgraph.loss(p, x, y), has_aux=True)(tree)
    params = params_from_numpy(tree, "cpu", graph=port)
    leaves = [t.requires_grad_(True) for lp in params.values() for t in lp.values()]
    ploss, (outs, _) = port.loss(params, torch.from_numpy(x), torch.from_numpy(y))
    grads = torch.autograd.grad(ploss, leaves)
    np.testing.assert_allclose(float(ploss.detach()), float(jloss), **TOL)
    np.testing.assert_allclose(outs["out"].detach().numpy(), np.asarray(jgraph.output(tree, x)), **TOL)
    want = [np.asarray(jgrads[layer][name]) for layer, lp in params.items() for name in lp]
    for got, ref in zip(grads, want):
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


def test_vertex_errors_match_jax():
    from gan_deeplearning4j_tpu.nn import graph as jg
    from gan_deeplearning4j_tpu.nn.input_type import InputType as JaxInputType
    from gan_deeplearning4j_tpu_torch.nn import graph as pg
    from gan_deeplearning4j_tpu_torch.nn.input_type import InputType

    for mod, it in ((jg, JaxInputType), (pg, InputType)):
        with pytest.raises(ValueError, match="incompatible input kinds"):
            mod.MergeVertex().output_type([it.feed_forward(3), it.convolutional(2, 2, 1)])
        with pytest.raises(ValueError, match="unknown elementwise op 'max'"):
            mod.ElementWiseVertex("max").apply([np.ones(2), np.ones(2)] if mod is jg
                                               else [torch.ones(2), torch.ones(2)])
        with pytest.raises(KeyError, match="unknown vertex type 'Bogus'"):
            mod._vertex_from_dict({"type": "Bogus"})
        b = mod.GraphBuilder().add_inputs("x")
        with pytest.raises(ValueError, match="duplicate name 'x'"):
            b.add_vertex("x", mod.MergeVertex(), "x")
