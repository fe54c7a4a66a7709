"""PyTorch port, checkpoints: the port reads and writes the JAX package's
zip format (``topology.json`` + ``arrays.npz`` + ``meta.json`` with member
digests, bf16 as tagged uint16) in both directions.

A zip written by JAX and read by the port serves the same outputs (1e-5,
float32 on the CPU on both sides); a zip written by the port is read by the
JAX ``read_model`` bit for bit; damaged files raise ``ValueError``.
"""

import json
import types
import zipfile

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gan_deeplearning4j_tpu.models import dcgan_mnist as jax_models
from gan_deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as pt_models
from gan_deeplearning4j_tpu_torch.nn import DenseLayer, GraphBuilder, GraphConfig, InputType, OutputLayer
from gan_deeplearning4j_tpu_torch.utils import serializer as pt_ser

TOL = dict(rtol=1e-5, atol=1e-5)


def _random_tree(shapes, seed):
    rng = np.random.default_rng(seed)
    return {
        layer: {
            name: (rng.uniform(0.5, 1.5, shape) if name in ("gamma", "var")
                   else rng.standard_normal(shape) * 0.05).astype(np.float32)
            for name, shape in leaves.items()
        }
        for layer, leaves in shapes.items()
    }


def _tiny_graph():
    b = GraphBuilder(GraphConfig(seed=5))
    b.add_inputs("x").set_input_types(InputType.feed_forward(6))
    b.add_layer("h", DenseLayer(n_out=5), "x")
    b.add_layer("out", OutputLayer(n_out=3, activation="softmax", loss="mcxent"), "h")
    b.set_outputs("out")
    return b.build()


def _bits(t):
    if isinstance(t, torch.Tensor):
        return t.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(t).view(np.uint16)


def test_jax_written_generator_serves_same_outputs_in_port(tmp_path):
    jax_gen = jax_models.build_generator()
    tree = _random_tree(pt_models.build_generator().param_shapes(), seed=1)
    path = str(tmp_path / "gen.zip")
    jax_ser.write_model(path, jax_gen, tree, save_updater=False)
    graph, params, opt_state, step = pt_ser.read_model(path, device="cpu")
    assert opt_state is None and step == 0
    z = np.random.default_rng(2).standard_normal((4, 2)).astype(np.float32)
    out = graph.output(params, torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(out, np.asarray(jax_gen.output(tree, z)), **TOL)
    for layer, leaves in tree.items():
        for name, value in leaves.items():
            assert np.array_equal(params[layer][name].numpy(), value)


def test_port_written_classifier_reads_in_jax(tmp_path):
    dis = pt_models.build_discriminator()
    cv, _ = pt_models.build_transfer_classifier(dis, dis.init(device="cpu"))
    tree = _random_tree(cv.param_shapes(), seed=3)
    params = {k: {n: torch.from_numpy(v) for n, v in leaves.items()} for k, leaves in tree.items()}
    state = types.SimpleNamespace(
        params=params,
        opt_state={"dis_batch": {"gamma": {"cache": torch.full((1024,), 1e-8)}}},
        step=7,
    )
    path = str(tmp_path / "cv.zip")
    pt_ser.write_model(path, cv, state)
    jax_graph, jax_params, jax_opt, step = jax_ser.read_model(path)
    assert step == 7
    assert json.loads(json.dumps(jax_graph.to_dict())) == json.loads(json.dumps(cv.to_dict()))
    for layer, leaves in tree.items():
        for name, value in leaves.items():
            assert np.array_equal(np.asarray(jax_params[layer][name]), value)
    np.testing.assert_array_equal(np.asarray(jax_opt["dis_batch"]["gamma"]["cache"]),
                                  np.full(1024, 1e-8, np.float32))
    x = np.random.default_rng(4).random((3, 784), dtype=np.float32)
    np.testing.assert_allclose(cv.output(params, torch.from_numpy(x)).numpy(),
                               np.asarray(jax_graph.output(jax_params, x)), **TOL)
    # and the port reads its own file back, updater state included
    _, params2, opt2, step2 = pt_ser.read_model(path, device="cpu")
    assert step2 == 7 and torch.equal(opt2["dis_batch"]["gamma"]["cache"], torch.full((1024,), 1e-8))
    assert torch.equal(params2["dis_batch"]["var"], params["dis_batch"]["var"])



def test_stored_port_checkpoints_load_in_jax(tmp_path):
    """The port writes checkpoint and mesh-shard members ``ZIP_STORED``
    (float arrays do not compress); the JAX reader loads both, and the
    member digests are of the same uncompressed bytes."""
    graph = _tiny_graph()
    tree = _random_tree(graph.param_shapes(), seed=9)
    params = {k: {n: torch.from_numpy(v) for n, v in leaves.items()} for k, leaves in tree.items()}
    state = types.SimpleNamespace(params=params, opt_state={"h": {"W": {"cache": params["h"]["W"] * 2}}},
                                  step=3)
    path = str(tmp_path / "m.zip")
    pt_ser.write_model(path, graph, state)
    shard = str(tmp_path / "shard.zip")
    flat = {"dis/params/h/W": params["h"]["W"], "dis/step": np.asarray(3, np.int32)}
    pt_ser.write_state_shard(shard, flat, meta={"shard_index": 0, "shard_count": 1})
    for name in (path, shard):
        with zipfile.ZipFile(name) as zf:
            assert {i.compress_type for i in zf.infolist()} == {zipfile.ZIP_STORED}
    _, jax_params, jax_opt, step = jax_ser.read_model(path)
    assert step == 3
    for layer, leaves in tree.items():
        for name, value in leaves.items():
            assert np.array_equal(np.asarray(jax_params[layer][name]), value)
    np.testing.assert_array_equal(np.asarray(jax_opt["h"]["W"]["cache"]), tree["h"]["W"] * 2)
    arrays, meta = jax_ser.read_state_shard(shard)
    assert np.array_equal(arrays["dis/params/h/W"], tree["h"]["W"])
    assert int(arrays["dis/step"]) == 3 and meta["shard_count"] == 1

def test_member_digest_matches_jax():
    assert pt_ser.member_digest(b"abc") == jax_ser.member_digest(b"abc")


@pytest.mark.parametrize("damage", ["flip", "truncate", "missing_member"])
def test_damaged_checkpoint_raises_value_error(tmp_path, damage):
    graph = _tiny_graph()
    path = tmp_path / "m.zip"
    pt_ser.write_model(str(path), graph, graph.init(device="cpu"))
    data = bytearray(path.read_bytes())
    if damage == "flip":
        with zipfile.ZipFile(path) as zf:
            info = zf.getinfo("arrays.npz")
        data[info.header_offset + 60] ^= 0xFF  # inside the npz member's bytes
    elif damage == "truncate":
        data = data[: len(data) // 2]
    else:
        with zipfile.ZipFile(path) as zf, zipfile.ZipFile(tmp_path / "x.zip", "w") as out:
            for name in ("topology.json", "meta.json"):
                out.writestr(name, zf.read(name))
        data = (tmp_path / "x.zip").read_bytes()
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        pt_ser.read_model(str(path), device="cpu")


def test_bf16_leaves_round_trip_both_ways(tmp_path):
    graph = _tiny_graph()
    jax_graph = JaxGraph.from_dict(json.loads(json.dumps(graph.to_dict())))
    tree = _random_tree(graph.param_shapes(), seed=9)
    jax_tree = {k: {n: jnp.asarray(v, jnp.bfloat16) for n, v in leaves.items()} for k, leaves in tree.items()}

    path = str(tmp_path / "jax_bf16.zip")
    jax_ser.write_model(path, jax_graph, jax_tree, save_updater=False)
    _, params, _, _ = pt_ser.read_model(path, device="cpu")
    for layer, leaves in jax_tree.items():
        for name, value in leaves.items():
            assert params[layer][name].dtype == torch.bfloat16
            np.testing.assert_array_equal(_bits(params[layer][name]), _bits(value))

    path2 = str(tmp_path / "port_bf16.zip")
    pt_ser.write_model(path2, graph, params)
    with zipfile.ZipFile(path2) as zf:
        meta = json.loads(zf.read("meta.json"))
    assert meta["array_dtypes"]["params/h/W"] == "bfloat16"
    _, jax_params, _, _ = jax_ser.read_model(path2)
    for layer, leaves in jax_tree.items():
        for name, value in leaves.items():
            assert jax_params[layer][name].dtype == jnp.bfloat16
            np.testing.assert_array_equal(_bits(jax_params[layer][name]), _bits(value))
