"""PyTorch port, the quality plane: the FID harness (``eval/fid.py``), the
quality probe (``eval/quality.py``) and the canary gate
(``deploy/canary.py``) against the JAX package's, on the CPU.

- FID statistics are float64 numpy in both packages: equal to 1e-10
  relative.
- Feature extractors compare float32 convolutions and dense products whose
  summation order differs: 1e-5 relative to the largest feature.
- ``frozen_feature_fn`` is compared with the reference computed live in
  this process, never with the constant that ``tests/test_eval.py`` pins
  (it was captured on another jax, and the threefry stream moved; ROADMAP.md
  §3). The port draws its kernels from jax's threefry stream computed on
  the host; the JAX package's own draw is pinned in
  ``gan_deeplearning4j_tpu_torch/eval/frozen_kernels.npz``, exported by
  this file: ``PYTHONPATH=. JAX_PLATFORMS=cpu python
  tests/test_torch_canary.py --export-frozen-kernels``.
- The probe and the gate get the same engines' rows: the probe's numbers
  equal the script's, and the gate admits and rejects as the JAX gate does.

Run with ``JAX_PLATFORMS=cpu``.
"""

import json
import os
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gan_deeplearning4j_tpu.deploy import canary as jax_canary
from gan_deeplearning4j_tpu.eval import fid as jax_fid
from gan_deeplearning4j_tpu.nn import DenseLayer as JaxDense
from gan_deeplearning4j_tpu.nn import GraphBuilder as JaxBuilder
from gan_deeplearning4j_tpu.nn import GraphConfig as JaxConfig
from gan_deeplearning4j_tpu.nn import InputType as JaxInputType
from gan_deeplearning4j_tpu.nn import OutputLayer as JaxOutput
from gan_deeplearning4j_tpu.nn.graph import ComputationGraph as JaxGraph
from gan_deeplearning4j_tpu.quant import build_int8_variant as jax_build_int8
from gan_deeplearning4j_tpu.serving import ServingEngine as JaxEngine
from gan_deeplearning4j_tpu.utils import serializer as jax_ser
from gan_deeplearning4j_tpu_torch.deploy import canary as pt_canary
from gan_deeplearning4j_tpu_torch.eval import fid as pt_fid
from gan_deeplearning4j_tpu_torch.eval import quality as pt_quality
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy
from gan_deeplearning4j_tpu_torch.nn.graph import ComputationGraph as PtGraph
from gan_deeplearning4j_tpu_torch.quant import build_int8_variant as pt_build_int8
from gan_deeplearning4j_tpu_torch.serving import ServingEngine
from gan_deeplearning4j_tpu_torch.telemetry.registry import MetricsRegistry, set_registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FROZEN_NPZ = os.path.join(REPO, "gan_deeplearning4j_tpu_torch", "eval", "frozen_kernels.npz")
FEATURE_REL = 1e-5
Z, FEAT, CLASSES, HIDDEN = 4, 6, 3, 5


@pytest.fixture(autouse=True)
def _port_registry():
    previous = set_registry(MetricsRegistry())
    try:
        yield
    finally:
        set_registry(previous)


def _live_frozen_kernels(channels: int, seed: int = 666):
    """The reference's frozen kernels as ``eval/fid.py::frozen_feature_fn``
    draws them on the installed jax."""
    keys = jax.random.split(jax.random.PRNGKey(seed), len(jax_fid._FROZEN_STAGES))
    out, c_in = [], channels
    for key, (c_out, k, _) in zip(keys, jax_fid._FROZEN_STAGES):
        fan_in = k * k * c_in
        out.append(np.asarray(jax.random.normal(key, (k, k, c_in, c_out), jnp.float32)
                              * jnp.sqrt(2.0 / fan_in)))
        c_in = c_out
    return out


def export_frozen_kernels(path: str = FROZEN_NPZ, seed: int = 666, channels=(1, 3)) -> None:
    """Write the port's ``frozen_kernels.npz``: the reference's kernels for
    each channel count, stamped with the jax version and seed."""
    arrays = {}
    for c in channels:
        for i, kernel in enumerate(_live_frozen_kernels(c, seed)):
            arrays[f"c{c}/stage{i}"] = kernel
    stamp = {"jax": jax.__version__, "seed": seed, "channels": list(channels),
             "jax_threefry_partitionable": bool(jax.config.jax_threefry_partitionable),
             "source": "gan_deeplearning4j_tpu/eval/fid.py::frozen_feature_fn",
             "made_by": "PYTHONPATH=. python tests/test_torch_canary.py --export-frozen-kernels"}
    np.savez(path, __stamp__=np.array(json.dumps(stamp)), **arrays)


# -- FID statistics ---------------------------------------------------------------

def _features(seed, n=40, d=12, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)) @ rng.standard_normal((d, d)) * 0.3 + shift).astype(np.float32)


@pytest.mark.parametrize("shift", [0.0, 0.5, 3.0])
def test_fid_from_stats_matches_jax(shift):
    real, fake = _features(1), _features(2, shift=shift)
    pt = pt_fid.fid_from_stats(pt_fid.FeatureStats.from_features(real),
                               pt_fid.FeatureStats.from_features(fake))
    ref = jax_fid.fid_from_stats(jax_fid.FeatureStats.from_features(real),
                                 jax_fid.FeatureStats.from_features(fake))
    assert pt == pytest.approx(ref, rel=1e-10, abs=1e-10)
    np.testing.assert_array_equal(pt_fid._sqrtm_psd(np.cov(real, rowvar=False)),
                                  jax_fid._sqrtm_psd(np.cov(real, rowvar=False)))
    assert pt_fid.fid_score(real, fake) == pytest.approx(jax_fid.fid_score(real, fake), rel=1e-10)


def test_feature_stats_refuse_one_sample():
    with pytest.raises(ValueError, match="2 samples"):
        pt_fid.FeatureStats.from_features(np.zeros((1, 3), np.float32))


# -- feature extractors -----------------------------------------------------------

def _tiny_jax_classifier():
    b = JaxBuilder(JaxConfig(seed=2))
    b.add_inputs("x").set_input_types(JaxInputType.feed_forward(FEAT))
    b.add_layer("feat_1", JaxDense(n_out=HIDDEN, activation="tanh"), "x")
    b.add_layer("cv_out", JaxOutput(n_out=CLASSES, activation="softmax", loss="mcxent"), "feat_1")
    b.set_outputs("cv_out")
    return b.build()


def _tiny_jax_generator():
    b = JaxBuilder(JaxConfig(seed=1))
    b.add_inputs("z").set_input_types(JaxInputType.feed_forward(Z))
    b.add_layer("g_dense_1", JaxDense(n_out=8, activation="tanh"), "z")
    b.add_layer("g_out", JaxOutput(n_out=FEAT, activation="sigmoid", loss="xent"), "g_dense_1")
    b.set_outputs("g_out")
    return b.build()


def _numpy_tree(params):
    return {k: {n: np.asarray(v) for n, v in lp.items()} for k, lp in params.items()}


def test_graph_feature_fn_matches_jax():
    jax_cv = _tiny_jax_classifier()
    tree = _numpy_tree(jax_cv.init())
    pt_cv = PtGraph.from_dict(json.loads(json.dumps(jax_cv.to_dict())))
    rows = np.random.default_rng(4).random((23, FEAT), dtype=np.float32)
    ref = jax_fid.graph_feature_fn(jax_cv, jax.tree_util.tree_map(jnp.asarray, tree), "feat_1",
                                   batch_size=8)(rows)
    pt = pt_fid.graph_feature_fn(pt_cv, params_from_numpy(tree, "cpu", graph=pt_cv), "feat_1",
                                 batch_size=8)(rows)
    assert pt.shape == ref.shape == (23, HIDDEN)
    np.testing.assert_allclose(pt, ref, rtol=0, atol=FEATURE_REL * np.abs(ref).max())


@pytest.mark.parametrize("height,width,channels", [(28, 28, 1), (8, 8, 3), (7, 9, 1)])
def test_frozen_feature_fn_matches_the_live_reference(height, width, channels):
    """(7, 9) pads unevenly: TensorFlow's SAME puts the odd pixel after."""
    rows = np.random.default_rng(5).random((11, height * width * channels), dtype=np.float32)
    ref = jax_fid.frozen_feature_fn(height, width, channels, batch_size=4)(rows)
    pt_fn = pt_fid.frozen_feature_fn(height, width, channels, batch_size=4, device="cpu")
    pt = pt_fn(rows)
    assert pt.shape == ref.shape == (11, 224)
    np.testing.assert_allclose(pt, ref, rtol=0, atol=FEATURE_REL * np.abs(ref).max())
    # images in NHWC give the same features as flat rows
    images = rows.reshape(11, height, width, channels)
    np.testing.assert_array_equal(pt_fn(images), pt)


def test_committed_frozen_kernels_are_the_live_references():
    """The pin is the reference's draw bit for bit; the port's own draw
    (``runtime/threefry.py``) is held to it within 1e-6 relative."""
    stamp = pt_fid.frozen_kernels_stamp()
    assert stamp["jax"] == jax.__version__ and stamp["seed"] == 666 and stamp["channels"] == [1, 3]
    for c in (1, 3):
        for pinned, mine, live in zip(pt_fid.pinned_frozen_kernels(c), pt_fid.frozen_kernels(c),
                                      _live_frozen_kernels(c)):
            assert pinned.dtype == mine.dtype == live.dtype == np.float32
            np.testing.assert_array_equal(pinned, live)
            np.testing.assert_allclose(mine, live, rtol=1e-6, atol=0)


@pytest.mark.parametrize("kwargs", [{"seed": 7}, {"channels": 2}])
def test_frozen_feature_fn_refuses_what_was_not_exported(kwargs):
    """Another seed or channel count was refused until the port drew the
    kernels itself: now it is served, equal to the live reference's."""
    channels = kwargs.get("channels", 1)
    rows = np.random.default_rng(5).random((6, 8 * 8 * channels), dtype=np.float32)
    ref = jax_fid.frozen_feature_fn(8, 8, batch_size=4, **kwargs)(rows)
    pt = pt_fid.frozen_feature_fn(8, 8, batch_size=4, device="cpu", **kwargs)(rows)
    assert pt.shape == ref.shape == (6, 224)
    np.testing.assert_allclose(pt, ref, rtol=0, atol=FEATURE_REL * np.abs(ref).max())


# -- the probe --------------------------------------------------------------------

def _gen_rows(z):
    """A deterministic numpy 'generator': z (n, Z) -> rows (n, FEAT) in [0, 1]."""
    w = np.linspace(-1.0, 1.0, Z * FEAT, dtype=np.float32).reshape(Z, FEAT)
    return 1.0 / (1.0 + np.exp(-(np.asarray(z, np.float32) @ w)))


@pytest.mark.parametrize("with_classifier", [False, True])
def test_quality_probe_matches_the_scripts(with_classifier):
    script_probe = jax_canary.load_quality_probe()
    real = np.random.default_rng(6).random((30, FEAT), dtype=np.float32)
    labels = np.random.default_rng(7).integers(0, CLASSES, 30)
    probs = lambda rows: np.eye(CLASSES)[(rows.sum(axis=1) * 7).astype(int) % CLASSES]  # noqa: E731
    kwargs = dict(z_size=Z, num_samples=24, seed=9,
                  classify_fn=probs if with_classifier else None,
                  labels=labels if with_classifier else None)
    ref = script_probe(_gen_rows, real, **kwargs)
    pt = pt_quality.quality_probe(_gen_rows, real, **kwargs)
    assert pt == ref
    with pytest.raises(ValueError, match="num_samples"):
        pt_quality.quality_probe(_gen_rows, real, z_size=Z, num_samples=1)


def test_sample_generator_rows_draws_the_scripts_stream():
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import quality_run
    finally:
        sys.path.pop(0)
    ref = quality_run.sample_generator_rows(lambda z: _gen_rows(np.asarray(z)), Z, 10, 3,
                                            batch_size=4)
    pt = pt_quality.sample_generator_rows(lambda z: torch.from_numpy(_gen_rows(z.numpy())),
                                          Z, 10, 3, batch_size=4, device="cpu")
    np.testing.assert_array_equal(pt, ref)


# -- the decision -----------------------------------------------------------------

@pytest.mark.parametrize("cand,inc", [
    ({"fid": 10.0, "accuracy": 0.9}, {"fid": 9.0, "accuracy": 0.92}),
    ({"fid": 100.0, "accuracy": 0.9}, {"fid": 9.0, "accuracy": 0.9}),
    ({"fid": 10.0, "accuracy": 0.5}, {"fid": 9.0, "accuracy": 0.9}),
    ({"fid": float("nan"), "accuracy": None}, {"fid": 9.0, "accuracy": 0.9}),
    ({"fid": 80.0, "accuracy": 0.1}, {"fid": 9.0, "accuracy": None}),
])
def test_compare_probes_decides_as_jax(cand, inc):
    pt = pt_canary.compare_probes(cand, inc)
    ref = jax_canary.compare_probes(cand, inc)
    assert (pt.passed, pt.reason) == (ref.passed, ref.reason)
    t = dict(fid_ratio_max=1.1, fid_slack=0.0, accuracy_drop_max=0.01)
    pt = pt_canary.compare_probes(cand, inc, pt_canary.CanaryThresholds(**t))
    ref = jax_canary.compare_probes(cand, inc, jax_canary.CanaryThresholds(**t))
    assert (pt.passed, pt.reason) == (ref.passed, ref.reason)


def _confident_bundle(directory):
    """The tiny fp32 bundle of tests/test_quant.py (classifier weights drawn
    wide, so int8 rounding flips no argmax), written by the JAX serializer."""
    os.makedirs(directory, exist_ok=True)
    gen, cv = _tiny_jax_generator(), _tiny_jax_classifier()
    rng = np.random.default_rng(7)
    cv_tree = jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(np.shape(a)).astype(np.float32) * 2.0
                   if np.ndim(a) == 2 else np.asarray(a)), cv.init())
    jax_ser.write_model(os.path.join(directory, "gen.zip"), gen, gen.init(), save_updater=False)
    jax_ser.write_model(os.path.join(directory, "cv.zip"), cv, cv_tree, save_updater=False)
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump({"format_version": 1, "generator": "gen.zip", "classifier": "cv.zip",
                   "feature_vertex": "feat_1", "generation": 0, "step": 0}, fh)
    return directory


@pytest.fixture(scope="module")
def gate_bundles(tmp_path_factory):
    """fp32, sane int8 and over-degraded int8 (calibrated on rows × 1e9)
    bundles, each int8 built by both packages from the same fp32 bundle, and
    48 rows labelled by the fp32 incumbent (tests/test_quant.py:325-357)."""
    root = tmp_path_factory.mktemp("gate")
    src = _confident_bundle(str(root / "fp32"))
    set_registry(MetricsRegistry())
    rows = np.random.default_rng(11).random((48, FEAT)).astype(np.float32)
    labels = np.argmax(np.asarray(JaxEngine.from_bundle(src).run("classify", rows)), axis=1)
    out = {"fp32": src, "rows": rows, "labels": labels}
    for tag, calib in (("sane", rows), ("degraded", rows * 1e9)):
        out[f"jax_{tag}"] = str(root / f"jax_{tag}")
        jax_build_int8(src, out[f"jax_{tag}"], calibration_rows=calib)
        out[f"pt_{tag}"] = str(root / f"pt_{tag}")
        pt_build_int8(src, out[f"pt_{tag}"], calibration_rows=calib, device="cpu")
    return out


@pytest.mark.parametrize("tag", ["sane", "degraded"])
@pytest.mark.parametrize("builder", ["jax", "pt"])
def test_canary_admits_and_rejects_as_the_jax_gate(gate_bundles, tag, builder):
    b = gate_bundles
    variant = b[f"{builder}_{tag}"]
    pt_gate = pt_canary.CanaryGate(b["rows"], b["labels"], num_samples=16, seed=1)
    pt_decision = pt_gate.evaluate(ServingEngine.from_bundle(variant, device="cpu"),
                                   ServingEngine.from_bundle(b["fp32"], device="cpu"))
    jax_gate = jax_canary.CanaryGate(b["rows"], b["labels"], num_samples=16, seed=1)
    ref = jax_gate.evaluate(JaxEngine.from_bundle(variant), JaxEngine.from_bundle(b["fp32"]))
    assert (pt_decision.passed, pt_decision.reason) == (ref.passed, ref.reason)
    assert pt_decision.passed == (tag == "sane")
    if tag == "degraded":
        assert "accuracy" in pt_decision.reason
    for side in ("candidate", "incumbent"):
        mine, theirs = getattr(pt_decision, side), getattr(ref, side)
        assert mine["accuracy"] == theirs["accuracy"]
        assert mine["fid"] == pytest.approx(theirs["fid"], rel=1e-5)


def test_the_gate_caches_the_incumbent_and_rolls_it_forward(gate_bundles):
    b = gate_bundles
    calls = []

    def probe(engine):
        calls.append(engine)
        return {"fid": 1.0, "accuracy": 1.0}

    gate = pt_canary.CanaryGate(b["rows"], b["labels"], probe=probe)
    inc, cand = object(), object()
    assert gate.evaluate(cand, inc).passed
    assert calls == [inc, cand]
    gate.evaluate(object(), cand)  # the admitted candidate is the cached incumbent
    assert len(calls) == 3 and calls[2] is not cand


def test_the_gate_fails_closed_across_datasets(gate_bundles):
    b = gate_bundles

    class _Engine:
        scenario = {"dataset": "fashion_mnist"}

    gate = pt_canary.CanaryGate(b["rows"], b["labels"], dataset="mnist",
                                probe=lambda e: pytest.fail("probed"))
    decision = gate.evaluate(_Engine(), object())
    assert not decision.passed and "fashion_mnist" in decision.reason
    with pytest.raises(ValueError, match="n >= 2"):
        pt_canary.CanaryGate(np.zeros((1, FEAT)))


def test_dis_feature_space_from_a_bundle_matches_jax(gate_bundles):
    b = gate_bundles
    for bundle in (b["fp32"], b["pt_sane"]):
        path, vertex = pt_canary.classifier_from_bundle(bundle)
        assert (path, vertex) == jax_canary.classifier_from_bundle(bundle)
        rows = b["rows"][:9]
        pt = pt_canary.feature_fn_from_checkpoint(path, vertex, device="cpu")(rows)
        ref = jax_canary.feature_fn_from_checkpoint(path, vertex)(rows)
        # the int8 bundle's first layer quantizes the same input bits in both
        np.testing.assert_allclose(pt, ref, rtol=0, atol=FEATURE_REL * np.abs(ref).max())
    with pytest.raises(ValueError, match="not a vertex"):
        pt_canary.feature_fn_from_checkpoint(path, "nope", device="cpu")
    gen_only = os.path.join(os.path.dirname(b["fp32"]), "gen_only")
    os.makedirs(gen_only, exist_ok=True)
    with open(os.path.join(gen_only, "serving.json"), "w") as fh:
        json.dump({"format_version": 1, "generator": "gen.zip"}, fh)
    assert pt_canary.classifier_from_bundle(gen_only) is None


if __name__ == "__main__":
    if sys.argv[1:] == ["--export-frozen-kernels"]:
        jax.config.update("jax_platforms", "cpu")
        export_frozen_kernels()
        print(f"wrote {FROZEN_NPZ}")
    else:
        sys.exit("usage: python tests/test_torch_canary.py --export-frozen-kernels")
