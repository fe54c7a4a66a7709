"""PyTorch port, the eval surface: the frozen extractor's kernels for any seed,
the Inception-schema interpreter, the quick-FID tracker, in-process
accuracy and the quality run, against the JAX package on the CPU.

Tolerances:
- frozen kernels drawn by the port (``runtime/threefry.py``) against the
  JAX package's own draw pinned in ``frozen_kernels.npz``: 1e-6 relative;
- features (frozen and Inception-schema): 1e-5 relative to the largest
  feature (float32 convolutions, another summation order);
- quick FID: 1e-3 relative;
- accuracy: equal.

Run with ``JAX_PLATFORMS=cpu``.
"""

import ast
import json
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from gan_deeplearning4j_tpu.eval import accuracy as jax_accuracy
from gan_deeplearning4j_tpu.eval import fid as jax_fid
from gan_deeplearning4j_tpu.models import dcgan_mnist as jax_models
from gan_deeplearning4j_tpu_torch.eval import accuracy as pt_accuracy
from gan_deeplearning4j_tpu_torch.eval import fid as pt_fid
from gan_deeplearning4j_tpu_torch.eval import quality_run
from gan_deeplearning4j_tpu_torch.eval.inception_schema import inception_v3_stem, write_schema
from gan_deeplearning4j_tpu_torch.interop import params_from_numpy
from gan_deeplearning4j_tpu_torch.models import dcgan_mnist as pt_models
from gan_deeplearning4j_tpu_torch.utils.serializer import read_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_REL = 1e-5


def _close_features(pt, ref):
    assert pt.shape == ref.shape
    np.testing.assert_allclose(pt, ref, rtol=0, atol=FEATURE_REL * np.abs(ref).max())


# -- frozen kernels for any seed ----------------------------------------------------

@pytest.mark.parametrize("channels", [1, 3])
def test_frozen_kernels_hold_the_pinned_jax_draw(channels):
    for mine, pinned in zip(pt_fid.frozen_kernels(channels, 666),
                            pt_fid.pinned_frozen_kernels(channels)):
        assert mine.dtype == pinned.dtype == np.float32 and mine.shape == pinned.shape
        rel = np.abs(mine - pinned) / np.abs(pinned)
        assert rel.max() <= 1e-6, rel.max()


def test_frozen_feature_fn_serves_another_seed_and_channel_count():
    rows = np.random.default_rng(5).random((9, 10 * 12 * 2), dtype=np.float32)
    ref = jax_fid.frozen_feature_fn(10, 12, 2, seed=7, batch_size=4)(rows)
    pt = pt_fid.frozen_feature_fn(10, 12, 2, seed=7, batch_size=4, device="cpu")(rows)
    assert pt.shape == (9, 224)
    _close_features(pt, ref)


# -- the Inception schema -------------------------------------------------------------

def _every_op_schema(path, height, width, channels=3):
    """A branched net with every op: a strided SAME conv (bias, relu), a
    VALID conv and VALID max and average pools joined by a concat, strided
    SAME max and average pools, a strided SAME 1×3 conv without bias (as
    InceptionV3's factorised 1×7 / 7×1 convolutions), and a global average
    pool."""
    rng = np.random.default_rng(0)
    schema = {
        "input": {"height": height, "width": width, "channels": channels,
                  "mean": [0.4, 0.5, 0.6][:channels], "std": [0.2, 0.25, 0.3][:channels]},
        "nodes": [
            {"name": "c1", "op": "conv", "in": "input", "stride": 2, "padding": "SAME",
             "activation": "relu", "kernel": "c1/kernel", "bias": "c1/bias"},
            {"name": "b1", "op": "conv", "in": "c1", "stride": 1, "padding": "VALID",
             "kernel": "b1/kernel", "bias": "b1/bias"},
            {"name": "b2", "op": "maxpool", "in": "c1", "size": 3, "stride": 1, "padding": "VALID"},
            {"name": "b3", "op": "avgpool", "in": "c1", "size": 3, "stride": 1, "padding": "VALID"},
            {"name": "cat", "op": "concat", "in": ["b1", "b2", "b3"]},
            {"name": "p1", "op": "maxpool", "in": "cat", "size": 2, "stride": 2, "padding": "SAME"},
            {"name": "p2", "op": "avgpool", "in": "p1", "size": 3, "stride": 2, "padding": "SAME"},
            {"name": "c2", "op": "conv", "in": "p2", "stride": 2, "padding": "SAME",
             "activation": "relu", "kernel": "c2/kernel"},
            {"name": "feat", "op": "global_avgpool", "in": "c2"},
        ],
        "output": "feat",
    }
    arrays = {
        "c1/kernel": rng.normal(size=(3, 3, channels, 4)).astype(np.float32) * 0.3,
        "c1/bias": rng.normal(size=(4,)).astype(np.float32) * 0.1,
        "b1/kernel": rng.normal(size=(3, 3, 4, 5)).astype(np.float32) * 0.3,
        "b1/bias": rng.normal(size=(5,)).astype(np.float32) * 0.1,
        "c2/kernel": rng.normal(size=(1, 3, 13, 6)).astype(np.float32) * 0.3,
    }
    return write_schema(path, schema, arrays)


@pytest.mark.parametrize("src,schema_hw,channels", [
    ((8, 8), (16, 16), 1),   # resize up, grayscale broadcast
    ((12, 9), (12, 9), 3),   # no resize, odd SAME splits
    ((32, 32), (15, 15), 3),  # resize down (anti-aliased)
    ((20, 20), (11, 13), 1),  # down and uneven
])
def test_every_op_schema_matches_jax(tmp_path, src, schema_hw, channels):
    path = _every_op_schema(str(tmp_path / "w.npz"), *schema_hw)
    h, w = src
    rows = np.random.default_rng(1).random((7, h * w * channels), dtype=np.float32)
    ref_fn = jax_fid.inception_feature_fn(h, w, channels, path=path, batch_size=4)
    pt_fn = pt_fid.inception_feature_fn(h, w, channels, path=path, batch_size=4, device="cpu")
    assert pt_fn.source == ref_fn.source == f"inception:{path}"
    pt = pt_fn(rows)
    assert pt.shape == (7, 6)
    _close_features(pt, ref_fn(rows))
    np.testing.assert_array_equal(pt_fn(rows.reshape(7, h, w, channels)), pt)


def test_a_map_output_flattens_in_nhwc_as_the_reference(tmp_path):
    path = _every_op_schema(str(tmp_path / "w.npz"), 12, 12)
    schema, arrays = pt_fid._load_schema(path)
    schema["output"] = "cat"
    write_schema(path, schema, arrays)
    rows = np.random.default_rng(2).random((3, 12 * 12 * 3), dtype=np.float32)
    ref = jax_fid.inception_feature_fn(12, 12, 3, path=path, batch_size=4)(rows)
    pt = pt_fid.inception_feature_fn(12, 12, 3, path=path, batch_size=4, device="cpu")(rows)
    assert pt.shape == (3, 4 * 4 * 13)
    _close_features(pt, ref)


@pytest.mark.parametrize("src,schema_hw", [((28, 28), (75, 75)), ((64, 64), (32, 32))])
def test_the_inception_v3_stem_matches_jax(tmp_path, src, schema_hw):
    """The published stem and Mixed_5b (256 features), fed MNIST-shaped
    grayscale rows resized up, or 64×64 colour rows resized down."""
    path = write_schema(str(tmp_path / "stem.npz"), *inception_v3_stem(*schema_hw))
    channels = 1 if src == (28, 28) else 3
    rows = np.random.default_rng(3).random((3, src[0] * src[1] * channels), dtype=np.float32)
    ref = jax_fid.inception_feature_fn(*src, channels, path=path, batch_size=2)(rows)
    pt = pt_fid.inception_feature_fn(*src, channels, path=path, batch_size=2, device="cpu")(rows)
    assert pt.shape == (3, 256)
    _close_features(pt, ref)


def test_shrinking_needs_the_anti_aliased_resize():
    """The trap: ``jax.image.resize(..., "bilinear")`` anti-aliases when it
    shrinks; torch's bilinear does so only with ``antialias=True``."""
    img = np.random.default_rng(4).random((2, 64, 64, 3), dtype=np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(img), (2, 32, 32, 3), method="bilinear"))
    x = torch.from_numpy(img).permute(0, 3, 1, 2)

    def resized(antialias):
        out = F.interpolate(x, size=(32, 32), mode="bilinear", align_corners=False,
                            antialias=antialias)
        return out.permute(0, 2, 3, 1).numpy()

    assert np.abs(resized(False) - ref).max() > 0.1
    np.testing.assert_allclose(resized(True), ref, rtol=0, atol=1e-6)


def test_avgpool_excludes_padding_from_divisor(tmp_path):
    """A constant input pools to that constant everywhere under SAME padding
    (the JAX package's test); ``count_include_pad=False`` on an ``F.pad``-ed
    input would count the pad, since it sees no padding of its own."""
    schema = {"input": {"height": 6, "width": 6, "channels": 1},
              "nodes": [{"name": "p", "op": "avgpool", "in": "input", "size": 3, "stride": 1,
                         "padding": "SAME"},
                        {"name": "f", "op": "global_avgpool", "in": "p"}],
              "output": "f"}
    path = write_schema(str(tmp_path / "avg.npz"), schema, {})
    x = np.full((3, 36), 0.625, dtype=np.float32)
    feats = pt_fid.inception_feature_fn(6, 6, 1, path=path, batch_size=4, device="cpu")(x)
    np.testing.assert_allclose(feats, 0.625, rtol=1e-6)
    padded = F.pad(torch.full((1, 1, 6, 6), 0.625), (1, 1, 1, 1))
    assert F.avg_pool2d(padded, 3, 1, count_include_pad=False).mean() < 0.6


def test_env_var_and_the_frozen_fallback(tmp_path, monkeypatch):
    monkeypatch.delenv("INCEPTION_WEIGHTS", raising=False)
    fb = pt_fid.inception_feature_fn(8, 8, 1, batch_size=8, device="cpu")
    assert fb.source == "frozen"
    rows = np.random.default_rng(2).random((4, 64), dtype=np.float32)
    ref = jax_fid.inception_feature_fn(8, 8, 1, batch_size=8)
    assert ref.source == "frozen"
    _close_features(fb(rows), ref(rows))
    path = _every_op_schema(str(tmp_path / "w.npz"), 16, 16)
    monkeypatch.setenv("INCEPTION_WEIGHTS", path)
    assert pt_fid.inception_feature_fn(8, 8, 1, batch_size=8, device="cpu").source == f"inception:{path}"
    # a missing file is no weights
    monkeypatch.setenv("INCEPTION_WEIGHTS", str(tmp_path / "missing.npz"))
    assert pt_fid.inception_feature_fn(8, 8, 1, batch_size=8, device="cpu").source == "frozen"


def test_an_unknown_op_or_padding_is_refused(tmp_path):
    schema = {"input": {"height": 4, "width": 4, "channels": 1},
              "nodes": [{"name": "f", "op": "softmax", "in": "input"}], "output": "f"}
    path = write_schema(str(tmp_path / "bad.npz"), schema, {})
    with pytest.raises(ValueError, match="unknown op 'softmax'"):
        pt_fid.inception_feature_fn(4, 4, 1, path=path, device="cpu")
    with pytest.raises(ValueError, match="padding"):
        pt_fid._pads("FULL", (4, 4), (3, 3), 1)


# -- the quick-FID tracker --------------------------------------------------------------

class _JaxExperiment:
    """What ``quick_fid_scorer`` reads of a JAX ``GanExperiment``."""

    def __init__(self, gen, params):
        self.model_cfg = jax_models.DcganConfig()
        self.gen, self.gen_params, self._compute_dtype = gen, params, None
        self._gen_fwd = jax.jit(lambda p, z: gen.output(p, z, train=False))


class _PortExperiment:
    """What the port's ``quick_fid_scorer`` reads of a ``GanExperiment``."""

    def __init__(self, gen, params):
        self.model_cfg = pt_models.DcganConfig()
        self.gen, self.gen_params, self._compute_dtype = gen, params, None
        self.device = torch.device("cpu")


def _numpy_tree(params):
    return {k: {n: np.asarray(v) for n, v in lp.items()} for k, lp in params.items()}


def test_quick_fid_scorer_matches_jax_and_dedups():
    jax_gen, pt_gen = jax_models.build_generator(), pt_models.build_generator()
    base = _numpy_tree(jax_gen.init())
    real = np.random.default_rng(8).random((96, 784), dtype=np.float32)
    jax_frozen = jax_fid.frozen_feature_fn(28, 28, 1, batch_size=64)
    pt_frozen = pt_fid.frozen_feature_fn(28, 28, 1, batch_size=64, device="cpu")
    jax_exp = _JaxExperiment(jax_gen, jax.tree_util.tree_map(jnp.asarray, base))
    pt_exp = _PortExperiment(pt_gen, params_from_numpy(base, "cpu", graph=pt_gen))
    ref = jax_fid.quick_fid_scorer(jax_exp, jax_frozen,
                                   jax_fid.FeatureStats.from_features(jax_frozen(real)),
                                   num_samples=64, seed=679)
    mine = pt_fid.quick_fid_scorer(pt_exp, pt_frozen,
                                   pt_fid.FeatureStats.from_features(pt_frozen(real)),
                                   num_samples=64, seed=679)
    rng = np.random.default_rng(9)
    for index in (1, 3, 5):
        tree = {k: {n: v + 0.05 * index * rng.standard_normal(v.shape).astype(np.float32)
                    for n, v in lp.items()} for k, lp in base.items()}
        jax_exp.gen_params = jax.tree_util.tree_map(jnp.asarray, tree)
        pt_exp.gen_params = params_from_numpy(tree, "cpu", graph=pt_gen)
        a, b = mine(pt_exp, index), ref(jax_exp, index)
        assert np.isfinite(a) and a == pytest.approx(b, rel=1e-3)
        # the same index again: the cached (rounded) value, no new entry
        assert mine(pt_exp, index) == mine.curve[-1][1] == round(a, 3)
    assert [i for i, _ in mine.curve] == [i for i, _ in ref.curve] == [1, 3, 5]
    np.testing.assert_allclose([f for _, f in mine.curve], [f for _, f in ref.curve], rtol=1e-3)


# -- in-process accuracy ----------------------------------------------------------------

def test_evaluate_classifier_matches_jax():
    jax_dis = jax_models.build_discriminator()
    jax_cv, jax_params = jax_models.build_transfer_classifier(jax_dis, jax_dis.init())
    tree = _numpy_tree(jax_params)
    pt_dis = pt_models.build_discriminator()
    pt_cv, _ = pt_models.build_transfer_classifier(pt_dis, pt_dis.init(device="cpu"))
    rng = np.random.default_rng(10)
    features = rng.random((1234, 784), dtype=np.float32)
    labels = rng.integers(0, 10, 1234)
    ref = jax_accuracy.evaluate_classifier(jax_cv, jax.tree_util.tree_map(jnp.asarray, tree),
                                           features, labels)
    mine = pt_accuracy.evaluate_classifier(pt_cv, params_from_numpy(tree, "cpu", graph=pt_cv),
                                           features, labels)
    assert mine == ref
    one_hot = np.eye(10, dtype=np.float32)[labels]
    assert pt_accuracy.evaluate_classifier(pt_cv, params_from_numpy(tree, "cpu", graph=pt_cv),
                                           features, one_hot, batch_size=300) == ref
    with pytest.raises(ValueError, match="no features"):
        pt_accuracy.evaluate_classifier(pt_cv, params_from_numpy(tree, "cpu", graph=pt_cv),
                                        features[:0], labels[:0])


# -- the quality run --------------------------------------------------------------------

def _script_report_keys():
    """The top-level and best-checkpoint keys of ``scripts/quality_run.py``'s
    report, read from its source."""
    tree = ast.parse(open(os.path.join(REPO, "scripts", "quality_run.py")).read())
    report = next(n.value for n in ast.walk(tree) if isinstance(n, ast.Assign)
                  and any(isinstance(t, ast.Name) and t.id == "report" for t in n.targets))
    keys = [k.value for k in report.keys]
    best = report.values[keys.index("best_checkpoint")].orelse
    return keys, [k.value for k in best.keys]


def test_quality_run_end_to_end(tmp_path, monkeypatch):
    """The CLI at a tiny size. The selection is biased to the first export
    boundary so that the best snapshot is taken two iterations before the
    end: it must be a copy, since the trained states are updated in place."""
    real_scorer = pt_fid.quick_fid_scorer
    taken, refs = {}, {}

    def biased(exp, frozen_fn, real_stats, **kwargs):
        score = real_scorer(exp, frozen_fn, real_stats, **kwargs)

        def wrapped(e, index):
            taken[index] = {k: {n: t.clone() for n, t in lp.items()} for k, lp in e.gen_params.items()}
            refs[index] = e.gen_params
            return score(e, index) + (0.0 if index == 1 else 1e6)

        wrapped.curve = score.curve
        return wrapped

    monkeypatch.setattr(quality_run, "quick_fid_scorer", biased)
    monkeypatch.delenv("INCEPTION_WEIGHTS", raising=False)
    out = str(tmp_path / "out")
    args = quality_run.build_parser().parse_args([
        "--cpu", "--iterations", "4", "--batch", "16", "--num-train", "64", "--num-test", "32",
        "--fid-samples", "64", "--select-samples", "32", "--export-every", "2", "--out", out])
    report, parts = quality_run.run(args)

    keys, best_keys = _script_report_keys()
    assert list(report) == keys
    assert list(report["best_checkpoint"]) == best_keys
    with open(os.path.join(out, "quality_run.json")) as fh:
        assert json.load(fh) == json.loads(json.dumps(report))
    assert report["platform"] == "cpu" and report["device_kind"] == "cpu"
    assert report["fid_inception"] is None and report["fid_inception_source"] is None
    assert report["iterations"] == 4 and 0.0 <= report["accuracy"] <= 1.0
    for name in ("DCGAN_Generated_Images.png", "DCGAN_Generated_Images_final.png",
                 "mnist_gen_model_best.zip", "mnist_gen_model.zip", "quality_test.csv"):
        assert os.path.exists(os.path.join(out, name)), name

    best = report["best_checkpoint"]
    assert best["iteration"] == 1 and best["is_final"] is False
    assert [i for i, _ in best["quick_fid_curve"]] == [1, 3, 4]
    exp = parts["experiment"]
    snapshot = parts["best"]["gen_params"]
    final = exp.gen_params
    # the trap: the states at index 1 were updated in place to the final ones
    assert all(torch.equal(refs[1][k][n], final[k][n]) for k in final for n in final[k])
    assert any(not torch.equal(taken[1][k][n], final[k][n]) for k in final for n in final[k])
    # the snapshot is the copy, and the saved best generator holds it
    _, saved, _, _ = read_model(parts["best_zip"], load_updater=False, device="cpu")
    for k in final:
        for n in final[k]:
            assert snapshot[k][n].data_ptr() != final[k][n].data_ptr()
            assert torch.equal(snapshot[k][n], taken[1][k][n])
            assert torch.equal(saved[k][n], taken[1][k][n])
    # rescoring the saved generator reproduces its curve entry
    rescore = real_scorer(exp, parts["frozen_fn"], parts["real_stats"], num_samples=32, seed=679)
    exp_best = _PortExperiment(exp.gen, saved)
    assert round(rescore(exp_best, 1), 3) == best["quick_fid_curve"][0][1]
    assert report["fid_frozen_features_best"] == best["fid_frozen_features"]
    assert report["fid_frozen_features_best"] != report["fid_frozen_features"]
