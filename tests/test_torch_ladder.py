"""PyTorch port, the learned ladder (``serving/ladder.py``) against the JAX
package's: ``solve_ladder``, ``expected_waste``, the histogram's ``merge``
/ ``merged`` and the manifest's ladder block, on seeded histograms (ragged,
heavy-tailed, empty, one size). The module is plain Python in both
packages, so every result must be equal exactly; a ladder block either
package writes must read in the other.
"""

import json
import os

import numpy as np
import pytest

from gan_deeplearning4j_tpu.serving import ladder as jax_ladder
from gan_deeplearning4j_tpu_torch.serving import ladder as pt_ladder


def _histograms():
    """name -> {size: count}, drawn with numpy from fixed seeds."""
    rng = np.random.default_rng(17)
    ragged = {int(s): int(c) for s, c in zip(rng.integers(1, 200, 40), rng.integers(1, 50, 40))}
    heavy = {}
    for s in np.minimum(rng.zipf(1.6, 3000), 700):
        heavy[int(s)] = heavy.get(int(s), 0) + 1
    dense = {s: int(c) for s, c in enumerate(rng.integers(1, 9, 128), start=1)}
    return {"ragged": ragged, "heavy_tailed": heavy, "dense_1_to_128": dense,
            "one_size": {21: 7}, "empty": {}, "only_full_chunks": {128: 3, 256: 2}}


HISTOGRAMS = _histograms()


@pytest.mark.parametrize("name", sorted(HISTOGRAMS))
@pytest.mark.parametrize("budget", [1, 2, 3, 4, 6])
@pytest.mark.parametrize("top", [None, 128])
def test_solve_ladder_equals_jax(name, budget, top):
    counts = HISTOGRAMS[name]
    if not counts and top is None:
        for mod in (jax_ladder, pt_ladder):
            with pytest.raises(ValueError):
                mod.solve_ladder(counts, budget, top=top)
        return
    got = pt_ladder.solve_ladder(counts, budget, top=top)
    assert got == jax_ladder.solve_ladder(counts, budget, top=top)
    assert len(got) <= max(budget, 1) and got[-1] == (top or max(counts))
    assert pt_ladder.expected_waste(counts, got) == jax_ladder.expected_waste(counts, got)
    # with the default ladder's budget and top, never worse than it
    if top == 128 and budget >= 4:
        assert pt_ladder.expected_waste(counts, got) <= pt_ladder.expected_waste(counts, (1, 8, 32, 128))


@pytest.mark.parametrize("name", sorted(HISTOGRAMS))
@pytest.mark.parametrize("buckets", [(1, 8, 32, 128), (128,), (3, 17, 64), (1, 2, 4, 8, 16, 32, 64, 128)])
def test_expected_waste_and_fold_equal_jax(name, buckets):
    counts = HISTOGRAMS[name]
    assert pt_ladder.expected_waste(counts, buckets) == jax_ladder.expected_waste(counts, buckets)
    top = max(buckets)
    assert pt_ladder._fold_counts(counts, top) == jax_ladder._fold_counts(counts, top)


def test_bad_ladders_and_budgets_raise_alike():
    for mod in (jax_ladder, pt_ladder):
        with pytest.raises(ValueError):
            mod.solve_ladder({3: 1}, 0)
        with pytest.raises(ValueError):
            mod.expected_waste({3: 1}, ())
        with pytest.raises(ValueError):
            mod.solve_ladder({3: 1}, 2, top=0)


def _record_stream(hist, seed):
    rng = np.random.default_rng(seed)
    for kind, n in zip(rng.choice(["sample", "classify", "features"], 600),
                       np.minimum(rng.zipf(1.4, 600), 900)):
        hist.record(str(kind), int(n))


@pytest.mark.parametrize("max_sizes", [256, 7])
def test_histogram_record_merge_and_merged_equal_jax(max_sizes):
    pt, jx = pt_ladder.SizeHistogram(max_sizes), jax_ladder.SizeHistogram(max_sizes)
    _record_stream(pt, 3)
    _record_stream(jx, 3)
    assert pt.snapshot() == jx.snapshot()
    # a snapshot through JSON (string sizes, as a manifest stores them),
    # with junk entries both must skip
    other = pt_ladder.SizeHistogram()
    _record_stream(other, 4)
    carried = json.loads(json.dumps({k: {str(s): c for s, c in v.items()}
                                     for k, v in other.snapshot().items()}))
    carried["sample"]["x"] = 3
    carried["classify"]["0"] = 5
    carried["junk"] = [1, 2]
    pt.merge(carried)
    jx.merge(carried)
    assert pt.snapshot() == jx.snapshot()
    assert pt.merged() == jx.merged()
    assert pt.total() == jx.total()
    assert pt.stats() == jx.stats()
    assert list(pt.merged()) == sorted(pt.merged())


def _bundle(directory):
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, "serving.json"), "w") as fh:
        json.dump({"format_version": 1, "generator": "gen.zip", "generation": 3}, fh)
    return directory


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_a_ladder_block_either_package_writes_reads_in_the_other(tmp_path, writer):
    hist = pt_ladder.SizeHistogram()
    _record_stream(hist, 5)
    snap = hist.snapshot()
    ladder = pt_ladder.solve_ladder(hist.merged(), 4, top=128)
    directory = _bundle(str(tmp_path / "bundle"))
    write = (jax_ladder if writer == "jax" else pt_ladder).write_ladder_block
    block = write(directory, ladder, histogram=snap, solved_from={"budget": 4, "rows": hist.total()})
    with open(os.path.join(directory, "serving.json")) as fh:
        manifest = json.load(fh)
    assert manifest["ladder"] == block and manifest["generation"] == 3
    for mod in (jax_ladder, pt_ladder):
        assert mod.manifest_ladder(directory) == tuple(ladder)
        assert mod.manifest_histogram(directory) == snap
    other = str(tmp_path / "other")
    other_write = (pt_ladder if writer == "jax" else jax_ladder).write_ladder_block
    assert other_write(_bundle(other), ladder, histogram=snap,
                       solved_from={"budget": 4, "rows": hist.total()}) == block


@pytest.mark.parametrize("block", [None, {"buckets": []}, {"buckets": [0, 4]}, {"buckets": "8"},
                                   {"buckets": [4, "x"]}, {"buckets": [8, 2, 2], "histogram": {"s": {"3": "y"}}}])
def test_malformed_ladder_blocks_fall_back_alike(tmp_path, block):
    directory = _bundle(str(tmp_path / "bundle"))
    if block is not None:
        with open(os.path.join(directory, "serving.json")) as fh:
            manifest = json.load(fh)
        manifest["ladder"] = block
        with open(os.path.join(directory, "serving.json"), "w") as fh:
            json.dump(manifest, fh)
    for fn in ("manifest_ladder", "manifest_histogram"):
        assert getattr(pt_ladder, fn)(directory) == getattr(jax_ladder, fn)(directory)
