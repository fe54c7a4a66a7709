"""PyTorch port, the serving bench (``serving/bench.py``) against the JAX
package's ``scripts/serve_bench.py``, on the CPU.

- Traffic: both scripts' closed-loop ``_drive`` feed one recording stub
  service; every worker's sequence of (kind, rows) must be bit-equal.
- The whole bench: both ``run_bench`` on the same small arguments must
  give the same key tree under ``results``, ``overload`` and
  ``invariants`` (``batch_occupancy``'s keys are flush sizes, which
  depend on timing, and are left out), the same ``ok`` and ``lost``
  counts and the same rows served, and every invariant true.
- The replay: the learned ladder equals ``solve_ladder`` of the flush
  histogram the port recorded, in both packages, with the same analytic
  waste; both replay invariants hold.
- The CLI: ``--cpu --smoke`` exits 0; without a card and without
  ``--cpu`` it exits 2 having built nothing; ``--compilation-cache`` is
  refused.

The JAX script's top level imports only the standard library and numpy;
it is loaded by path. Run with ``JAX_PLATFORMS=cpu``.
"""

import argparse
import importlib.util
import json
import os
import threading
from types import SimpleNamespace

import numpy as np
import pytest

from gan_deeplearning4j_tpu.serving import ladder as jax_ladder
from gan_deeplearning4j_tpu_torch.serving import bench
from gan_deeplearning4j_tpu_torch.serving import ladder as pt_ladder

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: keys the port's summary names differently under results, overload and
#: invariants: none (``config`` says ``platform`` from the engine, and
#: ``device_name`` on the card, but it is not compared)
RENAMED = {}
#: maps whose keys depend on timing
TIMING_KEYED = ("batch_occupancy",)


def _load_jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_serve_bench", os.path.join(REPO, "scripts", "serve_bench.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


JAX_BENCH = _load_jax_script()


class _Recorder:
    """A service whose ``batcher.submit`` records ``(kind, rows)`` per
    calling thread and answers ok."""

    def __init__(self):
        self.lock = threading.Lock()
        self.by_thread = {}
        self.batcher = self

    def submit(self, kind, rows, timeout=None):
        with self.lock:
            # a thread's name is unique in the process (an ident may be reused)
            self.by_thread.setdefault(threading.current_thread().name, []).append(
                (kind, rows.shape, rows.dtype.str, rows.tobytes()))
        return SimpleNamespace(status="ok", ok=True, data=rows)

    def sequences(self):
        """Each worker's sequence; workers are told apart by their draws,
        so the sorted list pairs worker w of one script with worker w of
        the other."""
        return sorted(self.by_thread.values())


@pytest.mark.parametrize("seed", [666, 667])
@pytest.mark.parametrize("threads", [3, 8])
@pytest.mark.parametrize("classes", [0, 10])
def test_closed_loop_traffic_is_bit_equal_to_the_jax_bench(seed, threads, classes):
    kinds = ["sample", "classify", "features"]
    width = {"sample": 2 + classes, "classify": 784, "features": 784}
    runs = []
    for drive in (JAX_BENCH._drive, bench._drive):
        service = _Recorder()
        statuses, rows, _ = drive(service, kinds, width, [1, 3, 8], 48, threads, seed,
                                  classes=classes)
        assert statuses == ["ok"] * (threads * (48 // threads))
        runs.append((service.sequences(), rows))
    (jax_seqs, jax_rows), (pt_seqs, pt_rows) = runs
    assert len(pt_seqs) == threads and pt_rows == jax_rows
    assert pt_seqs == jax_seqs


def _key_tree(node, prefix=""):
    if not isinstance(node, dict):
        return {prefix}
    out = {prefix} if prefix else set()
    for key, value in node.items():
        path = f"{prefix}/{RENAMED.get(key, key)}"
        out |= {path} if key in TIMING_KEYED else _key_tree(value, path)
    return out


@pytest.fixture(scope="module")
def both_benches():
    args = bench.parse_args([
        "--cpu", "--requests", "16", "--threads", "2", "--buckets", "1,8", "--sizes", "1,3,8",
        "--overload-requests", "8", "--overload-threads", "4"])
    return JAX_BENCH.run_bench(argparse.Namespace(**vars(args))), bench.run_bench(args)


@pytest.mark.parametrize("section", ["results", "overload", "invariants"])
def test_whole_bench_has_the_jax_key_tree(both_benches, section):
    jax_out, pt_out = both_benches
    assert _key_tree(pt_out[section]) == _key_tree(jax_out[section])


def test_whole_bench_serves_what_the_jax_bench_serves(both_benches):
    jax_out, pt_out = both_benches
    for key in ("ok", "lost", "errors", "shed"):
        assert pt_out["results"][key] == jax_out["results"][key], key
    assert pt_out["results"]["ok"] == 16 and pt_out["results"]["lost"] == 0

    def rows(out):
        return out["results"]["throughput_rows_per_s"] * out["results"]["elapsed_s"]

    assert rows(pt_out) == pytest.approx(rows(jax_out), rel=1e-9)
    for out in (jax_out, pt_out):
        assert out["overload"]["returned"] == out["overload"]["requests"] == 8
        assert all(out["invariants"].values()), out["invariants"]
    assert pt_out["results"]["compile_counts"] == {"sample": 2, "classify": 2, "features": 2}
    assert pt_out["telemetry"]["serve_requests_total"]


@pytest.fixture(scope="module")
def replay(tmp_path_factory):
    """A seeded heavy-tail trace of 96 sizes (Zipf 1.6 capped at 128, the
    draw of ``tests/test_torch_ladder.py``) replayed by one client: each
    flush is then one request, so both passes flush the trace's own sizes
    and the measured waste is the analytic waste of that histogram. With
    several clients the coalescing depends on timing, and on a 96-request
    trace the measured comparison can go either way in either package."""
    sizes = np.minimum(np.random.default_rng(17).zipf(1.6, 96), 128)
    path = tmp_path_factory.mktemp("trace") / "heavy_tail.json"
    path.write_text(json.dumps({"name": "heavy_tail_seed17", "sizes": [int(s) for s in sizes]}))
    return bench.run_replay(bench.parse_args(["--cpu", "--replay", str(path), "--threads", "1"]))


def test_replay_learns_solve_ladder_of_its_own_flush_histogram(replay):
    ladder = replay["ladder"]
    counts = {int(s): c for s, c in ladder["solved_from_flush_sizes"].items()}
    assert sum(counts.values()) == 96
    for solve in (pt_ladder.solve_ladder, jax_ladder.solve_ladder):
        assert list(solve(counts, budget=4, top=128)) == ladder["learned"]
    analytic = ladder["analytic_padded_rows"]
    assert analytic["baseline_rows"] == jax_ladder.expected_waste(counts, (1, 8, 32, 128))
    assert analytic["learned_rows"] == jax_ladder.expected_waste(counts, ladder["learned"])
    assert replay["waste"]["learned_rows"] == analytic["learned_rows"]
    assert replay["waste"]["baseline_rows"] == analytic["baseline_rows"]


def test_replay_invariants_hold_and_elasticity_reads_no_cache(replay):
    assert replay["invariants"]["learned_ladder_within_budget"]
    assert replay["invariants"]["learned_waste_not_worse"]
    assert all(replay["invariants"].values()), replay["invariants"]
    elasticity = replay["elasticity"]
    assert elasticity["cache_dir"] is None and elasticity["warm_warmup_s"] > 0
    assert set(elasticity) >= {"cache_dir", "cold_warmup_s", "warm_warmup_s", "speedup"}


def test_cli_smoke_on_the_cpu_exits_0(capsys):
    assert bench.main(["--cpu", "--smoke"]) == 0
    assert json.loads(capsys.readouterr().out)["lost"] == 0


def test_cli_without_a_card_exits_2_and_runs_nothing(monkeypatch, capsys):
    import torch

    def refuse(*args, **kwargs):
        raise AssertionError("the bench built a bundle without a device")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "build_bundle", refuse)
    assert bench.main([]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_cli_refuses_a_compilation_cache(capsys):
    with pytest.raises(SystemExit) as exc:
        bench.main(["--cpu", "--compilation-cache", "/nonexistent"])
    assert exc.value.code == 2
    assert "captured CUDA graphs" in capsys.readouterr().err
