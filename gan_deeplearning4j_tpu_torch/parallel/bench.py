"""update-sharding bench — replicated against sharded weight updates, per
mesh size; the port's ``scripts/update_sharding_bench.py``, with its flags
and JSON keys::

    python -m gan_deeplearning4j_tpu_torch.parallel.bench                       # on the card
    python -m gan_deeplearning4j_tpu_torch.parallel.bench --cpu --smoke --mesh 2

Runs the same MNIST training twice per mesh size N, replicated updates
(``update_sharding=False``) against sharded ones (``True``), under
``distributed="pmean"``, and records per N:

- parity after one iteration of each on the same rows: the worst
  leafwise relative difference of every state (``parity_rel_max_iter1``,
  gated at 5e-2 as in the JAX script) and whether the two states'
  digests are equal (``parity_digest_exact_iter1``; the port's sharded
  step slices the replicated mean gradient, so it is bit for bit the
  replicated one);
- resident updater bytes per rank: the whole optimizer state replicated,
  ``UpdateShardingPlan.resident_bytes`` of the packed rows sharded, gated
  at ``resident_ratio ≤ 1.35 / N``; each trainer's ``plan.describe()``;
- the collectives one eager iteration issues, by kind
  (``parallel/collectives.py::CALLS``);
- step time: ``--rounds`` rounds of ``--iterations`` iterations per arm,
  each round closed by a read of its last losses; the minimum round and
  every round (``step_s_min``, ``step_s_rounds``).

``--batch`` is the global batch (``batch_size_train`` on a mesh, as in the
JAX script); each rank trains on its 1/N of the rows, and a batch that N
does not divide is refused. Each mesh entry is one
``parallel/launch.py::spawn`` of N ranks (the rank program is
:func:`rank_run`): NCCL where the host has N cards or more, else gloo with
every rank on ``cuda:0``, and gloo on the CPU under ``--cpu``. Exit status
is 1 on any invariant breach, 2 without a card and without ``--cpu``
(nothing is spawned). ``--smoke`` is the JAX script's quick shape (parity
and residency only, 6 iterations, 2 rounds, batch ≤ 32). The summary is
printed; ``--output PATH`` and ``--record TAG``
(``BENCH_torch_update_sharding_<TAG>.json`` at the repo root) write it.

The step-time gate (sharded ≤ ``--step-time-slack`` × replicated) applies
only where every rank has a card of its own under NCCL. On gloo the ratio
is recorded with a ``step_time_note``: gloo stages every collective
through the host (about 85% of a rank's iteration with four ranks on one
card), the port's counterpart of the JAX script's forced host devices;
``--gate-step-time-on-cpu`` forces the gate there too.

What differs from the JAX script, and why:

- ``collectives`` counts the collectives issued, by
  ``parallel/collectives.py``, over one eager iteration of the parity
  pair (on NCCL that iteration runs uncaptured: a captured graph issues
  its collectives once, at capture). The JAX script counts the
  instructions in the optimised HLO text. Its keys keep the JAX names
  (``all-reduce``, ``reduce-scatter``, ``all-gather``); the port's
  synchronised BatchNorm adds two all-reduces a layer, and the port packs
  a step's gradients into one all-reduce per dtype;
- ``sharded_updater_bytes_per_device`` is keyed by rank (the JAX script's
  by device id); timings are rank 0's (every iteration ends in
  collectives, so the ranks keep step);
- added keys: ``backend`` (``nccl`` or ``gloo``) and ``device_name`` (the
  card's, or ``cpu``) per mesh entry;
- ``platform`` is ``gpu`` or ``cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict

import numpy as np

#: the parity gate after one iteration, and the residency slack over 1/N
PARITY_TOL = 5e-2
RESIDENT_SLACK = 1.35
#: JAX's collective names for ``collectives.CALLS``' kinds
COLLECTIVE_NAMES = {"all_reduce": "all-reduce", "reduce_scatter": "reduce-scatter",
                    "all_gather": "all-gather"}

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m gan_deeplearning4j_tpu_torch.parallel.bench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--update-sharding", choices=["off", "on", "both"], default="both",
                   help="which arm(s) to run; 'both' is the paired A/B")
    p.add_argument("--mesh", default="2,4",
                   help="comma-separated mesh sizes to bench (ranks of one spawn each)")
    p.add_argument("--iterations", type=int, default=24, help="timed iterations per round")
    p.add_argument("--rounds", type=int, default=3, help="timed rounds per arm (min is reported)")
    p.add_argument("--batch", type=int, default=64, help="the global batch")
    p.add_argument("--step-time-slack", type=float, default=1.05,
                   help="sharded/replicated min-round ratio gate")
    p.add_argument("--no-step-gate", action="store_true",
                   help="record step time but do not gate on it")
    p.add_argument("--gate-step-time-on-cpu", action="store_true",
                   help="apply the step-time gate on a gloo mesh too (on the CPU, or gloo ranks "
                        "sharing a card). Off by default: gloo stages every collective through "
                        "host memory, so the sharded arm's added all-gather reads as step time "
                        "that NCCL on a card per rank does not pay. The ratio is always recorded.")
    p.add_argument("--smoke", action="store_true",
                   help="quick shape: tiny workload, parity + residency invariants only")
    p.add_argument("--record", default=None, metavar="TAG",
                   help="write BENCH_torch_update_sharding_<TAG>.json at the repo root")
    p.add_argument("--output", default=None, help="also write the summary JSON here")
    p.add_argument("--cpu", action="store_true", help="run gloo ranks on the CPU")
    args = p.parse_args(argv)
    args.meshes = [int(x) for x in str(args.mesh).split(",") if x.strip()]
    if args.smoke:
        args.iterations = min(args.iterations, 6)
        args.rounds = min(args.rounds, 2)
        args.batch = min(args.batch, 32)
        args.no_step_gate = True
    bad = [n for n in args.meshes if n < 1 or args.batch % n]
    if bad:
        p.error(f"--batch {args.batch} does not split evenly over mesh sizes {bad}")
    return args


# -- the rank program ----------------------------------------------------------
def rank_run(spec: Dict) -> Dict:
    """One rank of one mesh entry: the parity pair, its residency and
    collectives, then the timed arms. ``spec`` holds the parsed flags as a
    dict and ``use_accelerator``. The experiments' directories are a
    temporary directory's, removed after."""
    with tempfile.TemporaryDirectory(prefix="update_sharding_bench_") as workdir:
        return _rank_run(spec, workdir)


def _rank_run(spec: Dict, workdir: str) -> Dict:
    import torch

    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, GanExperiment
    from gan_deeplearning4j_tpu_torch.harness.experiment import flatten_states
    from gan_deeplearning4j_tpu_torch.parallel import collectives
    from gan_deeplearning4j_tpu_torch.parallel.drill import _numpy, _resident
    from gan_deeplearning4j_tpu_torch.resilience.supervisor import TrainingSupervisor
    from gan_deeplearning4j_tpu_torch.runtime.environment import make_mesh

    mesh = make_mesh(use_accelerator=spec["use_accelerator"])
    n, batch = mesh.size, spec["batch"]
    rng = np.random.default_rng(666)
    feats = rng.random((batch, 784), dtype=np.float32)
    labels = np.zeros((batch, 10), np.float32)
    labels[np.arange(batch), rng.integers(0, 10, batch)] = 1.0

    def build(sharded: bool) -> GanExperiment:
        cfg = ExperimentConfig(
            batch_size_train=batch, batch_size_pred=batch, num_iterations=spec["iterations"],
            latent_grid=4, data_dir=os.path.join(workdir, "data"),
            output_dir=os.path.join(workdir, f"out-{n}-{sharded}"), save_models=False,
            distributed="pmean", update_sharding=sharded,
            use_accelerator=spec["use_accelerator"])
        return GanExperiment(cfg, mesh=mesh)

    def one_eager_iteration(exp) -> Dict[str, int]:
        """The collectives one uncaptured iteration issues, by JAX name."""
        exp.graphs.captured = False
        collectives.reset_calls()
        losses = exp.train_iteration(feats, labels)
        float(losses["d_loss"])
        counts = {COLLECTIVE_NAMES[k]: v for k, v in collectives.CALLS.items()}
        exp.graphs.captured = exp._captured()
        return counts

    def timed_arm(exp) -> dict:
        rounds = []
        for _ in range(spec["rounds"]):
            t0 = time.perf_counter()
            losses = None
            for _ in range(spec["iterations"]):
                losses = exp.train_iteration(feats, labels)
            vals = [float(v) for v in losses.values()]  # the fence: the last losses
            rounds.append((time.perf_counter() - t0) / spec["iterations"])
            if not all(np.isfinite(vals)):
                raise RuntimeError(f"non-finite losses: {vals}")
        return {"step_s_min": min(rounds), "step_s_rounds": rounds}

    out: Dict = {"rank": mesh.rank, "world": n, "backend": mesh.backend,
                 "jax_loaded": "jax" in sys.modules}
    run_off = spec["update_sharding"] in ("off", "both")
    run_on = spec["update_sharding"] in ("on", "both")
    if run_off and run_on:
        a, b = build(False), build(True)
        counts = {"replicated": one_eager_iteration(a), "sharded": one_eager_iteration(b)}
        fa = _numpy(flatten_states(a.digest_states()))
        fb = _numpy(flatten_states(b.digest_states()))
        worst = 0.0
        for key in fa:
            la, lb = np.asarray(fa[key], np.float64), np.asarray(fb[key], np.float64)
            denom = np.maximum(np.abs(la), 1e-2)
            worst = max(worst, float(np.max(np.abs(la - lb) / denom)))
        out["parity_rel_max_iter1"] = worst
        out["parity_digest_exact_iter1"] = (TrainingSupervisor.state_digests(a)
                                            == TrainingSupervisor.state_digests(b))
        out["replicated_bytes"] = _resident(a)
        out["sharded_bytes"] = _resident(b)
        out["plan"] = {name: tr.plan.describe() for name, tr in (
            ("dis", b.dis_trainer), ("gan", b.gan_trainer), ("CV", b.cv_trainer))
            if tr is not None}
        out["collectives"] = counts
        for exp in (a, b):
            exp.close()
        del a, b
    arms = {}
    if not spec["smoke"]:
        for label, wanted, sharded in (("replicated", run_off, False), ("sharded", run_on, True)):
            if wanted:
                exp = build(sharded)
                arms[label] = timed_arm(exp)
                exp.close()
                del exp
    out["arms"] = arms
    if mesh.device.type == "cuda":
        torch.cuda.empty_cache()
    return out


# -- the bench -----------------------------------------------------------------------
def _backend(n: int, cpu: bool):
    """``(backend, device_name)`` of an N-rank mesh entry."""
    import torch

    from gan_deeplearning4j_tpu_torch.runtime.environment import backend_for

    if cpu:
        return "gloo", "cpu"
    return backend_for(n), torch.cuda.get_device_name(0)


def run(args) -> Dict:
    """Every mesh entry; the summary (its ``invariants`` decide the exit
    status)."""
    from gan_deeplearning4j_tpu_torch.parallel import bench
    from gan_deeplearning4j_tpu_torch.parallel.launch import spawn

    spec = {k: getattr(args, k) for k in ("update_sharding", "iterations", "rounds", "batch",
                                          "smoke")}
    spec["use_accelerator"] = not args.cpu
    results, invariants = [], {}
    for n in args.meshes:
        backend, device_name = _backend(n, args.cpu)
        # by the module's name: run as a program, this module is __main__
        ranks = spawn(bench.rank_run, n, (spec,), backend=backend,
                      use_accelerator=not args.cpu, timeout=900, threads=2)
        r0 = ranks[0]
        entry: Dict = {"mesh": n, "backend": backend, "device_name": device_name}
        if "plan" in r0:
            entry["parity_rel_max_iter1"] = r0["parity_rel_max_iter1"]
            invariants[f"parity_tolerance_mesh{n}"] = r0["parity_rel_max_iter1"] <= PARITY_TOL
            entry["parity_digest_exact_iter1"] = r0["parity_digest_exact_iter1"]
            rep_total = max(r["replicated_bytes"] for r in ranks)
            sh_bytes = {r["rank"]: r["sharded_bytes"] for r in ranks}
            entry["replicated_updater_bytes_per_device"] = rep_total
            entry["sharded_updater_bytes_per_device"] = sh_bytes
            ratio = max(sh_bytes.values()) / rep_total
            entry["resident_ratio"] = ratio
            entry["resident_ratio_ideal"] = 1.0 / n
            # about 1/N: padding and each group's widest row
            invariants[f"resident_ratio_mesh{n}"] = ratio <= RESIDENT_SLACK / n
            entry["plan"] = r0["plan"]
            entry["collectives"] = r0["collectives"]
        arms = r0["arms"]
        if "replicated" in arms and "sharded" in arms and not args.no_step_gate:
            ratio = arms["sharded"]["step_s_min"] / arms["replicated"]["step_s_min"]
            entry["step_time_ratio"] = ratio
            if backend == "gloo" and not args.gate_step_time_on_cpu:
                entry["step_time_note"] = (
                    "recorded, not gated: gloo stages every collective through host "
                    "memory, so the sharded arm's added all-gather costs host copies "
                    "that NCCL with a card per rank does not pay; the gate runs "
                    "where each rank has its own card")
            else:
                invariants[f"step_time_mesh{n}"] = ratio <= args.step_time_slack
        entry["arms"] = arms
        results.append(entry)
        print(f"mesh {n}: {json.dumps({k: v for k, v in entry.items() if k != 'plan'}, default=str)[:400]}",
              flush=True)
    return {
        "bench": "update_sharding",
        "platform": "cpu" if args.cpu else "gpu",
        "batch": args.batch,
        "iterations": args.iterations,
        "rounds": args.rounds,
        "smoke": bool(args.smoke),
        "results": results,
        "invariants": invariants,
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    if not args.cpu and not torch.cuda.is_available():
        sys.stderr.write("update_sharding_bench: no CUDA device is available; pass --cpu to "
                         "run gloo ranks on the CPU\n")
        return 2
    summary = run(args)
    text = json.dumps(summary, indent=2, default=str)
    paths = [args.output] if args.output else []
    if args.record:
        paths.append(os.path.join(_REPO, f"BENCH_torch_update_sharding_{args.record}.json"))
    for path in paths:
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(text + "\n")
    bad = [k for k, v in summary["invariants"].items() if not v]
    if bad:
        sys.stderr.write(f"update_sharding_bench: invariants violated: {bad}\n")
        return 1
    print("update_sharding_bench: all invariants hold")
    return 0


if __name__ == "__main__":
    sys.exit(main())
