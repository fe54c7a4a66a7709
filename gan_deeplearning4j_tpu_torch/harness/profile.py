"""profile — where a training iteration's time goes; the port's
``scripts/profile_iteration.py`` and ``scripts/profile_wgan.py`` as two
subcommands over one timing core::

    python -m gan_deeplearning4j_tpu_torch.harness.profile iteration      # on the card
    python -m gan_deeplearning4j_tpu_torch.harness.profile wgan
    python -m gan_deeplearning4j_tpu_torch.harness.profile iteration --cpu --batch 8 --iters 3 --sweep ''

Each runs on ``cuda:0`` unless given ``--cpu``; without a card it exits 2
and runs nothing. Each prints its summary as JSON and writes a file only
where asked: ``--out PATH``, and the ``torch.profiler`` traces under
``--trace-dir`` (without it they go to a temporary directory, read, and
are deleted).

``iteration`` (config 1: DCGAN-MNIST at ``--batch`` 64, fp32 and bf16
compute) runs ``GanExperiment.train_iteration`` as a training user does on
the card: a replay of the captured iteration over a batch that stays on
the device. After warm calls (the captures) it times ``--iters`` calls
under a ``torch.profiler`` trace (``utils/profiling.py::device_trace``),
each in ``PhaseTimer``'s ``fused_iteration`` phase, and reports
``sec_per_iter``, ``images_per_sec``, ``flops_per_iter``
(``flops_per_iteration``), ``achieved_flops_per_sec`` and the phase
report; from the trace the device-busy share, kernels per iteration and
the top kernels by device time, each with its share of the iteration
(``dgrad2d`` sums the cuDNN kernels named ``dgrad2d_*``). Then the batch
sweep: per ``--sweep`` batch the marginal cost of an iteration from two
chained windows (``--sweep-iters`` / 4 and ``--sweep-iters`` calls), each
closed by one fence on its LAST call's loss.

``wgan`` decomposes a WGAN-GP round at the bench's shapes (32×32×3, z 128,
``n_critic`` 5, 64 rows a critic step). FLOPs are counted by
``torch.utils.flop_counter.FlopCounterMode`` over the port's own
``models/wgan_gp.py::WganGpTrainer`` and ``ops/losses.py::
gradient_penalty``: the critic forward, the generator forward, the
Wasserstein term's gradient, the penalty term's gradient (its double
backward), the full critic loss's gradient (``critic_grads``), one critic
round (``critic_round``, ``n_critic`` steps) and the generator step
(``gen_step``), and the JAX script's three ratios under their names. The
wall-clock part times ``--chunks`` windows of ``--scan-window`` rounds
(32, and 8 chunks) as replays of the captured round
(``harness/wgan_experiment.py``), each closed by one fence on its last
round's loss: ``sec_per_round``, ``images_per_sec``,
``cross_chunk_jitter`` and ``chunk_seconds``. One more window of
``TRACED_ROUNDS`` rounds (4) then runs under the trace, for the kernels
per round and the ``dgrad2d`` share of a round: a round is thousands of
kernels, and 8 traced chunks of 32 would be about a million trace events
(the JAX script traces its chunks). ``--cpu`` narrows the models as
the JAX script does (``base_filters`` 8, ``dense_width`` 32) for the
decomposition; the wall-clock part runs ``WganGpExperiment``, whose
widths are the family's.

What differs from the JAX scripts, and why:

- ``bytes_accessed_per_iter`` and ``arithmetic_intensity_flops_per_byte``
  come from XLA's post-optimisation cost analysis, which torch does not
  have. In their place ``bytes_lower_bound_per_iter`` counts each param,
  gradient and updater-state leaf and the batch once (what an iteration
  must at least move), and ``arithmetic_intensity_upper_bound_flops_per_
  byte`` is ``flops_per_iter`` over it. They are not the JAX numbers;
- ``flops_per_iter`` counts the dense and (transposed) convolution layers
  from shapes (``flops_per_iteration``); XLA's count, the JAX script's,
  also holds the elementwise work;
- ``costs_flops_bytes`` becomes ``costs_flops``: ``FlopCounterMode`` counts
  FLOPs only;
- the ratios differ by convention. XLA's counts include elementwise ops;
  ``FlopCounterMode`` counts matrix products and convolutions only, so
  ``gp_grad_over_forward`` reads near the count of passes (the penalty's
  forward, its input-gradient pass and a backward pass through each: six
  forwards' worth; XLA's optimised program counts fewer). XLA's cost analysis
  counts a ``scan`` body once (the JAX package's ``flops_per_iteration``
  multiplies its critic round by ``n_critic`` for that reason), so the JAX
  ``round_over_ncritic_fullgrad`` reads near ``1 / n_critic``; the port
  runs and counts every critic step, so its ratio is 1 up to the Adam
  updates (elementwise, not counted);
- ``platform`` is ``gpu`` or ``cpu`` and ``device_kind`` the card's name
  (``torch.cuda.get_device_name``); ``wgan`` adds ``model``, the
  decomposed models' image shape and widths.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
from collections import defaultdict
from typing import Dict, Optional

import numpy as np
import torch

#: how many kernels by device time a summary lists
TOP_KERNELS = 8
#: rounds in ``wgan``'s traced window, after its timed chunks
TRACED_ROUNDS = 4
#: calls made before a timed region: the first captures the iteration from
#: the initial state, the second the steady state
WARM_CALLS = 3


# -- the timing core --------------------------------------------------------
def fence(out) -> float:
    """Block until ``out`` (a dict of loss tensors, the last call's
    output) is computed, by reading the last element of its first value
    on the host: a value read of the newest result, never of an older one.
    Returns that value."""
    return float(next(iter(out.values())).reshape(-1)[-1])


def timed_window(call, n: int) -> float:
    """Seconds for ``n`` chained calls of ``call``, closed by one
    :func:`fence` on the last call's output."""
    t0 = time.perf_counter()
    out = None
    for _ in range(n):
        out = call()
    fence(out)
    return time.perf_counter() - t0


def _union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def kernel_breakdown(trace_path: str, wall_s: float, units: int, unit: str) -> dict:
    """The device side of a ``torch.profiler`` Chrome trace of ``units``
    iterations (or rounds: ``unit`` names the keys) that took ``wall_s``:
    the busy share (the union of kernel, copy and memset intervals over the
    wall), kernels and kernel milliseconds per unit, the top kernels by
    device time with each one's share of a unit's wall, and the same for
    the kernels named ``dgrad2d*`` together (and their names). A trace without device
    activity (the CPU) gives a busy share of None and no kernels."""
    with open(trace_path) as fh:
        events = json.load(fh).get("traceEvents", [])
    kernels, other, by_name = [], [], defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        span = (float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)))
        if cat == "kernel":
            kernels.append(span)
            by_name[ev.get("name", "?")] += span[1] - span[0]
        elif cat in ("gpu_memcpy", "gpu_memset"):
            other.append(span)

    def ms_and_share(us: float) -> dict:
        ms = us / units / 1e3
        return {f"ms_per_{unit}": ms, f"share_of_{unit}": ms / 1e3 / (wall_s / units)}

    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP_KERNELS]
    return {
        "device_busy_share": (_union_us(kernels + other) / (wall_s * 1e6)
                              if kernels or other else None),
        f"kernels_per_{unit}": len(kernels) / units,
        f"kernel_ms_per_{unit}": _union_us(kernels) / units / 1e3,
        "top_kernels": [{"name": name, **ms_and_share(us)} for name, us in top],
        "dgrad2d": {**ms_and_share(sum(us for name, us in by_name.items() if "dgrad2d" in name)),
                    "kernels": sorted(name for name in by_name if "dgrad2d" in name)},
    }


def traced_run(trace_dir: Optional[str], run, units: int, unit: str):
    """``run()``, which returns its wall seconds, under ``device_trace``
    into ``trace_dir`` (kept) or a temporary directory (deleted); returns
    the wall and the trace's :func:`kernel_breakdown`."""
    from gan_deeplearning4j_tpu_torch.utils.profiling import device_trace

    with contextlib.ExitStack() as stack:
        directory = trace_dir or stack.enter_context(
            tempfile.TemporaryDirectory(prefix="profile_trace_"))
        with device_trace(directory):
            wall_s = run()
        return wall_s, kernel_breakdown(os.path.join(directory, "trace.json"), wall_s, units, unit)


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def _tensor_bytes(tree) -> int:
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, dict):
        return sum(_tensor_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_tensor_bytes(v) for v in tree)
    return 0


# -- iteration ----------------------------------------------------------------
def bytes_lower_bound(exp, feats, labels) -> int:
    """Bytes one iteration must at least move: every param and updater-state
    leaf of the experiment's states, one gradient per trained leaf, and the
    batch, each once."""
    total = _tensor_bytes(feats) + _tensor_bytes(labels)
    trainers = {"dis": exp.dis_trainer, "gan": exp.gan_trainer, "cv": exp.cv_trainer}
    for name, tree in exp._trees().items():
        if tree is None:
            continue
        params = getattr(tree, "params", tree)
        total += _tensor_bytes(params) + _tensor_bytes(getattr(tree, "opt_state", None))
        trainer = trainers.get(name)
        if trainer is not None:
            total += sum(_tensor_bytes(params[layer][pname])
                         for layer, pname in trainer.optimizer.trainable_keys(params))
    return total


def _mnist_experiment(batch: int, compute_dtype, cpu: bool):
    """Config 1's experiment at ``batch`` and a seeded batch on its device."""
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment

    cfg = ExperimentConfig(
        batch_size_train=batch, batch_size_pred=batch, save_models=False,
        compute_dtype=compute_dtype, use_accelerator=not cpu,
    )
    exp = make_experiment(cfg)
    rng = np.random.default_rng(0)
    # a device-resident batch: the steady state under the device iterators
    feats = torch.as_tensor(exp.family.synthetic_data(batch, exp.model_cfg, 0)[:batch]).to(exp.device)
    labels = torch.as_tensor(
        np.eye(10, dtype=np.float32)[rng.integers(0, 10, size=batch)]).to(exp.device)
    return exp, feats, labels


def profile_once(exp, feats, labels, iters: int, trace_dir: Optional[str]) -> dict:
    """One dtype's run of ``iteration`` on a fresh experiment: the warm
    calls (the captures), then the timed, traced calls."""
    batch = feats.shape[0]
    for _ in range(WARM_CALLS):  # the captures, outside the trace
        fence(exp.train_iteration(feats, labels))

    def run():
        t0 = time.perf_counter()
        for _ in range(iters):
            with exp.timer.phase("fused_iteration") as sink:
                losses = exp.train_iteration(feats, labels)
                sink.extend(losses.values())
        fence(losses)
        return time.perf_counter() - t0

    wall_s, breakdown = traced_run(trace_dir, run, iters, "iter")
    wall = wall_s / iters
    flops = exp.flops_per_iteration(batch)
    nbytes = bytes_lower_bound(exp, feats, labels)
    return {
        "compute_dtype": exp.config.compute_dtype or "f32",
        "sec_per_iter": wall,
        "images_per_sec": batch / wall,
        "flops_per_iter": flops,
        "bytes_lower_bound_per_iter": nbytes,
        "arithmetic_intensity_upper_bound_flops_per_byte": flops / nbytes,
        "achieved_flops_per_sec": flops / wall,
        **breakdown,
        "phase_report": exp.timer.report(),
    }


def sweep_row(exp, feats, labels, batch: int, iters: int) -> dict:
    """Marginal seconds per iteration of ``exp`` from two chained windows
    of ``iters // 4`` and ``iters`` calls, each closed by one fence on its
    last call, after a settling window of 10."""
    def call():
        return exp.train_iteration(feats, labels)

    timed_window(call, 10)  # settle (and capture)
    short, long = timed_window(call, iters // 4), timed_window(call, iters)
    marginal = (long - short) / (iters - iters // 4)
    return {"batch": batch, "sec_per_iter": marginal, "images_per_sec": batch / marginal,
            "flops_per_iter": exp.flops_per_iteration(batch)}


def batch_sweep(batches, compute_dtype, iters: int, cpu: bool, profiled=None) -> list:
    """Throughput against batch size: one :func:`sweep_row` per batch.
    ``profiled`` is ``(exp, feats, labels)`` of the profiled run, whose
    batch it serves (it is captured already: the JAX script builds and
    compiles that batch again)."""
    rows = []
    for batch in batches:
        reuse = profiled is not None and profiled[1].shape[0] == batch
        exp, feats, labels = profiled if reuse else _mnist_experiment(batch, compute_dtype, cpu)
        rows.append(sweep_row(exp, feats, labels, batch, iters))
        if not reuse:
            exp.close()
        print(json.dumps(rows[-1]), flush=True)
    return rows


def run_iteration(args) -> dict:
    device = torch.device("cpu" if args.cpu else "cuda:0")
    results = {"platform": "cpu" if args.cpu else "gpu", "device_kind": _device_kind(device),
               "batch": args.batch, "runs": []}
    profiled = {}
    for dtype in (None, "bf16"):
        trace_dir = f"{args.trace_dir}_{'bf16' if dtype else 'f32'}" if args.trace_dir else None
        profiled[dtype] = _mnist_experiment(args.batch, dtype, args.cpu)
        r = profile_once(*profiled[dtype], args.iters, trace_dir)
        print(json.dumps({k: v for k, v in r.items() if k != "phase_report"}), flush=True)
        print(r["phase_report"], flush=True)
        results["runs"].append(r)
    batches = [int(b) for b in args.sweep.split(",")] if args.sweep else []
    if batches:
        results["batch_sweep"] = {dtype or "f32": batch_sweep(batches, dtype, args.sweep_iters,
                                                              args.cpu, profiled[dtype])
                                  for dtype in (None, "bf16")}
    for exp, _, _ in profiled.values():
        exp.close()
    return results


# -- wgan -----------------------------------------------------------------------
def _flops(fn) -> int:
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn()
    return int(counter.get_total_flops())


def wgan_costs(trainer, critic_state, gen_state, real, z, epsilon) -> Dict[str, int]:
    """``FlopCounterMode``'s FLOPs of the round's parts at one critic
    minibatch (``real`` (b, F), ``z`` (b, z), ``epsilon`` (b, 1)). Every
    loss term makes its fakes as ``critic_loss`` does (the generator's
    forward in inference mode, not differentiated), so the terms are
    comparable; the critic round repeats the minibatch ``n_critic``
    times."""
    from gan_deeplearning4j_tpu_torch.ops import losses as loss_ops
    from gan_deeplearning4j_tpu_torch.parallel.trainer import grad_leaves

    n = trainer.cfg.n_critic
    b = real.shape[0]
    cparams, gparams = critic_state.params, gen_state.params

    def gen_fake():
        with torch.no_grad():
            return trainer.generator.output(gparams, z, train=False).reshape(b, -1)

    def grad_of(loss_fn):
        def run():
            params, _, leaves = grad_leaves(trainer.critic_opt, cparams)
            with torch.enable_grad():
                # the penalty does not read the score's bias: its gradient is none
                return torch.autograd.grad(loss_fn(params), leaves, allow_unused=True)
        return run

    def w_loss(params):
        fake = gen_fake()
        return torch.mean(trainer._score(params, fake)) - torch.mean(trainer._score(params, real))

    def gp_loss(params):
        return loss_ops.gradient_penalty(lambda x: trainer._score(params, x), real, gen_fake(),
                                         epsilon)

    def critic_forward():
        with torch.no_grad():
            trainer._score(cparams, real)

    return {
        "critic_forward": _flops(critic_forward),
        "generator_forward": _flops(gen_fake),
        "w_term_grad": _flops(grad_of(w_loss)),
        "gp_term_grad": _flops(grad_of(gp_loss)),
        "full_loss_grad": _flops(lambda: trainer.critic_grads(cparams, gparams, real, z, epsilon)),
        "critic_round": _flops(lambda: trainer.critic_round(
            critic_state, gparams, real.expand(n, *real.shape), z.expand(n, *z.shape),
            epsilon.expand(n, *epsilon.shape))),
        "gen_step": _flops(lambda: trainer.gen_step(gen_state, cparams, z)),
    }


def wgan_analysis(costs: Dict[str, int], n_critic: int) -> dict:
    """The JAX script's three ratios. Each term program holds one generator
    forward, subtracted so the sharing ratio compares critic work only."""
    fwd_f, gen_f = costs["critic_forward"], costs["generator_forward"]
    w_c, gp_c, full_c = (costs[k] - gen_f for k in ("w_term_grad", "gp_term_grad",
                                                    "full_loss_grad"))
    full_f = costs["full_loss_grad"]
    return {
        # about 6x in matrix products and convolutions: the penalty's forward
        # and input-gradient passes, then a backward pass through each
        "gp_grad_over_forward": gp_c / fwd_f if fwd_f else None,
        # 1.0 = the Wasserstein and penalty terms share no work
        "full_over_sum_of_terms": full_c / (w_c + gp_c) if (w_c + gp_c) else None,
        # the round against n_critic full-loss gradients
        "round_over_ncritic_fullgrad": costs["critic_round"] / (n_critic * full_f) if full_f else None,
    }


def _wgan_experiment(args, f: int):
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig, make_experiment

    rows = args.n_critic * args.batch
    cfg = ExperimentConfig(
        model_family="wgan_gp", height=args.height, width=args.width, channels=args.channels,
        num_features=f, z_size=args.z_size, n_critic=args.n_critic, batch_size_train=rows,
        batch_size_pred=rows, save_models=False, use_accelerator=not args.cpu,
    )
    return make_experiment(cfg)


def run_wgan(args) -> dict:
    from gan_deeplearning4j_tpu_torch.models.wgan_gp import WganGpConfig, WganGpTrainer

    device = torch.device("cpu" if args.cpu else "cuda:0")
    cfg = WganGpConfig(
        height=args.height, width=args.width, channels=args.channels, z_size=args.z_size,
        n_critic=args.n_critic, **({"base_filters": 8, "dense_width": 32} if args.cpu else {}),
    )
    tr = WganGpTrainer(cfg)
    critic_state, gen_state = tr.init_states(seed=0, device=device)
    b, f = args.batch, cfg.num_features
    rng = np.random.default_rng(0)
    g = torch.Generator().manual_seed(1)
    real = torch.as_tensor(rng.random((b, f), dtype=np.float32)).to(device)
    z = torch.randn((b, cfg.z_size), generator=g).to(device)
    epsilon = torch.rand((b, 1), generator=g).to(device)
    costs = wgan_costs(tr, critic_state, gen_state, real, z, epsilon)
    analysis = wgan_analysis(costs, cfg.n_critic)
    del tr, critic_state, gen_state

    # -- wall clock: the bench's window of rounds, replayed, traced
    exp = _wgan_experiment(args, f)
    k = args.scan_window
    rounds = torch.as_tensor(
        rng.random((k, args.n_critic * b, f), dtype=np.float32)).to(exp.device)
    fence(exp.train_iterations(rounds))  # the captures
    chunk_secs = [timed_window(lambda: exp.train_iterations(rounds), 1)
                  for _ in range(args.chunks)]
    per_round = np.asarray(chunk_secs) / k
    # the trace: one more, short window (a round is thousands of kernels;
    # the chunks run without the profiler)
    traced_rounds = rounds[:TRACED_ROUNDS]
    trace_s, breakdown = traced_run(
        args.trace_dir, lambda: timed_window(lambda: exp.train_iterations(traced_rounds), 1),
        traced_rounds.shape[0], "round")
    exp.close()
    wall = {
        "scan_window": k,
        "sec_per_round": float(per_round.mean()),
        "images_per_sec": args.n_critic * b / float(per_round.mean()),
        "cross_chunk_jitter": (float(per_round.std(ddof=1) / per_round.mean())
                               if len(per_round) > 1 else None),
        "chunk_seconds": chunk_secs,
        "traced_rounds": traced_rounds.shape[0],
        "traced_sec_per_round": trace_s / traced_rounds.shape[0],
        **breakdown,
    }
    return {
        "platform": "cpu" if args.cpu else "gpu",
        "device_kind": _device_kind(device),
        "shapes": {"batch": b, "n_critic": cfg.n_critic, "features": f, "z_size": cfg.z_size},
        "model": {name: getattr(cfg, name)
                  for name in ("height", "width", "channels", "base_filters", "dense_width")},
        "costs_flops": costs,
        "analysis": analysis,
        "wall": wall,
    }


# -- the CLI ----------------------------------------------------------------------
def parse_args(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(prog="python -m gan_deeplearning4j_tpu_torch.harness.profile",
                                description=__doc__.splitlines()[0])
    sub = p.add_subparsers(dest="command", required=True)
    it = sub.add_parser("iteration", help="profile the DCGAN-MNIST iteration (config 1)")
    it.add_argument("--batch", type=int, default=64)
    it.add_argument("--iters", type=int, default=200)
    it.add_argument("--sweep", default="64,128,256,512",
                    help="comma-separated batch sizes for the throughput sweep ('' skips it)")
    it.add_argument("--sweep-iters", type=int, default=200,
                    help="calls in the sweep's long window (the short one has a quarter)")
    wg = sub.add_parser("wgan", help="decompose and time the WGAN-GP round")
    wg.add_argument("--height", type=int, default=32)
    wg.add_argument("--width", type=int, default=32)
    wg.add_argument("--channels", type=int, default=3)
    wg.add_argument("--z-size", type=int, default=128)
    wg.add_argument("--n-critic", type=int, default=5)
    wg.add_argument("--batch", type=int, default=64, help="rows a critic step")
    wg.add_argument("--scan-window", type=int, default=32)
    wg.add_argument("--chunks", type=int, default=8)
    for sp in (it, wg):
        sp.add_argument("--trace-dir", default=None,
                        help="keep the torch.profiler traces here (default: not kept)")
        sp.add_argument("--out", default=None, help="also write the summary to this file")
        sp.add_argument("--cpu", action="store_true", help="run on the CPU instead of the card")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.cpu and not torch.cuda.is_available():
        sys.stderr.write("profile: no CUDA device is available; pass --cpu to run on the CPU\n")
        return 2
    if args.command == "iteration":
        out = run_iteration(args)
    else:
        out = run_wgan(args)
        print(json.dumps({"analysis": out["analysis"], "wall": out["wall"]}), flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(out, fh, indent=2)
            fh.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
