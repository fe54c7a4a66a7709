"""N ranks on one host — the port's counterpart of the JAX package's
``__graft_entry__.spawn_multihost``, and of Spark's ``local[4]``.

``spawn(fn, world_size, ...)`` starts ``world_size`` Python processes.
Each joins one process group through a ``FileStore`` in a fresh temporary
directory (no TCP port, so concurrent launches never collide), calls
``fn(*args, **kwargs)`` and pickles what it returns; ``spawn`` returns the
results in rank order. ``fn`` must be importable by module and name (a
module-level function of this package, not of a test file: a child
imports the module that defines it). The parent drains every child at
once: their output goes to log files, and it polls all of them against
one deadline. When a child fails, the others get ``grace`` seconds (they
are likely blocked in a collective that will never complete) and are
then killed; past the deadline every child left is killed. Either way
``spawn`` raises with the tail of each failed rank's log.

The backend is the caller's: ``"gloo"`` (the CPU with
``use_accelerator=False``; or ranks sharing one card) or ``"nccl"`` (one
card per rank). ``threads`` sets each child's torch thread count (one per
rank keeps N ranks from oversubscribing the host's cores).

As a program it trains with the trainer CLI in every rank (rank 0's
output shown, the others' kept for a failure's report)::

    python -m gan_deeplearning4j_tpu_torch.parallel.launch --nproc 4 \\
        [--backend gloo] [--timeout S] -- --distributed pmean ...

(``torchrun --nproc-per-node 4 -m gan_deeplearning4j_tpu_torch ...`` runs
the same CLI through torchrun's own rendezvous.)
"""

from __future__ import annotations

import argparse
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

_POLL_S = 0.05


def _tail(path: str, n: int = 4000) -> str:
    try:
        with open(path, "rb") as fh:
            data = fh.read()
    except OSError:
        return ""
    return data[-n:].decode(errors="replace")


def spawn(fn: Callable, world_size: int, args: Sequence = (), kwargs: Optional[Dict] = None,
          *, backend: str = "gloo", use_accelerator: bool = False, timeout: Optional[float] = 120.0,
          threads: Optional[int] = 1, grace: float = 10.0, env: Optional[Dict[str, str]] = None,
          echo: bool = False) -> List[Any]:
    """Run ``fn(*args, **kwargs)`` in ``world_size`` ranks of one process
    group; returns the ranks' results in rank order. Raises
    ``RuntimeError`` when a rank fails and ``TimeoutError`` when the
    ranks are not done within ``timeout`` seconds (None: no limit).
    ``echo``: rank 0 writes to this process's output instead of a log."""
    workdir = tempfile.mkdtemp(prefix="gdt_launch_")
    try:
        spec = {"fn": fn, "args": tuple(args), "kwargs": dict(kwargs or {}),
                "world_size": world_size, "backend": backend,
                "use_accelerator": use_accelerator, "threads": threads,
                "init_file": os.path.join(workdir, "store"), "workdir": workdir}
        spec_path = os.path.join(workdir, "spec.pkl")
        with open(spec_path, "wb") as fh:
            pickle.dump(spec, fh)
        child_env = dict(os.environ, **(env or {}))
        # the children import this package from where the parent did
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        child_env["PYTHONPATH"] = os.pathsep.join(
            p for p in (root, child_env.get("PYTHONPATH")) if p)
        if threads is not None:
            child_env["OMP_NUM_THREADS"] = str(threads)
        procs, logs = [], []
        for rank in range(world_size):
            log = os.path.join(workdir, f"rank{rank}.log")
            logs.append(log)
            with open(log, "wb") as out:
                shown = echo and rank == 0
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "gan_deeplearning4j_tpu_torch.parallel.launch",
                     "--child", spec_path, "--rank", str(rank)],
                    stdout=None if shown else out, stderr=None if shown else subprocess.STDOUT,
                    env=child_env))
        deadline = None if timeout is None else time.monotonic() + timeout
        failed_at = None
        while any(p.poll() is None for p in procs):
            now = time.monotonic()
            if failed_at is None and any(p.returncode not in (None, 0) for p in procs):
                failed_at = now
            if deadline is not None and now > deadline or (
                    failed_at is not None and now > failed_at + grace):
                break
            time.sleep(_POLL_S)
        stalled = [r for r, p in enumerate(procs) if p.poll() is None]
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        failed = [r for r, p in enumerate(procs) if p.returncode != 0 and r not in stalled]
        if failed or stalled:
            detail = "\n".join(f"--- rank {r} (exit {procs[r].returncode}) ---\n{_tail(logs[r])}"
                               for r in sorted(set(failed) | set(stalled)))
            if failed:
                raise RuntimeError(f"ranks {failed} failed (killed after them: {stalled})\n{detail}")
            raise TimeoutError(f"ranks {stalled} did not finish within {timeout} s\n{detail}")
        results = []
        for rank in range(world_size):
            with open(os.path.join(workdir, f"result{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results
    finally:
        shutil.rmtree(workdir, ignore_errors=True)


def _child(spec_path: str, rank: int) -> int:
    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    world = spec["world_size"]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                      LOCAL_WORLD_SIZE=str(world))
    import torch

    if spec["threads"] is not None:
        torch.set_num_threads(spec["threads"])
    from gan_deeplearning4j_tpu_torch.runtime.environment import initialize_distributed

    initialize_distributed(rank=rank, world_size=world, init_file=spec["init_file"],
                           backend=spec["backend"], use_accelerator=spec["use_accelerator"])
    result = spec["fn"](*spec["args"], **spec["kwargs"])
    tmp = os.path.join(spec["workdir"], f"result{rank}.tmp")
    with open(tmp, "wb") as fh:
        pickle.dump(result, fh)
    os.replace(tmp, os.path.join(spec["workdir"], f"result{rank}.pkl"))
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _train(argv: List[str]) -> int:
    from gan_deeplearning4j_tpu_torch.__main__ import main

    return main(argv)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m gan_deeplearning4j_tpu_torch.parallel.launch",
        description="train with the trainer CLI in N ranks of one process group on this host")
    parser.add_argument("--nproc", type=int, default=None, help="ranks to start")
    parser.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                        help="default: nccl with --use-accelerator true, gloo with false")
    parser.add_argument("--timeout", type=float, default=None, help="seconds for all ranks")
    parser.add_argument("--threads", type=int, default=None, help="torch threads per rank")
    parser.add_argument("--child", default=None, help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("trainer_args", nargs=argparse.REMAINDER,
                        help="the trainer CLI's flags, after --")
    args = parser.parse_args(argv)
    if args.child is not None:
        return _child(args.child, args.rank)
    if not args.nproc:
        parser.error("--nproc is required")
    trainer_args = args.trainer_args[1:] if args.trainer_args[:1] == ["--"] else args.trainer_args
    from gan_deeplearning4j_tpu_torch.harness import ExperimentConfig

    cfg = ExperimentConfig.from_args(trainer_args)
    backend = args.backend or ("nccl" if cfg.use_accelerator else "gloo")
    # by its module's name: run as a program, this module is __main__
    from gan_deeplearning4j_tpu_torch.parallel import launch

    codes = spawn(launch._train, args.nproc, (trainer_args,), backend=backend,
                  use_accelerator=cfg.use_accelerator, timeout=args.timeout, threads=args.threads,
                  echo=True)
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
