"""Deterministic fault injection — the test plane of the resilience layer.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/resilience/faults.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package. One seed gives one schedule in both packages (stdlib
``random``), and either package reads the other's schedule files.

Preemptible workers fail in a handful of shapes: the process dies
mid-step (crash / OOM / segfault), the scheduler sends SIGTERM with a grace
window, a checkpoint write stalls or errors, or bytes rot on disk. Each
shape is a :class:`FaultSpec` kind:

- ``raise``       — raise :class:`InjectedFault` at the start of step N
                    (the trappable worker fault: exercises the supervisor's
                    in-process retry/backoff path);
- ``preempt``     — send SIGTERM to the current process at step N (the
                    scheduler-preemption shape: exercises checkpoint-then-
                    clean-exit);
- ``kill``        — SIGKILL the current process at step N (the untrappable
                    hard kill: only a *relauncher* — the drill — recovers);
- ``slow_write``  — sleep ``seconds`` inside the next checkpoint publish at
                    or after step N;
- ``fail_write``  — raise ``OSError`` inside that publish;
- ``corrupt``     — after the first publish at or after step N, flip bytes
                    in one member file of the published generation (the
                    bit-rot shape the store must quarantine).

Multi-worker (mesh) shapes — the ways an N-writer coordinated publish can
die, hooked by ``resilience/mesh.py``'s two-phase protocol:

- ``straggler``     — sleep ``seconds`` before staging this worker's shard
                      at the first mesh publish at or after step N (the
                      slow-writer shape: the commit must wait, not tear);
- ``kill_shard_staged`` — SIGKILL this worker right after its shard
                      manifest lands but before the mesh commit (a writer
                      dead inside the commit window);
- ``kill_commit``   — SIGKILL the coordinator after the all-shards barrier
                      but before the commit marker is written;
- ``kill_committed`` — SIGKILL the coordinator after the commit marker but
                      before the atomic rename / ledger write (the
                      marker-without-publication window).

Every spec may carry ``args: {"worker": k}`` to target one worker of a
shared schedule; an injector constructed with ``worker_id`` skips specs
aimed at other workers (specs without ``worker`` fire everywhere).

Schedules are *deterministic*: either an explicit spec list or
:meth:`FaultSchedule.seeded`, which derives (step, kind) pairs from a seed
via ``random.Random`` — the same seed always yields the same faults, so a
drill failure reproduces exactly. Schedules round-trip through JSON
(documented in docs/RESILIENCE.md) so a parent process can hand one to a
worker via a file path.

Every fired fault is recorded in ``FaultInjector.log`` — the drill's
ground truth for "the kill happened at step N".
"""

from __future__ import annotations

import dataclasses
import json
import os
import random
import signal
import time
from typing import Dict, List, Optional, Sequence

from gan_deeplearning4j_tpu_torch.resilience.store import MANIFEST_NAME, gen_dirname

FORMAT_VERSION = 1

STEP_KINDS = ("raise", "preempt", "kill")
WRITE_KINDS = ("slow_write", "fail_write")
MESH_KINDS = ("straggler", "kill_shard_staged", "kill_commit",
              "kill_committed")
KINDS = STEP_KINDS + WRITE_KINDS + ("corrupt",) + MESH_KINDS


class InjectedFault(RuntimeError):
    """The trappable worker fault (``raise`` kind)."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scheduled fault. ``step`` semantics: ``raise``/``preempt``/
    ``kill`` fire exactly at the start of step ``step``; write/corrupt
    kinds fire on the first checkpoint publish at or after ``step`` (a
    publish may not land on an arbitrary step, so exact match would make
    those faults silently unreachable)."""

    kind: str
    step: int
    args: Dict = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r} "
                             f"(known: {', '.join(KINDS)})")
        if self.step < 0:
            raise ValueError("fault step must be >= 0")


@dataclasses.dataclass
class FaultSchedule:
    """An ordered, deterministic set of faults."""

    specs: List[FaultSpec] = dataclasses.field(default_factory=list)

    @classmethod
    def seeded(cls, seed: int, total_steps: int,
               kinds: Sequence[str] = ("raise",),
               n_faults: int = 1) -> "FaultSchedule":
        """A seeded random schedule: ``n_faults`` distinct steps in
        ``[1, total_steps)`` with kinds drawn from ``kinds`` — the same
        seed always yields the same schedule."""
        if total_steps < 2:
            raise ValueError("total_steps must be >= 2 to place a fault")
        rng = random.Random(seed)
        n = min(n_faults, total_steps - 1)
        steps = sorted(rng.sample(range(1, total_steps), n))
        return cls([FaultSpec(kind=rng.choice(list(kinds)), step=s)
                    for s in steps])

    def to_json(self, path: str) -> None:
        payload = {
            "format_version": FORMAT_VERSION,
            "faults": [
                {"kind": s.kind, "step": s.step, "args": s.args}
                for s in self.specs
            ],
        }
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=2)
            fh.write("\n")

    @classmethod
    def from_json(cls, path: str) -> "FaultSchedule":
        with open(path) as fh:
            payload = json.load(fh)
        if payload.get("format_version", 0) > FORMAT_VERSION:
            raise ValueError(
                f"fault schedule format {payload['format_version']} is newer "
                f"than supported {FORMAT_VERSION}")
        return cls([
            FaultSpec(kind=f["kind"], step=int(f["step"]),
                      args=dict(f.get("args", {})))
            for f in payload.get("faults", [])
        ])


def corrupt_generation(store, number: int, seed: int = 0,
                       member: Optional[str] = None) -> str:
    """Flip 8 bytes in the middle of one member file of a *published*
    generation — in place, size-preserving, seeded member choice. Returns
    the corrupted member name. The store's digest verification must
    subsequently quarantine the generation; that is the invariant the
    drill checks."""
    path = os.path.join(store.generations_dir, gen_dirname(number))
    members = sorted(
        n for n in os.listdir(path)
        if n != MANIFEST_NAME and os.path.isfile(os.path.join(path, n))
    )
    if not members:
        raise ValueError(f"generation {number} has no members to corrupt")
    name = member or random.Random(seed).choice(members)
    fp = os.path.join(path, name)
    size = os.path.getsize(fp)
    offset = max(0, size // 2 - 4)
    with open(fp, "r+b") as fh:
        fh.seek(offset)
        chunk = fh.read(8)
        fh.seek(offset)
        fh.write(bytes(b ^ 0xFF for b in chunk))
        fh.flush()
        os.fsync(fh.fileno())
    return name


class FaultInjector:
    """Executes a :class:`FaultSchedule` against the supervisor's hook
    points. Each spec fires at most once. ``sleep`` is injectable so tests
    assert slow-write behavior without wall-clock waits."""

    def __init__(self, schedule: Optional[FaultSchedule] = None,
                 sleep=time.sleep, worker_id: Optional[int] = None) -> None:
        self.schedule = schedule or FaultSchedule()
        self._sleep = sleep
        self.worker_id = worker_id
        self._fired: set = set()
        self.log: List[dict] = []

    def _aimed_at_me(self, spec: FaultSpec) -> bool:
        """A spec with ``args.worker`` targets ONE worker of a shared
        schedule; without it (or without a worker identity) it fires
        everywhere — single-process schedules keep working unchanged."""
        target = spec.args.get("worker")
        return (target is None or self.worker_id is None
                or int(target) == self.worker_id)

    def _take(self, kinds, predicate):
        for i, spec in enumerate(self.schedule.specs):
            if i in self._fired or spec.kind not in kinds:
                continue
            if not self._aimed_at_me(spec):
                continue
            if predicate(spec):
                self._fired.add(i)
                yield spec

    def _record(self, spec: FaultSpec, step: int) -> None:
        self.log.append({"kind": spec.kind, "scheduled_step": spec.step,
                         "fired_step": step, "at": time.time()})

    # -- hook points ----------------------------------------------------
    def on_step(self, step: int) -> None:
        """Called by the supervisor at the START of every training step."""
        for spec in self._take(STEP_KINDS, lambda s: s.step == step):
            self._record(spec, step)
            if spec.kind == "raise":
                raise InjectedFault(
                    f"injected worker fault at step {step}")
            if spec.kind == "preempt":
                os.kill(os.getpid(), signal.SIGTERM)
                return  # handler runs on this signal's delivery
            if spec.kind == "kill":
                os.kill(os.getpid(), signal.SIGKILL)  # no cleanup, by design

    def on_checkpoint_write(self, step: int) -> None:
        """Called by the store at the start of every publish."""
        for spec in self._take(WRITE_KINDS, lambda s: step >= s.step):
            self._record(spec, step)
            if spec.kind == "slow_write":
                self._sleep(float(spec.args.get("seconds", 1.0)))
            elif spec.kind == "fail_write":
                raise OSError(
                    f"injected checkpoint write failure at step {step}")

    # -- mesh (two-phase publish) hook points ---------------------------
    def _kill_at(self, kind: str, step: int) -> None:
        for spec in self._take((kind,), lambda s: step >= s.step):
            self._record(spec, step)
            os.kill(os.getpid(), signal.SIGKILL)  # no cleanup, by design

    def on_shard_write(self, step: int) -> None:
        """Called by the mesh publish before this worker stages its shard
        (``straggler`` sleeps here — the slow-writer shape)."""
        for spec in self._take(("straggler",), lambda s: step >= s.step):
            self._record(spec, step)
            self._sleep(float(spec.args.get("seconds", 1.0)))

    def on_shard_staged(self, step: int) -> None:
        """Called after this worker's shard manifest (its phase-1 vote)
        lands, before the mesh commit."""
        self._kill_at("kill_shard_staged", step)

    def on_mesh_commit(self, step: int) -> None:
        """Coordinator only: after the all-shards barrier, before the
        commit marker is written."""
        self._kill_at("kill_commit", step)

    def on_mesh_committed(self, step: int) -> None:
        """Coordinator only: after the commit marker, before the atomic
        rename publishes it and the ledger records it."""
        self._kill_at("kill_committed", step)

    def on_published(self, store, generation) -> None:
        """Called by the supervisor after every successful publish."""
        for spec in self._take(("corrupt",),
                               lambda s: generation.step >= s.step):
            self._record(spec, generation.step)
            name = corrupt_generation(
                store, generation.number,
                seed=int(spec.args.get("seed", 0)),
                member=spec.args.get("member"),
            )
            self.log[-1]["member"] = name
