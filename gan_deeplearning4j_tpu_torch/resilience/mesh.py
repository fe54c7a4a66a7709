"""Mesh-scale checkpoint coordination — N workers, one generation.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/resilience/mesh.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package. Mesh workers are independent processes sharing one
directory: the protocol is files, not ``torch.distributed``, and a
round committed by either package's workers is one generation to both
packages' stores.

The checkpoint store is single-writer: one supervisor stages a full checkpoint and
an atomic rename publishes it. At mesh scale that design wastes N-1 copies
of every byte (each replica redundantly holds full state) and has no story
for a worker dying mid-publish. This module makes a *mesh generation* the
unit of durability: each of N workers stages only its **shard** of the
trained state, and worker 0 commits the whole generation with a two-phase
protocol whose publication point is still one atomic rename — so the
all-or-nothing property of the single-writer store survives the move to N
writers.

Coordination substrate: the shared store root itself (stdlib file
barriers). No sockets, no coordinator service — a worker that can write
its shard can also rendezvous, and the store's durability guarantees
(temp+fsync+rename for every marker) double as the barrier's. Layout:

```
<root>/
  .mesh/<token>/                     # barrier + decision files for one gang
    restore-0.json                   # worker 0's restore resolution
    <name>/w00001                    # barrier arrival markers
  .mesh-stage-<token>-gen-00000007/  # the shared staging dir for one round
    ROUND.json                       # worker 0's round announcement
    <prefix>_state_shard-0001-of-0002.zip   # worker 1's staged shard
    SHARD-00001.json                 # worker 1's phase-1 vote (shard manifest)
    MANIFEST.json                    # worker 0's commit marker (phase 2)
  generations/gen-00000007/          # the published mesh generation
```

The two-phase publish, step by step (``publish()``):

1. **round open** — worker 0 reserves the next generation number, creates
   the staging dir, and announces ``{generation, step, world_size}`` in
   ``ROUND.json`` (temp+fsync+rename). Workers find the round by matching
   the step they are publishing at — the supervisor's deterministic
   schedule guarantees every worker publishes at the same step boundaries.
2. **shard staging (phase 1)** — every worker writes its shard files into
   the staging dir, fsyncs them, and *votes* by atomically writing
   ``SHARD-<k>.json``: a per-shard manifest of sha256 digests + byte
   counts. A worker killed mid-write never votes; its half-written files
   are invisible to the protocol.
3. **commit (phase 2, worker 0 only)** — wait for all ``world_size``
   votes (bounded; a missing vote is a :class:`MeshTimeout`, never a
   partial commit), re-hash every staged file, cross-check each shard
   manifest byte for byte, fold the sorted ``name|digest`` stream into
   the **whole-mesh digest**, and write ``MANIFEST.json`` — the commit
   marker, format-identical to a single-writer manifest plus a ``mesh``
   section — into the staging dir.
4. **publication** — fsync, then ``os.replace`` the staging dir to
   ``generations/gen-N``: THE publication point, exactly as single-writer.
   Only after the rename does the ledger record the entry and GC run.
   Non-coordinator workers block on the rename becoming visible (bounded).

Crash analysis — why no failure can surface a torn generation:

- worker k killed mid-write (before its vote): no ``SHARD-k.json``, so
  worker 0 times out and aborts; the staging dir is never renamed.
- worker 0 killed after staging its own shard but before the commit
  marker: no ``MANIFEST.json``, no rename; peers time out on publication.
- worker 0 killed *between the commit marker and the ledger write*: the
  marker lives inside ``.mesh-stage-*`` — until the rename it is just
  bytes in a staging dir ``latest_valid()`` never scans. Killed after the
  rename, the generation is complete and the directory scan (not the
  ledger) defines liveness, exactly like the single-writer window.
- in every abort case the stale staging dir (and the gang's barrier
  files) are swept by the next gang's coordinator at construction —
  token-scoped, so a live gang never sweeps its own round.

Recovery model is **gang restart** (the TensorFlow system paper's
fault-tolerance design: consistent checkpoints + recovery as the only
correctness mechanism): any worker death aborts the whole gang via
bounded barrier timeouts (exit code 76 from the worker CLI), and the
relauncher restarts all N workers with a fresh ``token``. Restore is
*elastic*: ``GanExperiment.load_models`` merges however many shards the
generation holds, so a generation written by M workers restores
bit-exactly onto N workers for any N ≥ 1 (including the serve path).
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import shutil
import time
from typing import Callable, Dict, List, Optional

from gan_deeplearning4j_tpu_torch.resilience.store import (
    CheckpointStore,
    Generation,
    MANIFEST_NAME,
    FORMAT_VERSION,
    _atomic_write_json,
    _fsync_dir,
    _hash_file,
    gen_dirname,
)
from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

ROUND_NAME = "ROUND.json"
MESH_STAGE_PREFIX = ".mesh-stage-"

_TOKEN_RE = re.compile(r"^[A-Za-z0-9_.-]{1,64}$")
_STAGE_RE = re.compile(r"^\.mesh-stage-(?P<token>[A-Za-z0-9_.-]+)-"
                       r"(?P<gen>gen-\d{8})$")


class MeshTimeout(RuntimeError):
    """A bounded mesh wait expired: a peer is dead, wedged, or was never
    launched. Gang semantics make this non-retryable in-process — the
    whole mesh must be relaunched (worker CLI exit code 76)."""


class MeshProtocolError(RuntimeError):
    """The round's on-disk state contradicts the protocol (colliding shard
    files, a vote whose digests do not match the staged bytes, a round
    announcement disagreeing with this worker's step). Terminal: relaunch
    cannot fix a logic error."""


def shard_manifest_name(worker: int) -> str:
    return f"SHARD-{worker:05d}.json"


def mesh_digest(files: Dict[str, dict]) -> str:
    """The whole-mesh digest: sha256 over the sorted ``name|digest|bytes``
    stream of every staged file. One scalar that pins the entire N-writer
    generation — the commit marker stores it, and any reader can recompute
    it from the manifest alone."""
    h = hashlib.sha256()
    for name in sorted(files):
        meta = files[name]
        h.update(f"{name}|{meta['digest']}|{meta['bytes']}\n".encode())
    return "sha256:" + h.hexdigest()


class MeshCoordinator:
    """One worker's handle on the gang. ``worker`` 0 is the coordinator
    (commits generations, resolves restores); all workers share the store
    ``root`` and a per-gang-launch ``token`` (any stale round or barrier
    state from a *dead* gang carries a different token and is swept by the
    next coordinator's construction — a live gang never collides with a
    corpse). ``timeout_s`` bounds every in-round wait; ``boot_timeout_s``
    bounds the first rendezvous (restore resolution), which must absorb
    cold-start skew between worker processes. ``sleep`` is injectable so
    tests assert waits without wall-clock stalls. ``sweep=False`` skips
    the coordinator's stale-gang sweep — REQUIRED for barrier-only users
    (scripts/multihost_smoke.py) rendezvousing on a root where an
    unrelated checkpoint gang may be live: to the sweep, that gang's
    in-flight round is indistinguishable from a corpse."""

    def __init__(self, root: str, worker: int, world_size: int,
                 token: str = "r0", timeout_s: float = 60.0,
                 boot_timeout_s: Optional[float] = None,
                 poll_s: float = 0.05, faults=None,
                 sleep: Callable[[float], None] = time.sleep,
                 sweep: bool = True) -> None:
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        if not 0 <= worker < world_size:
            raise ValueError(f"worker {worker} outside mesh of "
                             f"{world_size}")
        if not _TOKEN_RE.match(token):
            raise ValueError(f"token {token!r} must match "
                             f"{_TOKEN_RE.pattern}")
        self.root = os.path.abspath(root)
        self.worker = worker
        self.world_size = world_size
        self.token = token
        self.timeout_s = timeout_s
        self.boot_timeout_s = (timeout_s if boot_timeout_s is None
                               else boot_timeout_s)
        self.poll_s = poll_s
        self.faults = faults
        self._sleep = sleep
        self.mesh_dir = os.path.join(self.root, ".mesh", token)
        os.makedirs(self.mesh_dir, exist_ok=True)
        # per-phase timings of the most recent publish (None until one
        # lands) — the supervisor stamps these into its summary timeline
        self.last_phases: Optional[dict] = None
        registry = get_registry()
        self._c_commits = registry.counter(
            "resilience_mesh_commits_total",
            "mesh generations committed by this worker (coordinator only)")
        self._h_commit = registry.histogram(
            "resilience_mesh_commit_seconds",
            "wall seconds per coordinated mesh publish (stage + barrier + "
            "commit + rename), per worker")
        self._c_aborts = registry.counter(
            "resilience_mesh_aborts_total",
            "mesh rounds abandoned on a bounded-wait timeout")
        self._g_generation = registry.gauge(
            "resilience_generation",
            "newest published generation in the store this process opened "
            "(-1 = none)")
        if self.is_coordinator and sweep:
            self._sweep_stale()

    # -- identity -------------------------------------------------------
    @property
    def is_coordinator(self) -> bool:
        return self.worker == 0

    # -- stale-gang sweeping --------------------------------------------
    def _sweep_stale(self) -> None:
        """Remove state left by DEAD gangs. Gang restart is the only path
        here — the relauncher starts a fresh coordinator only after the
        previous gang is fully gone — so anything already on disk at
        coordinator construction is a corpse. What may be swept follows
        ownership: staging dirs and restore decisions are created ONLY by
        a coordinator, and this gang's coordinator (us) has created none
        yet, so every existing one — our own token included, guarding a
        relauncher that (against the CLI contract) reused a token — is
        safe to remove. Barrier arrival markers are written by PEERS, and
        a same-token peer of THIS gang may already have arrived, so own-
        token barrier dirs are never touched (a reused token therefore
        still risks ghost arrivals — the fresh-token rule stands)."""
        for name in os.listdir(self.root):
            if _STAGE_RE.match(name):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        meshes = os.path.join(self.root, ".mesh")
        for name in os.listdir(meshes):
            if name != self.token:
                shutil.rmtree(os.path.join(meshes, name),
                              ignore_errors=True)
        for name in os.listdir(self.mesh_dir):
            if name.startswith("restore-") and name.endswith(".json"):
                try:
                    os.unlink(os.path.join(self.mesh_dir, name))
                except OSError:
                    pass

    # -- primitive waits ------------------------------------------------
    def _wait_for(self, predicate: Callable[[], bool], what: str,
                  timeout_s: Optional[float] = None) -> None:
        deadline = time.monotonic() + (self.timeout_s if timeout_s is None
                                       else timeout_s)
        while not predicate():
            if time.monotonic() >= deadline:
                self._c_aborts.inc()
                TRACER.instant("resilience.mesh_timeout",
                               {"worker": self.worker, "what": what})
                raise MeshTimeout(
                    f"worker {self.worker}/{self.world_size} timed out "
                    f"waiting for {what} (gang abort — relaunch the mesh)")
            self._sleep(self.poll_s)

    def barrier(self, name: str, timeout_s: Optional[float] = None) -> None:
        """Meet the gang: arrive by atomically creating
        ``.mesh/<token>/<name>/w<worker>``, then wait (bounded) until all
        ``world_size`` arrival markers exist. Names must be unique per
        rendezvous within one token (the supervisor keys them by step)."""
        d = os.path.join(self.mesh_dir, name)
        os.makedirs(d, exist_ok=True)
        _atomic_write_json(os.path.join(d, f"w{self.worker:05d}"),
                           {"worker": self.worker, "at": time.time()})

        def all_arrived() -> bool:
            try:
                present = os.listdir(d)
            except OSError:
                return False
            return sum(1 for n in present if n.startswith("w")
                       and not n.endswith(".tmp")) >= self.world_size

        self._wait_for(all_arrived, f"barrier {name!r}", timeout_s)

    # -- coordinated restore --------------------------------------------
    def resolve_restore(self, store: CheckpointStore,
                        attempt: int = 0) -> Optional[Generation]:
        """One restore decision for the whole gang. Worker 0 runs
        ``latest_valid()`` — performing any quarantine moves exactly once —
        and publishes the chosen generation number as a decision file; the
        other workers wait for the decision and load that generation
        read-only. Without this, N workers would race their quarantine
        renames against each other's digest walks."""
        decision_path = os.path.join(self.mesh_dir,
                                     f"restore-{attempt}.json")
        if self.is_coordinator:
            generation = store.latest_valid()
            _atomic_write_json(decision_path, {
                "generation": None if generation is None
                else generation.number,
                "attempt": attempt,
            })
            return generation
        self._wait_for(lambda: os.path.exists(decision_path),
                       f"restore decision (attempt {attempt})",
                       self.boot_timeout_s)
        with open(decision_path) as fh:
            decision = json.load(fh)
        if decision["generation"] is None:
            return None
        return store.load(int(decision["generation"]))

    # -- the two-phase coordinated publish ------------------------------
    def _stage_dirname(self, number: int) -> str:
        return f"{MESH_STAGE_PREFIX}{self.token}-{gen_dirname(number)}"

    def _find_round(self, step: int) -> tuple:
        """Non-coordinator: locate the staging dir whose ``ROUND.json``
        announces this step (bounded wait). Returns (number, staging)."""
        found: Dict[str, tuple] = {}

        def round_visible() -> bool:
            for name in os.listdir(self.root):
                m = _STAGE_RE.match(name)
                if not m or m.group("token") != self.token:
                    continue
                try:
                    with open(os.path.join(self.root, name,
                                           ROUND_NAME)) as fh:
                        announced = json.load(fh)
                except (OSError, json.JSONDecodeError):
                    continue  # round dir exists, announcement not landed yet
                if int(announced.get("step", -1)) == step:
                    found["round"] = (int(announced["generation"]),
                                      os.path.join(self.root, name),
                                      announced)
                    return True
            return False

        self._wait_for(round_visible, f"round announcement for step {step}")
        number, staging, announced = found["round"]
        if int(announced.get("world_size", -1)) != self.world_size:
            raise MeshProtocolError(
                f"round for step {step} announces world_size "
                f"{announced.get('world_size')} but this worker joined a "
                f"mesh of {self.world_size}")
        return number, staging

    def publish(self, store: CheckpointStore,
                shard_writer: Callable[[str], List[str]], step: int,
                extra: Optional[dict] = None) -> Generation:
        """Coordinated publish of one mesh generation at ``step``. Every
        worker of the gang must call this at the same step with its own
        ``shard_writer(staging_dir) -> [filenames written]``. Returns the
        published :class:`Generation` on every worker; raises
        :class:`MeshTimeout` on any bounded wait expiring (gang abort —
        the staging dir is deliberately left for the post-mortem and the
        next gang's sweep, never half-cleaned under live peers)."""
        t0 = time.perf_counter()
        if self.is_coordinator:
            number = store.next_number()
            staging = os.path.join(self.root, self._stage_dirname(number))
            os.makedirs(staging)
            _atomic_write_json(os.path.join(staging, ROUND_NAME), {
                "format_version": FORMAT_VERSION,
                "generation": number,
                "step": int(step),
                "world_size": self.world_size,
                "token": self.token,
            })
        else:
            number, staging = self._find_round(step)
        t_announced = time.perf_counter()

        # -- phase 1: stage this worker's shard, then vote --------------
        if self.faults is not None:
            self.faults.on_shard_write(step)
        written = sorted(shard_writer(staging))
        if not written:
            raise MeshProtocolError(
                f"worker {self.worker} staged no files — an empty shard "
                f"can never be restored")
        files: Dict[str, dict] = {}
        for name in written:
            digest, size = _hash_file(os.path.join(staging, name),
                                      fsync=True)
            files[name] = {"digest": digest, "bytes": size}
        _atomic_write_json(os.path.join(staging, shard_manifest_name(
            self.worker)), {
            "format_version": FORMAT_VERSION,
            "worker": self.worker,
            "world_size": self.world_size,
            "generation": number,
            "step": int(step),
            "files": files,
        })
        _fsync_dir(staging)
        t_staged = time.perf_counter()
        if self.faults is not None:
            self.faults.on_shard_staged(step)

        final = os.path.join(store.generations_dir, gen_dirname(number))
        if self.is_coordinator:
            self._commit(store, staging, final, number, step, extra)
        else:
            # publication barrier: the rename becoming visible IS the
            # commit notification — no second marker to race with
            self._wait_for(lambda: os.path.isdir(final),
                           f"publication of generation {number}")
        t_committed = time.perf_counter()
        seconds = t_committed - t0
        # per-phase attribution (docs/OBSERVABILITY.md "straggler
        # attribution"): announce = round rendezvous (a worker whose
        # peers lag waits HERE), stage = this worker writing + hashing
        # its own shard (a straggler's time lands HERE), commit_wait =
        # votes + re-hash + rename on the coordinator, or the publication
        # barrier on everyone else (the fast writers' wait on the
        # straggler lands HERE). Stamped into the supervisor's summary
        # timeline and, when tracing, into per-phase spans that
        # trace_report's barrier table folds by (gen, worker).
        self.last_phases = {
            "announce_s": t_announced - t0,
            "stage_s": t_staged - t_announced,
            "commit_wait_s": t_committed - t_staged,
        }
        self._h_commit.observe(seconds)
        self._g_generation.set(number)
        if TRACER.enabled:
            span_args = {"gen": number, "step": int(step),
                         "worker": self.worker,
                         "coordinator": self.is_coordinator}
            TRACER.complete("resilience.mesh_stage", t_announced, t_staged,
                            dict(span_args))
            TRACER.complete("resilience.mesh_commit_wait", t_staged,
                            t_committed, dict(span_args))
            TRACER.complete("resilience.mesh_publish", t0, t_committed,
                            span_args)
        with open(os.path.join(final, MANIFEST_NAME)) as fh:
            manifest = json.load(fh)
        return Generation(number=number, path=final, manifest=manifest)

    def _commit(self, store: CheckpointStore, staging: str, final: str,
                number: int, step: int, extra: Optional[dict]) -> None:
        """Phase 2, coordinator only: all-votes barrier → whole-mesh
        digest → commit marker → atomic rename → ledger."""
        vote_names = [shard_manifest_name(k)
                      for k in range(self.world_size)]

        def all_voted() -> bool:
            return all(os.path.exists(os.path.join(staging, n))
                       for n in vote_names)

        self._wait_for(all_voted,
                       f"all {self.world_size} shard manifests for "
                       f"generation {number}")
        if self.faults is not None:
            self.faults.on_mesh_commit(step)

        shards: List[dict] = []
        claimed: Dict[str, int] = {}
        for k, name in enumerate(vote_names):
            with open(os.path.join(staging, name)) as fh:
                vote = json.load(fh)
            if (int(vote.get("worker", -1)) != k
                    or int(vote.get("generation", -1)) != number):
                raise MeshProtocolError(
                    f"shard manifest {name} does not belong to this round "
                    f"(worker {vote.get('worker')}, generation "
                    f"{vote.get('generation')})")
            for member in vote.get("files", {}):
                if member in claimed:
                    raise MeshProtocolError(
                        f"shard file {member!r} staged by both worker "
                        f"{claimed[member]} and worker {k} — shard "
                        f"writers must produce disjoint files")
                claimed[member] = k
            shards.append(vote)

        # re-hash EVERY staged byte (shard data, votes, the round file):
        # the combined manifest must pin what is actually on disk, and the
        # cross-check below catches a shard whose vote lied about it
        files: Dict[str, dict] = {}
        for name in sorted(os.listdir(staging)):
            digest, size = _hash_file(os.path.join(staging, name),
                                      fsync=True)
            files[name] = {"digest": digest, "bytes": size}
        for vote in shards:
            for member, meta in vote["files"].items():
                if files.get(member) != meta:
                    raise MeshProtocolError(
                        f"staged file {member!r} does not match worker "
                        f"{vote['worker']}'s shard manifest — torn shard "
                        f"write")

        manifest = {
            "format_version": FORMAT_VERSION,
            "generation": number,
            "step": int(step),
            "files": files,
            "mesh": {
                "world_size": self.world_size,
                "token": self.token,
                "mesh_digest": mesh_digest(files),
                "shards": vote_names,
            },
            **(extra or {}),
        }
        _atomic_write_json(os.path.join(staging, MANIFEST_NAME), manifest)
        if self.faults is not None:
            self.faults.on_mesh_committed(step)
        _fsync_dir(staging)
        os.replace(staging, final)  # THE publication point
        _fsync_dir(store.generations_dir)
        self._c_commits.inc()
        store.note_published(number, step)


__all__ = [
    "MeshCoordinator",
    "MeshTimeout",
    "MeshProtocolError",
    "mesh_digest",
    "shard_manifest_name",
]
