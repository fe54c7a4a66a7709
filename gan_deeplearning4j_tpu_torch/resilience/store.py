"""Generation-ledgered checkpoint store — the durability layer under the
fault-tolerant supervisor.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/resilience/store.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package.

A *generation* is one immutable, self-verifying checkpoint directory:

```
<root>/
  ledger.json                      # the generation ledger (atomic updates)
  generations/
    gen-00000007/
      MANIFEST.json                # per-file content digests + step + extras
      mnist_dis_model.zip          # whatever the writer callback produced
      ...
  quarantine/
    gen-00000006/                  # failed verification — kept for forensics,
                                   # never selected as "latest"
  .stage-...                       # transient staging dirs (crash leftovers
                                   # are swept at store construction)
```

Publish protocol (crash-safe at every point):

1. the writer callback populates a fresh ``.stage-*`` directory;
2. ``MANIFEST.json`` (sha256 digest + byte count per file, the step counter,
   caller extras) is written temp+fsync+rename *inside* the staging dir;
3. every file and the staging dir itself are fsynced;
4. ``os.replace`` renames the staging dir to ``generations/gen-N`` — the
   atomic publication point: a reader either sees the complete generation
   or nothing;
5. the ledger records the entry and retention GC runs.

A crash before (4) leaves only a staging dir (swept later); a crash after
(4) but before (5) leaves a published-but-unledgered generation — the read
side scans the ``generations/`` directory, not the ledger, precisely so
that window loses nothing. The ledger is the *bookkeeping* record: status
transitions (``published`` → ``quarantined`` / ``gc``) and the reasons for
them, which is what the drill asserts its invariants against.

Read side: ``latest_valid()`` walks published generations newest-first,
re-hashing every file against its manifest; a corrupt or truncated
generation is moved to ``quarantine/`` and *flagged in the ledger*, and the
walk falls back to the previous generation — a half-written or bit-flipped
checkpoint is never served as "latest".
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from gan_deeplearning4j_tpu_torch.telemetry.registry import get_registry
from gan_deeplearning4j_tpu_torch.telemetry.trace import TRACER

MANIFEST_NAME = "MANIFEST.json"
LEDGER_NAME = "ledger.json"
FORMAT_VERSION = 1

_GEN_RE = re.compile(r"^gen-(\d{8})$")


def gen_dirname(number: int) -> str:
    return f"gen-{number:08d}"


def _digest_leaf(value) -> Tuple[str, str, bytes]:
    """``(dtype name, shape text, raw bytes)`` of one leaf, spelled as the
    JAX package spells a numpy array (a bfloat16 leaf is ``"bfloat16"``
    over its 2-byte patterns), so both packages digest one tree alike."""
    import torch

    if isinstance(value, torch.Tensor):
        t = value.detach().cpu().contiguous()
        shape = str(tuple(t.shape))
        if t.dtype == torch.bfloat16:
            return "bfloat16", shape, t.view(torch.int16).numpy().tobytes()
        a = t.numpy()
    else:
        a = np.asarray(value)
    return str(a.dtype), str(a.shape), a.tobytes()


def tree_digest(tree) -> str:
    """Canonical content digest of a tree of tensors: sha256 over the
    sorted ``path|dtype|shape|raw bytes`` stream. Unlike a digest of the
    checkpoint *zip* (whose deflate stream embeds member timestamps), this
    is reproducible across runs and processes — the currency of the drill's
    bit-exact-resume invariant."""
    # here, not at the top: the store itself loads without torch
    from gan_deeplearning4j_tpu_torch.utils.serializer import _flatten

    flat: Dict[str, object] = {}
    if isinstance(tree, dict):
        _flatten("t", tree, flat)
    else:  # TrainState-like: digest params + updater + step
        _flatten("t/params", tree.params, flat)
        _flatten("t/updater", tree.opt_state, flat)
        flat["t/step"] = tree.step
    h = hashlib.sha256()
    for key in sorted(flat):
        dtype, shape, raw = _digest_leaf(flat[key])
        h.update(key.encode())
        h.update(dtype.encode())
        h.update(shape.encode())
        h.update(raw)
    return "sha256:" + h.hexdigest()


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _hash_file(path: str, fsync: bool = False) -> Tuple[str, int]:
    """(digest, byte count) of a file, streamed in 1 MiB chunks — constant
    memory on checkpoints of any size. ``fsync=True`` additionally fsyncs
    the same descriptor (one open per file on the publish path)."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as fh:
        for chunk in iter(lambda: fh.read(1 << 20), b""):
            h.update(chunk)
            n += len(chunk)
        if fsync:
            os.fsync(fh.fileno())
    return "sha256:" + h.hexdigest(), n


def _atomic_write_json(path: str, payload: dict) -> None:
    """temp + fsync + rename — the only way any metadata file here lands."""
    directory = os.path.dirname(os.path.abspath(path))
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as fh:
            json.dump(payload, fh, indent=2, sort_keys=True)
            fh.write("\n")
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


@dataclasses.dataclass
class Generation:
    """One verified, readable generation."""

    number: int
    path: str
    manifest: dict

    @property
    def step(self) -> int:
        return int(self.manifest.get("step", 0))

    def file(self, name: str) -> str:
        return os.path.join(self.path, name)


class CheckpointStore:
    """The generation-ledgered store. ``keep_last`` newest published
    generations survive GC unconditionally; additionally every
    ``keep_every``-th generation number is kept forever (0 = off) — the
    keep-last-K + keep-every-N retention policy. A ``fault_injector``
    (``faults.FaultInjector``) hooks the write path for the drill's
    slow/failed-write scenarios; production passes None."""

    def __init__(self, root: str, keep_last: int = 3, keep_every: int = 0,
                 fault_injector=None, read_retries: int = 2,
                 read_retry_backoff_s: float = 0.05,
                 sleep: Callable[[float], None] = time.sleep) -> None:
        if keep_last < 1:
            raise ValueError("keep_last must be >= 1 (the store must always "
                             "retain a newest generation)")
        if keep_every < 0:
            raise ValueError("keep_every must be >= 0 (0 = off)")
        if read_retries < 0:
            raise ValueError("read_retries must be >= 0 (0 = no retries)")
        self.root = os.path.abspath(root)
        self.keep_last = keep_last
        self.keep_every = keep_every
        self.faults = fault_injector
        self.read_retries = read_retries
        self.read_retry_backoff_s = read_retry_backoff_s
        self._sleep = sleep
        self.generations_dir = os.path.join(self.root, "generations")
        self.quarantine_dir = os.path.join(self.root, "quarantine")
        os.makedirs(self.generations_dir, exist_ok=True)
        os.makedirs(self.quarantine_dir, exist_ok=True)
        # sweep crash leftovers: an unrenamed staging dir was never published
        for name in os.listdir(self.root):
            if name.startswith(".stage-"):
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)
        # telemetry registry series (docs/OBSERVABILITY.md): the ledger
        # stays the durable record; these are the live process-wide view
        registry = get_registry()
        self._c_publishes = registry.counter(
            "resilience_publishes_total", "generations published")
        self._h_publish = registry.histogram(
            "resilience_publish_seconds",
            "wall seconds per store publish (write+digest+fsync+rename)")
        self._c_quarantines = registry.counter(
            "resilience_quarantines_total",
            "generations moved to quarantine on failed verification")
        self._g_generation = registry.gauge(
            "resilience_generation",
            "newest published generation in the store this process opened "
            "(-1 = none)")
        self._c_read_retries = registry.counter(
            "resilience_read_retries_total",
            "transient OSError store reads retried before verify/load "
            "passed judgment (shared-filesystem flakes, not corruption)")
        # initialize from the directory scan: a fresh store must read -1,
        # not the gauge's 0.0 default — generation 0 is a REAL generation
        existing = self.published()
        self._g_generation.set(existing[-1] if existing else -1)

    # -- ledger ---------------------------------------------------------
    @property
    def ledger_path(self) -> str:
        return os.path.join(self.root, LEDGER_NAME)

    def ledger(self) -> dict:
        try:
            with open(self.ledger_path) as fh:
                return json.load(fh)
        except (FileNotFoundError, json.JSONDecodeError):
            # a torn ledger is recoverable: the generations/ dir scan is the
            # source of truth for what exists; the ledger restarts empty
            return {"format_version": FORMAT_VERSION, "entries": {}}

    def _update_ledger(self, number: int, **fields) -> None:
        ledger = self.ledger()
        entry = ledger["entries"].setdefault(str(number), {})
        entry.update(fields)
        _atomic_write_json(self.ledger_path, ledger)

    def entry(self, number: int) -> dict:
        return self.ledger()["entries"].get(str(number), {})

    # -- enumeration ----------------------------------------------------
    def _scan(self, directory: str) -> List[int]:
        out = []
        for name in os.listdir(directory):
            m = _GEN_RE.match(name)
            if m and os.path.isdir(os.path.join(directory, name)):
                out.append(int(m.group(1)))
        return sorted(out)

    def published(self) -> List[int]:
        """Generation numbers currently live under ``generations/``
        (ascending). The directory scan — not the ledger — defines
        liveness, so a publish that crashed before its ledger write still
        counts."""
        return self._scan(self.generations_dir)

    def quarantined(self) -> List[int]:
        return self._scan(self.quarantine_dir)

    def generations_newer_than(self, number: Optional[int]) -> List[int]:
        """Published generation numbers strictly newer than ``number``
        (ascending; all of them when ``number`` is None) — the reload
        plane's ledger lookup: a watcher tracking the served generation
        asks only for what it has not seen yet."""
        published = self.published()
        if number is None:
            return published
        return [n for n in published if n > number]

    def next_number(self) -> int:
        """Monotonic across GC and quarantine: one more than anything the
        directories or the ledger have ever seen."""
        seen = self.published() + self.quarantined()
        ledger_nums = [int(k) for k in self.ledger()["entries"]]
        return max(seen + ledger_nums, default=-1) + 1

    # -- publish --------------------------------------------------------
    def publish(self, writer: Callable[[str], None], step: int,
                extra: Optional[dict] = None) -> Generation:
        """Publish one generation. ``writer(staging_dir)`` populates the
        directory; everything it wrote is digested into the manifest and
        becomes immutable once the atomic rename lands."""
        number = self.next_number()
        t_publish = time.perf_counter()
        staging = os.path.join(
            self.root, f".stage-{gen_dirname(number)}-{os.getpid()}"
        )
        os.makedirs(staging)
        try:
            if self.faults is not None:
                self.faults.on_checkpoint_write(step)
            writer(staging)
            files: Dict[str, dict] = {}
            for name in sorted(os.listdir(staging)):
                # one streamed pass per file: digest AND fsync on the same
                # descriptor — constant memory however large the checkpoint
                digest, size = _hash_file(os.path.join(staging, name),
                                          fsync=True)
                files[name] = {"digest": digest, "bytes": size}
            if not files:
                raise ValueError("publish writer produced no files — an "
                                 "empty generation can never be restored")
            manifest = {
                "format_version": FORMAT_VERSION,
                "generation": number,
                "step": int(step),
                "files": files,
                **(extra or {}),
            }
            # the manifest itself is fsynced inside _atomic_write_json
            _atomic_write_json(os.path.join(staging, MANIFEST_NAME), manifest)
            _fsync_dir(staging)
            final = os.path.join(self.generations_dir, gen_dirname(number))
            os.replace(staging, final)  # THE publication point
            _fsync_dir(self.generations_dir)
        except BaseException:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        # measure to the publication point: ledger bookkeeping and
        # retention GC below are not publish cost, and folding them in
        # would inflate exactly the checkpoint-overhead number the drill
        # reports (the metric's help text pins write+digest+fsync+rename)
        t_published = time.perf_counter()
        self._h_publish.observe(t_published - t_publish)
        TRACER.complete("resilience.publish", t_publish, t_published,
                        {"gen": number, "step": int(step),
                         "kind": (extra or {}).get("kind", "training")})
        self.note_published(number, step)
        return Generation(number=number, path=final, manifest=manifest)

    def note_published(self, number: int, step: int) -> None:
        """Post-rename bookkeeping for a generation published by an
        EXTERNAL committer (the mesh coordinator's two-phase publish lands
        its own atomic rename): publish counter + gauge, the ledger entry,
        and retention GC — one definition with :meth:`publish`'s own
        epilogue so single-writer and mesh generations age identically."""
        self._c_publishes.inc()
        self._g_generation.set(number)
        self._update_ledger(number, status="published", step=int(step),
                            published_at=time.time())
        self.gc()

    # -- read side ------------------------------------------------------
    def _retried_read(self, fn: Callable[[], "object"]):
        """Run a read, retrying transient ``OSError`` with capped
        exponential backoff before giving up. Shared-filesystem multi-host
        runs (NFS-style mounts under the mesh plane) see sporadic EIO /
        ESTALE on perfectly good bytes — without the retry, one flaky read
        inside :meth:`verify` condemns a good generation to quarantine.
        ``read_retries=0`` restores fail-fast. The final error propagates
        to the caller, which still judges it exactly as before."""
        attempt = 0
        while True:
            try:
                return fn()
            except OSError:
                attempt += 1
                if attempt > self.read_retries:
                    raise
                self._c_read_retries.inc()
                self._sleep(min(1.0, self.read_retry_backoff_s
                                * 2 ** (attempt - 1)))

    def _read_manifest(self, path: str) -> dict:
        def read():
            with open(os.path.join(path, MANIFEST_NAME)) as fh:
                return json.load(fh)
        return self._retried_read(read)

    def verify(self, number: int) -> Optional[str]:
        """None when generation ``number`` is intact; otherwise the reason
        it is not (unparseable/missing manifest, missing member, size or
        digest mismatch). Transient ``OSError`` reads are retried
        (``read_retries`` with capped backoff) before a generation is
        condemned — corruption verdicts stay immediate (a digest mismatch
        is deterministic; re-reading cannot fix it)."""
        path = os.path.join(self.generations_dir, gen_dirname(number))
        try:
            manifest = self._read_manifest(path)
        except (OSError, json.JSONDecodeError) as exc:
            return f"manifest unreadable: {exc}"
        if manifest.get("format_version", 0) > FORMAT_VERSION:
            return (f"manifest format {manifest['format_version']} is newer "
                    f"than supported {FORMAT_VERSION}")
        for name, meta in manifest.get("files", {}).items():
            try:
                digest, size = self._retried_read(
                    lambda name=name: _hash_file(os.path.join(path, name)))
            except OSError as exc:
                return f"member {name!r} unreadable: {exc}"
            if size != meta["bytes"]:
                return (f"member {name!r} truncated: {size} bytes, "
                        f"manifest says {meta['bytes']}")
            if digest != meta["digest"]:
                return f"member {name!r} fails digest verification"
        return None

    def load(self, number: int) -> Generation:
        """Verified read of one specific generation (raises on corruption —
        callers wanting fallback use :meth:`latest_valid`)."""
        reason = self.verify(number)
        if reason is not None:
            raise ValueError(
                f"generation {number} fails verification: {reason}")
        path = os.path.join(self.generations_dir, gen_dirname(number))
        manifest = self._read_manifest(path)
        return Generation(number=number, path=path, manifest=manifest)

    def latest_valid(self) -> Optional[Generation]:
        """The newest generation that passes digest verification. Anything
        newer that fails is quarantined (moved aside + ledger-flagged) so
        it can never be selected again; None when no valid generation
        exists."""
        for number in reversed(self.published()):
            reason = self.verify(number)
            if reason is None:
                return self.load(number)
            self.quarantine(number, reason)
        return None

    def quarantine(self, number: int, reason: str) -> None:
        """Move a corrupt generation out of the selectable set, keeping its
        bytes for forensics, and record why in the ledger."""
        src = os.path.join(self.generations_dir, gen_dirname(number))
        dst = os.path.join(self.quarantine_dir, gen_dirname(number))
        if os.path.isdir(src):
            if os.path.isdir(dst):  # name collision from a prior half-move
                shutil.rmtree(dst, ignore_errors=True)
            os.replace(src, dst)
        self._update_ledger(number, status="quarantined", reason=reason,
                            quarantined_at=time.time())
        self._c_quarantines.inc()
        TRACER.instant("resilience.quarantine",
                       {"gen": number, "reason": reason})

    # -- retention ------------------------------------------------------
    def retained(self, numbers: List[int]) -> set:
        keep = set(numbers[-self.keep_last:])
        if self.keep_every:
            keep.update(n for n in numbers if n % self.keep_every == 0)
        return keep

    def gc(self) -> List[int]:
        """Apply retention: delete published generations outside
        keep-last-K / keep-every-N. The ledger entry flips to ``gc``
        BEFORE the directory is removed — a crash mid-delete leaves a
        directory the next ``latest_valid`` can still verify (it only
        shrinks the retained set, never corrupts it)."""
        numbers = self.published()
        keep = self.retained(numbers)
        removed = []
        for number in numbers:
            if number in keep:
                continue
            self._update_ledger(number, status="gc", gc_at=time.time())
            shutil.rmtree(
                os.path.join(self.generations_dir, gen_dirname(number)),
                ignore_errors=True,
            )
            removed.append(number)
        return removed
