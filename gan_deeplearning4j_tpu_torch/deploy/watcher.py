"""StoreWatcher — discovers newer digest-valid serving bundles to reload.

The PyTorch port's copy of ``gan_deeplearning4j_tpu/deploy/watcher.py`` (plain
Python, no JAX), kept inside the port so that it imports nothing of the
JAX package.

The reload plane's read side. Two sources, one contract:

- **store mode** — poll a ``resilience.CheckpointStore`` for published
  generations newer than the one currently served
  (``generations_newer_than``), newest first. A generation that fails
  digest verification is moved to quarantine through the store's existing
  machinery and the walk falls back — the *corrupt-generation skip*: a
  half-written or bit-flipped bundle is never offered to the reloader.
  Generations without a ``serving.json`` (training checkpoints sharing a
  store) are remembered and skipped silently.
- **directory mode** — poll a bare ``serving.json`` bundle directory (the
  unversioned ``publish_for_serving(directory=)`` flow). Bundles there
  carry no generation number, so "newer" is "the manifest bytes changed":
  the candidate token is a content hash of ``serving.json`` (which the
  publisher lands atomically, so a torn read is impossible).

The watcher also owns the *skip memory*: a candidate the reloader rejected
(canary failure, construction failure, kind mismatch) is recorded via
:meth:`discard` and never offered again — in store mode optionally through
the store's quarantine, which is what keeps a canary-failed generation out
of every FUTURE server's view too, not just this process's.

Polling cadence and backoff live in the :class:`~.reloader.ReloadController`
loop; this class is one synchronous, side-effect-bounded ``poll_once``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Optional, Set

from gan_deeplearning4j_tpu_torch.resilience.store import (
    MANIFEST_NAME,
    gen_dirname,
)

#: the bundle manifest every servable candidate must contain
SERVING_MANIFEST = "serving.json"


@dataclasses.dataclass(frozen=True)
class BundleCandidate:
    """One reloadable bundle the watcher found. ``generation`` is the
    store generation number (None in directory mode); ``token`` uniquely
    identifies the candidate across polls (the skip-memory key)."""

    path: str
    generation: Optional[int]
    token: str
    manifest: dict


class StoreWatcher:
    """``poll_once`` returns the newest candidate worth reloading, or
    None. Construct with exactly one of ``store`` (a
    ``resilience.CheckpointStore``) or ``path`` (a bundle directory)."""

    def __init__(self, store=None, path: Optional[str] = None):
        if (store is None) == (path is None):
            raise ValueError("pass exactly one of store= or path=")
        self.store = store
        self.path = path
        self._rejected: Set[str] = set()
        self._not_serving: Set[int] = set()  # training generations, by number

    # -- discovery ------------------------------------------------------
    def poll_once(self, current_generation: Optional[int] = None,
                  current_token: Optional[str] = None
                  ) -> Optional[BundleCandidate]:
        """The newest digest-valid serving candidate newer than what is
        currently served (``current_generation`` in store mode,
        ``current_token`` in directory mode), skipping rejected and
        non-serving entries and quarantining corrupt ones."""
        if self.store is not None:
            return self._poll_store(current_generation)
        return self._poll_dir(current_token)

    def _poll_store(self, current: Optional[int]
                    ) -> Optional[BundleCandidate]:
        for number in reversed(self.store.generations_newer_than(current)):
            token = gen_dirname(number)
            if token in self._rejected or number in self._not_serving:
                continue
            path = os.path.join(self.store.generations_dir,
                                gen_dirname(number))
            # the cheap check FIRST: a training checkpoint sharing the
            # store (no serving.json) is skipped without hashing a single
            # byte — and is never the serving plane's to quarantine
            if not os.path.exists(os.path.join(path, SERVING_MANIFEST)):
                if os.path.isdir(path):
                    self._not_serving.add(number)
                # else: GC'd between the scan and here — just move on
                continue
            reason = self.store.verify(number)
            if reason is not None:
                # corrupt-generation skip: quarantine through the store's
                # machinery (dir moved aside + ledger-flagged) and fall
                # back to the next-newest candidate — unless the writer's
                # retention GC deleted it underneath this walk, which is
                # not corruption and must not leave a bogus ledger flag
                if number in self.store.published():
                    self.store.quarantine(number, reason)
                continue
            with open(os.path.join(path, MANIFEST_NAME)) as fh:
                manifest = json.load(fh)
            return BundleCandidate(path=path, generation=number,
                                   token=token, manifest=manifest)
        return None

    def _poll_dir(self, current_token: Optional[str]
                  ) -> Optional[BundleCandidate]:
        try:
            with open(os.path.join(self.path, SERVING_MANIFEST), "rb") as fh:
                raw = fh.read()
        except OSError:
            return None  # no bundle (yet) — not an error, just nothing new
        token = "sha256:" + hashlib.sha256(raw).hexdigest()
        if token == current_token or token in self._rejected:
            return None
        try:
            manifest = json.loads(raw)
        except json.JSONDecodeError:
            return None  # publisher lands serving.json atomically; a torn
            # manifest means something else wrote here — don't offer it
        return BundleCandidate(path=self.path,
                               generation=manifest.get("generation"),
                               token=token, manifest=manifest)

    @staticmethod
    def dir_token(path: str) -> Optional[str]:
        """Content token of a bundle directory's current ``serving.json``
        (None when absent) — primes directory-mode tracking so the bundle
        the server just loaded is not immediately 're-loaded'."""
        try:
            with open(os.path.join(path, SERVING_MANIFEST), "rb") as fh:
                return "sha256:" + hashlib.sha256(fh.read()).hexdigest()
        except OSError:
            return None

    # -- skip memory ----------------------------------------------------
    def discard(self, candidate: BundleCandidate, reason: str,
                quarantine: bool = False) -> None:
        """Never offer ``candidate`` again. ``quarantine=True`` (store
        mode) additionally moves the generation aside through the store's
        quarantine machinery — a canary-failed generation is then invisible
        to every future reader, not just this watcher."""
        self._rejected.add(candidate.token)
        if (quarantine and self.store is not None
                and candidate.generation is not None
                and candidate.generation in self.store.published()):
            self.store.quarantine(candidate.generation, reason)
