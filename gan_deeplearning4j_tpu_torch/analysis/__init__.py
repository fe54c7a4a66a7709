"""torchlint — in-tree static analysis for the port's CUDA hazards.

The port of the JAX package's analyzer (``gan_deeplearning4j_tpu/analysis``,
"jaxlint"). The port was hurt, on the card, by bugs a syntax tree shows: a
graph destroyed by the cyclic collector mid-capture, a pinned allocation or
a synchronize inside a capture, a Python hyperparameter that jnp rounds to
bf16 and torch does not, a profiler session started off the main thread.
This package turns those lessons into rules, and keeps the JAX analyzer's
rules that are not tied to JAX.

A TWO-PHASE analyzer, as jaxlint is. Phase 1 (:mod:`.project`) builds a
project index — module/import graph, top-level symbol table, per-function
summaries (generator parameters, calls made inside a capture region, the
names a capture binds, direct host reads and device launches) and their
transitive closures (what runs inside a capture, what reads on the host or
launches device work through its callees) — and phase 2 runs the rules
with that index on every module. The concurrency (:mod:`.concurrency`) and
lifecycle (:mod:`.lifecycle`) indexes are jaxlint's, unchanged.

The rules carry the JAX analyzer's codes: its 14 rules that are not tied to
JAX, copied, and torch counterparts of ten JAX-idiom rules under the codes
they stand in for (``analysis/CATALOGUE.md`` says what each code means in
each package, and lists the codes still to come).

Deliberately torch-free and stdlib-only, like jaxlint: the linter must run
where no accelerator stack loads, and it imports nothing of the JAX package.

Public surface:

- :func:`analyze_paths` / :func:`analyze_source` / :func:`analyze_sources`
  — run all rules, return :class:`Report` (findings partitioned into
  active / suppressed / baselined; ``analyze_sources`` analyzes several
  in-memory modules under ONE project index);
- :class:`Finding` — one diagnostic, with a content-based fingerprint that
  is stable across line-number drift, so baselines survive unrelated edits;
- :data:`RULES` — the rule registry;
- CLI: ``python -m gan_deeplearning4j_tpu_torch.analysis <paths>`` — exit 0
  iff the tree is clean modulo the checked-in baseline
  (``analysis/_baseline.json``); ``--format json|sarif``, ``--changed-only``
  (the fast shape ``analysis/lint_gate.sh`` wraps), ``--fix``/
  ``--fix-suppress``, ``--prune-baseline``. A tier-1 test
  (``tests/test_torch_analysis.py::TestTreeIsClean``) holds the port and
  ``chip_smoke.py`` clean, and the analyzer's own package.

Suppression: a trailing ``# torchlint: disable=JG005`` (comma-separated
codes, or ``all``) on any line of the offending statement suppresses the
finding; suppressions are counted and reported, never silent, and a
suppression naming a code this registry lacks is a reported warning.
"""

from gan_deeplearning4j_tpu_torch.analysis.engine import (
    DEFAULT_BASELINE_PATH,
    Finding,
    Report,
    analyze_paths,
    analyze_source,
    analyze_sources,
    changed_files,
    load_baseline,
    prune_baseline,
)
from gan_deeplearning4j_tpu_torch.analysis.rules import RULES

__all__ = [
    "DEFAULT_BASELINE_PATH",
    "Finding",
    "Report",
    "RULES",
    "analyze_paths",
    "analyze_source",
    "analyze_sources",
    "changed_files",
    "load_baseline",
    "prune_baseline",
]
