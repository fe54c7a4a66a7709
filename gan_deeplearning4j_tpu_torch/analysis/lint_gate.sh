#!/bin/bash
# torchlint gate wrapper — the port's counterpart of the JAX package's
# scripts/lint_gate.sh, with the same two shapes:
#
#   gan_deeplearning4j_tpu_torch/analysis/lint_gate.sh
#                                        # FAST: only .py files changed vs
#                                        #   the merge base with ${LINT_BASE:-HEAD}
#                                        #   (HEAD = uncommitted work only) —
#                                        #   the pre-commit shape
#   gan_deeplearning4j_tpu_torch/analysis/lint_gate.sh --full
#                                        # the whole target set (the port and
#                                        #   chip_smoke.py) — what
#                                        #   tests/test_torch_analysis.py's
#                                        #   TestTreeIsClean enforces; also
#                                        #   FAILS (exit 1) on stale baseline
#                                        #   entries (--prune-baseline)
#   LINT_BASE=main .../lint_gate.sh      # changed vs merge-base with main
#   LINT_FORMAT=sarif .../lint_gate.sh --full > lint.sarif  # CI annotators
#   LINT_PROFILE=1 .../lint_gate.sh --full  # per-phase/per-rule wall-time
#                                        #   table on stderr (report unchanged)
#
# Extra arguments pass through to the analyzer (--rules JG00x, --fix, ...).
# Exit codes are the analyzer's: 0 clean (modulo baseline + suppressions),
# 1 active findings or stale baseline entries, 2 usage/environment error.
cd "$(dirname "$0")/../.." || exit 2
TARGETS=(gan_deeplearning4j_tpu_torch chip_smoke.py)
FORMAT="${LINT_FORMAT:-text}"
# Incremental parse cache shared by every shape; TORCHLINT_CACHE_DIR
# overrides the location, LINT_CACHE=off bypasses it (the analyzer honors
# it even when the dir is exported).
export TORCHLINT_CACHE_DIR="${TORCHLINT_CACHE_DIR:-${TMPDIR:-/tmp}/torchlint_cache}"
EXTRA=()
[ -n "${LINT_PROFILE:-}" ] && EXTRA+=(--profile)
if [ "$1" = "--full" ]; then
  shift
  exec python -m gan_deeplearning4j_tpu_torch.analysis "${TARGETS[@]}" \
    --format "$FORMAT" "${EXTRA[@]}" "$@"
fi
exec python -m gan_deeplearning4j_tpu_torch.analysis "${TARGETS[@]}" \
  --changed-only --diff-base "${LINT_BASE:-HEAD}" --format "$FORMAT" \
  "${EXTRA[@]}" "$@"
