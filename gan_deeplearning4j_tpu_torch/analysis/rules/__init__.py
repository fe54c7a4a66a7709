"""torchlint rule registry.

Each rule is a small object with ``code``, ``name``, ``summary`` and a
``check(mod) -> iterable`` yielding :class:`~..engine.Finding` (or
``(finding, node)`` tuples when multi-line suppression spans matter).
``skip_tests = True`` exempts test modules (tests legitimately assert).

Two kinds of rule live here, under the JAX analyzer's codes (the catalogue,
``analysis/CATALOGUE.md``, says what each code means in each package):

- the 14 rules that are not tied to JAX, copied with their codes and
  messages (JG003, JG016, JG017, JG021-JG029, JG031, JG032);
- the torch counterparts of the 18 JAX-idiom rules, each under the code
  of the JAX rule it stands in for (JG001, JG002, JG004-JG015, JG018-JG020,
  JG030).

So the registry holds the JAX registry's 32 codes.

New rules: add a module here, register the instance in RULES, and give it
true-positive/true-negative fixtures in ``tests/test_torch_analysis.py`` or
``tests/test_torch_analysis_flow.py`` —
a rule without a fixture proving it fires on the bug it was derived from
is not a rule, it is a hope.
"""

from gan_deeplearning4j_tpu_torch.analysis.rules.generator import GeneratorReuse
from gan_deeplearning4j_tpu_torch.analysis.rules.timing import StaleOrMissingFence
from gan_deeplearning4j_tpu_torch.analysis.rules.asserts import BareAssert
from gan_deeplearning4j_tpu_torch.analysis.rules.recapture import RecaptureHazard
from gan_deeplearning4j_tpu_torch.analysis.rules.capture_sync import HostSyncInCapture
from gan_deeplearning4j_tpu_torch.analysis.rules.replay_read import StaticBufferReadAfterReplay
from gan_deeplearning4j_tpu_torch.analysis.rules.out_of_place import DiscardedOutOfPlace
from gan_deeplearning4j_tpu_torch.analysis.rules.weak_scalar import WeakScalarDrift
from gan_deeplearning4j_tpu_torch.analysis.rules.host_read import HostReadInTimedRegion
from gan_deeplearning4j_tpu_torch.analysis.rules.telemetry_fence import (
    TelemetryUnfencedTiming,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.engine_swap import (
    SwapSeamUnguardedAccess,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.net_timeout import (
    UnboundedNetworkCall,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.respawn import (
    UnboundedRespawnLoop,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.mux_sharing import (
    CrossGenerationEngineSharing,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.alert_metrics import (
    UnknownMetricInAlertRule,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.shared_state import (
    UnguardedSharedMutableState,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.quant_dtype import (
    QuantPrecisionCastMismatch,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.lock_order import (
    LockOrderInversion,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.lock_blocking import (
    BlockingCallUnderLock,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.resource_leak import (
    LeakedPairedResource,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.release_balance import (
    UnbalancedRelease,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.handoff import (
    HandoffWithoutTransfer,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.ladder_literal import (
    HardcodedLadderLiteral,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.double_buffer import (
    DoubleBufferMisuse,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.replay_flow import StaticOutputAcrossCalls
from gan_deeplearning4j_tpu_torch.analysis.rules.seed_flow import SeedHandedToTwoHelpers
from gan_deeplearning4j_tpu_torch.analysis.rules.prefetch_transform import (
    HostSyncInPrefetchTransform,
)
from gan_deeplearning4j_tpu_torch.analysis.rules.replay_io import SyncIoOnTimedReplayPath
from gan_deeplearning4j_tpu_torch.analysis.rules.collective_group import CollectiveOffTheMesh
from gan_deeplearning4j_tpu_torch.analysis.rules.placement import StatePlacementMismatch
from gan_deeplearning4j_tpu_torch.analysis.rules.vmap_dims import VmapInDimsMismatch
from gan_deeplearning4j_tpu_torch.analysis.rules.inplace_collective import (
    InPlaceCollectiveReadAsLocal,
)

RULES = [
    GeneratorReuse(),
    StaleOrMissingFence(),
    BareAssert(),
    RecaptureHazard(),
    HostSyncInCapture(),
    StaticBufferReadAfterReplay(),
    DiscardedOutOfPlace(),
    WeakScalarDrift(),
    HostReadInTimedRegion(),
    TelemetryUnfencedTiming(),
    SwapSeamUnguardedAccess(),
    UnboundedNetworkCall(),
    UnboundedRespawnLoop(),
    CrossGenerationEngineSharing(),
    UnknownMetricInAlertRule(),
    UnguardedSharedMutableState(),
    LockOrderInversion(),
    BlockingCallUnderLock(),
    LeakedPairedResource(),
    UnbalancedRelease(),
    HandoffWithoutTransfer(),
    QuantPrecisionCastMismatch(),
    HardcodedLadderLiteral(),
    DoubleBufferMisuse(),
    StaticOutputAcrossCalls(),
    SeedHandedToTwoHelpers(),
    HostSyncInPrefetchTransform(),
    SyncIoOnTimedReplayPath(),
    CollectiveOffTheMesh(),
    StatePlacementMismatch(),
    VmapInDimsMismatch(),
    InPlaceCollectiveReadAsLocal(),
]

RULES_BY_CODE = {r.code: r for r in RULES}

#: the codes copied from the JAX analyzer unchanged
SHARED_CODES = ("JG003", "JG016", "JG017", "JG021", "JG022", "JG023",
                "JG024", "JG025", "JG026", "JG027", "JG028", "JG029",
                "JG031", "JG032")

__all__ = ["RULES", "RULES_BY_CODE", "SHARED_CODES"]
