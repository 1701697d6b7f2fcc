"""Device kernels and the host<->device placement engine (reference:
nomad_tpu/ops).  Kernels are hand-written CUDA (`csrc/`), each wrapped
beside its plain PyTorch version; see `kernels.KERNELS`."""

from .engine import (  # noqa: F401
    BatchItem,
    BulkDecisions,
    PlacementDecision,
    PlacementEngine,
    PlacementRequest,
)
from .executor import (  # noqa: F401
    BridgeExecutor,
    DeviceExecutor,
    ExecutorUnavailable,
    TorchExecutor,
    make_executor,
)
from .feasibility import constraint_mask, feasible_mask  # noqa: F401
from .scoring import (  # noqa: F401
    affinity_score,
    binpack_score,
    capacity_fit,
    job_anti_affinity,
    normalize_scores,
    spread_boost,
)
from .select import (  # noqa: F401
    BulkInputs,
    MultiEvalInputs,
    PlacementInputs,
    PlacementOutputs,
    place,
    place_packed,
)
