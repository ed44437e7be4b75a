"""The batched simulation engine on PyTorch (main-path slice)."""

from .batch import (  # noqa: F401
    BatchDeterminismError,
    BatchResult,
    BatchWorkload,
    run_batch,
)
from .engine import (  # noqa: F401
    BatchedSim,
    MsgPool,
    SimState,
    abs_time_us,
    summarize,
)
from .raft import (  # noqa: F401
    RaftState,
    make_raft_spec,
    raft_bench_config,
    raft_workload,
)
from .spec import (  # noqa: F401
    INF_GUARD,
    INF_US,
    Outbox,
    ProtocolSpec,
    REBASE_US,
    SimConfig,
    empty_outbox,
    replace_handlers,
    wraps_event,
)
