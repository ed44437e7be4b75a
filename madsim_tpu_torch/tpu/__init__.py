"""The batched simulation engine on PyTorch."""

from .batch import (  # noqa: F401
    BatchDeterminismError,
    BatchResult,
    BatchViolation,
    BatchWorkload,
    run_batch,
)
from .chain import ChainState, chain_workload, make_chain_spec  # noqa: F401
from .engine import (  # noqa: F401
    BatchedSim,
    MsgPool,
    NemesisState,
    SimState,
    StragPool,
    TraceRecord,
    TriageCtl,
    abs_time_us,
    default_ctl,
    scale_delay_ppm,
    summarize,
)
from .isr import IsrState, isr_workload, make_isr_spec  # noqa: F401
from .kv import (  # noqa: F401
    KvState,
    buggy_local_read_spec,
    kv_workload,
    make_kv_spec,
)
from .lease import LeaseState, lease_workload, make_lease_spec  # noqa: F401
from .nemesis import compile_plan, coverage_report, enabled_fire_kinds  # noqa: F401
from .paxos import PaxosState, make_paxos_spec, paxos_workload  # noqa: F401
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
    fuse_two_handlers,
    pool_kw_for,
    replace_handlers,
    simconfig_from_toml,
    wraps_event,
)
from .trace import TraceEvent, extract_trace, format_trace, trace_seed  # noqa: F401
from .twopc import (  # noqa: F401
    TpcState,
    make_twopc_spec,
    twopc_workload,
    unilateral_abort_spec,
)
from .wal import (  # noqa: F401
    WalState,
    buggy_ack_before_fsync_spec,
    make_wal_spec,
    wal_workload,
)
