from . import buggify, config, context, futures, plugin, rng, task, vtime  # noqa: F401
from .config import Config, NetConfig  # noqa: F401
from .futures import Future  # noqa: F401
from .rng import DeterminismError, GlobalRng  # noqa: F401
from .runtime import Handle, NodeBuilder, Runtime, check_determinism  # noqa: F401
from .task import (  # noqa: F401
    AbortHandle,
    DeadlockError,
    JoinError,
    JoinHandle,
    NodeHandle,
    NodeId,
    TimeLimitError,
)
