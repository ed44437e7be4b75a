"""PyTorch/CUDA port of madsim_tpu: the batched engine and the host runtime.

`madsim_tpu_torch.tpu` mirrors `madsim_tpu.tpu` module for module, and
`nemesis`, `triage`, `repro`, `oracle` and the rest mirror their JAX-package
namesakes; the JAX package stays the reference each part is held against.

The host runtime (`core/`, `net/`, `fs`) is the single-lane deterministic
simulator the host twins (`workloads/<x>_host.py` and speclang's generated
`<x>_host.py`) run on, exported here as the JAX package exports it:

    import madsim_tpu_torch as ms

    rt = ms.Runtime(seed=7)
    rt.block_on(main())      # ms.spawn, ms.time.sleep, ms.rand inside

This package imports torch and numpy only, and `import madsim_tpu_torch`
imports neither of them.
"""

from .core import (  # noqa: F401
    Config,
    DeadlockError,
    DeterminismError,
    Future,
    GlobalRng,
    Handle,
    JoinError,
    JoinHandle,
    NetConfig,
    NodeBuilder,
    NodeHandle,
    Runtime,
    TimeLimitError,
    buggify,
    check_determinism,
    plugin,
)
from .core import task  # noqa: F401
from .core import vtime as time  # noqa: F401
from .core.buggify import buggify_with_prob  # noqa: F401
from .core.task import spawn, yield_now  # noqa: F401
from . import fs, nemesis, net  # noqa: F401
from .nemesis import FaultPlan, NemesisDriver  # noqa: F401
from .core import sync  # noqa: F401


def rand() -> float:
    """Deterministic uniform [0,1) from the current simulation's RNG."""
    from .core import context

    return context.current_handle().rng.random()


def randrange(start: int, stop=None) -> int:
    from .core import context

    return context.current_handle().rng.randrange(start, stop)
