"""The simulation Runtime: owns RNG + executor + time + simulators.

TPU-native analog of reference madsim/src/sim/runtime/mod.rs:33-416.
`Runtime(seed, config)` builds one deterministic simulation lane; `Handle`
is the supervisor API (create_node / kill / restart / pause / resume /
send_ctrl_c / metrics); `NodeBuilder` configures nodes (name, cores, init fn
for restart, restart_on_panic).

`check_determinism` (reference runtime/mod.rs:167-191) runs the same seed
twice, the first run recording an RNG trace annotated with virtual-time
hashes, the second replaying against it and raising at the first divergence.

The batched entry point `run_batch(seeds)` lives in
`madsim_tpu_torch.tpu.batch` and fans whole seed ranges onto the card's
lanes; this module is the single-lane host semantics those lanes must
match. The port's copy of `madsim_tpu/core/runtime.py`.
"""

from __future__ import annotations

from typing import Any, Callable, Coroutine, Dict, List, Optional, Type

from . import context
from .config import Config
from .metrics import RuntimeMetrics
from .plugin import Simulator
from .rng import GlobalRng
from .task import (
    Executor,
    JoinHandle,
    NodeHandle,
    NodeId,
    Spawner,
    ToNodeId,
)
from .vtime import TimeHandle, to_nanos


class Handle:
    """Supervisor handle to a running simulation (runtime/mod.rs:201-290)."""

    def __init__(self, rng: GlobalRng, time: TimeHandle, executor: Executor, config: Config) -> None:
        self.rng = rng
        self.time = time
        self.executor = executor
        self.config = config
        self.simulators: Dict[Type[Simulator], Simulator] = {}
        # set by nemesis.NemesisDriver; read by RuntimeMetrics.chaos_fires
        self.nemesis = None

    @staticmethod
    def current() -> "Handle":
        return context.current_handle()

    @property
    def seed(self) -> int:
        return self.rng.seed

    def metrics(self) -> RuntimeMetrics:
        return RuntimeMetrics(self.executor, handle=self)

    # -- node supervision --

    def create_node(self) -> "NodeBuilder":
        return NodeBuilder(self)

    def get_node(self, id: ToNodeId) -> Optional[NodeHandle]:
        try:
            nid = self.executor.resolve_node_id(id)
        except KeyError:
            return None
        return NodeHandle(self.executor, nid)

    def kill(self, id: ToNodeId) -> None:
        self.executor.kill(id)

    def restart(self, id: ToNodeId) -> None:
        self.executor.restart(id)

    def pause(self, id: ToNodeId) -> None:
        self.executor.pause(id)

    def resume(self, id: ToNodeId) -> None:
        self.executor.resume(id)

    def send_ctrl_c(self, id: ToNodeId) -> None:
        self.executor.send_ctrl_c(id)

    def is_exit(self, id: ToNodeId) -> bool:
        return self.executor.is_exit(id)

    # -- simulator registry (plugin.rs) --

    def add_simulator(self, cls: Type[Simulator]) -> None:
        if cls in self.simulators:
            return
        sim = cls(self.rng, self.time, self.config)
        self.simulators[cls] = sim
        # fan out lifecycle events (runtime/mod.rs:70-81, task/mod.rs:352-355)
        self.executor.on_node_created.append(sim.create_node)
        self.executor.on_node_reset.append(sim.reset_node)
        for nid in self.executor.nodes:
            sim.create_node(nid)


class NodeBuilder:
    """Builds a simulated node (reference runtime/mod.rs:293-386)."""

    def __init__(self, handle: Handle) -> None:
        self._handle = handle
        self._name: Optional[str] = None
        self._cores: int = 1
        self._ip: Optional[str] = None
        self._init: Optional[Callable[[], Coroutine[Any, Any, Any]]] = None
        self._restart_on_panic = False
        self._restart_on_panic_matching: List[str] = []

    def name(self, name: str) -> "NodeBuilder":
        self._name = name
        return self

    def cores(self, cores: int) -> "NodeBuilder":
        if cores < 1:
            raise ValueError("cores must be >= 1")
        self._cores = cores
        return self

    def ip(self, ip: str) -> "NodeBuilder":
        """Assign an IP on the simulated network (used by NetSim)."""
        self._ip = ip
        return self

    def init(self, make_coro: Callable[[], Coroutine[Any, Any, Any]]) -> "NodeBuilder":
        """Set the initial task factory, re-invoked on every (re)start."""
        self._init = make_coro
        return self

    def restart_on_panic(self) -> "NodeBuilder":
        self._restart_on_panic = True
        return self

    def restart_on_panic_matching(self, substring: str) -> "NodeBuilder":
        self._restart_on_panic_matching.append(substring)
        return self

    def build(self) -> NodeHandle:
        make_coro = self._init
        init_fn = None
        if make_coro is not None:
            def init_fn(spawner: Spawner) -> None:
                spawner.spawn(make_coro(), name="init")

        info = self.executor.create_node(
            self._name,
            self._cores,
            init_fn,
            self._restart_on_panic,
            self._restart_on_panic_matching,
        )
        if self._ip is not None:
            try:
                from ..net.netsim import NetSim
            except ImportError:
                pass
            else:
                sim = self._handle.simulators.get(NetSim)
                if sim is not None:
                    sim.set_ip(info.id, self._ip)  # type: ignore[attr-defined]
        return NodeHandle(self.executor, info.id)

    @property
    def executor(self) -> Executor:
        return self._handle.executor


_warned_hash_randomization = False


def _check_hash_randomization() -> None:
    """Warn (once) when str-hash randomization is live.

    The reference seeds std's RandomState from the sim RNG so HashMap
    iteration order is part of the deterministic trajectory (rand.rs:176-244).
    CPython's str/bytes hash seed is fixed at interpreter start and CANNOT be
    re-seeded at runtime, so the only way to make str-keyed set/dict
    iteration reproducible ACROSS PROCESSES is launching with PYTHONHASHSEED
    pinned. Within one process determinism is unaffected (the hash seed is
    constant), but a repro seed handed to a colleague — or a determinism
    check that compares against a previous process's trace — silently
    diverges if user code iterates a str-keyed set. Detect and say so loudly
    instead of letting `check_determinism` chase ghosts.
    """
    global _warned_hash_randomization
    if _warned_hash_randomization:
        return
    import os

    # NB: sys.flags.hash_randomization is 1 for ANY env value except "0" —
    # including pinned nonzero seeds like PYTHONHASHSEED=12345, which ARE
    # cross-process reproducible. The env var is the ground truth.
    seed = os.environ.get("PYTHONHASHSEED", "")
    pinned = seed.isdigit()  # any fixed integer pins the hash seed
    if not pinned:
        import warnings

        _warned_hash_randomization = True
        warnings.warn(
            "madsim_tpu_torch: PYTHONHASHSEED is not pinned — str-keyed dict/set "
            "iteration order will differ across processes, so simulations "
            "whose user code iterates str-keyed collections are NOT "
            "reproducible across processes (within this process they are). "
            "Launch with PYTHONHASHSEED=0 for cross-process repro "
            "(reference madsim seeds HashMap's RandomState for the same "
            "reason, rand.rs:176-244).",
            stacklevel=3,
        )


class Runtime:
    """One deterministic simulation lane (runtime/mod.rs:33-192)."""

    def __init__(self, seed: int = 0, config: Optional[Config] = None) -> None:
        # make stdlib time/random/urandom deterministic inside sims (the
        # libc-interposition analog; patches dispatch on TLS context, so
        # code outside a sim is untouched)
        from . import interpose

        interpose.install()
        _check_hash_randomization()
        self.config = config or Config()
        self.rng = GlobalRng(seed)
        self.time = TimeHandle(self.rng)
        self.rng.time_hash_fn = self.time.now_ns
        self.executor = Executor(self.rng, self.time)
        self.handle = Handle(self.rng, self.time, self.executor, self.config)
        self._register_builtin_simulators()

    @staticmethod
    def with_seed_and_config(seed: int, config: Config) -> "Runtime":
        return Runtime(seed, config)

    def _register_builtin_simulators(self) -> None:
        # registered at construction like the reference (runtime/mod.rs:64-65)
        guard = context.enter(self.handle)
        try:
            from ..fs import FsSim

            self.handle.add_simulator(FsSim)
            try:
                from ..net.netsim import NetSim
            except ImportError:
                pass
            else:
                self.handle.add_simulator(NetSim)
        finally:
            guard.exit()

    def set_time_limit(self, seconds: float) -> None:
        self.executor.time_limit_ns = to_nanos(seconds)

    def enable_determinism_check(self, log: Optional[List[tuple[int, int]]] = None) -> None:
        if log is None:
            self.rng.enable_recording()
        else:
            self.rng.enable_check(log)

    def take_rand_log(self) -> List[tuple[int, int]]:
        return self.rng.take_log()

    def create_node(self) -> NodeBuilder:
        return self.handle.create_node()

    def block_on(self, coro: Coroutine[Any, Any, Any]) -> Any:
        guard = context.enter(self.handle)
        try:
            return self.executor.block_on(coro)
        finally:
            guard.exit()

    @staticmethod
    def run_batch(seeds, workload, **kwargs):
        """Fuzz a whole seed range as one batch on the card (the
        builder.rs:118-136 thread-per-seed fan-out replaced by device
        lanes); violating seeds re-run on this host runtime. See
        `madsim_tpu_torch.tpu.batch.run_batch` (`device="cuda"` unless the
        caller passes another).
        """
        from ..tpu.batch import run_batch as _run_batch

        return _run_batch(seeds, workload, **kwargs)


def check_determinism(
    seed: int,
    make_coro: Callable[[], Coroutine[Any, Any, Any]],
    config: Optional[Config] = None,
    time_limit: Optional[float] = None,
) -> Any:
    """Run `seed` twice; raise DeterminismError at the first RNG divergence.

    Mirrors reference runtime/mod.rs:167-191 (two runs, RNG-trace compare).
    """
    rt1 = Runtime(seed, config)
    if time_limit is not None:
        rt1.set_time_limit(time_limit)
    rt1.enable_determinism_check()
    result = rt1.block_on(make_coro())
    log = rt1.take_rand_log()

    rt2 = Runtime(seed, config)
    if time_limit is not None:
        rt2.set_time_limit(time_limit)
    rt2.enable_determinism_check(log)
    rt2.block_on(make_coro())
    consumed = rt2.rng._check_pos
    if consumed != len(log):
        from .rng import DeterminismError

        raise DeterminismError(
            f"non-determinism detected: second run made {consumed} RNG draws, "
            f"first run made {len(log)}"
        )
    return result
