"""Tasks, nodes, and the deterministic discrete-event executor.

TPU-native analog of reference madsim/src/sim/task/mod.rs (1072 LoC) +
utils/mpsc.rs. The executor is THE event loop of a single simulation lane
(reference task/mod.rs:220-307):

    loop:
        run_all_ready()          # drain ready queue in *random* order
        if main task finished: return
        advance virtual time to the next timer event (deadlock panic if none)

Random-order draining (reference utils/mpsc.rs:71-84 `try_recv_random`) is the
scheduling-nondeterminism amplifier: different seeds explore different task
interleavings. Each poll charges 50-100 ns of virtual time
(task/mod.rs:303-305).

Nodes are simulated processes — pure bookkeeping on one thread. Kill drops all
the node's futures (coroutines are closed when next popped, mirroring the
drop-on-pop in task/mod.rs:260-262), restart re-runs the node's init function
on a fresh `NodeInfo`, pause parks popped tasks until resume
(task/mod.rs:386-409), and a panicking task on a `restart_on_panic` node
triggers kill + randomized 1-10 s delayed restart (task/mod.rs:282-298).

The port's copy of `madsim_tpu/core/task.py`, with the plain list as the
ready queue (the optional native queue is not ported) and no production mode:
`spawn` outside a simulation raises NotImplementedError (ROADMAP item 16b).
"""

from __future__ import annotations

import sys
import time as _time
from typing import Any, Callable, Coroutine, Dict, List, Optional, Union

from . import context
from .futures import Future
from .rng import GlobalRng
from .vtime import TimeHandle

NodeId = int
MAIN_NODE_ID: NodeId = 0

ToNodeId = Union[int, str, "NodeHandle"]


class DeadlockError(RuntimeError):
    """No runnable tasks and no timers: the simulation would block forever."""


class TimeLimitError(RuntimeError):
    """Virtual time exceeded the configured limit (reference task/mod.rs:244-249)."""


class JoinError(Exception):
    """Awaiting a JoinHandle of a task that was aborted/killed or panicked."""

    def __init__(self, message: str, *, cancelled: bool) -> None:
        super().__init__(message)
        self.cancelled = cancelled

    def is_cancelled(self) -> bool:
        return self.cancelled

    def is_panic(self) -> bool:
        return not self.cancelled


class NodeInfo:
    """Immutable identity + mutable liveness flags of one simulated process.

    A restart replaces the node's `NodeInfo` wholesale (old tasks still point
    at the dead info and get dropped), mirroring task/mod.rs:358-385.
    """

    def __init__(
        self,
        id: NodeId,
        name: Optional[str],
        cores: int,
        restart_on_panic: bool = False,
        restart_on_panic_matching: Optional[List[str]] = None,
    ) -> None:
        self.id = id
        self.name = name
        self.cores = cores
        self.restart_on_panic = restart_on_panic
        self.restart_on_panic_matching = restart_on_panic_matching or []
        self.killed = False
        self.paused = False
        self.tasks: List["Task"] = []  # live tasks (for metrics + kill-wake)
        self.ctrl_c: Optional[List[Future]] = None  # None = never listened
        self.spawn_counts: Dict[str, int] = {}  # per-spawn-site live-task counts

    def kill(self, executor: "Executor") -> None:
        self.killed = True
        self.paused = False
        # wake every task so the executor pops + drops it promptly
        for task in list(self.tasks):
            executor.schedule(task)


class Task:
    """A spawned coroutine bound to a node."""

    __slots__ = (
        "id",
        "coro",
        "node",
        "name",
        "location",
        "executor",
        "cancelled",
        "finished",
        "join_fut",
        "_in_queue",
        "_parked",
        "_awaiting",
        "task_locals",
    )

    def __init__(
        self,
        id: int,
        coro: Coroutine[Any, Any, Any],
        node: NodeInfo,
        executor: "Executor",
        name: Optional[str],
        location: str,
    ) -> None:
        self.id = id
        self.coro = coro
        self.node = node
        self.name = name
        self.location = location
        self.executor = executor
        self.cancelled = False
        self.finished = False
        self.join_fut: Future[Any] = Future()
        self._in_queue = False
        self._parked = False
        self._awaiting: Optional[Future] = None
        # request/task-scoped data (tokio task_local! analog); lazily created
        self.task_locals: Optional[dict] = None
        node.tasks.append(self)
        node.spawn_counts[location] = node.spawn_counts.get(location, 0) + 1

    # -- lifecycle --

    def step(self) -> None:
        """Poll the coroutine once. Raises on unhandled task exception."""
        self._awaiting = None
        try:
            yielded = self.coro.send(None)
        except StopIteration as stop:
            self._finish()
            self.join_fut.try_set_result(stop.value)
            return
        except BaseException as exc:
            self._finish()
            if not self.join_fut.done():
                self.join_fut.set_exception(
                    JoinError(f"task panicked: {exc!r}", cancelled=False)
                )
            raise
        if isinstance(yielded, Future):
            self._awaiting = yielded
            yielded.add_done_callback(self._wake)
        elif isinstance(yielded, _YieldNow):
            self.executor.schedule(self)
        else:
            self.drop()
            raise TypeError(
                f"task awaited a non-simulation awaitable ({yielded!r}); "
                "only madsim_tpu_torch primitives may be awaited inside a simulation"
            )

    def _wake(self, _fut: Future) -> None:
        if not self.finished:
            self.executor.schedule(self)

    def drop(self) -> None:
        """Free the coroutine without running it further (kill/abort path)."""
        if self.finished:
            return
        self._finish()
        # tell producers this consumer is gone (lost-wakeup prevention)
        if self._awaiting is not None and not self._awaiting.done():
            self._awaiting.abandon()
        try:
            self.coro.close()
        except BaseException:  # noqa: BLE001 - a misbehaving finally block must not kill the sim
            pass
        if not self.join_fut.done():
            self.join_fut.set_exception(JoinError("task was cancelled", cancelled=True))

    def _finish(self) -> None:
        self.finished = True
        node = self.node
        try:
            node.tasks.remove(self)
        except ValueError:
            pass
        n = node.spawn_counts.get(self.location, 0)
        if n <= 1:
            node.spawn_counts.pop(self.location, None)
        else:
            node.spawn_counts[self.location] = n - 1

    def abort(self) -> None:
        self.cancelled = True
        if not self.finished:
            self.executor.schedule(self)

    def is_finished(self) -> bool:
        return self.finished

    def node_spawner(self) -> "Spawner":
        return Spawner(self.executor, self.node)


class JoinHandle:
    """Awaitable handle to a spawned task (reference task/join.rs).

    Awaiting returns the task's result, or raises `JoinError` if the task was
    aborted or its node killed. Dropping the handle detaches (task keeps
    running).
    """

    __slots__ = ("_task",)

    def __init__(self, task: Task) -> None:
        self._task = task

    def abort(self) -> None:
        self._task.abort()

    def abort_handle(self) -> "AbortHandle":
        return AbortHandle(self._task)

    def is_finished(self) -> bool:
        return self._task.finished

    @property
    def task(self) -> Task:
        return self._task

    def __await__(self):
        return self._task.join_fut.__await__()


class AbortHandle:
    __slots__ = ("_task",)

    def __init__(self, task: Task) -> None:
        self._task = task

    def abort(self) -> None:
        self._task.abort()

    def is_finished(self) -> bool:
        return self._task.finished


class Spawner:
    """Spawns tasks onto a fixed node (reference task/mod.rs:564-646)."""

    __slots__ = ("executor", "info")

    def __init__(self, executor: "Executor", info: NodeInfo) -> None:
        self.executor = executor
        self.info = info

    def spawn(
        self, coro: Coroutine[Any, Any, Any], *, name: Optional[str] = None
    ) -> JoinHandle:
        location = _caller_location()
        task = self.executor.new_task(coro, self.info, name, location)
        self.executor.schedule(task)
        return JoinHandle(task)


def _caller_location() -> str:
    """file:line of the user frame that called spawn (for metrics/panics)."""
    frame = sys._getframe(1)
    depth = 0
    while frame is not None and depth < 8:
        filename = frame.f_code.co_filename
        if "/madsim_tpu_torch/" not in filename.replace("\\", "/"):
            return f"{filename}:{frame.f_lineno}"
        frame = frame.f_back
        depth += 1
    return "<unknown>"


class _Node:
    """Executor-side record for a node: current info + parked tasks + init."""

    __slots__ = ("info", "paused_tasks", "init")

    def __init__(self, info: NodeInfo, init: Optional[Callable[[Spawner], None]]) -> None:
        self.info = info
        self.paused_tasks: List[Task] = []
        self.init = init


class Executor:
    """Single-lane deterministic discrete-event executor."""

    def __init__(self, rng: GlobalRng, time: TimeHandle) -> None:
        self.rng = rng
        self.time = time
        self.ready: List[Task] = []
        self.nodes: Dict[NodeId, _Node] = {}
        self.next_node_id = 1
        self.next_task_id = 1
        self.time_limit_ns: Optional[int] = None
        self.main_info = NodeInfo(MAIN_NODE_ID, "main", cores=1)
        self.nodes[MAIN_NODE_ID] = _Node(self.main_info, None)
        # simulators to fan node lifecycle events out to (plugin registry
        # wires itself in via Runtime)
        self.on_node_created: List[Callable[[NodeId], None]] = []
        self.on_node_reset: List[Callable[[NodeId], None]] = []
        # sweep-overhead visibility (RuntimeMetrics.dispatches/device_ms,
        # the host half of BatchResult's r6 fields): scheduling rounds
        # drained and wall time spent draining them
        self.sched_rounds = 0
        self.loop_busy_s = 0.0
        # rounds that actually polled a task (ready queue non-empty at
        # drain): busy_rounds / sched_rounds is the host runtime's
        # occupancy counter — the single-lane mirror of the device
        # engine's busy-lane-steps / total-lane-steps (r9 continuous
        # batching), so `vs_host` comparisons read one vocabulary
        self.busy_rounds = 0

    # -- task plumbing --

    def new_task(
        self,
        coro: Coroutine[Any, Any, Any],
        node: NodeInfo,
        name: Optional[str],
        location: str,
    ) -> Task:
        task = Task(self.next_task_id, coro, node, self, name, location)
        self.next_task_id += 1
        return task

    def schedule(self, task: Task) -> None:
        if not task._in_queue and not task._parked and not task.finished:
            task._in_queue = True
            self.ready.append(task)

    def _pop_random(self) -> Task:
        """Uniform random pop (reference utils/mpsc.rs:71-84)."""
        i = self.rng.randrange(len(self.ready))
        last = len(self.ready) - 1
        if i != last:
            self.ready[i], self.ready[last] = self.ready[last], self.ready[i]
        return self.ready.pop()

    # -- node lifecycle --

    def create_node(
        self,
        name: Optional[str],
        cores: int,
        init: Optional[Callable[[Spawner], None]],
        restart_on_panic: bool,
        restart_on_panic_matching: List[str],
    ) -> NodeInfo:
        id = self.next_node_id
        self.next_node_id += 1
        info = NodeInfo(id, name, cores, restart_on_panic, restart_on_panic_matching)
        node = _Node(info, init)
        self.nodes[id] = node
        for cb in self.on_node_created:
            cb(id)
        if init is not None:
            init(Spawner(self, info))
        return info

    def resolve_node_id(self, id: ToNodeId) -> NodeId:
        if isinstance(id, NodeHandle):
            return id.id
        if isinstance(id, int):
            return id
        for node in self.nodes.values():
            if node.info.name == id:
                return node.info.id
        raise KeyError(f"node not found: {id!r}")

    def kill(self, id: ToNodeId) -> None:
        self._kill_id(self.resolve_node_id(id))

    def _kill_id(self, id: NodeId) -> None:
        node = self.nodes[id]
        for task in node.paused_tasks:
            task._parked = False
            task.drop()
        node.paused_tasks.clear()
        node.info.kill(self)
        for cb in self.on_node_reset:
            cb(id)

    def restart(self, id: ToNodeId) -> None:
        id = self.resolve_node_id(id)
        node = self.nodes[id]
        old = node.info
        node.info = NodeInfo(
            id, old.name, old.cores, old.restart_on_panic, old.restart_on_panic_matching
        )
        for task in node.paused_tasks:
            task.drop()
        node.paused_tasks.clear()
        old.kill(self)
        for cb in self.on_node_reset:
            cb(id)
        if node.init is not None:
            node.init(Spawner(self, node.info))

    def pause(self, id: ToNodeId) -> None:
        self.nodes[self.resolve_node_id(id)].info.paused = True

    def resume(self, id: ToNodeId) -> None:
        node = self.nodes[self.resolve_node_id(id)]
        node.info.paused = False
        for task in node.paused_tasks:
            task._parked = False
            self.schedule(task)
        node.paused_tasks.clear()

    def send_ctrl_c(self, id: ToNodeId) -> None:
        node = self.nodes[self.resolve_node_id(id)]
        watchers = node.info.ctrl_c
        if watchers is not None:
            node.info.ctrl_c = []
            for fut in watchers:
                fut.try_set_result(None)
            return
        # nobody ever listened for ctrl-c: kill the node (task/mod.rs:410-425)
        self._kill_id(node.info.id)

    def is_exit(self, id: ToNodeId) -> bool:
        return self.nodes[self.resolve_node_id(id)].info.killed

    def node_info(self, id: ToNodeId) -> NodeInfo:
        return self.nodes[self.resolve_node_id(id)].info

    # -- the event loop --

    def block_on(self, coro: Coroutine[Any, Any, Any]) -> Any:
        main = self.new_task(coro, self.main_info, "main", _caller_location())
        self.schedule(main)
        while True:
            self.run_all_ready()
            if main.finished:
                return main.join_fut.result()
            if not self.time.advance_to_next_event():
                raise DeadlockError("no events, all tasks will block forever")
            if (
                self.time_limit_ns is not None
                and self.time.elapsed_ns() >= self.time_limit_ns
            ):
                raise TimeLimitError(
                    f"time limit exceeded: {self.time_limit_ns / 1e9}s"
                )

    def run_all_ready(self) -> None:
        self.sched_rounds += 1
        if self.ready:
            self.busy_rounds += 1
        t0 = _time.perf_counter()
        try:
            self._run_all_ready()
        finally:
            self.loop_busy_s += _time.perf_counter() - t0

    def _run_all_ready(self) -> None:
        while self.ready:
            task = self._pop_random()
            task._in_queue = False
            if task.finished:
                continue
            if task.cancelled or task.node.killed:
                task.drop()
                continue
            if task.node.paused:
                task._parked = True
                self.nodes[task.node.id].paused_tasks.append(task)
                continue
            guard = context.enter_task(task)
            try:
                task.step()
            except BaseException as exc:
                self._on_task_panic(task, exc)
            finally:
                guard.exit()
            # per-poll virtual-time charge: 50-100 ns (task/mod.rs:303-305)
            self.time.advance_ns(self.rng.randrange(50, 100))

    def _on_task_panic(self, task: Task, exc: BaseException) -> None:
        info = task.node
        msg = f"{type(exc).__name__}: {exc}"
        if info.restart_on_panic or any(
            s in msg for s in info.restart_on_panic_matching
        ):
            delay_ns = self.rng.randrange(1_000_000_000, 10_000_000_000)
            node_id = info.id
            self._kill_id(node_id)
            self.time.add_timer_ns(delay_ns, lambda: self.restart(node_id))
            return
        # annotate with simulation context, then propagate (resume_unwind)
        note = (
            f"[madsim_tpu_torch] panic context: node={info.id} {info.name!r}, "
            f"task={task.id} (spawned at {task.location})"
        )
        if hasattr(exc, "add_note"):
            exc.add_note(note)
        raise exc


class NodeHandle:
    """Public handle to a simulated node (reference task/mod.rs:564-646)."""

    __slots__ = ("_executor", "_node_id")

    def __init__(self, executor: Executor, node_id: NodeId) -> None:
        self._executor = executor
        self._node_id = node_id

    @property
    def id(self) -> NodeId:
        return self._node_id

    @property
    def name(self) -> Optional[str]:
        return self._executor.nodes[self._node_id].info.name

    def spawn(
        self, coro: Coroutine[Any, Any, Any], *, name: Optional[str] = None
    ) -> JoinHandle:
        info = self._executor.nodes[self._node_id].info
        return Spawner(self._executor, info).spawn(coro, name=name)


# ---- free functions over the current context ----


def spawn(coro: Coroutine[Any, Any, Any], *, name: Optional[str] = None):
    """Spawn a task onto the current node.

    Production (non-sim) mode, the JAX face's `real_spawn` onto a running
    asyncio loop, is not ported (ROADMAP item 16b): with no simulation
    context this raises NotImplementedError.
    """
    task = context.try_current_task()
    if task is not None:
        return task.node_spawner().spawn(coro, name=name)
    handle = context.try_current_handle()
    if handle is not None:
        return Spawner(handle.executor, handle.executor.main_info).spawn(coro, name=name)
    coro.close()
    raise NotImplementedError(
        "spawn outside a simulation is production mode (real_spawn), which "
        "madsim_tpu_torch does not port yet (ROADMAP item 16b)"
    )


spawn_local = spawn  # single-threaded by construction


class _YieldNow:
    """Awaitable that suspends once and is immediately rescheduled."""

    __slots__ = ("_yielded",)

    def __init__(self) -> None:
        self._yielded = False

    def __await__(self):
        if not self._yielded:
            self._yielded = True
            yield self


def yield_now() -> _YieldNow:
    """Reschedule the current task into the (random-order) ready queue."""
    return _YieldNow()


class Builder:
    """Named task spawning (reference task/builder.rs:7-41)."""

    def __init__(self) -> None:
        self._name: Optional[str] = None

    def name(self, name: str) -> "Builder":
        self._name = name
        return self

    def spawn(self, coro: Coroutine[Any, Any, Any]) -> JoinHandle:
        return spawn(coro, name=self._name)
