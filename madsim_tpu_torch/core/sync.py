"""Deterministic async synchronization primitives (tokio::sync analog).

The reference reuses real tokio `sync` inside the simulation — safe because
polling is single-threaded and deterministic (madsim-tokio/src/lib.rs:1-51).
Here the equivalents are built on the simulation's own `Future`: unbounded /
bounded mpsc channels, oneshot (= `Future`), watch, Notify, Semaphore, Event,
plus async Mutex / RwLock / OnceCell, a `select` race combinator (the
`tokio::select!` analog), and `JoinSet`.
No locks anywhere — one OS thread by construction.
"""

from __future__ import annotations

import inspect
from collections import deque
from typing import (
    Any,
    Awaitable,
    Deque,
    Generic,
    List,
    Optional,
    Set,
    Tuple,
    TypeVar,
)

from .futures import Future

T = TypeVar("T")


class ChannelClosed(Exception):
    """Receiving on an empty+closed channel, or sending on a closed one."""


class Channel(Generic[T]):
    """MPSC channel. Unbounded by default; bounded if capacity is given."""

    def __init__(self, capacity: Optional[int] = None) -> None:
        self._queue: Deque[T] = deque()
        self._capacity = capacity
        self._recv_waiters: Deque[Future[None]] = deque()
        self._send_waiters: Deque[Future[None]] = deque()
        self._closed = False

    # -- sender side --

    def try_send(self, value: T) -> bool:
        if self._closed:
            raise ChannelClosed("channel closed")
        if self._capacity is not None and len(self._queue) >= self._capacity:
            return False
        self._queue.append(value)
        self._wake_one(self._recv_waiters)
        return True

    async def send(self, value: T) -> None:
        while not self.try_send(value):
            fut: Future[None] = Future()
            self._send_waiters.append(fut)
            await fut
        return None

    def send_nowait(self, value: T) -> None:
        """Unbounded send (raises on bounded-full or closed)."""
        if not self.try_send(value):
            raise RuntimeError("channel full")

    # -- receiver side --

    def try_recv(self) -> Tuple[bool, Optional[T]]:
        if self._queue:
            value = self._queue.popleft()
            self._wake_one(self._send_waiters)
            return True, value
        if self._closed:
            raise ChannelClosed("channel closed")
        return False, None

    async def recv(self) -> T:
        while True:
            ok, value = self.try_recv()
            if ok:
                return value  # type: ignore[return-value]
            fut: Future[None] = Future()
            self._recv_waiters.append(fut)
            await fut

    # -- common --

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        for fut in self._recv_waiters:
            fut.try_set_result(None)
        self._recv_waiters.clear()
        for fut in self._send_waiters:
            fut.try_set_result(None)
        self._send_waiters.clear()

    @property
    def closed(self) -> bool:
        return self._closed

    def __len__(self) -> int:
        return len(self._queue)

    @staticmethod
    def _wake_one(waiters: Deque[Future[None]]) -> None:
        while waiters:
            if waiters.popleft().try_set_result(None):
                break


def oneshot() -> Tuple["OneshotSender[T]", Future[T]]:
    fut: Future[T] = Future()
    return OneshotSender(fut), fut


class OneshotSender(Generic[T]):
    __slots__ = ("_fut",)

    def __init__(self, fut: Future[T]) -> None:
        self._fut = fut

    def send(self, value: T) -> bool:
        return self._fut.try_set_result(value)


class Watch(Generic[T]):
    """Single-value watch channel: receivers see the latest value."""

    def __init__(self, initial: T) -> None:
        self.value = initial
        self.version = 0
        self._waiters: List[Future[None]] = []

    def send(self, value: T) -> None:
        self.value = value
        self.version += 1
        waiters, self._waiters = self._waiters, []
        for fut in waiters:
            fut.try_set_result(None)

    async def changed(self, seen_version: Optional[int] = None) -> T:
        version = self.version if seen_version is None else seen_version
        while self.version == version:
            fut: Future[None] = Future()
            self._waiters.append(fut)
            await fut
        return self.value

    def borrow(self) -> T:
        return self.value


class Notify:
    """Wake one / wake all notification primitive."""

    def __init__(self) -> None:
        self._waiters: Deque[Future[None]] = deque()
        self._pending = 0

    async def notified(self) -> None:
        if self._pending > 0:
            self._pending -= 1
            return
        fut: Future[None] = Future()
        self._waiters.append(fut)
        await fut

    def notify_one(self) -> None:
        while self._waiters:
            if self._waiters.popleft().try_set_result(None):
                return
        # tokio's Notify stores at most ONE permit: repeated notify_one with
        # no waiters must not grant multiple stored wakeups
        self._pending = 1

    def notify_waiters(self) -> None:
        waiters, self._waiters = self._waiters, deque()
        for fut in waiters:
            fut.try_set_result(None)


class Semaphore:
    def __init__(self, permits: int) -> None:
        self._permits = permits
        self._waiters: Deque[Future[None]] = deque()

    async def acquire(self) -> None:
        while self._permits <= 0:
            fut: Future[None] = Future()
            self._waiters.append(fut)
            await fut
        self._permits -= 1

    def try_acquire(self) -> bool:
        if self._permits > 0:
            self._permits -= 1
            return True
        return False

    def release(self) -> None:
        self._permits += 1
        while self._waiters:
            if self._waiters.popleft().try_set_result(None):
                break

    def available_permits(self) -> int:
        return self._permits


class Event:
    """One-shot broadcast flag."""

    def __init__(self) -> None:
        self._fut: Future[None] = Future()

    def set(self) -> None:
        self._fut.try_set_result(None)

    def is_set(self) -> bool:
        return self._fut.done()

    async def wait(self) -> None:
        if not self._fut.done():
            await self._fut


class Barrier:
    def __init__(self, n: int) -> None:
        if n < 1:
            raise ValueError("barrier size must be >= 1")
        self._n = n
        self._count = 0
        self._event = Event()

    async def wait(self) -> bool:
        """Returns True for the leader (last arriver)."""
        self._count += 1
        if self._count == self._n:
            event, self._event = self._event, Event()
            self._count = 0
            event.set()
            return True
        event = self._event
        await event.wait()
        return False


class Mutex(Generic[T]):
    """Async mutual exclusion guarding an optional value (tokio::sync::Mutex).

    Usage:  `async with mutex: ... mutex.value ...`. Unlock wakes EVERY
    parked waiter and each retries `try_lock` (losers re-park): a
    single-handoff wakeup can be lost when the chosen waiter's task is
    aborted *after* its future resolves but before it runs, deadlocking the
    rest on a free lock — wake-all makes a lost wakeup require every woken
    waiter to die, in which case nobody is left waiting.
    """

    def __init__(self, value: Optional[T] = None) -> None:
        self.value = value
        self._locked = False
        self._waiters: Deque[Future[None]] = deque()

    def locked(self) -> bool:
        return self._locked

    def try_lock(self) -> bool:
        if self._locked:
            return False
        self._locked = True
        return True

    async def lock(self) -> "Mutex[T]":
        while not self.try_lock():
            fut: Future[None] = Future()
            self._waiters.append(fut)
            await fut
        return self

    def unlock(self) -> None:
        if not self._locked:
            raise RuntimeError("unlock of an unlocked Mutex")
        self._locked = False
        waiters, self._waiters = self._waiters, deque()
        for fut in waiters:
            fut.try_set_result(None)

    async def __aenter__(self) -> "Mutex[T]":
        return await self.lock()

    async def __aexit__(self, *exc: object) -> None:
        self.unlock()


class RwLock(Generic[T]):
    """Async readers-writer lock (tokio::sync::RwLock): many readers XOR one
    writer. Writer-preferring: once a writer is queued, new readers wait —
    the tokio fairness policy, and it avoids writer starvation."""

    def __init__(self, value: Optional[T] = None) -> None:
        self.value = value
        self._readers = 0
        self._writer = False
        self._writers_waiting = 0
        self._read_waiters: Deque[Future[None]] = deque()
        self._write_waiters: Deque[Future[None]] = deque()

    async def read(self) -> "_ReadGuard[T]":
        while self._writer or self._writers_waiting > 0:
            fut: Future[None] = Future()
            self._read_waiters.append(fut)
            await fut
        self._readers += 1
        return _ReadGuard(self)

    async def write(self) -> "_WriteGuard[T]":
        self._writers_waiting += 1
        try:
            while self._writer or self._readers > 0:
                fut: Future[None] = Future()
                self._write_waiters.append(fut)
                await fut
        finally:
            self._writers_waiting -= 1
        self._writer = True
        return _WriteGuard(self)

    def _release_read(self) -> None:
        self._readers -= 1
        if self._readers == 0:
            self._wake_next()

    def _release_write(self) -> None:
        self._writer = False
        self._wake_next()

    def _wake_next(self) -> None:
        # wake-all + retry (see Mutex.unlock): a single-handoff wake is lost
        # if the chosen waiter's task is aborted post-wake. Readers woken
        # while writers are queued just re-park (the _writers_waiting gate
        # keeps writer preference); correctness never depends on any one
        # woken task surviving.
        for attr in ("_write_waiters", "_read_waiters"):
            waiters = getattr(self, attr)
            setattr(self, attr, deque())
            for fut in waiters:
                fut.try_set_result(None)


class _ReadGuard(Generic[T]):
    __slots__ = ("_lock", "_released")

    def __init__(self, lock: RwLock) -> None:
        self._lock = lock
        self._released = False

    @property
    def value(self) -> Optional[T]:
        return self._lock.value

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._lock._release_read()

    async def __aenter__(self) -> "_ReadGuard[T]":
        return self

    async def __aexit__(self, *exc: object) -> None:
        self.release()


class _WriteGuard(Generic[T]):
    __slots__ = ("_lock", "_released")

    def __init__(self, lock: RwLock) -> None:
        self._lock = lock
        self._released = False

    @property
    def value(self) -> Optional[T]:
        return self._lock.value

    @value.setter
    def value(self, v: T) -> None:
        self._lock.value = v

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._lock._release_write()

    async def __aenter__(self) -> "_WriteGuard[T]":
        return self

    async def __aexit__(self, *exc: object) -> None:
        self.release()


class OnceCell(Generic[T]):
    """A cell initialized at most once (tokio::sync::OnceCell).

    `get_or_init` runs the async factory in exactly one caller; concurrent
    callers wait for that initialization (and retry with their own factory
    if it raises — the tokio contract)."""

    def __init__(self) -> None:
        self._value: Optional[T] = None
        self._set = False
        self._initializing = False
        self._waiters: Deque[Future[None]] = deque()

    def get(self) -> Optional[T]:
        return self._value if self._set else None

    def initialized(self) -> bool:
        return self._set

    def set(self, value: T) -> bool:
        if self._set:
            return False
        self._value = value
        self._set = True
        self._wake_all()
        return True

    async def get_or_init(self, factory) -> T:
        while True:
            if self._set:
                return self._value  # type: ignore[return-value]
            if not self._initializing:
                self._initializing = True
                try:
                    value = await factory()
                except BaseException:
                    self._initializing = False
                    self._wake_all()  # let another caller try
                    raise
                self._initializing = False
                if not self.set(value):
                    # a concurrent set() won while the factory ran: the
                    # stored value is the cell's truth, not ours
                    return self._value  # type: ignore[return-value]
                return value
            fut: Future[None] = Future()
            self._waiters.append(fut)
            await fut

    def _wake_all(self) -> None:
        waiters, self._waiters = self._waiters, deque()
        for fut in waiters:
            fut.try_set_result(None)


class SelectError(Exception):
    """Every select branch failed (all raised / all closed)."""


async def select(*branches: Awaitable) -> Tuple[int, Any]:
    """Race awaitables; return (index, result) of the first to finish.

    The `tokio::select!` analog (madsim-tokio re-exports real select!,
    lib.rs:1-51 — safe there for the same reason it is here: polling is
    single-threaded and deterministic). Branches may be coroutines (spawned
    as tasks on the current node and aborted when they lose — losers' cleanup
    runs via coroutine close), `Future`s, or `JoinHandle`s. If the winner
    raised, its exception propagates.
    """
    from . import task as task_mod

    if not branches:
        raise ValueError("select of no branches")

    async def _guard(br):
        # a branch exception must surface through select's return, not crash
        # the simulation as an unhandled task panic
        try:
            return True, await br
        except GeneratorExit:  # loser being aborted: let close() proceed
            raise
        except BaseException as e:  # noqa: BLE001
            return False, e

    race: Future[int] = Future()
    spawned = []  # (JoinHandle, branch coroutine) we own, abort on loss
    futs: List[Future] = []
    guarded: Set[int] = set()
    try:
        for i, br in enumerate(branches):
            if inspect.iscoroutine(br):
                handle = task_mod.spawn(_guard(br), name=f"select-{i}")
                spawned.append((handle, br))
                fut = handle.task.join_fut
                guarded.add(i)
            elif isinstance(br, Future):
                fut = br
            elif hasattr(br, "task"):  # JoinHandle duck-type
                fut = br.task.join_fut
            else:
                raise TypeError(
                    f"select branch {i}: unsupported awaitable {br!r}"
                )
            futs.append(fut)
            fut.add_done_callback(lambda _f, i=i: race.try_set_result(i))
        winner = await race
    finally:
        for handle, br in spawned:
            if not handle.is_finished():
                handle.abort()
            # a guard task aborted before its first poll never entered
            # `await br` — close the branch coroutine directly; branches the
            # guard did enter get GeneratorExit via the abort's coro.close()
            if inspect.getcoroutinestate(br) == "CORO_CREATED":
                br.close()
        # a registration error leaves later branches unprocessed: close raw
        # coroutines instead of leaking them un-awaited
        for br in branches[len(futs):]:
            if inspect.iscoroutine(br):
                br.close()
    win_fut = futs[winner]
    try:
        value = win_fut.result()
    except task_mod.JoinError as e:
        if e.is_cancelled():
            raise SelectError("winning branch was cancelled") from e
        raise
    if winner in guarded:
        ok, payload = value
        if not ok:
            raise payload
        return winner, payload
    return winner, value


class JoinSet:
    """A set of spawned tasks joined in completion order (tokio JoinSet)."""

    def __init__(self) -> None:
        self._pending: Set[Any] = set()  # unfinished JoinHandles
        self._finished: Deque[Future] = deque()  # join futs, completion order
        self._waiters: Deque[Future[None]] = deque()

    def spawn(self, coro, *, name: Optional[str] = None):
        from . import task as task_mod

        handle = task_mod.spawn(coro, name=name)
        self._pending.add(handle)

        def on_done(fut: Future, handle=handle) -> None:
            self._pending.discard(handle)
            self._finished.append(fut)
            while self._waiters:
                if self._waiters.popleft().try_set_result(None):
                    break

        handle.task.join_fut.add_done_callback(on_done)
        return handle

    def __len__(self) -> int:
        return len(self._pending) + len(self._finished)

    def is_empty(self) -> bool:
        return len(self) == 0

    async def join_next(self) -> Optional[Any]:
        """Result of the next task to finish; None when the set is empty.
        Raises JoinError if that task was aborted or panicked."""
        while True:
            if self._finished:
                return self._finished.popleft().result()
            if not self._pending:
                return None
            fut: Future[None] = Future()
            self._waiters.append(fut)
            await fut

    def abort_all(self) -> None:
        for handle in list(self._pending):
            handle.abort()

    async def shutdown(self) -> None:
        """Abort everything and drain the completions."""
        self.abort_all()
        from .task import JoinError

        while len(self):
            try:
                await self.join_next()
            except JoinError:
                pass
