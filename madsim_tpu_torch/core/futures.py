"""Minimal deterministic Future machinery for the simulation executor.

The reference rides on Rust's `async-task` crate; here the analog is a tiny
single-threaded Future: tasks drive coroutines via `coro.send(None)`, and any
suspension point bottoms out in a `Future` yielded to the executor. No locks,
no thread-safety — the whole simulation is one OS thread by construction
(reference forbids real threads in sim, task/mod.rs:753-769).
"""

from __future__ import annotations

from typing import Any, Callable, Generator, Generic, List, Optional, TypeVar

T = TypeVar("T")


class Future(Generic[T]):
    """One-shot completion cell; awaiting yields it to the executor."""

    __slots__ = ("_done", "_result", "_exc", "_callbacks", "_abandoned")

    def __init__(self) -> None:
        self._done = False
        self._result: Optional[T] = None
        self._exc: Optional[BaseException] = None
        self._callbacks: List[Callable[["Future[T]"], None]] = []
        self._abandoned = False

    def done(self) -> bool:
        return self._done

    def abandoned(self) -> bool:
        return self._abandoned

    def abandon(self) -> None:
        """Mark that no task will ever consume this future's result.

        Set when the awaiting task is dropped (killed node / abort) so that
        producers (channels, semaphores, mailboxes) skip it instead of
        handing a wakeup/message to a dead consumer — otherwise the value
        would be silently lost (kill() is a chaos primitive; this matters).
        """
        self._abandoned = True

    def result(self) -> T:
        if not self._done:
            raise RuntimeError("future is not done")
        if self._exc is not None:
            raise self._exc
        return self._result  # type: ignore[return-value]

    def exception(self) -> Optional[BaseException]:
        return self._exc if self._done else None

    def set_result(self, result: T) -> None:
        if self._abandoned:
            return  # consumer is gone; drop silently
        if self._done:
            raise RuntimeError("future already done")
        self._result = result
        self._done = True
        self._run_callbacks()

    def set_exception(self, exc: BaseException) -> None:
        if self._abandoned:
            return
        if self._done:
            raise RuntimeError("future already done")
        self._exc = exc
        self._done = True
        self._run_callbacks()

    def try_set_result(self, result: T) -> bool:
        if self._done or self._abandoned:
            return False
        self.set_result(result)
        return True

    def add_done_callback(self, cb: Callable[["Future[T]"], None]) -> None:
        if self._done:
            cb(self)
        else:
            self._callbacks.append(cb)

    def _run_callbacks(self) -> None:
        callbacks, self._callbacks = self._callbacks, []
        for cb in callbacks:
            cb(self)

    def __await__(self) -> Generator[Any, None, T]:
        if not self._done:
            from . import context

            if context.try_current_task() is not None:
                # simulation mode: yield to the DES executor
                yield self
            else:
                # production mode: the same Future (and so every sync
                # primitive built on it) works under a real asyncio loop —
                # the dual-mode boundary of reference lib.rs:14-23
                import asyncio

                loop = asyncio.get_running_loop()
                afut = loop.create_future()
                self.add_done_callback(
                    lambda f: afut.done() or afut.set_result(None)
                )
                yield from afut.__await__()
        if not self._done:
            raise RuntimeError("task resumed but future is not done")
        return self.result()


async def pending() -> Any:
    """A future that never completes (blocks forever in virtual time)."""
    await Future()
