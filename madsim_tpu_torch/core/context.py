"""Thread-local simulation context: current runtime handle + current task.

Analog of reference madsim/src/sim/runtime/context.rs:14-77. One OS thread
runs at most one simulation at a time (seed sweeps use one thread per seed),
so the context is `threading.local`. Entering a runtime or a task returns a
guard object; guards must be exited in LIFO order.
"""

from __future__ import annotations

import threading
from typing import TYPE_CHECKING, Optional

if TYPE_CHECKING:
    from .runtime import Handle
    from .task import Task

_tls = threading.local()


class NoContextError(RuntimeError):
    pass


def current_handle() -> "Handle":
    h = getattr(_tls, "handle", None)
    if h is None:
        raise NoContextError(
            "there is no simulation context; this API must be called from "
            "within a madsim_tpu_torch Runtime (e.g. inside Runtime.block_on)"
        )
    return h


def try_current_handle() -> Optional["Handle"]:
    return getattr(_tls, "handle", None)


def current_task() -> "Task":
    t = getattr(_tls, "task", None)
    if t is None:
        raise NoContextError("this API must be called from within a running task")
    return t


def try_current_task() -> Optional["Task"]:
    return getattr(_tls, "task", None)


class _Guard:
    def __init__(self, attr: str, prev: object) -> None:
        self._attr = attr
        self._prev = prev

    def exit(self) -> None:
        setattr(_tls, self._attr, self._prev)

    def __enter__(self) -> "_Guard":
        return self

    def __exit__(self, *exc: object) -> None:
        self.exit()


def enter(handle: "Handle") -> _Guard:
    prev = getattr(_tls, "handle", None)
    if prev is not None:
        raise RuntimeError("cannot run a Runtime within a Runtime")
    _tls.handle = handle
    return _Guard("handle", prev)


def enter_task(task: "Task") -> _Guard:
    prev = getattr(_tls, "task", None)
    _tls.task = task
    return _Guard("task", prev)
