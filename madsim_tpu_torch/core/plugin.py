"""Simulator plugin framework (reference madsim/src/sim/plugin.rs:18-59).

A `Simulator` virtualizes one class of resource (network, filesystem, ...).
Each `Runtime` owns one instance of each registered simulator type, created
with the runtime's RNG + config, and receives node lifecycle fan-out:
`create_node` on node creation, `reset_node` on kill/restart.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Dict, Type, TypeVar

if TYPE_CHECKING:
    from .runtime import Handle

S = TypeVar("S", bound="Simulator")


class Simulator:
    """Base class for resource simulators."""

    def __init__(self, rng, time, config) -> None:  # noqa: ANN001 - see Runtime
        pass

    def create_node(self, node_id: int) -> None:
        pass

    def reset_node(self, node_id: int) -> None:
        pass


def simulator(cls: Type[S]) -> S:
    """Look up the instance of simulator type `cls` in the current runtime."""
    from . import context

    handle = context.current_handle()
    sim = handle.simulators.get(cls)
    if sim is None:
        raise KeyError(f"simulator not registered: {cls.__name__}")
    return sim  # type: ignore[return-value]


def node() -> int:
    """The current node id."""
    from . import context

    return context.current_task().node.id
