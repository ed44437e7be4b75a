"""The lane mesh: the port's counterpart of a one-axis `jax.sharding.Mesh`.

A `Mesh` is an ordered tuple of torch devices and an axis name ("seeds"
for a sweep's lanes, "islands" for a federation). Entries may repeat: a
mesh of `(cpu,) * 8` is what the JAX suite's eight virtual CPU devices
are, and `(cuda:0,) * 4` runs four shards on one card. A sharded sweep
splits its lanes (or its admission queue) into `mesh.size` contiguous
blocks, shard d on `mesh.devices[d]`; no draw folds the lane index, so a
seed's result does not depend on the shard it landed on.

A mesh that names a CUDA index the host lacks raises when it is built; it
never falls back to another device.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Tuple

import torch


def _card_count() -> int:
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def canonical_device(device) -> torch.device:
    """`device` as a torch device with its CUDA index made explicit ("cuda"
    is the current card). A CUDA device the host lacks raises: without
    any card, the same RuntimeError the engine's entry points raise."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    n = _card_count()
    if n == 0:
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "engine on the CPU"
        )
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < n:
        raise ValueError(
            f"{dev} names a card this host lacks: {n} CUDA device(s) "
            "visible"
        )
    return torch.device("cuda", index)


class Mesh:
    """A 1-D device mesh: `devices` (torch devices, in shard order, repeats
    allowed) and one axis name. `size` is the shard count."""

    def __init__(self, devices: Iterable, axis_name: str = "seeds") -> None:
        devs = tuple(canonical_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices: Tuple[torch.device, ...] = devs
        self.axis_name = str(axis_name)

    @property
    def size(self) -> int:
        return len(self.devices)

    def __eq__(self, other) -> bool:
        return (isinstance(other, Mesh) and other.devices == self.devices
                and other.axis_name == self.axis_name)

    def __hash__(self) -> int:
        return hash((self.devices, self.axis_name))

    def __repr__(self) -> str:
        devs = ", ".join(str(d) for d in self.devices)
        return f"Mesh(({devs}), {self.axis_name!r})"


def device_context(device):
    """`torch.cuda.device(device)` for a CUDA device (a thread driving a
    card makes it current); a no-op context otherwise."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def visible_devices(device="cuda") -> Tuple[torch.device, ...]:
    """Every visible device of `device`'s type: each card for CUDA, the one
    CPU device otherwise."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i) for i in range(_card_count()))
    return (torch.device(dev.type),)
