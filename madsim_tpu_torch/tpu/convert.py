"""Carry a simulation state across faces: numpy leaves <-> the port's state.

A simulator's weights are its state, so this is the port's weight loader:
`state_from_numpy` takes the leaves of a JAX-face `SimState` as numpy
arrays, keyed by dotted field path (`"clock"`, `"node.term"`,
`"msgs.valid_p"`, `"strag.deliver"`, `"dur.log_len"`, `"cov.bitmap"`,
`"lin.eid"`, `"msgs.sent_eid"`, `"queue.seeds"`, `"refill.cursor"`, the
device loop's `"loop.meta_key"`, `"loop.counter"`, `"loop.next_fresh"`,
`"loop.gens_done"`, `"loop.target_gens"`, `"loop.accepts"`, `"loop.ring_*"`
(n, bits, seed, off, occ, rate, h), `"loop.union"`, `"loop.seen_h1"`/
`"loop.seen_h2"`/`"loop.seen_n"`, `"loop.gen_h_raw"`, `"loop.gen_origin"`
and `"loop.arch_*"` (seed, off, occ, rate, h, origin, violated, bitmap,
hiwater, transitions), ...; absent planes simply have no keys) and stored
as the JAX face stores them, and builds the port's `SimState` on a device.
`state_to_numpy` goes the other way, into the same paths with every integer
value widened to int64 (and the triage ctl's float32 rate scales to
float64, the device loop's ring and archive rates too), so the two
faces' states compare leaf for leaf.

Storage mapping (values are never changed): u32 leaves (keys, chain
hashes, packed bool words) become int64; the JAX face's narrow u8/i8/u16
node and pool leaves become int32; int32 and bool leaves keep their dtype.
"""

from __future__ import annotations

import collections
from typing import Dict, Optional

import numpy as np
import torch

from .engine import (
    Coverage, DevLoop, Lineage, MsgPool, NemesisState, RefillLog,
    RefillQueue, SimState, StragPool, TriageCtl,
)

_WIDE = {
    np.dtype(np.uint32): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.uint16): torch.int32,
    np.dtype(np.int16): torch.int32,
    np.dtype(np.uint8): torch.int32,
    np.dtype(np.int8): torch.int32,
    np.dtype(np.bool_): torch.bool,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32,
}


def _tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _WIDE:
        raise ValueError(f"unsupported leaf dtype {a.dtype}")
    wide = _WIDE[a.dtype]
    if wide in (torch.bool, torch.float32):
        return torch.as_tensor(a.copy(), device=device)
    return torch.as_tensor(a.astype(np.int64), device=device).to(wide)


def state_from_numpy(
    leaves: Dict[str, np.ndarray], device="cpu", node_type: Optional[type] = None,
) -> SimState:
    """Build the port's SimState from dotted-path numpy leaves.

    `node_type` is the protocol state NamedTuple (e.g. raft.RaftState);
    by default one is made from the `node.*` field names in order."""
    def fields(plane):
        return [k[len(plane) + 1:] for k in leaves if k.startswith(plane + ".")]

    nodef = fields("node")
    if node_type is None:
        node_type = collections.namedtuple("NodeState", nodef)
    elif tuple(node_type._fields) != tuple(nodef):
        raise ValueError(
            f"node fields {nodef} do not match {node_type.__name__} "
            f"{list(node_type._fields)}"
        )
    planes = {"node": node_type, "msgs": MsgPool, "strag": StragPool,
              "nem": NemesisState, "ctl": TriageCtl, "cov": Coverage,
              "lin": Lineage, "queue": RefillQueue, "refill": RefillLog,
              "loop": DevLoop}
    durf = fields("dur")
    if durf:
        planes["dur"] = collections.namedtuple("DurState", durf)
    top = {}
    for f in SimState._fields:
        names = fields(f)
        if f in planes and names:
            typ = planes[f]
            top[f] = typ(**{
                g: _tensor(leaves[f"{f}.{g}"], device)
                if f"{f}.{g}" in leaves else None
                for g in typ._fields
            })
        elif f in leaves:
            top[f] = _tensor(leaves[f], device)
        elif names:
            raise ValueError(
                f"state plane {f!r} is not carried by this slice of the port"
            )
        else:
            top[f] = None
    return SimState(**top)


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """Dotted-path numpy leaves of a port SimState (None planes dropped),
    in the JAX face's flatten order: int64, float64 for float leaves."""
    out: Dict[str, np.ndarray] = {}

    def rec(name, obj):
        if obj is None:
            return
        if isinstance(obj, tuple) and hasattr(obj, "_fields"):
            for f in obj._fields:
                rec(f"{name}.{f}" if name else f, getattr(obj, f))
        else:
            a = obj.detach().cpu().numpy()
            out[name] = a.astype(
                np.float64 if np.issubdtype(a.dtype, np.floating) else np.int64
            )

    rec("", state)
    return out
