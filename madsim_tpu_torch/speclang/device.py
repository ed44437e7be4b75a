"""The speclang device backend: compile a Protocol to a ProtocolSpec.

The port of `madsim_tpu/speclang/device.py`, in the port's spec contract
(`tpu/spec.py`): handler bodies take explicit leading `[L, N]` axes, and
constant leaves are int32 `[L, N, *shape]` on the key's device.
Everything a hand-written `tpu/<x>.py` module re-states by hand is DERIVED
here from the spec-source declarations, exactly once:

  state NamedTuple   field order = declaration order
  init               constant leaves from Field.init, draw leaves from
                     the callable form, first deadline from the body's
                     `first_timer`
  on_restart         volatile fields reset to their init constants;
                     the deadline comes from `restart_timer`, which
                     receives the PRE-reset state (twopc inspects its
                     in-doubt set across the reset boundary) and the
                     per-lane restart instant `now` [L]
  narrow_fields      Field.narrow (as numpy dtypes, as every port spec)
  rate_floors        Field.rate (Rate -> RateFloor, Cap -> HardCap)
  narrow_horizon_us  min over Rate-bounded fields of
                     (dtype_max - max(0, init)) * floor_us
                         // (ratchet * inc * margin)
  time_fields        Field.time
  msg_kind_names     Protocol.messages
  durable plane      DiskPlane.fields / .sync_field + the body's
                     optional on_recover
  tune knob rows     KnobDecl -> tune.SpecKnob (`knob_rows`)

`build` introduces no operation of its own into the handler dataflow, so
a spec transcribed from a hand module runs bit-identically to it
(tests/test_torch_speclang.py holds twopc-gen to `GOLDEN["twopc"]` and
lease-gen to the hand lease, leaf for leaf).
"""

from __future__ import annotations

import dataclasses
import functools
from collections import namedtuple
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..tpu.spec import (
    HardCap,
    ProtocolSpec,
    RateFloor,
    fuse_two_handlers,
    wraps_event,
)
from .lang import NARROW_MAX, Cap, Field, Protocol, Rate, validate_protocol

_NARROW_NP = {
    "u8": np.uint8,
    "u16": np.uint16,
    "i8": np.int8,
    "i16": np.int16,
}

# one NamedTuple class per (protocol, resolved field layout), so two builds
# of the same protocol produce states of one type
_STATE_CACHE: Dict[Tuple, Any] = {}
_VALIDATED: set = set()


def _state_type(proto: Protocol, fields: Tuple[Field, ...]):
    key = (proto.name, tuple((f.name, tuple(f.shape)) for f in fields))
    if key not in _STATE_CACHE:
        cls_name = "".join(
            w.capitalize() for w in proto.name.replace("-", "_").split("_")
        ) + "State"
        _STATE_CACHE[key] = namedtuple(cls_name, [f.name for f in fields])
    return _STATE_CACHE[key]


def _const_leaf(f: Field, key: torch.Tensor) -> torch.Tensor:
    """The field's int32 init constant over `key`'s [L, N] axes."""
    if callable(f.init):
        raise ValueError(
            f"field {f.name}: draw-based init has no restart constant"
        )
    return torch.full(tuple(key.shape) + tuple(f.shape), f.init,
                      dtype=torch.int32, device=key.device)


def derive_tables(proto: Protocol, fields: Tuple[Field, ...]) -> dict:
    """The declaration-derived ProtocolSpec tables (shared by `build`
    and the emitter, which renders them as reviewable literals)."""
    narrow: Dict[str, Any] = {}
    floors: Dict[str, Any] = {}
    horizon: Optional[int] = None
    for f in fields:
        if f.narrow is not None:
            narrow[f.name] = _NARROW_NP[f.narrow]
        if isinstance(f.rate, Rate):
            floors[f.name] = RateFloor(
                floor_us=f.rate.floor_us, ratchet=f.rate.ratchet,
                inc=f.rate.inc, why=f.rate.why,
            )
            top = NARROW_MAX[f.narrow] - max(0, f.init)
            h = (top * f.rate.floor_us) // (
                f.rate.ratchet * f.rate.inc * f.rate.margin
                * proto.horizon_margin
            )
            horizon = h if horizon is None else min(horizon, h)
        elif isinstance(f.rate, Cap):
            floors[f.name] = HardCap(cap=f.rate.cap, why=f.rate.why)
    return {
        "narrow_fields": narrow or None,
        "rate_floors": floors or None,
        "narrow_horizon_us": horizon,
        "time_fields": tuple(f.name for f in fields if f.time),
        "msg_kind_names": tuple(proto.messages),
        "durable_fields": (
            tuple(proto.disk.fields) if proto.disk is not None else ()
        ),
        "sync_field": (
            proto.disk.sync_field if proto.disk is not None else None
        ),
    }


def build(proto: Protocol, **overrides) -> ProtocolSpec:
    """Compile one Protocol (with param overrides) to the fused masked
    ProtocolSpec the engine runs. Validation (the restriction walk)
    runs once per protocol object."""
    if id(proto) not in _VALIDATED:
        validate_protocol(proto)
        _VALIDATED.add(id(proto))
    p = proto.resolve(**overrides)
    fields = proto.fields(p)
    State = _state_type(proto, fields)
    handlers = dict(proto.body(p, State))

    first_timer = handlers["first_timer"]
    restart_timer = handlers["restart_timer"]
    volatile = tuple(f for f in fields if not f.durable)

    def init(key, nid):
        state = State(**{
            f.name: (f.init(key, nid) if callable(f.init) else
                     _const_leaf(f, key))
            for f in fields
        })
        return state, first_timer(key, nid)

    def on_restart(s, nid, now, key):
        state = s._replace(**{f.name: _const_leaf(f, key) for f in volatile})
        # the deadline may inspect the PRE-reset state (what survived)
        return state, restart_timer(s, nid, now, key)

    tables = derive_tables(proto, fields)
    max_out = proto.max_out(p)
    max_out_msg = (
        proto.max_out_msg(p) if proto.max_out_msg is not None else max_out
    )
    common = dict(
        name=f"{proto.name}{p.n_nodes}",
        n_nodes=p.n_nodes,
        payload_width=proto.payload_width,
        max_out=max_out,
        max_out_msg=max_out_msg,
        init=init,
        on_restart=on_restart,
        check_invariants=handlers["check_invariants"],
        lane_metrics=handlers.get("lane_metrics"),
        on_recover=handlers.get("on_recover"),
        **tables,
    )
    if proto.fused:
        on_event = handlers["on_event"]
        width = proto.payload_width

        @wraps_event(on_event)
        def on_message(s, nid, src, kind, payload, now, key):
            return on_event(s, nid, src, kind, payload, now, key)

        @wraps_event(on_event)
        def on_timer(s, nid, now, key):
            z = torch.zeros_like(now)
            return on_event(
                s, nid, z, z - 1,
                torch.zeros(now.shape + (width,), dtype=torch.int32,
                            device=now.device),
                now, key,
            )

        return ProtocolSpec(
            on_message=on_message, on_timer=on_timer, on_event=on_event,
            **common,
        )
    return fuse_two_handlers(ProtocolSpec(
        on_message=handlers["on_message"], on_timer=handlers["on_timer"],
        **common,
    ))


def build_workload(
    proto: Protocol,
    n_nodes: Optional[int] = None,
    virtual_secs: float = 10.0,
    loss_rate: float = 0.1,
    buggy: bool = False,
    device="cuda",
    **spec_overrides,
):
    """The BatchWorkload: generated spec + SimConfig from the spec
    source's `workload` section + the generic host twin as host_repro
    (the debugging-microscope contract every hand workload ships), its
    handlers on `device` (the card unless the caller asks for the CPU)."""
    from ..tpu.batch import BatchWorkload, twin_repro
    from . import hostrt

    if proto.workload is None:
        raise ValueError(f"{proto.name}: spec source declares no workload")
    overrides = dict(spec_overrides)
    if n_nodes is not None:
        overrides["n_nodes"] = n_nodes
    if buggy:
        if proto.buggy_param is None:
            raise ValueError(
                f"{proto.name}: no planted-bug param declared"
            )
        overrides[proto.buggy_param] = True
    spec = build(proto, **overrides)
    p = proto.resolve(**overrides)
    cfg = proto.workload(spec, p, virtual_secs, loss_rate)

    host_repro = twin_repro(
        functools.partial(hostrt.fuzz_one_seed, proto),
        hostrt.InvariantViolation, n_nodes=p.n_nodes,
        virtual_secs=virtual_secs, loss_rate=loss_rate, buggy=buggy,
        device=device,
    )
    return BatchWorkload(spec=spec, config=cfg, host_repro=host_repro)


def knob_rows(proto: Protocol, virtual_secs: float = 10.0) -> tuple:
    """The Tier-B SpecKnob rows derived from the spec source's KnobDecl
    declarations: every generated spec is born autotunable. Each row's
    rebuild swaps in the spec rebuilt through `build` at its value."""
    from ..tune import SpecKnob

    rows = []
    for k in proto.knobs:
        def rebuild(wl, v, _param=k.param):
            val = int(v) if isinstance(v, (int, float)) else v
            return dataclasses.replace(wl, spec=build(proto, **{_param: val}))

        rows.append(SpecKnob(k.name, tuple(k.values), rebuild,
                             default=k.default))
    return tuple(rows)
