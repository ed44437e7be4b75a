"""Speclang, the single-source protocol spec compiler (both faces).

The port of `madsim_tpu/speclang/`: a protocol is ONE spec source
(`speclang/specs/<x>.py`, written in the restricted vocabulary `lang.py`
validates, with handler bodies over the port's [L, N] axes) and two thin
generated modules (`speclang/generated/<x>_device.py` and `<x>_host.py`)
emitted by `python -m madsim_tpu_torch.speclang emit`, checked in and
drift-checked by `emit --check`.

  lang.py    the language surface: Field/Rate/Cap/KnobDecl/DiskPlane
             declarations + the Protocol container, plus the AST
             restriction validator (a copy of the JAX face's)
  device.py  the device backend: `build(proto)` derives the state
             NamedTuple, init, on_restart, narrow_fields, rate_floors,
             narrow_horizon_us, time_fields, msg_kind_names and the
             durable plane FROM the declarations, and gives the fused
             masked `ProtocolSpec` the engine runs
  hostrt.py  the host backend: the generic host twin that runs the same
             compiled handlers, one [1, 1] call per event on `device=`,
             over the host runtime's simulated network
  emit.py    the deterministic generated-module emitter + the
             spec-source digest that pins generated output to source

Registration is one row in
`madsim_tpu_torch/workloads/__init__.py`.
"""

from __future__ import annotations

from .lang import (  # noqa: F401
    Cap,
    DiskPlane,
    Field,
    KnobDecl,
    Protocol,
    Rate,
    validate_protocol,
)
