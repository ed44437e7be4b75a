"""Speclang, the single-source protocol spec compiler (device face).

The port of `madsim_tpu/speclang/`: a protocol is ONE spec source
(`speclang/specs/<x>.py`, written in the restricted vocabulary `lang.py`
validates, with handler bodies over the port's [L, N] axes) and one thin
generated module (`speclang/generated/<x>_device.py`) emitted by
`python -m madsim_tpu_torch.speclang emit`, checked in and drift-checked
by `emit --check`.

  lang.py    the language surface: Field/Rate/Cap/KnobDecl/DiskPlane
             declarations + the Protocol container, plus the AST
             restriction validator (a copy of the JAX face's)
  device.py  the device backend: `build(proto)` derives the state
             NamedTuple, init, on_restart, narrow_fields, rate_floors,
             narrow_horizon_us, time_fields, msg_kind_names and the
             durable plane FROM the declarations, and gives the fused
             masked `ProtocolSpec` the engine runs
  emit.py    the deterministic generated-module emitter + the
             spec-source digest that pins generated output to source

The host face (the generic host twin, `<x>_host.py`) is not ported
(ROADMAP.md queue 1, item 16). Registration is one row in
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
