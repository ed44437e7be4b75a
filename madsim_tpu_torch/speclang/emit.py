"""The speclang generated-module emitter.

The port of `madsim_tpu/speclang/emit.py`. `python -m
madsim_tpu_torch.speclang emit` renders, for every spec source in
`specs/`, the two thin checked-in faces under `generated/`:

  <x>_device.py  SPECLANG_DIGEST (sha256 of the spec source file) +
                 the DERIVED tables as reviewable literals + the
                 `make_spec` / `make_workload` (/ `spec_knobs`)
                 factories the workload registry rows point at
  <x>_host.py    SPECLANG_DIGEST + `fuzz_one_seed`, the generic host
                 twin (`hostrt.py`) with this protocol bound

The rendered text is a pure function of the spec source: tables come
from `device.derive_tables` (the same code `build` uses; the literals in
the file are documentation, never a second source of truth), dicts are
rendered in declaration order, and no timestamps or environment details
enter the output. `emit --check` regenerates in memory and diffs against
the files on disk.
"""

from __future__ import annotations

import hashlib
import pathlib
from typing import Dict, Tuple

from .lang import Protocol, Rate

_PKG = pathlib.Path(__file__).resolve().parent
SPECS_DIR = _PKG / "specs"
GEN_DIR = _PKG / "generated"

_HEADER = '''\
"""AUTO-GENERATED by `python -m madsim_tpu_torch.speclang emit` — DO NOT EDIT.

Source of truth: madsim_tpu_torch/speclang/specs/{src}.py (protocol
{proto!r}). Edit the spec source and re-run emit; `emit --check` fails if
this file or the digest below drifts from the source.
"""

from __future__ import annotations
'''


def source_digest(src_name: str) -> str:
    """sha256 of the spec source file — pins generated output to the
    exact source text it was emitted from."""
    return hashlib.sha256(
        (SPECS_DIR / f"{src_name}.py").read_bytes()
    ).hexdigest()


def _derived_literals(proto: Protocol) -> str:
    """The declaration-derived tables, rendered as reviewable literals
    (defaults-resolved). device.build re-derives them from the source;
    these constants show a reader what a spec edit moved."""
    from . import device

    p = proto.resolve()
    fields = proto.fields(p)
    tables = device.derive_tables(proto, fields)
    narrow = {
        f.name: f.narrow for f in fields if f.narrow is not None
    }
    floors = {}
    for f in fields:
        if isinstance(f.rate, Rate):
            floors[f.name] = (
                f"Rate(floor_us={f.rate.floor_us}, "
                f"ratchet={f.rate.ratchet}, inc={f.rate.inc}, "
                f"margin={f.rate.margin})"
            )
        elif f.rate is not None:
            floors[f.name] = f"Cap(cap={f.rate.cap})"
    lines = ["# ---- derived at defaults (documentation, not source) ----"]
    lines.append(f"STATE_FIELDS = {tuple(f.name for f in fields)!r}")
    lines.append(f"NARROW_FIELDS = {narrow!r}")
    lines.append("RATE_FLOORS = {")
    for k, v in floors.items():
        lines.append(f"    {k!r}: {v!r},")
    lines.append("}")
    lines.append(
        f"NARROW_HORIZON_US = {tables['narrow_horizon_us']!r}"
    )
    lines.append(f"TIME_FIELDS = {tables['time_fields']!r}")
    lines.append(f"MSG_KIND_NAMES = {tables['msg_kind_names']!r}")
    lines.append(f"DURABLE_FIELDS = {tables['durable_fields']!r}")
    lines.append(f"SYNC_FIELD = {tables['sync_field']!r}")
    return "\n".join(lines)


def render_device(src_name: str, proto: Protocol) -> str:
    head = _HEADER.format(src=src_name, proto=proto.name)
    knobs = ""
    if proto.knobs:
        knobs = '''

def spec_knobs(virtual_secs: float = 10.0) -> tuple:
    """The tune SpecKnob rows of the spec source's KnobDecl declarations
    (the registry's `knobs_attr` hook)."""
    return _device.knob_rows(_src.PROTOCOL, virtual_secs)
'''
    return f'''{head}
from .. import device as _device
from ..specs import {src_name} as _src

SPECLANG_DIGEST = "{source_digest(src_name)}"

{_derived_literals(proto)}


def make_spec(**overrides):
    """The fused masked ProtocolSpec compiled from the spec source."""
    return _device.build(_src.PROTOCOL, **overrides)


def make_workload(n_nodes=None, virtual_secs=10.0, loss_rate=0.1,
                  buggy=False, device="cuda", **overrides):
    """The BatchWorkload: generated spec + the spec source's chaos
    recipe + the generic host twin as host_repro (on `device`)."""
    return _device.build_workload(
        _src.PROTOCOL, n_nodes=n_nodes, virtual_secs=virtual_secs,
        loss_rate=loss_rate, buggy=buggy, device=device, **overrides,
    )
{knobs}'''


def render_host(src_name: str, proto: Protocol) -> str:
    head = _HEADER.format(src=src_name, proto=proto.name)
    return f'''{head}
from .. import hostrt as _hostrt
from ..specs import {src_name} as _src

SPECLANG_DIGEST = "{source_digest(src_name)}"

InvariantViolation = _hostrt.InvariantViolation


def fuzz_one_seed(seed, **kw):
    """One fuzzed host-twin execution of {proto.name!r} (the generic
    speclang twin with this protocol bound; `device=` picks where the
    handlers run, the card unless "cpu" is asked for); raises
    InvariantViolation on an oracle failure."""
    return _hostrt.fuzz_one_seed(_src.PROTOCOL, seed, **kw)
'''


def render_all() -> Dict[str, str]:
    """{filename -> content} for every generated module."""
    from .specs import PROTOCOLS

    out = {}
    for src_name, proto in PROTOCOLS.items():
        out[f"{src_name}_device.py"] = render_device(src_name, proto)
        out[f"{src_name}_host.py"] = render_host(src_name, proto)
    return out


def emit(check: bool = False) -> Tuple[list, list]:
    """Write (or with check=True, diff) the generated modules.
    Returns (written_or_clean, drifted)."""
    rendered = render_all()
    clean, drifted = [], []
    for fname, content in sorted(rendered.items()):
        path = GEN_DIR / fname
        on_disk = path.read_text() if path.exists() else None
        if on_disk == content:
            clean.append(fname)
            continue
        if check:
            drifted.append(fname)
        else:
            GEN_DIR.mkdir(exist_ok=True)
            path.write_text(content)
            clean.append(fname)
    return clean, drifted
