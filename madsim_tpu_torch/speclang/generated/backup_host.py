"""AUTO-GENERATED by `python -m madsim_tpu_torch.speclang emit` — DO NOT EDIT.

Source of truth: madsim_tpu_torch/speclang/specs/backup.py (protocol
'backup'). Edit the spec source and re-run emit; `emit --check` fails if
this file or the digest below drifts from the source.
"""

from __future__ import annotations

from .. import hostrt as _hostrt
from ..specs import backup as _src

SPECLANG_DIGEST = "374c66f1d06208d08692936b1e26d3491a8488ab00671b1f09cf760668d82bc7"

InvariantViolation = _hostrt.InvariantViolation


def fuzz_one_seed(seed, **kw):
    """One fuzzed host-twin execution of 'backup' (the generic
    speclang twin with this protocol bound; `device=` picks where the
    handlers run, the card unless "cpu" is asked for); raises
    InvariantViolation on an oracle failure."""
    return _hostrt.fuzz_one_seed(_src.PROTOCOL, seed, **kw)
