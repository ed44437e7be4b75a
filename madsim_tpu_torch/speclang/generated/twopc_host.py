"""AUTO-GENERATED by `python -m madsim_tpu_torch.speclang emit` — DO NOT EDIT.

Source of truth: madsim_tpu_torch/speclang/specs/twopc.py (protocol
'twopc-gen'). Edit the spec source and re-run emit; `emit --check` fails if
this file or the digest below drifts from the source.
"""

from __future__ import annotations

from .. import hostrt as _hostrt
from ..specs import twopc as _src

SPECLANG_DIGEST = "68cdeb436045d97dd9909af7fe0f340d247ff698ab500040b3f153039f472d8e"

InvariantViolation = _hostrt.InvariantViolation


def fuzz_one_seed(seed, **kw):
    """One fuzzed host-twin execution of 'twopc-gen' (the generic
    speclang twin with this protocol bound; `device=` picks where the
    handlers run, the card unless "cpu" is asked for); raises
    InvariantViolation on an oracle failure."""
    return _hostrt.fuzz_one_seed(_src.PROTOCOL, seed, **kw)
