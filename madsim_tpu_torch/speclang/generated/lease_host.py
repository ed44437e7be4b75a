"""AUTO-GENERATED by `python -m madsim_tpu_torch.speclang emit` — DO NOT EDIT.

Source of truth: madsim_tpu_torch/speclang/specs/lease.py (protocol
'lease-gen'). Edit the spec source and re-run emit; `emit --check` fails if
this file or the digest below drifts from the source.
"""

from __future__ import annotations

from .. import hostrt as _hostrt
from ..specs import lease as _src

SPECLANG_DIGEST = "b8136713fddcdb2590a0ef5290fb0a4e5931ce41afa502e39537f0a750eed323"

InvariantViolation = _hostrt.InvariantViolation


def fuzz_one_seed(seed, **kw):
    """One fuzzed host-twin execution of 'lease-gen' (the generic
    speclang twin with this protocol bound; `device=` picks where the
    handlers run, the card unless "cpu" is asked for); raises
    InvariantViolation on an oracle failure."""
    return _hostrt.fuzz_one_seed(_src.PROTOCOL, seed, **kw)
