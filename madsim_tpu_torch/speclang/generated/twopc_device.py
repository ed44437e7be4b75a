"""AUTO-GENERATED by `python -m madsim_tpu_torch.speclang emit` — DO NOT EDIT.

Source of truth: madsim_tpu_torch/speclang/specs/twopc.py (protocol
'twopc-gen'). Edit the spec source and re-run emit; `emit --check` fails if
this file or the digest below drifts from the source.
"""

from __future__ import annotations

from .. import device as _device
from ..specs import twopc as _src

SPECLANG_DIGEST = "68cdeb436045d97dd9909af7fe0f340d247ff698ab500040b3f153039f472d8e"

# ---- derived at defaults (documentation, not source) ----
STATE_FIELDS = ('tid_cur', 'vote_mask', 'o_tid', 'o_val', 'v_tid', 'v_val', 'decided')
NARROW_FIELDS = {'tid_cur': 'i16', 'vote_mask': 'u8', 'o_tid': 'i16', 'o_val': 'u8', 'v_tid': 'i16', 'v_val': 'u8'}
RATE_FLOORS = {
    'tid_cur': 'Rate(floor_us=1000, ratchet=1, inc=1, margin=1)',
    'o_tid': 'Rate(floor_us=1000, ratchet=1, inc=1, margin=1)',
    'v_tid': 'Rate(floor_us=1000, ratchet=1, inc=1, margin=1)',
}
NARROW_HORIZON_US = 32767000
TIME_FIELDS = ()
MSG_KIND_NAMES = ('PREPARE', 'VOTE', 'OUTCOME', 'DREQ')
DURABLE_FIELDS = ()
SYNC_FIELD = None


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


def spec_knobs(virtual_secs: float = 10.0) -> tuple:
    """The tune SpecKnob rows of the spec source's KnobDecl declarations
    (the registry's `knobs_attr` hook)."""
    return _device.knob_rows(_src.PROTOCOL, virtual_secs)
