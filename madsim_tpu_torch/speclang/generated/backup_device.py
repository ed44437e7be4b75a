"""AUTO-GENERATED by `python -m madsim_tpu_torch.speclang emit` — DO NOT EDIT.

Source of truth: madsim_tpu_torch/speclang/specs/backup.py (protocol
'backup'). Edit the spec source and re-run emit; `emit --check` fails if
this file or the digest below drifts from the source.
"""

from __future__ import annotations

from .. import device as _device
from ..specs import backup as _src

SPECLANG_DIGEST = "374c66f1d06208d08692936b1e26d3491a8488ab00671b1f09cf760668d82bc7"

# ---- derived at defaults (documentation, not source) ----
STATE_FIELDS = ('ver', 'val', 'b_ver', 'b_val', 'served_max', 'regress', 'ack_ver', 'r_seen', 'syncs', 'serves')
NARROW_FIELDS = {'ver': 'u16', 'b_ver': 'u16', 'served_max': 'u16', 'regress': 'u8', 'ack_ver': 'u16'}
RATE_FLOORS = {
    'ver': 'Rate(floor_us=40000, ratchet=1, inc=1, margin=2)',
    'b_ver': 'Rate(floor_us=40000, ratchet=1, inc=1, margin=2)',
    'served_max': 'Rate(floor_us=40000, ratchet=1, inc=1, margin=2)',
    'ack_ver': 'Rate(floor_us=40000, ratchet=1, inc=1, margin=2)',
}
NARROW_HORIZON_US = 1310700000
TIME_FIELDS = ()
MSG_KIND_NAMES = ('REPL', 'ACK', 'READ', 'RESP')
DURABLE_FIELDS = ('ver', 'val', 'b_ver', 'b_val', 'served_max', 'regress')
SYNC_FIELD = 'syncs'


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
