"""AUTO-GENERATED by `python -m madsim_tpu_torch.speclang emit` — DO NOT EDIT.

Source of truth: madsim_tpu_torch/speclang/specs/lease.py (protocol
'lease-gen'). Edit the spec source and re-run emit; `emit --check` fails if
this file or the digest below drifts from the source.
"""

from __future__ import annotations

from .. import device as _device
from ..specs import lease as _src

SPECLANG_DIGEST = "b8136713fddcdb2590a0ef5290fb0a4e5931ce41afa502e39537f0a750eed323"

# ---- derived at defaults (documentation, not source) ----
STATE_FIELDS = ('inc', 'held', 'my_token', 'my_expiry', 'pend', 'req_t', 'ka_t', 'wseen', 'l_holder', 'l_inc', 'l_token', 'l_expiry')
NARROW_FIELDS = {'held': 'u8', 'my_token': 'u16', 'pend': 'u8', 'wseen': 'u16', 'l_token': 'u16'}
RATE_FLOORS = {
    'my_token': 'Rate(floor_us=25000, ratchet=10, inc=1, margin=2)',
    'wseen': 'Rate(floor_us=25000, ratchet=10, inc=1, margin=2)',
    'l_token': 'Rate(floor_us=25000, ratchet=10, inc=1, margin=2)',
}
NARROW_HORIZON_US = 81918750
TIME_FIELDS = ('my_expiry', 'req_t', 'ka_t', 'l_expiry')
MSG_KIND_NAMES = ('ACQUIRE', 'GRANT', 'KA', 'KACK', 'RELEASE', 'NOTIFY')
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
