"""Speclang spec sources, the single-source protocol definitions.

Each module here declares exactly one `PROTOCOL` (a `speclang.lang.
Protocol`): typed fields with bounds and durability, the message
vocabulary, knobs, the handler bodies over [L, N] axes, and the workload
chaos recipe. The generated device face compiles from these files and
NOTHING else; edit a spec source, re-run `python -m
madsim_tpu_torch.speclang emit`, and `emit --check` passes again.

  twopc.py   the hand 2PC spec re-derived (golden-digest-identical)
  lease.py   the hand lease/watch spec re-derived (leaf-identical)
  backup.py  primary-backup log shipping, the first speclang-native
             protocol, with the planted stale-read regression bug
"""

from __future__ import annotations

from . import backup, lease, twopc  # noqa: F401

# emit CLI enumeration: spec-source module name -> Protocol
PROTOCOLS = {
    "twopc": twopc.PROTOCOL,
    "lease": lease.PROTOCOL,
    "backup": backup.PROTOCOL,
}
