"""Fault-kind vocabulary the engine's state is shaped by.

Copies of the constants in `madsim_tpu/nemesis.py` (the port imports
nothing of the JAX package): `SimState.fires` has one column per
FIRE_KINDS entry and `occ_fired` one row per OCC_CLAUSES entry, so the two
faces must agree on both tuples (tests/test_torch_prng.py asserts it).
"""

from __future__ import annotations

from typing import Dict, Tuple

FIRE_KINDS: Tuple[str, ...] = (
    "crash", "restart", "wipe", "partition", "heal", "clog", "spike",
    "loss", "dup", "reorder", "skew", "remove", "join",
    "disk_slow", "disk_crash", "disk_recover",
)
FIRE_INDEX: Dict[str, int] = {k: i for i, k in enumerate(FIRE_KINDS)}
# schedule clauses with occurrence counters
OCC_CLAUSES: Tuple[str, ...] = (
    "crash", "partition", "clog", "spike", "reconfig", "disk",
)
