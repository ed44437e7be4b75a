"""Layout-independent trajectory digest, and the pinned reference runs.

`canonical_digest` is the repo's golden-digest function
(`tests/test_state_layout.py:canonical_digest`) over `convert.state_to_numpy`
output: every field widened to int64, packed planes unpacked, so equal
values give equal digests whatever the storage. `PINNED` holds the digests
of two reference runs (64 lanes, seeds 0..63), computed from the JAX engine
on the CPU and asserted against it by tests/test_torch_engine.py; any device
running the port must reproduce them.

`GOLDEN` holds the JAX package's own correctness anchor, copied verbatim
from `tests/test_state_layout.py`: one 16-lane, 1500-step run per workload
under `CHAOS_PLAN` (crash, partition and message-loss clauses lowered by
`compile_plan`). `golden_run(name)` builds the same run for the port.
"""

from __future__ import annotations

import hashlib
from typing import Dict

import numpy as np

from .. import nemesis
from ..nemesis import FIRE_KINDS
from .chain import make_chain_spec
from .kv import make_kv_spec
from .nemesis import compile_plan
from .paxos import make_paxos_spec
from .raft import make_raft_spec, raft_bench_config
from .spec import SimConfig
from .twopc import make_twopc_spec

# the FIRE_KINDS prefix width the golden digests were blessed at: later
# columns enter the digest, named by kind, only where nonzero
R8_FIRE_WIDTH = 11


def _unpack(words: np.ndarray, k: int) -> np.ndarray:
    b = (words[..., :, None] >> np.arange(32, dtype=np.int64)) & 1
    return b.reshape(words.shape[:-1] + (words.shape[-1] * 32,))[..., :k] != 0


def canonical_digest(leaves: Dict[str, np.ndarray]) -> str:
    """sha256 over a state's values (dotted-path numpy leaves)."""
    h = hashlib.sha256()
    n = leaves["timer"].shape[1]
    view = dict(leaves)
    view["alive"] = _unpack(leaves["alive_p"], n)
    view["link_ok"] = _unpack(leaves["link_ok_p"], n)
    for name in ("clock", "epoch", "key", "done", "violated",
                 "violation_step", "steps", "events", "overflow",
                 "dead_drops", "crashed", "partitioned", "timer",
                 "alive", "link_ok"):
        h.update(np.ascontiguousarray(view[name].astype(np.int64)))
    for k, leaf in leaves.items():
        if k.startswith("node."):
            h.update(np.ascontiguousarray(leaf.astype(np.int64)))
    ck = leaves["msgs.deliver"].shape[-1]
    for part in (_unpack(leaves["msgs.valid_p"], ck), leaves["msgs.deliver"],
                 leaves["msgs.kind"], leaves["msgs.payload"]):
        h.update(np.ascontiguousarray(part.astype(np.int64)))
    fires = leaves["fires"].astype(np.int64)
    h.update(np.ascontiguousarray(fires[:, :R8_FIRE_WIDTH]))
    for i in range(R8_FIRE_WIDTH, fires.shape[1]):
        if fires[:, i].any():
            h.update(FIRE_KINDS[i].encode())
            h.update(np.ascontiguousarray(fires[:, i]))
    return h.hexdigest()


# name -> (spec kwargs, config, lanes, max_steps): the headline sweep's
# config, and the repo's single-step entry config run to its horizon
PINNED_RUNS = {
    "raft_bench": (
        dict(n_nodes=5, client_rate=0.1, log_capacity=16),
        raft_bench_config(10.0), 64, 8000,
    ),
    "raft_entry": (
        dict(n_nodes=5),
        SimConfig(
            horizon_us=5_000_000, loss_rate=0.1,
            crash_interval_lo_us=500_000, crash_interval_hi_us=3_000_000,
        ),
        64, 8000,
    ),
}

PINNED: Dict[str, str] = {
    "raft_bench": "1c1edc0a55e25e79ac89764a35682a363c31b33b5c5ff52b4dc38daf1e140300",
    "raft_entry": "c7dfcc2c9c2604f7d20bcc7a8a1ab0e10fa87c95b23d9d8dff5f11607a3b36ff",
}


def pinned_run(name: str):
    """(spec, config, seeds, max_steps) of one pinned reference run."""
    kw, cfg, lanes, max_steps = PINNED_RUNS[name]
    return make_raft_spec(**kw), cfg, list(range(lanes)), max_steps


# the golden runs' fault plan (tests/test_state_layout.py:CHAOS_PLAN)
CHAOS_PLAN = nemesis.FaultPlan(
    name="layout",
    clauses=(
        nemesis.Crash(interval_lo_us=300_000, interval_hi_us=900_000,
                      down_lo_us=200_000, down_hi_us=600_000),
        nemesis.Partition(interval_lo_us=400_000, interval_hi_us=1_200_000,
                          heal_lo_us=300_000, heal_hi_us=900_000),
        nemesis.MsgLoss(rate=0.05),
    ),
)
GOLDEN_LANES = 16
GOLDEN_STEPS = 1500
GOLDEN_SPECS = {
    "raft": make_raft_spec,
    "paxos": make_paxos_spec,
    "kv": make_kv_spec,
    "twopc": make_twopc_spec,
    "chain": make_chain_spec,
}
GOLDEN: Dict[str, str] = {
    "raft": "2a0e81ea9e273a54298b0bc11e44f377ef8861607ad320278695700bf0df861b",
    "paxos": "b32a304d0682bcc183b4b3d1382816bb6187c74d8f145d082e0198dec44efa8b",
    "kv": "2249bd64d3fd1aac94376125169167e7ae6f35fea51dfa06c0db38453ba58c9c",
    "twopc": "38b8eae7cd3944363dcac58cda088791727370d2892a28c8b978ab80c57a1666",
    "chain": "c6e860898bca578503460a96d3fdd9d9a21b7ea7b17313c0e4fd10ab785d1f86",
}


def golden_run(name: str):
    """(spec, config, seeds, max_steps) of one workload's golden run: the
    spec factory's defaults under CHAOS_PLAN compiled onto a 30-virtual-
    second config, seeds 0..15, 1500 steps (every lane still live at the
    end, so the run is exactly 1500 steps)."""
    cfg = compile_plan(CHAOS_PLAN, SimConfig(horizon_us=30_000_000))
    return (GOLDEN_SPECS[name](), cfg, list(range(GOLDEN_LANES)),
            GOLDEN_STEPS)
