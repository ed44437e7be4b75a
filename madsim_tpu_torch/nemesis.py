"""Nemesis: the fault-plan vocabulary the batched engine is driven by.

Copies of what the port needs from `madsim_tpu/nemesis.py` (the port
imports nothing of the JAX package): the fire-count and occurrence
vocabularies `SimState.fires` and `occ_fired` are shaped by, the draw
sites every schedule-level and message-level fault draw is keyed on, the
clause dataclasses with their validation, and `FaultPlan`. A plan lowers
onto the engine's `nem_*` SimConfig knobs through
`madsim_tpu_torch.tpu.nemesis.compile_plan`.

SCHEDULE-level clauses (crash, partition, clog, spike, skew) fire at
virtual times that are pure functions of (seed, clause site, occurrence
index); MESSAGE-level clauses (loss, duplication, reordering) flip a coin
per message on the step's network key. Both faces draw from the same
murmur3 chain at the same sites, so a plan gives the same trajectory on
both (tests/test_torch_nemesis.py holds every copy here equal to its
original).

The host-runtime faces of a plan (`schedule`, `skew_ppm`,
`to_net_config`) are not ported: they raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple, Type

# --------------------------------------------------------------------------
# fire-count and occurrence vocabulary
# --------------------------------------------------------------------------

FIRE_KINDS: Tuple[str, ...] = (
    "crash", "restart", "wipe", "partition", "heal", "clog", "spike",
    "loss", "dup", "reorder", "skew", "remove", "join",
    "disk_slow", "disk_crash", "disk_recover",
)
FIRE_INDEX: Dict[str, int] = {k: i for i, k in enumerate(FIRE_KINDS)}
# schedule clauses with occurrence counters (rows of SimState.occ_fired)
OCC_CLAUSES: Tuple[str, ...] = (
    "crash", "partition", "clog", "spike", "reconfig", "disk",
)
OCC_ROW: Dict[str, int] = {n: i for i, n in enumerate(OCC_CLAUSES)}

# Schedule-level probability coins use an integer threshold
# (bits % 1e6 < round(rate * 1e6)) rather than a float32 uniform.
COIN_DENOM = 1_000_000

# --------------------------------------------------------------------------
# draw sites (a site is a namespace of the murmur3 chain; keep unique)
# --------------------------------------------------------------------------

NEM_SITE_CRASH_IV = 201      # up-interval before crash event k
NEM_SITE_CRASH_DOWN = 202    # down duration of crash event k
NEM_SITE_CRASH_VICTIM = 203  # victim node of crash event k
NEM_SITE_CRASH_WIPE = 204    # wipe coin of crash event k
NEM_SITE_PART_IV = 211       # healthy interval before split k
NEM_SITE_PART_HEAL = 212     # partition duration of split k
NEM_SITE_PART_SIDE = 213     # per-node side bit; index = k * 64 + node
NEM_SITE_CLOG_IV = 221
NEM_SITE_CLOG_HEAL = 222
NEM_SITE_CLOG_SRC = 223
NEM_SITE_CLOG_DST = 224      # drawn in [0, N-1), shifted past src
NEM_SITE_SPIKE_IV = 231
NEM_SITE_SPIKE_DUR = 232
NEM_SITE_SKEW = 241          # per-node skew ppm; index = node
NEM_SITE_RECONF_IV = 251     # stable interval before remove event k
NEM_SITE_RECONF_DUR = 252    # out-of-membership duration of reconfig k
NEM_SITE_RECONF_VICTIM = 253 # removed node of reconfig event k
NEM_SITE_DISK_IV = 261       # healthy interval before disk episode k
NEM_SITE_DISK_SLOW = 262     # degraded (slow-disk) window length of episode k
NEM_SITE_DISK_DOWN = 263     # post-crash down duration of episode k
NEM_SITE_DISK_VICTIM = 264   # victim node of disk episode k
NEM_SITE_DISK_TORN = 265     # torn-tail coin of disk episode k

# per-message coin sites, drawn on the step's network key
NET_SITE_DUP = 5
NET_SITE_REORDER = 6
NET_SITE_REORDER_EXTRA = 7
NET_SITE_NEM_LOSS = 8
NET_SITE_DISK_EXTENT = 9

# --------------------------------------------------------------------------
# clauses
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Crash:
    """Crash/restart cycles: a random node goes down for a random duration.
    `wipe_rate` upgrades a fraction of crashes to crash-with-state-wipe
    (the node restarts from `init` state instead of `on_restart`)."""

    interval_lo_us: int = 1_000_000
    interval_hi_us: int = 5_000_000
    down_lo_us: int = 500_000
    down_hi_us: int = 3_000_000
    wipe_rate: float = 0.0


@dataclasses.dataclass(frozen=True)
class Partition:
    """Random bipartitions: links crossing the cut go down both ways."""

    interval_lo_us: int = 1_000_000
    interval_hi_us: int = 5_000_000
    heal_lo_us: int = 500_000
    heal_hi_us: int = 3_000_000


@dataclasses.dataclass(frozen=True)
class LinkClog:
    """Asymmetric single-link clog: src->dst drops, dst->src still flows."""

    interval_lo_us: int = 1_000_000
    interval_hi_us: int = 5_000_000
    heal_lo_us: int = 500_000
    heal_hi_us: int = 3_000_000


@dataclasses.dataclass(frozen=True)
class LatencySpike:
    """Windows during which every message pays `extra_us` more latency."""

    interval_lo_us: int = 1_000_000
    interval_hi_us: int = 5_000_000
    duration_lo_us: int = 200_000
    duration_hi_us: int = 1_000_000
    extra_us: int = 100_000


@dataclasses.dataclass(frozen=True)
class MsgLoss:
    """Per-message loss on top of the base network loss rate."""

    rate: float = 0.05


@dataclasses.dataclass(frozen=True)
class Duplicate:
    """Per-message duplication: the copy takes an independent latency roll
    (and may itself be lost)."""

    rate: float = 0.05


@dataclasses.dataclass(frozen=True)
class Reorder:
    """Bounded reordering: a fraction of messages pay an extra uniform
    delay in [0, window_us]."""

    rate: float = 0.1
    window_us: int = 50_000


@dataclasses.dataclass(frozen=True)
class ClockSkew:
    """Per-node clock rate skew: node n's relative timer delays are scaled
    by 1 + ppm(n) * 1e-6, ppm(n) drawn once per (seed, node) from
    [-max_ppm, +max_ppm]."""

    max_ppm: int = 50_000


@dataclasses.dataclass(frozen=True)
class Reconfig:
    """Dynamic membership: remove a random node, later re-join it as a
    fresh replica. (Carried by the plan; the engine refuses it until
    ROADMAP queue 1 item 8.)"""

    interval_lo_us: int = 1_000_000
    interval_hi_us: int = 5_000_000
    down_lo_us: int = 500_000
    down_hi_us: int = 3_000_000


@dataclasses.dataclass(frozen=True)
class DiskFault:
    """Durability chaos: a slow, then dying, then recovering disk. (Carried
    by the plan; the engine refuses it until ROADMAP queue 1 item 8.)"""

    interval_lo_us: int = 1_000_000
    interval_hi_us: int = 5_000_000
    slow_lo_us: int = 100_000
    slow_hi_us: int = 500_000
    down_lo_us: int = 500_000
    down_hi_us: int = 3_000_000
    torn_rate: float = 0.0
    extra_us: int = 50_000


Clause = Any  # one of the dataclasses above

_CLAUSE_TYPES: Tuple[type, ...] = (
    Crash, Partition, LinkClog, LatencySpike, MsgLoss, Duplicate, Reorder,
    ClockSkew, Reconfig, DiskFault,
)


def _check_interval(name: str, lo: int, hi: int) -> None:
    if lo < 0 or hi < lo:
        raise ValueError(f"{name}: interval [{lo}, {hi}] must satisfy 0 <= lo <= hi")
    if hi == 0:
        raise ValueError(f"{name}: interval hi must be > 0 (clause would never fire)")


def _check_rate(name: str, rate: float) -> None:
    if not (0.0 <= rate < 1.0):
        raise ValueError(f"{name} must be in [0, 1), got {rate}")


def _host_face(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"FaultPlan.{what} is a host-runtime face and is not ported to "
        "madsim_tpu_torch yet (ROADMAP.md queue 1, item 9)"
    )


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A named, validated composition of fault clauses, one instance per
    clause type. Lower it onto the engine with
    `madsim_tpu_torch.tpu.nemesis.compile_plan(plan, base_config)`."""

    clauses: Tuple[Clause, ...] = ()
    name: str = "nemesis"

    def __post_init__(self) -> None:
        seen: set = set()
        for c in self.clauses:
            if not isinstance(c, _CLAUSE_TYPES):
                raise TypeError(f"unknown fault clause: {c!r}")
            if type(c) in seen:
                raise ValueError(
                    f"duplicate {type(c).__name__} clause — one instance per kind"
                )
            seen.add(type(c))
        for c in self.clauses:
            n = type(c).__name__
            if isinstance(c, Crash):
                _check_interval(f"{n}.interval", c.interval_lo_us, c.interval_hi_us)
                _check_interval(f"{n}.down", c.down_lo_us, c.down_hi_us)
                _check_rate(f"{n}.wipe_rate", c.wipe_rate)
            elif isinstance(c, (Partition, LinkClog)):
                _check_interval(f"{n}.interval", c.interval_lo_us, c.interval_hi_us)
                _check_interval(f"{n}.heal", c.heal_lo_us, c.heal_hi_us)
            elif isinstance(c, Reconfig):
                _check_interval(f"{n}.interval", c.interval_lo_us, c.interval_hi_us)
                _check_interval(f"{n}.down", c.down_lo_us, c.down_hi_us)
            elif isinstance(c, DiskFault):
                _check_interval(f"{n}.interval", c.interval_lo_us, c.interval_hi_us)
                _check_interval(f"{n}.slow", c.slow_lo_us, c.slow_hi_us)
                _check_interval(f"{n}.down", c.down_lo_us, c.down_hi_us)
                _check_rate(f"{n}.torn_rate", c.torn_rate)
                if c.extra_us < 0:
                    raise ValueError(f"{n}.extra_us must be >= 0, got {c.extra_us}")
            elif isinstance(c, LatencySpike):
                _check_interval(f"{n}.interval", c.interval_lo_us, c.interval_hi_us)
                _check_interval(f"{n}.duration", c.duration_lo_us, c.duration_hi_us)
                if c.extra_us <= 0:
                    raise ValueError(f"{n}.extra_us must be > 0, got {c.extra_us}")
            elif isinstance(c, (MsgLoss, Duplicate, Reorder)):
                _check_rate(f"{n}.rate", c.rate)
                if isinstance(c, Reorder) and c.window_us <= 0:
                    raise ValueError(
                        f"{n}.window_us must be > 0, got {c.window_us}"
                    )
            elif isinstance(c, ClockSkew):
                if not (0 < c.max_ppm < 1_000_000):
                    raise ValueError(
                        f"{n}.max_ppm must be in (0, 1e6) (the timer rate "
                        f"1 + ppm*1e-6 must stay positive), got {c.max_ppm}"
                    )

    def get(self, cls: Type[Clause]) -> Optional[Clause]:
        for c in self.clauses:
            if isinstance(c, cls):
                return c
        return None

    @property
    def enabled_kinds(self) -> Tuple[str, ...]:
        """The FIRE_KINDS this plan can produce (for coverage reporting)."""
        kinds: List[str] = []
        if self.get(Crash) is not None:
            kinds += ["crash", "restart"]
            if self.get(Crash).wipe_rate > 0:
                kinds.append("wipe")
        if self.get(Partition) is not None:
            kinds += ["partition", "heal"]
        if self.get(LinkClog) is not None:
            kinds.append("clog")
        if self.get(LatencySpike) is not None:
            kinds.append("spike")
        if self.get(MsgLoss) is not None:
            kinds.append("loss")
        if self.get(Duplicate) is not None:
            kinds.append("dup")
        if self.get(Reorder) is not None:
            kinds.append("reorder")
        if self.get(ClockSkew) is not None:
            kinds.append("skew")
        if self.get(Reconfig) is not None:
            kinds += ["remove", "join"]
        if self.get(DiskFault) is not None:
            kinds += ["disk_slow", "disk_crash", "disk_recover"]
        return tuple(kinds)

    def schedule(self, seed: int, horizon_us: int, n_nodes: int,
                 max_events: int = 100_000):
        raise _host_face("schedule")

    def skew_ppm(self, seed: int, n_nodes: int):
        raise _host_face("skew_ppm")

    def to_net_config(self, base=None):
        raise _host_face("to_net_config")
