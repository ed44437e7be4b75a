"""Nemesis: the fault-plan vocabulary the batched engine is driven by.

Copies of what the port needs from `madsim_tpu/nemesis.py` (the port
imports nothing of the JAX package): the fire-count and occurrence
vocabularies `SimState.fires` and `occ_fired` are shaped by, the draw
sites every schedule-level and message-level fault draw is keyed on, the
clause dataclasses with their validation, and `FaultPlan`. A plan lowers
onto the engine's `nem_*` SimConfig knobs through
`madsim_tpu_torch.tpu.nemesis.compile_plan`.

SCHEDULE-level clauses (crash, partition, clog, spike, skew, reconfig,
disk) fire at virtual times that are pure functions of (seed, clause site,
occurrence index); MESSAGE-level clauses (loss, duplication, reordering)
flip a coin per message on the step's network key. Both faces draw from the
same murmur3 chain at the same sites, so a plan gives the same trajectory
on both (tests/test_torch_nemesis.py and tests/test_torch_triage.py hold
every copy here equal to its original).

`FaultPlan.schedule` is the pure schedule itself: the murmur3 chain in
plain Python integers (`mix32` ... `coin32`), the event stream the engine
executes and `filter_schedule` shrinks. The triage vocabulary
(`TRIAGE_CLAUSES`, `RATE_CLAUSES`, `CLAUSE_OF_EVENT`) names the atoms the
shrinker (madsim_tpu_torch/triage.py) switches off per lane.

`to_net_config` belongs to the host runtime, which is not part of the
port: it raises NotImplementedError.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple, Type

# --------------------------------------------------------------------------
# murmur3 hash-chain mirror (tpu/prng.py, in plain Python ints)
# --------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_KEY0 = 0x2545F491


def mix32(x: int) -> int:
    """murmur3 fmix32, bit-equal to tpu/prng.mix."""
    x &= _M32
    x ^= x >> 16
    x = (x * 0x85EBCA6B) & _M32
    x ^= x >> 13
    x = (x * 0xC2B2AE35) & _M32
    x ^= x >> 16
    return x


def fold32(key: int, word: int) -> int:
    return mix32(key ^ ((word * _GOLDEN) & _M32))


def key_from_seed(seed: int) -> int:
    """The engine's per-lane base key (prng.key_from of the seed's low 32
    bits, the truncation BatchedSim.init applies)."""
    return fold32(_KEY0, seed & _M32)


def bits32(key: int, site: int, index: int = 0) -> int:
    """Raw u32 draw, bit-equal to prng.bits(key, site, index)."""
    return mix32(fold32(fold32(key, site), index & _M32))


def randint32(key: int, site: int, lo: int, hi: int, index: int = 0) -> int:
    """prng.randint: lo + bits % max(hi - lo, 1)."""
    span = max(hi - lo, 1)
    return lo + bits32(key, site, index) % span


def coin32(key: int, site: int, rate: float, index: int = 0) -> bool:
    """The integer schedule coin: bits % 1e6 < round(rate * 1e6)."""
    return bits32(key, site, index) % COIN_DENOM < int(round(rate * COIN_DENOM))


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

# triage vocabulary: one name per shrinkable clause atom. A lane's
# TriageCtl carries a bitmask over TRIAGE_CLAUSES (set bit = clause off in
# that lane); the OCC_CLAUSES also take per-occurrence masks (bit k =
# occurrence k's effect suppressed, its timing still advancing).
TRIAGE_CLAUSES: Tuple[str, ...] = (
    "crash", "partition", "clog", "spike", "skew", "loss", "dup",
    "reorder", "wipe", "reconfig", "disk",
)
TRIAGE_BIT: Dict[str, int] = {n: 1 << i for i, n in enumerate(TRIAGE_CLAUSES)}
# message-level clauses with per-lane rate scaling (TriageCtl.rate_scale)
RATE_CLAUSES: Tuple[str, ...] = ("loss", "dup", "reorder")
RATE_ROW: Dict[str, int] = {n: i for i, n in enumerate(RATE_CLAUSES)}
# schedule-event kind -> owning clause (restart belongs to its crash
# occurrence, heal to its split, ...)
CLAUSE_OF_EVENT: Dict[str, str] = {
    "crash": "crash", "restart": "crash",
    "split": "partition", "heal": "partition",
    "clog": "clog", "unclog": "clog",
    "spike_on": "spike", "spike_off": "spike",
    "skew": "skew",
    "remove": "reconfig", "join": "reconfig",
    "disk_slow": "disk", "disk_crash": "disk", "disk_recover": "disk",
}

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
    fresh replica."""

    interval_lo_us: int = 1_000_000
    interval_hi_us: int = 5_000_000
    down_lo_us: int = 500_000
    down_hi_us: int = 3_000_000


@dataclasses.dataclass(frozen=True)
class DiskFault:
    """Durability chaos: a slow, then dying, then recovering disk."""

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

    # -- the pure schedule (what the engine executes) --

    def schedule(
        self, seed: int, horizon_us: int, n_nodes: int,
        max_events: int = 100_000,
    ) -> List["NemesisEvent"]:
        return plan_schedule(self, seed, horizon_us, n_nodes, max_events)

    def skew_ppm(self, seed: int, n_nodes: int) -> List[int]:
        """Per-node clock-skew ppm for this (plan, seed); [0]*N if disabled."""
        skew = self.get(ClockSkew)
        if skew is None:
            return [0] * n_nodes
        key = key_from_seed(seed)
        return [
            randint32(key, NEM_SITE_SKEW, -skew.max_ppm, skew.max_ppm + 1,
                      index=n)
            for n in range(n_nodes)
        ]

    def to_net_config(self, base=None):
        raise NotImplementedError(
            "FaultPlan.to_net_config configures the host runtime's network, "
            "and the host runtime is not part of madsim_tpu_torch"
        )


@dataclasses.dataclass(frozen=True, order=True)
class NemesisEvent:
    """One schedule-level fault event. Sorted by (time, kind, node)."""

    t_us: int
    kind: str  # crash|restart|split|heal|clog|unclog|spike_on|spike_off|skew|
    #            remove|join|disk_slow|disk_crash|disk_recover
    node: int = -1  # crash victim / clog src / skew node
    dst: int = -1  # clog dst
    side_mask: int = 0  # split: bitmask of nodes on side A
    wipe: bool = False  # crash/restart: state-wipe variant
    ppm: int = 0  # skew
    extra_us: int = 0  # spike_on / disk_slow per-write latency
    k: int = -1  # clause occurrence index (the ddmin atom id; -1 = n/a)
    torn: bool = False  # disk_crash/disk_recover: torn-tail variant

    def __str__(self) -> str:
        t = self.t_us / 1e6
        if self.kind in ("crash", "restart"):
            w = " (wipe)" if self.wipe else ""
            return f"[{t:9.6f}s] {self.kind} node{self.node}{w}"
        if self.kind in ("remove", "join"):
            return f"[{t:9.6f}s] {self.kind} node{self.node} (reconfig k={self.k})"
        if self.kind == "disk_slow":
            return (
                f"[{t:9.6f}s] disk_slow node{self.node} "
                f"+{self.extra_us}us/write (disk k={self.k})"
            )
        if self.kind in ("disk_crash", "disk_recover"):
            w = " (torn)" if self.torn else ""
            return f"[{t:9.6f}s] {self.kind} node{self.node}{w} (disk k={self.k})"
        if self.kind == "split":
            return f"[{t:9.6f}s] split side_mask={self.side_mask:#x}"
        if self.kind in ("clog", "unclog"):
            return f"[{t:9.6f}s] {self.kind} link {self.node}->{self.dst}"
        if self.kind == "skew":
            return f"[{t:9.6f}s] skew node{self.node} {self.ppm:+d} ppm"
        if self.kind == "spike_on":
            return f"[{t:9.6f}s] latency spike +{self.extra_us}us"
        return f"[{t:9.6f}s] {self.kind}"


def _windows(key, horizon_us, max_events, events, sites, make):
    """Append one clause's occurrence windows: for k = 0, 1, ... the open
    time is the previous close plus draw k at the interval site, and each
    later phase adds draw k at its own site; a time at or past the horizon
    ends the clause. `sites` are (site, lo, hi) per gap; `make(k, phase,
    t)` builds phase `phase`'s event."""
    t, k = 0, 0
    while len(events) < max_events:
        for phase, (site, lo, hi) in enumerate(sites):
            t += randint32(key, site, lo, hi, index=k)
            if t >= horizon_us:
                return
            events.append(make(k, phase, t))
        k += 1


def plan_schedule(
    plan: FaultPlan, seed: int, horizon_us: int, n_nodes: int,
    max_events: int = 100_000,
) -> List[NemesisEvent]:
    """The plan's full fault-event stream for one seed, a pure function:
    the engine derives the same times, victims and sides from the same
    hash chain. Event times are absolute virtual us."""
    key = key_from_seed(seed)
    events: List[NemesisEvent] = []

    for n, ppm in enumerate(plan.skew_ppm(seed, n_nodes)):
        if ppm != 0:
            events.append(NemesisEvent(t_us=0, kind="skew", node=n, ppm=ppm))

    crash = plan.get(Crash)
    if crash is not None:
        def crash_ev(k, phase, t):
            victim = randint32(key, NEM_SITE_CRASH_VICTIM, 0, n_nodes, index=k)
            wipe = crash.wipe_rate > 0 and coin32(
                key, NEM_SITE_CRASH_WIPE, crash.wipe_rate, index=k
            )
            return NemesisEvent(t, ("crash", "restart")[phase], node=victim,
                                wipe=wipe, k=k)

        _windows(key, horizon_us, max_events, events, (
            (NEM_SITE_CRASH_IV, crash.interval_lo_us, crash.interval_hi_us),
            (NEM_SITE_CRASH_DOWN, crash.down_lo_us, crash.down_hi_us),
        ), crash_ev)

    part = plan.get(Partition)
    if part is not None:
        def part_ev(k, phase, t):
            mask = 0
            for n in range(n_nodes):
                if bits32(key, NEM_SITE_PART_SIDE, index=k * 64 + n) & 1:
                    mask |= 1 << n
            return NemesisEvent(t, ("split", "heal")[phase], side_mask=mask,
                                k=k)

        _windows(key, horizon_us, max_events, events, (
            (NEM_SITE_PART_IV, part.interval_lo_us, part.interval_hi_us),
            (NEM_SITE_PART_HEAL, part.heal_lo_us, part.heal_hi_us),
        ), part_ev)

    clog = plan.get(LinkClog)
    if clog is not None:
        def clog_ev(k, phase, t):
            src = randint32(key, NEM_SITE_CLOG_SRC, 0, n_nodes, index=k)
            d = randint32(key, NEM_SITE_CLOG_DST, 0, n_nodes - 1, index=k)
            dst = d + (1 if d >= src else 0)
            return NemesisEvent(t, ("clog", "unclog")[phase], node=src,
                                dst=dst, k=k)

        _windows(key, horizon_us, max_events, events, (
            (NEM_SITE_CLOG_IV, clog.interval_lo_us, clog.interval_hi_us),
            (NEM_SITE_CLOG_HEAL, clog.heal_lo_us, clog.heal_hi_us),
        ), clog_ev)

    reconf = plan.get(Reconfig)
    if reconf is not None:
        def reconf_ev(k, phase, t):
            victim = randint32(key, NEM_SITE_RECONF_VICTIM, 0, n_nodes, index=k)
            return NemesisEvent(t, ("remove", "join")[phase], node=victim, k=k)

        _windows(key, horizon_us, max_events, events, (
            (NEM_SITE_RECONF_IV, reconf.interval_lo_us, reconf.interval_hi_us),
            (NEM_SITE_RECONF_DUR, reconf.down_lo_us, reconf.down_hi_us),
        ), reconf_ev)

    disk = plan.get(DiskFault)
    if disk is not None:
        def disk_ev(k, phase, t):
            victim = randint32(key, NEM_SITE_DISK_VICTIM, 0, n_nodes, index=k)
            if phase == 0:
                return NemesisEvent(t, "disk_slow", node=victim,
                                    extra_us=disk.extra_us, k=k)
            torn = disk.torn_rate > 0 and coin32(
                key, NEM_SITE_DISK_TORN, disk.torn_rate, index=k
            )
            return NemesisEvent(t, ("disk_crash", "disk_recover")[phase - 1],
                                node=victim, torn=torn, k=k)

        _windows(key, horizon_us, max_events, events, (
            (NEM_SITE_DISK_IV, disk.interval_lo_us, disk.interval_hi_us),
            (NEM_SITE_DISK_SLOW, disk.slow_lo_us, disk.slow_hi_us),
            (NEM_SITE_DISK_DOWN, disk.down_lo_us, disk.down_hi_us),
        ), disk_ev)

    spike = plan.get(LatencySpike)
    if spike is not None:
        def spike_ev(k, phase, t):
            if phase == 0:
                return NemesisEvent(t, "spike_on", extra_us=spike.extra_us, k=k)
            return NemesisEvent(t, "spike_off", k=k)

        _windows(key, horizon_us, max_events, events, (
            (NEM_SITE_SPIKE_IV, spike.interval_lo_us, spike.interval_hi_us),
            (NEM_SITE_SPIKE_DUR, spike.duration_lo_us, spike.duration_hi_us),
        ), spike_ev)

    events.sort()
    return events


def filter_schedule(
    events: Sequence[NemesisEvent],
    occ_off: Optional[Dict[str, int]] = None,
    drop_clauses: Sequence[str] = (),
) -> List[NemesisEvent]:
    """A shrunk schedule: drop whole clauses and/or masked occurrences
    (`occ_off` maps a schedule clause to an occurrence bitmask; bit k
    removes every phase of occurrence k). The pure-schedule face of the
    engine's per-lane TriageCtl."""
    occ_off = occ_off or {}
    drop = set(drop_clauses)
    out: List[NemesisEvent] = []
    for ev in events:
        clause = CLAUSE_OF_EVENT.get(ev.kind)
        if clause in drop:
            continue
        if ev.k >= 0 and (occ_off.get(clause, 0) >> ev.k) & 1:
            continue
        out.append(ev)
    return out
