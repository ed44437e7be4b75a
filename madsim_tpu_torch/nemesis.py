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

The host face: `FaultPlan.to_net_config` sets the host network's
message-level knobs, `ScheduleCoins` draws the host's loss/dup/reorder coins
from the same chain at the same sites, and `NemesisDriver` replays a plan's
schedule on the host runtime (`madsim_tpu_torch.core`), consuming
`plan_schedule` / `filter_schedule` above. The differential oracle
(`madsim_tpu_torch/oracle.py`) holds the applied stream and every logged
draw against the pure recomputation.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Type

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


def mutation_vocab(config) -> Tuple[List[str], List[str], List[str]]:
    """(sched, rate, togglable): the explorer's mutation vocabulary for a
    compiled SimConfig (read through getattr, so this module never imports
    the engine): the schedule clauses whose occurrences a mutant can
    switch off, the message clauses whose rates it can scale, and every
    clause it can toggle whole."""
    cfg = config
    sched = [n for n in OCC_CLAUSES if getattr(cfg, f"nem_{n}_enabled")]
    rate = [
        n for n, on in (
            ("loss", cfg.nem_loss_rate > 0),
            ("dup", cfg.nem_dup_enabled),
            ("reorder", cfg.nem_reorder_rate > 0),
        ) if on
    ]
    togglable = list(sched) + list(rate)
    if cfg.nem_skew_enabled:
        togglable.append("skew")
    if cfg.nem_crash_enabled and cfg.nem_crash_wipe_rate > 0:
        togglable.append("wipe")
    # legacy trajectory-coupled chaos: clause-level toggles only
    if cfg.chaos_enabled and "crash" not in togglable:
        togglable.append("crash")
    if cfg.partition_enabled and "partition" not in togglable:
        togglable.append("partition")
    return sched, rate, togglable

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

# the explorer's meta-rng sites (madsim_tpu_torch/explore.py): MetaRng draw
# i of meta-seed s is bits32(key_from_seed(s), META_SITE_DRAW, i), the same
# chain every nemesis draw uses, so the search is a pure function of s
META_SITE_DRAW = 301    # MetaRng draws
META_SITE_ISLAND = 302  # federation island-seed derivation

# genome-hash chain roots (explorer dedup): the 64-bit genome hash is two
# independent fold32 chains over the genome words, seeded from these
GENOME_H1 = 0x9E2AB744
GENOME_H2 = 0x3C6EF372

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
        """The host NetConfig with this plan's message-level knobs applied."""
        from .core.config import NetConfig

        net = dataclasses.replace(base) if base is not None else NetConfig()
        loss = self.get(MsgLoss)
        dup = self.get(Duplicate)
        ro = self.get(Reorder)
        if loss is not None:
            net.packet_extra_loss_rate = loss.rate
        if dup is not None:
            net.packet_duplicate_rate = dup.rate
        if ro is not None:
            net.packet_reorder_rate = ro.rate
            net.packet_reorder_window = ro.window_us / 1e6
        return net


# message-level clauses: per-message coins. Streams are per-backend but
# every host draw VALUE is schedule-matched (pure in (seed, site, index)
# via ScheduleCoins). Keys are RATE_CLAUSES rows / `nem_<name>_rate`.
MESSAGE_CLAUSES: Dict[str, type] = {
    "loss": MsgLoss, "dup": Duplicate, "reorder": Reorder,
}
# message clause -> the ScheduleCoins methods the host net layer calls
# for it (the fourth face's input contract: the oracle comparator
# iterates THIS table to verify every logged draw).
HOST_COIN_METHODS: Dict[str, Tuple[str, ...]] = {
    "loss": ("loss",),
    "dup": ("dup",),
    "reorder": ("reorder", "reorder_extra"),
    # schedule clause with a HOST-consumed draw: the torn-tail byte
    # extent FsSim applies at a torn disk_crash (the device abstracts
    # the extent behind the schedule's torn coin, so this is the one
    # draw only the host stream contains — still seed-pure, still
    # oracle-verified)
    "disk": ("disk_torn_extent",),
}
# ScheduleCoins method -> murmur3 draw site (shared with tpu/engine.py)
COIN_SITE: Dict[str, int] = {
    "loss": NET_SITE_NEM_LOSS,
    "dup": NET_SITE_DUP,
    "reorder": NET_SITE_REORDER,
    "reorder_extra": NET_SITE_REORDER_EXTRA,
    "disk_torn_extent": NET_SITE_DISK_EXTENT,
}


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


# --------------------------------------------------------------------------
# schedule-matched message coins (the host half of the fourth face)
# --------------------------------------------------------------------------

# bound on the retained draw log: a long soak must not grow host memory
# without bound; overflow is counted, never silent (the oracle verifies
# the retained prefix and reports the drop count)
MAX_COIN_DRAWS = 200_000

# test-only divergence plant (the oracle's never-vacuously-green lever):
# set MADSIM_TPU_ORACLE_PLANT=reorder_window_off_by_one to skew the
# host's reorder-window draw span by one — a deliberate host/device
# semantic divergence the differential oracle must catch.
PLANT_ENV = "MADSIM_TPU_ORACLE_PLANT"
PLANT_REORDER_OFF_BY_ONE = "reorder_window_off_by_one"


class ScheduleCoins:
    """Host message-level draws as pure functions of (seed, site, index).

    The device engine rolls loss/dup/reorder per candidate message from
    its hash chain; the host historically rolled them from the ambient
    `GlobalRng`, which made the two backends comparable only in *rate*.
    This provider replaces the host's ambient rolls with the same murmur3
    chain (`coin32`/`randint32` on `key_from_seed(seed)`) at the shared
    `NET_SITE_*` sites, one monotone draw index per site — so every draw
    the host applies is recomputable from the seed alone, and the
    differential oracle (`madsim_tpu_torch/oracle.py`) verifies the applied
    stream draw-for-draw. WHICH indices get consumed still depends on
    traffic (streams are per-backend by design); what each draw is worth
    does not.

    Installed by `NemesisDriver.install()` onto the live `NetConfig`
    (`cfg.coins`); `NetSim.send` / `Network.test_link` consult it and
    fall back to the GlobalRng when absent (plans without a driver).
    Each draw is logged as `(site, index, value, t_ns, eid_hint)` —
    virtual time and the most recent host-lineage event id at draw time
    — which is what lets a divergence report anchor the first divergent
    draw to a delivery in the lineage DAG."""

    def __init__(self, seed: int, plant: Optional[str] = None) -> None:
        import os

        self.seed = seed
        self.key = key_from_seed(seed)
        self.plant = (
            os.environ.get(PLANT_ENV, "") if plant is None else plant
        )
        self._index: Dict[int, int] = {}
        self.draws: List[Tuple[int, int, int, int, int]] = []
        # (site, index) -> draw modulus, for draws whose span is HOST
        # state rather than clause config (disk_torn_extent's unsynced
        # tail length): the oracle needs the span to recompute the value
        self.spans: Dict[Tuple[int, int], int] = {}
        self.dropped = 0
        self._time = None
        self._lineage = None

    def bind(self, time=None, lineage=None) -> "ScheduleCoins":
        """Attach clock + lineage so draws carry (t_ns, eid) anchors."""
        self._time = time
        self._lineage = lineage
        return self

    def _next_index(self, site: int) -> int:
        idx = self._index.get(site, 0)
        self._index[site] = idx + 1
        return idx

    def _log(self, site: int, index: int, value: int) -> None:
        if len(self.draws) >= MAX_COIN_DRAWS:
            self.dropped += 1
            return
        t_ns = self._time.now_ns() if self._time is not None else -1
        eid = (
            self._lineage.next_eid - 1
            if self._lineage is not None and self._lineage.enabled
            else -1
        )
        self.draws.append((site, index, value, t_ns, eid))

    def _coin(self, site: int, rate: float) -> bool:
        idx = self._next_index(site)
        hit = coin32(self.key, site, rate, index=idx)
        self._log(site, idx, int(hit))
        return hit

    # -- clause-named draw methods (HOST_COIN_METHODS is the contract) --

    def loss(self, rate: float) -> bool:
        """MsgLoss extra-loss coin (NET_SITE_NEM_LOSS)."""
        return self._coin(NET_SITE_NEM_LOSS, rate)

    def dup(self, rate: float) -> bool:
        """Duplicate coin (NET_SITE_DUP)."""
        return self._coin(NET_SITE_DUP, rate)

    def reorder(self, rate: float) -> bool:
        """Reorder coin (NET_SITE_REORDER)."""
        return self._coin(NET_SITE_REORDER, rate)

    def reorder_extra(self, span_ns: int) -> int:
        """Extra reorder delay in [0, span_ns) ns (NET_SITE_REORDER_EXTRA)."""
        idx = self._next_index(NET_SITE_REORDER_EXTRA)
        span = max(int(span_ns), 1)
        if self.plant == PLANT_REORDER_OFF_BY_ONE:
            # deliberate off-by-one in the host's reorder window: the
            # draw modulus shifts by one, so the applied value diverges
            # from the pure recomputation at the true span — the planted
            # semantic skew the oracle self-test must catch
            span += 1
        v = randint32(self.key, NET_SITE_REORDER_EXTRA, 0, span, index=idx)
        self._log(NET_SITE_REORDER_EXTRA, idx, v)
        return v

    def disk_torn_extent(self, unsynced_len: int) -> int:
        """Torn-tail retained bytes in [0, unsynced_len) (NET_SITE_DISK_EXTENT).

        Consumed by `FsSim.power_fail_node` at a torn `disk_crash`: the
        crash keeps this many bytes of the victim's last unsynced write
        on top of the synced snapshot — a PROPER prefix, because a torn
        write that survived whole would have been a completed one."""
        idx = self._next_index(NET_SITE_DISK_EXTENT)
        span = max(int(unsynced_len), 1)
        v = randint32(self.key, NET_SITE_DISK_EXTENT, 0, span, index=idx)
        self.spans[(NET_SITE_DISK_EXTENT, idx)] = span
        self._log(NET_SITE_DISK_EXTENT, idx, v)
        return v


# --------------------------------------------------------------------------
# host driver
# --------------------------------------------------------------------------


class NemesisDriver:
    """Replays a plan's schedule on the host runtime (the Jepsen nemesis).

    Schedule-level clauses apply through `Handle` (kill/restart) and
    `NetSim` (partition / clog_link / latency-spike windows); message-level
    clauses are pushed into `NetConfig` together with a `ScheduleCoins`
    provider so `NetSim.send` / `Network.test_link` draw them from the
    same murmur3 chain as the device — every applied coin is a pure
    function of (seed, site, index), logged on `self.coins.draws` for
    the differential oracle. Applied events are recorded in
    `self.applied` (the host half of a twin comparison) and counted in
    `self.fired` per FIRE_KINDS.

        rt = ms.Runtime(seed=7)
        ...create nodes...
        driver = nemesis.NemesisDriver(
            plan, handle, node_ids=[n.id for n in nodes],
            horizon_us=10_000_000,
        )
        driver.install()          # spawns the driver task
        rt.block_on(workload())
        driver.fired              # {"crash": 3, "partition": 2, ...}

    `on_wipe(protocol_node_index)` runs before a wiped node's restart so
    the workload can discard that node's durable state (the host runtime
    keeps durability at the application level)."""

    def __init__(
        self,
        plan: FaultPlan,
        handle,
        node_ids: Sequence[int],
        horizon_us: int,
        seed: Optional[int] = None,
        on_wipe: Optional[Callable[[int], None]] = None,
        occ_off: Optional[Dict[str, int]] = None,
        on_crash: Optional[Callable[[int], None]] = None,
    ) -> None:
        self.plan = plan
        self.handle = handle
        self.node_ids = list(node_ids)
        self.on_wipe = on_wipe
        # on_crash(protocol_node_index) runs before the kill, letting a
        # workload mark the victim dead for its invariant monitors (the
        # restart side needs no hook: nodes built with `.init(...)`
        # respawn through their init closure)
        self.on_crash = on_crash
        self.seed = handle.seed if seed is None else seed
        self.occ_off = dict(occ_off or {})
        # occ_off replays a SHRUNK plan (triage.py repro bundles): masked
        # occurrences are skipped while the survivors keep their original
        # times — the schedule stays a pure function of the seed
        self.schedule = filter_schedule(
            plan.schedule(self.seed, horizon_us, len(self.node_ids)),
            self.occ_off,
        )
        self.applied: List[NemesisEvent] = []
        # schedule-matched message coins (installed onto the net config
        # when the plan has message clauses; always present so twin
        # tests can assert an empty draw log on schedule-only plans)
        self.coins = ScheduleCoins(self.seed)
        self.fired: Dict[str, int] = {}
        # clause -> occurrence bitmask: bit k set when the OPEN half of
        # window k applied (the host face of the engine's per-lane
        # `occ_fired`; `NemesisEvent.k` is the shared occurrence index, and
        # k >= 31 folds into bit 31 exactly like the device tensor)
        self.occ_fired: Dict[str, int] = {}
        self._installed = False
        # open-window tracking: NetSim's Network keeps ONE clogged_link
        # set, so an overlapping partition heal would silently lift an
        # active nemesis clog (and an unclog would punch a hole in an open
        # partition). The engine keeps the two independent ([L,N,N]
        # link_ok vs its own clog state); the driver restores the same
        # semantics by re-asserting whichever window is still open.
        self._open_clog: Optional[Tuple[int, int]] = None
        self._open_split_mask: Optional[int] = None
        # the handle exposes the driver so RuntimeMetrics can report fires
        handle.nemesis = self

    def _count(self, kind: str, n: int = 1) -> None:
        self.fired[kind] = self.fired.get(kind, 0) + n

    def _netsim(self):
        from .net.netsim import NetSim

        return self.handle.simulators.get(NetSim)

    def _fssim(self):
        from .fs import FsSim

        return self.handle.simulators.get(FsSim)

    def install(self) -> None:
        """Apply message-level knobs + clock skew, spawn the schedule task."""
        if self._installed:
            raise RuntimeError("NemesisDriver.install() called twice")
        self._installed = True
        net = self._netsim()
        if net is not None and (
            self.plan.get(MsgLoss) or self.plan.get(Duplicate)
            or self.plan.get(Reorder)
        ):
            net.update_config(self.plan.to_net_config(net.network.config))
            # schedule-matched coins: the net layer draws loss/dup/
            # reorder from the per-seed murmur3 chain instead of the
            # ambient GlobalRng (the fourth-face contract the oracle
            # verifies draw-for-draw)
            net.network.config.coins = self.coins.bind(
                time=self.handle.time, lineage=net.lineage
            )
        skew = self.plan.skew_ppm(self.seed, len(self.node_ids))
        if any(skew):
            # integer ppm straight through (r8): vtime.skew_delay_ns
            # applies the exact-int truncation rule shared with the
            # device engine's scale_delay_ppm
            self.handle.time.node_skew = {
                nid: ppm
                for nid, ppm in zip(self.node_ids, skew)
                if ppm != 0
            }
            self._count("skew", sum(1 for p in skew if p != 0))
        from .core.task import Spawner  # noqa: F401  (doc pointer)
        from . import spawn

        spawn(self._run(), name=f"nemesis:{self.plan.name}")

    async def _run(self) -> None:
        from .core.vtime import Sleep

        time = self.handle.time
        for ev in self.schedule:
            if ev.kind == "skew":
                continue  # applied at install time
            deadline_ns = ev.t_us * 1_000
            if deadline_ns > time.now_ns():
                await Sleep(deadline_ns, time)
            self._apply(ev)

    def _apply(self, ev: NemesisEvent) -> None:
        net = self._netsim()
        if ev.kind in (
            "crash", "split", "clog", "spike_on", "remove", "disk_slow"
        ) and ev.k >= 0:
            clause = CLAUSE_OF_EVENT[ev.kind]
            self.occ_fired[clause] = self.occ_fired.get(clause, 0) | (
                1 << min(ev.k, 31)
            )
        if ev.kind == "crash":
            if self.on_crash is not None:
                self.on_crash(ev.node)
            self.handle.kill(self.node_ids[ev.node])
            self._count("crash")
            if ev.wipe:
                self._count("wipe")
        elif ev.kind == "restart":
            if ev.wipe and self.on_wipe is not None:
                self.on_wipe(ev.node)
            self.handle.restart(self.node_ids[ev.node])
            self._count("restart")
        elif ev.kind == "split":
            a, b = self._sides(ev.side_mask)
            self._open_split_mask = ev.side_mask
            if net is not None:
                net.partition(a, b)
            self._count("partition")
        elif ev.kind == "heal":
            a, b = self._sides(ev.side_mask)
            self._open_split_mask = None
            if net is not None:
                net.heal_partition(a, b)
                if self._open_clog is not None:
                    # heal_partition unclogs every cross-group pair; an
                    # active clog window must survive it (idempotent re-add)
                    net.clog_link(*self._open_clog)
            self._count("heal")
        elif ev.kind == "clog":
            self._open_clog = (self.node_ids[ev.node], self.node_ids[ev.dst])
            if net is not None:
                net.clog_link(*self._open_clog)
            self._count("clog")
        elif ev.kind == "unclog":
            pair = (self.node_ids[ev.node], self.node_ids[ev.dst])
            self._open_clog = None
            if net is not None and not self._crosses_open_split(ev.node, ev.dst):
                # if the pair crosses an open partition, the clogged_link
                # entry is doing the partition's work too — leave it for
                # the heal to remove
                net.unclog_link(*pair)
        elif ev.kind == "spike_on":
            if net is not None:
                net.network.config.spike_extra_latency = ev.extra_us / 1e6
            self._count("spike")
        elif ev.kind == "spike_off":
            if net is not None:
                net.network.config.spike_extra_latency = 0.0
        elif ev.kind == "remove":
            # membership removal: the node leaves the cluster. The host
            # runtime has no separate membership plane — a removed node is
            # killed (its tasks drop, its inbound traffic dies with it),
            # which matches the engine clearing BOTH member and alive bits.
            if self.on_crash is not None:
                self.on_crash(ev.node)
            self.handle.kill(self.node_ids[ev.node])
            self._count("remove")
        elif ev.kind == "join":
            # the node re-enters as a BRAND-NEW replica: blank disk (the
            # power_fail never-synced rule extended to joins — nothing
            # survives a membership change, see FsSim.wipe_node), durable
            # app state discarded via the same on_wipe hook wiped restarts
            # use, then the init closure rebuilds it from scratch — the
            # host face of the engine's join-through-`_init` rebuild.
            from .fs import FsSim

            fs = self.handle.simulators.get(FsSim)
            if fs is not None:
                fs.wipe_node(self.node_ids[ev.node])
            if self.on_wipe is not None:
                self.on_wipe(ev.node)
            self.handle.restart(self.node_ids[ev.node])
            self._count("join")
        elif ev.kind == "disk_slow":
            # the victim's disk degrades: every write pays extra latency
            # and fsync raises EIO until the disk dies at disk_crash —
            # the FsSim fault hooks the device face mirrors as a pure
            # fire/trace marker (no device state effect: the loss
            # semantics land at the crash)
            fs = self._fssim()
            if fs is not None:
                fs.set_disk_fault(
                    self.node_ids[ev.node], extra_ns=ev.extra_us * 1_000
                )
            self._count("disk_slow")
        elif ev.kind == "disk_crash":
            # the disk dies: the node goes down and every unsynced byte
            # is dropped back to the synced snapshot (FsSim.power_fail
            # semantics) — except a TORN crash, which keeps a
            # schedule-drawn PREFIX of the last unsynced write
            # (coins.disk_torn_extent: the one host-only draw of the
            # clause, verified by the differential oracle)
            if self.on_crash is not None:
                self.on_crash(ev.node)
            self.handle.kill(self.node_ids[ev.node])
            fs = self._fssim()
            if fs is not None:
                fs.clear_disk_fault(self.node_ids[ev.node])
                fs.power_fail_node(
                    self.node_ids[ev.node],
                    torn_extent=(
                        self.coins.disk_torn_extent if ev.torn else None
                    ),
                )
            self._count("disk_crash")
        elif ev.kind == "disk_recover":
            # recovery from the durable watermark: the host node's init
            # closure re-reads whatever FsSim retained (synced prefix,
            # plus the torn tail if any) — on_wipe is NOT called, synced
            # durability survives a disk death by definition
            self.handle.restart(self.node_ids[ev.node])
            self._count("disk_recover")
        self.applied.append(ev)

    def _crosses_open_split(self, a_idx: int, b_idx: int) -> bool:
        mask = self._open_split_mask
        if mask is None:
            return False
        return bool(mask >> a_idx & 1) != bool(mask >> b_idx & 1)

    def _sides(self, mask: int) -> Tuple[List[int], List[int]]:
        a = [nid for i, nid in enumerate(self.node_ids) if mask >> i & 1]
        b = [nid for i, nid in enumerate(self.node_ids) if not mask >> i & 1]
        return a, b

    def fire_counts(self) -> Dict[str, int]:
        """Host-side chaos fire counts: schedule events + NetSim message
        coins (loss/dup/reorder ride the network config's counters)."""
        out = dict(self.fired)
        net = self._netsim()
        if net is not None:
            for kind, n in net.network.config.nemesis_fires.items():
                out[kind] = out.get(kind, 0) + n
        return out
