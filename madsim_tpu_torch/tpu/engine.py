"""The batched discrete-event engine in PyTorch.

The port of `madsim_tpu/tpu/engine.py`: one step advances every lane to its
next conservative-DES window, picks each node's earliest in-window event
(message, straggler or timer), runs the spec's handlers (the fused
`on_event`, or `on_message` and `on_timer` with a 3-way state merge),
applies crash/restart, bipartition, link-clog, latency-spike, membership
(remove/join) and disk-fault (slow/crash/recover) chaos (legacy
trajectory-coupled knobs or the schedule-indexed `nem_*` knobs a FaultPlan
compiles to), keeps the durable watermark of specs that declare one, rolls
loss, duplication, reordering, latency and the heavy-tail straggler coin
for every send, places survivors in the message ring (node-pooled for fused
specs, per-candidate rings for two-handler specs) or the straggler side
pool, checks invariants and rebases lanes whose clock offset crossed
REBASE_US. Same state fields, same draws, same order: a seed's final state
is leaf for leaf the JAX engine's (tests/test_torch_engine.py,
tests/test_torch_nemesis.py, tests/test_torch_twohandler.py,
tests/test_torch_membership.py, tests/test_torch_triage.py).

`BatchedSim(..., triage=True)` threads a per-lane `TriageCtl` through the
step: clause and occurrence switches, message-rate scales and a horizon
per lane, so one batch evaluates a generation of shrink candidates. The
same step, asked for it, also returns the step's `TraceRecord`, the
per-lane event record `run_traced` collects (tpu/trace.py renders it).

State layout differs only in storage width: node, watermark and straggler
leaves are stored wide (the JAX face's u8/i8/u16 narrowing is a storage
choice, not a value one) and u32 values are int64 tensors (prng.py). The
bool planes rest packed, as on the JAX face (`alive_p`, `link_ok_p`,
`member_p`, `msgs.valid_p`); the straggler pool's `valid` stays unpacked,
as there.

Configurations the port does not carry yet (the coverage, lineage and
device-loop planes) are refused at construction with the ROADMAP item that
will port them.
Every entry point runs on the CUDA card unless the caller passes
`device="cpu"`; without a card it raises rather than fall back.
"""

from __future__ import annotations

import collections
from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from . import bitpack, prng
from ..nemesis import (
    COIN_DENOM,
    FIRE_INDEX,
    FIRE_KINDS,
    NEM_SITE_CLOG_DST,
    NEM_SITE_CLOG_HEAL,
    NEM_SITE_CLOG_IV,
    NEM_SITE_CLOG_SRC,
    NEM_SITE_CRASH_DOWN,
    NEM_SITE_CRASH_IV,
    NEM_SITE_CRASH_VICTIM,
    NEM_SITE_CRASH_WIPE,
    NEM_SITE_DISK_DOWN,
    NEM_SITE_DISK_IV,
    NEM_SITE_DISK_SLOW,
    NEM_SITE_DISK_TORN,
    NEM_SITE_DISK_VICTIM,
    NEM_SITE_PART_HEAL,
    NEM_SITE_PART_IV,
    NEM_SITE_PART_SIDE,
    NEM_SITE_RECONF_DUR,
    NEM_SITE_RECONF_IV,
    NEM_SITE_RECONF_VICTIM,
    NEM_SITE_SKEW,
    NEM_SITE_SPIKE_DUR,
    NEM_SITE_SPIKE_IV,
    NET_SITE_DUP,
    NET_SITE_NEM_LOSS,
    NET_SITE_REORDER,
    NET_SITE_REORDER_EXTRA,
    OCC_CLAUSES,
    OCC_ROW,
    RATE_CLAUSES,
    fold32,
    RATE_ROW,
    TRIAGE_BIT,
)
from .spec import (
    INF_GUARD, INF_US, REBASE_US, HardCap, ProtocolSpec, RateFloor, SimConfig,
    derate_horizon, expand_to, tree_map, tree_select,
)

DEFAULT_DISPATCH_STEPS = 10_000
# steps launched between two host reads of the all-done flag. Steps past the
# point where every lane is done are no-ops (see BatchedSim._step), so the
# check only bounds wasted work; it never changes a result.
DONE_CHECK_STEPS = 32
# idle steps of a traced run (every lane done) evaluated as one batch: a
# card's step costs about the same at 1 and at 16384 lanes, a CPU's grows
# with the lanes past ~1024
IDLE_BLOCK_STEPS = {"cpu": 1024}
IDLE_BLOCK_STEPS_DEFAULT = 16384


class MsgPool(NamedTuple):
    """In-flight messages: per-destination validity + per-slot ring.

    Node n owns the SK contiguous ring slots [n*SK, (n+1)*SK); a slot holds
    one (deliver time, kind, payload), and validity is one bit per
    (destination, slot), packed along the slot axis."""

    valid_p: Any  # u32-in-int64 [L,N,ceil(CK/32)]
    deliver: Any  # int32 [L,CK] (offset us)
    kind: Any  # int32 [L,CK]
    payload: Any  # int32 [L,CK,P]
    sent_eid: Any = None  # lineage stamp (not ported: always None)

    @property
    def valid(self):
        """bool [L,N,CK] validity view."""
        return bitpack.unpack_bits(self.valid_p, self.deliver.shape[-1])


class StragPool(NamedTuple):
    """Heavy-tail straggler side pool (present iff buggify_delay_rate > 0):
    one region of K4 slots per candidate position ([L, C, K4] flattened to
    [L, B]); the destination is stored per slot."""

    valid: Any  # bool [L,B]
    deliver: Any  # int32 [L,B] (offset us)
    dst: Any  # int32 [L,B]
    kind: Any  # int32 [L,B]
    payload: Any  # int32 [L,B,P]
    sent_eid: Any = None  # lineage stamp (not ported: always None)


class NemesisState(NamedTuple):
    """Per-lane nemesis bookkeeping (present iff a schedule-level clause or
    clock skew is enabled). Every nemesis draw is indexed by (lane base
    key, clause site, occurrence counter `*_k`), a pure function of the
    seed, never of the trajectory clock. The crash clause shares
    `SimState.chaos_at`/`crashed` and the partition clause shares
    `part_at`/`partitioned`/`link_ok` with the legacy knobs; clog, spike,
    reconfig and disk windows carry their own next-toggle offsets here."""

    crash_k: Any  # int32 [L] crash/restart cycle counter
    wipe: Any  # bool [L] current down node restarts with wiped state
    part_k: Any  # int32 [L] split/heal cycle counter
    clog_at: Any  # int32 [L] next clog toggle (offset us; INF_US disabled)
    clogged: Any  # bool [L] a directed link is currently clogged
    clog_src: Any  # int32 [L]
    clog_dst: Any  # int32 [L]
    clog_k: Any  # int32 [L]
    spike_at: Any  # int32 [L] next latency-spike toggle
    spiking: Any  # bool [L]
    spike_k: Any  # int32 [L]
    reconfig_at: Any  # int32 [L] next membership toggle (INF_US disabled)
    reconf_node: Any  # int32 [L] node currently out of the membership (-1:
    #           all in; the next reconfig event is a remove, else a join)
    reconfig_k: Any  # int32 [L] remove/join cycle counter
    disk_at: Any  # int32 [L] next disk-fault phase toggle (INF_US disabled)
    disk_phase: Any  # int32 [L] 0 healthy, 1 degraded, 2 down (the victim
    #           and torn bit are pure draws at (key0, site, disk_k))
    disk_k: Any  # int32 [L] disk-fault occurrence counter (bumps at recover)
    skew_ppm: Any  # int32 [L,N] per-node timer skew in ppm | None


class TriageCtl(NamedTuple):
    """Per-lane shrink controls (present iff `BatchedSim(..., triage=True)`).

    The shrinker (madsim_tpu_torch/triage.py) evaluates every candidate as
    a lane of one batch: all lanes share the config's compiled knobs, and
    these tensors switch clauses, single clause occurrences, message-coin
    rates and the horizon off per lane. A suppressed occurrence still
    advances the timing machinery through its window, so a candidate is
    the seed's trajectory minus exactly the suppressed faults."""

    off: Any  # int32 [L] clause-off bitmask over nemesis.TRIAGE_CLAUSES
    occ: Any  # int32 [L, len(OCC_CLAUSES)] occurrence-off bitmasks (bit k
    #           suppresses occurrence k; k >= 32 is always on, and bit 31,
    #           the int32 sign bit, is left unused by the shrinker)
    rate_scale: Any  # float32 [L, len(RATE_CLAUSES)] loss/dup/reorder rate
    #           scales (the coin is `u < rate * scale` on the same stream)
    h_epoch: Any  # int32 [L] per-lane horizon, epoch part
    h_off: Any  # int32 [L] per-lane horizon, offset part


def default_ctl(L: int, horizon_us: int, device="cpu") -> TriageCtl:
    """The no-op ctl: every clause and occurrence on, full horizon."""
    eh, oh = divmod(int(horizon_us), REBASE_US)
    return TriageCtl(
        off=torch.zeros((L,), dtype=torch.int32, device=device),
        occ=torch.zeros((L, len(OCC_CLAUSES)), dtype=torch.int32,
                        device=device),
        rate_scale=torch.ones((L, len(RATE_CLAUSES)), dtype=torch.float32,
                              device=device),
        h_epoch=torch.full((L,), eh, dtype=torch.int32, device=device),
        h_off=torch.full((L,), oh, dtype=torch.int32, device=device),
    )


def _clause_on(ctl: TriageCtl, name: str) -> torch.Tensor:
    """bool [L]: clause `name` enabled per lane."""
    return (ctl.off & TRIAGE_BIT[name]) == 0


def _occ_on(ctl: TriageCtl, name: str, k: torch.Tensor) -> torch.Tensor:
    """bool [L]: occurrence k [L] of schedule clause `name` enabled per
    lane. The mask is read as u32 (held in int64), as on the JAX face."""
    bit = (
        prng.u32(ctl.occ[:, OCC_ROW[name]]) >> torch.clamp(k, 0, 31).long()
    ) & 1
    return _clause_on(ctl, name) & ((bit == 0) | (k >= 32))


def _scaled_rate(rate: float, ctl: TriageCtl, name: str) -> torch.Tensor:
    """float32 [L, 1]: a message clause's per-lane coin rate, the JAX
    face's f32(rate) * scale * f32(clause on). The product of two float32
    values rounds the same whether formed in float32 or in double, so the
    scalar needs no device tensor; with the default ctl it is f32(rate)."""
    return (
        ctl.rate_scale[:, RATE_ROW[name]] * prng.f32(rate)
        * _clause_on(ctl, name).to(torch.float32)
    )[:, None]


class TraceRecord(NamedTuple):
    """One step's observable events, for per-lane violation traces: every
    delivery, timer fire and chaos event with its virtual time. Leaves are
    [L, ...]; `run_traced` stacks them to [T, L, ...]. Times are offsets in
    the post-rebase basis (absolute = epoch * REBASE_US + offset)."""

    clock: Any  # int32 [L]
    epoch: Any  # int32 [L]
    t_evt: Any  # int32 [L,N] virtual time of node n's event this step
    msg_fired: Any  # bool [L,N] message delivered to node n this step
    msg_src: Any  # int32 [L,N]
    msg_kind: Any  # int32 [L,N]
    msg_payload: Any  # int32 [L,N,P]
    timer_fired: Any  # bool [L,N]
    crash: Any  # int32 [L] node crashed this step, -1 = none
    restart: Any  # int32 [L] node restarted this step, -1 = none
    split: Any  # bool [L] partition split this step
    heal: Any  # bool [L] partition healed this step
    side_mask: Any  # int32 [L] nodes on side A of the partition draw
    violation: Any  # bool [L] invariant first violated this step
    deadlock: Any  # bool [L]
    clog_src: Any  # int32 [L] link clogged this step, -1 = none
    clog_dst: Any  # int32 [L]
    unclog: Any  # bool [L]
    spike_on: Any  # bool [L] latency spike opened this step
    spike_off: Any  # bool [L]
    remove: Any  # int32 [L] node removed from membership, -1 = none
    join: Any  # int32 [L] node re-joined (fresh init), -1 = none
    disk_slow: Any  # int32 [L] disk degraded on node, -1 = none
    disk_crash: Any  # int32 [L] disk died on node, -1 = none
    disk_recover: Any  # int32 [L] node recovered from its watermark, -1 = none
    disk_torn: Any  # bool [L] the occurrence's torn coin (crash, recover)
    lam: Any = None  # lineage plane (not ported: always None)
    evt_eid: Any = None
    sent_eid: Any = None


class SimState(NamedTuple):
    """The full per-lane state; the JAX face's field names. Fields of planes
    this slice does not carry are None."""

    clock: Any  # int32 [L] (offset us; see epoch)
    epoch: Any  # int32 [L]
    key: Any  # u32 [L] hash-chain key
    key0: Any  # u32 [L] the lane's base key
    done: Any  # bool [L]
    violated: Any  # bool [L]
    violation_at: Any  # int32 [L]
    violation_epoch: Any  # int32 [L]
    violation_step: Any  # int32 [L] first violating step (-1 = none)
    deadlocked: Any  # bool [L]
    steps: Any  # int32 [L]
    events: Any  # int32 [L]
    overflow: Any  # int32 [L] sends dropped: pool full
    dead_drops: Any  # int32 [L] sends dropped: destination down
    nonmember_drops: Any  # int32 [L] sends dropped: destination removed
    unsynced_loss: Any  # int32 [L] disk crashes that lost unsynced state
    fires: Any  # int32 [L, len(FIRE_KINDS)]
    occ_fired: Any  # u32 [L, len(OCC_CLAUSES)] occurrence bits | None
    alive_p: Any  # u32 [L,1] packed liveness bits
    crashed: Any  # int32 [L] node currently down, -1 = none
    chaos_at: Any  # int32 [L] next crash/restart event
    member_p: Any  # u32 [L,1] packed membership bits (reconfig clause)
    member_epoch: Any  # int32 [L]
    link_ok_p: Any  # u32 [L,N,1] packed directed-link bits, row = src
    partitioned: Any  # bool [L]
    part_at: Any  # int32 [L] next partition split/heal event
    timer: Any  # int32 [L,N]
    node: Any  # protocol NamedTuple, leaves [L,N,...]
    dur: Any  # durable watermark over spec.durable_fields, leaves [L,N,...]
    #           | None (present iff nem_disk is on and the spec declares
    #           durable_fields)
    msgs: MsgPool
    strag: Any  # StragPool | None
    nem: Any  # NemesisState | None
    ctl: Any  # TriageCtl | None (BatchedSim(..., triage=True) only)
    cov: Any  # None (coverage)
    lin: Any  # None (lineage)
    queue: Any  # None (refill queue)
    refill: Any  # None (refill log)
    loop: Any = None  # None (device-loop carry)

    @property
    def alive(self):
        return bitpack.unpack_bits(self.alive_p, self.timer.shape[1])

    @property
    def link_ok(self):
        return bitpack.unpack_bits(self.link_ok_p, self.timer.shape[1])

    @property
    def member(self):
        return bitpack.unpack_bits(self.member_p, self.timer.shape[1])


def resolve_device(device) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU. A CUDA
    request without a card raises; it never falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "engine on the CPU"
        )
    return dev


def scale_delay_ppm(d: torch.Tensor, ppm) -> torch.Tensor:
    """Stretch an int32 microsecond delay by (1 + ppm * 1e-6), exactly:
    d + floor(d * |ppm| / 1e6) * sign(ppm), wrapped to int32.

    The JAX face splits the 64-bit product into int32-safe partial
    products; the product is exact in int64 (|d| < 2^31, |ppm| < 1e6), and
    floor division of the whole product equals the sum of its floored
    parts, so the result is the same int32 value for every input the
    engine passes (tests/test_torch_nemesis.py holds both on edge
    values)."""
    d64 = d.to(torch.int64)
    ppm64 = torch.as_tensor(ppm, device=d.device).to(torch.int64)
    adj = torch.div(d64 * ppm64.abs(), 1_000_000, rounding_mode="floor")
    return torch.where(ppm64 >= 0, d64 + adj, d64 - adj).to(torch.int32)


def _first_free(free: torch.Tensor, K: int) -> torch.Tensor:
    """First-free-slot mask along the last axis (length K, static),
    unrolled as on the JAX face."""
    if K == 1:
        return free
    prev = torch.zeros_like(free[..., 0])
    cols = []
    for k in range(K):
        cols.append(free[..., k] & ~prev)
        prev = prev | free[..., k]
    return torch.stack(cols, dim=-1)


# select NamedTuple leaves by an [L, N] mask, broadcasting trailing dims
# (the JAX engine's `_tree_where`)
_tree_where = tree_select


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to madsim_tpu_torch yet "
        f"(ROADMAP.md queue 1, {item})"
    )


class BatchedSim:
    """Vectorized multi-lane simulator for one ProtocolSpec."""

    def __init__(
        self, spec: ProtocolSpec, config: Optional[SimConfig] = None,
        triage: bool = False, coverage: bool = False,
        lineage: bool = False, devloop: Any = None, device="cuda",
    ) -> None:
        self.spec = spec
        self.config = config or SimConfig()
        self.triage = bool(triage)
        cfg = self.config
        N = spec.n_nodes
        # -- the JAX face's construction checks that apply to this slice,
        # with the same messages, so both faces accept the same configs
        if devloop is not None and not (triage and coverage):
            raise ValueError(
                "devloop needs BatchedSim(..., triage=True, coverage=True) "
                "— the device loop mutates ctl genomes and ranks coverage "
                "novelty in-jit"
            )
        if N < 2:
            raise ValueError(f"spec.n_nodes must be >= 2, got {N}")
        if N > 32:
            raise ValueError(
                f"spec.n_nodes must be <= 32 (packed bool planes), got {N}"
            )
        if spec.msg_kind_names is not None and len(spec.msg_kind_names) > 256:
            raise ValueError(
                "message kinds must fit u8 (pool `kind` is stored narrow): "
                f"got {len(spec.msg_kind_names)} named kinds"
            )
        narrow = dict(spec.narrow_fields or {})
        bad = set(narrow) & set(spec.time_fields)
        if bad:
            raise ValueError(
                "time_fields hold absolute epoch-rebased times and must "
                f"stay i32 — remove {sorted(bad)} from narrow_fields"
            )
        for fname, entry in (spec.rate_floors or {}).items():
            if not isinstance(entry, (RateFloor, HardCap)):
                raise ValueError(
                    f"rate_floors[{fname!r}] must be a RateFloor or "
                    f"HardCap, got {type(entry).__name__}"
                )
        if narrow and spec.narrow_horizon_us is not None:
            # the JAX face stores these fields narrow and would wrap them
            # past this horizon: refuse the same configs it refuses
            cap = derate_horizon(
                spec.narrow_horizon_us,
                cfg.nem_skew_max_ppm if cfg.nem_skew_enabled else 0,
            )
            if cfg.horizon_us > cap:
                raise ValueError(
                    f"horizon_us={cfg.horizon_us} exceeds this spec's "
                    f"narrow-dtype safe horizon ({cap} us"
                    + (" after clock-skew derating"
                       if cfg.nem_skew_enabled else "")
                    + "): strip spec.narrow_fields (dataclasses.replace("
                    "spec, narrow_fields=None)) for long soaks, or "
                    "shorten the horizon"
                )
        if spec.payload_width < 1 or spec.max_out < 1 or spec.max_out_msg < 1:
            raise ValueError(
                "spec payload_width / max_out / max_out_msg must be >= 1 "
                f"(got {spec.payload_width}/{spec.max_out}/{spec.max_out_msg})"
            )
        if cfg.latency_lo_us < 0 or cfg.latency_hi_us < cfg.latency_lo_us:
            raise ValueError(
                f"latency range [{cfg.latency_lo_us}, {cfg.latency_hi_us}] "
                "must satisfy 0 <= lo <= hi"
            )
        if not (0.0 <= cfg.loss_rate < 1.0):
            raise ValueError(f"loss_rate must be in [0, 1), got {cfg.loss_rate}")
        if cfg.horizon_us <= 0:
            raise ValueError(f"horizon_us must be positive, got {cfg.horizon_us}")
        for name in ("msg_depth_msg", "msg_depth_timer"):
            v = getattr(cfg, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if cfg.msg_spare_slots < 0:
            raise ValueError(
                f"msg_spare_slots must be >= 0, got {cfg.msg_spare_slots}"
            )
        if spec.on_event is None and cfg.msg_spare_slots > 0:
            raise ValueError(
                "msg_spare_slots only applies to fused (on_event) specs — "
                "the two-handler path places per-candidate rings; use "
                "msg_depth_msg/msg_depth_timer there"
            )
        for name in (
            "nem_loss_rate", "nem_dup_rate", "nem_reorder_rate",
            "nem_crash_wipe_rate", "nem_disk_torn_rate",
        ):
            v = getattr(cfg, name)
            if not (0.0 <= v < 1.0):
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if cfg.nem_crash_enabled and cfg.chaos_enabled:
            raise ValueError(
                "nem_crash_* and crash_interval_* cannot both be enabled — "
                "one crash machinery, one time source (use the FaultPlan)"
            )
        if cfg.nem_partition_enabled and cfg.partition_enabled:
            raise ValueError(
                "nem_partition_* and partition_interval_* cannot both be "
                "enabled — one partition machinery, one time source"
            )
        for prefix, parts in (
            ("nem_crash", ("interval", "down")),
            ("nem_partition", ("interval", "heal")),
            ("nem_clog", ("interval", "heal")),
            ("nem_spike", ("interval", "duration")),
            ("nem_reconfig", ("interval", "down")),
            ("nem_disk", ("interval", "slow", "down")),
        ):
            if getattr(cfg, f"{prefix}_interval_hi_us") <= 0:
                continue
            for part in parts:
                lo = getattr(cfg, f"{prefix}_{part}_lo_us")
                hi = getattr(cfg, f"{prefix}_{part}_hi_us")
                if lo < 0 or hi < lo or hi <= 0:
                    raise ValueError(
                        f"{prefix}_{part} range [{lo}, {hi}] must satisfy "
                        "0 <= lo <= hi and hi > 0"
                    )
        if cfg.nem_reorder_rate > 0 and cfg.nem_reorder_window_us <= 0:
            raise ValueError(
                "nem_reorder_rate needs nem_reorder_window_us > 0, got "
                f"{cfg.nem_reorder_window_us}"
            )
        if cfg.nem_spike_enabled and cfg.nem_spike_extra_us <= 0:
            raise ValueError(
                f"nem_spike_extra_us must be > 0, got {cfg.nem_spike_extra_us}"
            )
        if not (0 <= cfg.nem_skew_max_ppm < 1_000_000):
            raise ValueError(
                "nem_skew_max_ppm must be in [0, 1e6) (the timer rate "
                f"1 + ppm*1e-6 must stay positive), got {cfg.nem_skew_max_ppm}"
            )
        if (
            cfg.latency_hi_us + cfg.nem_spike_extra_us
            + cfg.nem_reorder_window_us
        ) >= INF_GUARD // 4:
            raise ValueError(
                "latency_hi + nem_spike_extra + nem_reorder_window must stay "
                f"below {INF_GUARD // 4} us"
            )
        if spec.on_event is not None and cfg.msg_depth_timer is not None and (
            cfg.msg_depth_timer != cfg.msg_depth_msg
        ):
            raise ValueError(
                "fused (on_event) specs have ONE candidate class: "
                "msg_depth_timer has no effect and must equal msg_depth_msg "
                f"(got {cfg.msg_depth_timer} vs {cfg.msg_depth_msg}); tune "
                "msg_depth_msg and msg_spare_slots instead"
            )
        if spec.on_recover is not None and not spec.durable_fields:
            raise ValueError(
                "spec.on_recover requires spec.durable_fields — the hook "
                "receives the durable watermark, and without declared "
                "durable fields there is nothing durable to recover from"
            )
        if spec.durable_fields and spec.sync_field is None:
            raise ValueError(
                "spec.durable_fields requires spec.sync_field — the i32 "
                "node-state counter the spec's handlers bump at their "
                "fsync points; without it the watermark could never "
                "advance past boot"
            )
        if spec.durable_fields and spec.sync_field in spec.durable_fields:
            raise ValueError(
                "spec.sync_field must not itself be durable: the watermark "
                "advance compares its live value against the PREVIOUS "
                "step's, not against the snapshot"
            )
        bad_dur = set(spec.durable_fields) & set(spec.time_fields)
        if bad_dur:
            raise ValueError(
                "durable_fields cannot include time_fields (the watermark "
                "snapshot is not epoch-rebased; an absolute time in it "
                f"would go stale): remove {sorted(bad_dur)}"
            )
        # -- valid configurations this slice does not carry yet
        if coverage:
            raise _not_ported("BatchedSim(coverage=True)", "item 9")
        if lineage:
            raise _not_ported("BatchedSim(lineage=True)", "item 9")
        if devloop is not None:
            raise _not_ported("BatchedSim(devloop=...)", "item 12")

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # every op of the step has a deterministic CUDA implementation;
            # this turns any future nondeterministic one into an error
            torch.use_deterministic_algorithms(True)
        dev = self.device
        # candidate positions, the fixed send sites of one step: a fused
        # spec's N * max_out rows; a two-handler spec's N * max_out_msg
        # on_message rows, then its N * max_out on_timer rows. Position
        # c's source node is a constant either way.
        self._fused = spec.on_event is not None
        if self._fused:
            src_of_c = np.arange(N * spec.max_out) // spec.max_out
        else:
            src_of_c = np.concatenate([
                np.arange(N * spec.max_out_msg) // spec.max_out_msg,
                np.arange(N * spec.max_out) // spec.max_out,
            ])
        # nemesis duplication doubles the candidate axis: position 2c is
        # the original send, 2c+1 its coin-gated copy (interleaved, so each
        # node's candidate block and each two-handler segment stays
        # contiguous with its bounds doubled); pool sizing follows
        self._dup = cfg.nem_dup_rate > 0
        mult = 2 if self._dup else 1
        self._Cb = src_of_c.size  # base (pre-duplication) candidates
        self._C = self._Cb * mult
        src_of_c = np.repeat(src_of_c, mult)
        uniform = max(1, cfg.msg_capacity // self._C)
        self._Km = cfg.msg_depth_msg or uniform
        if self._fused:
            # node-pooled placement: node n owns SK = E*K (+ spare)
            # contiguous ring slots, shared by all its sends
            self._E_pack = spec.max_out * mult
            self._SK = self._E_pack * self._Km + cfg.msg_spare_slots
            self._CK = N * self._SK
            src_of_slot = np.repeat(np.arange(N), self._SK)
            self._segs = None
        else:
            # per-candidate rings: position c owns K consecutive slots, K
            # per class (reply rows msg_depth_msg, timer rows
            # msg_depth_timer); equal depths collapse to one segment
            self._Kt = cfg.msg_depth_timer or uniform
            Cm = N * spec.max_out_msg * mult
            Sm = Cm * self._Km
            self._CK = Sm + (self._C - Cm) * self._Kt
            if self._Km == self._Kt:
                self._segs = ((0, self._C, self._Km, 0, self._CK),)
            else:
                self._segs = (
                    (0, Cm, self._Km, 0, Sm),
                    (Cm, self._C, self._Kt, Sm, self._CK),
                )
            # the candidate that owns each ring slot
            cand_of_slot = np.concatenate([
                np.repeat(np.arange(c0, c1), K)
                for c0, c1, K, _, _ in self._segs
            ])
            self._cand_of_slot = torch.as_tensor(cand_of_slot, device=dev)
            src_of_slot = src_of_c[cand_of_slot]
        self._src_of_c = torch.as_tensor(src_of_c, device=dev)  # int64 [C]
        self._src_of_slot = torch.as_tensor(
            src_of_slot, dtype=torch.int32, device=dev
        )  # [CK]
        # straggler side pool: K4 slots per candidate position
        if cfg.buggify_delay_rate > 0:
            self._K4 = max(1, cfg.buggify_depth)
            self._B = self._C * self._K4
            cand_of_b = np.repeat(np.arange(self._C), self._K4)
            self._cand_of_b = torch.as_tensor(cand_of_b, device=dev)
            self._src_of_b = torch.as_tensor(
                src_of_c[cand_of_b], dtype=torch.int32, device=dev
            )  # [B]
        else:
            self._K4 = self._B = 0
        # per-lane nemesis bookkeeping exists iff a schedule-level clause
        # (or skew) is on; occurrence bits iff a schedule clause is on
        self._occ_track = (
            cfg.nem_crash_enabled or cfg.nem_partition_enabled
            or cfg.nem_clog_enabled or cfg.nem_spike_enabled
            or cfg.nem_reconfig_enabled or cfg.nem_disk_enabled
        )
        self._nem_state = self._occ_track or cfg.nem_skew_enabled
        # durability plane: carried iff the disk clause can fire and the
        # spec declares what is durable
        self._dur_state = cfg.nem_disk_enabled and bool(spec.durable_fields)
        self._DurTuple = (
            collections.namedtuple("DurState", spec.durable_fields)
            if spec.durable_fields else None
        )
        self._narange = torch.arange(N, dtype=torch.int32, device=dev)
        self._slot_idx = torch.arange(self._CK, device=dev)
        self._cidx = torch.arange(self._C, device=dev)
        self._bidx = torch.arange(self._Cb, device=dev)
        if self._B:
            self._sidx = torch.arange(self._B, device=dev)
        self.step = self._step

    # ------------------------------------------------------------------ init

    def _seeds_tensor(self, seeds) -> torch.Tensor:
        """Seeds (any int sequence or array) as u32-in-int64 on the device."""
        if isinstance(seeds, torch.Tensor):
            return prng.u32(seeds.to(self.device))
        arr = np.asarray(list(seeds) if isinstance(seeds, range) else seeds)
        return torch.as_tensor(
            arr.astype(np.uint32).astype(np.int64), device=self.device
        )

    def init(self, seeds, ctl: Optional[TriageCtl] = None) -> SimState:
        """Build lane state for a batch of seeds. `ctl` (triage sims only)
        carries the per-lane shrink controls; by default every clause is
        on and the horizon is the config's."""
        spec, cfg, dev = self.spec, self.config, self.device
        seeds = self._seeds_tensor(seeds)
        L, N, CK = seeds.shape[0], spec.n_nodes, self._CK
        if ctl is not None and not self.triage:
            raise ValueError(
                "a TriageCtl requires BatchedSim(..., triage=True)"
            )
        if self.triage:
            ctl = (default_ctl(L, cfg.horizon_us, dev) if ctl is None
                   else TriageCtl(*(t.to(dev) for t in ctl)))

        key = prng.key_from(seeds)  # u32 [L]
        node_keys = prng.fold(key[:, None], self._narange)
        node_state, timer = spec.init(node_keys, self._narange)
        timer = timer.to(torch.int32)
        if spec.durable_fields:
            self._check_durable(node_state)

        def full(shape, v, dtype=torch.int32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        zi = full((L,), 0)
        zb = full((L,), False, torch.bool)
        fires = full((L, len(FIRE_KINDS)), 0)
        # per-node clock skew: integer ppm drawn once per (seed, node);
        # initial timers are armed at local t=0, so their delay scales
        skew_ppm = None
        if cfg.nem_skew_enabled:
            skew_ppm = prng.randint(
                key[:, None], NEM_SITE_SKEW, -cfg.nem_skew_max_ppm,
                cfg.nem_skew_max_ppm + 1, index=self._narange[None, :],
            )  # [L,N]
            if self.triage:
                # a skew-off lane runs every node at ppm 0; the draws
                # still happen, they just do not apply
                skew_ppm = torch.where(
                    _clause_on(ctl, "skew")[:, None], skew_ppm, 0
                ).to(torch.int32)
            fires[:, FIRE_INDEX["skew"]] = (skew_ppm != 0).sum(
                dim=1, dtype=torch.int32
            )
            sk_ok = (timer >= 0) & (timer < INF_GUARD)
            timer = torch.where(sk_ok, scale_delay_ppm(timer, skew_ppm), timer)

        if cfg.nem_crash_enabled:
            # occurrence-indexed: the first crash interval is draw k=0
            chaos_at = prng.randint(
                key, NEM_SITE_CRASH_IV, cfg.nem_crash_interval_lo_us,
                cfg.nem_crash_interval_hi_us, index=0,
            )
        elif cfg.chaos_enabled:
            chaos_at = prng.randint(
                key, 11, cfg.crash_interval_lo_us, cfg.crash_interval_hi_us
            )
        else:
            chaos_at = full((L,), INF_US)
        if cfg.nem_partition_enabled:
            part_at = prng.randint(
                key, NEM_SITE_PART_IV, cfg.nem_partition_interval_lo_us,
                cfg.nem_partition_interval_hi_us, index=0,
            )
        elif cfg.partition_enabled:
            part_at = prng.randint(
                key, 12, cfg.partition_interval_lo_us,
                cfg.partition_interval_hi_us,
            )
        else:
            part_at = full((L,), INF_US)

        nem = None
        if self._nem_state:
            def first_toggle(enabled, site, lo, hi):
                if enabled:
                    return prng.randint(key, site, lo, hi, index=0)
                return full((L,), INF_US)

            nem = NemesisState(
                crash_k=zi, wipe=zb, part_k=zi,
                clog_at=first_toggle(
                    cfg.nem_clog_enabled, NEM_SITE_CLOG_IV,
                    cfg.nem_clog_interval_lo_us, cfg.nem_clog_interval_hi_us,
                ),
                clogged=zb, clog_src=zi, clog_dst=zi, clog_k=zi,
                spike_at=first_toggle(
                    cfg.nem_spike_enabled, NEM_SITE_SPIKE_IV,
                    cfg.nem_spike_interval_lo_us,
                    cfg.nem_spike_interval_hi_us,
                ),
                spiking=zb, spike_k=zi,
                reconfig_at=first_toggle(
                    cfg.nem_reconfig_enabled, NEM_SITE_RECONF_IV,
                    cfg.nem_reconfig_interval_lo_us,
                    cfg.nem_reconfig_interval_hi_us,
                ),
                reconf_node=full((L,), -1), reconfig_k=zi,
                disk_at=first_toggle(
                    cfg.nem_disk_enabled, NEM_SITE_DISK_IV,
                    cfg.nem_disk_interval_lo_us, cfg.nem_disk_interval_hi_us,
                ),
                disk_phase=zi, disk_k=zi, skew_ppm=skew_ppm,
            )
        strag = None
        if self._B:
            B = self._B
            strag = StragPool(
                valid=full((L, B), False, torch.bool),
                deliver=full((L, B), INF_US),
                dst=full((L, B), 0),
                kind=full((L, B), 0),
                payload=full((L, B, spec.payload_width), 0),
            )
        all_n = bitpack.full_mask_word(N)
        return SimState(
            clock=zi, epoch=zi, key=key, key0=key, done=zb, violated=zb,
            violation_at=full((L,), INF_US), violation_epoch=zi,
            violation_step=full((L,), -1), deadlocked=zb, steps=zi,
            events=zi, overflow=zi, dead_drops=zi, nonmember_drops=zi,
            unsynced_loss=zi, fires=fires,
            occ_fired=(
                full((L, len(OCC_CLAUSES)), 0, torch.int64)
                if self._occ_track else None
            ),
            alive_p=full((L, 1), all_n, torch.int64),
            crashed=full((L,), -1), chaos_at=chaos_at,
            member_p=full((L, 1), all_n, torch.int64), member_epoch=zi,
            link_ok_p=full((L, N, 1), all_n, torch.int64),
            partitioned=zb, part_at=part_at, timer=timer, node=node_state,
            # boot is fsynced: the watermark starts as the init snapshot
            dur=self._dur_of(node_state) if self._dur_state else None,
            msgs=MsgPool(
                valid_p=full((L, N, bitpack.packed_words(CK)), 0, torch.int64),
                deliver=full((L, CK), INF_US),
                kind=full((L, CK), 0),
                payload=full((L, CK, spec.payload_width), 0),
            ),
            strag=strag, nem=nem, ctl=ctl, cov=None, lin=None, queue=None,
            refill=None,
        )

    # ----------------------------------------------- durability watermark
    # spec.durable_fields: the disk clause's plane. The JAX face stores it
    # at the node carry's narrow dtypes; here, like the node, it is wide.

    def _check_durable(self, node) -> None:
        for f in self.spec.durable_fields:
            if not hasattr(node, f):
                raise ValueError(
                    f"durable_fields names unknown node-state field {f!r}"
                )
        sf = self.spec.sync_field
        if sf is not None and not hasattr(node, sf):
            raise ValueError(
                f"sync_field names unknown node-state field {sf!r}"
            )

    def _dur_of(self, node):
        """Snapshot the durable fields of a node pytree (the watermark)."""
        return self._DurTuple(**{
            f: getattr(node, f) for f in self.spec.durable_fields
        })

    # ------------------------------------------------------------------ step

    def _step(self, state: SimState, gate_key: bool = False,
              record: bool = False):
        """One engine step. With `gate_key`, a step taken when every lane is
        already done is a no-op: done lanes freeze every leaf but `key`, and
        the gate holds `key` too, so a sweep may run past its last live step
        without changing the result (the JAX loop stops at that step). With
        `record`, returns (state, TraceRecord of this step)."""
        spec, cfg = self.spec, self.config
        triage = self.triage
        ctl = state.ctl
        N, CK, P, C = spec.n_nodes, self._CK, spec.payload_width, self._C
        L = state.clock.shape[0]
        msgs = state.msgs
        strag = state.strag
        nst = state.nem
        narange = self._narange
        i32 = torch.int32
        clog_on, spike_on = cfg.nem_clog_enabled, cfg.nem_spike_enabled
        reconf_on, disk_on = cfg.nem_reconfig_enabled, cfg.nem_disk_enabled

        # -- 0. unpack the packed bool planes
        valid = bitpack.unpack_bits(msgs.valid_p, CK)  # bool [L,N,CK]
        alive = bitpack.unpack_bits(state.alive_p, N)  # bool [L,N]
        link_ok = bitpack.unpack_bits(state.link_ok_p, N)  # bool [L,N,N]
        node0 = state.node

        # -- 1. advance each lane to its next event window
        t_pend = torch.where(valid, msgs.deliver[:, None, :], INF_US)
        tmsg_main = t_pend.amin(dim=2)  # [L,N]
        tmsg_n = tmsg_main
        if self._B:
            # a node's earliest straggler: the side pool stores each
            # slot's destination
            sd_oh = strag.dst[:, :, None] == narange  # [L,B,N]
            ts_b = torch.where(strag.valid, strag.deliver, INF_US)  # [L,B]
            t_sn = torch.where(sd_oh, ts_b[:, :, None], INF_US)  # [L,B,N]
            tmsg_strag = t_sn.amin(dim=1)  # [L,N]
            tmsg_n = torch.minimum(tmsg_n, tmsg_strag)
        tmsg_n = torch.where(alive, tmsg_n, INF_US)
        ttmr_n = torch.where(alive, state.timer, INF_US)
        # the next chaos instant: crash/restart and partition toggles
        # (legacy or nemesis), and the nemesis clog/spike/reconfig/disk
        # toggles, which lanes advance to even when the protocol is quiet
        next_chaos = torch.minimum(state.chaos_at, state.part_at)
        for on, at in ((clog_on, "clog_at"), (spike_on, "spike_at"),
                       (reconf_on, "reconfig_at"), (disk_on, "disk_at")):
            if on:
                next_chaos = torch.minimum(next_chaos, getattr(nst, at))
        t_next = torch.minimum(
            torch.minimum(tmsg_n.amin(dim=1), ttmr_n.amin(dim=1)), next_chaos
        )
        deadlocked = (~state.done) & (t_next >= INF_US)
        active = (~state.done) & (t_next < INF_US)
        # conservative-DES lookahead window [t_next, t_next + latency_lo),
        # collapsed to the instant t_next when chaos falls inside it (the
        # straggler tail only lengthens latencies)
        lo_w = max(0, cfg.latency_lo_us - 1) if cfg.lookahead else 0
        w_end = torch.clamp(t_next, max=INF_US - lo_w - 1) + lo_w
        if lo_w and (
            cfg.any_crash_enabled or cfg.any_partition_enabled
            or clog_on or spike_on or reconf_on or disk_on
        ):
            w_end = torch.where(next_chaos <= w_end, t_next, w_end)

        # -- 2. advance per-lane keys
        key = prng.fold(state.key, 1)
        if gate_key:
            key = torch.where((~state.done).any(), key, state.key)
        node_key = prng.fold(key[:, None], narange)  # [L,N]
        mkeys = prng.fold(node_key, 101)
        rkeys = prng.fold(node_key, 103)
        ckey = prng.fold(key, 104)  # [L]

        # -- 3. pick each node's event: earliest in-window message or timer
        msg_due = active[:, None] & (tmsg_n <= w_end[:, None])
        tmr_due = active[:, None] & (ttmr_n <= w_end[:, None])
        if cfg.sched_randomize:
            timer_first = prng.bernoulli(prng.fold(node_key, 108), 1, 0.5)
        else:
            timer_first = torch.zeros_like(msg_due)
        tie = msg_due & tmr_due & (tmsg_n == ttmr_n)
        has_msg = msg_due & (
            ~tmr_due | (tmsg_n < ttmr_n) | (tie & ~timer_first)
        )
        due_t = tmr_due & (
            ~msg_due | (ttmr_n < tmsg_n) | (tie & timer_first)
        )
        t_evt = torch.where(
            has_msg, tmsg_n, torch.where(due_t, ttmr_n, t_next[:, None])
        )
        # slot choice among the node's earliest-time slots: argmin returns
        # the FIRST minimum on both devices, as jnp.argmin does
        head = valid & (t_pend == tmsg_n[:, :, None])  # [L,N,CK]
        if cfg.sched_randomize:
            prio = prng.bits(
                prng.fold(key, 107)[:, None], 1, index=self._slot_idx[None]
            )[:, None, :]  # u32 [L,1,CK]
            slot = torch.where(head, prio, prng.M32).argmin(dim=2)
        else:
            slot = torch.where(head, t_pend, INF_US).argmin(dim=2)
        pick_oh = self._slot_idx == slot[:, :, None]  # [L,N,CK]
        m_src = self._src_of_slot[slot]  # [L,N]
        m_kind = torch.gather(msgs.kind, 1, slot)
        m_pay = torch.gather(
            msgs.payload, 1, slot[:, :, None].expand(L, N, P)
        )
        if self._B:
            # a straggler beats the main pool only with a strictly earlier
            # time (same-instant cross-pool ties go to the main pool); among
            # a node's earliest stragglers the first slot wins
            strag_win = has_msg & (tmsg_strag < tmsg_main)
            s_slot = t_sn.argmin(dim=1)  # [L,N]
            m_src = torch.where(strag_win, self._src_of_b[s_slot], m_src)
            m_kind = torch.where(
                strag_win, torch.gather(strag.kind, 1, s_slot), m_kind
            )
            m_pay = torch.where(
                strag_win[:, :, None],
                torch.gather(
                    strag.payload, 1, s_slot[:, :, None].expand(L, N, P)
                ),
                m_pay,
            )
            consumed_main = has_msg & ~strag_win
        else:
            consumed_main = has_msg
        node_ids = torch.broadcast_to(narange, (L, N))

        # -- 4. handlers + state select (the masks are disjoint)
        any_crash = cfg.any_crash_enabled
        wipe_mask = None
        if any_crash:
            chaos_due = active & (state.chaos_at <= t_next)
            is_restart_evt = state.crashed >= 0
            do_crash = chaos_due & ~is_restart_evt
            do_restart = chaos_due & is_restart_evt
            if cfg.nem_crash_enabled:
                # victim k of the pure schedule: a function of the seed,
                # not of when the crash fires
                victim = prng.randint(
                    state.key0, NEM_SITE_CRASH_VICTIM, 0, N,
                    index=nst.crash_k,
                )
            else:
                victim = prng.randint(ckey, 1, 0, N)
            # triage: a suppressed occurrence keeps its timing (chaos_at,
            # crashed, crash_k advance as always) but applies no effect:
            # ap_* gate the kill, the restart, the pool drops, the trace
            # rows and the fire counts
            ap_crash, ap_restart = do_crash, do_restart
            if triage:
                crash_en = _occ_on(
                    ctl, "crash",
                    nst.crash_k if cfg.nem_crash_enabled
                    else torch.zeros_like(state.crashed),
                )
                ap_crash, ap_restart = do_crash & crash_en, do_restart & crash_en
            crash_mask = ap_crash[:, None] & (node_ids == victim[:, None])
            restart_node = torch.clamp(state.crashed, 0, N - 1)
            restart_mask = ap_restart[:, None] & (
                node_ids == restart_node[:, None]
            )
            ns_r, timer_r = spec.on_restart(node0, node_ids, t_next, rkeys)
            if cfg.nem_crash_enabled and cfg.nem_crash_wipe_rate > 0:
                # crash-with-state-wipe: the marked node restarts from
                # `init`, its absolute time fields and first timer shifted
                # to the restart instant (the wipe flag was drawn at crash
                # time and rides nem.wipe through the down window)
                ns_w, timer_w = self._fresh(rkeys, t_next)
                wipe_mask = restart_mask & nst.wipe[:, None]
                if triage:
                    # wipe is its own atom: with it off, the occurrence
                    # still happens but restarts through on_restart
                    wipe_mask = wipe_mask & _clause_on(ctl, "wipe")[:, None]
                ns_r = _tree_where(wipe_mask, ns_w, ns_r)
                timer_r = torch.where(wipe_mask, timer_w, timer_r)
        if self._fused:
            evt = has_msg | due_t
            evt_kind = torch.where(has_msg, m_kind, -1)
            ns_e, out_e, timer_e = spec.on_event(
                node0, node_ids, m_src, evt_kind, m_pay, t_evt, mkeys
            )
            if any_crash:
                node = tree_map(
                    lambda old, e, r: torch.where(
                        expand_to(restart_mask, old), r,
                        torch.where(expand_to(evt, old), e, old),
                    ),
                    node0, ns_e, ns_r,
                )
            else:
                node = tree_map(
                    lambda old, e: torch.where(expand_to(evt, old), e, old),
                    node0, ns_e,
                )
            timer_m = timer_t = timer_e
        else:
            # both handlers run for every node; a 3-way select keeps the
            # one whose event fired (or the restart)
            tkeys = prng.fold(node_key, 102)
            ns_m, out_m, timer_m = spec.on_message(
                node0, node_ids, m_src, m_kind, m_pay, t_evt, mkeys
            )
            ns_t, out_t, timer_t = spec.on_timer(node0, node_ids, t_evt, tkeys)

            def merge(old, m, t, r=None):
                out = torch.where(
                    expand_to(due_t, old), t,
                    torch.where(expand_to(has_msg, old), m, old),
                )
                if r is not None:
                    out = torch.where(expand_to(restart_mask, old), r, out)
                return out

            if any_crash:
                node = tree_map(merge, node0, ns_m, ns_t, ns_r)
            else:
                node = tree_map(merge, node0, ns_m, ns_t)
        if cfg.nem_skew_enabled:
            # per-node clock skew: a handler's absolute deadline encodes a
            # delay from its own event time; stretch that delay by the
            # node's ppm (sentinels and keep/disarm negatives pass through)
            def skew_deadline(deadline, now):
                d = deadline - now
                stretched = now + scale_delay_ppm(d, nst.skew_ppm)
                ok = (deadline >= 0) & (deadline < INF_GUARD) & (d > 0)
                return torch.where(ok, stretched, deadline)

            if self._fused:
                timer_m = timer_t = skew_deadline(timer_e, t_evt)
            else:
                timer_m = skew_deadline(timer_m, t_evt)
                timer_t = skew_deadline(timer_t, t_evt)
            if any_crash:
                timer_r = skew_deadline(
                    timer_r, torch.broadcast_to(t_next[:, None], (L, N))
                )
        # message events keep the deadline on a negative timer; timer
        # events disarm on one
        timer = torch.where(has_msg & (timer_m >= 0), timer_m, state.timer)
        timer = torch.where(
            due_t, torch.where(timer_t >= 0, timer_t, INF_US), timer
        )
        if any_crash:
            timer = torch.where(restart_mask, timer_r, timer)
        # consume the delivered slot
        valid = valid & ~(pick_oh & consumed_main[:, :, None])
        if self._B:
            s_oh = (self._sidx == s_slot[:, :, None]) & strag_win[:, :, None]
            svalid = strag.valid & ~s_oh.any(dim=1)  # [L,B]
        clock = torch.where(
            active, torch.maximum(state.clock, t_evt.amax(dim=1)), state.clock
        )

        # -- 5. crash/restart chaos
        crashed, chaos_at = state.crashed, state.chaos_at
        nem_crash_k = nem_wipe = None
        if any_crash:
            alive = (alive & ~crash_mask) | restart_mask
            if cfg.nem_crash_enabled:
                # schedule arithmetic: next toggle = previous toggle time
                # plus an occurrence-indexed delta, never clock + delta
                ck_n = nst.crash_k
                restart_delay = prng.randint(
                    state.key0, NEM_SITE_CRASH_DOWN, cfg.nem_crash_down_lo_us,
                    cfg.nem_crash_down_hi_us, index=ck_n,
                )
                next_crash = prng.randint(
                    state.key0, NEM_SITE_CRASH_IV,
                    cfg.nem_crash_interval_lo_us,
                    cfg.nem_crash_interval_hi_us, index=ck_n + 1,
                )
                chaos_at = torch.where(
                    do_crash, state.chaos_at + restart_delay,
                    torch.where(
                        do_restart, state.chaos_at + next_crash,
                        state.chaos_at,
                    ),
                )
                nem_crash_k = ck_n + do_restart.to(i32)
                # integer schedule coin: bits % 1e6 < round(rate * 1e6)
                wipe_coin = (
                    prng.bits(state.key0, NEM_SITE_CRASH_WIPE, index=ck_n)
                    % COIN_DENOM
                ) < round(cfg.nem_crash_wipe_rate * COIN_DENOM)
                nem_wipe = torch.where(
                    do_crash, wipe_coin,
                    torch.where(do_restart, False, nst.wipe),
                )
            else:
                restart_delay = prng.randint(
                    ckey, 2, cfg.restart_delay_lo_us, cfg.restart_delay_hi_us
                )
                next_crash = prng.randint(
                    ckey, 3, cfg.crash_interval_lo_us,
                    cfg.crash_interval_hi_us,
                )
                chaos_at = torch.where(
                    do_crash, clock + restart_delay,
                    torch.where(do_restart, clock + next_crash, state.chaos_at),
                )
            crashed = torch.where(
                do_crash, victim, torch.where(do_restart, -1, state.crashed)
            )
            # in-flight messages to a crashed node are lost
            valid = valid & ~crash_mask[:, :, None]
            if self._B:
                svalid = svalid & ~(
                    ap_crash[:, None] & (strag.dst == victim[:, None])
                )

        # -- 5b. partition chaos: random bipartition splits, later heals
        partitioned, part_at = state.partitioned, state.part_at
        nem_part_k = None
        if cfg.any_partition_enabled:
            part_due = active & (state.part_at <= t_next)
            do_split = part_due & ~state.partitioned
            do_heal = part_due & state.partitioned
            if cfg.nem_partition_enabled:
                pk_n = nst.part_k
                # per-node side bit of occurrence k: index = k * 64 + node
                side = (
                    prng.bits(
                        state.key0[:, None], NEM_SITE_PART_SIDE,
                        index=prng.u32(pk_n)[:, None] * 64 + narange[None, :],
                    ) & 1
                ) == 1  # [L,N]
                heal_delay = prng.randint(
                    state.key0, NEM_SITE_PART_HEAL,
                    cfg.nem_partition_heal_lo_us,
                    cfg.nem_partition_heal_hi_us, index=pk_n,
                )
                next_split = prng.randint(
                    state.key0, NEM_SITE_PART_IV,
                    cfg.nem_partition_interval_lo_us,
                    cfg.nem_partition_interval_hi_us, index=pk_n + 1,
                )
                part_at = torch.where(
                    do_split, state.part_at + heal_delay,
                    torch.where(
                        do_heal, state.part_at + next_split, state.part_at
                    ),
                )
                nem_part_k = pk_n + do_heal.to(i32)
            else:
                pkey = prng.fold(key, 106)
                side = prng.uniform(
                    pkey[:, None], 7, index=narange[None, :]
                ) < 0.5
                heal_delay = prng.randint(
                    pkey, 8, cfg.partition_heal_lo_us, cfg.partition_heal_hi_us
                )
                next_split = prng.randint(
                    pkey, 9, cfg.partition_interval_lo_us,
                    cfg.partition_interval_hi_us,
                )
                part_at = torch.where(
                    do_split, clock + heal_delay,
                    torch.where(do_heal, clock + next_split, state.part_at),
                )
            # a suppressed occurrence toggles `partitioned` (timing) but
            # never touches link_ok
            ap_split, ap_heal = do_split, do_heal
            if triage:
                part_en = _occ_on(
                    ctl, "partition",
                    nst.part_k if cfg.nem_partition_enabled
                    else torch.zeros_like(state.crashed),
                )
                ap_split, ap_heal = do_split & part_en, do_heal & part_en
            same_side = side[:, :, None] == side[:, None, :]  # [L,N,N]
            link_ok = torch.where(
                ap_split[:, None, None], same_side,
                torch.where(ap_heal[:, None, None], True, link_ok),
            )
            partitioned = (state.partitioned | do_split) & ~do_heal

        # -- 5c. nemesis link-clog + latency-spike windows (schedule-timed
        # toggles; the clog is asymmetric: src->dst only)
        clogged = clog_src = clog_dst = None
        nem_clog_at = nem_clog_k = None
        if clog_on:
            clog_due = active & (nst.clog_at <= t_next)
            do_clog = clog_due & ~nst.clogged
            do_unclog = clog_due & nst.clogged
            kk = nst.clog_k
            # clog_k names the window open (or opening) this step: one gate
            # covers the toggle's trace rows and every in-window send
            ap_clog, ap_unclog = do_clog, do_unclog
            if triage:
                clog_en = _occ_on(ctl, "clog", kk)
                ap_clog, ap_unclog = do_clog & clog_en, do_unclog & clog_en
            src_d = prng.randint(state.key0, NEM_SITE_CLOG_SRC, 0, N, index=kk)
            dst_d = prng.randint(
                state.key0, NEM_SITE_CLOG_DST, 0, N - 1, index=kk
            )
            dst_d = dst_d + (dst_d >= src_d).to(i32)  # skip src
            clog_src = torch.where(do_clog, src_d, nst.clog_src)
            clog_dst = torch.where(do_clog, dst_d, nst.clog_dst)
            clogged = (nst.clogged | do_clog) & ~do_unclog
            heal_d = prng.randint(
                state.key0, NEM_SITE_CLOG_HEAL, cfg.nem_clog_heal_lo_us,
                cfg.nem_clog_heal_hi_us, index=kk,
            )
            next_d = prng.randint(
                state.key0, NEM_SITE_CLOG_IV, cfg.nem_clog_interval_lo_us,
                cfg.nem_clog_interval_hi_us, index=kk + 1,
            )
            nem_clog_at = torch.where(
                do_clog, nst.clog_at + heal_d,
                torch.where(do_unclog, nst.clog_at + next_d, nst.clog_at),
            )
            nem_clog_k = kk + do_unclog.to(i32)
        spiking = nem_spike_at = nem_spike_k = None
        if spike_on:
            spike_due = active & (nst.spike_at <= t_next)
            do_spike = spike_due & ~nst.spiking
            do_unspike = spike_due & nst.spiking
            sk = nst.spike_k
            ap_spike, ap_unspike = do_spike, do_unspike
            if triage:
                spike_en = _occ_on(ctl, "spike", sk)
                ap_spike = do_spike & spike_en
                ap_unspike = do_unspike & spike_en
            spiking = (nst.spiking | do_spike) & ~do_unspike
            dur_d = prng.randint(
                state.key0, NEM_SITE_SPIKE_DUR, cfg.nem_spike_duration_lo_us,
                cfg.nem_spike_duration_hi_us, index=sk,
            )
            next_d = prng.randint(
                state.key0, NEM_SITE_SPIKE_IV, cfg.nem_spike_interval_lo_us,
                cfg.nem_spike_interval_hi_us, index=sk + 1,
            )
            nem_spike_at = torch.where(
                do_spike, nst.spike_at + dur_d,
                torch.where(do_unspike, nst.spike_at + next_d, nst.spike_at),
            )
            nem_spike_k = sk + do_unspike.to(i32)

        # -- 5d. nemesis membership reconfiguration: a remove takes the
        # schedule-drawn victim out of the cluster (member and alive bits
        # cleared, in-flight messages to it lost); the paired join brings
        # the same node back as a fresh replica rebuilt through spec.init.
        # reconf_node doubles as the open/closed discriminator (-1: the
        # next event is a remove)
        member = None
        member_epoch = state.member_epoch
        nem_reconfig_at = nem_reconf_node = nem_reconfig_k = None
        if reconf_on:
            member = bitpack.unpack_bits(state.member_p, N)  # bool [L,N]
            reconf_due = active & (nst.reconfig_at <= t_next)
            do_remove = reconf_due & (nst.reconf_node < 0)
            do_join = reconf_due & (nst.reconf_node >= 0)
            rk = nst.reconfig_k
            # one gate per occurrence covers both halves (k bumps at the
            # join): a suppressed occurrence changes no membership at all
            ap_remove, ap_join = do_remove, do_join
            if triage:
                reconf_en = _occ_on(ctl, "reconfig", rk)
                ap_remove, ap_join = do_remove & reconf_en, do_join & reconf_en
            victim_d = prng.randint(
                state.key0, NEM_SITE_RECONF_VICTIM, 0, N, index=rk
            )
            join_node = torch.clamp(nst.reconf_node, 0, N - 1)
            remove_mask = ap_remove[:, None] & (node_ids == victim_d[:, None])
            join_mask = ap_join[:, None] & (node_ids == join_node[:, None])
            member = (member & ~remove_mask) | join_mask
            # liveness and membership stay independent planes, but a
            # remove also downs the node and a join revives it
            alive = (alive & ~remove_mask) | join_mask
            member_epoch = member_epoch + (ap_remove | ap_join).to(i32)
            valid = valid & ~remove_mask[:, :, None]
            if self._B:
                svalid = svalid & ~(
                    ap_remove[:, None] & (strag.dst == victim_d[:, None])
                )
            ns_j, timer_j = self._fresh(
                rkeys, t_next, nst.skew_ppm if cfg.nem_skew_enabled else None
            )
            node = _tree_where(join_mask, ns_j, node)
            timer = torch.where(join_mask, timer_j, timer)
            down_d = prng.randint(
                state.key0, NEM_SITE_RECONF_DUR, cfg.nem_reconfig_down_lo_us,
                cfg.nem_reconfig_down_hi_us, index=rk,
            )
            next_d = prng.randint(
                state.key0, NEM_SITE_RECONF_IV,
                cfg.nem_reconfig_interval_lo_us,
                cfg.nem_reconfig_interval_hi_us, index=rk + 1,
            )
            nem_reconfig_at = torch.where(
                do_remove, nst.reconfig_at + down_d,
                torch.where(do_join, nst.reconfig_at + next_d,
                            nst.reconfig_at),
            )
            nem_reconf_node = torch.where(
                do_remove, victim_d,
                torch.where(do_join, -1, nst.reconf_node),
            )
            nem_reconfig_k = rk + do_join.to(i32)

        # durability watermark advance: re-snapshot the durable fields of
        # every node whose sync counter rose this step. Done before the disk
        # clause, so a spec that syncs before acking never loses an acked
        # write to it, even when the sync and the crash land on one step
        dur_mid = state.dur
        if self._dur_state:
            sf = spec.sync_field
            dur_adv = getattr(node, sf) > getattr(node0, sf)  # [L,N]
            dur_mid = _tree_where(dur_adv, self._dur_of(node), state.dur)

        # -- 5e. nemesis disk-fault cycle (slow -> crash -> recover): the
        # victim is killed at the crash and, at recovery, rebuilt from its
        # durable watermark instead of live state. The victim and torn bit
        # are pure draws at index disk_k, recomputed at every phase
        drec_mask = None
        unsynced_lost = None
        nem_disk_at = nem_disk_phase = nem_disk_k = None
        if disk_on:
            disk_due = active & (nst.disk_at <= t_next)
            dk = nst.disk_k
            do_dslow = disk_due & (nst.disk_phase == 0)
            do_dcrash = disk_due & (nst.disk_phase == 1)
            do_drecover = disk_due & (nst.disk_phase == 2)
            # all three phases of occurrence k share one gate
            ap_dslow, ap_dcrash, ap_drecover = do_dslow, do_dcrash, do_drecover
            if triage:
                disk_en = _occ_on(ctl, "disk", dk)
                ap_dslow = do_dslow & disk_en
                ap_dcrash = do_dcrash & disk_en
                ap_drecover = do_drecover & disk_en
            dvictim = prng.randint(
                state.key0, NEM_SITE_DISK_VICTIM, 0, N, index=dk
            )
            if cfg.nem_disk_torn_rate > 0:
                torn = (
                    prng.bits(state.key0, NEM_SITE_DISK_TORN, index=dk)
                    % COIN_DENOM
                ) < round(cfg.nem_disk_torn_rate * COIN_DENOM)
            else:
                torn = torch.zeros_like(do_dslow)
            dcrash_mask = ap_dcrash[:, None] & (node_ids == dvictim[:, None])
            drec_mask = ap_drecover[:, None] & (node_ids == dvictim[:, None])
            alive = (alive & ~dcrash_mask) | drec_mask
            valid = valid & ~dcrash_mask[:, :, None]
            if self._B:
                svalid = svalid & ~(
                    ap_dcrash[:, None] & (strag.dst == dvictim[:, None])
                )
            # unsynced loss: the victim's durable fields differ from its
            # watermark at the crash instant (without a durable contract
            # the whole node state is unsynced)
            if self._dur_state:
                differs = torch.zeros_like(dcrash_mask)
                for f in spec.durable_fields:
                    d = getattr(dur_mid, f) != getattr(node, f)
                    differs = differs | d.reshape(L, N, -1).any(dim=2)
                unsynced_lost = (dcrash_mask & differs).any(dim=1).to(i32)
            else:
                unsynced_lost = ap_dcrash.to(i32)
            # recovery: a fresh init state with the durable fields replaced
            # by the watermark, refined by spec.on_recover (which sees the
            # torn bit); its timer is a delay from the recovery instant
            ns_d, timer_d = spec.init(rkeys, narange)
            if self._dur_state:
                ns_d = ns_d._replace(**{
                    f: getattr(dur_mid, f) for f in spec.durable_fields
                })
            if spec.on_recover is not None:
                ns_d, timer_d = spec.on_recover(
                    ns_d, node_ids, t_next, torn, rkeys
                )
            ns_d, timer_d = self._shift_fresh(
                ns_d, timer_d, t_next,
                nst.skew_ppm if cfg.nem_skew_enabled else None,
            )
            node = _tree_where(drec_mask, ns_d, node)
            timer = torch.where(drec_mask, timer_d, timer)
            slow_d = prng.randint(
                state.key0, NEM_SITE_DISK_SLOW, cfg.nem_disk_slow_lo_us,
                cfg.nem_disk_slow_hi_us, index=dk,
            )
            down_d = prng.randint(
                state.key0, NEM_SITE_DISK_DOWN, cfg.nem_disk_down_lo_us,
                cfg.nem_disk_down_hi_us, index=dk,
            )
            next_d = prng.randint(
                state.key0, NEM_SITE_DISK_IV, cfg.nem_disk_interval_lo_us,
                cfg.nem_disk_interval_hi_us, index=dk + 1,
            )
            nem_disk_at = torch.where(
                do_dslow, nst.disk_at + slow_d,
                torch.where(
                    do_dcrash, nst.disk_at + down_d,
                    torch.where(do_drecover, nst.disk_at + next_d,
                                nst.disk_at),
                ),
            )
            nem_disk_phase = torch.where(
                do_dslow, 1,
                torch.where(do_dcrash, 2,
                            torch.where(do_drecover, 0, nst.disk_phase)),
            ).to(i32)
            nem_disk_k = dk + do_drecover.to(i32)

        # durability watermark reset, the node now final: where wipe, join
        # or disk-recover installed a fresh state, that state is the new
        # on-disk truth. Reset targets are disjoint from advance targets
        new_dur = dur_mid
        if self._dur_state:
            reset = drec_mask
            if wipe_mask is not None:
                reset = reset | wipe_mask
            if reconf_on:
                reset = reset | join_mask
            new_dur = _tree_where(reset, self._dur_of(node), dur_mid)

        # -- 6. collect outboxes, roll the network, pack into the pool
        def flat(out, emitting, e):  # [L,N,e,...] -> [L, N*e, ...]
            return (
                (out.valid & emitting[:, :, None]).reshape(L, N * e),
                out.dst.reshape(L, N * e),
                out.kind.reshape(L, N * e),
                out.payload.reshape(L, N * e, P),
            )

        if self._fused:
            cand_valid, cd, cand_kind, cand_pay = flat(out_e, evt, spec.max_out)
        else:
            parts = (flat(out_m, has_msg, spec.max_out_msg),
                     flat(out_t, due_t, spec.max_out))
            cand_valid, cd, cand_kind, cand_pay = (
                torch.cat(xs, dim=1) for xs in zip(*parts)
            )
        cand_dst = torch.clamp(cd, 0, N - 1).long()
        net_key = prng.fold(key, 105)[:, None]
        zl = torch.zeros((L,), dtype=i32, device=self.device)
        dup_fires = loss_drops = reorder_fires = zl
        if self._dup:
            # nemesis duplication: interleave a coin-gated copy of every
            # candidate (position 2c+1 mirrors 2c); the copy rolls its own
            # loss and latency below
            # triage: a per-lane scaled rate on the same uniform stream
            dcoin = prng.uniform(
                net_key, NET_SITE_DUP, index=self._bidx[None, :]
            ) < (_scaled_rate(cfg.nem_dup_rate, ctl, "dup") if triage
                 else prng.f32(cfg.nem_dup_rate))
            dup_fires = (cand_valid & dcoin).sum(dim=1, dtype=i32)

            def il(x):
                return torch.repeat_interleave(x, 2, dim=1)

            cand_valid = torch.stack(
                [cand_valid, cand_valid & dcoin], dim=2
            ).reshape(L, C)
            cand_dst, cand_kind, cand_pay = (
                il(cand_dst), il(cand_kind), il(cand_pay)
            )
        cidx = self._cidx[None, :]
        u = prng.uniform(net_key, 1, index=cidx)
        lat = prng.randint(
            net_key, 2, cfg.latency_lo_us,
            max(cfg.latency_hi_us, cfg.latency_lo_us + 1), index=cidx,
        )
        keep = cand_valid & (u >= prng.f32(cfg.loss_rate))
        nonmember_dropped = zl
        if reconf_on:
            # membership filter first, so the drop classes stay disjoint: a
            # send to a removed node counts here, to a crashed member below
            member_dst = torch.gather(member, 1, cand_dst)
            nonmember_dropped = (keep & ~member_dst).sum(dim=1, dtype=i32)
            keep = keep & member_dst
        # sends to dead nodes drop, counted apart from pool overflow
        alive_dst = torch.gather(alive, 1, cand_dst)
        dead_dropped = (keep & ~alive_dst).sum(dim=1, dtype=i32)
        keep = keep & alive_dst
        if cfg.any_partition_enabled:
            # link test at send time, row = the candidate's static source
            link = link_ok.index_select(1, self._src_of_c)  # [L,C,N]
            keep = keep & torch.gather(link, 2, cand_dst[:, :, None])[..., 0]
        if clog_on:
            # asymmetric clog: drop candidates whose (static source,
            # destination) is the lane's clogged directed link
            clog_hit = (
                clogged[:, None]
                & (self._src_of_c[None, :] == clog_src[:, None])
                & (cand_dst == clog_dst[:, None])
            )
            if triage:
                clog_hit = clog_hit & clog_en[:, None]
            keep = keep & ~clog_hit
        if cfg.nem_loss_rate > 0:
            # the nemesis loss coin, rolled last: only on messages that
            # survived base loss, dead destinations, partitions and clogs
            u2 = prng.uniform(net_key, NET_SITE_NEM_LOSS, index=cidx)
            nem_lost = keep & (
                u2 < (_scaled_rate(cfg.nem_loss_rate, ctl, "loss") if triage
                      else prng.f32(cfg.nem_loss_rate))
            )
            loss_drops = nem_lost.sum(dim=1, dtype=i32)
            keep = keep & ~nem_lost
        if cfg.nem_reorder_rate > 0:
            # bounded reordering: an extra uniform delay in [0, window]
            rcoin = keep & (
                prng.uniform(net_key, NET_SITE_REORDER, index=cidx)
                < (_scaled_rate(cfg.nem_reorder_rate, ctl, "reorder")
                   if triage else prng.f32(cfg.nem_reorder_rate))
            )
            extra = prng.randint(
                net_key, NET_SITE_REORDER_EXTRA, 0,
                cfg.nem_reorder_window_us + 1, index=cidx,
            )
            lat = torch.where(rcoin, lat + extra, lat)
            reorder_fires = rcoin.sum(dim=1, dtype=i32)
        if spike_on:
            spike_open = spiking & spike_en if triage else spiking
            lat = torch.where(
                spike_open[:, None], lat + cfg.nem_spike_extra_us, lat
            )
        if self._B:
            # the heavy-tail straggler coin: a surviving message sometimes
            # takes seconds instead of milliseconds, and rides the side pool
            bug = keep & prng.bernoulli(
                net_key, 3, cfg.buggify_delay_rate, index=cidx
            )
            tail = prng.randint(
                net_key, 4, cfg.buggify_delay_lo_us,
                max(cfg.buggify_delay_hi_us, cfg.buggify_delay_lo_us + 1),
                index=cidx,
            )
            lat = torch.where(bug, tail, lat)
            send = keep & ~bug
        else:
            send = keep
        deliver_at = t_evt.index_select(1, self._src_of_c) + lat  # [L,C]
        # slots no destination references reset to INF_US (canonical state)
        referenced = valid.any(dim=1)
        old_deliver = torch.where(referenced, msgs.deliver, INF_US)

        if self._fused:
            # node-pooled placement: the i-th send of node n takes the i-th
            # free slot of n's SK-slot pool; a send ranked past the free
            # count drops and counts as overflow
            E, SK = self._E_pack, self._SK
            send_n = send.reshape(L, N, E)
            free = (~referenced).reshape(L, N, SK)
            send_i = send_n.to(i32)
            free_i = free.to(i32)
            r_send = torch.cumsum(send_i, dim=-1, dtype=i32) - send_i
            c_free = torch.cumsum(free_i, dim=-1, dtype=i32)
            r_free = c_free - free_i
            n_free = c_free[..., -1]
            place = (
                send_n[:, :, :, None]
                & free[:, :, None, :]
                & (r_send[:, :, :, None] == r_free[:, :, None, :])
            )  # [L,N,E,SK]: at most one row per slot
            ring_w = place.any(dim=2).reshape(L, CK)
            overflow = state.overflow + (
                send_n & (r_send >= n_free[:, :, None])
            ).sum(dim=(1, 2), dtype=i32)
            # the candidate that took each slot (masked by ring_w)
            row = (
                place.to(i32)
                * torch.arange(E, dtype=i32, device=self.device)[:, None]
            ).sum(dim=2, dtype=i32)  # [L,N,SK]
            cand_of_slot = (row + (narange * E)[None, :, None]).reshape(
                L, CK
            ).long()

            def to_slots(cand):
                if cand.dim() == 2:
                    return torch.gather(cand, 1, cand_of_slot)
                return torch.gather(
                    cand, 1, cand_of_slot[:, :, None].expand(L, CK, P)
                )
        else:
            # per-candidate rings: a send takes the first of its K ring
            # slots no destination still references; with all K pending it
            # drops and counts as overflow (per depth segment)
            ring_w_parts = []
            ovf = zl
            for c0, c1, K, s0, s1 in self._segs:
                nc = c1 - c0
                send_seg = send[:, c0:c1]
                free = (~referenced[:, s0:s1]).reshape(L, nc, K)
                ring_w_seg = send_seg[:, :, None] & _first_free(free, K)
                ovf = ovf + (send_seg & ~ring_w_seg.any(dim=2)).sum(
                    dim=1, dtype=i32
                )
                ring_w_parts.append(ring_w_seg.reshape(L, nc * K))
            ring_w = (
                ring_w_parts[0] if len(ring_w_parts) == 1
                else torch.cat(ring_w_parts, dim=1)
            )  # [L,CK]
            overflow = state.overflow + ovf

            def to_slots(cand):
                return cand.index_select(1, self._cand_of_slot)

        def put(ring, cand):
            """Write each placed candidate's value into its slot."""
            return torch.where(expand_to(ring_w, ring), to_slots(cand), ring)

        written = ring_w[:, None, :] & (
            to_slots(cand_dst)[:, None, :] == narange.long()[None, :, None]
        )  # [L,N,CK]: destination d references slot s
        new_valid = valid | written
        new_deliver = put(old_deliver, deliver_at)
        new_kind = put(msgs.kind, cand_kind)
        new_payload = put(msgs.payload, cand_pay)

        new_strag = None
        if self._B:
            # straggler pack: candidate c's tail send takes the first free
            # of its K4 side-pool slots
            K4, B = self._K4, self._B
            sb = keep & bug  # [L,C]
            splace = sb[:, :, None] & _first_free(
                ~svalid.reshape(L, C, K4), K4
            )
            swritten = splace.reshape(L, B)
            overflow = overflow + (sb & ~splace.any(dim=2)).sum(
                dim=1, dtype=i32
            )

            def sput(pool, cand):
                inc = cand.index_select(1, self._cand_of_b)
                return torch.where(expand_to(swritten, pool), inc, pool)

            new_strag = StragPool(
                valid=svalid | swritten,
                deliver=sput(
                    torch.where(svalid, strag.deliver, INF_US), deliver_at
                ),
                dst=sput(strag.dst, cand_dst.to(i32)),
                kind=sput(strag.kind, cand_kind),
                payload=sput(strag.payload, cand_pay),
            )

        # -- 6b. chaos fire counts
        cols = [zl] * len(FIRE_KINDS)
        if any_crash:
            cols[FIRE_INDEX["crash"]] = ap_crash.to(i32)
            cols[FIRE_INDEX["restart"]] = ap_restart.to(i32)
            if cfg.nem_crash_enabled and cfg.nem_crash_wipe_rate > 0:
                ap_wipe = ap_crash & wipe_coin
                if triage:
                    ap_wipe = ap_wipe & _clause_on(ctl, "wipe")
                cols[FIRE_INDEX["wipe"]] = ap_wipe.to(i32)
        if cfg.any_partition_enabled:
            cols[FIRE_INDEX["partition"]] = ap_split.to(i32)
            cols[FIRE_INDEX["heal"]] = ap_heal.to(i32)
        if clog_on:
            cols[FIRE_INDEX["clog"]] = ap_clog.to(i32)
        if spike_on:
            cols[FIRE_INDEX["spike"]] = ap_spike.to(i32)
        if reconf_on:
            cols[FIRE_INDEX["remove"]] = ap_remove.to(i32)
            cols[FIRE_INDEX["join"]] = ap_join.to(i32)
        if disk_on:
            cols[FIRE_INDEX["disk_slow"]] = ap_dslow.to(i32)
            cols[FIRE_INDEX["disk_crash"]] = ap_dcrash.to(i32)
            cols[FIRE_INDEX["disk_recover"]] = ap_drecover.to(i32)
        cols[FIRE_INDEX["loss"]] = loss_drops
        cols[FIRE_INDEX["dup"]] = dup_fires
        cols[FIRE_INDEX["reorder"]] = reorder_fires
        fires = state.fires + torch.stack(cols, dim=1)

        # clause x occurrence fire bits: a window's bit is set when its
        # open half applies (suppressed occurrences stay unset)
        occ_fired = state.occ_fired
        if occ_fired is not None:
            ocols = [occ_fired[:, i] for i in range(len(OCC_CLAUSES))]

            def occ_mark(row, fired, k):
                bit = torch.bitwise_left_shift(
                    torch.ones_like(ocols[row]), torch.clamp(k, 0, 31).long()
                )
                ocols[row] = torch.where(fired, ocols[row] | bit, ocols[row])

            if cfg.nem_crash_enabled:
                occ_mark(OCC_ROW["crash"], ap_crash, nst.crash_k)
            if cfg.nem_partition_enabled:
                occ_mark(OCC_ROW["partition"], ap_split, nst.part_k)
            if clog_on:
                occ_mark(OCC_ROW["clog"], ap_clog, nst.clog_k)
            if spike_on:
                occ_mark(OCC_ROW["spike"], ap_spike, nst.spike_k)
            if reconf_on:
                occ_mark(OCC_ROW["reconfig"], ap_remove, nst.reconfig_k)
            if disk_on:
                occ_mark(OCC_ROW["disk"], ap_dslow, nst.disk_k)
            occ_fired = torch.stack(ocols, dim=1)

        # -- 7. invariants + lane lifecycle
        ok = spec.check_invariants(node, alive, clock)
        new_violation = active & ~ok & ~state.violated
        violated = state.violated | new_violation
        violation_at = torch.where(new_violation, clock, state.violation_at)
        violation_epoch = torch.where(
            new_violation, state.epoch, state.violation_epoch
        )
        violation_step = torch.where(
            new_violation, state.steps, state.violation_step
        )
        # horizon in (epoch, offset) space; triage lanes carry their own
        # (the shrinker's time-truncation axis)
        if triage:
            eh, oh = ctl.h_epoch, ctl.h_off
        else:
            eh, oh = divmod(int(cfg.horizon_us), REBASE_US)
        reached_horizon = (state.epoch > eh) | (
            (state.epoch == eh) & (clock >= oh)
        )
        done = state.done | deadlocked | reached_horizon | violated

        # -- 8. epoch rebase: unbounded virtual time, int32 offsets
        do_shift = (~done) & (clock >= REBASE_US)
        shift = torch.where(do_shift, REBASE_US, 0).to(i32)  # [L]

        def rb(x):  # rebase a live-offset tensor, guarding sentinels
            return torch.where(x < INF_GUARD, x - expand_to(shift, x), x)

        clock = clock - shift
        epoch = state.epoch + do_shift.to(i32)
        timer = rb(timer)
        chaos_at = rb(chaos_at)
        part_at = rb(part_at)
        new_deliver = rb(new_deliver)
        if new_strag is not None:
            new_strag = new_strag._replace(deliver=rb(new_strag.deliver))
        new_nem = None
        if nst is not None:
            def pick(new, old):
                return old if new is None else new

            new_nem = NemesisState(
                crash_k=pick(nem_crash_k, nst.crash_k),
                wipe=pick(nem_wipe, nst.wipe),
                part_k=pick(nem_part_k, nst.part_k),
                clog_at=rb(pick(nem_clog_at, nst.clog_at)),
                clogged=pick(clogged, nst.clogged),
                clog_src=pick(clog_src, nst.clog_src),
                clog_dst=pick(clog_dst, nst.clog_dst),
                clog_k=pick(nem_clog_k, nst.clog_k),
                spike_at=rb(pick(nem_spike_at, nst.spike_at)),
                spiking=pick(spiking, nst.spiking),
                spike_k=pick(nem_spike_k, nst.spike_k),
                reconfig_at=rb(pick(nem_reconfig_at, nst.reconfig_at)),
                reconf_node=pick(nem_reconf_node, nst.reconf_node),
                reconfig_k=pick(nem_reconfig_k, nst.reconfig_k),
                disk_at=rb(pick(nem_disk_at, nst.disk_at)),
                disk_phase=pick(nem_disk_phase, nst.disk_phase),
                disk_k=pick(nem_disk_k, nst.disk_k),
                skew_ppm=nst.skew_ppm,
            )
        if spec.time_fields:
            node = node._replace(**{
                f: getattr(node, f) - expand_to(shift, getattr(node, f))
                for f in spec.time_fields
            })

        new_state = SimState(
            clock=clock,
            epoch=epoch,
            key=key,
            key0=state.key0,
            done=done,
            violated=violated,
            violation_at=violation_at,
            violation_epoch=violation_epoch,
            violation_step=violation_step,
            deadlocked=state.deadlocked | deadlocked,
            steps=state.steps + active.to(i32),
            events=state.events
            + has_msg.sum(dim=1, dtype=i32)
            + due_t.sum(dim=1, dtype=i32),
            overflow=overflow,
            dead_drops=state.dead_drops + dead_dropped,
            nonmember_drops=state.nonmember_drops + nonmember_dropped,
            unsynced_loss=(
                state.unsynced_loss if unsynced_lost is None
                else state.unsynced_loss + unsynced_lost
            ),
            fires=fires,
            occ_fired=occ_fired,
            alive_p=bitpack.pack_bits(alive),
            crashed=crashed,
            chaos_at=chaos_at,
            member_p=(
                state.member_p if member is None else bitpack.pack_bits(member)
            ),
            member_epoch=member_epoch,
            link_ok_p=bitpack.pack_bits(link_ok),
            partitioned=partitioned,
            part_at=part_at,
            timer=timer,
            node=node,
            dur=new_dur,
            msgs=MsgPool(
                valid_p=bitpack.pack_bits(new_valid),
                deliver=new_deliver,
                kind=new_kind,
                payload=new_payload,
            ),
            strag=new_strag, nem=new_nem, ctl=state.ctl, cov=None, lin=None,
            queue=None, refill=None,
        )
        if not record:
            return new_state

        # the step's trace record: effects only (suppressed triage
        # occurrences leave no row), event times in the post-rebase basis
        def none(dtype=i32):
            return torch.full((L,), -1 if dtype == i32 else False,
                              dtype=dtype, device=self.device)

        def node_or_none(fired, node):
            return torch.where(fired, node, -1)

        rec = dict(
            crash=none(), restart=none(), split=none(torch.bool),
            heal=none(torch.bool), side_mask=zl, clog_src=none(),
            clog_dst=none(), unclog=none(torch.bool),
            spike_on=none(torch.bool), spike_off=none(torch.bool),
            remove=none(), join=none(), disk_slow=none(), disk_crash=none(),
            disk_recover=none(), disk_torn=none(torch.bool),
        )
        if any_crash:
            rec.update(crash=node_or_none(ap_crash, victim),
                       restart=node_or_none(ap_restart, restart_node))
        if cfg.any_partition_enabled:
            rec.update(
                split=ap_split, heal=ap_heal,
                side_mask=(side.to(i32) * (1 << narange)).sum(dim=1, dtype=i32),
            )
        if clog_on:
            rec.update(clog_src=node_or_none(ap_clog, src_d),
                       clog_dst=node_or_none(ap_clog, dst_d), unclog=ap_unclog)
        if spike_on:
            rec.update(spike_on=ap_spike, spike_off=ap_unspike)
        if reconf_on:
            rec.update(remove=node_or_none(ap_remove, victim_d),
                       join=node_or_none(ap_join, join_node))
        if disk_on:
            rec.update(
                disk_slow=node_or_none(ap_dslow, dvictim),
                disk_crash=node_or_none(ap_dcrash, dvictim),
                disk_recover=node_or_none(ap_drecover, dvictim),
                disk_torn=(ap_dcrash | ap_drecover) & torn,
            )
        return new_state, TraceRecord(
            clock=clock, epoch=epoch, t_evt=t_evt - shift[:, None],
            msg_fired=has_msg, msg_src=m_src, msg_kind=m_kind,
            msg_payload=m_pay, timer_fired=due_t,
            violation=new_violation, deadlock=deadlocked, **rec,
        )

    def _fresh(self, rkeys, t_next, skew_ppm=None):
        """A node rebuilt through `spec.init` at the instant t_next [L] (a
        wipe-restart or a join), shifted as `_shift_fresh` does."""
        ns, timer = self.spec.init(rkeys, self._narange)
        return self._shift_fresh(ns, timer, t_next, skew_ppm)

    def _shift_fresh(self, ns, timer, t_next, skew_ppm=None):
        """Shift an init-style state (first timer relative) to the instant
        t_next [L]: the timer and the spec's absolute time fields move by
        t_next, and with `skew_ppm` [L,N] the timer's positive delay is
        stretched by each node's ppm."""
        timer = timer.to(torch.int32)
        tn = t_next[:, None]
        ok = (timer >= 0) & (timer < INF_GUARD)
        timer = torch.where(ok, timer + tn, timer)
        if skew_ppm is not None:
            d = timer - tn
            timer = torch.where(
                ok & (d > 0), tn + scale_delay_ppm(d, skew_ppm), timer
            )
        if self.spec.time_fields:
            ns = ns._replace(**{
                f: getattr(ns, f) + expand_to(t_next, getattr(ns, f))
                for f in self.spec.time_fields
            })
        return ns, timer

    # ------------------------------------------------------------------ run

    def _run(self, state: SimState, max_steps: int) -> SimState:
        """Step until every lane is done or `max_steps` steps ran: the JAX
        face's while-loop, with the all-done flag read every
        DONE_CHECK_STEPS steps (gated steps past it are no-ops)."""
        i = 0
        while i < max_steps:
            k = min(DONE_CHECK_STEPS, max_steps - i)
            for _ in range(k):
                state = self._step(state, gate_key=True)
            i += k
            if bool(state.done.all()):
                break
        return state

    def run(
        self, seeds, max_steps: int = 100_000,
        dispatch_steps: int = DEFAULT_DISPATCH_STEPS,
        ctl: Optional[TriageCtl] = None,
    ) -> SimState:
        """Run lanes until every lane is done (or max_steps). `ctl` gives
        a triage sim's lanes their shrink controls."""
        if dispatch_steps <= 0:
            raise ValueError(
                f"dispatch_steps must be positive, got {dispatch_steps}"
            )
        return self.run_state(self.init(seeds, ctl), max_steps, dispatch_steps)

    def run_state(
        self, state: SimState, max_steps: int,
        dispatch_steps: int = DEFAULT_DISPATCH_STEPS,
    ) -> SimState:
        """run()'s segment loop on a pre-built state: segments of
        `dispatch_steps`, stopping once every lane is done. The result
        equals one loop of `max_steps` (the JAX face's semantics)."""
        if dispatch_steps <= 0:
            raise ValueError(
                f"dispatch_steps must be positive, got {dispatch_steps}"
            )
        remaining = max_steps
        while remaining > 0:
            n = min(dispatch_steps, remaining)
            state = self._run(state, n)
            remaining -= n
            if bool(state.done.all()):
                break
        return state

    def run_steps(self, state: SimState, n_steps: int) -> SimState:
        """Exactly `n_steps` ungated steps (the JAX face's fixed-step scan:
        `key` keeps advancing after every lane is done)."""
        for _ in range(n_steps):
            state = self._step(state)
        return state

    def run_traced(
        self, seed: int, max_steps: int = 20_000,
        ctl: Optional[TriageCtl] = None,
    ):
        """Re-run one seed with full event capture (the violation
        microscope): (final state, TraceRecord with [T, 1, ...] leaves) of
        exactly T = max_steps ungated steps, the JAX face's traced scan.
        The records come out of the same step a sweep runs, so the traced
        lane is the batch lane's trajectory. `ctl` (triage sims) traces a
        shrunk candidate."""
        state = self.init([seed], ctl)
        recs = []
        while len(recs) < max_steps:
            state, rec = self._step(state, record=True)
            recs.append(rec)
            if len(recs) % DONE_CHECK_STEPS == 0 and bool(state.done.all()):
                break
        if len(recs) < max_steps:
            state, tail = self._idle_steps(state, max_steps - len(recs))
            recs.extend(tail)
        return state, TraceRecord(*(
            None if leaves[0] is None else torch.cat(
                [x.reshape((-1, state.clock.shape[0]) + x.shape[1:])
                 for x in leaves]
            )
            for leaves in zip(*recs)
        ))

    def _idle_steps(self, state: SimState, n: int):
        """`n` more ungated steps of a state whose lanes are all done, as
        (final state, list of [R, L, ...] records). Such a step changes
        `key` alone (key' = fold(key, 1)) and its record depends on the
        state and that key only, and lanes never interact, so R such steps
        run as ONE step of R*L lanes: lane block j holds the state under
        the key of idle step j. Same step, same records, R times fewer
        launches."""
        L = state.clock.shape[0]
        keys = [int(k) for k in state.key.cpu().tolist()]
        recs = []
        left = n
        while left > 0:
            R = min(left, IDLE_BLOCK_STEPS.get(self.device.type,
                                               IDLE_BLOCK_STEPS_DEFAULT))
            block = []  # [R, L] key chain of these steps
            for _ in range(R):
                block.append(keys)
                keys = [fold32(k, 1) for k in keys]
            rep_state = tree_map(
                lambda t: t.repeat((R,) + (1,) * (t.dim() - 1)), state
            )._replace(key=torch.as_tensor(
                np.asarray(block, np.int64).reshape(R * L),
                device=self.device,
            ))
            _, rec = self._step(rep_state, record=True)
            recs.append(rec)
            left -= R
        return state._replace(key=torch.as_tensor(
            np.asarray(keys, np.int64), device=self.device
        )), recs


def abs_time_us(state: SimState) -> np.ndarray:
    """Absolute virtual time per lane as int64 numpy (epoch * REBASE + off)."""
    return (
        state.epoch.cpu().numpy().astype(np.int64) * REBASE_US
        + state.clock.cpu().numpy().astype(np.int64)
    )


def _sum64(x: torch.Tensor, axis=0):
    """Exact lane sum of a non-negative i32 tensor as two u32 partials
    (16-bit halves), the JAX face's reduction; both partials stay below
    2^32 only for lanes <= 65536, so a bigger batch is refused."""
    if x.shape[axis] > 65536:
        raise ValueError(
            f"_sum64: lane axis {x.shape[axis]} > 65536 would overflow "
            "the u32 partial sums — summarize in chunks"
        )
    xu = prng.u32(x)
    return (
        torch.sum(xu >> 16, dim=axis),
        torch.sum(xu & 0xFFFF, dim=axis),
    )


def _join64(hi, lo) -> int:
    return int(
        np.asarray(hi.cpu() if isinstance(hi, torch.Tensor) else hi, np.int64)
        * 65536
        + np.asarray(lo.cpu() if isinstance(lo, torch.Tensor) else lo, np.int64)
    )


def _summary_reduction(state: SimState) -> dict:
    """Every per-summary reduction, on the device."""
    violated = state.violated
    return {
        "violations": violated.sum(),
        "deadlocked": state.deadlocked.sum(),
        "events64": _sum64(state.events),
        "overflow64": _sum64(state.overflow),
        "dead_drops64": _sum64(state.dead_drops),
        "nonmember_drops64": _sum64(state.nonmember_drops),
        "unsynced_loss64": _sum64(state.unsynced_loss),
        "steps64": _sum64(state.steps),
        "epoch64": _sum64(state.epoch),
        "clock64": _sum64(state.clock),
        "first_violation_step": torch.where(
            violated, state.violation_step, 2**31 - 1
        ).amin(),
        "fires64": _sum64(state.fires, axis=0),
        # per-(clause row, occurrence bit) lane counts [R, 32]
        "occ_counts": None if state.occ_fired is None else (
            (state.occ_fired[:, :, None] >> torch.arange(
                32, device=state.occ_fired.device
            )) & 1
        ).sum(dim=0),
    }


def summarize(state: SimState, spec: Optional[ProtocolSpec] = None) -> dict:
    """Host-side summary of a finished batch; the JAX face's keys and
    values. Pass the spec to include its `lane_metrics` diagnostics."""
    red = _summary_reduction(state)
    violated = state.violated.cpu().numpy()
    L = int(violated.shape[0])
    steps_total = _join64(*red["steps64"])
    vt_total_us = (
        _join64(*red["epoch64"]) * REBASE_US + _join64(*red["clock64"])
    )
    out = {
        "lanes": L,
        "violations": int(red["violations"]),
        "violation_lanes": np.nonzero(violated)[0].tolist()[:32],
        "deadlocked": int(red["deadlocked"]),
        "total_events": _join64(*red["events64"]),
        "total_overflow": _join64(*red["overflow64"]),
        "total_dead_drops": _join64(*red["dead_drops64"]),
        "total_nonmember_drops": _join64(*red["nonmember_drops64"]),
        "total_unsynced_loss": _join64(*red["unsynced_loss64"]),
        "mean_steps": steps_total / L,
        "mean_virtual_secs": vt_total_us / L / 1e6,
    }
    if out["violations"]:
        out["first_violation_step"] = int(red["first_violation_step"])
    f_hi, f_lo = red["fires64"]
    f_hi = f_hi.cpu().numpy().astype(np.int64)
    f_lo = f_lo.cpu().numpy().astype(np.int64)
    for i, name in enumerate(FIRE_KINDS):
        out[f"fires_{name}"] = int(f_hi[i] * 65536 + f_lo[i])
    # per-occurrence fire counts (nemesis schedule clauses only): lanes in
    # which occurrence k of the clause applied
    if red["occ_counts"] is not None:
        occ_counts = red["occ_counts"].cpu().numpy()
        for row, clause in enumerate(OCC_CLAUSES):
            for k in range(32):
                n = int(occ_counts[row, k])
                if n:
                    out[f"occfires_{clause}_k{k}"] = n
    if spec is not None and spec.lane_metrics is not None:
        for name, arr in spec.lane_metrics(state.node).items():
            a = arr.cpu().numpy()
            if a.dtype == np.bool_:
                out[name] = int(a.sum())
            else:
                out[name] = float(a.mean())
    return out
