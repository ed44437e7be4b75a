"""Nemesis, tensorized: FaultPlan -> the batched engine's `nem_*` knobs.

The port of the device face of `madsim_tpu/tpu/nemesis.py`:

  * `compile_plan(plan, base)` lowers a FaultPlan onto the `nem_*`
    SimConfig knobs that `BatchedSim` threads through its state and step
    (byte-equal `to_toml()` to the JAX face's for the same plan);
  * `enabled_fire_kinds(cfg)` names the FIRE_KINDS a config can produce;
  * `coverage_report(summary, cfg)` renders the chaos-coverage line of a
    batch summary, flagging enabled clauses that never fired.

  * `device_chaos_events(sim, seed)` reads one seed's chaos stream off
    the traced step, and `assert_device_matches_schedule` holds it equal,
    event for event, to the plan's pure schedule (occurrence-filtered
    under a triage ctl): the twin check that survives shrinking;
  * `genome_hash64` and `genome_ctl_rows` are the device faces of the
    explorer's genome hash and ctl encode, which the device-resident
    search loop's generation boundary computes on tensors.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..nemesis import (
    ClockSkew,
    Crash,
    DiskFault,
    Duplicate,
    FaultPlan,
    GENOME_H1,
    GENOME_H2,
    LatencySpike,
    LinkClog,
    MsgLoss,
    NemesisEvent,
    OCC_CLAUSES,
    Partition,
    Reconfig,
    Reorder,
    filter_schedule,
)
from .spec import REBASE_US, SimConfig


def compile_plan(plan: FaultPlan, base: Optional[SimConfig] = None) -> SimConfig:
    """Lower a FaultPlan onto the engine's `nem_*` knobs.

    A plan that provides a Crash or Partition clause CLEARS the base
    config's legacy trajectory-coupled counterpart (`crash_interval_*` /
    `partition_interval_*`): one machinery, one time source."""
    cfg = base or SimConfig()
    kw: Dict[str, Any] = {}
    crash = plan.get(Crash)
    if crash is not None:
        kw.update(
            crash_interval_lo_us=0,
            crash_interval_hi_us=0,
            nem_crash_interval_lo_us=crash.interval_lo_us,
            nem_crash_interval_hi_us=crash.interval_hi_us,
            nem_crash_down_lo_us=crash.down_lo_us,
            nem_crash_down_hi_us=crash.down_hi_us,
            nem_crash_wipe_rate=crash.wipe_rate,
        )
    part = plan.get(Partition)
    if part is not None:
        kw.update(
            partition_interval_lo_us=0,
            partition_interval_hi_us=0,
            nem_partition_interval_lo_us=part.interval_lo_us,
            nem_partition_interval_hi_us=part.interval_hi_us,
            nem_partition_heal_lo_us=part.heal_lo_us,
            nem_partition_heal_hi_us=part.heal_hi_us,
        )
    clog = plan.get(LinkClog)
    if clog is not None:
        kw.update(
            nem_clog_interval_lo_us=clog.interval_lo_us,
            nem_clog_interval_hi_us=clog.interval_hi_us,
            nem_clog_heal_lo_us=clog.heal_lo_us,
            nem_clog_heal_hi_us=clog.heal_hi_us,
        )
    spike = plan.get(LatencySpike)
    if spike is not None:
        kw.update(
            nem_spike_interval_lo_us=spike.interval_lo_us,
            nem_spike_interval_hi_us=spike.interval_hi_us,
            nem_spike_duration_lo_us=spike.duration_lo_us,
            nem_spike_duration_hi_us=spike.duration_hi_us,
            nem_spike_extra_us=spike.extra_us,
        )
    loss = plan.get(MsgLoss)
    if loss is not None:
        kw.update(nem_loss_rate=loss.rate)
    dup = plan.get(Duplicate)
    if dup is not None:
        kw.update(nem_dup_rate=dup.rate)
    ro = plan.get(Reorder)
    if ro is not None:
        kw.update(nem_reorder_rate=ro.rate, nem_reorder_window_us=ro.window_us)
    skew = plan.get(ClockSkew)
    if skew is not None:
        kw.update(nem_skew_max_ppm=skew.max_ppm)
    reconf = plan.get(Reconfig)
    if reconf is not None:
        kw.update(
            nem_reconfig_interval_lo_us=reconf.interval_lo_us,
            nem_reconfig_interval_hi_us=reconf.interval_hi_us,
            nem_reconfig_down_lo_us=reconf.down_lo_us,
            nem_reconfig_down_hi_us=reconf.down_hi_us,
        )
    disk = plan.get(DiskFault)
    if disk is not None:
        kw.update(
            nem_disk_interval_lo_us=disk.interval_lo_us,
            nem_disk_interval_hi_us=disk.interval_hi_us,
            nem_disk_slow_lo_us=disk.slow_lo_us,
            nem_disk_slow_hi_us=disk.slow_hi_us,
            nem_disk_down_lo_us=disk.down_lo_us,
            nem_disk_down_hi_us=disk.down_hi_us,
            nem_disk_torn_rate=disk.torn_rate,
            nem_disk_extra_us=disk.extra_us,
        )
    return dataclasses.replace(cfg, **kw)


# normalized comparison tuples: (t_us, kind, a, b); wipe flags, skew ppm
# and spike magnitudes are schedule-side detail the trace does not carry
_CHAOS_KINDS = (
    "crash", "restart", "split", "heal", "clog", "unclog",
    "spike_on", "spike_off", "remove", "join",
    "disk_slow", "disk_crash", "disk_recover",
)


def schedule_tuples(
    events: Sequence[NemesisEvent], horizon_us: Optional[int] = None
) -> List[Tuple[int, str, int, int]]:
    """Normalize a pure schedule for stream comparison (skew rows are t=0
    assignments, not events: compare those through plan.skew_ppm)."""
    out = []
    for ev in events:
        if ev.kind == "skew":
            continue
        if horizon_us is not None and ev.t_us >= horizon_us:
            continue
        if ev.kind in ("split", "heal"):
            out.append((ev.t_us, ev.kind, ev.side_mask, -1))
        elif ev.kind in ("clog", "unclog"):
            out.append((ev.t_us, ev.kind, ev.node, ev.dst))
        elif ev.kind in ("spike_on", "spike_off"):
            out.append((ev.t_us, ev.kind, -1, -1))
        elif ev.kind in ("disk_crash", "disk_recover"):
            # the torn flag is part of the stream contract
            out.append((ev.t_us, ev.kind, ev.node, int(ev.torn)))
        else:  # crash / restart / remove / join / disk_slow
            out.append((ev.t_us, ev.kind, ev.node, -1))
    return out


def device_chaos_events(
    sim, seed: int, max_steps: int = 20_000,
    horizon_us: Optional[int] = None, ctl=None,
) -> List[Tuple[int, str, int, int]]:
    """One seed's schedule-level chaos stream as the engine executed it,
    in `schedule_tuples` form, read off the traced step. With `horizon_us`
    (pass the config's horizon) events at or past it are dropped: the
    engine fires at most one event past the horizon before the lane
    freezes. `ctl` (triage sims) reads a shrunk candidate's stream."""
    from .trace import trace_seed

    clog_pair = (-1, -1)
    out: List[Tuple[int, str, int, int]] = []
    for ev in trace_seed(sim, seed, max_steps=max_steps, ctl=ctl):
        if ev.kind not in _CHAOS_KINDS:
            continue
        if horizon_us is not None and ev.t_us >= horizon_us:
            continue
        if ev.kind in ("crash", "restart", "remove", "join", "disk_slow"):
            out.append((ev.t_us, ev.kind, ev.node, -1))
        elif ev.kind in ("disk_crash", "disk_recover"):
            out.append((ev.t_us, ev.kind, ev.node, int(ev.detail == "torn")))
        elif ev.kind in ("split", "heal"):
            out.append((ev.t_us, ev.kind, _side_mask_of(ev), -1))
        elif ev.kind == "clog":
            clog_pair = (ev.node, ev.src)
            out.append((ev.t_us, "clog", ev.node, ev.src))
        elif ev.kind == "unclog":
            out.append((ev.t_us, "unclog", clog_pair[0], clog_pair[1]))
        else:
            out.append((ev.t_us, ev.kind, -1, -1))
    return out


def _side_mask_of(ev) -> int:
    """A split event's side-A mask, parsed back from its trace detail
    (heal events record none: -2)."""
    if ev.kind == "heal":
        return -2
    a = ev.detail.split("|")[0].strip()
    mask = 0
    for tok in a.strip("[] ").split(","):
        tok = tok.strip()
        if tok:
            mask |= 1 << int(tok)
    return mask


def assert_device_matches_schedule(
    sim, plan: FaultPlan, seed: int, horizon_us: int,
    max_steps: int = 20_000, ctl=None, occ_off=None,
) -> int:
    """The twin check: the engine's chaos stream for `seed` equals the pure
    schedule event for event (times, kinds, victims, sides, clog pairs)
    below the horizon; returns the number of compared events. With `ctl`
    and `occ_off` (triage) the device runs the shrunk candidate and the
    schedule is occurrence-filtered the same way; pass a plan already
    stripped of dropped clauses."""
    want = schedule_tuples(
        filter_schedule(
            plan.schedule(seed, horizon_us, sim.spec.n_nodes), occ_off
        ),
        horizon_us,
    )
    got = device_chaos_events(
        sim, seed, max_steps=max_steps, horizon_us=horizon_us, ctl=ctl
    )
    # heal events carry no mask in the trace, and same-microsecond ties
    # across clauses come in clause order from the trace but sorted from
    # the schedule: a sorted compare is order-exact wherever times differ
    def norm(evs):
        return sorted(
            (t, k, -2 if k == "heal" else a, b) for (t, k, a, b) in evs
        )

    if norm(want) != norm(got):
        for i, (w, g) in enumerate(zip(norm(want), norm(got))):
            if w != g:
                raise AssertionError(
                    f"chaos stream diverges at event {i}: schedule {w} vs "
                    f"device {g}\n  full schedule: {want}\n  full device: "
                    f"{got}"
                )
        raise AssertionError(
            f"chaos stream length mismatch: schedule {len(want)} events vs "
            f"device {len(got)}\n  schedule: {want}\n  device: {got}"
        )
    return len(want)


def enabled_fire_kinds(cfg: SimConfig) -> Tuple[str, ...]:
    """Which FIRE_KINDS this config can produce (legacy knobs included)."""
    kinds: List[str] = []
    if cfg.any_crash_enabled:
        kinds += ["crash", "restart"]
        if cfg.nem_crash_enabled and cfg.nem_crash_wipe_rate > 0:
            kinds.append("wipe")
    if cfg.any_partition_enabled:
        kinds += ["partition", "heal"]
    if cfg.nem_clog_enabled:
        kinds.append("clog")
    if cfg.nem_spike_enabled:
        kinds.append("spike")
    if cfg.nem_loss_rate > 0:
        kinds.append("loss")  # the MsgLoss clause; base loss_rate is ambience
    if cfg.nem_dup_rate > 0:
        kinds.append("dup")
    if cfg.nem_reorder_rate > 0:
        kinds.append("reorder")
    if cfg.nem_skew_enabled:
        kinds.append("skew")
    if cfg.nem_reconfig_enabled:
        kinds += ["remove", "join"]
    if cfg.nem_disk_enabled:
        kinds += ["disk_slow", "disk_crash", "disk_recover"]
    return tuple(kinds)


def occurrence_fires(summary: Dict[str, Any]) -> Dict[str, Dict[int, int]]:
    """Per-clause, per-occurrence lane counts from a batch summary's
    `occfires_<clause>_k<k>` keys."""
    out: Dict[str, Dict[int, int]] = {}
    for key, v in summary.items():
        if not key.startswith("occfires_"):
            continue
        clause, _, kpart = key[len("occfires_"):].rpartition("_k")
        out.setdefault(clause, {})[int(kpart)] = int(v)
    return out


def coverage_report(summary: Dict[str, Any], cfg: SimConfig) -> str:
    """The chaos-coverage line for a batch summary: an enabled clause with
    zero fires over a whole seed batch is dead chaos; schedule clauses
    also report their per-occurrence lane counts."""
    lanes = summary.get("lanes", "?")
    parts = []
    dead = []
    for kind in enabled_fire_kinds(cfg):
        n = int(summary.get(f"fires_{kind}", 0))
        parts.append(f"{kind} {n}")
        if n == 0:
            dead.append(kind)
    if not parts:
        return f"seed batch of {lanes}: no chaos clauses enabled"
    line = f"seed batch of {lanes}: " + ", ".join(parts)
    if dead:
        line += " => DEAD CLAUSE: " + ", ".join(dead)
    occ = occurrence_fires(summary)
    for clause in OCC_CLAUSES:
        ks = occ.get(clause)
        if ks:
            line += f"\n  {clause} occurrences: " + ", ".join(
                f"k{k} {ks[k]}" for k in sorted(ks)
            )
    return line


# --------------------------------------------------------------------------
# device-loop genome faces
# --------------------------------------------------------------------------


def genome_hash64(seed, off, occ, rate_scale, horizon_us):
    """(h1, h2), the 64-bit genome-dedup hash, DEVICE face: u32 values
    as int64 tensors.

    Two fold chains from the `GENOME_H1`/`GENOME_H2` roots over the genome
    words (seed, off, the occ rows, the float32 BIT PATTERNS of the rate
    rows, the raw horizon), bit-equal to the host `explore.genome_hash64`
    and to the JAX face's device face, so a hash collision hits the host
    loop and the device loop alike. Broadcasts over leading axes (occ:
    [..., n_occ], rate_scale: [..., n_rate]); int32 words reinterpret
    their two's complement bits."""
    import torch

    from . import prng

    def t(x, dtype):
        return x if isinstance(x, torch.Tensor) else torch.as_tensor(
            x, dtype=dtype)

    occ = t(occ, torch.int32)
    rs = t(rate_scale, torch.float32).to(torch.float32)
    words = [t(seed, torch.int64), t(off, torch.int32)]
    words += [occ[..., i] for i in range(occ.shape[-1])]
    words += [rs[..., i].view(torch.int32) for i in range(rs.shape[-1])]
    words.append(t(horizon_us, torch.int32))
    h1, h2 = GENOME_H1, GENOME_H2
    for w in words:
        w = prng.u32(w)
        h1 = prng.fold(h1, w)
        h2 = prng.fold(h2, w)
    return prng.mix(h1), prng.mix(h2)


def genome_ctl_rows(horizon_raw, full_horizon_us: int):
    """(h_epoch, h_off) int32: the genome -> TriageCtl horizon encode,
    device face of `explore.ctl_for`'s rows. A raw genome horizon of 0
    decodes to the config's full horizon, then splits by REBASE_US; the
    encode is lossy, which is why the device loop keeps the raw horizons
    beside the queue."""
    import torch

    h = torch.as_tensor(horizon_raw).to(torch.int32)
    h_eff = torch.where(h == 0, int(full_horizon_us), h).to(torch.int32)
    return h_eff // REBASE_US, h_eff % REBASE_US
