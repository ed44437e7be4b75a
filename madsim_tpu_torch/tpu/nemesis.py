"""Nemesis, tensorized: FaultPlan -> the batched engine's `nem_*` knobs.

The port of the device face of `madsim_tpu/tpu/nemesis.py`:

  * `compile_plan(plan, base)` lowers a FaultPlan onto the `nem_*`
    SimConfig knobs that `BatchedSim` threads through its state and step
    (byte-equal `to_toml()` to the JAX face's for the same plan);
  * `enabled_fire_kinds(cfg)` names the FIRE_KINDS a config can produce;
  * `coverage_report(summary, cfg)` renders the chaos-coverage line of a
    batch summary, flagging enabled clauses that never fired.

`device_chaos_events` and `assert_device_matches_schedule` need the
traced step and the pure host schedule, and wait for ROADMAP queue 1
item 9.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from ..nemesis import (
    ClockSkew,
    Crash,
    DiskFault,
    Duplicate,
    FaultPlan,
    LatencySpike,
    LinkClog,
    MsgLoss,
    OCC_CLAUSES,
    Partition,
    Reconfig,
    Reorder,
)
from .spec import SimConfig


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
