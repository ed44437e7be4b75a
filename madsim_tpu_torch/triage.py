"""Triage: batched shrinking of violating seeds into repro bundles.

The port of `madsim_tpu/triage.py`. A sweep finds violating seeds; this
module reduces one to a minimal set of fault clauses and occurrences and
writes a portable JSON `ReproBundle` that replays at the same step and
virtual time (`python -m madsim_tpu_torch.repro bundle.json`), on this
face or the JAX face: the bundle is field for field the one the JAX face
writes for the same workload, config and seed.

Shrinking is ddmin over three axes, resting on the nemesis guarantee that
fault draws are pure in (seed, clause site, occurrence), so suppressing one
fault never moves another:

  (a) clauses and single clause occurrences, one ddmin atom each;
  (b) the horizon, truncated just past the baseline violation;
  (c) the rates of surviving message clauses (the coin is
      `u < rate * scale`, so a scaled lane's fires are a subset).

Every candidate of a ddmin generation is a lane of one batch of
`BatchedSim(..., triage=True)`, whose per-lane `TriageCtl` switches the
faults off: a whole shrink costs a handful of batched dispatches.

The port evaluates generations on the chunked path (lanes padded to
`lane_width`, the same seed in every lane). The JAX face defaults to its
continuously batched evaluator (`refill=True`); the port has no refill
plane yet (ROADMAP queue 1 item 11), so its `shrink_seed` defaults to
`refill=False`. Verdicts, and so bundles, are bit-identical either way.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .nemesis import (
    CLAUSE_OF_EVENT,
    ClockSkew,
    Crash,
    DiskFault,
    Duplicate,
    FaultPlan,
    LatencySpike,
    LinkClog,
    MsgLoss,
    OCC_CLAUSES,
    OCC_ROW,
    Partition,
    RATE_CLAUSES,
    RATE_ROW,
    Reconfig,
    Reorder,
    TRIAGE_BIT,
)

# v2 added campaign provenance fields, v3 an optional causal digest; every
# version reads back with the newer fields defaulted
BUNDLE_FORMAT = "madsim-tpu-repro/3"
BUNDLE_FORMATS_READ = (
    "madsim-tpu-repro/1", "madsim-tpu-repro/2", BUNDLE_FORMAT,
)

# an atom is (clause_name, occurrence k | None); k=None means the whole
# clause (message-level clauses, skew, wipe, and legacy chaos knobs)
Atom = Tuple[str, Optional[int]]

_CLAUSE_TYPES = {
    "crash": Crash, "partition": Partition, "clog": LinkClog,
    "spike": LatencySpike, "skew": ClockSkew, "loss": MsgLoss,
    "dup": Duplicate, "reorder": Reorder, "reconfig": Reconfig,
    "disk": DiskFault,
}


class NotReproducible(AssertionError):
    """The seed did not violate under the full configuration: nothing to
    shrink."""


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to madsim_tpu_torch yet "
        f"(ROADMAP.md queue 1, {item})"
    )


# --------------------------------------------------------------------------
# FaultPlan <-> SimConfig <-> JSON plumbing
# --------------------------------------------------------------------------


def plan_from_config(cfg, name: str = "recovered") -> FaultPlan:
    """Reconstruct the FaultPlan a SimConfig was compiled from
    (compile_plan is a bijection clause by clause). Legacy knobs
    (crash_interval_*, partition_interval_*) have no plan face: they
    shrink clause-level through the ctl and ride the config TOML."""
    clauses: list = []
    if cfg.nem_crash_enabled:
        clauses.append(Crash(
            interval_lo_us=cfg.nem_crash_interval_lo_us,
            interval_hi_us=cfg.nem_crash_interval_hi_us,
            down_lo_us=cfg.nem_crash_down_lo_us,
            down_hi_us=cfg.nem_crash_down_hi_us,
            wipe_rate=cfg.nem_crash_wipe_rate,
        ))
    if cfg.nem_partition_enabled:
        clauses.append(Partition(
            interval_lo_us=cfg.nem_partition_interval_lo_us,
            interval_hi_us=cfg.nem_partition_interval_hi_us,
            heal_lo_us=cfg.nem_partition_heal_lo_us,
            heal_hi_us=cfg.nem_partition_heal_hi_us,
        ))
    if cfg.nem_clog_enabled:
        clauses.append(LinkClog(
            interval_lo_us=cfg.nem_clog_interval_lo_us,
            interval_hi_us=cfg.nem_clog_interval_hi_us,
            heal_lo_us=cfg.nem_clog_heal_lo_us,
            heal_hi_us=cfg.nem_clog_heal_hi_us,
        ))
    if cfg.nem_spike_enabled:
        clauses.append(LatencySpike(
            interval_lo_us=cfg.nem_spike_interval_lo_us,
            interval_hi_us=cfg.nem_spike_interval_hi_us,
            duration_lo_us=cfg.nem_spike_duration_lo_us,
            duration_hi_us=cfg.nem_spike_duration_hi_us,
            extra_us=cfg.nem_spike_extra_us,
        ))
    if cfg.nem_loss_rate > 0:
        clauses.append(MsgLoss(rate=cfg.nem_loss_rate))
    if cfg.nem_dup_enabled:
        clauses.append(Duplicate(rate=cfg.nem_dup_rate))
    if cfg.nem_reorder_rate > 0:
        clauses.append(Reorder(
            rate=cfg.nem_reorder_rate, window_us=cfg.nem_reorder_window_us
        ))
    if cfg.nem_skew_enabled:
        clauses.append(ClockSkew(max_ppm=cfg.nem_skew_max_ppm))
    if cfg.nem_reconfig_enabled:
        clauses.append(Reconfig(
            interval_lo_us=cfg.nem_reconfig_interval_lo_us,
            interval_hi_us=cfg.nem_reconfig_interval_hi_us,
            down_lo_us=cfg.nem_reconfig_down_lo_us,
            down_hi_us=cfg.nem_reconfig_down_hi_us,
        ))
    if cfg.nem_disk_enabled:
        clauses.append(DiskFault(
            interval_lo_us=cfg.nem_disk_interval_lo_us,
            interval_hi_us=cfg.nem_disk_interval_hi_us,
            slow_lo_us=cfg.nem_disk_slow_lo_us,
            slow_hi_us=cfg.nem_disk_slow_hi_us,
            down_lo_us=cfg.nem_disk_down_lo_us,
            down_hi_us=cfg.nem_disk_down_hi_us,
            torn_rate=cfg.nem_disk_torn_rate,
            extra_us=cfg.nem_disk_extra_us,
        ))
    return FaultPlan(clauses=tuple(clauses), name=name)


def plan_to_json(plan: FaultPlan) -> dict:
    return {
        "name": plan.name,
        "clauses": [
            {"type": type(c).__name__, **dataclasses.asdict(c)}
            for c in plan.clauses
        ],
    }


def plan_from_json(doc: dict) -> FaultPlan:
    by_name = {cls.__name__: cls for cls in _CLAUSE_TYPES.values()}
    clauses = []
    for c in doc.get("clauses", []):
        kw = dict(c)
        cls = by_name[kw.pop("type")]
        clauses.append(cls(**kw))
    return FaultPlan(clauses=tuple(clauses), name=doc.get("name", "bundle"))


def shrink_plan(
    plan: FaultPlan, dropped: Sequence[str], rate_scale: Dict[str, float],
) -> FaultPlan:
    """The readable face of a shrink outcome: dropped clauses removed,
    surviving message rates scaled (occurrence masks live beside the plan,
    in ReproBundle.occ_off)."""
    dropped = set(dropped)
    out = []
    for c in plan.clauses:
        name = next(n for n, cls in _CLAUSE_TYPES.items() if isinstance(c, cls))
        if name in dropped:
            continue
        if isinstance(c, Crash) and "wipe" in dropped and c.wipe_rate > 0:
            c = dataclasses.replace(c, wipe_rate=0.0)
        if name in RATE_CLAUSES and rate_scale.get(name, 1.0) != 1.0:
            c = dataclasses.replace(c, rate=c.rate * rate_scale[name])
        out.append(c)
    return FaultPlan(clauses=tuple(out), name=f"{plan.name}-shrunk")


def _ctl_of_rows(rows: Sequence[Tuple[int, List[int], List[float], int]]):
    """One TriageCtl (CPU tensors) with a lane per candidate row
    (off_bits, occ_masks, rate_scales, horizon_us)."""
    from .tpu.engine import TriageCtl
    from .tpu.spec import REBASE_US

    def i32(xs):
        return torch.as_tensor(np.asarray(xs, np.int64).astype(np.int32))

    return TriageCtl(
        off=i32([r[0] for r in rows]),
        occ=i32([r[1] for r in rows]),
        rate_scale=torch.as_tensor(np.asarray([r[2] for r in rows], np.float32)),
        h_epoch=i32([r[3] // REBASE_US for r in rows]),
        h_off=i32([r[3] % REBASE_US for r in rows]),
    )


def build_ctl(
    L: int,
    horizon_us: int,
    off_clauses: Sequence[str] = (),
    occ_off: Optional[Dict[str, int]] = None,
    rate_scale: Optional[Dict[str, float]] = None,
):
    """A uniform TriageCtl (every lane identical): the replay shape."""
    row = _atom_rows([], [(n, None) for n in off_clauses], horizon_us,
                     rate_scale=rate_scale, extra_occ=occ_off)
    return _ctl_of_rows([row] * L)


# --------------------------------------------------------------------------
# the repro bundle
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ReproBundle:
    """A portable, self-describing repro of one shrunk violation.

    `config_toml` is the full compiled SimConfig the shrinker ran under:
    dropped clauses are expressed through the ctl fields (`dropped_clauses`,
    `occ_off`, `rate_scale`), never by removing their knobs. `plan` is the
    shrunk FaultPlan, for reading and for the schedule twin."""

    seed: int
    spec_ref: Optional[str]  # "module:factory" rebuilding the ProtocolSpec
    spec_kwargs: Dict[str, Any]
    spec_name: str
    n_nodes: int
    config_toml: str
    config_hash: str
    violation_kind: str  # "invariant"
    violation_step: int  # first violating step
    violation_t_us: int  # absolute virtual time of the violation
    dropped_clauses: List[str]
    occ_off: Dict[str, int]
    rate_scale: Dict[str, float]
    horizon_us: int  # bisected: just past the violation
    max_steps: int
    plan: dict  # shrunk FaultPlan (plan_to_json)
    trace_tail: List[str]
    format: str = BUNDLE_FORMAT
    # -- v2: campaign provenance (None outside a campaign) --
    signature: Optional[str] = None
    campaign: Optional[str] = None
    generation: Optional[int] = None
    # -- v3: optional causal digest (None without lineage) --
    causal: Optional[Dict[str, Any]] = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2) + "\n"

    @staticmethod
    def from_json(text: str) -> "ReproBundle":
        doc = json.loads(text)
        fmt = doc.get("format", "")
        if fmt not in BUNDLE_FORMATS_READ:
            raise ValueError(
                f"unsupported bundle format {fmt!r} "
                f"(want one of {list(BUNDLE_FORMATS_READ)})"
            )
        fields = {f.name for f in dataclasses.fields(ReproBundle)}
        unknown = set(doc) - fields
        if unknown:
            raise ValueError(f"unknown bundle fields: {sorted(unknown)}")
        # the format string is kept as read: it records what wrote the file
        return ReproBundle(**doc)

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path

    @staticmethod
    def load(path: str) -> "ReproBundle":
        with open(path) as f:
            return ReproBundle.from_json(f.read())

    def ctl(self, L: int = 1):
        """The TriageCtl that replays exactly the verified candidate."""
        return build_ctl(
            L, self.horizon_us, self.dropped_clauses, self.occ_off,
            self.rate_scale,
        )

    def config(self):
        from .tpu.spec import simconfig_from_toml

        cfg = simconfig_from_toml(self.config_toml)
        if cfg.hash() != self.config_hash:
            raise ValueError(
                "bundle config hash mismatch: the TOML was edited or the "
                f"SimConfig schema drifted ({cfg.hash()} != {self.config_hash})"
            )
        return cfg

    def shrunk_plan(self) -> FaultPlan:
        return plan_from_json(self.plan)

    def repro_command(self, path: str) -> str:
        return f"python -m madsim_tpu_torch.repro {path}"


# --------------------------------------------------------------------------
# batched ddmin
# --------------------------------------------------------------------------


def ddmin(
    atoms: List[Atom],
    batch_violates: Callable[[List[List[Atom]]], List[bool]],
) -> List[Atom]:
    """Zeller/Hildebrandt ddmin, every generation's subsets and complements
    evaluated by one `batch_violates` call (one batched dispatch). Returns
    a 1-minimal kept set: it violates, and without any single atom it
    does not."""
    cur = list(atoms)
    if not cur:
        return cur
    if len(cur) == 1:
        # the one generation ddmin proper never tests: nothing at all
        if batch_violates([[]])[0]:
            return []
        return cur
    n = 2
    while len(cur) >= 2:
        chunk = -(-len(cur) // n)
        subsets = [cur[i:i + chunk] for i in range(0, len(cur), chunk)]
        cands: List[List[Atom]] = list(subsets)
        compl: List[List[Atom]] = []
        if len(subsets) > 2:
            compl = [
                [a for s in (subsets[:i] + subsets[i + 1:]) for a in s]
                for i in range(len(subsets))
            ]
        res = batch_violates(cands + compl)
        hit = next((i for i, r in enumerate(res[: len(cands)]) if r), None)
        if hit is not None:
            cur = cands[hit]
            n = 2
            continue
        chit = next((i for i, r in enumerate(res[len(cands):]) if r), None)
        if chit is not None:
            cur = compl[chit]
            n = max(n - 1, 2)
            continue
        if n >= len(cur):
            break
        n = min(len(cur), 2 * n)
    return cur


# --------------------------------------------------------------------------
# the shrinker
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ShrinkResult:
    bundle: ReproBundle
    bundle_path: Optional[str]
    dispatches: int  # batched device evaluations the whole shrink cost
    original_atoms: int
    kept_atoms: List[Atom]

    @property
    def repro_command(self) -> str:
        if self.bundle_path:
            return self.bundle.repro_command(self.bundle_path)
        return f"seed={self.bundle.seed} (bundle not written)"


class _Eval:
    """Evaluates shrink candidates as lanes of batched dispatches: rows pad
    to `lane_width` (pad lanes replay the first row; their results are
    discarded), every lane runs the same seed, and a generation larger
    than `lane_width` takes several dispatches."""

    def __init__(
        self, sim, seed: int, max_steps: int, lane_width: int,
        refill: bool = False, mesh=None,
    ):
        if refill:
            raise _not_ported("the refill shrink evaluator (refill=True)",
                              "item 11")
        if mesh is not None:
            raise _not_ported("a sharded shrink (mesh=...)", "item 14")
        self.sim = sim
        self.seed = int(seed)
        self.max_steps = int(max_steps)
        self.lane_width = max(2, int(lane_width))
        self.dispatches = 0

    def run(
        self, rows: List[Tuple[int, List[int], List[float], int]]
    ) -> List[Dict[str, int]]:
        """rows: (off_bits, occ_masks, rate_scales, horizon_us) per
        candidate. Returns per-candidate {violated, step, t_us}."""
        from .tpu.spec import REBASE_US

        out: List[Dict[str, int]] = []
        for lo in range(0, len(rows), self.lane_width):
            part = rows[lo:lo + self.lane_width]
            n = len(part)
            part = part + [part[0]] * (self.lane_width - n)
            seeds = np.full((self.lane_width,), self.seed, np.uint32)
            state = self.sim.run(
                seeds, max_steps=self.max_steps, ctl=_ctl_of_rows(part)
            )
            self.dispatches += 1
            violated = state.violated.cpu().numpy()
            step = state.violation_step.cpu().numpy()
            t_us = (
                state.violation_epoch.cpu().numpy().astype(np.int64)
                * REBASE_US
                + state.violation_at.cpu().numpy().astype(np.int64)
            )
            for i in range(n):
                out.append({
                    "violated": bool(violated[i]),
                    "step": int(step[i]),
                    "t_us": int(t_us[i]) if violated[i] else -1,
                })
        return out


def _atom_rows(
    kept: Sequence[Atom], all_atoms: Sequence[Atom], horizon_us: int,
    rate_scale: Optional[Dict[str, float]] = None,
    extra_occ: Optional[Dict[str, int]] = None,
) -> Tuple[int, List[int], List[float], int]:
    """One candidate row: every atom not in `kept` is suppressed.
    `extra_occ` (clause -> occurrence bitmask) is ORed in unconditionally,
    so a base candidate's suppressions hold in every row even where the
    vocabulary collapsed that clause to one clause-level atom."""
    kept_set = set(kept)
    off = 0
    occ = [0] * len(OCC_CLAUSES)
    for atom in all_atoms:
        if atom in kept_set:
            continue
        name, k = atom
        if k is None:
            off |= TRIAGE_BIT[name]
        else:
            occ[OCC_ROW[name]] |= 1 << k
    for name, mask in (extra_occ or {}).items():
        occ[OCC_ROW[name]] |= int(mask)
    rs = [1.0] * len(RATE_CLAUSES)
    for name, s in (rate_scale or {}).items():
        rs[RATE_ROW[name]] = float(s)
    return (off, occ, rs, int(horizon_us))


def enumerate_atoms(
    plan: FaultPlan, cfg, seed: int, horizon_us: int, n_nodes: int,
    max_occ: int = 31,
) -> List[Atom]:
    """The ddmin universe for one (plan, seed, horizon): one atom per
    schedule-clause occurrence whose window opens inside the horizon (read
    off `plan.schedule`, no device run), a clause-level atom for a clause
    with more than `max_occ` occurrences or an index >= 31 (bit 31 of the
    int32 mask is unusable), and clause-level atoms for message clauses,
    skew, wipe and legacy chaos knobs."""
    atoms: List[Atom] = []
    occ_of: Dict[str, set] = {}
    for ev in plan.schedule(seed, horizon_us, n_nodes):
        clause = CLAUSE_OF_EVENT.get(ev.kind)
        if clause in OCC_ROW and ev.k >= 0:
            occ_of.setdefault(clause, set()).add(ev.k)
    for clause in OCC_CLAUSES:
        ks = sorted(occ_of.get(clause, ()))
        if not ks:
            continue
        if len(ks) > max_occ or max(ks) >= 31:
            atoms.append((clause, None))
        else:
            atoms.extend((clause, k) for k in ks)
    if plan.get(MsgLoss) is not None:
        atoms.append(("loss", None))
    if plan.get(Duplicate) is not None:
        atoms.append(("dup", None))
    if plan.get(Reorder) is not None:
        atoms.append(("reorder", None))
    if plan.get(ClockSkew) is not None:
        atoms.append(("skew", None))
    crash = plan.get(Crash)
    if crash is not None and crash.wipe_rate > 0:
        atoms.append(("wipe", None))
    # legacy trajectory-coupled knobs: clause-level only (no pure schedule)
    if cfg.chaos_enabled:
        atoms.append(("crash", None))
    if cfg.partition_enabled:
        atoms.append(("partition", None))
    return atoms


def shrink_seed(
    workload,
    seed: int,
    out_dir: Optional[str] = None,
    spec_ref: Optional[str] = None,
    spec_kwargs: Optional[Dict[str, Any]] = None,
    slack_us: int = 2_000,
    lane_width: Optional[int] = None,
    rate_steps: Sequence[float] = (0.5, 0.25),
    trace_tail: int = 40,
    sim=None,
    log: Optional[Callable[[str], None]] = None,
    base_ctl: Optional[Dict[str, Any]] = None,
    refill: bool = False,
    mesh=None,
    causal: bool = False,
    tuning: Any = None,
    device="cuda",
) -> ShrinkResult:
    """Shrink one violating seed of a BatchWorkload into a ReproBundle.

    `base_ctl` shrinks within a candidate's suppression set instead of the
    full plan: keys `off_clauses`, `occ_off`, `rate_scale`, `horizon_us`;
    every suppression it carries stays in the bundle's ctl.

    Dispatches: 1. the baseline (the full and the empty plan as two lanes;
    the full lane must violate, else NotReproducible, and its violation
    time truncates the horizon); 2..k. one per ddmin generation; k+1. an
    optional rate probe for surviving message clauses (a grid, then the
    combination); k+2. the final confirmation under the exact bundle ctl
    (saved when the rate combination already confirmed it). The trace
    tail is a separate single-lane traced run of the final candidate.

    `sim` passes a pre-built `BatchedSim(spec, config, triage=True)`;
    otherwise one is built on `device`. Not ported yet, each refused with
    its ROADMAP item: `refill=True` (the JAX face's default evaluator;
    bundles are bit-identical either way), `mesh`, `tuning` and
    `causal=True`."""
    from .tpu.engine import BatchedSim
    from .tpu.spec import SimConfig

    if tuning is not None:
        raise _not_ported("shrink_seed(tuning=...)", "item 12")
    if causal:
        raise _not_ported("shrink_seed(causal=True) (lineage)", "item 9")
    say = log or (lambda msg: None)
    spec = workload.spec
    cfg = workload.config or SimConfig()
    if lane_width is None:
        lane_width = 16
    if sim is None:
        sim = BatchedSim(spec, cfg, triage=True, device=device)
    elif not sim.triage:
        raise ValueError("shrink_seed needs a BatchedSim(..., triage=True)")
    ev = _Eval(
        sim, seed, workload.max_steps, lane_width, refill=refill, mesh=mesh,
    )
    plan = plan_from_config(cfg)
    base_ctl = base_ctl or {}
    base_off = set(base_ctl.get("off_clauses") or ())
    base_occ: Dict[str, int] = dict(base_ctl.get("occ_off") or {})
    base_rs: Dict[str, float] = dict(base_ctl.get("rate_scale") or {})
    full_h = int(cfg.horizon_us)
    if base_ctl.get("horizon_us"):
        full_h = min(full_h, int(base_ctl["horizon_us"]))

    def _base_on(atom: Atom) -> bool:
        name, k = atom
        if name in base_off:
            return False
        return k is None or not (base_occ.get(name, 0) >> k) & 1

    # -- 1. baseline: the (base-suppressed) plan + empty plan, one dispatch
    base_atoms = enumerate_atoms(plan, cfg, seed, full_h, spec.n_nodes)
    enabled0 = [a for a in base_atoms if _base_on(a)]
    full_row = _atom_rows(enabled0, base_atoms, full_h, rate_scale=base_rs,
                          extra_occ=base_occ)
    empty_row = _atom_rows([], base_atoms, full_h, rate_scale=base_rs,
                           extra_occ=base_occ)
    base, empty = ev.run([full_row, empty_row])[:2]
    if not base["violated"]:
        raise NotReproducible(
            f"seed {seed} does not violate under the "
            f"{'candidate' if base_ctl else 'full'} configuration "
            f"(horizon {full_h} us) — nothing to shrink"
        )
    trunc_h = min(full_h, base["t_us"] + slack_us)
    say(
        f"baseline: violation at step {base['step']}, t={base['t_us']}us; "
        f"horizon truncated {full_h} -> {trunc_h}us"
    )

    # -- 2..k. ddmin over the truncated-horizon atom universe
    if empty["violated"]:
        # the protocol violates with no chaos at all: the minimal plan is
        # empty, and the whole universe stays suppressed in the bundle
        all_atoms: List[Atom] = list(base_atoms)
        universe: List[Atom] = list(enabled0)
        kept: List[Atom] = []
        trunc_h = min(full_h, empty["t_us"] + slack_us)
    else:
        # `all_atoms` is the suppression vocabulary at the truncated
        # horizon; ddmin searches only its base-enabled subset
        all_atoms = enumerate_atoms(plan, cfg, seed, trunc_h, spec.n_nodes)
        universe = [a for a in all_atoms if _base_on(a)]

        def batch_violates(cands: List[List[Atom]]) -> List[bool]:
            rows = [
                _atom_rows(c, all_atoms, trunc_h, rate_scale=base_rs,
                           extra_occ=base_occ)
                for c in cands
            ]
            res = ev.run(rows)
            say(
                f"ddmin generation: {len(cands)} candidates -> "
                f"{sum(r['violated'] for r in res)} violating"
            )
            return [r["violated"] for r in res]

        kept = ddmin(universe, batch_violates)
    say(f"ddmin: {len(universe)} atoms -> {len(kept)} kept: {kept}")

    # -- k+1. rate reduction for surviving message clauses (clauses the
    # base already scaled stay at the base scale)
    kept_clauses = {name for name, _ in kept}
    rate_scale: Dict[str, float] = {}
    rate_targets = [
        n for n in RATE_CLAUSES if (n, None) in kept and n not in base_rs
    ]
    if rate_targets and rate_steps:
        grid: List[Tuple[str, float]] = [
            (n, s) for n in rate_targets for s in rate_steps
        ]
        res = ev.run([
            _atom_rows(kept, all_atoms, trunc_h,
                       rate_scale={**base_rs, n: s}, extra_occ=base_occ)
            for n, s in grid
        ])
        for n in rate_targets:
            best = min(
                (s for (gn, s), r in zip(grid, res)
                 if gn == n and r["violated"]),
                default=1.0,
            )
            if best < 1.0:
                rate_scale[n] = best
    final: Optional[Dict[str, int]] = None
    if rate_targets and rate_steps and rate_scale:
        # scales were probed one clause at a time: confirm the combination
        # (back to full rates if it stops violating); a confirmed row is
        # the final confirmation itself
        ok = ev.run([
            _atom_rows(kept, all_atoms, trunc_h,
                       rate_scale={**base_rs, **rate_scale},
                       extra_occ=base_occ)
        ])[0]
        if ok["violated"]:
            final = ok
        else:
            rate_scale = {}
    if rate_targets:
        say(f"rate reduction: {rate_scale or 'none'}")

    # -- k+2. final confirmation under the exact bundle ctl
    if final is None:
        final = ev.run([
            _atom_rows(kept, all_atoms, trunc_h,
                       rate_scale={**base_rs, **rate_scale},
                       extra_occ=base_occ)
        ])[0]
    assert final["violated"], "shrunk candidate must still violate"
    final_h = min(trunc_h, final["t_us"] + slack_us)

    # the bundle's ctl: the whole vocabulary minus the kept set (base
    # suppressions land in dropped/occ_off like any other)
    dropped = sorted({name for name, _ in all_atoms} - kept_clauses)
    occ_off: Dict[str, int] = {}
    for name, k in all_atoms:
        if k is not None and (name, k) not in kept and name in kept_clauses:
            occ_off[name] = occ_off.get(name, 0) | (1 << k)
    for name, mask in base_occ.items():
        if name not in dropped and mask:
            occ_off[name] = occ_off.get(name, 0) | int(mask)
    rate_scale = {
        n: s for n, s in {**base_rs, **rate_scale}.items()
        if n in kept_clauses
    }

    # -- trace tail: single-lane microscope of the final candidate
    tail: List[str] = []
    if trace_tail > 0:
        from .tpu.trace import trace_seed

        events = trace_seed(
            sim, seed, max_steps=max(final["step"] + 2, 64),
            kind_names=spec.msg_kind_names,
            ctl=build_ctl(1, final_h, dropped, occ_off, rate_scale),
        )
        tail = [str(e) for e in events[-trace_tail:]]

    bundle = ReproBundle(
        seed=int(seed),
        spec_ref=spec_ref,
        spec_kwargs=dict(spec_kwargs or {}),
        spec_name=spec.name,
        n_nodes=spec.n_nodes,
        config_toml=cfg.to_toml(),
        config_hash=cfg.hash(),
        violation_kind="invariant",
        violation_step=final["step"],
        violation_t_us=final["t_us"],
        dropped_clauses=list(dropped),
        occ_off=occ_off,
        rate_scale=rate_scale,
        horizon_us=int(final_h),
        max_steps=int(workload.max_steps),
        plan=plan_to_json(shrink_plan(plan, dropped, rate_scale)),
        trace_tail=tail,
    )
    path = None
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        # the config hash keys the name: runs of one spec under different
        # configs must not overwrite each other's bundles
        path = os.path.join(
            out_dir,
            f"repro_{spec.name}_{cfg.hash()}_seed{int(seed)}.json",
        )
        bundle.save(path)
    say(
        f"shrunk seed {seed}: {len(base_atoms)} atoms -> {len(kept)} in "
        f"{ev.dispatches} dispatches; bundle {path or '(unsaved)'}"
    )
    return ShrinkResult(
        bundle=bundle,
        bundle_path=path,
        dispatches=ev.dispatches,
        original_atoms=len(base_atoms),
        kept_atoms=kept,
    )


def default_bundle_dir() -> str:
    """Where run_batch drops bundles unless told otherwise (per user, under
    the temp dir; MADSIM_TRIAGE_DIR overrides)."""
    uid = os.getuid() if hasattr(os, "getuid") else "all"
    return os.environ.get(
        "MADSIM_TRIAGE_DIR",
        os.path.join(tempfile.gettempdir(), f"madsim_tpu_repros-{uid}"),
    )
