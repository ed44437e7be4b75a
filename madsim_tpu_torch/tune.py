"""Measured autotuning over the engine's throughput knobs: the port of
`madsim_tpu/tune.py`.

The engine's dispatch defaults (lanes per chunk, the `dispatch_steps`
segment length, the host pipeline, the refill lane width) were pinned for
another accelerator. This module measures them on the device a run uses:
successive-halving coordinate descent driven by the measurement
discipline of `madsim_tpu_torch.measure` (fresh seeds per rep index, the
exact timed program warmed first, medians over interleaved rounds), with
winners persisted in a versioned tuned-config cache that `run_batch`,
`triage.shrink_seed`, `Explorer`, `Campaign` and `campaign serve` consume
through ``tuning="auto"``.

Two knob tiers, kept apart:

  Tier A — result-invariant DISPATCH knobs: `chunk`, `dispatch_steps`,
  `pipeline`, `refill_lanes`, `devices`. A seed's trajectory never depends
  on its batch position, the chunk phase or the retirement order, so a
  tuned run's per-seed rows equal the default run's exactly and the knobs
  may be applied anywhere, even mid-campaign. `devices` is offered only
  when more than one card is visible (d > 1 is a "seeds" mesh over the
  first d cards).

  Tier B — trajectory-AFFECTING config knobs (`msg_capacity`,
  `msg_depth_msg`, `msg_depth_timer`, `msg_spare_slots`, and spec knobs
  such as raft's LOG window), tuned at config-creation time only and
  cached only after the acceptance gate passes. Legs 1-2 of the gate run
  here (the engine accepts the config; an acceptance sweep drops nothing
  and saturates nothing). Leg 3, the range certifier, is static analysis
  (item 15), so `certify_config`, `tier_b_gate(certify=True)` and
  `tune_workload(tier="B"|"AB")` refuse, the last before its first trial:
  an uncertified Tier-B winner is never cached.

Cache identity. An entry is keyed by (device kind, spec name, the config's
hash with the Tier-B knobs blanked, lane bucket), in the JAX face's format
(`TUNED_FORMAT`) and directory ($MADSIM_TUNED_DIR, else
~/.cache/madsim-tpu/tuned). `device_kind(device)` names the device a
consumer runs on: a CUDA device is its sanitized card name (e.g.
``NVIDIA_H100_80GB_HBM3``), the CPU is ``cpu``, the JAX face's CPU kind,
so CPU entries are shared by both faces (safe: Tier-A knobs never change a
result). Every function that resolves or writes an entry takes that
device (`device=`, default ``"cuda"``); a CPU consumer looks up ``cpu-…``
entries whether or not a card is visible.

On a card a sweep's `_run` replays one captured CUDA graph per 32 steps,
and a sim keeps the graph of its newest state layout only. So
`tune_workload` holds one sim per chunk width (each warmed once by the
trial clock), and its chunk grid keeps only widths that divide the sweep:
no timed trial captures a graph.

CLI: ``python -m madsim_tpu_torch.tune --workload raft [--device cpu]``.
Wall clocks are `time.perf_counter` only; they never feed a simulation.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from . import telemetry
from .measure import SweepTimer, fresh_seeds, median
from .tpu.engine import _not_ported

TUNED_FORMAT = "madsim-tpu-tuned/1"

# Tier-A dispatch knobs: result-invariant, applicable anywhere.
TIER_A_KNOBS = ("chunk", "dispatch_steps", "pipeline", "refill_lanes",
                "devices")
# Tier-B SimConfig knobs: trajectory-affecting, config-creation time only.
TIER_B_KNOBS = ("msg_capacity", "msg_depth_msg", "msg_depth_timer",
                "msg_spare_slots")

# tuning-trial wall-time histogram buckets (ms)
TRIAL_MS_BUCKETS = (1, 5, 10, 50, 100, 500, 1_000, 5_000, 30_000, 120_000)

# the range certifier behind Tier B's third gate leg
_CERTIFIER = "item 15, static analysis"


class TunedCacheError(ValueError):
    """A tuned-config cache entry that must not be silently used: stale
    or unknown format version, or content that contradicts the requested
    key (a file copied from another device / workload / config)."""


# --------------------------------------------------------------------------
# cache identity
# --------------------------------------------------------------------------


def device_kind(device="cuda") -> str:
    """The device identity a tuned entry is valid for: ``cpu`` for a CPU
    device, else the card's name with every non-alphanumeric character
    made ``_`` (measured knobs do not transfer across device generations,
    which is why the cache is keyed). A CUDA device without a card
    raises."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return "cpu"
    kind = str(torch.cuda.get_device_name(dev))
    return "".join(c if c.isalnum() else "_" for c in kind) or "unknown"


def lane_bucket(lanes: int) -> int:
    """Lane counts bucket to the next power of two: the knee points the
    knobs trade around move with scale, not with exact lane counts."""
    lanes = int(lanes)
    if lanes < 1:
        raise ValueError(f"lane count must be >= 1, got {lanes}")
    b = 1
    while b < lanes:
        b *= 2
    return b


def config_hash_sans_tier_b(config) -> str:
    """SimConfig identity with the Tier-B pool knobs blanked: the key must
    be stable under the very values tuning changes, or a tuned config
    could never find its own entry again."""
    lines = [
        ln for ln in config.to_toml().splitlines()
        if ln.split(" = ")[0] not in TIER_B_KNOBS
    ]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()[:16]


def cache_key(device: str, workload: str, config, lanes: int) -> str:
    """The entry's file stem; `device` is a device KIND (`device_kind`)."""
    return (
        f"{device}-{workload}-{config_hash_sans_tier_b(config)}"
        f"-l{lane_bucket(lanes)}"
    )


def default_cache_dir() -> str:
    return os.environ.get("MADSIM_TUNED_DIR") or os.path.join(
        os.path.expanduser("~"), ".cache", "madsim-tpu", "tuned"
    )


@dataclasses.dataclass
class TunedEntry:
    """One measured winner: the `madsim-tpu-tuned/1` cache record (the JAX
    face's fields and document, so either face reads the other's).

    `dispatch` holds the Tier-A knob assignment; `config` the Tier-B
    SimConfig overrides and `spec` the Tier-B spec-knob overrides (both
    empty unless a certified Tier-B search ran). `fallback` records that
    the never-regress guard kept the hand-pinned defaults."""

    device_kind: str
    workload: str
    config_hash: str  # sans Tier B (the cache key's config component)
    lane_bucket: int
    dispatch: Dict[str, Any] = dataclasses.field(default_factory=dict)
    config: Dict[str, Any] = dataclasses.field(default_factory=dict)
    spec: Dict[str, Any] = dataclasses.field(default_factory=dict)
    baseline_seeds_per_sec: float = 0.0
    tuned_seeds_per_sec: float = 0.0
    trials: int = 0
    fallback: bool = False
    certified: bool = False
    format: str = TUNED_FORMAT

    def key(self) -> str:
        return (
            f"{self.device_kind}-{self.workload}-{self.config_hash}"
            f"-l{self.lane_bucket}"
        )

    def win_pct(self) -> float:
        if self.baseline_seeds_per_sec <= 0:
            return 0.0
        return round(
            (self.tuned_seeds_per_sec / self.baseline_seeds_per_sec - 1)
            * 100, 2,
        )

    def to_doc(self) -> Dict[str, Any]:
        doc = dataclasses.asdict(self)
        doc["win_pct"] = self.win_pct()
        return doc

    @classmethod
    def from_doc(cls, doc: Dict[str, Any], where: str = "tuned entry"):
        doc = dict(doc)
        doc.pop("win_pct", None)
        fmt = doc.get("format")
        if fmt != TUNED_FORMAT:
            raise TunedCacheError(
                f"{where}: format {fmt!r} is not {TUNED_FORMAT!r} — a "
                "stale or foreign tuned-config cache must be re-tuned, "
                "never silently reinterpreted"
            )
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - known
        if unknown:
            raise TunedCacheError(
                f"{where}: unknown fields {sorted(unknown)} — written by "
                "a newer tree? re-tune rather than half-apply"
            )
        bad = set(doc.get("dispatch") or {}) - set(TIER_A_KNOBS)
        if bad:
            raise TunedCacheError(
                f"{where}: dispatch holds non-Tier-A knobs {sorted(bad)}"
            )
        bad = set(doc.get("config") or {}) - set(TIER_B_KNOBS)
        if bad:
            raise TunedCacheError(
                f"{where}: config holds non-Tier-B knobs {sorted(bad)}"
            )
        return cls(**doc)

    def save(self, dir: Optional[str] = None) -> str:
        dir = dir or default_cache_dir()
        os.makedirs(dir, exist_ok=True)
        path = os.path.join(dir, self.key() + ".json")
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.to_doc(), f, indent=1, sort_keys=True)
        os.replace(tmp, path)
        return path

    @classmethod
    def load(cls, path: str) -> "TunedEntry":
        with open(path) as f:
            doc = json.load(f)
        return cls.from_doc(doc, where=path)


def load_tuned(
    workload: str, config, lanes: int,
    dir: Optional[str] = None, device="cuda",
) -> Optional[TunedEntry]:
    """The cache lookup behind ``tuning="auto"`` for a consumer running on
    `device`: None on a clean miss; `TunedCacheError` when an entry exists
    at the key but its content contradicts the request (wrong device kind,
    workload or config hash, stale format)."""
    dir = dir or default_cache_dir()
    kind = device_kind(device)
    key = cache_key(kind, workload, config, lanes)
    path = os.path.join(dir, key + ".json")
    if not os.path.exists(path):
        return None
    entry = TunedEntry.load(path)
    want = (kind, workload, config_hash_sans_tier_b(config),
            lane_bucket(lanes))
    got = (entry.device_kind, entry.workload, entry.config_hash,
           entry.lane_bucket)
    if got != want:
        raise TunedCacheError(
            f"{path}: entry content {got} does not match its key {want} "
            "— a copied or hand-edited tuned cache; delete it and re-tune"
        )
    return entry


def _validate_dispatch(d: Dict[str, Any], where: str = "tuning") -> Dict[str, Any]:
    bad = set(d) - set(TIER_A_KNOBS)
    if bad:
        raise ValueError(
            f"{where}: {sorted(bad)} are not Tier-A dispatch knobs "
            f"(Tier A = {TIER_A_KNOBS}; Tier-B config knobs are applied "
            "at config-creation time only)"
        )
    return dict(d)


def resolve_tuning(
    tuning, workload: str, config, lanes: int,
    dir: Optional[str] = None, device="cuda",
) -> Dict[str, Any]:
    """Resolve a caller's `tuning` argument into Tier-A dispatch overrides
    ({} = run the hand-pinned defaults) for a run on `device`.

    Accepted forms: None (no-op), ``"auto"`` (consult the tuned-config
    cache; a clean miss is {}), a `TunedEntry`, a dict of Tier-A knobs
    (applied verbatim — what campaign checkpoints persist, so kill/resume
    never re-tunes), or a path to a saved entry."""
    if tuning is None or tuning is False or tuning == "":
        return {}
    if isinstance(tuning, TunedEntry):
        return _validate_dispatch(tuning.dispatch, "TunedEntry.dispatch")
    if isinstance(tuning, dict):
        return _validate_dispatch(tuning)
    if tuning == "auto":
        entry = load_tuned(workload, config, lanes, dir=dir, device=device)
        return {} if entry is None else _validate_dispatch(
            entry.dispatch, "tuned cache"
        )
    if isinstance(tuning, str):
        return _validate_dispatch(
            TunedEntry.load(tuning).dispatch, tuning
        )
    raise TypeError(
        f"tuning must be None, 'auto', a dict, a TunedEntry or a path — "
        f"got {type(tuning).__name__}"
    )


# --------------------------------------------------------------------------
# the search: successive-halving coordinate descent
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Knob:
    """One tunable axis: candidate values in screening order."""

    name: str
    values: Tuple[Any, ...]
    tier: str = "A"


class TrialLog:
    """Trial bookkeeping + telemetry: every measured trial increments the
    per-knob `tune_trials_total` counter, lands its wall in the
    `tune_trial_ms` histogram and runs inside a `telemetry.span`."""

    def __init__(self, log: Optional[Callable[[str], None]] = None) -> None:
        self.rep = 1  # rep 0 is SweepTimer's warm rep — never timed
        self.trials: List[Dict[str, Any]] = []
        self.say = log or (lambda msg: None)

    def trial(self, measure, assignment: Dict[str, Any], knob: str,
              value) -> float:
        with telemetry.span("tune_trial", knob=knob, value=str(value)):
            wall = measure(assignment, self.rep)
        self.rep += 1
        reg = telemetry.get_registry()
        if reg is not None:
            reg.counter(
                "tune_trials_total", "autotune trials per knob"
            ).inc(knob=knob)
            reg.histogram(
                "tune_trial_ms", "measured autotune trial wall (ms)",
                buckets=TRIAL_MS_BUCKETS,
            ).observe(wall * 1e3, knob=knob)
        self.trials.append({
            "knob": knob, "value": value, "wall_s": round(wall, 6),
        })
        self.say(f"[tune] {knob}={value}: {wall * 1e3:.1f} ms")
        return wall


def coordinate_descent(
    knobs: Sequence[Knob],
    measure,
    base: Dict[str, Any],
    tl: TrialLog,
    passes: int = 1,
) -> Dict[str, Any]:
    """One knob at a time, others pinned at the current best; per knob, a
    successive-halving tournament: every surviving value gets one more
    interleaved measurement per round and the slower half is cut."""
    assign = dict(base)
    for _ in range(int(passes)):
        for knob in knobs:
            values = list(dict.fromkeys(
                list(knob.values) + [assign[knob.name]]
            ))
            if len(values) < 2:
                continue
            scores: Dict[Any, List[float]] = {v: [] for v in values}
            alive = list(values)
            while len(alive) > 1:
                for v in alive:  # interleaved round over survivors
                    a = dict(assign)
                    a[knob.name] = v
                    scores[v].append(tl.trial(measure, a, knob.name, v))
                alive = sorted(
                    alive, key=lambda v: median(scores[v])
                )[: (len(alive) + 1) // 2]
            assign[knob.name] = alive[0]
    return assign


def ab_guard(
    measure, default: Dict[str, Any], tuned: Dict[str, Any],
    tl: TrialLog, rounds: int = 2,
) -> Dict[str, float]:
    """The never-regress gate: default vs tuned head-to-head, interleaved
    rounds, median walls. The caller keeps the default whenever the tuned
    assignment does not beat it."""
    walls: Dict[str, List[float]] = {"default": [], "tuned": []}
    for _ in range(int(rounds)):
        walls["default"].append(
            tl.trial(measure, default, "ab_guard", "default")
        )
        walls["tuned"].append(tl.trial(measure, tuned, "ab_guard", "tuned"))
    return {k: median(v) for k, v in walls.items()}


# --------------------------------------------------------------------------
# Tier-B acceptance gate
# --------------------------------------------------------------------------


def certify_config(spec, config, lanes: int = 64) -> Tuple[bool, List[str]]:
    """Leg 3 of the Tier-B gate: a fresh range-certifier run over the
    tuned config's step program. Static analysis is not ported, so this
    refuses."""
    raise _not_ported("the range certifier (tune.certify_config)",
                      _CERTIFIER)


def tier_b_gate(
    workload, config, seeds: int = 256,
    certify: bool = True, log: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """The Tier-B acceptance gate. A trajectory-affecting tuned config is
    cached only when all three legs hold:

      1. the engine ACCEPTS it — `BatchedSim.__init__`'s validation;
      2. an acceptance sweep of `seeds` seeds on `device` drops nothing:
         `total_overflow == 0` and every summary key naming ``saturated``
         is zero;
      3. the range certifier re-certifies it (`certify_config`).

    Leg 3 is not ported, so ``certify=True`` refuses before leg 1 runs.
    Returns {"ok", "reasons", "summary"}; reasons name the failing leg,
    in the JAX face's words."""
    from .tpu.batch import run_batch
    from .tpu.engine import BatchedSim

    if certify:
        raise _not_ported("tier_b_gate(certify=True), whose third leg is "
                          "the range certifier", _CERTIFIER)
    say = log or (lambda msg: None)
    reasons: List[str] = []
    try:
        sim = BatchedSim(workload.spec, config, device=device)
    except ValueError as e:
        return {
            "ok": False,
            "reasons": [f"engine rejects the config: {e}"],
            "summary": {},
        }
    wl2 = dataclasses.replace(workload, config=config, host_repro=None)
    res = run_batch(
        range(int(seeds)), wl2, repro_on_host=False, max_traces=0,
        mesh=None, shrink_on_violation=False, sim=sim,
    )
    overflow = int(res.summary.get("total_overflow", 0))
    if overflow:
        reasons.append(
            f"acceptance sweep dropped {overflow} sends (overflow != 0): "
            "the tuned pool budget is too small for this traffic"
        )
    for k, v in sorted(res.summary.items()):
        if "saturated" in k and isinstance(v, (int, float)) and v:
            reasons.append(f"acceptance sweep: {k} = {v} (must be 0)")
    gate = {
        "ok": not reasons,
        "reasons": reasons,
        "summary": {
            "seeds": int(seeds),
            "violations": int(res.violations),
            "total_overflow": overflow,
        },
    }
    if reasons:
        say(f"[tune] Tier-B gate REJECTED: {'; '.join(reasons)}")
    return gate


# --------------------------------------------------------------------------
# Tier-A tuning: the spread-mix benchmark and whole workloads
# --------------------------------------------------------------------------


def spread_mix_sim(virtual_secs: float = 1.0, device="cuda"):
    """The 10x horizon-spread raft mix (`digest.spread_mix`: Crash + 5%
    loss; one long admission per 8) as the Tier-A tuning benchmark.
    Returns (BatchedSim(triage=True) on `device`, horizon_us)."""
    from .tpu import make_raft_spec
    from .tpu.digest import spread_mix
    from .tpu.engine import BatchedSim

    horizon = int(virtual_secs * 1e6)
    return BatchedSim(make_raft_spec(), spread_mix(horizon), triage=True,
                      device=device), horizon


def spread_ctl_rows(horizon_us: int, admissions: int, spread: int = 10,
                    long_every: int = 8):
    """Per-admission TriageCtl rows for the spread mix (`digest.spread_ctl`):
    one long horizon per `long_every` admissions, the rest at
    horizon/spread."""
    from .tpu.digest import spread_ctl

    return spread_ctl(horizon_us, admissions, spread=spread,
                      long_every=long_every)


def tune_spread_mix(
    lanes: int = 16, waves: int = 16, spread: int = 10, long_every: int = 8,
    virtual_secs: float = 1.0, max_steps: int = 50_000,
    knobs: Optional[Sequence[Knob]] = None,
    guard_rounds: int = 2,
    cache_dir: Optional[str] = None, save: bool = True,
    log: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> TunedEntry:
    """One Tier-A coordinate pass over the refill engine's dispatch knobs
    on the spread mix: the refill lane width and the sweep segment length.
    Refill sweeps step eagerly, so no trial captures a graph."""
    from .tpu.engine import DEFAULT_DISPATCH_STEPS

    sim, horizon = spread_mix_sim(virtual_secs, device=device)
    A = int(lanes) * int(waves)
    ctl = spread_ctl_rows(horizon, A, spread=spread, long_every=long_every)
    default = {
        "refill_lanes": int(lanes),
        "dispatch_steps": DEFAULT_DISPATCH_STEPS,
    }
    if knobs is None:
        widths = tuple(sorted({max(1, lanes // 2), int(lanes), lanes * 2}))
        knobs = (
            Knob("refill_lanes", widths),
            Knob("dispatch_steps", (1_000, 5_000, 10_000)),
        )

    def run(assign: Dict[str, Any], rep: int):
        seeds = fresh_seeds(rep, A)
        return sim.run_refill(
            seeds, lanes=int(assign["refill_lanes"]), max_steps=max_steps,
            dispatch_steps=int(assign["dispatch_steps"]), ctl=ctl,
        )

    measure = SweepTimer(
        run,
        compile_key=lambda a: (a["refill_lanes"], a["dispatch_steps"]),
    )
    tl = TrialLog(log)
    best = coordinate_descent(knobs, measure, default, tl)
    best, fallback, baseline_sps, tuned_sps = _guard_tier_a(
        measure, default, best, tl, work_items=A,
        guard_rounds=guard_rounds,
    )
    return _finish_entry(
        workload="spread-mix", config=sim.config, lanes=lanes,
        default=default, best=best, fallback=fallback,
        baseline_sps=baseline_sps, tuned_sps=tuned_sps, tl=tl,
        cache_dir=cache_dir, save=save, device=sim.device,
    )


def _guard_tier_a(
    measure, default: Dict[str, Any], best: Dict[str, Any],
    tl: TrialLog, work_items: int, guard_rounds: int,
) -> Tuple[Dict[str, Any], bool, float, float]:
    """The never-regress A/B guard + seeds/s accounting, shared by every
    tuner. Returns (best, fallback, baseline_sps, tuned_sps) with `best`
    replaced by the default when the tuned assignment did not measure
    faster."""
    if best != default:
        meds = ab_guard(measure, default, best, tl, rounds=guard_rounds)
        fallback = meds["tuned"] >= meds["default"]
        baseline_sps = work_items / meds["default"]
        tuned_sps = (
            baseline_sps if fallback else work_items / meds["tuned"]
        )
        if fallback:
            best = dict(default)
    else:
        wall = tl.trial(measure, default, "ab_guard", "default")
        baseline_sps = tuned_sps = work_items / wall
        fallback = True
    return best, fallback, baseline_sps, tuned_sps


def _finish_entry(
    workload: str, config, lanes: int,
    default: Dict[str, Any], best: Dict[str, Any],
    fallback: bool, baseline_sps: float, tuned_sps: float,
    tl: TrialLog,
    cache_dir: Optional[str], save: bool,
    config_overrides: Optional[Dict[str, Any]] = None,
    spec_overrides: Optional[Dict[str, Any]] = None,
    certified: bool = False,
    device="cuda",
) -> TunedEntry:
    """The shared tail of every tuner: cache-entry assembly + write."""
    entry = TunedEntry(
        device_kind=device_kind(device),
        workload=workload,
        config_hash=config_hash_sans_tier_b(config),
        lane_bucket=lane_bucket(lanes),
        # store only the knobs that actually BEAT their default: a value
        # equal to the default was either never searched or lost
        dispatch={
            k: v for k, v in best.items() if v != default.get(k)
        } if not fallback else {},
        config=dict(config_overrides or {}),
        spec=dict(spec_overrides or {}),
        baseline_seeds_per_sec=round(baseline_sps, 2),
        tuned_seeds_per_sec=round(tuned_sps, 2),
        trials=len(tl.trials),
        fallback=fallback and not (config_overrides or spec_overrides),
        certified=certified,
    )
    if save:
        entry.save(cache_dir)
    return entry


def _mesh_for(devices: int, cached: bool = False):
    """0 = the production default mesh ("auto": every visible card); 1 =
    unsharded (None); d > 1 = an explicit "seeds" mesh over the first d
    cards. `cached=True` is the consumer side (a driver applying a tuned
    cache entry, keyed by card kind, not count): an entry recorded on a
    bigger host falls back to "auto", since a cache entry can only be a
    throughput decision, never a crash; the tuner's own search raises on
    a count the host cannot give."""
    from .tpu.mesh import Mesh, visible_devices

    d = int(devices)
    if d == 0:
        return "auto"
    if d == 1:
        return None
    cards = visible_devices("cuda")
    if d > len(cards):
        if cached:
            return "auto"
        raise ValueError(f"devices={d} but only {len(cards)} visible")
    return Mesh(cards[:d], "seeds")


def tier_a_knobs(
    workload, n_seeds: int, quick: bool = False, device="cuda",
) -> Tuple[Knob, ...]:
    """The Tier-A knob grid for a whole-workload `run_batch` sweep of
    `n_seeds` seeds on `device`. `quick` is the CI/bench screen: segment
    length + pipeline only. The chunk widths are the JAX face's (n/4, n/2,
    n) less any that leaves a short last chunk, whose other layout would
    recapture the sim's graph inside every timed trial; `devices` comes up
    only when more than one card is visible."""
    n_seeds = int(n_seeds)
    steps = (5_000, 10_000, 20_000) if quick else (
        2_000, 5_000, 10_000, 20_000,
    )
    ks: List[Knob] = [
        Knob("dispatch_steps", steps),
        Knob("pipeline", (True, False)),
    ]
    if not quick:
        chunks = tuple(sorted(
            c for c in {max(1, n_seeds // 4), max(1, n_seeds // 2), n_seeds}
            if n_seeds % c == 0
        ))
        ks.append(Knob("chunk", chunks))
        if workload.lane_check is None:
            # the refill path keeps no per-admission node state, so
            # lane_check workloads must stay chunked (run_batch refuses)
            ks.append(Knob("refill_lanes", (0, max(1, n_seeds // 4))))
        D = (torch.cuda.device_count()
             if torch.device(device).type == "cuda" else 1)
        if D > 1:
            # 0 is "auto" = a mesh over ALL visible devices, so the ladder
            # stays strictly below D
            dv: List[int] = [0, 1]
            d = 2
            while d < D:
                dv.append(d)
                d *= 2
            ks.append(Knob("devices", tuple(dv)))
    return tuple(ks)


def _require_certifier(tier: str) -> None:
    """Tier B's winners are cached only after the range certifier passes,
    and it is not ported: refuse before the first trial."""
    if "B" in tier.upper():
        raise _not_ported(f"tune tier {tier!r} (a Tier-B winner is cached "
                          "only once the range certifier passes)",
                          _CERTIFIER)


def tune_workload(
    workload, name: str, lanes: int = 4_096,
    n_seeds: Optional[int] = None, tier: str = "A",
    knobs: Optional[Sequence[Knob]] = None,
    spec_knobs: Optional[Sequence["SpecKnob"]] = None,
    quick: bool = False, guard_rounds: int = 2, gate_seeds: int = 256,
    cache_dir: Optional[str] = None, save: bool = True,
    log: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> TunedEntry:
    """Tune one BatchWorkload's end-to-end `run_batch` throughput on
    `device`.

    Tier A searches the dispatch knobs (the trial clock is
    `measure.SweepTimer`: fresh seed blocks per rep, the exact program
    warmed once per compile key). Trials share one sim per chunk width, so
    each layout's graph is captured in its warm rep and only replayed in
    timed ones. ``tier="B"`` or ``"AB"`` refuses before any trial (the
    Tier-B gate's certifier is item 15). The entry is keyed by the spec's
    name and the measured sweep size."""
    from .tpu.batch import DEFAULT_CHUNK, run_batch
    from .tpu.engine import DEFAULT_DISPATCH_STEPS, BatchedSim
    from .tpu.spec import SimConfig

    _require_certifier(tier)
    cfg = workload.config or SimConfig()
    n = int(n_seeds or int(lanes))
    tl = TrialLog(log)
    default = {
        "chunk": min(DEFAULT_CHUNK, n),
        "dispatch_steps": DEFAULT_DISPATCH_STEPS,
        "pipeline": True, "refill_lanes": 0, "devices": 0,
    }
    if knobs is None:
        knobs = tier_a_knobs(workload, n_seeds=n, quick=quick, device=device)
    # one sim per chunk width: a CUDA sim keeps only its newest layout's
    # graph, so a shared sim would recapture inside a timed trial whenever
    # the chunk knob changed its lane count
    sims: Dict[int, Any] = {}

    def sim_for(chunk: int):
        width = min(int(chunk), n)
        if width not in sims:
            sims[width] = BatchedSim(workload.spec, cfg, device=device)
        return sims[width]

    dev = sim_for(default["chunk"]).device  # fails fast without a card

    def run(assign: Dict[str, Any], rep: int):
        run_batch(
            fresh_seeds(rep, n), workload, sim=sim_for(assign["chunk"]),
            chunk=int(assign["chunk"]),
            dispatch_steps=int(assign["dispatch_steps"]),
            pipeline=bool(assign["pipeline"]),
            refill=int(assign["refill_lanes"]),
            mesh=_mesh_for(assign["devices"]),
            repro_on_host=False, max_traces=0,
        )
        return None  # run_batch reads its results back itself

    measure = SweepTimer(
        run,
        compile_key=lambda a: (
            a["chunk"], a["dispatch_steps"], a["refill_lanes"], a["devices"],
        ),
    )
    best = coordinate_descent(knobs, measure, default, tl)
    # guard FIRST: Tier-B candidates are measured under the Tier-A
    # assignment the entry actually ships
    best, fallback, baseline_sps, tuned_sps = _guard_tier_a(
        measure, default, best, tl, work_items=n,
        guard_rounds=guard_rounds,
    )
    config_overrides: Dict[str, Any] = {}
    spec_overrides: Dict[str, Any] = {}
    certified = False
    if "B" in tier.upper():  # reached once the certifier is ported
        config_overrides, spec_overrides, certified = _tune_tier_b(
            workload, best, n, tl, spec_knobs=spec_knobs,
            gate_seeds=gate_seeds, log=log, device=dev,
        )
    # the cache identity is the SPEC name ("raft5"), which every
    # tuning="auto" consumer resolves with, and the MEASURED sweep size
    return _finish_entry(
        workload=workload.spec.name, config=cfg, lanes=n,
        default=default, best=best, fallback=fallback,
        baseline_sps=baseline_sps, tuned_sps=tuned_sps, tl=tl,
        cache_dir=cache_dir, save=save,
        config_overrides=config_overrides, spec_overrides=spec_overrides,
        certified=certified, device=dev,
    )


# --------------------------------------------------------------------------
# Tier B: trajectory-affecting knobs, gated
# --------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpecKnob:
    """A Tier-B SPEC knob (raft LOG window, kv OPS ring): candidate
    values plus a rebuild hook (workload, value) -> workload carrying the
    re-parameterized spec."""

    name: str
    values: Tuple[Any, ...]
    rebuild: Callable[[Any, Any], Any]
    default: Any = None


def tier_b_effective_defaults(workload, default: Dict[str, Any],
                              device="cuda") -> Dict[str, Any]:
    """The engine's EFFECTIVE values behind None-defaulted Tier-B pool
    knobs (msg_depth_msg/msg_depth_timer None = `msg_capacity // C`,
    derived inside BatchedSim). A candidate equal to the effective value
    is the same program as the default: never measured twice, never
    cached as an override."""
    from .tpu.engine import BatchedSim
    from .tpu.spec import SimConfig

    eff = dict(default)
    if eff.get("msg_depth_msg") is None or (
        "msg_depth_timer" in eff and eff["msg_depth_timer"] is None
    ):
        sim0 = BatchedSim(
            workload.spec, workload.config or SimConfig(), device=device
        )
        if eff.get("msg_depth_msg") is None:
            eff["msg_depth_msg"] = int(sim0._Km)
        if "msg_depth_timer" in eff and eff["msg_depth_timer"] is None:
            eff["msg_depth_timer"] = int(sim0._Kt)
    return eff


def tier_b_config_knobs(workload, device="cuda") -> Tuple[Knob, ...]:
    """Pool-knob candidates around the workload's current EFFECTIVE
    values. Fused (on_event) specs place node-pooled slots — depth +
    spare are the levers; two-handler specs tune the per-class ring
    depths."""
    from .tpu.engine import BatchedSim
    from .tpu.spec import SimConfig

    cfg = workload.config or SimConfig()
    fused = workload.spec.on_event is not None
    sim0 = BatchedSim(workload.spec, cfg, device=device)
    depth = int(sim0._Km)
    ks = [Knob(
        "msg_depth_msg",
        tuple(sorted({max(1, depth - 1), depth, depth + 1})), tier="B",
    )]
    if fused:
        spare = cfg.msg_spare_slots
        ks.append(Knob(
            "msg_spare_slots",
            tuple(sorted({max(0, spare - 1), spare, spare + 1, spare + 2})),
            tier="B",
        ))
    else:
        kt = int(sim0._Kt)
        ks.append(Knob(
            "msg_depth_timer",
            tuple(sorted({max(1, kt - 1), kt, kt + 1})), tier="B",
        ))
    return tuple(ks)


def _tune_tier_b(
    workload, tier_a: Dict[str, Any], n_seeds: int, tl: TrialLog,
    spec_knobs: Optional[Sequence[SpecKnob]] = None,
    gate_seeds: int = 256,
    log: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> Tuple[Dict[str, Any], Dict[str, Any], bool]:
    """The Tier-B search + gate: (config_overrides, spec_overrides,
    certified). Defaults win unless a candidate measures faster AND
    passes `tier_b_gate` on the full tuned config — whose certifier leg
    refuses until item 15, so a winner never reaches the cache."""
    from .tpu.batch import run_batch
    from .tpu.engine import BatchedSim
    from .tpu.spec import SimConfig

    say = log or (lambda msg: None)
    base_cfg = workload.config or SimConfig()
    knobs = tier_b_config_knobs(workload, device=device)
    default = {k.name: getattr(base_cfg, k.name) for k in knobs}
    for sk in (spec_knobs or ()):
        default[sk.name] = sk.default
    sims: Dict[Any, Tuple[Any, Any]] = {}
    spec_by_name = {sk.name: sk for sk in (spec_knobs or ())}

    def build(assign: Dict[str, Any]):
        wl2 = workload
        cfg_over = {
            k: v for k, v in assign.items() if k not in spec_by_name
        }
        for k, sk in spec_by_name.items():
            if assign.get(k) != sk.default:
                wl2 = sk.rebuild(wl2, assign[k])
        cfg2 = dataclasses.replace(wl2.config or base_cfg, **cfg_over)
        wl2 = dataclasses.replace(wl2, config=cfg2, host_repro=None)
        return wl2, cfg2

    def valid(assign: Dict[str, Any]) -> bool:
        try:
            wl2, cfg2 = build(assign)
            BatchedSim(wl2.spec, cfg2, device=device)
            return True
        except ValueError:
            return False

    def run(assign: Dict[str, Any], rep: int):
        # one sim per candidate config, each at the Tier-A chunk width:
        # each captures its graph in its own warm rep
        key = tuple(sorted(assign.items()))
        ent = sims.get(key)
        if ent is None:
            wl2, cfg2 = build(assign)
            ent = sims[key] = (BatchedSim(wl2.spec, cfg2, device=device),
                               wl2)
        simb, wl2 = ent
        run_batch(
            fresh_seeds(rep, int(n_seeds)), wl2, sim=simb,
            chunk=int(tier_a["chunk"]),
            dispatch_steps=int(tier_a["dispatch_steps"]),
            pipeline=bool(tier_a["pipeline"]),
            refill=int(tier_a["refill_lanes"]),
            mesh=_mesh_for(tier_a["devices"]),
            repro_on_host=False, max_traces=0,
        )
        return None

    measure = SweepTimer(
        run, compile_key=lambda a: tuple(sorted(a.items())),
    )
    all_knobs = list(knobs) + [
        Knob(sk.name, sk.values, tier="B") for sk in (spec_knobs or ())
    ]
    # screen candidates for engine validity against the default point and
    # for effective-default twins (the default program under another name)
    effective = tier_b_effective_defaults(workload, default, device=device)
    screened: List[Knob] = []
    for k in all_knobs:
        vals = tuple(
            v for v in k.values
            if not (
                default.get(k.name) is None and v == effective.get(k.name)
            )
            and valid({**default, k.name: v})
        )
        if vals:
            screened.append(dataclasses.replace(k, values=vals))
    best = coordinate_descent(screened, measure, default, tl)
    if best == default:
        return {}, {}, False
    meds = ab_guard(measure, default, best, tl)
    if meds["tuned"] >= meds["default"]:
        say("[tune] Tier B: no candidate beat the hand-pinned defaults")
        return {}, {}, False
    wl2, cfg2 = build(best)
    gate = tier_b_gate(wl2, cfg2, seeds=gate_seeds, log=log, device=device)
    if not gate["ok"]:
        return {}, {}, False
    config_overrides = {
        k: best[k] for k in default
        if k not in spec_by_name and best[k] != default[k]
        and best[k] != effective.get(k, default[k])
    }
    spec_overrides = {
        k: best[k] for k in spec_by_name if best[k] != default[k]
    }
    say(
        f"[tune] Tier B certified: config={config_overrides} "
        f"spec={spec_overrides}"
    )
    return config_overrides, spec_overrides, True


def apply_tier_b(config, entry: TunedEntry):
    """Fold a certified entry's Tier-B overrides into a SimConfig (its
    `hash()` changes, so campaign resume and repro bundles see the drift).
    Refuses an uncertified entry."""
    if entry.config and not entry.certified:
        raise ValueError(
            "tuned entry carries Tier-B overrides but certified=False — "
            "the acceptance gate must pass before Tier B is applied"
        )
    if not entry.config:
        return config
    return dataclasses.replace(config, **entry.config)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def _tune_workloads() -> Tuple[str, ...]:
    from . import workloads as registry

    return registry.names(tunable=True)


WORKLOADS = _tune_workloads()


def _spec_knobs_for(name: str, virtual_secs: float) -> Tuple[SpecKnob, ...]:
    """The Tier-B spec hooks: raft's LOG window and kv's OPS history ring,
    rebuilt through the factories the named workloads use; any other
    workload's come from its registry row."""
    if name == "raft":
        from .tpu import make_raft_spec

        def rebuild(wl, v):
            return dataclasses.replace(
                wl, spec=make_raft_spec(n_nodes=5, log_capacity=int(v))
            )

        return (SpecKnob(
            "log_capacity", (12, 16, 24), rebuild, default=24,
        ),)
    if name == "kv":
        from .tpu.kv import kv_workload

        def rebuild(wl, v):
            fresh = kv_workload(
                virtual_secs=virtual_secs, ops_capacity=int(v),
            )
            return dataclasses.replace(
                wl, spec=fresh.spec, lane_check=fresh.lane_check,
            )

        base = max(24, min(128, int(virtual_secs * 6.4)))
        return (SpecKnob(
            "ops_capacity",
            tuple(sorted({24, base, min(128, base * 2)})),
            rebuild, default=base,
        ),)
    from . import workloads as registry

    try:
        return tuple(registry.spec_knobs(name, virtual_secs))
    except KeyError:
        return ()


def main(argv: Optional[Sequence[str]] = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m madsim_tpu_torch.tune",
        description="measured autotuning over the engine's throughput "
        "knobs; winners cached per (device kind, workload, config, lane "
        "bucket) and consumed via tuning='auto'",
    )
    parser.add_argument(
        "--workload", default="raft",
        help=f"{'|'.join(WORKLOADS)}|spread-mix|all",
    )
    parser.add_argument("--virtual-secs", type=float, default=2.0)
    parser.add_argument("--storm", action="store_true")
    parser.add_argument(
        "--lanes", type=int, default=None,
        help="seeds per trial sweep / cache lane bucket (default: 4096; "
        "spread-mix: 16 refill lanes)",
    )
    parser.add_argument(
        "--seeds", type=int, default=None,
        help="seeds per trial sweep (default: --lanes)",
    )
    parser.add_argument(
        "--tier", default="A", choices=("A", "B", "AB"),
        help="B and AB are refused until the range certifier is ported",
    )
    parser.add_argument("--cache-dir", default=None)
    parser.add_argument("--no-save", action="store_true")
    parser.add_argument(
        "--quick", action="store_true",
        help="small knob grid (segment length + pipeline only)",
    )
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument(
        "--device", default="cuda",
        help="the device to tune on and key the cache by (default cuda; "
        "cpu tunes on the CPU)",
    )
    args = parser.parse_args(argv)

    say = (lambda msg: None) if args.quiet else print
    names = list(WORKLOADS) if args.workload == "all" else [args.workload]
    rc = 0
    for nm in names:
        try:
            if nm == "spread-mix":
                # the spread-mix branch runs the refill engine's own
                # search; the workload-sweep flags don't apply to it and
                # must not be silently dropped
                dropped = [
                    flag for flag, hit in (
                        ("--tier", args.tier != "A"),
                        ("--seeds", args.seeds is not None),
                        ("--quick", args.quick),
                        ("--storm", args.storm),
                    ) if hit
                ]
                if dropped:
                    parser.error(
                        f"{' '.join(dropped)} do(es) not apply to "
                        "--workload spread-mix (Tier-A refill search only)"
                    )
                entry = tune_spread_mix(
                    lanes=args.lanes or 16,
                    virtual_secs=args.virtual_secs,
                    cache_dir=args.cache_dir, save=not args.no_save,
                    log=say, device=args.device,
                )
            else:
                from .explore import _named_workload

                wl = _named_workload(nm, args.virtual_secs, args.storm)
                entry = tune_workload(
                    wl, nm, lanes=args.lanes or 4_096, n_seeds=args.seeds,
                    tier=args.tier,
                    spec_knobs=(
                        _spec_knobs_for(nm, args.virtual_secs)
                        if "B" in args.tier else None
                    ),
                    quick=args.quick, cache_dir=args.cache_dir,
                    save=not args.no_save, log=say, device=args.device,
                )
        except Exception as e:  # noqa: BLE001 - one workload must not
            # hide the others' results
            print(json.dumps({
                "workload": nm,
                "error": f"{type(e).__name__}: {str(e)[:200]}",
            }), flush=True)
            rc = 1
            continue
        print(json.dumps(entry.to_doc()), flush=True)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
