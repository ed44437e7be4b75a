"""The standing differential oracle: schedule-matched host replay.

The port's copy of `madsim_tpu/oracle.py`. It replays lanes on the port's
host twins (`madsim_tpu_torch.workloads`), shrinks through the port's
`triage.ddmin`, dedups through the port's `campaign.bug_signature`, and
anchors divergences with the port's `causal` host-lineage checks; its
digests, bundles and `oracle.json` are the JAX face's, byte for byte
(tests/test_torch_oracle.py).

Every fault a compiled `FaultPlan` injects is a pure function of the
seed (nemesis.py's murmur3 chain), and since the host `NemesisDriver`
consumes the SAME compiled stream the device executes — schedule events
verbatim, loss/dup/reorder coins through `ScheduleCoins`, integer-ppm
skew through `node_skew` — a host replay of a device lane is a
controlled A/B: any surface where the host-applied stream drifts from
the pure recomputation is a first-class bug, not noise.

This module promotes the twin machinery to that standing oracle:

  * `check_seed` replays one (spec, plan, seed) lane on the host twin
    (workloads/raft_host.py, workloads/chain_host.py) and compares four
    surfaces against pure recomputation: the applied schedule stream,
    per-node skew ppm, every logged coin draw (draw-for-draw against
    `coin32`/`randint32` at the shared NET_SITE_* sites), and the
    host-lineage Lamport law (`causal.check_host_lineage`) — plus
    repeat-digest determinism across `repeats` runs.
  * A mismatch becomes a `Divergence` naming the FIRST divergent event,
    anchored into the lineage DAG via `causal.host_causal_slice`.
  * `shrink_divergence` ddmin-shrinks a diverging lane through
    `triage.ddmin` (host-replay evaluator) into a `ReproBundle` with
    `violation_kind="divergence"` (format v3 unchanged — the `kind`
    field suffices; the `causal` digest carries the host slice).
  * `divergence_bug` dedups shrunk divergences through
    `campaign.bug_signature` into a `BugRecord` on the campaign.
  * `OracleTenant` runs all of that as the `campaign serve` background
    tenant: an idle-CPU consumer sampling lanes from every generation
    (`sample_rate` knob, per-round cap for graceful degradation when
    saturated), with kill/restart-resumable cursors in `oracle.json`.

Never vacuously green: set MADSIM_TPU_ORACLE_PLANT=
reorder_window_off_by_one (nemesis.PLANT_ENV) and the host's reorder
window skews by one — the oracle must catch it
(tests/test_torch_oracle.py).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from . import causal
from . import nemesis as nem
from . import telemetry

# --------------------------------------------------------------------------
# host twins — which specs the oracle can replay
# --------------------------------------------------------------------------


# spec-name prefix -> schedule-matched host twin runner, derived from
# the consolidated workload registry (entries flagged oracle_twin). A
# twin runs ONE lane with `plan=`/`occ_off=` (NemesisDriver mode) and
# lineage on, and returns the workload dict whose "nemesis" key is the
# artifact bundle the comparator consumes. Specs without an entry are
# skipped (counted, never silently).
from . import workloads as _workload_registry

HOST_TWINS: Dict[str, Callable[..., dict]] = _workload_registry.oracle_twins()

# direct handles for the two standing twins (tests drive them one-off)
_raft_twin = HOST_TWINS["raft"]
_chain_twin = HOST_TWINS["chain"]


def twin_for(spec_name: str) -> Optional[Callable[..., dict]]:
    for prefix, fn in HOST_TWINS.items():
        if spec_name.startswith(prefix):
            return fn
    return None


# deterministic lane-sampling coin site (shares the murmur3 vocabulary
# with nemesis.NET_SITE_* / NEM_SITE_* but collides with neither)
ORACLE_SAMPLE_SITE = 40

MAX_DIVERGENCES = 8  # per report; the FIRST one is the headline


# --------------------------------------------------------------------------
# divergences + the report
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Divergence:
    """One host-vs-schedule mismatch, anchored to its first divergent
    event: `site`/`index`/`applied`/`expected` for coin divergences,
    `t_us` virtual time, `eid` the host-lineage anchor whose causal
    slice (`slice_text` / `slice_digest`) names the delivery chain that
    led to the divergent draw."""

    kind: str  # schedule|skew|coin|coin_overflow|lineage|nondeterminism|host_invariant
    detail: str
    t_us: int = -1
    eid: int = -1
    site: Optional[str] = None
    index: int = -1
    applied: Any = None
    expected: Any = None
    slice_text: str = ""
    slice_digest: Optional[Dict[str, Any]] = None

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class OracleReport:
    """One lane's oracle verdict: the surfaces checked and every
    divergence found (first = the headline the causal slice names)."""

    spec_name: str
    seed: int
    plan_name: str
    divergences: List[Divergence]
    schedule_events: int = 0
    draws: int = 0
    draws_dropped: int = 0
    skew_nodes: int = 0
    lineage_edges: int = 0
    digest: str = ""
    repeats: int = 1

    @property
    def diverged(self) -> bool:
        return bool(self.divergences)

    @property
    def first(self) -> Optional[Divergence]:
        return self.divergences[0] if self.divergences else None

    def render(self) -> str:
        head = (
            f"oracle {self.spec_name} seed={self.seed} plan={self.plan_name}: "
            f"{self.schedule_events} schedule events, {self.draws} coin "
            f"draws, {self.skew_nodes} skewed nodes, "
            f"{self.lineage_edges} lineage edges, x{self.repeats} repeats"
        )
        if not self.diverged:
            return head + " -> MATCH"
        d = self.first
        lines = [head + f" -> {len(self.divergences)} DIVERGENCE(S)"]
        lines.append(f"first divergent event ({d.kind}): {d.detail}")
        if d.slice_text:
            lines.append("causal slice to the divergent delivery:")
            lines.append(d.slice_text)
        return "\n".join(lines)

    def to_dict(self) -> Dict[str, Any]:
        doc = dataclasses.asdict(self)
        doc["diverged"] = self.diverged
        return doc


# --------------------------------------------------------------------------
# the comparator
# --------------------------------------------------------------------------


def state_digest(art: Dict[str, Any]) -> str:
    """Canonical digest of a twin run's final state + fire counts + skew
    (JSON over sorted keys; tuples normalize to lists)."""
    doc = {
        "state": art.get("state"),
        "fires": dict(sorted((art.get("fires") or {}).items())),
        "skew": dict(sorted((art.get("node_skew") or {}).items())),
    }
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True, default=list).encode()
    ).hexdigest()[:16]


def _anchor(lineage, eid: int, max_len: int = 16) -> Tuple[str, Optional[dict]]:
    if lineage is None or not getattr(lineage, "events", None):
        return "", None
    chain = causal.host_causal_slice(lineage, eid, max_len=max_len)
    if not chain:
        return "", None
    return causal.format_host_slice(chain), causal.host_slice_digest(chain)


def compare(
    plan: nem.FaultPlan,
    seed: int,
    horizon_us: int,
    n_nodes: int,
    art: Dict[str, Any],
    occ_off: Optional[Dict[str, int]] = None,
) -> List[Divergence]:
    """Compare one twin run's `"nemesis"` artifact bundle against pure
    recomputation from (plan, seed). Returns divergences in event order
    (first = earliest); empty list = all four surfaces match."""
    divs: List[Divergence] = []
    lineage = art.get("lineage")

    # -- surface 1: the applied schedule stream, verbatim ------------------
    expected_sched = [
        ev for ev in nem.filter_schedule(
            plan.schedule(seed, horizon_us, n_nodes), occ_off or {}
        )
        if ev.kind != "skew"  # applied at install time, checked as skew
    ]
    applied = list(art.get("applied") or [])
    for i, (a, e) in enumerate(zip(applied, expected_sched)):
        if a != e:
            divs.append(Divergence(
                kind="schedule", t_us=e.t_us,
                detail=f"applied event #{i} is `{a}`, schedule says `{e}`",
                applied=str(a), expected=str(e),
            ))
            break
    else:
        if len(applied) != len(expected_sched):
            k = min(len(applied), len(expected_sched))
            extra = (applied[k:] or expected_sched[k:])[0]
            divs.append(Divergence(
                kind="schedule", t_us=extra.t_us,
                detail=(
                    f"host applied {len(applied)} schedule events, pure "
                    f"schedule has {len(expected_sched)} (first unmatched: "
                    f"`{extra}`)"
                ),
                applied=len(applied), expected=len(expected_sched),
            ))

    # -- surface 2: integer-ppm skew assignment ----------------------------
    node_ids = list(art.get("node_ids") or range(n_nodes))
    want_skew = {
        node_ids[i]: ppm
        for i, ppm in enumerate(plan.skew_ppm(seed, n_nodes))
        if ppm != 0
    }
    got_skew = dict(art.get("node_skew") or {})
    if got_skew != want_skew:
        divs.append(Divergence(
            kind="skew",
            detail=f"host node_skew {got_skew} != schedule {want_skew}",
            applied=got_skew, expected=want_skew,
        ))

    # -- surface 3: every coin draw, against the pure chain ----------------
    # HOST_COIN_METHODS is the fourth-face contract: it names every
    # ScheduleCoins draw method per message clause, and COIN_SITE names
    # each method's murmur3 site — iterating THAT table (not a local
    # copy) is what lets the mirror lint prove a new clause cannot ship
    # without an oracle face.
    coins = art.get("coins")
    if coins is not None:
        key = nem.key_from_seed(seed)
        clause_of_method = {
            m: cname
            for cname, methods in nem.HOST_COIN_METHODS.items()
            for m in methods
        }
        site_name = {nem.COIN_SITE[m]: m for m in clause_of_method}
        rate_of: Dict[str, float] = {}
        for cname, cls in nem.MESSAGE_CLAUSES.items():
            clause = plan.get(cls)
            if clause is not None:
                rate_of[cname] = clause.rate
        reorder = plan.get(nem.Reorder)
        disk = plan.get(nem.DiskFault)
        coin_spans = dict(getattr(coins, "spans", None) or {})
        for site, index, value, t_ns, eid in coins.draws:
            name = site_name.get(site)
            cname = clause_of_method.get(name or "")
            if name == "reorder_extra":
                if reorder is None:
                    expect: Any = None
                else:
                    # the exact span NetSim computes (net/netsim.py):
                    # float window_us -> ns, rounded, floor 1
                    span = max(round(reorder.window_us / 1e6 * 1e9), 1)
                    expect = nem.randint32(key, site, 0, span, index=index)
            elif name == "disk_torn_extent":
                # the span is host state (the victim's unsynced tail
                # length), logged by ScheduleCoins alongside the draw;
                # given the span the value is pure in (seed, site, index)
                if disk is None or disk.torn_rate <= 0:
                    expect = None
                else:
                    span = coin_spans.get((site, index))
                    if span is None:
                        continue  # pre-span artifact: value unverifiable
                    expect = nem.randint32(
                        key, site, 0, max(int(span), 1), index=index
                    )
            elif cname in rate_of:
                expect = int(
                    nem.coin32(key, site, rate_of[cname], index=index)
                )
            else:
                expect = None
            if expect is None:
                detail = (
                    f"host drew a {name or site} coin (index {index}) but "
                    "the plan has no such clause"
                )
            elif value != expect:
                detail = (
                    f"{name} draw #{index} applied {value}, pure chain "
                    f"says {expect} (t={t_ns / 1e9:.6f}s)"
                )
            else:
                continue
            text, dig = _anchor(lineage, eid)
            divs.append(Divergence(
                kind="coin", detail=detail, t_us=t_ns // 1000 if t_ns >= 0 else -1,
                eid=eid, site=name, index=index, applied=value,
                expected=expect, slice_text=text, slice_digest=dig,
            ))
            if len(divs) >= MAX_DIVERGENCES:
                break
        if coins.dropped:
            divs.append(Divergence(
                kind="coin_overflow",
                detail=(
                    f"{coins.dropped} draws past MAX_COIN_DRAWS were not "
                    "retained; only the logged prefix was verified"
                ),
                applied=coins.dropped, expected=0,
            ))

    # -- surface 4: the host-lineage Lamport law ---------------------------
    if lineage is not None:
        try:
            causal.check_host_lineage(lineage)
        except causal.LineageError as e:
            divs.append(Divergence(kind="lineage", detail=str(e)))

    # earliest-first so `first` names the first divergent event
    divs.sort(key=lambda d: (d.t_us if d.t_us >= 0 else 1 << 62))
    return divs


def check_seed(
    spec_name: str,
    plan: nem.FaultPlan,
    seed: int,
    horizon_us: int,
    n_nodes: int = 5,
    loss_rate: float = 0.1,
    occ_off: Optional[Dict[str, int]] = None,
    repeats: int = 2,
) -> OracleReport:
    """Replay one lane on the host twin and run the full comparison:
    four schedule-matched surfaces plus repeat-digest determinism.
    Raises ValueError when `spec_name` has no host twin."""
    twin = twin_for(spec_name)
    if twin is None:
        raise ValueError(
            f"no host twin for spec {spec_name!r} "
            f"(HOST_TWINS: {sorted(HOST_TWINS)})"
        )
    virtual_secs = horizon_us / 1e6
    rep = OracleReport(
        spec_name=spec_name, seed=int(seed), plan_name=plan.name,
        divergences=[], repeats=max(int(repeats), 1),
    )
    digests: List[str] = []
    first_art: Optional[dict] = None
    for r in range(rep.repeats):
        try:
            run = twin(seed, plan, occ_off, n_nodes, virtual_secs, loss_rate)
        except AssertionError as e:
            # host invariant violation under the schedule-matched plan —
            # first-class too (the device lane may or may not share it)
            rep.divergences.append(Divergence(
                kind="host_invariant",
                detail=f"{type(e).__name__}: {str(e)[:200]}",
            ))
            return rep
        art = run.get("nemesis") or {}
        digests.append(state_digest(art))
        if r == 0:
            first_art = art
    art = first_art or {}
    rep.schedule_events = len(art.get("applied") or ())
    coins = art.get("coins")
    rep.draws = len(coins.draws) if coins is not None else 0
    rep.draws_dropped = int(coins.dropped) if coins is not None else 0
    rep.skew_nodes = len(art.get("node_skew") or {})
    lineage = art.get("lineage")
    rep.lineage_edges = len(lineage.edges) if lineage is not None else 0
    rep.digest = digests[0] if digests else ""
    rep.divergences = compare(
        plan, seed, horizon_us, n_nodes, art, occ_off=occ_off
    )
    if len(set(digests)) > 1:
        rep.divergences.append(Divergence(
            kind="nondeterminism",
            detail=(
                f"state digests differ across {rep.repeats} repeats: "
                f"{digests}"
            ),
            applied=digests, expected=[digests[0]] * len(digests),
        ))
    return rep


# --------------------------------------------------------------------------
# shrinking a divergence (triage.ddmin over host replays)
# --------------------------------------------------------------------------


def _kept_to_masks(
    kept: Sequence[Tuple[str, Optional[int]]],
    all_atoms: Sequence[Tuple[str, Optional[int]]],
) -> Tuple[List[str], Dict[str, int]]:
    """A kept-set as (dropped clause names, occurrence masks) — the
    host-replay face of triage._atom_rows."""
    kept_set = set(kept)
    dropped: List[str] = []
    occ_off: Dict[str, int] = {}
    for name, k in all_atoms:
        if (name, k) in kept_set:
            continue
        if k is None:
            dropped.append(name)
        else:
            occ_off[name] = occ_off.get(name, 0) | (1 << k)
    return sorted(set(dropped)), occ_off


def shrink_divergence(
    spec_name: str,
    plan: nem.FaultPlan,
    seed: int,
    horizon_us: int,
    n_nodes: int = 5,
    loss_rate: float = 0.1,
    out_dir: Optional[str] = None,
    cfg=None,
    spec_ref: Optional[str] = None,
    spec_kwargs: Optional[Dict[str, Any]] = None,
):
    """ddmin a diverging lane to a 1-minimal fault plan, entirely on the
    host: the atom universe comes from `triage.enumerate_atoms`, each
    candidate kept-set replays the shrunk plan through the twin, and
    "violates" means `check_seed` still diverges. Returns a
    `triage.ShrinkResult` whose bundle has `violation_kind="divergence"`
    and the first divergent event's host causal slice in `causal`.
    Raises `triage.NotReproducible` when the lane does not diverge."""
    import types

    from . import triage

    shim = cfg if cfg is not None else types.SimpleNamespace(
        chaos_enabled=False, partition_enabled=False
    )
    atoms = triage.enumerate_atoms(
        plan, shim, seed, horizon_us, n_nodes
    )
    replays = [0]

    def diverges(kept: Sequence[Tuple[str, Optional[int]]]) -> bool:
        dropped, occ = _kept_to_masks(kept, atoms)
        sub = triage.shrink_plan(plan, dropped, {})
        replays[0] += 1
        return check_seed(
            spec_name, sub, seed, horizon_us, n_nodes=n_nodes,
            loss_rate=loss_rate, repeats=1,
        ).diverged

    if not diverges(atoms):
        raise triage.NotReproducible(
            f"seed {seed} does not diverge under the full plan "
            f"{plan.name!r} — nothing to shrink"
        )

    def batch_violates(cands):
        return [diverges(kept) for kept in cands]

    kept = triage.ddmin(list(atoms), batch_violates)
    dropped, occ_off = _kept_to_masks(kept, atoms)
    shrunk = triage.shrink_plan(plan, dropped, {})
    final = check_seed(
        spec_name, shrunk, seed, horizon_us, n_nodes=n_nodes,
        loss_rate=loss_rate, occ_off=occ_off, repeats=2,
    )
    first = final.first
    bundle = triage.ReproBundle(
        seed=int(seed),
        spec_ref=spec_ref,
        spec_kwargs=dict(spec_kwargs or {}),
        spec_name=spec_name,
        n_nodes=int(n_nodes),
        config_toml=cfg.to_toml() if cfg is not None else "",
        config_hash=cfg.hash() if cfg is not None else "",
        violation_kind="divergence",
        violation_step=0,
        violation_t_us=int(first.t_us) if first and first.t_us >= 0 else 0,
        dropped_clauses=list(dropped),
        occ_off=dict(occ_off),
        rate_scale={},
        horizon_us=int(horizon_us),
        max_steps=0,
        plan=triage.plan_to_json(shrunk),
        trace_tail=final.render().splitlines(),
        causal=first.slice_digest if first else None,
    )
    bundle_path = None
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        bundle_path = os.path.join(
            out_dir, f"divergence-{spec_name}-seed{seed}.json"
        )
        bundle.save(bundle_path)
    sr = triage.ShrinkResult(
        bundle=bundle, bundle_path=bundle_path, dispatches=replays[0],
        original_atoms=len(atoms), kept_atoms=list(kept),
    )
    if telemetry.enabled():
        telemetry.record_shrink(sr, workload=spec_name, kind="divergence")
    return sr


# --------------------------------------------------------------------------
# campaign integration — BugRecords with kind="divergence"
# --------------------------------------------------------------------------


def divergence_bug(
    campaign_obj,
    report: OracleReport,
    plan: nem.FaultPlan,
    horizon_us: int,
    n_nodes: int,
    loss_rate: float = 0.1,
    shrink: bool = True,
    generation: Optional[int] = None,
):
    """Fold one diverging lane into the campaign's dedup layer: shrink
    (host ddmin), sign with `campaign.bug_signature(spec, "divergence",
    kept_atoms)`, merge by signature into an existing `BugRecord` or
    open a new one with `violation_kind="divergence"`. Returns the
    record. Shrink failures degrade to a whole-plan signature with
    `shrink_error` recorded — dedup must outlive triage."""
    from .campaign import BugRecord, bug_signature, clause_profile

    spec_name = report.spec_name
    gen = int(generation if generation is not None
              else getattr(campaign_obj, "generation", 0))
    kept = [
        (name, None)
        for name in sorted(
            nem.CLAUSE_OF_EVENT[ev.kind]
            for ev in plan.schedule(report.seed, horizon_us, n_nodes)
            if ev.kind in nem.CLAUSE_OF_EVENT
        )
    ]
    bundle_path = None
    shrink_error = None
    if shrink:
        try:
            sr = shrink_divergence(
                spec_name, plan, report.seed, horizon_us,
                n_nodes=n_nodes, loss_rate=loss_rate,
                out_dir=getattr(campaign_obj, "bundles_dir", None),
                cfg=getattr(
                    getattr(campaign_obj, "workload", None), "config", None
                ),
                spec_ref=getattr(campaign_obj, "spec_ref", None),
                spec_kwargs=getattr(campaign_obj, "spec_kwargs", None),
            )
            kept = list(sr.kept_atoms)
            signature = bug_signature(spec_name, "divergence", kept)
            sr.bundle.stamp(
                signature, getattr(campaign_obj, "campaign_id", None), gen
            )
            if sr.bundle_path:
                sr.bundle.save(sr.bundle_path)
                bundle_path = sr.bundle_path
        except Exception as e:  # noqa: BLE001 - dedup must outlive triage
            shrink_error = f"{type(e).__name__}: {str(e)[:160]}"
            signature = bug_signature(spec_name, "divergence", kept)
    else:
        signature = bug_signature(spec_name, "divergence", kept)
    witness = {
        "seed": int(report.seed),
        "candidate": None,  # oracle lanes replay full plans, not genomes
        "dispatch": gen,
        "origin": "oracle",
        "cov_digest": None,
    }
    existing = campaign_obj._by_sig.get(signature)
    if existing is not None:
        existing.witnesses.append(witness)
        return existing
    record = BugRecord(
        signature=signature,
        spec_name=spec_name,
        violation_kind="divergence",
        clause_profile=clause_profile(kept),
        witnesses=[witness],
        bundle_path=bundle_path,
        campaign=getattr(campaign_obj, "campaign_id", "oracle"),
        first_generation=gen,
        coarse_keys=[],
        shrink_error=shrink_error,
    )
    campaign_obj.bugs.append(record)
    campaign_obj._by_sig[signature] = record
    return record


# --------------------------------------------------------------------------
# the serve tenant
# --------------------------------------------------------------------------


def _atomic_json(path: str, doc: Dict[str, Any]) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        f.write(json.dumps(doc, indent=2, sort_keys=True) + "\n")
    os.replace(tmp, path)


class OracleTenant:
    """The idle-CPU oracle lane inside `campaign serve`: after each
    round's device slices, sample lanes from every campaign's NEW
    generations (deterministic per-seed coin at `sample_rate`), replay
    them schedule-matched on the host twin, and fold divergences into
    the campaign's BugRecords. `per_round` caps host replays per round —
    when a round surfaces more sampled lanes than the budget, the rest
    are counted as `skipped_saturated` (graceful degradation, never
    silent). Cursors + counters persist atomically to `state_path`
    (oracle.json), so a killed service resumes where it stopped."""

    def __init__(
        self,
        sample_rate: float = 0.25,
        per_round: int = 2,
        repeats: int = 2,
        max_shrinks: int = 4,
        state_path: Optional[str] = None,
        log: Optional[Callable[[str], None]] = None,
    ) -> None:
        self.sample_rate = float(sample_rate)
        self.per_round = int(per_round)
        self.repeats = int(repeats)
        self.max_shrinks = int(max_shrinks)
        self.state_path = state_path
        self.say = log or (lambda msg: None)
        self.cursor: Dict[str, int] = {}  # campaign id -> gens consumed
        self.seeds_checked = 0
        self.divergences = 0
        self.shrinks_done = 0
        self.skipped_no_twin = 0
        self.skipped_saturated = 0
        self.errors = 0
        self.draws_checked = 0
        if state_path and os.path.exists(state_path):
            try:
                with open(state_path) as f:
                    self.restore(json.load(f))
            except (json.JSONDecodeError, OSError, KeyError, TypeError):
                pass  # a torn state file resets cursors, never the serve

    # ------------------------------------------------------------ persist

    def state(self) -> Dict[str, Any]:
        return {
            "format": "madsim-tpu-oracle/1",
            "cursor": dict(self.cursor),
            "seeds_checked": self.seeds_checked,
            "divergences": self.divergences,
            "shrinks_done": self.shrinks_done,
            "skipped_no_twin": self.skipped_no_twin,
            "skipped_saturated": self.skipped_saturated,
            "errors": self.errors,
            "draws_checked": self.draws_checked,
            "sample_rate": self.sample_rate,
            "per_round": self.per_round,
        }

    def restore(self, doc: Dict[str, Any]) -> None:
        self.cursor = {str(k): int(v) for k, v in doc["cursor"].items()}
        for k in (
            "seeds_checked", "divergences", "shrinks_done",
            "skipped_no_twin", "skipped_saturated", "errors",
            "draws_checked",
        ):
            setattr(self, k, int(doc.get(k, 0)))

    def save(self) -> None:
        if self.state_path:
            _atomic_json(self.state_path, self.state())

    def status(self) -> Dict[str, Any]:
        """The status.json face (and record_oracle's input)."""
        return {
            "seeds_checked": self.seeds_checked,
            "divergences": self.divergences,
            "shrinks_done": self.shrinks_done,
            "skipped_no_twin": self.skipped_no_twin,
            "skipped_saturated": self.skipped_saturated,
            "errors": self.errors,
            "draws_checked": self.draws_checked,
            "sample_rate": self.sample_rate,
            "per_round": self.per_round,
        }

    # ------------------------------------------------------------ sampling

    def _sampled(self, cid: str, campaign_obj) -> List[int]:
        """Seeds to replay this round: corpus lanes from generations past
        this campaign's cursor, thinned by a deterministic per-seed coin
        (same murmur3 vocabulary as the schedules, so the sample is a
        pure function of (seed, generation) — two services checking the
        same campaign check the same lanes)."""
        gen = int(getattr(campaign_obj, "generation", 0))
        last = self.cursor.get(cid, 0)
        if gen <= last:
            return []
        self.cursor[cid] = gen
        seeds: List[int] = []
        for e in getattr(campaign_obj.ex, "corpus", ()):
            if not last <= int(e.dispatch) < gen:
                continue
            s = int(e.cand.seed)
            if nem.coin32(
                nem.key_from_seed(s), ORACLE_SAMPLE_SITE,
                self.sample_rate, index=int(e.dispatch),
            ):
                seeds.append(s)
        return sorted(set(seeds))

    # ------------------------------------------------------------ observe

    def observe(self, cid: str, campaign_obj) -> Dict[str, Any]:
        """One campaign, one round: sample, replay, compare, absorb.
        Never raises — per-lane failures are counted in `errors` (the
        tenant must not take the farm down)."""
        out = {"campaign": cid, "checked": 0, "diverged": 0, "skipped": 0}
        spec_name = getattr(campaign_obj, "spec_name", "")
        if twin_for(spec_name) is None:
            self.skipped_no_twin += 1
            out["skipped"] = 1
            return out
        from . import triage

        try:
            cfg = campaign_obj.workload.config
            plan = triage.plan_from_config(cfg, name=f"{spec_name}-oracle")
            horizon_us = int(cfg.horizon_us)
            n_nodes = int(campaign_obj.workload.spec.n_nodes)
            loss_rate = float(getattr(cfg, "loss_rate", 0.1))
        except Exception as e:  # noqa: BLE001 - tenant survives
            self.errors += 1
            self.say(
                f"oracle {cid}: cannot derive plan: "
                f"{type(e).__name__}: {str(e)[:120]}"
            )
            return out
        seeds = self._sampled(cid, campaign_obj)
        budget = seeds[: self.per_round]
        self.skipped_saturated += len(seeds) - len(budget)
        out["skipped"] += len(seeds) - len(budget)
        for seed in budget:
            try:
                rep = check_seed(
                    spec_name, plan, seed, horizon_us,
                    n_nodes=n_nodes, loss_rate=loss_rate,
                    repeats=self.repeats,
                )
            except Exception as e:  # noqa: BLE001 - tenant survives
                self.errors += 1
                self.say(
                    f"oracle {cid} seed {seed}: "
                    f"{type(e).__name__}: {str(e)[:120]}"
                )
                continue
            self.seeds_checked += 1
            self.draws_checked += rep.draws
            out["checked"] += 1
            if rep.diverged:
                self.divergences += 1
                out["diverged"] += 1
                self.say(rep.render())
                do_shrink = self.shrinks_done < self.max_shrinks
                if do_shrink:
                    self.shrinks_done += 1
                try:
                    divergence_bug(
                        campaign_obj, rep, plan, horizon_us, n_nodes,
                        loss_rate=loss_rate, shrink=do_shrink,
                    )
                except Exception as e:  # noqa: BLE001
                    self.errors += 1
                    self.say(
                        f"oracle {cid} absorb failed: "
                        f"{type(e).__name__}: {str(e)[:120]}"
                    )
        if telemetry.enabled():
            telemetry.record_oracle(self.status(), campaign=cid)
        self.save()
        return out
