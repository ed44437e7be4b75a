"""Campaigns: persistent corpus, bug dedup, merge + minimize, regression,
and the watch-dir fuzz service.

The port of `madsim_tpu/campaign.py`. The explorer
(`explore.py`) lives one process at a time: the corpus, the coverage union
and every violation it found end with it. A campaign persists them:

  * **Checkpoints are exact.** `Explorer.snapshot()` captures the whole
    search state (the MetaRng counter cursor, the fresh-seed cursor, the
    union bitmap, the corpus with its bitmaps, the seen-genome set, the
    violations); kill then resume gives the uninterrupted run's
    `ExploreReport.fingerprint()`, curves, corpus digest and violations,
    in one process or across processes.
  * **Merge + minimize is one batched dispatch per `lane_width`
    candidates.** Every candidate of the merged corpora replays with
    coverage on, then the smallest greedy lane set whose bitmap union
    equals the merged union is kept; `minimize` raises unless the kept
    union equals the merged union in popcount and word for word.
  * **Bugs dedup by signature, not by seed.** Violations group by
    `coarse_key` (workload, kind, candidate genome without its seed); the
    first witness of a new group is ddmin-shrunk within its candidate's
    suppressions, its shrunk plan's clause profile keys the `BugRecord`
    (`bug_signature`), and every later violation of the group is one more
    witness seed. The shrunk bundle is stamped with the signature, the
    campaign id and the generation (`ReproBundle.stamp`) and copied into
    the regression corpus, which `regress` replays green.

What crosses faces. A checkpoint either face writes resumes in the other:
`manifest.json` (format `CAMPAIGN_FORMAT`) names generation-stamped
sidecars, `corpus.<tag>.jsonl`, `seen.<tag>.jsonl`,
`violations.<tag>.jsonl`, `bugs.<tag>.jsonl` and `report.<tag>.json`,
each with its sha256, and carries the snapshot's scalar state (`state`:
meta-seed, lanes, `meta_cursor`, `next_fresh`, generation, curves, the
union), `params` (`explorer_params`: exactly the JAX face's keys),
`campaign_params`, `config_hash`, `spec_name`, `campaign_id`,
`workload`, `seen_violations`, `shrinks_done`, `tuning` (the resolved
Tier-A dict the campaign runs under, or None) and `kind`. The card a run uses (`device=`) is a runtime argument
and is never written. The port holds u32 words in int64 tensors; every
bitmap leaves the engine through `explore._u32` as a true uint32 array,
so a corpus line's `bitmap` is the hex of the JAX face's little-endian
u32 bytes and its `cov_digest` that of the same bytes; the union is
written the same way. Seeds are Python ints below 2**32, genomes are
JSON lists `[seed, off, occ_off, rate_scale, horizon_us]` with rate
scales as the float32 values the JAX face writes (0.25, 0.5, 1.0).
Named workloads write `spec_ref` "madsim_tpu_torch.campaign:spec_for";
a JAX checkpoint's "madsim_tpu.campaign:spec_for" is read as it.

The fuzz service (`serve`) watches `<dir>/queue/` for request files,
time-slices the campaigns round-robin, streams one JSON line per slice and
checkpoints after every slice, as on the JAX face. Its differential-oracle
tenant (`oracle.OracleTenant`, on by default; `--no-oracle` turns it off)
replays a sample of each slice's lanes on the host twins between slices,
on this thread, and keeps its cursors in `<dir>/oracle.json`.

CLI:

    python -m madsim_tpu_torch.campaign run --workload raft --storm --generations 8 --dir D
    python -m madsim_tpu_torch.campaign merge --out MERGED D1 D2 ...
    python -m madsim_tpu_torch.campaign regress [--dir D]
    python -m madsim_tpu_torch.campaign serve --dir D

(each with `--device cpu` to run on the CPU; the card is the default).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import glob
import hashlib
import json
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import telemetry
from .explore import (
    Candidate,
    CorpusEntry,
    Explorer,
    ExploreReport,
    _u32,
    canon_genome,
    ctl_for,
    popcount_rows,
)

CAMPAIGN_FORMAT = "madsim-tpu-campaign/1"

MANIFEST = "manifest.json"
STATUS = "status.json"  # the serve farm-status surface
METRICS_TEXTFILE = "metrics.prom"
CORPUS = "corpus.jsonl"
SEEN = "seen.jsonl"
VIOLATIONS = "violations.jsonl"
BUGS = "bugs.jsonl"
REPORT = "report.json"
REPORTS_STREAM = "reports.jsonl"
BUNDLE_DIR = "bundles"
REGRESSION_DIR = "regression"

# the spec factory bundles of named workloads name, and the JAX face's
# name for it (read as the port's)
SPEC_FOR_REF = "madsim_tpu_torch.campaign:spec_for"
JAX_SPEC_FOR_REF = "madsim_tpu.campaign:spec_for"


# --------------------------------------------------------------------------
# small file plumbing (atomic writes: a kill mid-checkpoint must leave the
# previous checkpoint readable)
# --------------------------------------------------------------------------


def _write_text(path: str, text: str) -> str:
    tmp = f"{path}.tmp-{os.getpid()}"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, path)
    return path


def _write_json(path: str, doc: Any) -> str:
    return _write_text(path, json.dumps(doc, indent=2, sort_keys=True) + "\n")


def _jsonl(text: str) -> List[Any]:
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def _read_jsonl(path: str) -> List[Any]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return _jsonl(f.read())


# --------------------------------------------------------------------------
# workload references — how a manifest names the thing it fuzzes
# --------------------------------------------------------------------------


def build_workload(ref: Dict[str, Any]):
    """Rebuild a BatchWorkload from a manifest's workload reference.

    Only `kind: "named"` refs (the CLI vocabulary) are constructible here;
    a campaign over a custom in-code workload writes `kind: "custom"` and
    must be resumed with `Campaign.resume(dir, workload=...)` — the config
    hash check still guards the match."""
    if ref.get("kind") != "named":
        raise ValueError(
            "manifest workload is not CLI-constructible "
            f"({ref.get('kind')!r}); pass workload= to Campaign.resume"
        )
    from .explore import _named_workload

    try:
        return _named_workload(
            str(ref["name"]), float(ref.get("virtual_secs", 2.0)),
            bool(ref.get("storm", False)),
        )
    except SystemExit as e:
        # _named_workload speaks CLI (SystemExit on unknown names); as a
        # library error it must be catchable
        raise ValueError(str(e)) from None


def spec_for(name: str, virtual_secs: float = 2.0):
    """ProtocolSpec factory for named workloads — the `spec_ref` target
    baked into campaign bundles (`SPEC_FOR_REF`), so
    `python -m madsim_tpu_torch.repro bundle.json` works from any
    process."""
    from .explore import _named_workload

    return _named_workload(name, virtual_secs, False).spec


def named_workload_ref(
    name: str, virtual_secs: float, storm: bool,
) -> Dict[str, Any]:
    return {
        "kind": "named", "name": name,
        "virtual_secs": float(virtual_secs), "storm": bool(storm),
    }


# --------------------------------------------------------------------------
# bug signatures — the dedup key
# --------------------------------------------------------------------------


def clause_profile(kept_atoms: Sequence[Tuple[str, Optional[int]]]) -> List[list]:
    """The SHAPE of a shrunk minimal fault plan: per clause, how many
    occurrence atoms survived ddmin (-1 = the whole-clause atom survived).
    Occurrence indices are dropped: which crash window triggers a bug
    varies seed to seed, the minimal plan's shape does not."""
    prof: Dict[str, int] = {}
    for name, k in kept_atoms:
        if k is None:
            prof[name] = -1
        elif prof.get(name) != -1:
            prof[name] = prof.get(name, 0) + 1
    return [[n, c] for n, c in sorted(prof.items())]


def _sha_of_json(payload: Dict[str, Any]) -> str:
    return hashlib.sha256(
        json.dumps(payload, sort_keys=True, separators=(",", ":")).encode()
    ).hexdigest()


def bug_signature(
    spec_name: str,
    violation_kind: str,
    kept_atoms: Sequence[Tuple[str, Optional[int]]],
) -> str:
    """The stable dedup key of a bug class: sha256 over (workload spec,
    violation kind, shrunk-plan clause profile). A violating lane's
    bitmap digest is seed-unique, so it is per-witness evidence on the
    BugRecord, not the key."""
    return _sha_of_json({
        "spec": str(spec_name),
        "kind": str(violation_kind),
        "clauses": clause_profile(kept_atoms),
    })


def coarse_key(spec_name: str, violation_kind: str, genome) -> str:
    """Pre-shrink grouping key: (spec, kind, candidate ctl genome minus
    the seed). Every fresh-seed violation of one workload shares it, so a
    seed-dense bug pays ONE shrink."""
    _, off, occ, rs, h = canon_genome(genome)
    return "coarse-" + _sha_of_json({
        "spec": str(spec_name), "kind": str(violation_kind),
        "ctl": [off, list(occ), list(rs), h],
    })


def bug_anatomy(
    workload,
    record: "BugRecord",
    max_witnesses: int = 4,
    max_len: Optional[int] = None,
    log: Optional[Callable[[str], None]] = None,
    label_cache: Optional[Dict[int, Dict[str, Any]]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Cross-witness bug anatomy: align >= 1 witnesses' causal slices.

    Each witness replays once, single-lane, with the causal-lineage plane
    on (`causal.explain` on `device`) under its own candidate ctl; the
    slices' canonical label sequences fold into the shared event
    SKELETON, and what each witness has beyond it is its seed-local
    noise. Witnesses replay in seed order, so the skeleton is
    deterministic. `label_cache` (seed -> computed row) makes a refresh
    replay only the witnesses it has not seen."""
    from . import causal

    say = log or (lambda msg: None)
    wits = sorted(
        record.witnesses, key=lambda w: int(w["seed"])
    )[: int(max_witnesses)]
    if not wits:
        raise ValueError("bug_anatomy needs a record with >= 1 witness")
    spec, cfg = workload.spec, workload.config
    rows: List[Dict[str, Any]] = []
    label_seqs: List[List[str]] = []
    for w in wits:
        seed = int(w["seed"])
        cached = None if label_cache is None else label_cache.get(seed)
        if cached is not None:
            label_seqs.append(list(cached["labels"]))
            rows.append(dict(cached))
            continue
        genome = canon_genome(tuple(w["candidate"]))
        cand = Candidate(
            seed=genome[0], off=genome[1], occ_off=genome[2],
            rate_scale=genome[3], horizon_us=genome[4],
        )
        _, sl = causal.explain(
            spec, cfg, seed,
            ctl=ctl_for([cand], cfg.horizon_us, device),
            max_steps=int(workload.max_steps), max_len=max_len,
            device=device,
        )
        labels = causal.slice_labels(sl)
        label_seqs.append(labels)
        row = {
            "seed": seed,
            "chain_len": len(sl.chain),
            "cone_size": sl.cone_size,
            "depth": sl.depth,
            "labels": labels,
        }
        rows.append(row)
        if label_cache is not None:
            label_cache[seed] = dict(row)
        if telemetry.enabled():
            telemetry.record_causal(
                {"depth": sl.depth, "cone_size": sl.cone_size,
                 "chain_len": len(sl.chain)},
                workload=spec.name, signature=record.signature[:12],
            )
    skel = causal.skeleton(label_seqs)
    for row in rows:
        row["noise"] = len(row.pop("labels")) - len(skel)
    anatomy = {
        "skeleton": skel,
        "skeleton_sha": hashlib.sha256(
            json.dumps(skel, separators=(",", ":")).encode()
        ).hexdigest()[:16],
        "witnesses": rows,
    }
    say(
        f"anatomy {record.signature[:12]}: skeleton {len(skel)} shared "
        f"events over {len(rows)} witnesses "
        f"(noise {[r['noise'] for r in rows]})"
    )
    return anatomy


@dataclasses.dataclass
class BugRecord:
    """One deduplicated bug class: the signature that keys it, the shrunk
    repro of its first witness, and every witness seed since."""

    signature: str
    spec_name: str
    violation_kind: str
    clause_profile: List[list]
    witnesses: List[Dict[str, Any]]  # {seed, candidate, dispatch, origin, cov_digest}
    bundle_path: Optional[str]
    campaign: str
    first_generation: int
    coarse_keys: List[str]
    shrink_error: Optional[str] = None
    # optional cross-witness bug anatomy (Campaign(anatomy=True) or
    # bug_anatomy()); None on anatomy-off campaigns
    anatomy: Optional[Dict[str, Any]] = None

    @property
    def witness_seeds(self) -> List[int]:
        return [int(w["seed"]) for w in self.witnesses]

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(doc: Dict[str, Any]) -> "BugRecord":
        fields = {f.name for f in dataclasses.fields(BugRecord)}
        unknown = set(doc) - fields
        if unknown:
            raise ValueError(f"unknown BugRecord fields: {sorted(unknown)}")
        return BugRecord(**{k: doc[k] for k in fields if k in doc})


# --------------------------------------------------------------------------
# checkpoint save/load
# --------------------------------------------------------------------------


_SIDECAR_KEYS = ("corpus", "seen", "violations", "bugs", "report")


def _sidecar_names(gen_tag: str) -> Dict[str, str]:
    """Generation-stamped sidecar file names: two checkpoints never share
    a file, so the manifest replace below is a true commit point."""
    return {
        "corpus": f"corpus.{gen_tag}.jsonl",
        "seen": f"seen.{gen_tag}.jsonl",
        "violations": f"violations.{gen_tag}.jsonl",
        "bugs": f"bugs.{gen_tag}.jsonl",
        "report": f"report.{gen_tag}.json",
    }


def _sha256(text: str) -> str:
    return hashlib.sha256(text.encode()).hexdigest()


def save_checkpoint(
    dir: str,
    snapshot: Dict[str, Any],
    manifest_extra: Dict[str, Any],
    bugs: Sequence[BugRecord] = (),
    report: Optional[ExploreReport] = None,
) -> str:
    """Write one campaign checkpoint with a whole-checkpoint commit point.

    The sidecars are written first under new generation-and-content
    stamped names with their sha256 recorded; the manifest, which names
    the exact files and digests, is replaced LAST, atomically. A kill
    anywhere mid-checkpoint leaves the previous manifest pointing at the
    previous, untouched sidecars. Sidecars no manifest references are
    removed only after the new manifest commits."""
    os.makedirs(dir, exist_ok=True)
    texts = {
        "corpus": "".join(
            json.dumps(d, sort_keys=True) + "\n"
            for d in snapshot.get("corpus", [])
        ),
        "seen": "".join(
            json.dumps({"genome": g}, sort_keys=True) + "\n"
            for g in snapshot.get("seen", [])
        ),
        "violations": "".join(
            json.dumps(d, sort_keys=True) + "\n"
            for d in snapshot.get("violations", [])
        ),
        "bugs": "".join(
            json.dumps(b.to_dict(), sort_keys=True) + "\n" for b in bugs
        ),
    }
    if report is not None:
        texts["report"] = json.dumps(
            report.to_dict(), indent=2, sort_keys=True
        ) + "\n"
    # the tag is the generation plus a content digest: a re-checkpoint at
    # the same generation with different content writes fresh names
    # instead of rewriting files the committed manifest still references
    blob = hashlib.sha256()
    for key in sorted(texts):
        blob.update(key.encode())
        blob.update(texts[key].encode())
    gen_tag = f"{int(snapshot.get('generation', 0))}-{blob.hexdigest()[:8]}"
    names = _sidecar_names(gen_tag)
    files: Dict[str, str] = {}
    digests: Dict[str, str] = {}
    for key, text in texts.items():
        _write_text(os.path.join(dir, names[key]), text)
        files[key] = names[key]
        digests[key] = _sha256(text)
    manifest = {
        "format": CAMPAIGN_FORMAT,
        "files": files,
        "file_sha256": digests,
        "state": {
            k: v for k, v in snapshot.items()
            if k not in ("corpus", "seen", "violations")
        },
        **manifest_extra,
    }
    _write_json(os.path.join(dir, MANIFEST), manifest)  # the commit point
    _gc_stale_sidecars(dir, keep=set(files.values()))
    return dir


def _gc_stale_sidecars(dir: str, keep: set) -> None:
    for key in _SIDECAR_KEYS:
        for path in glob.glob(os.path.join(dir, f"{key}.*.json*")):
            if os.path.basename(path) not in keep:
                try:
                    os.remove(path)
                except OSError:
                    pass  # best-effort: a stale file is dead weight, not harm


def _read_sidecar(dir: str, manifest: Dict[str, Any], key: str,
                  legacy_name: str) -> str:
    """Read one manifest-named sidecar, verifying its digest — a torn,
    partially copied or hand-edited checkpoint fails loudly."""
    files = manifest.get("files") or {}
    name = files.get(key, legacy_name)
    path = os.path.join(dir, name)
    if not os.path.exists(path):
        if key in files:
            raise AssertionError(
                f"checkpoint file {name} referenced by the manifest is "
                "missing — partial copy or torn checkpoint"
            )
        return ""
    with open(path) as f:
        text = f.read()
    want = (manifest.get("file_sha256") or {}).get(key)
    if want and _sha256(text) != want:
        raise AssertionError(
            f"checkpoint file {name} does not match its manifest digest — "
            "torn or corrupt checkpoint"
        )
    return text


def _read_manifest(dir: str) -> Dict[str, Any]:
    with open(os.path.join(dir, MANIFEST)) as f:
        return json.load(f)


def load_checkpoint(dir: str) -> Dict[str, Any]:
    """Load a checkpoint directory back into {manifest, snapshot, bugs},
    verifying every sidecar against the manifest's digests."""
    manifest = _read_manifest(dir)
    fmt = manifest.get("format", "")
    if fmt != CAMPAIGN_FORMAT:
        raise ValueError(
            f"unsupported campaign format {fmt!r} (want {CAMPAIGN_FORMAT!r})"
        )
    snapshot = dict(manifest.get("state", {}))
    snapshot["corpus"] = _jsonl(_read_sidecar(dir, manifest, "corpus", CORPUS))
    snapshot["seen"] = [
        d["genome"] for d in _jsonl(_read_sidecar(dir, manifest, "seen", SEEN))
    ]
    snapshot["violations"] = _jsonl(
        _read_sidecar(dir, manifest, "violations", VIOLATIONS)
    )
    bugs = [
        BugRecord.from_dict(d)
        for d in _jsonl(_read_sidecar(dir, manifest, "bugs", BUGS))
    ]
    return {"manifest": manifest, "snapshot": snapshot, "bugs": bugs}


def export_explorer(
    dir: str,
    ex: Explorer,
    workload_ref: Optional[Dict[str, Any]] = None,
    campaign_id: Optional[str] = None,
) -> str:
    """Write a bare Explorer's state as a campaign checkpoint (the explore
    CLI's `--out`). `seen_violations` is 0, so a later
    `Campaign.resume(dir).run(k)` dedups the recorded violations into
    BugRecords on its first slice."""
    extra = {
        "campaign_id": campaign_id or default_campaign_id(ex),
        "workload": workload_ref or {"kind": "custom"},
        "config_hash": ex.cfg.hash(),
        "spec_name": ex.workload.spec.name,
        "params": explorer_params(ex),
        "seen_violations": 0,
        "kind": "campaign",
    }
    return save_checkpoint(dir, ex.snapshot(), extra, bugs=(),
                           report=ex.report())


def explorer_params(ex: Explorer) -> Dict[str, Any]:
    """The Explorer constructor parameters a resume must replay (the
    snapshot carries state; these carry configuration). The JAX face's
    keys exactly: the device is not one of them."""
    return {
        "meta_seed": ex.meta_seed,
        "lanes": ex.lanes,
        "chunk": ex.chunk,
        "fresh_frac": ex.fresh_frac,
        "mutant_frac": ex.mutant_frac,
        "top_k": ex.top_k,
        "swarm_group": ex.swarm_group,
        "pipeline": ex.pipeline,
        # dispatch-shape knobs: results are identical across them, but a
        # resume replays the mode so the dispatch budget matches
        "device_loop": ex.device_loop,
        "device_window": ex.device_window,
        "seen_cap": ex.seen_cap,
    }


def default_campaign_id(ex: Explorer) -> str:
    """Deterministic campaign identity: same workload config + meta-seed
    IS the same (replayable) campaign."""
    return f"{ex.workload.spec.name}-m{ex.meta_seed}-{ex.cfg.hash()[:8]}"


# --------------------------------------------------------------------------
# the campaign
# --------------------------------------------------------------------------


class Campaign:
    """A persistent, resumable fuzz campaign over one workload.

        c = Campaign(workload, dir="/data/c1", meta_seed=7, lanes=256)
        c.run(8)           # 8 explorer generations + bug dedup
        c.checkpoint()     # exact resume point on disk
        ...
        c2 = Campaign.resume("/data/c1")   # (named workloads rebuild
        c2.run(8)                          #  themselves from the manifest)

    The campaign owns violation triage: its Explorer runs with
    `shrink_violations=False`, and after each `run` the new violations go
    through the dedup layer (`_absorb_violations`). Bundles land in
    `<dir>/bundles/` and are copied into the regression corpus
    (`<dir>/regression/` unless `regression_dir` or
    $MADSIM_REGRESSION_DIR names a shared one). `device` is the card the
    explorer's sim is built on when no `sim` is passed ("cpu" runs on the
    CPU); it is a runtime argument, never persisted. `tuning` is resolved
    once, here, for that device ("auto" consults its tuned-config cache),
    and the RESOLVED Tier-A dict is what the checkpoint persists: a resume
    replays it without re-tuning.
    """

    def __init__(
        self,
        workload,
        dir: str,
        meta_seed: int = 0,
        lanes: int = 256,
        chunk: Optional[int] = None,
        campaign_id: Optional[str] = None,
        workload_ref: Optional[Dict[str, Any]] = None,
        shrink: bool = True,
        max_shrinks: int = 8,
        lane_width: int = 16,
        spec_ref: Optional[str] = None,
        spec_kwargs: Optional[Dict[str, Any]] = None,
        regression_dir: Optional[str] = None,
        sim=None,
        pipeline: Optional[bool] = None,
        log: Optional[Callable[[str], None]] = None,
        explorer_kwargs: Optional[Dict[str, Any]] = None,
        anatomy: bool = False,
        max_anatomy_witnesses: int = 4,
        tuning: Any = None,
        device="cuda",
    ) -> None:
        self.workload = workload
        self.dir = str(dir)
        self.tuning: Optional[Dict[str, Any]] = None
        if tuning is not None:
            from . import tune as _tune
            from .tpu.spec import SimConfig

            resolved = _tune.resolve_tuning(
                tuning, workload.spec.name,
                workload.config or SimConfig(), int(lanes),
                device=device if sim is None else sim.device,
            )
            self.tuning = resolved or None
        self.shrink = bool(shrink)
        self.max_shrinks = int(max_shrinks)
        # runtime policy like shrink: resume restores it from
        # campaign_params, an explicit argument overrides
        self.anatomy = bool(anatomy)
        self.max_anatomy_witnesses = int(max_anatomy_witnesses)
        # signature -> {seed -> computed slice row}: each witness replays
        # once per campaign process however many refreshes its record sees
        self._anatomy_cache: Dict[str, Dict[int, Dict[str, Any]]] = {}
        self.lane_width = int(lane_width)
        self.spec_ref = spec_ref
        self.spec_kwargs = dict(spec_kwargs or {})
        self.say = log or (lambda msg: None)
        # pipeline rides the Explorer's None sentinel so a tuned value can
        # land when the caller omitted it; explorer_params persists the
        # APPLIED value, which resume replays explicitly
        self.ex = Explorer(
            workload, meta_seed=meta_seed, lanes=lanes, chunk=chunk,
            shrink_violations=False, pipeline=pipeline, sim=sim, log=log,
            tuning=self.tuning, device=device, **(explorer_kwargs or {}),
        )
        self.campaign_id = campaign_id or default_campaign_id(self.ex)
        self.workload_ref = workload_ref or {"kind": "custom"}
        # producer default mirrors the `regress` consumer's: an explicit
        # argument, then $MADSIM_REGRESSION_DIR, then the campaign's own
        self.regression_dir = (
            regression_dir
            or os.environ.get("MADSIM_REGRESSION_DIR")
            or os.path.join(self.dir, REGRESSION_DIR)
        )
        self.bundles_dir = os.path.join(self.dir, BUNDLE_DIR)
        self.bugs: List[BugRecord] = []
        self._by_sig: Dict[str, BugRecord] = {}
        self._by_coarse: Dict[str, BugRecord] = {}
        self._seen_violations = 0
        self._shrinks_done = 0

    # ------------------------------------------------------------ identity

    @property
    def generation(self) -> int:
        return self.ex._gen

    @property
    def spec_name(self) -> str:
        return self.workload.spec.name

    # ----------------------------------------------------------------- run

    def run(self, generations: int) -> ExploreReport:
        """Run `generations` explorer generations, then dedup the slice's
        new violations into BugRecords (shrinking at most `max_shrinks`
        first witnesses over the campaign's lifetime)."""
        report = self.ex.run(int(generations))
        self._absorb_violations()
        return report

    def report(self) -> ExploreReport:
        return self.ex.report()

    def _absorb_violations(self) -> None:
        new = self.ex.violations[self._seen_violations:]
        self._seen_violations = len(self.ex.violations)
        for rec in new:
            genome = canon_genome(rec["candidate"])
            gen = int(rec["dispatch"])
            witness = {
                "seed": int(rec["seed"]),
                "candidate": list(genome),
                "dispatch": gen,
                "origin": rec.get("origin", "fresh"),
                "cov_digest": rec.get("cov_digest"),
            }
            record = self._by_coarse.get(
                coarse_key(self.spec_name, "invariant", genome)
            )
            if record is None:
                record = self._new_record(rec, genome, gen)
            record.witnesses.append(witness)
            if (
                self.anatomy
                and 2 <= len(record.witnesses) <= self.max_anatomy_witnesses
            ):
                # refresh the skeleton as witnesses arrive; an anatomy
                # failure is recorded on the record, as on the JAX face
                try:
                    record.anatomy = bug_anatomy(
                        self.workload, record,
                        max_witnesses=self.max_anatomy_witnesses,
                        log=self.say,
                        label_cache=self._anatomy_cache.setdefault(
                            record.signature, {}
                        ),
                        device=self.ex.sim.device,
                    )
                except Exception as e:  # noqa: BLE001
                    record.anatomy = {
                        "error": f"{type(e).__name__}: {str(e)[:160]}"
                    }

    def _new_record(self, rec, genome, gen: int) -> BugRecord:
        """Resolve a violation whose coarse group is new: shrink its first
        witness to compute the full signature (budget permitting), merge
        into an existing record when the signature matches, else open
        one. A failed shrink is kept on the record as `shrink_error`."""
        ck = coarse_key(self.spec_name, "invariant", genome)
        signature = ck  # the weak fallback key when no shrink runs
        profile: List[list] = []
        kind = "invariant"
        bundle_path = None
        shrink_error = None
        if self.shrink and self._shrinks_done < self.max_shrinks:
            from . import triage

            self._shrinks_done += 1
            cand = Candidate(
                seed=genome[0], off=genome[1], occ_off=genome[2],
                rate_scale=genome[3], horizon_us=genome[4],
            )
            os.makedirs(self.bundles_dir, exist_ok=True)
            try:
                sr = triage.shrink_seed(
                    self.workload, genome[0], sim=self.ex.sim,
                    base_ctl=cand.base_ctl(), out_dir=self.bundles_dir,
                    lane_width=self.lane_width, spec_ref=self.spec_ref,
                    spec_kwargs=self.spec_kwargs or None,
                )
                kind = sr.bundle.violation_kind
                profile = clause_profile(sr.kept_atoms)
                signature = bug_signature(
                    self.spec_name, kind, sr.kept_atoms
                )
                sr.bundle.stamp(signature, self.campaign_id, gen)
                if sr.bundle_path:
                    sr.bundle.save(sr.bundle_path)
                    bundle_path = sr.bundle_path
                    os.makedirs(self.regression_dir, exist_ok=True)
                    sr.bundle.save(os.path.join(
                        self.regression_dir, os.path.basename(sr.bundle_path)
                    ))
                self.say(
                    f"bug {signature[:12]}: shrunk seed {genome[0]} "
                    f"({len(sr.kept_atoms)} atoms kept) -> {bundle_path}"
                )
            except Exception as e:  # noqa: BLE001 - dedup must outlive triage
                shrink_error = f"{type(e).__name__}: {str(e)[:160]}"
        existing = self._by_sig.get(signature)
        if existing is not None:
            # a different candidate shape shrank to the same minimal class
            existing.coarse_keys.append(ck)
            self._by_coarse[ck] = existing
            return existing
        record = BugRecord(
            signature=signature,
            spec_name=self.spec_name,
            violation_kind=kind,
            clause_profile=profile,
            witnesses=[],
            bundle_path=bundle_path,
            campaign=self.campaign_id,
            first_generation=gen,
            coarse_keys=[ck],
            shrink_error=shrink_error,
        )
        self.bugs.append(record)
        self._by_sig[signature] = record
        self._by_coarse[ck] = record
        return record

    # ---------------------------------------------------------- checkpoint

    def checkpoint(self) -> str:
        extra = {
            "campaign_id": self.campaign_id,
            "workload": self.workload_ref,
            "config_hash": self.ex.cfg.hash(),
            "spec_name": self.spec_name,
            "params": explorer_params(self.ex),
            "campaign_params": {
                "shrink": self.shrink,
                "max_shrinks": self.max_shrinks,
                "anatomy": self.anatomy,
                "max_anatomy_witnesses": self.max_anatomy_witnesses,
                "lane_width": self.lane_width,
                "spec_ref": self.spec_ref,
                "spec_kwargs": self.spec_kwargs,
                # a resume keeps feeding the same (possibly shared)
                # regression corpus without re-passing the flag
                "regression_dir": self.regression_dir,
            },
            "seen_violations": self._seen_violations,
            "shrinks_done": self._shrinks_done,
            # the RESOLVED Tier-A tuning (None = the defaults): resume
            # replays it verbatim and never re-tunes
            "tuning": self.tuning,
            "kind": "campaign",
        }
        return save_checkpoint(
            self.dir, self.ex.snapshot(), extra, bugs=self.bugs,
            report=self.ex.report(),
        )

    @classmethod
    def resume(
        cls,
        dir: str,
        workload=None,
        sim=None,
        regression_dir: Optional[str] = None,
        log: Optional[Callable[[str], None]] = None,
        tuning: Any = None,
        device="cuda",
    ) -> "Campaign":
        """Rebuild a campaign from its checkpoint, either face's: same
        workload (rebuilt from the manifest for named workloads, else
        passed in), same explorer parameters, exact search state —
        `resume(d).run(k)` fingerprints as the uninterrupted run does.
        The checkpoint's resolved tuning applies; an explicit `tuning` must
        resolve (for `device`) to the same dict, or the resume is refused
        rather than silently change the dispatch shape mid-campaign."""
        ck = load_checkpoint(dir)
        man = ck["manifest"]
        if man.get("kind") == "merged":
            raise ValueError(
                "a merged corpus has no meta-rng cursor to resume; import "
                "it via merge, or start a fresh campaign over it"
            )
        if workload is None:
            workload = build_workload(man["workload"])
        params = dict(man["params"])
        cparams = dict(man.get("campaign_params") or {})
        spec_ref = cparams.get("spec_ref")
        spec_kwargs = cparams.get("spec_kwargs")
        if spec_ref == JAX_SPEC_FOR_REF:
            spec_ref = SPEC_FOR_REF
        if spec_ref is None and man["workload"].get("kind") == "named":
            # an `explore --out` export carries no campaign params: its
            # bundles would otherwise carry no spec factory
            spec_ref = SPEC_FOR_REF
            spec_kwargs = {
                "name": man["workload"]["name"],
                "virtual_secs": man["workload"].get("virtual_secs", 2.0),
            }
        man_tuning = man.get("tuning") or None
        if tuning is not None:
            from . import tune as _tune
            from .tpu.spec import SimConfig

            resolved = _tune.resolve_tuning(
                tuning, workload.spec.name,
                workload.config or SimConfig(), int(params["lanes"]),
                device=device if sim is None else sim.device,
            ) or None
            if resolved != man_tuning:
                raise ValueError(
                    f"resume tuning {resolved} conflicts with the "
                    f"checkpoint's persisted tuning {man_tuning} — a "
                    "resumed campaign replays the tuning it was created "
                    "under; omit tuning= (the checkpoint's applies), or "
                    "start a fresh campaign to re-tune"
                )
        c = cls(
            workload, dir,
            meta_seed=int(params["meta_seed"]),
            lanes=int(params["lanes"]),
            chunk=int(params["chunk"]),
            campaign_id=man["campaign_id"],
            workload_ref=man["workload"],
            shrink=bool(cparams.get("shrink", True)),
            max_shrinks=int(cparams.get("max_shrinks", 8)),
            anatomy=bool(cparams.get("anatomy", False)),
            max_anatomy_witnesses=int(
                cparams.get("max_anatomy_witnesses", 4)
            ),
            lane_width=int(cparams.get("lane_width", 16)),
            spec_ref=spec_ref,
            spec_kwargs=spec_kwargs,
            regression_dir=regression_dir or cparams.get("regression_dir"),
            sim=sim,
            pipeline=bool(params.get("pipeline", True)),
            log=log,
            tuning=man_tuning,
            explorer_kwargs={
                k: params[k] for k in
                ("fresh_frac", "mutant_frac", "top_k", "swarm_group",
                 "device_loop", "device_window", "seen_cap")
                if k in params
            },
            device=device,
        )
        got = c.ex.cfg.hash()
        want = man.get("config_hash")
        if want and got != want:
            raise ValueError(
                f"workload config hash {got} does not match the "
                f"checkpoint's {want} — resuming a different configuration "
                "would silently fork the campaign"
            )
        c.ex.restore(ck["snapshot"])
        c.bugs = list(ck["bugs"])
        for b in c.bugs:
            c._by_sig[b.signature] = b
            for k in b.coarse_keys:
                c._by_coarse[k] = b
        c._seen_violations = int(man.get("seen_violations", 0))
        c._shrinks_done = int(man.get("shrinks_done", 0))
        return c


# --------------------------------------------------------------------------
# corpus merge + cmin minimization
# --------------------------------------------------------------------------


def load_report(dir: str) -> Optional[ExploreReport]:
    """The checkpoint's latest ExploreReport (None if none was saved)."""
    text = _read_sidecar(dir, _read_manifest(dir), "report", REPORT)
    return ExploreReport.from_dict(json.loads(text)) if text else None


def load_corpus(dir: str) -> List[CorpusEntry]:
    return [
        CorpusEntry.from_dict(d)
        for d in _jsonl(_read_sidecar(dir, _read_manifest(dir), "corpus",
                                      CORPUS))
    ]


def merge_entry_lists(
    lists: Sequence[Sequence[CorpusEntry]],
) -> List[CorpusEntry]:
    """Concatenate several in-memory corpora, first occurrence of each
    genome winning, in list order (the merge primitive shared by
    `merge_corpora` and the island federation's coverage exchange)."""
    entries: List[CorpusEntry] = []
    seen: set = set()
    for lst in lists:
        for e in lst:
            key = canon_genome(e.cand.key())
            if key in seen:
                continue
            seen.add(key)
            entries.append(e)
    return entries


def merge_corpora(dirs: Sequence[str]) -> Tuple[List[CorpusEntry], List[dict]]:
    """Concatenate the corpora of several campaign directories, first
    occurrence of each genome winning, and verify they fuzzed the SAME
    workload spec and compiled configuration."""
    manifests: List[dict] = []
    corpora: List[List[CorpusEntry]] = []
    hashes = set()
    spec_names = set()
    for d in dirs:
        man = _read_manifest(d)
        manifests.append(man)
        if man.get("config_hash"):
            hashes.add(man["config_hash"])
        if man.get("spec_name"):
            spec_names.add(man["spec_name"])
        corpora.append(load_corpus(d))
    with telemetry.span("merge", site="campaign", corpora=len(dirs)):
        entries = merge_entry_lists(corpora)
    if len(hashes) > 1:
        raise ValueError(
            f"corpora were fuzzed under {len(hashes)} different configs "
            f"({sorted(hashes)}) — merge is only defined within one config"
        )
    if len(spec_names) > 1:
        raise ValueError(
            f"corpora come from different workload specs "
            f"({sorted(spec_names)}) — their coverage spaces are unrelated"
        )
    return entries, manifests


def minimize(
    workload,
    entries: Sequence[CorpusEntry],
    sim=None,
    lane_width: int = 64,
    verify_bitmaps: bool = True,
    log: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """AFL-`cmin` as batched dispatches: replay every candidate lane with
    coverage on (chunks of `lane_width` lanes, the last padded with copies
    of its first candidate whose rows are discarded), then greedily keep
    the minimal lane set whose bitmap union equals the merged union. The
    preservation claim is RAISED on here — popcount and exact array
    equality — and with `verify_bitmaps` every replayed bitmap must equal
    the one its entry recorded (a lane's bitmap does not depend on its
    lane, nor on the lanes beside it). `sim` is a
    `BatchedSim(triage=True, coverage=True)`; without one, one is built
    on `device`.

    Returns {kept: [CorpusEntry], union, merged_bits, kept_bits,
    replayed, dispatches}. Kept entries carry their REPLAYED bitmaps."""
    from .tpu.batch import pipelined
    from .tpu.engine import BatchedSim

    say = log or (lambda msg: None)
    if not entries:
        return {
            "kept": [], "union": None, "merged_bits": 0, "kept_bits": 0,
            "replayed": 0, "dispatches": 0,
        }
    if sim is None:
        sim = BatchedSim(
            workload.spec, workload.config, triage=True, coverage=True,
            device=device,
        )
    elif not (sim.triage and sim.coverage):
        raise ValueError(
            "minimize needs a BatchedSim(..., triage=True, coverage=True)"
        )
    full_h = int(sim.config.horizon_us)
    lane_width = max(2, int(lane_width))
    bitmaps: List[np.ndarray] = []
    dispatches = 0

    def dispatch(lo: int):
        nonlocal dispatches
        part = list(entries[lo:lo + lane_width])
        n = len(part)
        part = part + [part[0]] * (lane_width - n)
        cands = [e.cand for e in part]
        seeds = np.asarray([c.seed for c in cands], np.uint32)
        with telemetry.span("dispatch", site="cmin", off=lo):
            st = sim.run(
                seeds, max_steps=workload.max_steps,
                ctl=ctl_for(cands, full_h, sim.device),
            )
        dispatches += 1
        return n, st

    def decode(entry) -> None:
        n, st = entry
        bm = _u32(st.cov.bitmap)
        for i in range(n):
            bitmaps.append(bm[i].copy())

    pipelined(range(0, len(entries), lane_width), dispatch, decode)

    if verify_bitmaps:
        for e, bm in zip(entries, bitmaps):
            if not np.array_equal(e.bitmap, bm):
                raise AssertionError(
                    f"corpus entry (seed {e.cand.seed}) replayed to a "
                    "different coverage bitmap than it recorded — the "
                    "corpus and this config/engine disagree (schema "
                    "drift, or a corrupt corpus line)"
                )

    merged_union = np.zeros_like(bitmaps[0])
    for bm in bitmaps:
        merged_union |= bm
    merged_bits = int(popcount_rows(merged_union[None, :])[0])

    # greedy cover in deterministic order: densest bitmap first (ties by
    # genome) — each pick keeps a lane only if it still adds new bits
    counts = popcount_rows(np.stack(bitmaps))
    order = sorted(
        range(len(entries)),
        key=lambda i: (-int(counts[i]), canon_genome(entries[i].cand.key())),
    )
    kept_idx: List[int] = []
    union = np.zeros_like(merged_union)
    covered = 0
    for i in order:
        if not (bitmaps[i] & ~union).any():
            continue
        kept_idx.append(i)
        union |= bitmaps[i]
        covered = int(popcount_rows(union[None, :])[0])
        if covered == merged_bits:
            break
    # an explicit raise, not `assert`: it must survive python -O
    if covered != merged_bits or not np.array_equal(union, merged_union):
        raise AssertionError(
            f"cmin dropped coverage: kept-set union has {covered} bits, "
            f"the merged union {merged_bits}"
        )
    kept_idx.sort()
    kept = [
        dataclasses.replace(entries[i], bitmap=bitmaps[i]) for i in kept_idx
    ]
    say(
        f"cmin: {len(entries)} candidates -> {len(kept)} kept, "
        f"{merged_bits} union bits preserved, {dispatches} dispatches"
    )
    return {
        "kept": kept, "union": union, "merged_bits": merged_bits,
        "kept_bits": covered, "replayed": len(entries),
        "dispatches": dispatches,
    }


def merge_and_minimize(
    dirs: Sequence[str],
    out_dir: str,
    workload=None,
    sim=None,
    lane_width: int = 64,
    log: Optional[Callable[[str], None]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """Merge several campaign corpora and write the cmin-minimized corpus
    to `out_dir` (manifest kind "merged": importable, not resumable — a
    merged corpus has no single meta-rng cursor)."""
    entries, manifests = merge_corpora(dirs)
    if workload is None:
        workload = build_workload(manifests[0]["workload"])
    res = minimize(
        workload, entries, sim=sim, lane_width=lane_width, log=log,
        device=device,
    )
    os.makedirs(out_dir, exist_ok=True)
    union_hex = (
        res["union"].tobytes().hex() if res["union"] is not None else ""
    )
    corpus_text = "".join(
        json.dumps(e.to_dict(), sort_keys=True) + "\n" for e in res["kept"]
    )
    # content-addressed like save_checkpoint's sidecars
    corpus_name = f"corpus.merged-{_sha256(corpus_text)[:8]}.jsonl"
    _write_text(os.path.join(out_dir, corpus_name), corpus_text)
    # manifest last: the commit point
    _write_json(os.path.join(out_dir, MANIFEST), {
        "format": CAMPAIGN_FORMAT,
        "kind": "merged",
        "files": {"corpus": corpus_name},
        "file_sha256": {"corpus": _sha256(corpus_text)},
        "merged_from": [m.get("campaign_id") for m in manifests],
        "workload": manifests[0].get("workload"),
        "config_hash": manifests[0].get("config_hash"),
        "spec_name": manifests[0].get("spec_name"),
        "union": union_hex,
        "merged_bits": res["merged_bits"],
        "kept": len(res["kept"]),
        "candidates": res["replayed"],
    })
    _gc_stale_sidecars(out_dir, keep={corpus_name})
    return res


# --------------------------------------------------------------------------
# regression replay
# --------------------------------------------------------------------------


def default_regression_dir() -> str:
    return os.environ.get(
        "MADSIM_REGRESSION_DIR",
        os.path.join(os.getcwd(), ".madsim_regression"),
    )


def regress(
    dir: Optional[str] = None,
    spec=None,
    repeats: int = 1,
    out=print,
    device="cuda",
) -> Dict[str, Any]:
    """Replay every ReproBundle in a regression corpus on `device`
    (`repro.replay_device`) and report which stayed green (still violate
    exactly as recorded; a red one is a prior bug's repro that stopped
    reproducing). Given a campaign directory, the regression corpus its
    manifest names is used. An empty or missing dir is vacuously green."""
    from . import repro

    dir = dir or default_regression_dir()
    if os.path.exists(os.path.join(dir, MANIFEST)):
        man = _read_manifest(dir)
        dir = (man.get("campaign_params") or {}).get(
            "regression_dir"
        ) or os.path.join(dir, REGRESSION_DIR)
    bundles = sorted(glob.glob(os.path.join(dir, "*.json")))
    failures: List[Dict[str, str]] = []
    for path in bundles:
        try:
            bundle = repro.ReproBundle.load(path)
            repro.replay_device(bundle, spec=spec, repeats=repeats, out=out,
                                device=device)
        except Exception as e:  # noqa: BLE001 - report every bundle
            failures.append({
                "bundle": path, "error": f"{type(e).__name__}: {str(e)[:200]}"
            })
            out(f"REGRESSION RED: {path}: {e}")
    out(
        f"regression: {len(bundles) - len(failures)}/{len(bundles)} bundles "
        f"green ({dir})"
    )
    return {"dir": dir, "bundles": len(bundles), "failures": failures}


def check_resume_conflicts(manifest: Dict[str, Any],
                           given: Dict[str, Any]) -> None:
    """Refuse to resume a checkpoint under explicitly different search
    parameters — silently continuing a different search is the one
    mistake no fingerprint catches. `given` holds only the knobs the
    caller EXPLICITLY provided; omitted knobs defer to the checkpoint."""
    params = manifest.get("params") or {}
    ref = manifest.get("workload") or {}
    conflicts = []
    for key in ("meta_seed", "lanes", "chunk"):
        if key in given and int(given[key]) != params.get(key):
            conflicts.append(
                f"{key} {given[key]} != checkpoint {params.get(key)}"
            )
    if "workload" in given and str(given["workload"]) != ref.get("name"):
        conflicts.append(
            f"workload {given['workload']!r} != checkpoint "
            f"{ref.get('name')!r}"
        )
    if "virtual_secs" in given and \
            float(given["virtual_secs"]) != ref.get("virtual_secs"):
        conflicts.append(
            f"virtual_secs {given['virtual_secs']} != checkpoint "
            f"{ref.get('virtual_secs')}"
        )
    if "storm" in given and bool(given["storm"]) != bool(
        ref.get("storm", False)
    ):
        conflicts.append(
            f"storm {given['storm']} != checkpoint {ref.get('storm')}"
        )
    if "tuning" in given:
        want = given["tuning"] or None
        have = manifest.get("tuning") or None
        if want != have:
            conflicts.append(
                f"tuning {want} != checkpoint tuning {have}"
            )
    if conflicts:
        raise ValueError(
            "request conflicts with the existing checkpoint: "
            + "; ".join(conflicts)
        )


def _explicit_request_params(
    request: Dict[str, Any], manifest: Optional[Dict[str, Any]] = None,
    device="cuda",
) -> Dict[str, Any]:
    """The knobs a service request explicitly pins (chunk 0/null means
    'default', like the CLI flag, so it never counts as explicit). A
    request's string `tuning` ("auto", a cache path) resolves FIRST, for
    `device` and against the checkpoint's own workload and lane scale —
    exactly what Campaign() resolved at creation — so the conflict check
    compares resolved dicts: a restart with "tuning": "auto" resumes while
    the tuned cache is unchanged and is rejected once it was re-tuned."""
    given = {
        k: request[k]
        for k in ("workload", "virtual_secs", "storm", "meta_seed", "lanes")
        if request.get(k) is not None
    }
    if request.get("chunk"):
        given["chunk"] = request["chunk"]
    if "tuning" in request:
        given["tuning"] = request["tuning"]
        ref = (manifest or {}).get("workload") or {}
        if isinstance(given["tuning"], str) and ref.get("kind") == "named":
            from . import tune as _tune
            from .tpu.spec import SimConfig

            wl = build_workload(ref)
            given["tuning"] = _tune.resolve_tuning(
                given["tuning"], wl.spec.name,
                wl.config or SimConfig(),
                int((manifest or {}).get("params", {}).get("lanes", 256)),
                device=device,
            ) or None
    return given


def _default_factory(request: Dict[str, Any], campaign_dir: str,
                     regression_dir: str, log, device="cuda") -> Campaign:
    """serve's campaign factory: resume `campaign_dir` when it holds a
    checkpoint (refusing a request that explicitly contradicts it), else
    start the request's named-workload campaign on `device`."""
    name = str(request.get("workload", "raft"))
    virtual_secs = float(request.get("virtual_secs", 2.0))
    storm = bool(request.get("storm", False))
    if os.path.exists(os.path.join(campaign_dir, MANIFEST)):
        man = _read_manifest(campaign_dir)
        check_resume_conflicts(
            man, _explicit_request_params(request, man, device=device)
        )
        c = Campaign.resume(
            campaign_dir, regression_dir=regression_dir, log=log,
            device=device,
        )
        # triage knobs are runtime policy, not search identity (they never
        # touch the explorer fingerprint) — an explicit request overrides
        if "shrink" in request:
            c.shrink = bool(request["shrink"])
        if request.get("max_shrinks") is not None:
            c.max_shrinks = int(request["max_shrinks"])
        return c
    ref = named_workload_ref(name, virtual_secs, storm)
    return Campaign(
        build_workload(ref), campaign_dir,
        meta_seed=int(request.get("meta_seed", 0)),
        lanes=int(request.get("lanes", 256)),
        chunk=int(request["chunk"]) if request.get("chunk") else None,
        campaign_id=request.get("id"),
        workload_ref=ref,
        shrink=bool(request.get("shrink", True)),
        max_shrinks=int(request.get("max_shrinks", 8)),
        spec_ref=SPEC_FOR_REF,
        spec_kwargs={"name": name, "virtual_secs": virtual_secs},
        regression_dir=regression_dir,
        log=log,
        tuning=request.get("tuning"),
        device=device,
    )


def _device_ctx(dev):
    """`torch.cuda.device(dev)` for a CUDA torch device; a no-op context
    for None, a CPU device and the stub tokens the scheduling tests use."""
    import contextlib

    if isinstance(dev, torch.device) and dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def _place(campaign, dev) -> None:
    """Run `campaign`'s sweeps on `dev` from this slice on: its explorer's
    sim becomes the sim's twin there (`BatchedSim.on`; the search state is
    on the host, so the results do not change). Stub campaigns and device
    tokens that are not torch devices are left as they are."""
    ex = getattr(campaign, "ex", None)
    if isinstance(dev, torch.device) and getattr(ex, "sim", None) is not None:
        ex.sim = ex.sim.on(dev)


def serve(
    dir: str,
    poll_s: float = 0.5,
    slice_generations: int = 1,
    max_rounds: Optional[int] = None,
    idle_rounds: Optional[int] = None,
    out=print,
    log: Optional[Callable[[str], None]] = None,
    factory: Optional[Callable[..., Any]] = None,
    sleep: Callable[[float], None] = time.sleep,
    devices: Optional[Sequence[Any]] = None,
    oracle: bool = True,
    oracle_sample_rate: float = 0.25,
    oracle_per_round: int = 2,
    device="cuda",
) -> Dict[str, Any]:
    """The fuzz-farm front end: watch `<dir>/queue/` for request files,
    time-slice the device between active campaigns round-robin
    (`slice_generations` explorer generations per turn), stream ONE JSON
    line per slice ({campaign, generation, device, fingerprint, report}),
    and checkpoint after every slice — a kill at any slice boundary
    resumes exactly where it stopped.

    With `devices` (the CLI's `--devices`), every round distributes the
    active campaigns over the devices — least-loaded first, honoring each
    request's optional `"devices": [idx, ...]` pin — and the per-device
    slice lanes run concurrently, one thread per device (a device may be
    listed more than once: two lanes on one card, or on the CPU). A slice
    on a torch device runs the campaign's sweeps there (`_place`).
    Campaign results do not depend on the placement. Stub device tokens
    (the scheduling tests) are passed through as they are.

    Request file (JSON): {"id"?, "workload", "virtual_secs"?, "storm"?,
    "meta_seed"?, "lanes"?, "chunk"?, "generations", "shrink"?,
    "max_shrinks"?, "devices"?, "tuning"?}. Requests move queue/ ->
    active/ -> done/; `generations` is the campaign's TOTAL target. The
    default factory builds each campaign on `device`. `status.json` and a
    Prometheus textfile are replaced after every round.

    `max_rounds` / `idle_rounds` bound the loop for tests and cron-style
    runs; the default (None/None) serves forever.

    The differential oracle runs as a background tenant unless
    `oracle=False`: after each slice it replays a sampled subset of the new
    generations' lanes schedule-matched on the host twin
    (`oracle_sample_rate` thins, `oracle_per_round` caps — saturation
    degrades into a counted skip) and folds any divergence into the owning
    campaign's BugRecords with `violation_kind="divergence"`. It runs on
    this thread between slices, never inside a slice lane. Its cursors
    persist in `<dir>/oracle.json`, so kill/restart resumes without
    re-checking; `status.json` carries its counters under "oracle".
    """
    if int(slice_generations) < 1:
        raise ValueError(
            f"slice_generations must be >= 1 (got {slice_generations}): a "
            "zero-generation slice never finishes any request"
        )
    # an empty device sequence is exactly "no pinning" — same as None
    devs: List[Any] = list(devices) if devices else [None]
    pinned_devices = bool(devices)
    queue_dir = os.path.join(dir, "queue")
    active_dir = os.path.join(dir, "active")
    done_dir = os.path.join(dir, "done")
    campaigns_dir = os.path.join(dir, "campaigns")
    regression_dir = os.path.join(dir, REGRESSION_DIR)
    for d in (queue_dir, active_dir, done_dir, campaigns_dir):
        os.makedirs(d, exist_ok=True)
    build = factory or functools.partial(_default_factory, device=device)

    tenant = None
    if oracle:
        from . import oracle as _oracle

        tenant = _oracle.OracleTenant(
            sample_rate=oracle_sample_rate, per_round=oracle_per_round,
            state_path=os.path.join(dir, "oracle.json"), log=log,
        )

    # crash recovery: requests in flight when a previous service died are
    # requeued — their campaigns resume from checkpoint, and `generations`
    # counts TOTAL campaign generations, so re-admission runs exactly the
    # remainder. A freshly resubmitted request of the same name supersedes
    # its stale orphan.
    for path in sorted(glob.glob(os.path.join(active_dir, "*.json"))):
        target = os.path.join(queue_dir, os.path.basename(path))
        if os.path.exists(target):
            os.replace(path, os.path.join(done_dir, os.path.basename(path)))
        else:
            os.replace(path, target)

    jobs: Dict[str, Dict[str, Any]] = {}
    completed: List[str] = []
    rounds = 0
    idle = 0
    unparseable: Dict[str, int] = {}  # queue path -> consecutive bad polls

    def reject(path: str, cid: Optional[str], why: str) -> None:
        out(json.dumps({"campaign": cid, "rejected": why}))
        os.replace(path, os.path.join(done_dir, os.path.basename(path)))

    def poll_queue() -> None:
        """One request must never take the service down: malformed JSON is
        retried a few polls (a non-atomic writer may still be mid-write)
        then rejected to done/; a request that fails to build (unknown
        workload, checkpoint mismatch, ...) is rejected immediately."""
        for path in sorted(glob.glob(os.path.join(queue_dir, "*.json"))):
            try:
                with open(path) as f:
                    request = json.load(f)
            except (json.JSONDecodeError, OSError) as e:
                n = unparseable.get(path, 0) + 1
                if n >= 3:
                    unparseable.pop(path, None)
                    reject(
                        path, None,
                        f"unreadable request after {n} polls: "
                        f"{type(e).__name__}: {str(e)[:120]}",
                    )
                else:
                    unparseable[path] = n
                continue
            unparseable.pop(path, None)
            cid = str(
                request.get("id")
                or os.path.splitext(os.path.basename(path))[0]
            )
            request["id"] = cid
            if cid in jobs:
                reject(path, cid, "duplicate id; request ignored")
                continue
            remaining = int(request.get("generations", 4))
            if remaining <= 0:
                reject(path, cid, "generations must be positive")
                continue
            # per-campaign device set: indices into this service's device
            # list, validated here so a bad pin is a loud reject
            dev_set: Optional[set] = None
            if request.get("devices") is not None:
                try:
                    dev_set = {int(i) for i in request["devices"]}
                except (TypeError, ValueError):
                    reject(path, cid, "devices must be a list of indices")
                    continue
                bad = {i for i in dev_set if not 0 <= i < len(devs)}
                if bad or not dev_set:
                    reject(
                        path, cid,
                        f"device indices {sorted(bad) or '[]'} out of "
                        f"range — this service has {len(devs)} device(s)",
                    )
                    continue
            # active/ entries are keyed by CAMPAIGN id, not request-file
            # basename: two files with distinct explicit ids must never
            # share (and clobber) one in-flight path
            active_path = os.path.join(active_dir, f"{cid}.json")
            os.replace(path, active_path)
            campaign_dir = os.path.join(campaigns_dir, cid)
            try:
                built = build(request, campaign_dir, regression_dir, log)
            except Exception as e:  # noqa: BLE001 - service must survive
                reject(active_path, cid,
                       f"{type(e).__name__}: {str(e)[:200]}")
                continue
            # a resumed campaign runs only the remainder of its TOTAL
            # target; an already-satisfied request completes immediately
            left = remaining - int(getattr(built, "generation", 0))
            if left <= 0:
                os.replace(
                    active_path,
                    os.path.join(done_dir, os.path.basename(active_path)),
                )
                completed.append(cid)
                out(json.dumps({
                    "campaign": cid, "completed": True,
                    "generation": int(getattr(built, "generation", 0)),
                }))
                continue
            jobs[cid] = {
                "campaign": built,
                "request": request,
                "active_path": active_path,
                "campaign_dir": campaign_dir,
                "remaining": left,
                "devices": dev_set,
                # seeds/s baseline of the status surface: a resumed
                # campaign's explorer already carries its checkpointed
                # seeds_run
                "seeds_run_prev": int(
                    getattr(getattr(built, "ex", None), "seeds_run", 0)
                    or 0
                ),
            }
            out(json.dumps({
                "campaign": cid, "accepted": True, "generations": left,
                **({"devices": sorted(dev_set)} if dev_set else {}),
            }))

    def assign_round() -> Dict[int, List[str]]:
        """Every active campaign gets exactly ONE slice per round, placed
        on the least-loaded device its device set allows — lowest index
        on ties, in sorted-campaign order, so the assignment (and the
        output stream) is deterministic."""
        assignment: Dict[int, List[str]] = {i: [] for i in range(len(devs))}
        for cid in sorted(jobs):
            allowed = jobs[cid]["devices"] or range(len(devs))
            di = min(allowed, key=lambda i: (len(assignment[i]), i))
            assignment[di].append(cid)
        return assignment

    def run_lane(assignment, di: int) -> Dict[str, tuple]:
        """One device's slice lane: its campaigns' slices, sequentially,
        on the device. Raises never escape — a failing tenant is reported
        per campaign in the fold below. Each slice's wall rides along for
        the status surface."""
        res: Dict[str, tuple] = {}
        for cid in assignment[di]:
            job = jobs[cid]
            g = min(int(slice_generations), job["remaining"])
            t_slice = time.perf_counter()
            try:
                with _device_ctx(devs[di]):
                    _place(job["campaign"], devs[di])
                    with telemetry.span(
                        "slice", site="serve", campaign=cid, device=di
                    ):
                        report = job["campaign"].run(g)
                    with telemetry.span(
                        "checkpoint", site="serve", campaign=cid
                    ):
                        job["campaign"].checkpoint()
                res[cid] = (g, report, None, time.perf_counter() - t_slice)
            except Exception as e:  # noqa: BLE001 - one tenant's failing
                # workload must not take the other campaigns down; its
                # last good checkpoint stays resumable
                res[cid] = (g, None, e, time.perf_counter() - t_slice)
        return res

    # the live status surface: status.json + a Prometheus textfile, both
    # atomically replaced after every round
    t_serve = time.perf_counter()
    dev_busy_s = [0.0] * len(devs)
    dev_seeds = [0] * len(devs)
    last_device: Dict[str, Optional[int]] = {}

    def write_status_surfaces() -> None:
        uptime = max(time.perf_counter() - t_serve, 1e-9)
        status = {
            "uptime_s": round(uptime, 3),
            "rounds": rounds,
            "devices": len(devs) if pinned_devices else 1,
            "queue_depth": len(glob.glob(os.path.join(queue_dir, "*.json"))),
            "active": {
                cid: {
                    "generation": int(getattr(
                        jobs[cid]["campaign"], "generation", 0
                    )),
                    "remaining": int(jobs[cid]["remaining"]),
                    "bugs": len(getattr(jobs[cid]["campaign"], "bugs", ())),
                    "device": (
                        last_device.get(cid) if pinned_devices else None
                    ),
                }
                for cid in sorted(jobs)
            },
            "completed": list(completed),
            "per_device": [
                {
                    "busy_s": round(dev_busy_s[d], 3),
                    "occupancy": round(dev_busy_s[d] / uptime, 4),
                    "seeds_run": dev_seeds[d],
                    "seeds_per_sec": round(
                        dev_seeds[d] / dev_busy_s[d], 1
                    ) if dev_busy_s[d] > 0 else 0.0,
                }
                for d in range(len(devs))
            ],
        }
        if tenant is not None:
            status["oracle"] = tenant.status()
        telemetry.write_status(os.path.join(dir, STATUS), status)
        telemetry.write_farm_textfile(
            os.path.join(dir, METRICS_TEXTFILE), status
        )

    # the slice lanes start here: one thread per device. A CUDA sim
    # captures its step's graph one capture at a time in the process, in
    # the thread-local error mode, so the other lanes' work on the cards
    # (and the status writers on this thread) may run beside a capture
    pool = None
    if len(devs) > 1:
        from concurrent.futures import ThreadPoolExecutor

        pool = ThreadPoolExecutor(
            max_workers=len(devs), thread_name_prefix="madsim-serve",
        )
    try:
        while True:
            poll_queue()
            progressed = False
            assignment = assign_round()
            lanes = [di for di in sorted(assignment) if assignment[di]]
            device_of = {
                cid: di for di in lanes for cid in assignment[di]
            }
            last_device.update(device_of)
            results: Dict[str, tuple] = {}
            if pool is not None and len(lanes) > 1:
                futs = [
                    pool.submit(run_lane, assignment, di) for di in lanes
                ]
                for f in futs:
                    results.update(f.result())
            else:
                for di in lanes:
                    results.update(run_lane(assignment, di))
            for cid in sorted(results):
                g, report, err, slice_s = results[cid]
                job = jobs[cid]
                dev_busy_s[device_of[cid]] += slice_s
                if err is not None:
                    reject(
                        job["active_path"], cid,
                        f"slice failed: {type(err).__name__}: "
                        f"{str(err)[:200]}",
                    )
                    del jobs[cid]
                    progressed = True
                    continue
                job["remaining"] -= g
                campaign = job["campaign"]
                seeds_run = int(getattr(report, "seeds_run", 0))
                dev_seeds[device_of[cid]] += max(
                    seeds_run - job.get("seeds_run_prev", 0), 0
                )
                job["seeds_run_prev"] = seeds_run
                line = {
                    "campaign": cid,
                    "generation": campaign.generation,
                    "remaining": job["remaining"],
                    "device": device_of[cid] if pinned_devices else None,
                    "fingerprint": report.fingerprint(),
                    "bugs": len(getattr(campaign, "bugs", ())),
                    "report": report.to_dict(),
                }
                out(json.dumps(line))
                if telemetry.enabled():
                    telemetry.record_slice(line)
                with open(
                    os.path.join(job["campaign_dir"], REPORTS_STREAM), "a"
                ) as f:
                    f.write(json.dumps(line) + "\n")
                progressed = True
                if tenant is not None:
                    # the idle-CPU oracle lane: replay a sampled subset
                    # of this slice's lanes schedule-matched on the host
                    # twin. observe() never raises; a divergence lands a
                    # BugRecord on the campaign, so re-checkpoint to make
                    # it durable at this slice boundary.
                    obs = tenant.observe(cid, campaign)
                    if obs.get("diverged"):
                        try:
                            campaign.checkpoint()
                        except Exception:  # noqa: BLE001 - next slice's
                            pass  # checkpoint persists the record anyway
                if job["remaining"] <= 0:
                    os.replace(
                        job["active_path"],
                        os.path.join(
                            done_dir, os.path.basename(job["active_path"])
                        ),
                    )
                    completed.append(cid)
                    del jobs[cid]
            rounds += 1
            write_status_surfaces()
            if max_rounds is not None and rounds >= max_rounds:
                break
            if progressed:
                idle = 0
            else:
                idle += 1
                if idle_rounds is not None and idle >= idle_rounds:
                    break
                sleep(poll_s)
    finally:
        if pool is not None:
            pool.shutdown(wait=True)
        write_status_surfaces()
    return {
        "rounds": rounds, "completed": completed, "pending": sorted(jobs),
        "devices": len(devs) if pinned_devices else 1,
    }


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def _cmd_run(args) -> int:
    say = None if args.json else (lambda m: print(m, flush=True))
    if os.path.exists(os.path.join(args.dir, MANIFEST)):
        # resume: flags the user explicitly typed must MATCH the
        # checkpoint (sentinel defaults are None, so omitted flags defer)
        given = {
            k: v for k, v in (
                ("workload", args.workload),
                ("virtual_secs", args.virtual_secs),
                ("meta_seed", args.meta_seed),
                ("lanes", args.lanes),
                ("chunk", args.chunk or None),
            ) if v is not None
        }
        if args.storm:
            given["storm"] = True
        check_resume_conflicts(_read_manifest(args.dir), given)
        c = Campaign.resume(
            args.dir, regression_dir=args.regression_dir, log=say,
            device=args.device,
        )
        # triage knobs are runtime policy, not search identity
        if args.no_shrink:
            c.shrink = False
        if args.max_shrinks is not None:
            c.max_shrinks = args.max_shrinks
    else:
        workload = args.workload or "raft"
        virtual_secs = 2.0 if args.virtual_secs is None else args.virtual_secs
        ref = named_workload_ref(workload, virtual_secs, args.storm)
        c = Campaign(
            build_workload(ref), args.dir,
            meta_seed=args.meta_seed or 0,
            lanes=args.lanes or 256,
            chunk=args.chunk or None, workload_ref=ref,
            shrink=not args.no_shrink,
            max_shrinks=8 if args.max_shrinks is None else args.max_shrinks,
            spec_ref=SPEC_FOR_REF,
            spec_kwargs={"name": workload, "virtual_secs": virtual_secs},
            regression_dir=args.regression_dir,
            log=say,
            device=args.device,
        )
    report = c.run(args.generations)
    c.checkpoint()
    if args.json:
        print(json.dumps({
            "campaign": c.campaign_id,
            "generation": c.generation,
            "fingerprint": report.fingerprint(),
            "bugs": [b.to_dict() for b in c.bugs],
            "report": report.to_dict(),
        }), flush=True)
    else:
        print(report.render(), flush=True)
        for b in c.bugs:
            print(
                f"  bug {b.signature[:12]} ({b.violation_kind}, clauses "
                f"{b.clause_profile}): {len(b.witnesses)} witness seed(s) "
                f"{b.witness_seeds[:8]} -> {b.bundle_path}",
                flush=True,
            )
        print(f"checkpoint: {c.dir}", flush=True)
    return 0


def _cmd_merge(args) -> int:
    res = merge_and_minimize(
        args.dirs, args.out, lane_width=args.lane_width,
        log=lambda m: print(m, flush=True), device=args.device,
    )
    print(json.dumps({
        "out": args.out, "candidates": res["replayed"],
        "kept": len(res["kept"]), "merged_bits": res["merged_bits"],
        "kept_bits": res["kept_bits"], "dispatches": res["dispatches"],
    }), flush=True)
    return 0


def _cmd_regress(args) -> int:
    rep = regress(args.dir, repeats=args.repeats, device=args.device)
    return 1 if rep["failures"] else 0


def _cmd_serve(args) -> int:
    devices = None
    if args.devices:
        dev = torch.device(args.device)
        devs = ([torch.device("cuda", i)
                 for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" else [dev])
        if args.devices == "all":
            devices = devs
        else:
            try:
                n = int(args.devices)
            except ValueError:
                raise SystemExit(
                    f"--devices must be an integer or 'all', got "
                    f"{args.devices!r}"
                ) from None
            if n < 1 or n > len(devs):
                raise SystemExit(
                    f"--devices {n} out of range: {len(devs)} device(s) "
                    "visible"
                )
            devices = devs[:n]
    serve(
        args.dir, poll_s=args.poll,
        slice_generations=args.slice_generations,
        max_rounds=args.max_rounds, idle_rounds=args.idle_rounds,
        log=lambda m: print(m, flush=True) if args.verbose else None,
        devices=devices,
        oracle=not args.no_oracle,
        oracle_sample_rate=args.oracle_sample_rate,
        oracle_per_round=args.oracle_per_round,
        device=args.device,
    )
    return 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m madsim_tpu_torch.campaign",
        description="persistent fuzz campaigns over the batched explorer",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(s) -> None:
        s.add_argument(
            "--device", default="cuda",
            help="the device the campaign runs on (default cuda; cpu runs "
            "on the CPU)",
        )

    r = sub.add_parser(
        "run", help="run (or resume, if DIR has a manifest) one campaign"
    )
    # workload/search flags default to None sentinels: on a fresh dir the
    # fallbacks are raft/2.0s/seed 0/256 lanes; on resume, only the flags
    # the user actually typed are checked against the checkpoint
    r.add_argument("--dir", required=True)
    r.add_argument("--workload", default=None)
    r.add_argument("--virtual-secs", type=float, default=None)
    r.add_argument("--storm", action="store_true")
    r.add_argument("--meta-seed", type=int, default=None)
    r.add_argument("--lanes", type=int, default=None)
    r.add_argument("--chunk", type=int, default=None)
    r.add_argument("--generations", type=int, default=8)
    r.add_argument("--no-shrink", action="store_true")
    r.add_argument("--max-shrinks", type=int, default=None)
    r.add_argument("--regression-dir", default=None)
    r.add_argument("--json", action="store_true")
    device_flag(r)
    r.set_defaults(fn=_cmd_run)

    m = sub.add_parser(
        "merge", help="merge + cmin-minimize corpora into --out"
    )
    m.add_argument("dirs", nargs="+")
    m.add_argument("--out", required=True)
    m.add_argument("--lane-width", type=int, default=64)
    device_flag(m)
    m.set_defaults(fn=_cmd_merge)

    g = sub.add_parser(
        "regress",
        help="replay the regression corpus green (default dir: "
        "$MADSIM_REGRESSION_DIR or ./.madsim_regression)",
    )
    g.add_argument("--dir", default=None)
    g.add_argument("--repeats", type=int, default=1)
    device_flag(g)
    g.set_defaults(fn=_cmd_regress)

    s = sub.add_parser(
        "serve", help="watch-dir fuzz service: queue/ -> active/ -> done/"
    )
    s.add_argument("--dir", required=True)
    s.add_argument("--poll", type=float, default=0.5)
    s.add_argument("--slice-generations", type=int, default=1)
    s.add_argument("--max-rounds", type=int, default=None)
    s.add_argument("--idle-rounds", type=int, default=None)
    s.add_argument(
        "--devices", default=None, metavar="N|all",
        help="schedule campaigns across this many visible devices "
        "(requests may pin a device subset with \"devices\": [i, ...]); "
        "more than one card is not ported yet",
    )
    s.add_argument(
        "--no-oracle", action="store_true",
        help="disable the background differential-oracle tenant",
    )
    s.add_argument(
        "--oracle-sample-rate", type=float, default=0.25,
        help="fraction of each generation's lanes the oracle replays "
        "schedule-matched on the host twin",
    )
    s.add_argument(
        "--oracle-per-round", type=int, default=2,
        help="max host replays per serve round",
    )
    s.add_argument("--verbose", action="store_true")
    device_flag(s)
    s.set_defaults(fn=_cmd_serve)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    import sys

    sys.exit(main())
