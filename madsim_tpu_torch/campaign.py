"""Campaigns: persistent corpus, bug dedup, merge + minimize, regression.

The port of `madsim_tpu/campaign.py` (its serve loop aside). The explorer
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
`workload`, `seen_violations`, `shrinks_done`, `tuning` (always None
here) and `kind`. The card a run uses (`device=`) is a runtime argument
and is never written. The port holds u32 words in int64 tensors; every
bitmap leaves the engine through `explore._u32` as a true uint32 array,
so a corpus line's `bitmap` is the hex of the JAX face's little-endian
u32 bytes and its `cov_digest` that of the same bytes; the union is
written the same way. Seeds are Python ints below 2**32, genomes are
JSON lists `[seed, off, occ_off, rate_scale, horizon_us]` with rate
scales as the float32 values the JAX face writes (0.25, 0.5, 1.0).
Named workloads write `spec_ref` "madsim_tpu_torch.campaign:spec_for";
a JAX checkpoint's "madsim_tpu.campaign:spec_for" is read as it.

Not ported yet, each refused with its ROADMAP item (ROADMAP.md queue 1):
measured tuning (`tuning=`, item 12, tune) and the fuzz service
(`serve`, item 12, serve; its oracle tenant is item 16).

CLI:

    python -m madsim_tpu_torch.campaign run --workload raft --storm --generations 8 --dir D
    python -m madsim_tpu_torch.campaign merge --out MERGED D1 D2 ...
    python -m madsim_tpu_torch.campaign regress [--dir D]

(each with `--device cpu` to run on the CPU; the card is the default).
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import hashlib
import json
import os
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

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
from .tpu.engine import _not_ported

CAMPAIGN_FORMAT = "madsim-tpu-campaign/1"

MANIFEST = "manifest.json"
CORPUS = "corpus.jsonl"
SEEN = "seen.jsonl"
VIOLATIONS = "violations.jsonl"
BUGS = "bugs.jsonl"
REPORT = "report.json"
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
    CPU); it is a runtime argument, never persisted. Measured tuning
    (`tuning=`) is not ported yet.
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
        if tuning is not None:
            raise _not_ported("Campaign(tuning=...)", "item 12, tune")
        self.workload = workload
        self.dir = str(dir)
        self.tuning: Optional[Dict[str, Any]] = None
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
        self.ex = Explorer(
            workload, meta_seed=meta_seed, lanes=lanes, chunk=chunk,
            shrink_violations=False, pipeline=pipeline, sim=sim, log=log,
            device=device, **(explorer_kwargs or {}),
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
        A checkpoint made under measured tuning is refused."""
        ck = load_checkpoint(dir)
        man = ck["manifest"]
        if man.get("kind") == "merged":
            raise ValueError(
                "a merged corpus has no meta-rng cursor to resume; import "
                "it via merge, or start a fresh campaign over it"
            )
        if tuning is not None or man.get("tuning"):
            raise _not_ported("Campaign.resume under tuning", "item 12, tune")
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
    raise _not_ported("campaign serve (the fuzz service)", "item 12, serve")


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
        "serve", help="the watch-dir fuzz service (not ported yet: "
        "ROADMAP.md item 12, serve)",
    )
    s.set_defaults(fn=_cmd_serve)

    # serve's own flags are refused with it, not as unknown arguments
    args, extra = p.parse_known_args(argv)
    if extra and args.cmd != "serve":
        p.error(f"unrecognized arguments: {' '.join(extra)}")
    return args.fn(args)


if __name__ == "__main__":
    import sys

    sys.exit(main())
