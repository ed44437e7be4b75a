"""Explorer: coverage-guided seed & fault-plan search over batched lanes.

The port of `madsim_tpu/explore.py`'s host loop (one island). `run_batch`
spends every lane on a uniformly random seed; coverage-guided search
(AFL/libFuzzer) and Swarm Testing (Groce et al., ISSTA 2012) steer inputs
toward novel behaviour instead. A generation of candidates is one refill
sweep (or one chunked, double-buffered sweep) of `BatchedSim(triage=True,
coverage=True)`, and each lane carries its own TriageCtl row: clause,
occurrence and rate masks and a per-lane horizon, so a mutant is its
parent's trajectory minus or plus exactly the mutated faults.

The loop:

  * the engine accumulates a per-lane coverage bitmap (one bit per hash of
    node x event type x payload-magnitude bucket), the clause x occurrence
    fire words and scalar features (pool high water, state-changing
    events); the host reads them once per generation (refill) or once per
    chunk inside the pipelined decode, after the next chunk's dispatch;
  * the host keeps a corpus ranked by novelty — the bits a lane set that
    the union had never seen — and splits the next generation between
    FRESH seeds (generation 0 is all fresh: the uniform sweep's first
    chunk), MUTANTS of top-novelty entries (flip an occurrence bit, toggle
    a clause, scale a message rate, halve the horizon) and SWARM lane
    groups sharing a random clause subset;
  * novel violations go straight into `triage.shrink_seed(base_ctl=...)`:
    a mutant shrinks within its own suppression set, so its bundle replays
    the exact candidate.

Everything is a pure function of ONE meta-seed: the meta-rng is the
murmur3 counter chain the engines draw from (`nemesis.bits32`), and
candidates fold in admission order whatever dispatch shape ran them. The
port gives the JAX face's `ExploreReport.fingerprint()` for the same
workload, meta-seed and parameters (`tpu/digest.py:PINNED_EXPLORE`), and
restores a JAX face's `snapshot()` to continue its search.

`device_loop=True` runs WINDOWS of up to `device_window` generations as
one sweep of a `BatchedSim(devloop=make_devloop_plan(...))`: ranking,
mutation and admission happen in the step (`tpu/engine.py`), the host
decodes once per window and replays each window's populations from its
own meta chain as a standing oracle. Corpus, curves and fingerprints are
the host loop's, bit for bit, whatever the window partition.

`Federation` runs `n_islands` explorers with disjoint fresh-seed
sub-queues and a periodic coverage exchange through the campaign layer's
merge + minimize (`campaign.py`): with a mesh of one shard per island, a
generation is one sharded refill sweep (island i's population is shard
i's sub-queue), otherwise the islands run one after another on one
device; the fingerprint is the same either way, and the JAX face's.

`tuning=` applies the device's tuned Tier-A dispatch knobs
(madsim_tpu_torch/tune.py) where the caller kept the defaults. As on the
JAX face, a single explorer takes no mesh: the explorer's device topology
is the federation's islands (`--islands`), so the CLI's `--mesh` is
refused.

CLI:  python -m madsim_tpu_torch.explore --workload raft --storm --dispatches 12
      (add --device cpu to run on the CPU, --device-loop for the
      device-resident loop, --islands N for a federation, --out DIR to
      write the run as a resumable campaign)
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import telemetry
from .nemesis import (
    GENOME_H1,
    GENOME_H2,
    META_SITE_DRAW,
    META_SITE_ISLAND,
    OCC_CLAUSES,
    OCC_ROW,
    RATE_CLAUSES,
    RATE_ROW,
    TRIAGE_BIT,
    TRIAGE_CLAUSES,
    bits32,
    fold32,
    key_from_seed,
    mix32,
    mutation_vocab,
)
from .tpu.mesh import Mesh, visible_devices


def island_meta_seed(meta_seed: int, island: int) -> int:
    """Island `island`'s own meta-seed, derived from the federation
    meta-seed through the shared murmur3 chain (pure, collision-spread:
    per-island MetaRng streams are independent counter chains)."""
    return bits32(key_from_seed(int(meta_seed)), META_SITE_ISLAND, int(island))


class MetaRng:
    """Counter-based meta-rng: draw i of meta-seed s is
    `bits32(key_from_seed(s), META_SITE_DRAW, i)` — the same murmur3
    mirror both backends execute, so the whole search is a pure function
    of the meta-seed with no hidden RNG state.

    The whole state is (meta_seed, counter): a checkpoint records the
    `counter` cursor and a resume constructs `MetaRng(seed, counter=c)`,
    which by the counter-chain construction continues the exact stream —
    the property the campaign layer's kill/resume bit-identity rests on.
    """

    def __init__(self, meta_seed: int, counter: int = 0) -> None:
        self.meta_seed = int(meta_seed)
        self._key = key_from_seed(int(meta_seed))
        self._n = int(counter)

    @property
    def counter(self) -> int:
        """The draw cursor — draw `counter` is the next one handed out."""
        return self._n

    def u32(self) -> int:
        v = bits32(self._key, META_SITE_DRAW, self._n)
        self._n += 1
        return v

    def randint(self, lo: int, hi: int) -> int:
        """int in [lo, hi) (degenerate range yields lo, like prng.randint)."""
        return lo + self.u32() % max(hi - lo, 1)

    def coin(self, p: float) -> bool:
        return self.u32() % 1_000_000 < int(round(p * 1_000_000))

    def choice(self, seq: Sequence) -> Any:
        return seq[self.u32() % len(seq)]


# --------------------------------------------------------------------------
# candidates — one lane's (seed, fault-plan subset) genome
# --------------------------------------------------------------------------


def canon_genome(key) -> tuple:
    """Canonical in-memory form of a Candidate.key() that may have been
    through JSON (tuples collapse to lists): (seed, off, occ_off tuple,
    rate_scale tuple, horizon_us)."""
    seed, off, occ, rs, h = key
    return (
        int(seed), int(off), tuple(int(v) for v in occ),
        tuple(float(v) for v in rs), int(h),
    )


def genome_hash64(key) -> Tuple[int, int]:
    """(h1, h2) — the 64-bit genome-dedup hash, HOST face.

    Two independent fold chains (nemesis.GENOME_H1/H2) over the genome's
    canonical u32 words: seed, clause-off mask, each occ row, each rate
    scale's IEEE-754 f32 bit pattern, raw horizon. Equal to the JAX
    face's, so both faces make the same dedup decision for every genome
    (a hash collision, the only way a hash set can differ from the exact
    key set, hits both alike); tests/test_torch_explore.py holds it."""
    seed, off, occ, rs, h = canon_genome(key)
    words = [seed & 0xFFFFFFFF, off & 0xFFFFFFFF]
    words += [v & 0xFFFFFFFF for v in occ]
    words += [int(np.float32(v).view(np.uint32)) for v in rs]
    words.append(h & 0xFFFFFFFF)
    h1, h2 = GENOME_H1, GENOME_H2
    for w in words:
        h1 = fold32(h1, w)
        h2 = fold32(h2, w)
    return mix32(h1), mix32(h2)


@dataclasses.dataclass(frozen=True)
class Candidate:
    """One lane of a generation: a seed plus the ctl knobs that carve a
    fault-plan subset out of the compiled config (see TriageCtl — the
    shrinker's per-lane machinery doubles as the mutator's)."""

    seed: int
    off: int = 0  # clause-disable bitmask over TRIAGE_CLAUSES
    occ_off: Tuple[int, ...] = (0,) * len(OCC_CLAUSES)
    rate_scale: Tuple[float, ...] = (1.0,) * len(RATE_CLAUSES)
    horizon_us: int = 0  # 0 = the config's full horizon
    origin: str = "fresh"  # fresh | mutant | swarm

    def key(self) -> tuple:
        """Dedupe/set identity (origin is provenance, not genome)."""
        return (
            self.seed, self.off, self.occ_off, self.rate_scale,
            self.horizon_us,
        )

    def is_default(self) -> bool:
        return (
            self.off == 0 and not any(self.occ_off)
            and all(s == 1.0 for s in self.rate_scale)
            and self.horizon_us == 0
        )

    def base_ctl(self) -> Optional[Dict[str, Any]]:
        """The triage.shrink_seed(base_ctl=...) face of this candidate
        (None for a default candidate — plain full-plan shrink)."""
        if self.is_default():
            return None
        return {
            "off_clauses": [
                n for n in TRIAGE_CLAUSES if self.off & TRIAGE_BIT[n]
            ],
            "occ_off": {
                n: self.occ_off[OCC_ROW[n]]
                for n in OCC_CLAUSES if self.occ_off[OCC_ROW[n]]
            },
            "rate_scale": {
                n: self.rate_scale[RATE_ROW[n]]
                for n in RATE_CLAUSES if self.rate_scale[RATE_ROW[n]] != 1.0
            },
            "horizon_us": self.horizon_us or None,
        }

    def to_dict(self) -> Dict[str, Any]:
        """JSON face (campaign corpus lines; tuples become lists)."""
        return dataclasses.asdict(self)

    @staticmethod
    def from_dict(doc: Dict[str, Any]) -> "Candidate":
        # Corpus lines written before a clause registry grew carry shorter
        # genome rows; pad to the current registry length (0 / 1.0 = the
        # neutral face) so old corpora stay loadable.
        occ = [int(v) for v in doc.get("occ_off") or ()]
        occ += [0] * (len(OCC_CLAUSES) - len(occ))
        rate = [float(v) for v in doc.get("rate_scale") or ()]
        rate += [1.0] * (len(RATE_CLAUSES) - len(rate))
        return Candidate(
            seed=int(doc["seed"]),
            off=int(doc.get("off", 0)),
            occ_off=tuple(occ),
            rate_scale=tuple(rate),
            horizon_us=int(doc.get("horizon_us", 0)),
            origin=str(doc.get("origin", "fresh")),
        )

    def describe(self) -> str:
        bits = [f"seed={self.seed}"]
        off = [n for n in TRIAGE_CLAUSES if self.off & TRIAGE_BIT[n]]
        if off:
            bits.append("off=" + "+".join(off))
        for n in OCC_CLAUSES:
            if self.occ_off[OCC_ROW[n]]:
                bits.append(f"{n}.occ_off={self.occ_off[OCC_ROW[n]]:#x}")
        for n in RATE_CLAUSES:
            if self.rate_scale[RATE_ROW[n]] != 1.0:
                bits.append(f"{n}.scale={self.rate_scale[RATE_ROW[n]]}")
        if self.horizon_us:
            bits.append(f"h={self.horizon_us}us")
        return f"[{self.origin}] " + " ".join(bits)


@dataclasses.dataclass
class CorpusEntry:
    """A candidate admitted for novelty, with the coverage that earned it."""

    cand: Candidate
    new_bits: int  # bits this lane added to the union at admission
    bitmap: np.ndarray  # u32 [COV_WORDS]
    hiwater: int
    transitions: int
    violated: bool
    dispatch: int  # generation index at admission

    def to_dict(self) -> Dict[str, Any]:
        """One campaign corpus.jsonl line: the genome, the novelty that
        admitted it, the exact bitmap (hex) and its digest."""
        return {
            "cand": self.cand.to_dict(),
            "new_bits": int(self.new_bits),
            "bitmap": self.bitmap.tobytes().hex(),
            "cov_digest": hashlib.sha256(self.bitmap.tobytes()).hexdigest(),
            "hiwater": int(self.hiwater),
            "transitions": int(self.transitions),
            "violated": bool(self.violated),
            "dispatch": int(self.dispatch),
        }

    @staticmethod
    def from_dict(doc: Dict[str, Any]) -> "CorpusEntry":
        bitmap = np.frombuffer(
            bytes.fromhex(doc["bitmap"]), np.uint32
        ).copy()  # frombuffer views are read-only; the union path ORs in place
        digest = doc.get("cov_digest")
        if digest and hashlib.sha256(bitmap.tobytes()).hexdigest() != digest:
            raise ValueError(
                "corpus entry bitmap does not match its cov_digest "
                f"(seed {doc.get('cand', {}).get('seed')}) — corrupt corpus"
            )
        return CorpusEntry(
            cand=Candidate.from_dict(doc["cand"]),
            new_bits=int(doc["new_bits"]),
            bitmap=bitmap,
            hiwater=int(doc.get("hiwater", 0)),
            transitions=int(doc.get("transitions", 0)),
            violated=bool(doc.get("violated", False)),
            dispatch=int(doc.get("dispatch", 0)),
        )


@dataclasses.dataclass
class ExploreReport:
    """One search's record: the coverage curve per dispatch, the corpus,
    and every unique violation (with its bundle when shrinking ran)."""

    meta_seed: int
    lanes: int
    dispatches: int
    coverage_curve: List[int]  # union bits after each dispatch
    corpus_curve: List[int]  # corpus size after each dispatch
    violation_curve: List[int]  # cumulative unique violations
    violations: List[Dict[str, Any]]
    coverage_bits: int
    corpus_size: int
    seeds_run: int
    first_violation_dispatch: Optional[int]
    wall_s: float
    device_dispatches: int
    corpus_digest: str = ""  # sha256 over corpus genomes + bitmaps

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict())

    @classmethod
    def from_dict(cls, doc: Dict[str, Any]) -> "ExploreReport":
        """Reload a report (checkpoints, the campaign service stream).

        The inverse of `to_dict` up to JSON's tuple->list collapse;
        `fingerprint()` is canonicalized over that collapse, so a
        round-tripped report fingerprints identically to the original.
        """
        fields = {f.name for f in dataclasses.fields(cls)}
        unknown = set(doc) - fields
        if unknown:
            raise ValueError(f"unknown ExploreReport fields: {sorted(unknown)}")
        rep = cls(**{k: doc[k] for k in fields if k in doc})
        # candidate genomes arrive as JSON lists; restore the in-memory
        # tuple form so violation records compare equal either way
        rep.violations = [dict(v) for v in rep.violations]
        for v in rep.violations:
            if v.get("candidate") is not None:
                v["candidate"] = canon_genome(v["candidate"])
        return rep

    @classmethod
    def from_json(cls, text: str) -> "ExploreReport":
        return cls.from_dict(json.loads(text))

    def fingerprint(self) -> str:
        """sha256 over everything the determinism contract covers: corpus
        genomes + bitmaps (via `corpus_digest`), coverage/corpus/violation
        curves, violation genomes. Excludes wall-clock and bundle paths
        (machine-local). JSON-canonical (tuples and lists encode the
        same), so it survives a to_json/from_json round trip — the
        campaign checkpoint and service-stream code depend on that."""
        h = hashlib.sha256()
        h.update(json.dumps({
            "meta_seed": self.meta_seed,
            "lanes": self.lanes,
            "coverage_curve": list(self.coverage_curve),
            "corpus_curve": list(self.corpus_curve),
            "violation_curve": list(self.violation_curve),
            "corpus_digest": self.corpus_digest,
            "violations": [
                [v["candidate"], v["dispatch"]] for v in self.violations
            ],
        }, sort_keys=True, separators=(",", ":")).encode())
        return h.hexdigest()

    def render(self) -> str:
        lines = [
            f"explore meta_seed={self.meta_seed}: {self.dispatches} "
            f"dispatches x {self.lanes} lanes ({self.seeds_run} lane-runs)",
            f"  coverage: {self.coverage_bits} bits "
            f"(curve {self.coverage_curve})",
            f"  corpus: {self.corpus_size} entries",
            f"  unique violations: {len(self.violations)}"
            + (
                f" (first at dispatch {self.first_violation_dispatch})"
                if self.violations else ""
            ),
        ]
        for v in self.violations:
            line = f"    {v['describe']}"
            if v.get("bundle_path"):
                line += f" -> {v['bundle_path']}"
            lines.append(line)
        return "\n".join(lines)


# --------------------------------------------------------------------------
# the pure-Python coverage mirror (the twin-test face of engine step 7b)
# --------------------------------------------------------------------------


def cov_index(node: int, src: int = -1, kind: int = -1, bucket: int = 0) -> int:
    """Mirror of the engine's event-class hash: bit index for one event.

    Deliveries hash (dst node, src, msg kind, payload[0] magnitude
    bucket); timer fires hash (node, -1, -1, 0). All inputs are
    trace-visible, so `bitmap_from_trace` recomputes a lane's exact device
    bitmap — the coverage analog of the nemesis schedule-mirror invariant.

    The folded fields and their order are registered in
    `engine.COV_FIELDS` (step phase 7b folds the same chain on the card).
    """
    from .tpu.engine import COV_BITS, COV_SALT

    ck = fold32(COV_SALT, node)
    ck = fold32(ck, src)
    ck = fold32(ck, kind)
    ck = fold32(ck, bucket)
    return mix32(ck) % COV_BITS


def payload_bucket(payload0: int) -> int:
    """The engine's AFL-style magnitude bucket: bit_length of the payload
    word reinterpreted as u32 (32 - clz)."""
    return (int(payload0) & 0xFFFFFFFF).bit_length()


def bitmap_from_trace(records, lane: int = 0) -> np.ndarray:
    """Recompute one lane's coverage bitmap from a TraceRecord stream
    (`BatchedSim.run_traced` records, leaves [T, L, ...]).

    Must equal `final_state.cov.bitmap[lane]` bit-for-bit when the sim ran
    with coverage=True.
    """
    from .tpu.engine import COV_WORDS

    msg_fired = _host(records.msg_fired)[:, lane]  # [T,N]
    timer_fired = _host(records.timer_fired)[:, lane]
    src = _host(records.msg_src)[:, lane]
    kind = _host(records.msg_kind)[:, lane]
    pay0 = _host(records.msg_payload)[:, lane, :, 0]
    bm = np.zeros((COV_WORDS,), np.uint32)
    T, N = msg_fired.shape
    for t in range(T):
        for n in range(N):
            if msg_fired[t, n]:
                idx = cov_index(
                    n, int(src[t, n]), int(kind[t, n]),
                    payload_bucket(pay0[t, n]),
                )
            elif timer_fired[t, n]:
                idx = cov_index(n)
            else:
                continue
            bm[idx // 32] |= np.uint32(1) << np.uint32(idx % 32)
    return bm


def popcount_rows(bitmaps: np.ndarray) -> np.ndarray:
    """Per-row set-bit counts of a u32 bitmap array [..., COV_WORDS]."""
    return np.unpackbits(
        np.ascontiguousarray(bitmaps, np.uint32).view(np.uint8), axis=-1
    ).sum(axis=-1)


def _host(x) -> np.ndarray:
    """A host numpy copy of a (card or CPU) tensor or an array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _u32(x) -> np.ndarray:
    """A true uint32 array of u32 words: the port holds them in int64,
    masked to 32 bits before the cast, so `tobytes()` (and every corpus
    digest) is the JAX face's."""
    a = _host(x)
    if a.dtype != np.uint32:
        a = (a.astype(np.int64) & 0xFFFFFFFF).astype(np.uint32)
    return a


def ctl_for(pop: Sequence[Candidate], full_horizon_us: int, device="cpu"):
    """The TriageCtl encoding one candidate per lane (the Explorer's
    dispatch face), as tensors on `device` in the dtypes of the port's
    TriageCtl (int32 masks and horizon parts, float32 rate scales). The
    per-lane horizon splits into (h_epoch, h_off) by REBASE_US, as on the
    JAX face."""
    from .tpu.engine import TriageCtl
    from .tpu.spec import REBASE_US

    off = np.asarray([c.off for c in pop], np.int32)
    occ = np.asarray([list(c.occ_off) for c in pop], np.int32)
    rs = np.asarray([list(c.rate_scale) for c in pop], np.float32)
    h = np.asarray(
        [c.horizon_us or int(full_horizon_us) for c in pop], np.int64
    )

    def t(a):
        return torch.as_tensor(a, device=device)

    return TriageCtl(
        off=t(off),
        occ=t(occ),
        rate_scale=t(rs),
        h_epoch=t((h // REBASE_US).astype(np.int32)),
        h_off=t((h % REBASE_US).astype(np.int32)),
    )


# --------------------------------------------------------------------------
# the explorer
# --------------------------------------------------------------------------


class Explorer:
    """Coverage-guided generation loop over one BatchWorkload.

        ex = Explorer(workload, meta_seed=7, lanes=256)
        report = ex.run(dispatches=12)
        print(report.render())

    Each `run` dispatch is one generation of `lanes` candidate lanes: one
    refill sweep (the default), or chunked and double-buffered above
    `chunk` lanes like run_batch. `device` is the card the explorer's
    BatchedSim runs on when it builds one (`"cpu"` runs on the CPU); a
    pre-built `sim` keeps its own.
    The workload's config decides the mutation vocabulary: nemesis
    schedule clauses contribute occurrence-mask mutations, message clauses
    rate-scale mutations, every enabled clause a toggle, and the horizon
    is always mutable. A config with no chaos degrades gracefully to a
    coverage-ranked uniform sweep.
    """

    def __init__(
        self,
        workload,
        meta_seed: int = 0,
        lanes: int = 256,
        chunk: Optional[int] = None,
        fresh_frac: float = 0.5,
        mutant_frac: float = 0.3,
        top_k: int = 16,
        swarm_group: int = 8,
        first_seed: int = 0,
        fresh_stride: int = 1,
        shrink_violations: bool = True,
        max_shrinks: Optional[int] = None,
        shrink_kwargs: Optional[Dict[str, Any]] = None,
        pipeline: Optional[bool] = None,
        refill: bool = True,
        refill_lanes: Optional[int] = None,
        dispatch_steps: Optional[int] = None,
        device_loop: bool = False,
        device_window: int = 8,
        seen_cap: int = 1 << 17,
        sim=None,
        log: Optional[Callable[[str], None]] = None,
        tuning: Any = None,
        device="cuda",
    ) -> None:
        from .tpu.engine import DEFAULT_DISPATCH_STEPS, BatchedSim
        from .tpu.spec import SimConfig

        self.workload = workload
        self.cfg = workload.config or SimConfig()
        self.meta_seed = int(meta_seed)
        self.lanes = int(lanes)
        if tuning is not None:
            # Tier-A dispatch knobs from the tuned-config cache of the
            # device the explorer runs on, applied only where the caller
            # kept the defaults; corpus, curves and fingerprints do not
            # depend on them. `chunk` is recorded in explorer_params, so a
            # campaign persists the applied value. A cached `devices` is
            # not consumed: the explorer's topology is the Federation's.
            from . import tune as _tune

            tn = _tune.resolve_tuning(
                tuning, workload.spec.name, self.cfg, self.lanes,
                device=device if sim is None else sim.device,
            )
            if chunk is None and tn.get("chunk"):
                chunk = min(int(tn["chunk"]), self.lanes)
            if refill_lanes is None and tn.get("refill_lanes"):
                refill_lanes = int(tn["refill_lanes"])
            if dispatch_steps is None and tn.get("dispatch_steps"):
                dispatch_steps = int(tn["dispatch_steps"])
            if pipeline is None and "pipeline" in tn:
                pipeline = bool(tn["pipeline"])
        self.chunk = int(chunk) if chunk else self.lanes
        self.fresh_frac = float(fresh_frac)
        self.mutant_frac = float(mutant_frac)
        self.top_k = int(top_k)
        self.swarm_group = max(1, int(swarm_group))
        self.shrink_violations = bool(shrink_violations)
        # cap on shrink invocations per explorer (None = shrink every novel
        # violation): a bug class dense in the seed space surfaces dozens of
        # violations per dispatch, and each shrink costs a few dispatches —
        # past the cap, violations are still recorded (and still count in
        # the curves/fingerprint), just without a bundle
        self.max_shrinks = None if max_shrinks is None else int(max_shrinks)
        self._shrinks_done = 0
        self.shrink_kwargs = dict(shrink_kwargs or {})
        self.pipeline = True if pipeline is None else bool(pipeline)
        # engine segment length for every generation dispatch
        self.dispatch_steps = (
            DEFAULT_DISPATCH_STEPS if dispatch_steps is None
            else int(dispatch_steps)
        )
        # continuous batching: a generation's candidates become ADMISSIONS
        # of one refill sweep over `refill_lanes` lanes (default: the
        # chunk width) — lanes whose candidates finish early (short mutant
        # horizons, early violations) retire and admit the next genome
        # instead of idling to the longest fresh seed's horizon. Decode
        # order stays admission (= pop) order, so corpus contents, curves
        # and fingerprints equal the chunked path's; refill=False keeps
        # the chunked reference loop.
        self.refill = bool(refill)
        self.refill_lanes = None if refill_lanes is None else int(refill_lanes)
        # device-resident search: run() executes WINDOWS of up to
        # `device_window` generations as one sweep (ranking, mutation and
        # admission in the step) and syncs the host corpus once per window
        # from the decoded archives; the host replays each window's
        # populations as a standing oracle, so the search is unchanged
        self.device_loop = bool(device_loop)
        self.device_window = max(1, int(device_window))
        self.seen_cap = int(seen_cap)
        self.say = log or (lambda msg: None)

        # ONE sim serves search and shrink: triage threads the ctl (the
        # mutator's knobs), coverage threads the novelty bitmaps. `sim`
        # accepts a pre-built BatchedSim(triage=True, coverage=True).
        if sim is None:
            devloop_plan = None
            if self.device_loop:
                from .tpu.engine import make_devloop_plan

                devloop_plan = make_devloop_plan(
                    self.cfg, pop=self.lanes, top_k=int(top_k),
                    seen_cap=self.seen_cap, fresh_frac=float(fresh_frac),
                    mutant_frac=float(mutant_frac),
                    swarm_group=max(1, int(swarm_group)),
                    fresh_stride=max(1, int(fresh_stride)),
                )
            sim = BatchedSim(
                workload.spec, self.cfg, triage=True, coverage=True,
                devloop=devloop_plan, device=device,
            )
        elif not (sim.triage and sim.coverage):
            raise ValueError(
                "Explorer needs a BatchedSim(..., triage=True, coverage=True)"
            )
        if self.device_loop:
            plan = getattr(sim, "devloop", None)
            if plan is None:
                raise ValueError(
                    "device_loop=True needs a BatchedSim built with "
                    "devloop=make_devloop_plan(...)"
                )
            if (
                plan.pop != self.lanes
                or plan.top_k != int(top_k)
                or plan.fresh_stride != max(1, int(fresh_stride))
            ):
                raise ValueError(
                    "devloop plan disagrees with the explorer: plan "
                    f"(pop={plan.pop}, top_k={plan.top_k}, "
                    f"fresh_stride={plan.fresh_stride}) vs explorer "
                    f"(lanes={self.lanes}, top_k={int(top_k)}, "
                    f"fresh_stride={max(1, int(fresh_stride))})"
                )
        self.sim = sim
        self._rng = MetaRng(self.meta_seed)
        self._next_fresh = int(first_seed)
        # fresh seeds advance by `fresh_stride` (default 1): an island
        # federation gives island i the stride-n_islands progression
        # first_seed=i, so per-island fresh-seed sub-queues are disjoint
        self._fresh_stride = max(1, int(fresh_stride))
        self._full_h = int(self.cfg.horizon_us)

        # the mutation vocabulary this config supports (one derivation,
        # nemesis.mutation_vocab, as on the JAX face)
        self._sched, self._rate, self._togglable = mutation_vocab(self.cfg)

        # search state
        self.union = np.zeros((self._cov_words(),), np.uint32)
        self.corpus: List[CorpusEntry] = []
        self._seen: set = set()  # candidate genomes ever dispatched
        # the CANONICAL dedup membership: 64-bit genome-hash pairs
        # (genome_hash64). `_population` checks THIS set, not `_seen` —
        # the device loop can only compare hashes, so the host must make
        # the identical (hash-based) dedup decision for both paths to
        # stay draw-for-draw aligned. `_seen` keeps the exact keys for
        # snapshots and provenance.
        self._seen_h: set = set()
        self._violated_seeds: set = set()
        self.violations: List[Dict[str, Any]] = []
        self.coverage_curve: List[int] = []
        self.corpus_curve: List[int] = []
        self.violation_curve: List[int] = []
        self.seeds_run = 0
        self.first_violation_dispatch: Optional[int] = None
        self._gen = 0
        self._wall_s = 0.0

    @staticmethod
    def _cov_words() -> int:
        from .tpu.engine import COV_WORDS

        return COV_WORDS

    # ------------------------------------------------------------ mutation

    def _fresh(self) -> Candidate:
        c = Candidate(seed=self._next_fresh)
        self._next_fresh += self._fresh_stride
        return c

    def _mutate(self, parent: Candidate) -> Candidate:
        """One mutation step on the fault-plan genome (never the seed: the
        seed IS the trajectory; the plan subset is what steering can vary
        without leaving the seed's schedule-pure universe)."""
        rng = self._rng
        ops: List[str] = []
        if self._sched:
            ops += ["occ"] * 3  # the finest-grained knob gets the weight
        if self._togglable:
            ops += ["clause"] * 2
        if self._rate:
            ops.append("rate")
        ops.append("horizon")
        op = rng.choice(ops)
        if op == "occ":
            name = rng.choice(self._sched)
            k = rng.randint(0, 10)  # early windows dominate short horizons
            occ = list(parent.occ_off)
            occ[OCC_ROW[name]] ^= 1 << k
            return dataclasses.replace(
                parent, occ_off=tuple(occ), origin="mutant"
            )
        if op == "clause":
            name = rng.choice(self._togglable)
            return dataclasses.replace(
                parent, off=parent.off ^ TRIAGE_BIT[name], origin="mutant"
            )
        if op == "rate":
            name = rng.choice(self._rate)
            rs = list(parent.rate_scale)
            rs[RATE_ROW[name]] = rng.choice([0.25, 0.5, 1.0])
            return dataclasses.replace(
                parent, rate_scale=tuple(rs), origin="mutant"
            )
        # horizon: bisect toward the interesting prefix, or restore full
        h = parent.horizon_us or self._full_h
        new_h = rng.choice([0, max(h // 2, self._full_h // 8)])
        return dataclasses.replace(parent, horizon_us=new_h, origin="mutant")

    def _swarm_off(self) -> int:
        """Swarm Testing: a random clause subset (each enabled clause
        dropped with p=1/2) shared by one lane-group."""
        off = 0
        for name in self._togglable:
            if self._rng.coin(0.5):
                off |= TRIAGE_BIT[name]
        return off

    def _claim(self, cand: Candidate) -> None:
        """Record a genome as dispatched in BOTH dedup faces: the exact
        key set (snapshots/provenance) and the canonical hash-pair set
        (the membership `_population` and the device loop check)."""
        self._seen.add(cand.key())
        self._seen_h.add(genome_hash64(cand.key()))

    def _parents(self) -> List[CorpusEntry]:
        """The corpus top-K by novelty (ties in dispatch order): the
        mutants' parents, and the device loop's corpus ring."""
        return sorted(
            (e for e in self.corpus if e.new_bits > 0),
            key=lambda e: (-e.new_bits, e.dispatch),
        )[: self.top_k]

    def _population(self, gen: int) -> List[Candidate]:
        """The next generation's lanes. Generation 0 is ALL fresh seeds —
        identical to the uniform sweep's first chunk, so the explorer
        never pays a steering tax before it has a signal to steer by.

        The mutant block is ONE draw schedule per slot: parent choice +
        one `_mutate`, then the seen-check, then a draw-free fresh
        fallback on a duplicate. No retry loop — a retry would consume a
        data-dependent number of meta draws per slot, which is exactly
        what a device-resident loop cannot mirror with a fixed advance
        table (the JAX face's engine `adv_of`). Exactly
        ONE genome is claimed per slot (mutants at choice time — two
        mutants of the same parent can draw identical ops WITHIN a
        generation — fresh and swarm at population end), so the host
        seen-set and the device seen-table grow in lockstep."""
        L = self.lanes
        parents = self._parents()
        if gen == 0 or not parents:
            pop = [self._fresh() for _ in range(L)]
        else:
            n_mut = int(L * self.mutant_frac)
            n_fresh = int(L * self.fresh_frac)
            n_swarm = L - n_mut - n_fresh if self._togglable else 0
            n_fresh = L - n_mut - n_swarm
            pop = [self._fresh() for _ in range(n_fresh)]
            for _ in range(n_mut):
                parent = self._rng.choice(parents).cand
                cand = self._mutate(parent)
                if genome_hash64(cand.key()) in self._seen_h:
                    # duplicate genome re-runs nothing new: fall back to
                    # the next fresh seed (no draws consumed)
                    cand = self._fresh()
                self._claim(cand)
                pop.append(cand)
            while len(pop) < L:
                off = self._swarm_off()
                for _ in range(min(self.swarm_group, L - len(pop))):
                    pop.append(dataclasses.replace(
                        self._fresh(), off=off, origin="swarm"
                    ))
        for c in pop:
            self._claim(c)
        return pop

    # ------------------------------------------------------------ dispatch

    def _ctl_for(self, pop: List[Candidate]):
        return ctl_for(pop, self._full_h, self.sim.device)

    def _fold_part(
        self, gen: int, part, bitmaps, hiwater, transitions, violated,
        new_violations: List[Tuple[Candidate, np.ndarray]],
    ) -> None:
        """Fold one decoded slice of a generation's lanes (IN ADMISSION
        ORDER) into the corpus/union, collecting novel violations into
        `new_violations` for `_finish_generation`. Candidates fold in
        pop order whatever dispatch produced the rows — chunked (called
        per chunk from decode, overlapping device time), refill, or the
        federation's sharded per-island rows — which is what keeps
        corpus contents and fingerprints bit-identical across dispatch
        shapes."""
        self.seeds_run += len(part)
        for i, cand in enumerate(part):
            new = bitmaps[i] & ~self.union
            nb = int(popcount_rows(new[None, :])[0])
            if nb > 0:
                # lane order IS admission order: earlier lanes absorb
                # shared novelty, keeping the corpus deterministic
                self.union |= bitmaps[i]
                self.corpus.append(CorpusEntry(
                    cand=cand, new_bits=nb, bitmap=bitmaps[i].copy(),
                    hiwater=int(hiwater[i]),
                    transitions=int(transitions[i]),
                    violated=bool(violated[i]), dispatch=gen,
                ))
            if violated[i] and cand.seed not in self._violated_seeds:
                self._violated_seeds.add(cand.seed)
                new_violations.append((cand, bitmaps[i].copy()))

    def _finish_generation(
        self, gen: int,
        new_violations: List[Tuple[Candidate, np.ndarray]],
    ) -> None:
        """Close one generation: shrink/record the novel violations and
        append the coverage/corpus/violation curve points."""
        for cand, bitmap in new_violations:
            if self.first_violation_dispatch is None:
                self.first_violation_dispatch = gen
            self.violations.append(self._record_violation(cand, gen, bitmap))
        self.coverage_curve.append(
            int(popcount_rows(self.union[None, :])[0])
        )
        self.corpus_curve.append(len(self.corpus))
        self.violation_curve.append(len(self.violations))
        if telemetry.enabled():
            # observe-only, at the host boundary: the generation's device
            # work is done and folded before any gauge moves
            telemetry.record_explore_generation(self)
        self.say(
            f"dispatch {gen}: {self.coverage_curve[-1]} union bits, "
            f"corpus {len(self.corpus)}, violations {len(self.violations)}"
        )

    def _fold_generation(self, gen: int, parts) -> None:
        """One whole generation's rows at once (the refill and
        federation face of _fold_part + _finish_generation)."""
        new_violations: List[Tuple[Candidate, np.ndarray]] = []
        for part, bitmaps, hiwater, transitions, violated in parts:
            self._fold_part(
                gen, part, bitmaps, hiwater, transitions, violated,
                new_violations,
            )
        self._finish_generation(gen, new_violations)

    def _run_generation(self, gen: int, pop: List[Candidate]) -> None:
        """Dispatch one generation — continuously batched by default (the
        whole population is the admission queue of one refill sweep), or
        chunked + double-buffered like run_batch (chunk k+1 on device
        while the host ranks chunk k: each chunk folds inside decode) —
        and fold its coverage into the corpus. Both paths fold
        candidates in pop order, so the corpus, union, and violation
        records are bit-identical."""
        from .tpu.batch import pipelined

        new_violations: List[Tuple[Candidate, np.ndarray]] = []

        def fold(part, bitmaps, hiwater, transitions, violated) -> None:
            self._fold_part(
                gen, part, bitmaps, hiwater, transitions, violated,
                new_violations,
            )

        if self.refill:
            from .tpu.engine import refill_results

            seeds = np.asarray([c.seed for c in pop], np.uint32)
            with telemetry.span("dispatch", site="explore", gen=gen):
                st = self.sim.run_refill(
                    seeds,
                    lanes=min(self.refill_lanes or self.chunk, len(pop)),
                    max_steps=self.workload.max_steps,
                    dispatch_steps=self.dispatch_steps,
                    ctl=self._ctl_for(pop),
                )
            with telemetry.span("decode", site="explore", gen=gen):
                # refill_results is where the host blocks on the device
                res = refill_results(st)
                fold(
                    pop, _u32(res["cov_bitmap"]),
                    res["cov_hiwater"], res["cov_transitions"],
                    res["violated"],
                )
        else:
            def dispatch(lo: int):
                part = pop[lo:lo + self.chunk]
                seeds = np.asarray([c.seed for c in part], np.uint32)
                with telemetry.span("dispatch", site="explore", gen=gen):
                    st = self.sim.run(
                        seeds, max_steps=self.workload.max_steps,
                        dispatch_steps=self.dispatch_steps,
                        ctl=self._ctl_for(part),
                    )
                return part, st

            def decode(entry) -> None:
                part, st = entry
                with telemetry.span("decode", site="explore", gen=gen):
                    # each read syncs with the card; decode runs after the
                    # next chunk's dispatch, so the pipelining is kept
                    fold(
                        part, _u32(st.cov.bitmap),
                        _host(st.cov.hiwater),
                        _host(st.cov.transitions),
                        _host(st.violated),
                    )

            pipelined(
                range(0, len(pop), self.chunk), dispatch, decode,
                serial=not self.pipeline,
            )
        self._finish_generation(gen, new_violations)

    def _record_violation(
        self, cand: Candidate, gen: int,
        bitmap: Optional[np.ndarray] = None,
    ) -> Dict[str, Any]:
        rec: Dict[str, Any] = {
            "candidate": cand.key(),
            "seed": cand.seed,
            "origin": cand.origin,
            "describe": cand.describe(),
            "dispatch": gen,
            "bundle_path": None,
            # the violating lane's exact coverage-bitmap digest — per-seed
            # evidence the campaign dedup layer records on each witness
            "cov_digest": (
                hashlib.sha256(bitmap.tobytes()).hexdigest()
                if bitmap is not None else None
            ),
        }
        if self.shrink_violations and (
            self.max_shrinks is not None
            and self._shrinks_done >= self.max_shrinks
        ):
            rec["shrink_skipped"] = "max_shrinks reached"
        elif self.shrink_violations:
            # straight into triage: ddmin within the candidate's own
            # suppression set, so the bundle replays this exact lane
            from . import triage

            self._shrinks_done += 1
            kwargs = dict(self.shrink_kwargs)
            kwargs.setdefault("out_dir", triage.default_bundle_dir())
            try:
                sr = triage.shrink_seed(
                    self.workload, cand.seed, sim=self.sim,
                    base_ctl=cand.base_ctl(), **kwargs,
                )
                rec["bundle_path"] = sr.bundle_path
                rec["violation_step"] = sr.bundle.violation_step
                rec["kept_atoms"] = [list(a) for a in sr.kept_atoms]
            except Exception as e:  # noqa: BLE001 - search must outlive triage
                rec["shrink_error"] = f"{type(e).__name__}: {str(e)[:160]}"
        return rec

    # ----------------------------------------------------- device window

    def _run_device_window(self, window: int) -> None:
        """Run `window` generations as ONE device-loop sweep: the host
        builds the window's first population (`_population`, the entry
        point both faces share), uploads the search state (corpus top-K
        ring, coverage union, seen-hash table, MetaRng cursor), and the
        step folds, ranks, mutates and re-admits every later generation.
        The window's one decode, `devloop_results`, gives the
        per-generation archives, which fold through the host loop's
        `_fold_generation`, so corpus, curves and fingerprints are the
        host loop's.

        The host then replays each later generation's population from its
        own MetaRng chain and checks that the device archived exactly
        those genomes, and that the final counter, fresh cursor, union and
        seen count agree: a drift between the two search faces raises at
        the first window (no fallback to the host loop). The replay is
        host arithmetic only: no device work, no extra read."""
        from .tpu.engine import DEVLOOP_ORIGINS, devloop_results

        window = int(window)
        if not 1 <= window <= self.device_window:
            raise ValueError(
                f"window must be in [1, {self.device_window}], got {window}"
            )
        gen0 = self._gen
        pop0 = self._population(gen0)

        # the upload faces of the host search state
        parents = self._parents()
        ring = {
            "n": len(parents),
            "bits": [e.new_bits for e in parents],
            "seed": [e.cand.seed for e in parents],
            "off": [e.cand.off for e in parents],
            "occ": [list(e.cand.occ_off) for e in parents],
            "rate": [list(e.cand.rate_scale) for e in parents],
            "h": [e.cand.horizon_us for e in parents],
        }
        # membership is an order-independent test over the valid prefix;
        # sorted rows make the upload itself deterministic
        seen_rows = sorted(self._seen_h)
        seen = {
            "n": len(seen_rows),
            "h1": [h1 for h1, _ in seen_rows],
            "h2": [h2 for _, h2 in seen_rows],
        }
        origin_of = {name: i for i, name in enumerate(DEVLOOP_ORIGINS)}
        with telemetry.span("dispatch", site="explore-devloop", gen=gen0):
            st = self.sim.init_devloop(
                np.asarray([c.seed for c in pop0], np.uint32),
                lanes=min(self.refill_lanes or self.chunk, len(pop0)),
                ctl=self._ctl_for(pop0),
                window=self.device_window,
                step_cap=self.workload.max_steps,
                meta_seed=self.meta_seed,
                meta_counter=self._rng.counter,
                next_fresh=self._next_fresh,
                target_gens=window,
                gen_h_raw=[c.horizon_us for c in pop0],
                gen_origin=[origin_of[c.origin] for c in pop0],
                ring=ring, union=self.union, seen=seen,
            )
            st = self.sim.run_devloop(st, dispatch_steps=self.dispatch_steps)
        with telemetry.span("decode", site="explore-devloop", gen=gen0):
            # devloop_results is the window's one read of the search state
            res = devloop_results(st)
        if res["gens_done"] != window:
            raise RuntimeError(
                f"device loop retired {res['gens_done']} generations, "
                f"window asked for {window}"
            )

        pop = pop0
        for g in range(window):
            row = res["gens"][g]
            self._check_window_gen(gen0 + g, pop, row)
            self._fold_generation(gen0 + g, [(
                pop, _u32(row["bitmap"]),
                row["hiwater"], row["transitions"], row["violated"],
            )])
            self._gen += 1
            if g + 1 < window:
                # replay the device's next population from the host
                # chain: fold first (the device ranked generation g's
                # novelty before mutating), then draw
                pop = self._population(self._gen)
        if telemetry.enabled():
            telemetry.record_explore_devloop(self, res, window)
        self._check_window_end(res)

    def _check_window_gen(self, gen: int, pop: List[Candidate], row) -> None:
        """Oracle: the device archived EXACTLY the population the host
        (re)built for this generation: genomes, origins, row order."""
        from .tpu.engine import DEVLOOP_ORIGINS

        got = [
            (
                int(row["seed"][i]), int(row["off"][i]),
                tuple(int(v) for v in row["occ"][i]),
                tuple(round(float(v), 6) for v in row["rate"][i]),
                int(row["h"][i]),
                DEVLOOP_ORIGINS[int(row["origin"][i])],
            )
            for i in range(len(pop))
        ]
        want = [
            (
                c.seed, c.off, tuple(int(v) for v in c.occ_off),
                tuple(round(float(v), 6) for v in c.rate_scale),
                c.horizon_us, c.origin,
            )
            for c in pop
        ]
        for i, (g, w) in enumerate(zip(got, want)):
            if g != w:
                raise RuntimeError(
                    f"device-loop divergence at generation {gen}, "
                    f"admission {i}: device archived {g}, host replay "
                    f"built {w}: the two search faces drifted"
                )

    def _check_window_end(self, res: Dict[str, Any]) -> None:
        """Oracle: after the window, the device cursors and coverage
        union landed exactly where the host replay did."""
        checks = (
            ("meta counter", res["counter"], self._rng.counter),
            ("next_fresh", res["next_fresh"],
             self._next_fresh & 0xFFFFFFFF),
            ("seen rows", res["seen_n"], len(self._seen_h)),
        )
        for name, dev, host in checks:
            if int(dev) != int(host):
                raise RuntimeError(
                    f"device-loop divergence: {name} is {dev} on device, "
                    f"{host} on the host replay"
                )
        if not np.array_equal(res["union"], self.union):
            raise RuntimeError(
                "device-loop divergence: coverage union mismatch after "
                "the window"
            )

    # ----------------------------------------------------------------- run

    def run(self, dispatches: int) -> ExploreReport:
        """Run `dispatches` generations (cumulative across calls). With
        `device_loop=True` the generations run in device-resident windows
        of up to `device_window` (one sweep and one decode each);
        otherwise one host-ranked dispatch per generation."""
        t0 = time.perf_counter()
        if self.device_loop:
            remaining = int(dispatches)
            while remaining > 0:
                w = min(remaining, self.device_window)
                self._run_device_window(w)
                remaining -= w
        else:
            for _ in range(int(dispatches)):
                gen = self._gen
                self._run_generation(gen, self._population(gen))
                self._gen += 1
        self._wall_s += time.perf_counter() - t0
        return self.report()

    def report(self) -> ExploreReport:
        digest = hashlib.sha256()
        for e in self.corpus:
            digest.update(repr((e.cand.key(), e.new_bits, e.dispatch)).encode())
            digest.update(e.bitmap.tobytes())
        return ExploreReport(
            meta_seed=self.meta_seed,
            lanes=self.lanes,
            dispatches=self._gen,
            coverage_curve=list(self.coverage_curve),
            corpus_curve=list(self.corpus_curve),
            violation_curve=list(self.violation_curve),
            violations=list(self.violations),
            coverage_bits=(
                self.coverage_curve[-1] if self.coverage_curve else 0
            ),
            corpus_size=len(self.corpus),
            seeds_run=self.seeds_run,
            first_violation_dispatch=self.first_violation_dispatch,
            wall_s=round(self._wall_s, 3),
            device_dispatches=self.sim.dispatch_count,
            corpus_digest=digest.hexdigest(),
        )

    # ---------------------------------------------------------- persistence

    def snapshot(self) -> Dict[str, Any]:
        """The COMPLETE search state as a JSON-safe dict: restoring it into
        a fresh Explorer (same workload, same constructor parameters) and
        running k more generations produces bit-identically what the
        uninterrupted run would have — `MetaRng(seed, counter)` continues
        the draw stream, `_next_fresh` the seed sequence, and the corpus /
        union / seen-genome set reproduce every ranking and dedup decision.
        The dict is the JAX face's: a snapshot either face wrote restores
        into the other."""
        return {
            "meta_seed": self.meta_seed,
            "lanes": self.lanes,
            "meta_cursor": self._rng.counter,
            "next_fresh": self._next_fresh,
            "generation": self._gen,
            "shrinks_done": self._shrinks_done,
            "seeds_run": self.seeds_run,
            "first_violation_dispatch": self.first_violation_dispatch,
            "wall_s": self._wall_s,
            "union": self.union.tobytes().hex(),
            "coverage_curve": list(self.coverage_curve),
            "corpus_curve": list(self.corpus_curve),
            "violation_curve": list(self.violation_curve),
            "corpus": [e.to_dict() for e in self.corpus],
            "seen": [list(g) for g in sorted(self._seen)],
            "violated_seeds": sorted(int(s) for s in self._violated_seeds),
            "violations": json.loads(json.dumps(self.violations)),
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        """Install a `snapshot()` into this (freshly constructed) Explorer.

        The constructor parameters are part of the contract the snapshot
        does NOT carry (the campaign manifest records them); meta_seed and
        lanes are cross-checked because silently resuming a different
        search is the one mistake no fingerprint would catch early."""
        if int(snap["meta_seed"]) != self.meta_seed:
            raise ValueError(
                f"snapshot meta_seed {snap['meta_seed']} != explorer "
                f"meta_seed {self.meta_seed}"
            )
        if int(snap["lanes"]) != self.lanes:
            raise ValueError(
                f"snapshot lanes {snap['lanes']} != explorer lanes "
                f"{self.lanes}"
            )
        self._rng = MetaRng(self.meta_seed, counter=int(snap["meta_cursor"]))
        self._next_fresh = int(snap["next_fresh"])
        self._gen = int(snap["generation"])
        self._shrinks_done = int(snap["shrinks_done"])
        self.seeds_run = int(snap["seeds_run"])
        fvd = snap["first_violation_dispatch"]
        self.first_violation_dispatch = None if fvd is None else int(fvd)
        self._wall_s = float(snap["wall_s"])
        union = np.frombuffer(bytes.fromhex(snap["union"]), np.uint32)
        if union.shape != self.union.shape:
            raise ValueError(
                f"snapshot union has {union.size} words, engine has "
                f"{self.union.size} (COV_WORDS drift — not resumable)"
            )
        self.union = union.copy()  # frombuffer is read-only; decode ORs in place
        self.coverage_curve = [int(v) for v in snap["coverage_curve"]]
        self.corpus_curve = [int(v) for v in snap["corpus_curve"]]
        self.violation_curve = [int(v) for v in snap["violation_curve"]]
        self.corpus = [CorpusEntry.from_dict(d) for d in snap["corpus"]]
        self._seen = {canon_genome(g) for g in snap["seen"]}
        # the hash-pair face is derived state: rebuild it from the exact
        # keys (snapshots never carry it, so old checkpoints stay loadable)
        self._seen_h = {genome_hash64(g) for g in self._seen}
        self._violated_seeds = {int(s) for s in snap["violated_seeds"]}
        self.violations = [dict(v) for v in snap["violations"]]
        for v in self.violations:
            if v.get("candidate") is not None:
                v["candidate"] = canon_genome(v["candidate"])


# --------------------------------------------------------------------------
# island-model federation
# --------------------------------------------------------------------------


class Federation:
    """Island-model explorer federation: `n_islands` independent
    coverage-guided searches — one corpus per island, each fed from its
    own disjoint fresh-seed sub-queue (island i draws seeds i, i + n,
    i + 2n, ...) and its own MetaRng counter chain derived from ONE
    federation meta-seed (`island_meta_seed`) — with a periodic coverage
    EXCHANGE built on the campaign layer's merge + cmin
    (`campaign.merge_entry_lists` + `campaign.minimize`, whose raised
    union-preservation check IS the exchange primitive).

        fed = Federation(workload, n_islands=8, meta_seed=7, lanes=32)
        report = fed.run(generations=12)

    With a `mesh` of exactly `n_islands` shards, every generation is ONE
    sharded refill sweep: island i's population is shard i's admission
    sub-queue, nothing crosses shards in the step, and the rows are
    gathered at segment end (`report()["sharded"]` is true). Otherwise the
    islands run one after another through one shared sim on one device
    (`device`, or a pre-built `sim`'s). The rows are the same either way,
    so the federation fingerprint is pinned across shard counts, and it is
    the JAX face's. `device_loop=True` runs each island's generations in
    device-resident windows clipped to exchange boundaries (one island
    after another, whatever the mesh), with the same fingerprint and
    exchange log as the host loop.
    """

    def __init__(
        self,
        workload,
        n_islands: int = 8,
        meta_seed: int = 0,
        lanes: int = 64,
        exchange_every: int = 4,
        minimize_on_exchange: bool = True,
        mesh=None,
        refill_lanes: Optional[int] = None,
        shrink_violations: bool = False,
        max_shrinks: Optional[int] = None,
        shrink_kwargs: Optional[Dict[str, Any]] = None,
        device_loop: bool = False,
        device_window: int = 8,
        sim=None,
        log: Optional[Callable[[str], None]] = None,
        device="cuda",
        **island_kwargs,
    ) -> None:
        from .tpu.batch import resolve_mesh
        from .tpu.engine import BatchedSim

        if n_islands < 1:
            raise ValueError(f"n_islands must be >= 1, got {n_islands}")
        if exchange_every < 1:
            raise ValueError(
                f"exchange_every must be >= 1, got {exchange_every}"
            )
        self.mesh = resolve_mesh(mesh, device if sim is None else sim.device)
        self.workload = workload
        self.n_islands = int(n_islands)
        self.meta_seed = int(meta_seed)
        self.lanes = int(lanes)
        self.exchange_every = int(exchange_every)
        self.minimize_on_exchange = bool(minimize_on_exchange)
        self.refill_lanes = (
            self.lanes if refill_lanes is None else int(refill_lanes)
        )
        # device-resident islands: each island's generations run in
        # windows CLIPPED to exchange boundaries, so an exchange always
        # sees fully folded corpora; windows dispatch one island after
        # another through the one shared sim
        self.device_loop = bool(device_loop)
        self.device_window = max(1, int(device_window))
        self.say = log or (lambda msg: None)
        if sim is None:
            devloop_plan = None
            if self.device_loop:
                from .tpu.engine import make_devloop_plan

                devloop_plan = make_devloop_plan(
                    workload.config, pop=self.lanes,
                    top_k=int(island_kwargs.get("top_k", 16)),
                    seen_cap=int(island_kwargs.get("seen_cap", 1 << 17)),
                    fresh_frac=float(island_kwargs.get("fresh_frac", 0.5)),
                    mutant_frac=float(
                        island_kwargs.get("mutant_frac", 0.3)
                    ),
                    swarm_group=int(island_kwargs.get("swarm_group", 8)),
                    # island i's fresh sub-queue: first_seed=i, stride=n
                    fresh_stride=self.n_islands,
                )
            sim = BatchedSim(
                workload.spec, workload.config, triage=True, coverage=True,
                devloop=devloop_plan, device=device,
            )
        elif not (sim.triage and sim.coverage):
            raise ValueError(
                "Federation needs a BatchedSim(..., triage=True, "
                "coverage=True)"
            )
        self.sim = sim
        # ONE sim serves every island; each island keeps its OWN search
        # state and MetaRng cursor
        self.islands: List[Explorer] = [
            Explorer(
                workload,
                meta_seed=island_meta_seed(self.meta_seed, i),
                lanes=self.lanes,
                first_seed=i,
                fresh_stride=self.n_islands,
                refill=True,
                refill_lanes=self.refill_lanes,
                shrink_violations=shrink_violations,
                max_shrinks=max_shrinks,
                shrink_kwargs=shrink_kwargs,
                device_loop=self.device_loop,
                device_window=self.device_window,
                sim=self.sim,
                log=None,
                **island_kwargs,
            )
            for i in range(self.n_islands)
        ]
        self._gen = 0
        self._wall_s = 0.0
        # exchange log: one record per exchange, part of the fingerprint
        # (an exchange changes every island's later ranking decisions)
        self.exchanges: List[Dict[str, Any]] = []

    # ----------------------------------------------------------- dispatch

    def _sharded(self) -> bool:
        return self.mesh is not None and self.mesh.size == self.n_islands

    def _run_generation(self) -> None:
        """One federated generation: every island contributes its next
        population; the rows come back from one sharded refill sweep (a
        mesh of one shard per island) or from one refill sweep per island,
        and fold into each island's corpus in admission order."""
        from .tpu.engine import refill_results, refill_results_sharded

        pops = [ex._population(ex._gen) for ex in self.islands]
        L = self.lanes
        if self._sharded():
            # island i's population IS shard i's contiguous sub-queue:
            # A = n_islands * lanes over n_islands shards, so Ad = lanes
            cands = [c for pop in pops for c in pop]
            st = self.sim.run_refill_sharded(
                np.asarray([c.seed for c in cands], np.uint32),
                lanes=min(self.refill_lanes, L), mesh=self.mesh,
                max_steps=self.workload.max_steps,
                ctl=ctl_for(cands, int(self.sim.config.horizon_us),
                            self.sim.device),
            )
            res = refill_results_sharded(st, admissions=len(cands))
            rows = [
                tuple(res[f][i * L:(i + 1) * L] for f in (
                    "cov_bitmap", "cov_hiwater", "cov_transitions",
                    "violated"))
                for i in range(self.n_islands)
            ]
        else:
            rows = []
            for ex, pop in zip(self.islands, pops):
                st = self.sim.run_refill(
                    np.asarray([c.seed for c in pop], np.uint32),
                    lanes=min(self.refill_lanes, L),
                    max_steps=self.workload.max_steps,
                    ctl=ex._ctl_for(pop),
                )
                res = refill_results(st)
                rows.append((res["cov_bitmap"], res["cov_hiwater"],
                             res["cov_transitions"], res["violated"]))
        for ex, pop, (bm, hw, tr, vi) in zip(self.islands, pops, rows):
            ex._fold_generation(ex._gen, [(pop, _u32(bm), hw, tr, vi)])
            ex._gen += 1

    # ----------------------------------------------------------- exchange

    def _exchange(self) -> None:
        """Periodic coverage exchange: merge every island's corpus
        (first genome wins, in island order), cmin-minimize the union
        (`campaign.minimize`, union preservation raised on), and install
        the merged view as every island's corpus and union, with the
        islands' seen sets and violated seeds joined. Each island keeps
        its own MetaRng cursor and fresh-seed sub-queue, so the exchange
        never perturbs a draw stream."""
        from . import campaign

        entries = campaign.merge_entry_lists(
            [ex.corpus for ex in self.islands]
        )
        if entries and self.minimize_on_exchange:
            res = campaign.minimize(
                self.workload, entries, sim=self.sim,
                lane_width=max(2, min(64, self.lanes)),
            )
            kept, union = res["kept"], res["union"]
        else:
            kept = entries
            union = np.zeros((Explorer._cov_words(),), np.uint32)
            for e in entries:
                union |= e.bitmap
        bits = int(popcount_rows(union[None, :])[0]) if entries else 0
        seen: set = set()
        seen_h: set = set()
        violated: set = set()
        for ex in self.islands:
            seen |= ex._seen
            seen_h |= ex._seen_h
            violated |= ex._violated_seeds
        for ex in self.islands:
            ex.corpus = list(kept)
            ex.union = union.copy()
            ex._seen = set(seen)
            ex._seen_h = set(seen_h)
            ex._violated_seeds = set(violated)
        self.exchanges.append({
            "generation": self._gen,
            "merged": len(entries),
            "kept": len(kept),
            "union_bits": bits,
        })
        self.say(
            f"exchange @gen {self._gen}: {len(entries)} entries -> "
            f"{len(kept)} kept, {bits} union bits"
        )

    # ---------------------------------------------------------------- run

    def run(self, generations: int) -> Dict[str, Any]:
        """Run `generations` federated generations (cumulative across
        calls), exchanging coverage every `exchange_every`. Device-loop
        islands run windows clipped to the next exchange boundary, so
        exchanges land at the same generations as on the host loop."""
        t0 = time.perf_counter()
        remaining = int(generations)
        while remaining > 0:
            if self.device_loop:
                until = self.exchange_every - (
                    self._gen % self.exchange_every
                )
                w = min(remaining, self.device_window, until)
                for ex in self.islands:
                    ex._run_device_window(w)
                self._gen += w
                remaining -= w
            else:
                self._run_generation()
                self._gen += 1
                remaining -= 1
            if self._gen % self.exchange_every == 0:
                self._exchange()
        self._wall_s += time.perf_counter() - t0
        return self.report()

    def coverage_bits(self) -> int:
        """Union bits across ALL islands (the federation's curve value)."""
        union = np.zeros((Explorer._cov_words(),), np.uint32)
        for ex in self.islands:
            union |= ex.union
        return int(popcount_rows(union[None, :])[0])

    def report(self) -> Dict[str, Any]:
        reports = [ex.report() for ex in self.islands]
        island_fps = [r.fingerprint() for r in reports]
        return {
            "meta_seed": self.meta_seed,
            "n_islands": self.n_islands,
            "lanes": self.lanes,
            "generations": self._gen,
            "exchange_every": self.exchange_every,
            "sharded": self._sharded(),
            "coverage_bits": self.coverage_bits(),
            "seeds_run": sum(r.seeds_run for r in reports),
            "violations": sum(len(r.violations) for r in reports),
            "exchanges": list(self.exchanges),
            "wall_s": round(self._wall_s, 3),
            "islands": [r.to_dict() for r in reports],
            "fingerprint": self.fingerprint(island_fps),
        }

    def fingerprint(
        self, island_fingerprints: Optional[List[str]] = None,
    ) -> str:
        """sha256 over every island's fingerprint plus the exchange log:
        the JAX face's, and pinned across kill/resume.
        `island_fingerprints` reuses already-built island reports."""
        fps = island_fingerprints or [
            ex.report().fingerprint() for ex in self.islands
        ]
        h = hashlib.sha256()
        h.update(json.dumps({
            "meta_seed": self.meta_seed,
            "n_islands": self.n_islands,
            "lanes": self.lanes,
            "exchange_every": self.exchange_every,
            "islands": fps,
            "exchanges": self.exchanges,
        }, sort_keys=True, separators=(",", ":")).encode())
        return h.hexdigest()

    # --------------------------------------------------------- persistence

    def snapshot(self) -> Dict[str, Any]:
        """The complete federation state (JSON-safe, the JAX face's
        dict): per-island Explorer snapshots (each with its MetaRng
        counter cursor) and the exchange log. `restore()` into a
        same-parameter Federation and `run(k)` continues bit-identically."""
        return {
            "meta_seed": self.meta_seed,
            "n_islands": self.n_islands,
            "lanes": self.lanes,
            "exchange_every": self.exchange_every,
            "generation": self._gen,
            "wall_s": self._wall_s,
            "exchanges": json.loads(json.dumps(self.exchanges)),
            "islands": [ex.snapshot() for ex in self.islands],
        }

    def restore(self, snap: Dict[str, Any]) -> None:
        for key in ("meta_seed", "n_islands", "lanes", "exchange_every"):
            if int(snap[key]) != getattr(self, key):
                raise ValueError(
                    f"snapshot {key} {snap[key]} != federation "
                    f"{key} {getattr(self, key)}"
                )
        self._gen = int(snap["generation"])
        self._wall_s = float(snap["wall_s"])
        self.exchanges = [dict(e) for e in snap["exchanges"]]
        for ex, isnap in zip(self.islands, snap["islands"]):
            ex.restore(isnap)


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------


def storm_plan(horizon_us: int):
    """A default occurrence-rich fault plan scaled to the horizon (the
    mutation vocabulary needs schedule clauses with several windows)."""
    from .nemesis import Crash, FaultPlan, LatencySpike, Partition

    return FaultPlan(name="explore-storm", clauses=(
        Crash(
            interval_lo_us=horizon_us // 10, interval_hi_us=horizon_us // 3,
            down_lo_us=horizon_us // 16, down_hi_us=horizon_us // 4,
        ),
        Partition(
            interval_lo_us=horizon_us // 10, interval_hi_us=horizon_us // 3,
            heal_lo_us=horizon_us // 16, heal_hi_us=horizon_us // 4,
        ),
        LatencySpike(
            interval_lo_us=horizon_us // 8, interval_hi_us=horizon_us // 2,
            duration_lo_us=horizon_us // 32, duration_hi_us=horizon_us // 8,
            extra_us=max(horizon_us // 50, 1),
        ),
    ))


def _named_workload(name: str, virtual_secs: float, storm: bool):
    import dataclasses as dc

    from . import workloads as registry

    choices = registry.names(explorable=True)
    if name not in choices:
        raise SystemExit(
            f"unknown workload {name!r} (choose from {sorted(choices)})"
        )
    wl = registry.workload_factory(name)(virtual_secs=virtual_secs)
    wl = dc.replace(wl, host_repro=None)
    if storm:
        from .tpu import nemesis as tn

        wl = dc.replace(
            wl, config=tn.compile_plan(
                storm_plan(int(wl.config.horizon_us)), wl.config
            ),
        )
    return wl


def main(argv: Optional[Sequence[str]] = None) -> None:
    parser = argparse.ArgumentParser(
        prog="python -m madsim_tpu_torch.explore",
        description="coverage-guided seed & fault-plan search",
    )
    parser.add_argument("--workload", default="raft")
    parser.add_argument("--virtual-secs", type=float, default=2.0)
    parser.add_argument(
        "--storm", action="store_true",
        help="compile an occurrence-rich Crash+Partition+Spike plan onto "
        "the workload config (the full mutation vocabulary)",
    )
    parser.add_argument("--meta-seed", type=int, default=0)
    parser.add_argument("--dispatches", type=int, default=8)
    parser.add_argument("--lanes", type=int, default=256)
    parser.add_argument("--chunk", type=int, default=0)
    parser.add_argument("--no-shrink", action="store_true")
    parser.add_argument(
        "--max-shrinks", type=int, default=None,
        help="cap shrink invocations (violations past the cap are recorded "
        "without a bundle)",
    )
    parser.add_argument("--no-pipeline", action="store_true")
    parser.add_argument(
        "--no-refill", action="store_true",
        help="run generations as padded chunks instead of the "
        "continuously batched (lane-refill) engine",
    )
    parser.add_argument(
        "--refill-lanes", type=int, default=None,
        help="device lane count for the refill engine (default: the "
        "chunk width); smaller = more refills per generation",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="the device the search runs on (default cuda; cpu runs on "
        "the CPU)",
    )
    parser.add_argument(
        "--device-loop", action="store_true",
        help="run the generation loop device-resident: novelty ranking, "
        "mutation and admission happen in the step, the host syncs once "
        "per window; same corpus, curves and fingerprint as the host "
        "loop, bit for bit",
    )
    parser.add_argument(
        "--device-window", type=int, default=8,
        help="generations per device-resident window (the one host sync "
        "amortizes over this many generations)",
    )
    parser.add_argument(
        "--islands", type=int, default=0,
        help="run an island-model FEDERATION of this many explorers: "
        "per-island corpora and disjoint fresh-seed sub-queues, periodic "
        "coverage exchange; with at least this many visible cards, each "
        "generation runs as one sharded sweep, one island per card "
        "(0 = single explorer)",
    )
    parser.add_argument(
        "--exchange-every", type=int, default=4,
        help="federation coverage-exchange period in generations",
    )
    parser.add_argument(
        "--mesh", action="store_true",
        help="refused: a single explorer takes no mesh (as on the JAX "
        "face); shard over cards with --islands",
    )
    parser.add_argument("--out-dir", default=None)
    parser.add_argument(
        "--out", default=None, metavar="DIR",
        help="write the report AND the corpus/checkpoint to DIR in the "
        "campaign on-disk format: the one-shot run becomes a resumable, "
        "merge-importable campaign (python -m madsim_tpu_torch.campaign)",
    )
    parser.add_argument("--json", action="store_true", help="JSON line only")
    args = parser.parse_args(argv)

    if args.mesh:
        raise ValueError(
            "explore --mesh: a single explorer takes no mesh (the JAX "
            "face's explorer has none); its device topology is the "
            "federation's islands — pass --islands N"
        )
    wl = _named_workload(args.workload, args.virtual_secs, args.storm)
    shrink_kwargs = {"out_dir": args.out_dir} if args.out_dir else {}
    if args.islands:
        # one island per card when there are enough cards, as the JAX
        # face does with its visible devices
        cards = (visible_devices("cuda")
                 if torch.device(args.device).type == "cuda" else ())
        mesh = (Mesh(cards[:args.islands], "islands")
                if 1 < args.islands <= len(cards) else None)
        fed = Federation(
            wl, n_islands=args.islands, meta_seed=args.meta_seed,
            lanes=args.lanes, exchange_every=args.exchange_every,
            mesh=mesh, refill_lanes=args.refill_lanes,
            shrink_violations=not args.no_shrink,
            max_shrinks=args.max_shrinks, shrink_kwargs=shrink_kwargs,
            device_loop=args.device_loop,
            device_window=args.device_window,
            log=None if args.json else lambda m: print(m, flush=True),
            device=args.device,
        )
        rep = fed.run(args.dispatches)
        if args.json:
            print(json.dumps(rep), flush=True)
        else:
            print(
                f"federation meta_seed={rep['meta_seed']}: "
                f"{rep['n_islands']} islands x {rep['lanes']} lanes, "
                f"{rep['generations']} generations "
                f"(sharded={rep['sharded']})\n"
                f"  coverage: {rep['coverage_bits']} union bits, "
                f"violations: {rep['violations']}, "
                f"exchanges: {len(rep['exchanges'])}\n"
                f"  fingerprint: {rep['fingerprint']}",
                flush=True,
            )
        return
    ex = Explorer(
        wl, meta_seed=args.meta_seed, lanes=args.lanes,
        chunk=args.chunk or None, shrink_violations=not args.no_shrink,
        max_shrinks=args.max_shrinks,
        shrink_kwargs=shrink_kwargs, pipeline=not args.no_pipeline,
        refill=not args.no_refill, refill_lanes=args.refill_lanes,
        device_loop=args.device_loop, device_window=args.device_window,
        log=None if args.json else lambda m: print(m, flush=True),
        device=args.device,
    )
    report = ex.run(args.dispatches)
    if args.out:
        from . import campaign

        campaign.export_explorer(
            args.out, ex,
            workload_ref=campaign.named_workload_ref(
                args.workload, args.virtual_secs, bool(args.storm)
            ),
        )
        if not args.json:
            print(f"checkpoint + corpus written to {args.out}", flush=True)
    if args.json:
        print(report.to_json(), flush=True)
    else:
        print(report.render(), flush=True)


if __name__ == "__main__":
    main()
