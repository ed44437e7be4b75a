"""The port's explorer host loop against the JAX package:
`madsim_tpu_torch/explore.py`, its nemesis pieces (`META_SITE_*`,
`GENOME_H*`, `mutation_vocab`) and the workload registry
(`madsim_tpu_torch/workloads`).

The same inputs go through both faces on the CPU:
  * the pure pieces — `MetaRng`, `island_meta_seed`, `genome_hash64`,
    `canon_genome`, `cov_index`/`payload_bucket`/`popcount_rows`,
    `mutation_vocab`, `ctl_for`, `Candidate` and the `ExploreReport` /
    `CorpusEntry` JSON faces — return the original's values on seeded
    random inputs;
  * the pinned run (`digest.EXPLORE_RUN` on `chip_smoke.explore_workload`)
    gives `digest.PINNED_EXPLORE`, which is the JAX face's fingerprint, on
    the refill and chunked paths, pipeline on and off, telemetry on and
    off; its corpus (every field of every entry) and violations hash to
    `digest.PINNED_EXPLORE_CORPUS`, the JAX face's;
  * a snapshot the JAX face wrote after one generation restores into the
    port's explorer, whose next generation reaches the JAX face's
    uninterrupted fingerprint and corpus;
  * one explorer violation with a swarm candidate's `base_ctl` writes the
    JAX face's bundle JSON;
  * a Tier-B tune (the explorer's and a campaign's) is refused with its
    ROADMAP item, a federation mesh naming cards the host lacks raises, and
    the CLI's `--mesh` is refused for `--islands` (the device loop is
    tests/test_torch_devloop.py's, the federation and the CLI's
    `--islands` and `--out` tests/test_torch_campaign.py's); the campaign
    CLI's `serve` runs with its oracle tenant; the registry's rows are the
    JAX registry's, the speclang-generated ones included, with the host
    face on raft and chain only.

Tolerances: exact everywhere (integers, float32 bit patterns, bitmaps and
JSON byte for byte).
"""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from madsim_tpu import explore as jex
from madsim_tpu import nemesis as jn
from madsim_tpu import workloads as jreg
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu_torch import campaign, explore, telemetry, tune
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch import workloads as reg
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu.digest import (
    EXPLORE_GENERATIONS, EXPLORE_RUN, PINNED_EXPLORE, PINNED_EXPLORE_CORPUS,
    explore_corpus_digest,
)
from test_explore import PLAN, _planted_workload


def _keys(rng, n):
    """n random genome keys over the port's registry widths."""
    out = []
    for _ in range(n):
        out.append((
            int(rng.integers(0, 2**32)), int(rng.integers(0, 2**11)),
            tuple(int(v) for v in rng.integers(0, 2**31, len(tn.OCC_CLAUSES))),
            tuple(float(v) for v in rng.choice([0.25, 0.5, 1.0, 0.1],
                                               len(tn.RATE_CLAUSES))),
            int(rng.integers(0, 2**33)),
        ))
    return out


# ------------------------------------------------------- the pure pieces


def test_meta_rng_genome_hash_and_vocab_equal_the_jax_face():
    rng = np.random.default_rng(7)
    for name in ("META_SITE_DRAW", "META_SITE_ISLAND", "GENOME_H1",
                 "GENOME_H2"):
        assert getattr(tn, name) == getattr(jn, name), name
    for seed in (0, 7, 11, 2**31 + 5):
        a, b = explore.MetaRng(seed), jex.MetaRng(seed)
        assert [a.u32() for _ in range(64)] == [b.u32() for _ in range(64)]
        assert [a.randint(3, 17) for _ in range(16)] == [
            b.randint(3, 17) for _ in range(16)]
        assert [a.coin(0.3) for _ in range(16)] == [
            b.coin(0.3) for _ in range(16)]
        assert a.counter == b.counter
        c = explore.MetaRng(seed, counter=a.counter)
        assert c.choice(list(range(9))) == b.choice(list(range(9)))
        assert [explore.island_meta_seed(seed, i) for i in range(4)] == [
            jex.island_meta_seed(seed, i) for i in range(4)]
    keys = _keys(rng, 200)
    for k in keys:
        assert explore.genome_hash64(k) == jex.genome_hash64(k)
        # JSON collapses tuples to lists; the canonical form is the same
        j = json.loads(json.dumps(k))
        assert explore.canon_genome(j) == jex.canon_genome(j) == k
        assert explore.genome_hash64(j) == explore.genome_hash64(k)
    assert len({explore.genome_hash64(k) for k in keys}) == len(set(keys))
    # the mutation vocabulary of configs with every kind of clause
    plans = [PLAN, chip_smoke.storm_plan(), chip_smoke.membership_plan(),
             explore.storm_plan(2_000_000)]
    for plan in plans:
        for jplan in (_jax_plan(plan),):
            cfg = ttn.compile_plan(plan, chip_smoke.explore_workload().config)
            jcfg = jtn.compile_plan(jplan, _planted_workload().config)
            assert tn.mutation_vocab(cfg) == jn.mutation_vocab(jcfg)


def _jax_plan(plan):
    """The JAX face's FaultPlan of a port FaultPlan (clause for clause)."""
    return jn.FaultPlan(name=plan.name, clauses=tuple(
        getattr(jn, type(c).__name__)(**dataclasses.asdict(c))
        for c in plan.clauses))


def test_coverage_mirror_and_ctl_rows_equal_the_jax_face():
    from madsim_tpu.tpu.engine import COV_BITS as JCOV_BITS
    from madsim_tpu_torch.tpu.engine import COV_BITS

    assert COV_BITS == JCOV_BITS
    for n in range(5):
        for s in (-1, 0, 3, 4):
            for k in (-1, 0, 2, 255):
                for b in (0, 1, 17, 32):
                    assert explore.cov_index(n, s, k, b) == jex.cov_index(
                        n, s, k, b)
    for p in (0, 1, -1, 2**31 - 1, -2**31, 12345, 2**32 - 1):
        assert explore.payload_bucket(p) == jex.payload_bucket(p)
    rng = np.random.default_rng(3)
    bm = rng.integers(0, 2**32, (6, 256), dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(explore.popcount_rows(bm), jex.popcount_rows(bm))
    # one ctl row per candidate: the JAX face's TriageCtl values and the
    # port's TriageCtl dtypes, horizon split by REBASE_US
    keys = _keys(rng, 12) + [(5, 0, (0,) * 6, (1.0,) * 3, 0)]
    pop = [explore.Candidate(seed=k[0] & 0xFFFF, off=k[1], occ_off=k[2],
                             rate_scale=k[3], horizon_us=k[4])
           for k in keys]
    jpop = [jex.Candidate(**{f.name: getattr(c, f.name)
                             for f in dataclasses.fields(c)}) for c in pop]
    ctl = explore.ctl_for(pop, 2_500_000)
    jctl = jex.ctl_for(jpop, 2_500_000)
    for f in ctl._fields:
        got, want = getattr(ctl, f), np.asarray(getattr(jctl, f))
        assert got.dtype == (torch.float32 if f == "rate_scale"
                             else torch.int32), f
        assert np.array_equal(got.numpy(), want), f


def test_candidate_and_report_faces_equal_the_jax_face():
    occ = [0] * len(tn.OCC_CLAUSES)
    occ[tn.OCC_ROW["partition"]] = 0b101
    kw = dict(seed=3, off=tn.TRIAGE_BIT["loss"] | tn.TRIAGE_BIT["skew"],
              occ_off=tuple(occ), rate_scale=(1.0, 0.5, 1.0),
              horizon_us=1_000_000, origin="mutant")
    c, jc = explore.Candidate(**kw), jex.Candidate(**kw)
    assert c.base_ctl() == jc.base_ctl()
    assert c.describe() == jc.describe() and c.key() == jc.key()
    assert c.to_dict() == jc.to_dict()
    assert explore.Candidate(seed=3).base_ctl() is None
    old = {"seed": 1, "occ_off": [0, 0b101, 0, 0], "rate_scale": [0.5]}
    assert explore.Candidate.from_dict(old) == explore.Candidate(
        **dataclasses.asdict(jex.Candidate.from_dict(old)))
    # the corpus line face: the same bitmap bytes and digest
    bm = np.arange(256, dtype=np.uint32) * np.uint32(2654435761)
    e = explore.CorpusEntry(c, 9, bm, 4, 17, True, 2)
    je = jex.CorpusEntry(jc, 9, bm, 4, 17, True, 2)
    assert e.to_dict() == je.to_dict()
    back = explore.CorpusEntry.from_dict(je.to_dict())
    assert np.array_equal(back.bitmap, bm) and back.cand == c
    bad = dict(je.to_dict(), cov_digest="00" * 32)
    with pytest.raises(ValueError, match="cov_digest"):
        explore.CorpusEntry.from_dict(bad)
    # the report face (tests/test_explore.py's report, on both faces)
    fields = dict(
        meta_seed=11, lanes=16, dispatches=3,
        coverage_curve=[40, 61, 61], corpus_curve=[3, 5, 5],
        violation_curve=[0, 1, 2],
        violations=[{
            "candidate": (9, 2, (0, 0b101, 0, 0, 0, 0), (1.0, 0.5, 1.0), 0),
            "seed": 9, "origin": "mutant", "describe": "[mutant] seed=9",
            "dispatch": 1, "bundle_path": "/tmp/x.json",
            "cov_digest": "ab" * 32,
        }],
        coverage_bits=61, corpus_size=5, seeds_run=48,
        first_violation_dispatch=1, wall_s=1.25, device_dispatches=6,
        corpus_digest="feed" * 16,
    )
    rep, jrep = explore.ExploreReport(**fields), jex.ExploreReport(**fields)
    assert rep.to_json() == jrep.to_json()
    assert rep.fingerprint() == jrep.fingerprint()
    assert rep.render() == jrep.render()
    again = explore.ExploreReport.from_json(jrep.to_json())
    assert again.fingerprint() == rep.fingerprint()
    assert again.violations == rep.violations
    with pytest.raises(ValueError, match="unknown"):
        explore.ExploreReport.from_dict({**rep.to_dict(), "bogus": 1})


# ------------------------------------------------------- the pinned run

def _pinned(**kw):
    return explore.Explorer(chip_smoke.explore_workload(), device="cpu",
                            **{**EXPLORE_RUN, **kw})


def test_jax_snapshot_restores_into_the_port_and_pins_the_fingerprint():
    """The JAX face's pinned run gives PINNED_EXPLORE (and its corpus
    PINNED_EXPLORE_CORPUS); its snapshot after one generation, restored
    into the port's explorer, continues to the same fingerprint, corpus
    and violations."""
    jx = jex.Explorer(_planted_workload(), **EXPLORE_RUN)
    jx.run(1)
    snap = json.loads(json.dumps(jx.snapshot()))
    jrep = jx.run(EXPLORE_GENERATIONS - 1)
    assert jrep.fingerprint() == PINNED_EXPLORE
    assert explore_corpus_digest(jx) == PINNED_EXPLORE_CORPUS

    ex = _pinned()
    ex.restore(snap)
    rep = ex.run(EXPLORE_GENERATIONS - 1)
    assert rep.fingerprint() == PINNED_EXPLORE
    assert [e.to_dict() for e in ex.corpus] == [e.to_dict()
                                                 for e in jx.corpus]
    assert rep.violations == jrep.violations
    assert ex.snapshot() == {**jx.snapshot(), "wall_s": ex._wall_s}
    with pytest.raises(ValueError, match="meta_seed"):
        _pinned(meta_seed=12).restore(snap)


# refill with telemetry off is the snapshot continuation's path above
PATHS = [
    ("refill-telemetry", dict(), True),
    ("chunked-pipelined", dict(refill=False), False),
    ("chunked-serial-telemetry", dict(refill=False, pipeline=False), True),
]


@pytest.mark.parametrize("kw,telem", [p[1:] for p in PATHS],
                         ids=[p[0] for p in PATHS])
def test_port_reaches_the_pinned_fingerprint(kw, telem, tmp_path):
    """Every dispatch path, with telemetry on or off, gives the JAX face's
    fingerprint, corpus and violations; telemetry observes the spans and
    the generation gauges while doing so."""
    if telem:
        telemetry.enable(out_dir=str(tmp_path))
    try:
        ex = _pinned(**kw)
        rep = ex.run(EXPLORE_GENERATIONS)
        if telem:
            r = telemetry.get_registry()
            assert r.gauge("explore_generations").value(meta_seed=11) == 2
            assert r.gauge("explore_coverage_bits").value(
                meta_seed=11) == rep.coverage_bits
            spans = [s.name for s in telemetry.spans()]
            n = 1 if ex.refill else 16 // ex.chunk
            assert spans.count("dispatch") == spans.count("decode") == (
                n * EXPLORE_GENERATIONS)
    finally:
        telemetry.disable()
    assert rep.fingerprint() == PINNED_EXPLORE
    assert explore_corpus_digest(ex) == PINNED_EXPLORE_CORPUS
    assert rep.coverage_curve == sorted(rep.coverage_curve)
    assert sum(e.new_bits for e in ex.corpus) == rep.coverage_bits
    assert ex.seeds_run == 16 * EXPLORE_GENERATIONS
    assert rep.first_violation_dispatch == 0
    if telem:
        events = telemetry.read_events(str(tmp_path / "events.jsonl"))
        assert any(e["name"] == "explore_corpus_size" for e in events)


def test_explorer_violation_bundle_equals_the_jax_face(tmp_path):
    """A swarm candidate (crash switched off) of a violating seed, through
    `_record_violation` into shrink_seed(base_ctl=...): the record and the
    bundle JSON are the JAX face's, and the suppression stays in the
    bundle's ctl."""
    kw = dict(seed=11, off=tn.TRIAGE_BIT["crash"], origin="swarm")
    recs, texts = [], []
    for face, wl, cand, extra in (
        (explore, chip_smoke.explore_workload(), explore.Candidate(**kw),
         dict(device="cpu")),
        (jex, _planted_workload(), jex.Candidate(**kw), {}),
    ):
        out = tmp_path / face.__name__
        ex = face.Explorer(wl, **{**EXPLORE_RUN, "shrink_violations": True},
                           shrink_kwargs={"lane_width": 4,
                                          "out_dir": str(out)}, **extra)
        rec = ex._record_violation(cand, 1)
        texts.append(open(rec.pop("bundle_path")).read())
        recs.append(rec)
    assert recs[0] == recs[1] and texts[0] == texts[1]
    doc = json.loads(texts[0])
    assert "crash" in doc["dropped_clauses"]
    assert recs[0]["kept_atoms"] and all(
        a[0] != "crash" for a in recs[0]["kept_atoms"])


# ------------------------------------------------------- refusals, registry

# (tuning=, Campaign(tuning=) and serve were refused until item 12 came;
# what stays refused of them is Tier B's certifier, item 15; serve's
# oracle tenant came with item 16, test_campaign_serve_cli_runs_its_oracle)
REFUSED = [
    ("tuning", lambda: tune.tune_workload(
        chip_smoke.explore_workload(), "planted", tier="AB", device="cpu"),
     "item 15"),
    ("campaign-tuning", lambda: tune.tier_b_gate(
        chip_smoke.explore_workload(), chip_smoke.explore_workload().config,
        device="cpu"), "item 15"),
    # (a multi-device mesh was refused as item 14 until it came: a mesh
    # naming cards this host lacks is refused and never runs elsewhere,
    # and the CLI's --mesh, which the JAX CLI lacks (a single explorer
    # takes no mesh there), points at --islands)
    ("federation-mesh", lambda: explore.Federation(
        chip_smoke.explore_workload(), n_islands=2,
        mesh=["cuda:0", "cuda:1"], device="cpu"), "no CUDA device"),
    ("cli-mesh", lambda: explore.main(["--mesh"]), "--islands"),
]


@pytest.mark.parametrize("call,item", [r[1:] for r in REFUSED],
                         ids=[r[0] for r in REFUSED])
def test_unported_explorer_options_are_refused(call, item):
    exc = {"no CUDA device": RuntimeError,
           "--islands": ValueError}.get(item, NotImplementedError)
    with pytest.raises(exc, match=item):
        call()


def test_campaign_serve_cli_runs_its_oracle(tmp_path):
    """`campaign serve` with no --no-oracle (refused until item 16 came):
    a bounded serve over an empty queue writes the tenant's "oracle" block
    of status.json (tests/test_torch_oracle.py serves real requests)."""
    d = str(tmp_path / "svc")
    assert campaign.main(["serve", "--dir", d, "--device", "cpu",
                          "--max-rounds", "1", "--idle-rounds", "1"]) in (
        0, None)
    with open(os.path.join(d, "status.json")) as f:
        status = json.load(f)
    assert status["oracle"] == {
        "seeds_checked": 0, "divergences": 0, "shrinks_done": 0,
        "skipped_no_twin": 0, "skipped_saturated": 0, "errors": 0,
        "draws_checked": 0, "sample_rate": 0.25, "per_round": 2}


def test_registry_rows_equal_the_jax_registry(capsys):
    """Every row of the JAX registry, the speclang-generated ones
    included, field for field, with the port's module paths, host
    faces included: `host_fuzz` answers for every row."""
    assert reg.names() == jreg.names()
    for flags in (dict(explorable=True), dict(tunable=True),
                  dict(oracle_twin=True), dict(analysis=True),
                  dict(generated=True), dict(generated=False)):
        assert reg.names(**flags) == jreg.names(**flags), flags
    assert "wal" not in reg.names(explorable=True)
    def port(module):
        return module and module.replace("madsim_tpu.", "madsim_tpu_torch.",
                                         1)

    for name in jreg.names():
        e, je = reg.get(name), jreg.get(name)
        assert dataclasses.asdict(e) == dataclasses.asdict(je) | {
            "module": port(je.module),
            "host_module": port(je.host_module),
            "source_module": port(je.source_module),
        }, name
        assert reg.spec_factory(name).__module__ == e.module
        assert e.host_module is not None
        assert reg.host_fuzz(name).__module__ in (
            e.host_module, "madsim_tpu_torch.speclang.hostrt")
    assert sorted(reg.oracle_twins()) == sorted(jreg.oracle_twins())
    with pytest.raises(KeyError, match="unknown workload"):
        reg.get("nonesuch")
    # the CLI's named workload: the JAX face's config, storm plan included
    for storm in (False, True):
        wl = explore._named_workload("raft", 0.5, storm)
        jwl = jex._named_workload("raft", 0.5, storm)
        assert wl.config.to_toml() == jwl.config.to_toml()
        assert wl.host_repro is None
    # a tiny CLI run on the CPU reports what the API reports
    explore.main(["--virtual-secs", "0.2", "--lanes", "4", "--dispatches",
                  "1", "--no-shrink", "--json", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    api = explore.Explorer(explore._named_workload("raft", 0.2, False),
                           lanes=4, shrink_violations=False,
                           device="cpu").run(1)
    assert explore.ExploreReport.from_json(line).fingerprint() == \
        api.fingerprint()
