"""The port's causal layer against the JAX package: `madsim_tpu_torch.causal`
(a copy of `madsim_tpu/causal.py`), `shrink_seed(causal=True)`,
`repro.replay_device(explain=N)` and the CLI's `--explain`, and the
interface repairs F1-F3 (ROADMAP queue 3).

The same inputs go through both faces on the CPU:
  * each pure function of the copy (`lamport_mirror`, `vector_clocks`,
    `causal_cone`, `cone_depth`, `causal_slice`, `slice_labels`,
    `skeleton`, `shiviz_log`, `format_slice`, the host-lineage checks)
    returns the original's output on the same decoded graph or synthetic
    host mirror;
  * the decoder rejects a forged Lamport desync, an unresolvable send eid
    and a trace without lineage;
  * the planted re-stamp seeds' causal slices, digests and shared
    skeleton equal the JAX face's;
  * `shrink_seed(causal=True)` writes a v3 bundle whose causal digest is
    the JAX face's `causal_digest(explain(...))` under the JAX face's
    `build_ctl` of the bundle's fields, `digest.PINNED_CAUSAL` and
    `digest.PINNED_BUNDLE_V3`; the CLI's `--explain 8` replay cross-checks
    its sha, and `replay_device(explain=N)` raises on a tampered one;
  * F1 `BatchResult.chaos_fires`/`chaos_report()` equal the JAX face's and
    show a dead clause; F2 `mesh="auto"` runs unsharded on the CPU or one
    card and equals `mesh=None`, and is every card's mesh over several;
    F3 the re-exports and `--backend tpu`.

Tolerances: exact everywhere (integers, strings, JSON byte for byte).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import chip_smoke
from madsim_tpu import causal as jcausal
from madsim_tpu import nemesis as jn
from madsim_tpu import triage as jtri
from madsim_tpu.net.netsim import HostLineage
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu.batch import run_batch as jax_run_batch
from madsim_tpu.tpu.raft import raft_workload as jax_raft_workload
from madsim_tpu_torch import causal, repro, triage
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch import tpu as ttpu
from madsim_tpu_torch.tpu import BatchedSim, raft_workload, run_batch
from madsim_tpu_torch.tpu import batch as tbatch
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu.digest import (
    PINNED_BUNDLE, PINNED_BUNDLE_V3, PINNED_CAUSAL, bundle_digest,
)
from madsim_tpu_torch.tpu.trace import extract_trace
from test_triage import _sched_workload

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPEC_REF = "chip_smoke:planted_restamp_spec"


# ------------------------------------------------- the decoded graph


@pytest.fixture(scope="module")
def planted():
    """The port's lineage trace of the planted re-stamp seed 0 (violates
    at step 452), its events and decoded graph."""
    wl = chip_smoke.triage_workload()
    _, recs = BatchedSim(wl.spec, wl.config, lineage=True,
                         device="cpu").run_traced(0, max_steps=460)
    names = wl.spec.msg_kind_names
    events = extract_trace(recs, kind_names=names)
    g = causal.graph_from_events(events, n_nodes=wl.spec.n_nodes)
    return dict(wl=wl, recs=recs, events=events, g=g)


def _slice(m, g):
    return m.causal_slice(g)


def _graph_view(g):
    return (g.edges, g.prog_pred, sorted(g.events), len(g.chaos),
            g.violation.step)


PURE = {
    "lamport_mirror": lambda m, g: m.lamport_mirror(g),
    "vector_clocks": lambda m, g: m.vector_clocks(g),
    "violation_anchor": lambda m, g: m.violation_anchor(g),
    "causal_cone": lambda m, g: m.causal_cone(g, max(g.events)),
    "cone_depth": lambda m, g: m.cone_depth(
        g, m.causal_cone(g, max(g.events))),
    "causal_slice": lambda m, g: dataclasses.asdict(_slice(m, g)),
    "causal_slice_max_len": lambda m, g: dataclasses.asdict(
        m.causal_slice(g, max_len=8)),
    "slice_labels": lambda m, g: m.slice_labels(_slice(m, g)),
    "slice_labels_raw": lambda m, g: m.slice_labels(_slice(m, g),
                                                    canonical=False),
    "format_slice": lambda m, g: m.format_slice(_slice(m, g)),
    "causal_digest": lambda m, g: m.causal_digest(_slice(m, g)),
    "shiviz_log": lambda m, g: m.shiviz_log(g),
    "graph_from_events": lambda m, g: _graph_view(m.graph_from_events(
        list(g.events.values()) + list(g.chaos) + [g.violation],
        n_nodes=g.n_nodes)),
}


@pytest.mark.parametrize("name", sorted(PURE))
def test_pure_functions_equal_the_original(planted, name):
    g = planted["g"]
    assert PURE[name](causal, g) == PURE[name](jcausal, g)


def test_constants_and_skeleton_equal_the_original():
    assert causal.SHIVIZ_REGEX == jcausal.SHIVIZ_REGEX
    seqs = [["a", "b", "c", "d"], ["b", "x", "c", "d"], ["a", "c", "y", "d"]]
    for k in range(len(seqs) + 1):
        assert causal.skeleton(seqs[:k]) == jcausal.skeleton(seqs[:k])
    assert causal.skeleton(seqs) == ["c", "d"]


def _host_mirror(seed, tamper=False):
    """A synthetic HostLineage mirror (the host runtime's Lamport plane):
    random sends and deliveries over 5 nodes obeying the law; `tamper`
    bumps one recorded clock."""
    rng = np.random.default_rng(seed)
    lin = HostLineage().enable()
    pending = []
    for _ in range(200):
        if pending and rng.random() < 0.5:
            send = pending.pop(int(rng.integers(len(pending))))
            lin.on_deliver(int(rng.integers(5)), send)
        else:
            pending.append(lin.on_send(int(rng.integers(5))))
    if tamper:
        eid, node, lam, kind = lin.events[150]
        lin.events[150] = (eid, node, lam + 3, kind)
    return lin


@pytest.mark.parametrize("seed", [0, 1])
def test_host_lineage_functions_equal_the_original(seed):
    lin = _host_mirror(seed)
    assert causal.check_host_lineage(lin) == jcausal.check_host_lineage(lin)
    assert causal.check_host_lineage(lin) > 20
    for anchor in (max(e[0] for e in lin.events), 57):
        chain = causal.host_causal_slice(lin, anchor, max_len=12)
        assert chain == jcausal.host_causal_slice(lin, anchor, max_len=12)
        assert (causal.host_slice_labels(chain)
                == jcausal.host_slice_labels(chain))
        assert (causal.format_host_slice(chain)
                == jcausal.format_host_slice(chain))
        assert (causal.host_slice_digest(chain)
                == jcausal.host_slice_digest(chain))
    bad = _host_mirror(seed, tamper=True)
    for m in (causal, jcausal):
        with pytest.raises(m.LineageError, match="Lamport"):
            m.check_host_lineage(bad)


def test_decoder_rejects_a_forged_desync_and_an_unresolved_stamp(planted):
    """tests/test_causal.py's test_lamport_mirror_detects_desync on the
    port's events, and a send eid that names no event."""
    events = planted["events"]
    stamped = [e for e in events if e.eid >= 0]
    mid = stamped[len(stamped) // 2]
    forged = [dataclasses.replace(e, lam=e.lam + 7) if e is mid else e
              for e in events]
    with pytest.raises(causal.LineageError, match="Lamport"):
        causal.graph_from_events(forged, n_nodes=5)
    deliver = next(e for e in stamped[10:] if e.kind == "deliver")
    aliased = [dataclasses.replace(e, sent_eid=10**9) if e is deliver else e
               for e in events]
    with pytest.raises(causal.LineageError, match="not an event"):
        causal.graph_from_events(aliased, n_nodes=5)
    # the same forgeries fail the original's checker too
    with pytest.raises(jcausal.LineageError, match="Lamport"):
        jcausal.graph_from_events(forged, n_nodes=5)


def test_decoder_rejects_a_trace_without_lineage(planted):
    wl = planted["wl"]
    _, recs = BatchedSim(wl.spec, wl.config, device="cpu").run_traced(
        0, max_steps=50)
    assert recs.evt_eid is None
    with pytest.raises(causal.LineageError, match="lineage"):
        causal.graph_from_trace(recs)
    events = extract_trace(recs, kind_names=wl.spec.msg_kind_names)
    assert all(e.eid == e.sent_eid == e.lam == -1 for e in events)
    with pytest.raises(causal.LineageError, match="no lineage-stamped"):
        causal.graph_from_events(events)


# ------------------------------------------------- slices across seeds


@pytest.fixture(scope="module")
def explained():
    """Both faces' `explain` of the planted seeds 0 and 1 (both violate
    within 600 steps), without a ctl: the full plan."""
    wl, jwl = chip_smoke.triage_workload(), _sched_workload()
    out = {}
    for seed in (0, 1):
        out[seed] = (
            causal.explain(wl.spec, wl.config, seed, max_steps=600,
                           device="cpu"),
            jcausal.explain(jwl.spec, jwl.config, seed, max_steps=600),
        )
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_planted_slice_equals_the_jax_face(explained, seed):
    (g, sl), (jg, jsl) = explained[seed]
    assert g.violation is not None and jg.violation is not None
    assert g.edges == jg.edges
    assert causal.slice_labels(sl) == jcausal.slice_labels(jsl)
    assert causal.causal_digest(sl) == jcausal.causal_digest(jsl)
    anchor = g.events[sl.anchor_eid]
    assert anchor.step == g.violation.step
    assert sl.cone_size >= len(sl.chain) > 10


def test_two_witnesses_share_the_jax_skeleton(explained):
    """The cross-witness anatomy, computed from the slices directly: the
    port's skeleton of seeds 0 and 1 equals the JAX face's."""
    labels = [causal.slice_labels(explained[s][0][1]) for s in (0, 1)]
    jlabels = [jcausal.slice_labels(explained[s][1][1]) for s in (0, 1)]
    sk = causal.skeleton(labels)
    assert sk == jcausal.skeleton(jlabels)
    assert any(lbl.startswith("deliver:APPEND:") for lbl in sk)


# ------------------------------------------------- shrink, bundle, replay


@pytest.fixture(scope="module")
def causal_shrink(tmp_path_factory):
    """The port's shrink of the planted seed 0 with causal=True."""
    out = str(tmp_path_factory.mktemp("causal_bundles"))
    wl = chip_smoke.triage_workload()
    sr = triage.shrink_seed(wl, 0, lane_width=4, causal=True, device="cpu",
                            out_dir=out, spec_ref=SPEC_REF)
    return dict(wl=wl, sr=sr)


def test_causal_shrink_writes_the_jax_faces_v3_bundle(causal_shrink):
    sr = causal_shrink["sr"]
    b = sr.bundle
    assert b.format == "madsim-tpu-repro/3" == jtri.BUNDLE_FORMAT
    jwl = _sched_workload()
    _, jsl = jcausal.explain(
        jwl.spec, jwl.config, b.seed,
        ctl=jtri.build_ctl(1, b.horizon_us, b.dropped_clauses, b.occ_off,
                           b.rate_scale),
        max_steps=max(b.violation_step + 2, 64))
    want = jcausal.causal_digest(jsl)
    assert b.causal == want
    assert b.causal["sha"] == PINNED_CAUSAL
    # the causal field is the only change to the pinned v2-content bundle
    assert bundle_digest(dataclasses.replace(b, causal=None)) == (
        PINNED_BUNDLE[1])
    assert bundle_digest(b) == PINNED_BUNDLE_V3
    # the JAX face reads the file and hashes it the same
    jb = jtri.ReproBundle.load(sr.bundle_path)
    assert jb.causal == want and bundle_digest(jb) == PINNED_BUNDLE_V3
    assert triage.ReproBundle.load(sr.bundle_path) == b


def test_cli_explain_replays_on_the_tpu_backend_alias(causal_shrink, capsys):
    """`--backend tpu` (the JAX face's name) replays on the port, and
    `--explain 8` prints the slice's last 8 links and reproduces the
    bundle's causal sha (replay_device raises on a different one)."""
    path = causal_shrink["sr"].bundle_path
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        rc = repro.main([path, "--backend", "tpu", "--device", "cpu",
                         "--repeats", "1", "--explain", "8"])
    finally:
        os.chdir(cwd)
    out = capsys.readouterr().out
    assert rc == 0, out
    lines = out.splitlines()
    head = next(i for i, ln in enumerate(lines)
                if ln.startswith("causal slice -> anchor"))
    assert "chain of 8 events" in lines[head]
    assert sum("eid=" in ln for ln in lines[head + 1:]) >= 8
    assert lines[-1].startswith("device replay OK")


def test_a_tampered_causal_sha_raises(causal_shrink):
    """replay_device(explain=N) raises when the bundle's recorded sha
    differs from the replayed slice's, naming both."""
    b, wl = causal_shrink["sr"].bundle, causal_shrink["wl"]
    bad = dataclasses.replace(b, causal=dict(b.causal, sha="0" * 16))
    with pytest.raises(repro.ReplayError, match="causal slice diverged") as e:
        repro.replay_device(bad, spec=wl.spec, repeats=1, explain=3,
                            device="cpu", out=lambda *_: None)
    assert f"{b.causal['sha']} != {'0' * 16}" in str(e.value)


# ------------------------------------------------- F1-F3


def _dead_plan(m):
    """tests/test_nemesis.py's dead-clause plan: the partition's first
    split can never arrive before the horizon."""
    return m.FaultPlan(clauses=(
        m.Crash(interval_lo_us=400_000, interval_hi_us=1_500_000,
                down_lo_us=300_000, down_hi_us=1_000_000),
        m.Partition(interval_lo_us=50_000_000, interval_hi_us=60_000_000),
    ))


def test_chaos_fires_and_report_equal_the_jax_face_and_auto_mesh():
    """F1 on a FaultPlan batch, both faces; F2: the port's default
    mesh="auto" on the CPU is the unsharded run."""
    wl = raft_workload(virtual_secs=1.0)
    wl = dataclasses.replace(wl, config=ttn.compile_plan(_dead_plan(tn),
                                                         wl.config))
    jwl = jax_raft_workload(virtual_secs=1.0)
    jwl = dataclasses.replace(
        jwl, config=jtn.compile_plan(_dead_plan(jn), jwl.config),
        host_repro=None)
    assert wl.config.to_toml() == jwl.config.to_toml()
    kw = dict(repro_on_host=False, max_traces=0)
    res = run_batch(range(16), wl, device="cpu", **kw)
    ref = run_batch(range(16), wl, device="cpu", mesh=None, **kw)
    jres = jax_run_batch(range(16), jwl, **kw)
    assert res.chaos_fires == jres.chaos_fires
    assert res.chaos_report() == jres.chaos_report()
    assert res.chaos_fires["crash"] > 0 == res.chaos_fires["partition"]
    assert "partition" in res.chaos_report().split("DEAD CLAUSE")[1]
    assert res.summary["n_devices"] == 1
    for f in ("violated", "deadlocked", "violation_step"):
        np.testing.assert_array_equal(getattr(res, f), getattr(ref, f))
    drop = {"device_ms"}
    assert ({k: v for k, v in res.summary.items() if k not in drop}
            == {k: v for k, v in ref.summary.items() if k not in drop})


def test_resolve_mesh_auto_on_one_card_and_refuses_several(monkeypatch):
    """F2: "auto" is None on the CPU and on a host with one card, as the
    JAX face's resolve_mesh is with one device; over two cards it is a
    "seeds" mesh of both, and an explicit device list is a mesh as it is
    (the multi-device mesh once refused as item 14), by run_batch and the
    shrinker alike; a list naming cards the host lacks is refused."""
    assert tbatch.resolve_mesh(None) is None
    assert tbatch.resolve_mesh("auto", "cpu") is None
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert tbatch.resolve_mesh("auto", "cuda") is None
    sim = BatchedSim(chip_smoke.triage_workload().spec, None, triage=True,
                     device="cpu")
    assert triage._Eval(sim, 0, 100, 4, mesh="auto").lane_width == 4
    with pytest.raises(ValueError, match="lacks"):
        tbatch.resolve_mesh(("cuda:0", "cuda:1"), "cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    two = (torch.device("cuda", 0), torch.device("cuda", 1))
    auto = tbatch.resolve_mesh("auto", "cuda:0")
    assert auto.devices == two and auto.axis_name == "seeds"
    assert tbatch.resolve_mesh(("cuda:0", "cuda:1"), "cpu") == auto
    assert triage._Eval(sim, 0, 100, 4, mesh=("cuda:0", "cuda:1")).mesh \
        == auto


def test_tpu_package_reexports_the_schedule_twin():
    """F3: the two schedule-twin helpers the JAX face's package exports."""
    assert ttpu.device_chaos_events is ttn.device_chaos_events
    assert (ttpu.assert_device_matches_schedule
            is ttn.assert_device_matches_schedule)
    with pytest.raises(ValueError, match="unknown backend"):
        repro.replay(triage.ReproBundle(
            seed=0, spec_ref=None, spec_kwargs={}, spec_name="raft5",
            n_nodes=5, config_toml="", config_hash="",
            violation_kind="invariant", violation_step=0, violation_t_us=0,
            dropped_clauses=[], occ_off={}, rate_scale={}, horizon_us=1,
            max_steps=1, plan={}, trace_tail=[]), backend="gpu")
