"""The port's telemetry plane against the JAX package:
`madsim_tpu_torch/telemetry.py` (a copy of `madsim_tpu/telemetry.py`) and
its wiring into `run_batch`.

The same inputs go through both faces on the CPU:
  * one sequence of instrument updates and `record_*` calls (summaries
    with clause and occurrence fires, disk occurrences included, shrink
    results, causal digests, explorer reports and generations, campaign
    slices, oracle status) gives the same Prometheus text and the same
    JSONL event lines (their `t_rel_s` clock aside); `parse_event` /
    `read_events` read either face's stream; the farm textfile, status
    document and rendering, `chaos_rows` and the CLI's `tail`/`render`
    print the same;
  * the disabled `span` is one shared no-op object; enabled spans record
    their threads and export a well-formed wall-clock timeline;
  * `perfetto_from_events` of one real lineage trace (the planted
    re-stamp seed) is byte-equal JSON on both faces, one track per node,
    one flow per delivery, each arrow anchored at its send event;
  * a port `run_batch` with telemetry on writes its record lines, its
    spans and the traced seed's timeline, and its rows equal the run with
    telemetry off.

Tolerances: exact everywhere (text and JSON byte for byte).
"""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest

import chip_smoke
from madsim_tpu import causal as jcausal
from madsim_tpu import explore as jex
from madsim_tpu import telemetry as jtel
from madsim_tpu_torch import causal, explore, telemetry
from madsim_tpu_torch.tpu import BatchedSim, run_batch
from madsim_tpu_torch.tpu.trace import extract_trace

SUMMARY = {  # scrambled insertion order, every occurrence clause
    "lanes": 64, "violations": 3, "deadlocked": 0, "total_events": 9000,
    "total_overflow": 2, "total_dead_drops": 5, "dispatches": 4,
    "device_ms": 12.5, "occupancy": 0.93, "coverage_bits": 301,
    "first_violation_step": 452,
    "occfires_spike_k0": 7, "occfires_disk_k1": 5, "occfires_crash_k2": 1,
    "occfires_partition_k1": 2, "occfires_crash_k0": 3,
    "occfires_disk_k0": 9, "occfires_reconfig_k3": 4,
    "fires_crash": 4, "fires_disk_slow": 2, "fires_loss": 17,
}


@dataclasses.dataclass
class _Shrink:
    original_atoms: int = 6
    kept_atoms: tuple = (("partition", 0),)
    dispatches: int = 4


@dataclasses.dataclass
class _Ex:
    meta_seed: int = 11
    coverage_curve: tuple = (325, 341)
    corpus: tuple = (1,) * 19
    violations: tuple = (1,) * 13
    seeds_run: int = 32
    top_k: int = 16


@dataclasses.dataclass
class _Result:
    summary: dict


STATUS = {
    "rounds": 3, "uptime_s": 12.25, "devices": 2, "queue_depth": 1,
    "active": {'c"1': {"generation": 4, "remaining": 2, "bugs": 1,
                       "device": 0},
               "c2": {"generation": 1, "remaining": 7, "bugs": 0}},
    "completed": ["c0"],
    "per_device": [{"occupancy": 0.9, "seeds_per_sec": 1234.5,
                    "seeds_run": 99}, {"occupancy": 0.5}],
}


def _drive(tel, mod, out_dir):
    """One sequence of updates through telemetry face `tel` (its explorer
    module `mod` builds the report); returns (prom text, event lines
    without their clock)."""
    reg = tel.enable(out_dir=out_dir)
    try:
        reg.counter("sweep_violations", "v").inc(3, workload="raft")
        reg.counter("sweep_violations").inc(1, workload="kv")
        reg.gauge("farm_queue_depth").set(4)
        reg.gauge("farm_campaign_generation").set(1, campaign='a"b\\c\nd')
        h = reg.histogram("lat", "x", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 7.0):
            h.observe(v, site="dispatch")
        with pytest.raises(TypeError):
            reg.gauge("sweep_violations")
        tel.record_summary(SUMMARY, workload="raft5")
        tel.record_batch_result(_Result(dict(SUMMARY)), workload="raft5")
        tel.record_shrink(_Shrink(), workload="raft5", seed=0)
        tel.record_causal({"depth": 37, "cone_size": 603, "chain_len": 213},
                          workload="raft5")
        tel.record_slice({"campaign": "c1", "generation": 3,
                          "remaining": 5, "bugs": 2})
        tel.record_oracle({"seeds_checked": 8, "divergences": 1,
                           "draws_checked": 999, "sample_rate": 0.25})
        tel.record_explore_generation(_Ex())
        tel.record_explore_devloop(_Ex(), {"ring": {"n": 8},
                                           "gens_done": 3, "accepts": 5,
                                           "seen_n": 77}, 0)
        rep = mod.ExploreReport(
            meta_seed=11, lanes=16, dispatches=2, coverage_curve=[325, 341],
            corpus_curve=[13, 19], violation_curve=[5, 13], violations=[],
            coverage_bits=341, corpus_size=19, seeds_run=32,
            first_violation_dispatch=0, wall_s=1.0, device_dispatches=4)
        tel.record_explore_report(rep, island=0)
        prom = reg.to_prom()
    finally:
        tel.disable()
    with open(os.path.join(out_dir, "events.jsonl")) as f:
        lines = [json.loads(ln) for ln in f]
    for d in lines:
        d.pop("t_rel_s")
    return prom, lines


def test_registry_exposition_and_event_lines_equal_the_jax_face(tmp_path):
    prom, lines = _drive(telemetry, explore, str(tmp_path / "port"))
    jprom, jlines = _drive(jtel, jex, str(tmp_path / "jax"))
    assert prom == jprom and lines == jlines
    assert 'campaign="a\\"b\\\\c\\nd"' in prom
    assert 'madsim_chaos_occurrence_lanes_total{clause="disk",k="1",' \
           'workload="raft5"} 10' in prom
    # either face's reader takes the other's stream
    for a, b in ((telemetry, "jax"), (jtel, "port")):
        path = str(tmp_path / b / "events.jsonl")
        assert a.read_events(path) == (jtel if a is telemetry
                                       else telemetry).read_events(path)
    ok = {"format": telemetry.TELEMETRY_FORMAT, "kind": "counter",
          "name": "x", "value": 1, "labels": {}, "seq": 0}
    for breakage in ({"format": "bogus/9"}, {"kind": "summary"},
                     {"value": None, "kind": "span"}, {"labels": [1, 2]}):
        line = json.dumps({**ok, **breakage})
        errs = []
        for face in (telemetry, jtel):
            with pytest.raises(ValueError) as e:
                face.parse_event(line)
            errs.append(str(e.value))
        assert errs[0] == errs[1]
    # chaos rows, the farm surface
    assert telemetry.chaos_rows(SUMMARY) == jtel.chaos_rows(SUMMARY)
    assert [r["clause"] for r in telemetry.chaos_rows(SUMMARY)][-2:] == [
        "disk", "disk"]
    assert telemetry.farm_textfile(STATUS) == jtel.farm_textfile(STATUS)
    assert telemetry.render_status(
        {"format": telemetry.FARM_STATUS_FORMAT, **STATUS}
    ) == jtel.render_status({"format": jtel.FARM_STATUS_FORMAT, **STATUS})
    for face, name in ((telemetry, "p"), (jtel, "j")):
        face.write_status(str(tmp_path / f"{name}.json"), STATUS)
        face.write_farm_textfile(str(tmp_path / f"{name}.prom"), STATUS)
    for ext in ("json", "prom"):
        assert (tmp_path / f"p.{ext}").read_text() == (
            tmp_path / f"j.{ext}").read_text()


def test_cli_tail_and_render_print_the_jax_faces_text(tmp_path, capsys):
    _drive(telemetry, explore, str(tmp_path))
    events = str(tmp_path / "events.jsonl")
    with open(events, "a") as f:
        f.write('{"format": "nope"}\n')
    telemetry.write_status(str(tmp_path / "status.json"), STATUS)
    telemetry.write_perfetto(str(tmp_path / "t.json"), [])
    outs = []
    for args in (["tail", events, "-n", "40"],
                 ["tail", events, "--validate"],
                 ["render", str(tmp_path)],
                 ["render", str(tmp_path / "t.json")],
                 ["render", str(tmp_path / "missing.json")]):
        rc = telemetry.main(args)
        got = capsys.readouterr()
        assert (rc, got) == (jtel.main(args), capsys.readouterr()), args
        outs.append((rc, got.out))
    assert outs[0][0] == 0 and (
        "chaos_fires{clause=loss,workload=raft5} = 17" in outs[0][1])
    assert outs[1][0] == 1 and outs[2][0] == 0 and "round 3" in outs[2][1]
    assert "chrome-trace" in outs[3][1] and outs[4][0] == 1


def test_span_is_a_noop_singleton_off_and_records_threads_on(tmp_path):
    a, b = telemetry.span("x"), telemetry.span("y", q=1)
    assert a is b  # no per-call allocation on the disabled path
    with a:
        pass
    assert telemetry.spans() == []
    telemetry.enable(out_dir=str(tmp_path))
    try:
        assert telemetry.span("x") is not telemetry.span("x")

        def worker():
            with telemetry.span("slice", campaign="c1", device=1):
                pass

        with telemetry.span("dispatch", off=0):
            t = threading.Thread(target=worker, name="lane-1")
            t.start()
            t.join()
        recs = telemetry.spans()
        assert sorted(r.name for r in recs) == ["dispatch", "slice"]
        assert {r.thread for r in recs} == {"MainThread", "lane-1"}
        h = telemetry.get_registry().histogram("span_seconds")
        assert h.snapshot(site="dispatch")["count"] == 1
        path = str(tmp_path / "loop.perfetto.json")
        telemetry.write_spans_perfetto(path)
    finally:
        telemetry.disable()
    doc = json.load(open(path))
    threads = sorted(e["args"]["name"] for e in doc["traceEvents"]
                     if e["ph"] == "M" and e["name"] == "thread_name")
    assert threads == ["MainThread", "lane-1"]
    assert [e["kind"] for e in telemetry.read_events(
        str(tmp_path / "events.jsonl"))].count("span") == 2


def test_perfetto_of_a_lineage_trace_equals_the_jax_face():
    wl = chip_smoke.triage_workload()
    _, recs = BatchedSim(wl.spec, wl.config, lineage=True,
                         device="cpu").run_traced(0, max_steps=460)
    events = extract_trace(recs, kind_names=wl.spec.msg_kind_names)
    n = wl.spec.n_nodes
    doc = telemetry.perfetto_from_events(events, n_nodes=n, label="raft5")
    assert json.dumps(doc) == json.dumps(
        jtel.perfetto_from_events(events, n_nodes=n, label="raft5"))
    evs = doc["traceEvents"]
    tracks = {e["tid"] for e in evs if e["ph"] == "M"
              and e["name"] == "thread_name" and e["tid"] < n}
    assert tracks == set(range(n))
    # one flow per delivery edge of the decoded graph, each arrow starting
    # at its send event (on the source track, at the send's time)
    g = causal.graph_from_trace(recs, kind_names=wl.spec.msg_kind_names,
                                n_nodes=n)
    starts = {e["id"]: e for e in evs if e["ph"] == "s"}
    delivers = [e for e in events if e.kind == "deliver"]
    assert len(starts) == len(delivers) == len(g.msg_pred) > 0
    by_eid = {e.eid: e for e in events if e.eid >= 0}
    ends = {e["id"]: e for e in evs if e["ph"] == "f"}
    for i, f in ends.items():
        d = next(e for e in delivers if e.t_us == f["ts"]
                 and e.node == f["tid"])
        send = by_eid[d.sent_eid]
        assert (starts[i]["tid"], starts[i]["ts"]) == (send.node, send.t_us)
    # the slice's timeline (causal.slice_perfetto) is the JAX face's too
    sl = causal.causal_slice(g)
    jg = jcausal.graph_from_events(events, n_nodes=n)
    assert json.dumps(causal.slice_perfetto(sl)) == json.dumps(
        jcausal.slice_perfetto(jcausal.causal_slice(jg)))
    # without lineage the arrows fall back to the delivery instant alike
    legacy = [dataclasses.replace(e, eid=-1, sent_eid=-1) for e in events]
    assert json.dumps(telemetry.perfetto_from_events(legacy)) == json.dumps(
        jtel.perfetto_from_events(legacy))


def test_run_batch_with_telemetry_writes_events_and_timeline(tmp_path):
    """Telemetry observes only: the rows equal the run with it off, and
    the record lines, the spans and the traced seed's timeline land in
    the out dir. (Both seeds are done by step 568, so a 600-step budget
    leaves every row as it is and keeps the traced run short.)"""
    wl = dataclasses.replace(chip_smoke.triage_workload(), max_steps=600)
    kw = dict(device="cpu", repro_on_host=False)
    telemetry.enable(out_dir=str(tmp_path))
    try:
        on = run_batch(range(2), wl, max_traces=1, **kw)
        spans = [s.name for s in telemetry.spans()]
    finally:
        telemetry.disable()
    off = run_batch(range(2), wl, max_traces=0, **kw)
    for f in ("seeds", "violated", "deadlocked", "retired_step",
              "violation_step"):
        assert np.array_equal(getattr(on, f), getattr(off, f)), f
    drop = ("device_ms",)
    assert {k: v for k, v in on.summary.items() if k not in drop} == {
        k: v for k, v in off.summary.items() if k not in drop}
    assert list(on.traces) == [0] and not off.traces
    assert on.traces[0][-1].kind == "violation"
    assert spans.count("dispatch") == spans.count("decode") == 1
    assert spans.count("trace") == 1
    events = telemetry.read_events(str(tmp_path / "events.jsonl"))
    names = {e["name"] for e in events}
    assert {"sweep_lanes", "sweep_violations", "chaos_fires",
            "chaos_occurrence_lanes", "span_seconds"} <= names
    viol = [e for e in events if e["name"] == "sweep_violations"]
    assert viol[0]["value"] == on.violations == 2
    path = tmp_path / f"{wl.spec.name}-seed0.perfetto.json"
    doc = json.loads(path.read_text())
    assert json.dumps(doc) == json.dumps(jtel.perfetto_from_events(
        on.traces[0], n_nodes=wl.spec.n_nodes,
        label=f"{wl.spec.name} seed 0"))
    assert any(e.get("name") == "violation" for e in doc["traceEvents"])
