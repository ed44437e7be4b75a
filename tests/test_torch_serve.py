"""The port's fuzz service against the JAX package: `campaign.serve`,
`_explicit_request_params`, `_default_factory`,
`_device_ctx` and `python -m madsim_tpu_torch.campaign serve`.

Both faces serve the same request directories on the CPU with
`oracle=False`:
  * the watch-dir protocol with stub campaigns (tests/test_campaign.py's
    queue mechanics, bad requests, crash recovery with the total-generation
    target, active files keyed by campaign id) and the device-aware
    round-robin over stub device tokens: the same streamed lines, the same
    files in queue/, active/ and done/, the same status surfaces;
  * a request's "tuning": "auto" resolves against the checkpoint's own
    workload and lane scale before the resume-conflict check
    (tests/test_tune.py's case);
  * end to end: two real requests (raft, 16 lanes, 2 generations, one of
    them under "tuning": "auto" with a tuned-cache entry that both faces
    read), served by the JAX face in one run and by the port through its
    CLI killed after round 1 and restarted: every streamed line carries
    the JAX face's fingerprint, and the tuned campaign's the untuned one's;
  * serve with its oracle tenant (the default; refused until item 16
    came) writes oracle.json and the status block; serve
    over two CPU devices (two slice lanes on two threads) drains three
    real campaigns with the one-device serve's fingerprints.

Tolerances: exact (JSON lines, fingerprints).
"""

import contextlib
import json
import os

import pytest
import torch

from madsim_tpu import campaign as jc
from madsim_tpu import explore as jex
from madsim_tpu import tune as jtune
from madsim_tpu_torch import campaign, explore, tune

# one torch thread per process, as tests/test_torch_engine.py sets (six
# xdist workers with torch's default pool oversubscribe the cores)
torch.set_num_threads(1)

FACES = {"port": (campaign, explore), "jax": (jc, jex)}


def _report(ex_mod, meta_seed=1):
    return ex_mod.ExploreReport(
        meta_seed=meta_seed, lanes=4, dispatches=1, coverage_curve=[3],
        corpus_curve=[1], violation_curve=[0], violations=[],
        coverage_bits=3, corpus_size=1, seeds_run=4,
        first_violation_dispatch=None, wall_s=0.1, device_dispatches=2,
        corpus_digest="00" * 32,
    )


class Stub:
    """A campaign that runs no device: generations, a report, a
    checkpoint directory; `events` records runs and checkpoints."""

    def __init__(self, d, ex_mod, cid, events, start_gen=0, explode=False):
        self.d, self.ex_mod, self.cid = d, ex_mod, cid
        self.events, self.generation, self.explode = events, start_gen, explode
        self.bugs = []

    def run(self, g):
        if self.explode:
            raise RuntimeError("planted slice failure")
        self.generation += g
        self.events.append(("run", self.cid, self.generation))
        return _report(self.ex_mod)

    def checkpoint(self):
        self.events.append(("ckpt", self.cid, self.generation))
        os.makedirs(os.path.join(self.d, "campaigns", self.cid),
                    exist_ok=True)


def _listing(d):
    return {sub: sorted(os.listdir(os.path.join(d, sub)))
            for sub in ("queue", "active", "done")}


def _write(d, sub, name, doc):
    os.makedirs(os.path.join(d, sub), exist_ok=True)
    with open(os.path.join(d, sub, f"{name}.json"), "w") as f:
        if isinstance(doc, str):
            f.write(doc)
        else:
            json.dump(doc, f)


def _by_campaign(events):
    """Each campaign's own events, in the order they happened."""
    out = {}
    for e in events:
        out.setdefault(e[1], []).append(e)
    return out


def _serve_both(tmp_path, setup, make_stub=None, **kw):
    """Serve the same request dir on each face with stub campaigns:
    {face: (result, lines, events, listing, dir)}; the faces' streams,
    events and listings must be equal. With more than one device, each
    device's slice lane appends its stubs' events from its own thread, so
    the global interleaving is the OS scheduler's on either face: there
    each campaign's own event sequence must be equal (the streamed lines
    are sorted by both faces before they print, and stay compared
    whole)."""
    out = {}
    for face, (mod, ex_mod) in FACES.items():
        d = str(tmp_path / face)
        setup(d)
        events, lines = [], []

        def factory(request, campaign_dir, regression_dir, log):
            if make_stub is not None:
                return make_stub(d, ex_mod, request, events)
            return Stub(d, ex_mod, request["id"], events)

        res = mod.serve(d, out=lambda s: lines.append(json.loads(s)),
                        factory=factory, sleep=lambda s: None, oracle=False,
                        **kw)
        out[face] = (res, lines, events, _listing(d), d)
    threaded = len(kw.get("devices") or ()) > 1
    for i in range(4):
        if i == 2 and threaded:
            assert _by_campaign(out["port"][2]) == _by_campaign(
                out["jax"][2])
            continue
        assert out["port"][i] == out["jax"][i], i
    return out["port"]


def test_serve_queue_mechanics_with_stub_campaigns(tmp_path):
    """Requests move queue/ -> active/ -> done/, slices round-robin, one
    JSON line streams per slice, each slice checkpoints before its line."""
    def setup(d):
        for name, gens in (("a", 2), ("b", 1)):
            _write(d, "queue", name, {"workload": "raft", "generations": gens})

    res, lines, events, listing, d = _serve_both(
        tmp_path, setup, slice_generations=1, max_rounds=5, idle_rounds=1)
    assert res["completed"] == ["b", "a"] and not res["pending"]
    assert events == [
        ("run", "a", 1), ("ckpt", "a", 1), ("run", "b", 1),
        ("ckpt", "b", 1), ("run", "a", 2), ("ckpt", "a", 2),
    ]
    slices = [l for l in lines if "report" in l]
    assert [(l["campaign"], l["generation"]) for l in slices] == [
        ("a", 1), ("b", 1), ("a", 2),
    ]
    assert all(l["fingerprint"] == _report(explore).fingerprint()
               for l in slices)
    assert listing == {"queue": [], "active": [], "done": ["a.json",
                                                           "b.json"]}
    for name in ("a", "b"):
        stream = campaign._read_jsonl(
            os.path.join(d, "campaigns", name, campaign.REPORTS_STREAM))
        assert [s["generation"] for s in stream] == (
            [1, 2] if name == "a" else [1])
    status = json.load(open(os.path.join(d, campaign.STATUS)))
    jstatus = json.load(open(os.path.join(str(tmp_path / "jax"), jc.STATUS)))
    for doc in (status, jstatus):
        doc.pop("uptime_s")
        for row in doc["per_device"]:
            row.pop("busy_s"), row.pop("occupancy"), row.pop("seeds_per_sec")
    assert status == jstatus and status["completed"] == ["b", "a"]
    assert os.path.exists(os.path.join(d, campaign.METRICS_TEXTFILE))


def test_serve_survives_bad_requests(tmp_path):
    """Malformed JSON is retried then rejected to done/, non-positive
    generations and factory failures are rejected at once, and a campaign
    whose slice raises is evicted while the others keep running."""
    reqs = {
        "ok": {"workload": "raft", "generations": 1},
        "explodes": {"workload": "raft", "generations": 2},
        "unbuildable": {"workload": "nope", "generations": 1},
        "zero": {"workload": "raft", "generations": 0},
        "garbage": "{not json",
    }

    def setup(d):
        for name, req in reqs.items():
            _write(d, "queue", name, req)

    def make_stub(d, ex_mod, request, events):
        if request["id"] == "unbuildable":
            raise ValueError("unknown workload")
        return Stub(d, ex_mod, request["id"], events,
                    explode=request["id"] == "explodes")

    res, lines, _, listing, _ = _serve_both(
        tmp_path, setup, make_stub, slice_generations=1, max_rounds=6,
        idle_rounds=2)
    assert res["completed"] == ["ok"] and not res["pending"]
    rejected = {l["campaign"]: l["rejected"] for l in lines
                if "rejected" in l}
    assert "generations" in rejected["zero"]
    assert "unknown workload" in rejected["unbuildable"]
    assert "planted slice failure" in rejected["explodes"]
    assert any("unreadable request" in v for v in rejected.values())
    assert listing["queue"] == listing["active"] == []
    assert len(listing["done"]) == 5
    assert [(l["campaign"], l["generation"]) for l in lines
            if "report" in l] == [("ok", 1)]


def test_serve_crash_recovery_and_total_generation_semantics(tmp_path):
    """A restart requeues requests orphaned in active/, and `generations`
    is the campaign's TOTAL target: a resumed campaign runs only the
    remainder, an already-satisfied request completes without running."""
    start_gens = {"orphan": 3, "satisfied": 5}

    def setup(d):
        _write(d, "active", "orphan", {"workload": "raft", "generations": 4})
        _write(d, "queue", "satisfied", {"workload": "raft",
                                         "generations": 2})

    def make_stub(d, ex_mod, request, events):
        return Stub(d, ex_mod, request["id"], events,
                    start_gen=start_gens[request["id"]])

    res, lines, events, listing, _ = _serve_both(
        tmp_path, setup, make_stub, slice_generations=2, max_rounds=4,
        idle_rounds=1)
    assert sorted(res["completed"]) == ["orphan", "satisfied"]
    assert [e for e in events if e[0] == "run"] == [("run", "orphan", 4)]
    assert any(l.get("completed") and l["campaign"] == "satisfied"
               and l["generation"] == 5 for l in lines)
    assert listing == {"queue": [], "active": [],
                       "done": ["orphan.json", "satisfied.json"]}


def test_serve_active_files_keyed_by_campaign_id(tmp_path):
    """In-flight requests park as active/<campaign id>.json: a request
    reusing an in-flight request's filename with another id clobbers
    nothing."""
    def setup(d):
        _write(d, "queue", "job", {"id": "a", "workload": "raft",
                                   "generations": 2})

    _, _, _, listing, _ = _serve_both(tmp_path, setup, slice_generations=1,
                                      max_rounds=1)
    assert listing["active"] == ["a.json"]

    # a second request reuses the FILENAME while "a" is in flight (the
    # service restarted: the orphan requeues under its id)
    for face, (mod, ex_mod) in FACES.items():
        d = str(tmp_path / face)
        _write(d, "queue", "job", {"id": "b", "workload": "raft",
                                   "generations": 1})
        events = []
        res = mod.serve(
            d, slice_generations=1, max_rounds=4, idle_rounds=1,
            out=lambda s: None, sleep=lambda s: None, oracle=False,
            factory=lambda r, cd, rd, log, d=d, ex_mod=ex_mod:
            Stub(d, ex_mod, r["id"], events))
        assert sorted(res["completed"]) == ["a", "b"], face
        assert _listing(d) == {"queue": [], "active": [],
                               "done": ["a.json", "b.json"]}, face


def test_serve_schedules_stub_devices_like_the_jax_face(tmp_path):
    """Device-aware round-robin over stub device tokens (one thread per
    device): least-loaded placement honoring a request's device pin, a
    bad pin rejected, the same stream on both faces."""
    def setup(d):
        for name in ("a", "b", "c"):
            _write(d, "queue", name, {"workload": "raft", "generations": 2})
        _write(d, "queue", "pinned", {"workload": "raft", "generations": 1,
                                      "devices": [1]})
        _write(d, "queue", "bad", {"workload": "raft", "generations": 1,
                                   "devices": [5]})

    res, lines, _, _, _ = _serve_both(
        tmp_path, setup, slice_generations=1, max_rounds=4, idle_rounds=1,
        devices=["d0", "d1"])
    assert res["devices"] == 2 and not res["pending"]
    slices = [(l["campaign"], l["device"]) for l in lines if "report" in l]
    assert ("pinned", 1) in slices
    assert {dv for _, dv in slices} == {0, 1}
    assert any("out of range" in l.get("rejected", "") for l in lines)


def test_serve_request_auto_tuning_resolves_before_conflict_check(
    tmp_path, monkeypatch,
):
    """A request with "tuning": "auto" resumes cleanly while the tuned
    cache is unchanged: the string resolves against the checkpoint's own
    workload and lane scale before the conflict check, on both faces."""
    monkeypatch.setenv("MADSIM_TUNED_DIR", str(tmp_path))
    man = {
        "workload": campaign.named_workload_ref("raft", 0.5, False),
        "params": {"meta_seed": 0, "lanes": 16, "chunk": 16},
        "tuning": None,
    }
    for mod, kw in ((campaign, {"device": "cpu"}), (jc, {})):
        given = mod._explicit_request_params({"tuning": "auto"}, man, **kw)
        assert given["tuning"] is None
        mod.check_resume_conflicts(man, given)
    wl = explore._named_workload("raft", 0.5, False)
    tune.TunedEntry(
        device_kind="cpu", workload=wl.spec.name,
        config_hash=tune.config_hash_sans_tier_b(wl.config),
        lane_bucket=tune.lane_bucket(16), dispatch={"chunk": 8},
    ).save()
    man2 = dict(man, tuning={"chunk": 8})
    for mod, kw in ((campaign, {"device": "cpu"}), (jc, {})):
        given2 = mod._explicit_request_params({"tuning": "auto"}, man2, **kw)
        assert given2["tuning"] == {"chunk": 8}
        mod.check_resume_conflicts(man2, given2)
        with pytest.raises(ValueError, match="tuning"):
            mod.check_resume_conflicts(man, given2)
    assert campaign._explicit_request_params(
        {"chunk": 0, "lanes": 16, "workload": "raft", "storm": None}) == \
        jc._explicit_request_params(
            {"chunk": 0, "lanes": 16, "workload": "raft", "storm": None})


SMALL = {"workload": "raft", "virtual_secs": 0.2, "lanes": 8, "chunk": 8,
         "generations": 2, "shrink": False}


def test_serve_refuses_the_oracle_tenant_and_several_cards(tmp_path):
    """The oracle tenant runs (it was refused until item 16 came): a
    serve with the default `oracle=True` and the CLI without --no-oracle
    both write oracle.json and the status block. Serve over several
    devices (once refused as item 14) runs: two CPU devices, two slice
    lanes on two threads, drain three real small campaigns with the
    fingerprints the one-device serve streams, generation for
    generation."""
    d = str(tmp_path / "svc")
    _write(d, "queue", "o", dict(SMALL, meta_seed=9, generations=1))
    res = campaign.serve(d, out=lambda s: None, sleep=lambda s: None,
                         idle_rounds=1, oracle_sample_rate=1.0,
                         device="cpu")
    assert res["completed"] == ["o"]
    with open(os.path.join(d, "status.json")) as f:
        block = json.load(f)["oracle"]
    assert block["seeds_checked"] == 2 and block["errors"] == 0
    assert block["skipped_saturated"] > 0 and block["divergences"] == 0
    with open(os.path.join(d, "oracle.json")) as f:
        assert json.load(f)["cursor"] == {"o": 1}
    campaign.main(["serve", "--dir", d, "--device", "cpu",
                   "--max-rounds", "1", "--idle-rounds", "1"])
    with open(os.path.join(d, "oracle.json")) as f:
        assert json.load(f)["seeds_checked"] == 2  # the cursor resumed
    for dev in (None, torch.device("cpu"), "d0", 3):
        assert isinstance(campaign._device_ctx(dev),
                          contextlib.nullcontext)
    with pytest.raises(SystemExit, match="out of range"):
        campaign.main(["serve", "--dir", d, "--device", "cpu", "--no-oracle",
                       "--devices", "2"])
    streams = {}
    for name, devices in (("one", None),
                          ("two", [torch.device("cpu")] * 2)):
        farm = str(tmp_path / name)
        for i, cid in enumerate(("a", "b", "c")):
            _write(farm, "queue", cid, dict(SMALL, meta_seed=i + 1))
        lines = []
        res = campaign.serve(
            farm, out=lambda s: lines.append(json.loads(s)),
            sleep=lambda s: None, oracle=False, idle_rounds=1,
            devices=devices, device="cpu")
        assert sorted(res["completed"]) == ["a", "b", "c"]
        assert res["devices"] == (2 if devices else 1)
        streams[name] = sorted((x["campaign"], x["generation"],
                                x["fingerprint"])
                               for x in lines if "fingerprint" in x)
        if devices:
            assert {x["device"] for x in lines if "report" in x} == {0, 1}
    assert streams["two"] == streams["one"] and len(streams["one"]) == 6


REQUEST = {"workload": "raft", "virtual_secs": 0.5, "meta_seed": 11,
           "lanes": 16, "chunk": 8, "generations": 2, "shrink": False}


def test_serve_end_to_end_streams_the_jax_fingerprints(
    tmp_path, monkeypatch, capsys,
):
    """Two real requests, one under "tuning": "auto" (a tuned-cache entry
    both faces read: chunk 4, refill lanes 4, pipeline off; the request's
    own chunk wins over the tuned one): the JAX face
    serves them in one run, the port through its CLI on the CPU, killed
    after round 1 and restarted. Every port line carries the JAX line's
    fingerprint, and the tuned campaign's equal the untuned one's."""
    monkeypatch.setenv("MADSIM_TUNED_DIR", str(tmp_path / "tuned"))
    wl = explore._named_workload("raft", 0.5, False)
    tune.TunedEntry(
        device_kind="cpu", workload=wl.spec.name,
        config_hash=tune.config_hash_sans_tier_b(wl.config),
        lane_bucket=tune.lane_bucket(16),
        dispatch={"chunk": 4, "refill_lanes": 4, "pipeline": False},
    ).save()
    assert jtune.resolve_tuning("auto", wl.spec.name, wl.config, 16) == \
        {"chunk": 4, "refill_lanes": 4, "pipeline": False}
    streams = {}
    for face in ("jax", "port"):
        d = str(tmp_path / face)
        _write(d, "queue", "plain", REQUEST)
        _write(d, "queue", "tuned", dict(REQUEST, tuning="auto"))
        if face == "jax":
            lines = []
            jc.serve(d, out=lambda s: lines.append(json.loads(s)),
                     sleep=lambda s: None, oracle=False, idle_rounds=1)
        else:
            argv = ["serve", "--dir", d, "--device", "cpu", "--no-oracle",
                    "--poll", "0"]
            campaign.main(argv + ["--max-rounds", "1"])  # the kill
            assert _listing(d)["active"] == ["plain.json", "tuned.json"]
            campaign.main(argv + ["--idle-rounds", "1"])  # the restart
            lines = [json.loads(s) for s in
                     capsys.readouterr().out.strip().splitlines()]
            man = json.load(open(os.path.join(
                d, "campaigns", "tuned", campaign.MANIFEST)))
            assert man["tuning"] == {"chunk": 4, "refill_lanes": 4,
                                     "pipeline": False}
            # the request's explicit chunk wins; the tuned pipeline lands
            assert man["params"]["chunk"] == 8
            assert man["params"]["pipeline"] is False
        assert _listing(d)["done"] == ["plain.json", "tuned.json"]
        streams[face] = sorted(
            (l["campaign"], l["generation"], l["fingerprint"])
            for l in lines if "fingerprint" in l)
    assert streams["port"] == streams["jax"] and len(streams["port"]) == 4
    by_gen = {}
    for cid, gen, fp in streams["port"]:
        by_gen.setdefault(gen, set()).add(fp)
    assert all(len(fps) == 1 for fps in by_gen.values())
