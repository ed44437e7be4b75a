"""Continuous batching on the port against the JAX engine.

tests/test_refill.py's properties, held against the JAX face directly; the
same seeds and ctl rows go through both faces on the CPU:
  * refill sweeps: the whole final state (queue and log included) and the
    `refill_results` rows equal the JAX engine's, and the rows equal the
    port's chunked rows per seed: plain (A=24, L=4), triage + coverage on
    the 10x horizon spread (A=80, L=4, occupancy >= 0.90), truncation at
    max_steps=120, and the total_steps=50 cutoff with its host-side final
    harvest; the pinned spread-mix run's row digest is PINNED_REFILL;
  * run_batch(refill=4, coverage=True) equals the chunked
    run_batch(chunk=8, coverage=True) and the JAX face's refill summary,
    pipeline on and off; refill rejects lane_check workloads, and
    check_determinism runs on the refill path;
  * shrink_seed(refill=False) gives the bundle that the default refill
    evaluator and the JAX face give (the planted shrink of
    tests/test_torch_triage.py);
  * @batch_test honours MADSIM_TEST_SEED/NUM/TIME_LIMIT/CONFIG/
    CHECK_DETERMINISM like the JAX face's decorator.

Tolerances: exact, except the float lane means of the summaries (rtol
1e-6, summed in another order on each face).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke
from madsim_tpu import nemesis as jn
from madsim_tpu import tune as jtune
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import batch as jbatch
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu.engine import TriageCtl as JaxCtl
from madsim_tpu.tpu.engine import refill_results as jax_refill_results
from madsim_tpu.tpu.engine import summarize_refill as jax_summarize_refill
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch import triage
from madsim_tpu_torch.tpu import (
    BatchDeterminismError, BatchViolation, BatchWorkload, BatchedSim,
    SimConfig, batch_test, make_raft_spec, pipelined, run_batch,
)
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import (
    PINNED_BUNDLE, PINNED_REFILL, REFILL_RUN, bundle_digest, refill_digest,
    refill_run, spread_ctl,
)
from madsim_tpu_torch.tpu.engine import refill_results, summarize_refill
from madsim_tpu_torch.tpu.spec import REBASE_US
from test_torch_engine import assert_leaves_equal, assert_summaries_equal
from test_torch_triage import SPEC_REF, jax_leaves

HORIZON = 1_000_000


def _plan(m):
    """tests/test_refill.py's PLAN, on either face's nemesis module."""
    return m.FaultPlan(name="refill-tests", clauses=(
        m.Crash(interval_lo_us=150_000, interval_hi_us=450_000,
                down_lo_us=100_000, down_hi_us=300_000),
        m.Partition(interval_lo_us=200_000, interval_hi_us=600_000,
                    heal_lo_us=150_000, heal_hi_us=450_000),
        m.MsgLoss(rate=0.05),
    ))


JCFG = jtn.compile_plan(_plan(jn), JaxConfig(horizon_us=HORIZON))
CFG = ttn.compile_plan(_plan(tn), SimConfig(horizon_us=HORIZON))

# per-admission rows the refill/chunked identity covers
# (tests/test_refill.py:53-58, plus the coverage rows)
ROW_FIELDS = (
    "violated", "deadlocked", "violation_at", "violation_epoch",
    "violation_step", "steps", "events", "overflow", "dead_drops",
    "clock", "epoch", "fires", "occ_fired",
)
COV_ROWS = ("cov_bitmap", "cov_hiwater", "cov_transitions")
HOST_KEYS = {"device_ms", "dispatches", "n_devices"}


@pytest.fixture(scope="module")
def sims():
    """(JAX sim, port sim) pairs: plain, and triage + coverage."""
    assert CFG.to_toml() == JCFG.to_toml()
    return {
        "plain": (JaxSim(jax_raft_spec(), JCFG),
                  BatchedSim(make_raft_spec(), CFG, device="cpu")),
        "tcov": (JaxSim(jax_raft_spec(), JCFG, triage=True, coverage=True),
                 BatchedSim(make_raft_spec(), CFG, triage=True, coverage=True,
                            device="cpu")),
    }


def _chunked_rows(sim, seeds, ctl=None, max_steps=30_000):
    """The port's chunked rows of the same admissions, one lane each (rows
    do not depend on the chunk: no draw folds the lane index)."""
    st = sim.run(seeds, max_steps=max_steps, dispatch_steps=max_steps,
                 ctl=ctl)
    out = {f: getattr(st, f) for f in ROW_FIELDS}
    if st.cov is not None:
        out.update(cov_bitmap=st.cov.bitmap, cov_hiwater=st.cov.hiwater,
                   cov_transitions=st.cov.transitions)
    return {k: None if v is None else v.numpy() for k, v in out.items()}


def _both_refill(pair, seeds, lanes, max_steps=30_000, jctl=None, ctl=None,
                 total_steps=None):
    """Both faces' refill sweeps: (JAX results, port results, port state),
    after holding the whole final states leaf for leaf."""
    jsim, psim = pair
    jst = jsim.run_refill(np.asarray(seeds, np.uint32), lanes=lanes,
                          max_steps=max_steps, ctl=jctl,
                          total_steps=total_steps)
    pst = psim.run_refill(seeds, lanes=lanes, max_steps=max_steps, ctl=ctl,
                          total_steps=total_steps)
    got = state_to_numpy(pst)
    assert {"queue.seeds", "refill.cursor", "refill.retired"} <= set(got)
    assert_leaves_equal(jax_leaves(jst), got, "refill state")
    jres, res = jax_refill_results(jst), refill_results(pst)
    assert set(jres) == set(res)
    for k, v in jres.items():
        if isinstance(v, np.ndarray):
            assert res[k].dtype == v.dtype, k
            np.testing.assert_array_equal(res[k], v, err_msg=k)
        else:
            assert res[k] == v, k
    return jres, res, pst


def _assert_rows_equal(ref, res, fields):
    for f in fields:
        if ref.get(f) is None:
            assert res.get(f) is None, f
            continue
        np.testing.assert_array_equal(ref[f], res[f],
                                      err_msg=f"refill row {f} != chunked")


def test_refill_plain_equals_jax_and_chunked(sims):
    A, L = 24, 4
    seeds = list(range(A))
    _, res, pst = _both_refill(sims["plain"], seeds, L)
    assert res["truncated"] == 0
    assert (res["retired"] >= 0).all()
    assert int(pst.refill.cursor) == A
    _assert_rows_equal(_chunked_rows(sims["plain"][1], seeds), res,
                       ROW_FIELDS)


def test_refill_horizon_spread_triage_coverage(sims):
    """Per-admission ctl rows with a 10x horizon spread, coverage on:
    rows (every coverage bitmap included) equal the chunked path's,
    refills interleave with still-running survivors, and occupancy clears
    0.90, far above the chunked path's at the same lane count."""
    A, L = 80, 4
    seeds = list(range(A))
    h = np.where(np.arange(A) % 4 == 0, HORIZON, HORIZON // 10)
    jctl = JaxCtl(
        off=jnp.zeros((A,), jnp.int32), occ=jnp.zeros((A, 4), jnp.int32),
        rate_scale=jnp.ones((A, 3), jnp.float32),
        h_epoch=jnp.asarray((h // REBASE_US).astype(np.int32)),
        h_off=jnp.asarray((h % REBASE_US).astype(np.int32)),
    )
    ctl = triage._ctl_of_rows([(0, [0] * 4, [1.0] * 3, int(x)) for x in h])
    jres, res, _ = _both_refill(sims["tcov"], seeds, L, jctl=jctl, ctl=ctl)
    assert res["truncated"] == 0
    ref = _chunked_rows(sims["tcov"][1], seeds, ctl=ctl)
    _assert_rows_equal(ref, res, ROW_FIELDS + COV_ROWS)
    assert res["retired"][L:].min() < res["retired"][:L].max()
    assert res["occupancy"] >= 0.90, res["occupancy"]
    steps = ref["steps"].reshape(-1, L)
    chunked_occ = steps.sum() / (steps.max(axis=1) * L).sum()
    assert res["occupancy"] > chunked_occ + 0.2
    s, js = summarize_refill(res), jax_summarize_refill(jres)
    assert s["lanes"] == A and "fires_crash" in s
    assert_summaries_equal(js, s)


def test_refill_truncation_matches_chunked(sims):
    """max_steps binds: an admission at its step budget retires truncated
    at the step the chunked loop stops it."""
    A, L, cap = 12, 4, 120
    seeds = list(range(A))
    _, res, _ = _both_refill(sims["plain"], seeds, L, max_steps=cap)
    _assert_rows_equal(_chunked_rows(sims["plain"][1], seeds, max_steps=cap),
                       res, ROW_FIELDS)
    assert (res["steps"] == cap).any()
    assert (res["retired"] >= 0).all()
    assert res["truncated"] == 0


def test_refill_results_final_harvest_on_budget_cutoff(sims):
    """total_steps binds mid-admission: the live lanes are harvested on
    the host, as on the JAX face."""
    _, res, pst = _both_refill(sims["plain"], list(range(8)), 4,
                               total_steps=50)
    assert res["truncated"] > 0 and res["iters"] == 50
    assert not res["violated"][pst.refill.admitted.numpy()].any()


def test_pinned_refill_run_digest():
    """The pinned spread-mix refill run (256 admissions over 16 lanes,
    triage + coverage): both faces' row digests are PINNED_REFILL, which
    chip_smoke.py holds the card to."""
    spec, cfg, seeds, ctl, lanes, max_steps = refill_run()
    h = REFILL_RUN[0]
    jsim, _ = jtune.spread_mix_sim(h / 1e6)
    assert jsim.config.to_toml() == cfg.to_toml()
    jctl = jtune.spread_ctl_rows(h, len(seeds))
    for f in JaxCtl._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jctl, f)),
                                      getattr(ctl, f).numpy(), err_msg=f)
    pair = (JaxSim(jax_raft_spec(), jsim.config, triage=True, coverage=True),
            BatchedSim(spec, cfg, triage=True, coverage=True, device="cpu"))
    jres, res, _ = _both_refill(pair, seeds, lanes, max_steps=max_steps,
                                jctl=jctl, ctl=ctl)
    assert refill_digest(jres) == PINNED_REFILL
    assert refill_digest(res) == PINNED_REFILL
    assert res["occupancy"] >= 0.90
    # the digest is spread_ctl's rows at any admission count
    assert spread_ctl(h, 9).h_off.tolist() == [h] + [h // 10] * 7 + [h]


@pytest.fixture(scope="module")
def batches():
    """run_batch on 16 seeds: the port chunked (chunk=8), the port refill
    (refill=4 over chunks of 8) pipelined and serial, and the JAX face's
    refill sweep; all with coverage."""
    wl = BatchWorkload(spec=make_raft_spec(), config=CFG, max_steps=30_000)
    jwl = jbatch.BatchWorkload(spec=jax_raft_spec(), config=JCFG,
                               max_steps=30_000)
    seeds = range(16)
    kw = dict(max_traces=0, coverage=True, device="cpu")
    return dict(
        chunked=run_batch(seeds, wl, chunk=8, **kw),
        refill=run_batch(seeds, wl, chunk=8, refill=4, **kw),
        serial=run_batch(seeds, wl, chunk=8, refill=4, pipeline=False, **kw),
        jax=jbatch.run_batch(seeds, jwl, chunk=8, refill=4, mesh=None,
                             max_traces=0, coverage=True),
    )


@pytest.mark.parametrize("which", ["refill", "serial"])
def test_run_batch_refill_matches_chunked_and_jax(batches, which):
    rc, rr, jr = batches["chunked"], batches[which], batches["jax"]
    for a in (rc, jr):
        np.testing.assert_array_equal(rr.violated, a.violated)
        np.testing.assert_array_equal(rr.violation_step, a.violation_step)
        np.testing.assert_array_equal(rr.coverage.bitmap, a.coverage.bitmap)
        np.testing.assert_array_equal(rr.coverage.hiwater, a.coverage.hiwater)
        np.testing.assert_array_equal(rr.coverage.transitions,
                                      a.coverage.transitions)
        np.testing.assert_array_equal(rr.coverage.occ_fired,
                                      a.coverage.occ_fired)
    np.testing.assert_array_equal(rr.retired_step, jr.retired_step)
    assert rr.occupancy == jr.occupancy
    assert rr.coverage.bitmap.dtype == np.uint32
    assert_summaries_equal(
        {k: v for k, v in jr.summary.items() if k not in HOST_KEYS},
        {k: v for k, v in rr.summary.items() if k not in HOST_KEYS})
    assert rr.summary["refill_lanes"] == 4
    for k in ("violations", "deadlocked", "total_events", "total_overflow",
              "total_dead_drops", "coverage_bits", "mean_steps",
              "fires_crash", "fires_partition", "fires_loss"):
        assert rc.summary[k] == rr.summary[k], k
    for r in (rc, rr):
        assert 0 < r.occupancy <= 1
        assert r.retired_step.shape == r.violation_step.shape == (16,)


def test_run_batch_refill_rejects_lane_check():
    wl = BatchWorkload(spec=make_raft_spec(), config=CFG, max_steps=1000,
                       lane_check=lambda st, lanes: {"violations": 0})
    with pytest.raises(ValueError, match="lane_check"):
        run_batch(range(8), wl, refill=4, device="cpu")


def test_refill_determinism_check_mode():
    """check_determinism runs every refill segment twice and compares the
    whole final states, queue and log included; an impure spec fails."""
    cfg = dataclasses.replace(CFG, horizon_us=200_000)
    wl = BatchWorkload(spec=make_raft_spec(), config=cfg, max_steps=30_000)
    r = run_batch(range(8), wl, chunk=8, refill=4, check_determinism=True,
                  device="cpu", max_traces=0)
    assert r.summary["refill_lanes"] == 4 and r.retired_step.min() >= 0
    calls = []
    init = wl.spec.init

    def impure_init(key, nid):
        calls.append(1)
        state, timer = init(key, nid)
        return state, timer + len(calls)

    bad = dataclasses.replace(wl, spec=dataclasses.replace(
        wl.spec, init=impure_init))
    with pytest.raises(BatchDeterminismError, match="refill"):
        run_batch(range(8), bad, chunk=8, refill=4, check_determinism=True,
                  device="cpu", max_traces=0)


def test_pipelined_decodes_in_order_and_stops_early():
    log = []

    def dispatch(i):
        log.append(("d", i))
        return i

    def decode(i):
        log.append(("r", i))
        return i if i == 2 else None

    assert pipelined(range(5), dispatch, decode) == 2
    assert log == [("d", 0), ("d", 1), ("r", 0), ("d", 2), ("r", 1),
                   ("d", 3), ("r", 2)]
    log.clear()
    assert pipelined(range(2), dispatch, decode, serial=True) is None
    assert log == [("d", 0), ("r", 0), ("d", 1), ("r", 1)]


def test_shrink_refill_and_chunked_bundles_agree():
    """The planted re-stamp seed shrunk by the chunked evaluator writes
    the bundle of the JAX face and of the port's default refill evaluator
    (tests/test_torch_triage.py holds that one to PINNED_BUNDLE)."""
    wl = chip_smoke.triage_workload()
    sr = triage.shrink_seed(wl, PINNED_BUNDLE[0], lane_width=4, refill=False,
                            spec_ref=SPEC_REF, device="cpu")
    assert bundle_digest(sr.bundle) == PINNED_BUNDLE[1]
    assert len(sr.kept_atoms) < sr.original_atoms


def _env_workloads(tmp_path, monkeypatch):
    toml = tmp_path / "cfg.toml"
    toml.write_text("loss_rate = 0.2\nlatency_hi_us = 20000\n")
    monkeypatch.setenv("MADSIM_TEST_SEED", "5")
    monkeypatch.setenv("MADSIM_TEST_NUM", "6")
    monkeypatch.setenv("MADSIM_TEST_TIME_LIMIT", "0.3")
    monkeypatch.setenv("MADSIM_TEST_CONFIG", str(toml))
    monkeypatch.setenv("MADSIM_TEST_CHECK_DETERMINISM", "1")
    wl = BatchWorkload(spec=make_raft_spec(), config=SimConfig(),
                       max_steps=5_000)
    jwl = jbatch.BatchWorkload(spec=jax_raft_spec(), config=JaxConfig(),
                               max_steps=5_000)
    return wl, jwl, toml


def test_batch_test_honours_the_env(tmp_path, monkeypatch):
    wl, jwl, toml = _env_workloads(tmp_path, monkeypatch)
    got = {}

    @batch_test(wl, device="cpu")
    def port_test(result, extra):
        got["port"] = (result, extra)

    @jbatch.batch_test(jwl)
    def jax_test(result):
        got["jax"] = result

    port_test(extra=7)
    jax_test()
    result, extra = got["port"]
    assert extra == 7
    assert result.seeds.tolist() == list(range(5, 11))
    cfg = result.workload.config
    assert (cfg.horizon_us, cfg.loss_rate, cfg.latency_hi_us) == (
        300_000, 0.2, 20_000)
    jr = got["jax"]
    np.testing.assert_array_equal(result.violated, jr.violated)
    np.testing.assert_array_equal(result.retired_step, jr.retired_step)
    assert_summaries_equal(
        {k: v for k, v in jr.summary.items() if k not in HOST_KEYS},
        {k: v for k, v in result.summary.items() if k not in HOST_KEYS})
    # an unknown TOML key fails loudly on both faces
    toml.write_text("no_such_knob = 1\n")
    with pytest.raises(ValueError, match="MADSIM_TEST_CONFIG"):
        port_test(extra=0)


def test_batch_test_raises_on_violation(monkeypatch):
    monkeypatch.setenv("MADSIM_TEST_NUM", "2")
    monkeypatch.setenv("MADSIM_TEST_TIME_LIMIT", "0.5")
    spec = dataclasses.replace(make_raft_spec(), check_invariants=(
        lambda ns, alive, now: now < 100_000))
    wl = BatchWorkload(spec=spec, config=SimConfig(), max_steps=5_000)
    seen = []

    @batch_test(wl, device="cpu")
    def fails(result):
        seen.append(result)

    with pytest.raises(BatchViolation, match="MADSIM_TEST_SEED"):
        fails()
    assert not seen

    @batch_test(wl, expect_violations=True, device="cpu")
    def expects(result):
        seen.append(result)

    expects()
    assert seen[0].violations == 2
