"""The port on a CUDA card: the pinned digest, and the card against the CPU.

These tests need a card and skip without one (marker `cuda`). They import
no JAX, so they run where only torch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda -q
"""

import numpy as np
import pytest
import torch

from madsim_tpu_torch.tpu import BatchedSim
from madsim_tpu_torch.tpu import prng
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import PINNED, canonical_digest, pinned_run


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (python3 chip_smoke.py covers it too)")
    torch.use_deterministic_algorithms(True)
    return torch.device("cuda")


@pytest.mark.cuda
def test_u32_product_wrap_on_the_card(cuda_device):
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1], np.uint32),
        rng.integers(0, 2**32, size=1 << 16, dtype=np.uint64).astype(np.uint32),
    ])
    for c in (0x85EBCA6B, 0xC2B2AE35, prng.GOLDEN):
        got = prng._mul32(torch.as_tensor(x.astype(np.int64), device=cuda_device), c)
        np.testing.assert_array_equal(
            got.cpu().numpy(), (x * np.uint32(c)).astype(np.int64)
        )


@pytest.mark.cuda
def test_card_run_matches_pinned_digest_and_cpu(cuda_device):
    spec, cfg, seeds, max_steps = pinned_run("raft_entry")
    card = state_to_numpy(
        BatchedSim(spec, cfg, device=cuda_device).run(seeds, max_steps)
    )
    assert canonical_digest(card) == PINNED["raft_entry"]
    cpu = state_to_numpy(
        BatchedSim(spec, cfg, device="cpu").run(seeds[:8], max_steps)
    )
    sub = state_to_numpy(
        BatchedSim(spec, cfg, device=cuda_device).run(seeds[:8], max_steps)
    )
    for k in cpu:
        np.testing.assert_array_equal(sub[k], cpu[k], err_msg=k)


def _slice3_configs():
    """(spec, config) of the third slice's paths: the two-handler
    unilateral-abort 2PC participant under the 5% straggler tail, and the
    buggy WAL under Reconfig + DiskFault."""
    from madsim_tpu_torch import nemesis as nm
    from madsim_tpu_torch.tpu import (
        SimConfig, buggy_ack_before_fsync_spec, compile_plan,
        unilateral_abort_spec,
    )

    plan = nm.FaultPlan(clauses=(
        nm.Reconfig(interval_lo_us=300_000, interval_hi_us=900_000),
        nm.DiskFault(interval_lo_us=300_000, interval_hi_us=900_000,
                     torn_rate=0.5),
    ))
    return {
        "two_handler_tail": (
            unilateral_abort_spec(5),
            SimConfig(horizon_us=10_000_000, loss_rate=0.0, msg_depth_msg=2,
                      msg_depth_timer=2, buggify_delay_rate=0.05),
        ),
        "reconfig_disk": (
            buggy_ack_before_fsync_spec(n_nodes=4),
            compile_plan(plan, SimConfig(horizon_us=6_000_000,
                                         msg_depth_msg=2,
                                         msg_spare_slots=2)),
        ),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["two_handler_tail", "reconfig_disk"])
def test_third_slice_paths_card_equals_cpu(cuda_device, name):
    spec, cfg = _slice3_configs()[name]
    seeds = list(range(32))
    card = state_to_numpy(
        BatchedSim(spec, cfg, device=cuda_device).run(seeds, 300)
    )
    cpu = state_to_numpy(BatchedSim(spec, cfg, device="cpu").run(seeds, 300))
    assert set(card) == set(cpu)
    for k in cpu:
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)


@pytest.mark.cuda
def test_card_shrink_bundle_matches_pinned_digest(cuda_device):
    """The planted re-stamp shrink on the card writes the bundle whose
    digest the CPU tests hold equal to the JAX face's."""
    import chip_smoke
    from madsim_tpu_torch import triage
    from madsim_tpu_torch.tpu.digest import PINNED_BUNDLE, bundle_digest

    seed, sha = PINNED_BUNDLE
    sr = triage.shrink_seed(chip_smoke.triage_workload(), seed,
                            spec_ref=chip_smoke.TRIAGE_SPEC_REF,
                            device=cuda_device)
    assert sr.dispatches <= 10
    assert bundle_digest(sr.bundle) == sha


@pytest.mark.cuda
def test_card_refill_run_matches_pinned_digest_and_cpu(cuda_device):
    """The pinned spread-mix refill run (triage + coverage) on the card:
    its row digest is PINNED_REFILL, and its whole final state, queue and
    log included, equals the CPU's."""
    from madsim_tpu_torch.tpu.digest import (
        PINNED_REFILL, refill_digest, refill_run,
    )
    from madsim_tpu_torch.tpu.engine import refill_results

    spec, cfg, seeds, ctl, lanes, max_steps = refill_run()
    states = {}
    for dev in (cuda_device, "cpu"):
        st = BatchedSim(spec, cfg, triage=True, coverage=True,
                        device=dev).run_refill(seeds, lanes=lanes,
                                               max_steps=max_steps, ctl=ctl)
        assert refill_digest(refill_results(st)) == PINNED_REFILL
        states[str(dev)] = state_to_numpy(st)
    card, cpu = states[str(cuda_device)], states["cpu"]
    assert set(card) == set(cpu) and "refill.retired" in card
    for k in cpu:
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)


@pytest.mark.cuda
def test_card_lineage_refill_matches_cpu_and_lineage_off(cuda_device):
    """The lineage plane on the card's refill path: a 12-admission sweep
    over 4 lanes with lineage on equals the CPU's in every leaf (lineage
    leaves of re-admitted lanes included), and its non-lineage leaves equal
    the lineage-off card sweep's."""
    from madsim_tpu_torch.tpu.digest import spread_mix
    from madsim_tpu_torch.tpu.raft import make_raft_spec

    spec, cfg = make_raft_spec(), spread_mix(600_000)
    states = {}
    for dev, lin in ((cuda_device, True), ("cpu", True), (cuda_device, False)):
        st = BatchedSim(spec, cfg, lineage=lin, device=dev).run_refill(
            range(12), lanes=4, max_steps=4_000)
        states[(str(dev), lin)] = state_to_numpy(st)
    card, cpu = states[(str(cuda_device), True)], states[("cpu", True)]
    off = states[(str(cuda_device), False)]
    assert set(card) == set(cpu) and "lin.eid" in card
    for k in cpu:
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
    for k in off:
        np.testing.assert_array_equal(card[k], off[k], err_msg=k)


@pytest.mark.cuda
def test_card_explorer_matches_pinned_fingerprint_and_cpu(cuda_device):
    """The pinned explorer run on the card gives PINNED_EXPLORE (the JAX
    face's fingerprint) and the CPU's corpus entry for entry."""
    import chip_smoke
    from madsim_tpu_torch.explore import Explorer
    from madsim_tpu_torch.tpu.digest import (
        EXPLORE_GENERATIONS, EXPLORE_RUN, PINNED_EXPLORE,
        PINNED_EXPLORE_CORPUS, explore_corpus_digest,
    )

    corpora = []
    for dev in (cuda_device, "cpu"):
        ex = Explorer(chip_smoke.explore_workload(), device=dev,
                      **EXPLORE_RUN)
        assert ex.run(EXPLORE_GENERATIONS).fingerprint() == PINNED_EXPLORE
        assert explore_corpus_digest(ex) == PINNED_EXPLORE_CORPUS
        corpora.append([e.to_dict() for e in ex.corpus])
    assert corpora[0] == corpora[1]


@pytest.mark.cuda
def test_card_devloop_window_equals_cpu(cuda_device):
    """One device-loop window (16 admissions over 8 lanes, 2 generations,
    meta-seed 11, seen_cap 512) on the card equals the CPU's window in
    every leaf, `loop.*` included, and in `devloop_results`."""
    import chip_smoke
    from madsim_tpu_torch.explore import Candidate, ctl_for
    from madsim_tpu_torch.tpu.engine import devloop_results, make_devloop_plan

    wl = chip_smoke.explore_workload()
    plan = make_devloop_plan(wl.config, pop=16, seen_cap=512)
    pop = [Candidate(seed=i) for i in range(16)]
    states, results = [], []
    for dev in (cuda_device, "cpu"):
        sim = BatchedSim(wl.spec, wl.config, triage=True, coverage=True,
                         devloop=plan, device=dev)
        st = sim.run_devloop(sim.init_devloop(
            range(16), lanes=8, ctl=ctl_for(pop, plan.full_h, dev), window=2,
            step_cap=wl.max_steps, meta_seed=11, next_fresh=16))
        states.append(state_to_numpy(st))
        results.append(devloop_results(st))
    card, cpu = states
    assert set(card) == set(cpu) and "loop.ring_n" in card
    for k in cpu:
        np.testing.assert_array_equal(card[k], cpu[k], err_msg=k)
    assert results[0]["gens_done"] == results[1]["gens_done"] == 2
    for f in ("seed", "origin", "bitmap", "violated"):
        for a, b in zip(results[0]["gens"], results[1]["gens"]):
            np.testing.assert_array_equal(a[f], b[f], err_msg=f)


@pytest.mark.cuda
def test_card_campaign_kill_resume_reaches_pinned_fingerprint(cuda_device,
                                                              tmp_path):
    """The pinned search as a campaign on the card, checkpointed after 1
    generation, dropped, and resumed from its directory for 1 more,
    reaches PINNED_EXPLORE."""
    import chip_smoke
    from madsim_tpu_torch.campaign import Campaign
    from madsim_tpu_torch.tpu.digest import (
        EXPLORE_GENERATIONS, EXPLORE_RUN, PINNED_EXPLORE,
    )

    wl = chip_smoke.explore_workload()
    kw = {k: EXPLORE_RUN[k] for k in ("meta_seed", "lanes", "chunk")}
    c = Campaign(wl, str(tmp_path), shrink=False, device=cuda_device, **kw)
    c.run(1)
    c.checkpoint()
    del c
    resumed = Campaign.resume(str(tmp_path), workload=wl, device=cuda_device)
    assert resumed.generation == 1
    rep = resumed.run(EXPLORE_GENERATIONS - 1)
    assert rep.fingerprint() == PINNED_EXPLORE


@pytest.mark.cuda
@pytest.mark.parametrize("max_steps", [32, 95, 8000])
def test_captured_run_equals_eager_run(cuda_device, max_steps):
    """`_run`'s captured blocks (a CUDA graph per 32 gated steps, an eager
    tail) against the eager loop on the same card, 64 lanes: every leaf
    and the dispatch count equal."""
    spec, cfg, seeds, _ = pinned_run("raft_bench")
    captured = BatchedSim(spec, cfg, device=cuda_device)
    eager = BatchedSim(spec, cfg, device=cuda_device)
    eager._eager_run = True
    got = state_to_numpy(captured.run(seeds, max_steps))
    want = state_to_numpy(eager.run(seeds, max_steps))
    assert captured._graph is not None and eager._graph is None
    assert captured.dispatch_count == eager.dispatch_count
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
def test_second_captured_run_leaves_the_first_result_unchanged(cuda_device):
    from madsim_tpu_torch.tpu.spec import tree_leaves

    spec, cfg, seeds, _ = pinned_run("raft_bench")
    sim = BatchedSim(spec, cfg, device=cuda_device)
    first = sim.run(seeds, 95)
    before = state_to_numpy(first)
    second = sim.run(seeds[::-1], 95)
    after = state_to_numpy(first)
    for k in before:
        np.testing.assert_array_equal(after[k], before[k], err_msg=k)
    held = {t.untyped_storage().data_ptr() for t in tree_leaves(first)}
    assert not held & {t.untyped_storage().data_ptr()
                       for t in tree_leaves(second)}
    eager = BatchedSim(spec, cfg, device=cuda_device)
    eager._eager_run = True
    want = state_to_numpy(eager.run(seeds[::-1], 95))
    got = state_to_numpy(second)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.cuda
def test_generated_twopc_on_the_card_matches_golden_digest(cuda_device):
    from madsim_tpu_torch.speclang.generated import twopc_device
    from madsim_tpu_torch.tpu.digest import GOLDEN, golden_run

    _, cfg, seeds, steps = golden_run("twopc")
    st = BatchedSim(twopc_device.make_spec(), cfg,
                    device=cuda_device).run(seeds, steps)
    assert canonical_digest(state_to_numpy(st)) == GOLDEN["twopc"]


@pytest.mark.cuda
def test_no_cyclic_collection_inside_a_capture(cuda_device):
    """A sim is a reference cycle, so a dropped sim and its graph are
    freed by the cyclic collector, whenever it runs; freeing a graph
    inside another sim's capture ends that capture (CUDA refuses it). The
    collector is off for exactly the 32 captured steps, and on again
    after."""
    import gc

    spec, cfg, seeds, _ = pinned_run("raft_bench")
    sim = BatchedSim(spec, cfg, device=cuda_device)
    seen = []
    inner = sim._step

    def step(state, gate_key=False, record=False):
        seen.append((torch.cuda.is_current_stream_capturing(),
                     gc.isenabled()))
        return inner(state, gate_key=gate_key, record=record)

    sim._step = step
    sim.run(seeds, 95)
    assert gc.isenabled()
    inside = [on for capturing, on in seen if capturing]
    assert len(inside) == 32 and not any(inside)
    assert all(on for capturing, on in seen if not capturing)


@pytest.mark.cuda
def test_two_threads_capture_and_replay_at_once(cuda_device):
    """Captures take a process lock, a stream of their own and the
    thread-local error mode, so two threads, each capturing its own sim's
    graph and replaying it while the other captures or steps, give the
    rows a sequential run gives (serve's slice lanes, shards on distinct
    cards)."""
    import threading

    spec, cfg, seeds, _ = pinned_run("raft_bench")
    blocks = [seeds[:32], seeds[32:]]
    want = [state_to_numpy(BatchedSim(spec, cfg, device=cuda_device)
                           .run(b, 200)) for b in blocks]
    sims = [BatchedSim(spec, cfg, device=cuda_device) for _ in blocks]
    got, errors = {}, []

    def run(i):
        try:
            got[i] = state_to_numpy(sims[i].run(blocks[i], 200))
        except BaseException as e:  # noqa: BLE001 - reraised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i,)) for i in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    for i in range(2):
        assert sims[i]._graph is not None
        for k in want[i]:
            np.testing.assert_array_equal(got[i][k], want[i][k], err_msg=k)


@pytest.mark.cuda
def test_sharded_run_on_one_card_equals_the_unsharded_run(cuda_device):
    """`run(mesh=)` over four shards of the one card (each shard's block
    captured on the sim's graph slot, one after another) is leaf-equal to
    the unsharded run, and its result lives on the sim's card."""
    from madsim_tpu_torch.tpu.mesh import Mesh

    spec, cfg, seeds, _ = pinned_run("raft_bench")
    sim = BatchedSim(spec, cfg, device=cuda_device)
    want = state_to_numpy(sim.run(seeds, 200))
    out = sim.run(seeds, 200, mesh=Mesh((cuda_device,) * 4))
    assert out.clock.device == sim.device
    got = state_to_numpy(out)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
