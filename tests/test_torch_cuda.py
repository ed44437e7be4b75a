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
