"""run_batch on the port against run_batch on the JAX package.

Per-seed rows (violated, deadlocked, violation step, steps) and the batch
summary must be equal for the same seeds and workload, with `chunk`
smaller than the seed count, and the port's `check_determinism` rerun
must find both runs leaf-equal.
"""

import dataclasses

import numpy as np
import pytest

from madsim_tpu.tpu import run_batch as jax_run_batch
from madsim_tpu.tpu.raft import raft_workload as jax_raft_workload
from madsim_tpu_torch.tpu import run_batch, raft_workload
from madsim_tpu_torch.tpu.batch import BatchDeterminismError, BatchedSim

SEEDS = list(range(12))
# summary keys that time the host or name its devices, not the simulation
HOST_KEYS = {"device_ms", "dispatches", "n_devices", "occupancy"}


def _faces(planted: bool):
    jwl = jax_raft_workload(virtual_secs=1.0)
    twl = raft_workload(virtual_secs=1.0)
    jwl = dataclasses.replace(jwl, host_repro=None, max_steps=400)
    twl = dataclasses.replace(twl, max_steps=400)
    if planted:
        # a planted "bug": the invariant fails once a lane's clock passes
        # 0.3-0.6 s (seed-dependent through the run), so lanes violate at
        # different steps and the violation rows carry real values
        def jcheck(ns, alive, now):
            return now < 300_000 + 100_000 * (ns.term.sum() % 4)

        def tcheck(ns, alive, now):
            return now < 300_000 + 100_000 * (ns.term.sum(dim=1) % 4)

        jwl = dataclasses.replace(
            jwl, spec=dataclasses.replace(jwl.spec, check_invariants=jcheck)
        )
        twl = dataclasses.replace(
            twl, spec=dataclasses.replace(twl.spec, check_invariants=tcheck)
        )
    return jwl, twl


@pytest.mark.parametrize("planted", [False, True], ids=["clean", "planted"])
def test_run_batch_per_seed_rows_equal_jax(planted):
    jwl, twl = _faces(planted)
    jr = jax_run_batch(SEEDS, jwl, repro_on_host=False, chunk=5, mesh=None,
                       max_traces=0)
    tr = run_batch(SEEDS, twl, chunk=5, check_determinism=True, device="cpu")
    np.testing.assert_array_equal(tr.seeds, jr.seeds)
    np.testing.assert_array_equal(tr.violated, jr.violated)
    np.testing.assert_array_equal(tr.deadlocked, jr.deadlocked)
    np.testing.assert_array_equal(tr.violation_step, jr.violation_step)
    np.testing.assert_array_equal(tr.retired_step, jr.retired_step)
    assert tr.violating_seeds == jr.violating_seeds
    assert (tr.violations > 0) == planted
    js = {k: v for k, v in jr.summary.items() if k not in HOST_KEYS}
    ts = {k: v for k, v in tr.summary.items() if k not in HOST_KEYS}
    assert set(js) == set(ts), set(js) ^ set(ts)
    for k in js:
        if isinstance(js[k], float):
            np.testing.assert_allclose(ts[k], js[k], rtol=1e-6, err_msg=k)
        else:
            assert ts[k] == js[k], k
    assert tr.occupancy == pytest.approx(jr.occupancy, rel=1e-12)


def test_run_batch_rows_independent_of_chunk():
    _, twl = _faces(True)
    sim = BatchedSim(twl.spec, twl.config, device="cpu")
    a = run_batch(SEEDS[:6], twl, chunk=6, sim=sim)
    b = run_batch(SEEDS[:6], twl, chunk=4, sim=sim)
    for f in ("violated", "deadlocked", "violation_step", "retired_step"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


def test_check_determinism_catches_an_impure_spec():
    _, twl = _faces(False)
    calls = []
    init = twl.spec.init

    def impure_init(key, nid):
        calls.append(1)
        state, timer = init(key, nid)
        return state, timer + len(calls)

    spec = dataclasses.replace(twl.spec, init=impure_init)
    twl = dataclasses.replace(twl, spec=spec, max_steps=20)
    with pytest.raises(BatchDeterminismError, match="differs"):
        run_batch(SEEDS[:2], twl, check_determinism=True, device="cpu")


def test_run_batch_refuses_out_of_slice_options():
    """Tuning applies Tier-A dispatch knobs only (a Tier-B config knob is
    refused at dispatch, as on the JAX face; tuning itself was once
    refused, item 12); a mesh naming cards this host lacks is refused
    when it is built, never run elsewhere (multi-device sharding itself,
    once refused as item 14, is tests/test_torch_multichip.py's); refill
    (once refused, item 11) refuses only a lane_check
    workload, as on the JAX face; a pre-built sim must match the workload
    and the coverage."""
    _, twl = _faces(False)
    with pytest.raises(ValueError, match="not Tier-A"):
        run_batch(SEEDS, twl, tuning={"msg_capacity": 8}, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_batch(SEEDS, twl, mesh=("cuda:0", "cuda:1"), device="cpu")
    checked = dataclasses.replace(
        twl, lane_check=lambda st, lanes: {"violations": 0})
    with pytest.raises(ValueError, match="lane_check"):
        run_batch(SEEDS, checked, refill=4, device="cpu")
    with pytest.raises(ValueError, match="coverage"):
        run_batch(SEEDS, twl, coverage=True,
                  sim=BatchedSim(twl.spec, twl.config, device="cpu"))
    other = BatchedSim(twl.spec, dataclasses.replace(twl.config, loss_rate=0.2),
                       device="cpu")
    with pytest.raises(ValueError, match="different"):
        run_batch(SEEDS, twl, sim=other)
