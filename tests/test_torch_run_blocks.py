"""`BatchedSim._run`'s block structure, on the eager path (the CPU).

`_run` steps in blocks of DONE_CHECK_STEPS gated steps with one host read
of the all-done flag after each block, and a shorter tail block where
`max_steps` is not a multiple of it. On a CUDA card each full block is one
replay of a captured graph (tests/test_torch_cuda.py holds it equal to
the eager loop there); here the same blocks run eagerly. Held: the result
equals a plain loop of gated steps to the first all-done step, the number
of steps taken is the block structure's, and a second run on the same sim
leaves the first result unchanged and shares no storage with it. Exact,
leaf for leaf.
"""

import numpy as np
import pytest

from madsim_tpu_torch.tpu import BatchedSim
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import pinned_run
from madsim_tpu_torch.tpu.engine import DONE_CHECK_STEPS
from madsim_tpu_torch.tpu.spec import tree_leaves

LANES = 16


def _sim():
    spec, cfg, seeds, _ = pinned_run("raft_entry")
    return BatchedSim(spec, cfg, device="cpu"), seeds[:LANES]


@pytest.mark.parametrize("max_steps", [32, 95, 8000])
def test_blocks_and_tail_equal_a_plain_gated_loop(max_steps):
    sim, seeds = _sim()
    calls = []
    inner = sim._step

    def counted(state, gate_key=False, record=False):
        calls.append(gate_key)
        return inner(state, gate_key=gate_key, record=record)

    sim._step = counted
    got = state_to_numpy(sim.run(seeds, max_steps))
    ref, _ = _sim()
    st, n = ref.init(seeds), 0
    while n < max_steps and not bool(st.done.all()):
        st, n = ref._step(st, gate_key=True), n + 1
    want = state_to_numpy(st)
    assert set(got) == set(want)
    assert not [k for k in want if not np.array_equal(got[k], want[k])]
    # full blocks with a done check after each, then the tail block
    assert all(calls)
    assert len(calls) == min(-(-n // DONE_CHECK_STEPS) * DONE_CHECK_STEPS,
                             max_steps)
    if max_steps == 8000:
        assert got["done"].all() and n < max_steps


def test_second_run_leaves_the_first_result_unchanged():
    sim, seeds = _sim()
    first = sim.run(seeds, 95)
    before = state_to_numpy(first)
    second = sim.run(seeds[::-1], 95)
    after = state_to_numpy(first)
    assert not [k for k in before if not np.array_equal(before[k], after[k])]
    held = {t.untyped_storage().data_ptr() for t in tree_leaves(first)}
    assert not held & {t.untyped_storage().data_ptr()
                       for t in tree_leaves(second)}
