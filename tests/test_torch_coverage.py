"""The coverage plane on the port against the JAX engine.

The same seeds go through both faces on the CPU with
`BatchedSim(coverage=True)`:
  * Raft under CHAOS_PLAN, 16 lanes x 300 steps: the final state is
    leaf-equal to the JAX engine's, `cov.*` included, and `summarize`'s
    coverage keys are equal;
  * the twopc quiet config with a 5% heavy tail (the straggler pool on):
    leaf-equal, and `cov.hiwater` is the running maximum of main-pool plus
    straggler-pool occupancy, above what the main pool alone reaches;
  * coverage on/off: every non-`cov` leaf is equal, and the Raft golden run
    with coverage on still has the JAX package's GOLDEN digest;
  * the primitives: the constants, the payload bucket at its edge values,
    `fold(key, -1)` of int32 and int64 words, the lane OR-reduction and the
    copy of `explore.popcount_rows`.

Tolerances: exact, except the float lane means of `summarize` (rtol 1e-6,
summed in another order on each face).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu import explore as jexplore
from madsim_tpu import nemesis as jn
from madsim_tpu.tpu import BatchedSim as JaxSim
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import engine as jengine
from madsim_tpu.tpu import make_raft_spec as jax_raft_spec
from madsim_tpu.tpu import make_twopc_spec as jax_twopc_spec
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu import prng as jprng
from madsim_tpu.tpu import summarize as jax_summarize
from madsim_tpu_torch.tpu import (
    BatchedSim, SimConfig, make_raft_spec, make_twopc_spec, summarize,
)
from madsim_tpu_torch.tpu import batch as tbatch
from madsim_tpu_torch.tpu import engine as tengine
from madsim_tpu_torch.tpu import prng
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import (
    CHAOS_PLAN, GOLDEN, canonical_digest, golden_run,
)
from madsim_tpu_torch.tpu.nemesis import compile_plan
from test_buggify import quiet_config as jax_quiet_config
from test_torch_engine import assert_leaves_equal, assert_summaries_equal
from test_torch_nemesis import PLANS
from test_torch_triage import jax_leaves

CHAOS_STEPS = 300


@pytest.fixture(scope="module")
def chaos():
    """Raft under CHAOS_PLAN with coverage on, both faces, and the port's
    coverage-off run of the same seeds."""
    jcfg = jtn.compile_plan(PLANS["chaos"](jn),
                            JaxConfig(horizon_us=30_000_000))
    cfg = compile_plan(CHAOS_PLAN, SimConfig(horizon_us=30_000_000))
    assert cfg.to_toml() == jcfg.to_toml()
    jst = JaxSim(jax_raft_spec(5), jcfg, coverage=True).run(
        jnp.arange(16, dtype=jnp.uint32), max_steps=CHAOS_STEPS,
        dispatch_steps=CHAOS_STEPS)
    kw = dict(max_steps=CHAOS_STEPS, dispatch_steps=CHAOS_STEPS)
    pst = BatchedSim(make_raft_spec(5), cfg, coverage=True,
                     device="cpu").run(range(16), **kw)
    off = BatchedSim(make_raft_spec(5), cfg, device="cpu").run(range(16), **kw)
    return jst, pst, off


def test_constants_equal_the_jax_engine():
    for name in ("COV_WORDS", "COV_BITS", "COV_SALT", "COV_FIELDS"):
        assert getattr(tengine, name) == getattr(jengine, name), name
    assert tengine.Coverage._fields == jengine.Coverage._fields


def test_raft_chaos_coverage_leaf_equal(chaos):
    jst, pst, _ = chaos
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert {"cov.bitmap", "cov.hiwater", "cov.transitions"} <= set(got)
    assert_leaves_equal(want, got, "coverage")
    # the plane did real work: many classes, non-trivial scalars
    assert (got["cov.bitmap"] != 0).sum(axis=1).min() > 10
    assert got["cov.hiwater"].min() > 0
    assert got["cov.transitions"].min() > 0
    assert got["cov.bitmap"].max() < 2**32


def test_summarize_coverage_keys_equal(chaos):
    jst, pst, _ = chaos
    js, ps = jax_summarize(jst), summarize(pst)
    assert {"coverage_bits", "coverage_hiwater",
            "coverage_transitions"} <= set(ps)
    assert_summaries_equal(js, ps)
    assert ps["coverage_bits"] > 100


def test_coverage_off_leaves_every_other_leaf_equal(chaos):
    _, pst, off = chaos
    on = state_to_numpy(pst)
    cov = {k for k in on if k.startswith("cov.")}
    assert len(cov) == 3
    assert_leaves_equal({k: v for k, v in on.items() if k not in cov},
                        state_to_numpy(off), "coverage on/off")


def test_golden_digest_raft_with_coverage():
    """The Raft golden run with coverage on: its canonical digest (which
    hashes no cov leaf) is still the JAX package's GOLDEN value."""
    spec, cfg, seeds, steps = golden_run("raft")
    st = BatchedSim(spec, cfg, coverage=True, device="cpu").run(
        seeds, max_steps=steps, dispatch_steps=steps)
    leaves = state_to_numpy(st)
    assert canonical_digest(leaves) == GOLDEN["raft"]
    assert leaves["cov.transitions"].min() > 0


def test_twopc_tail_hiwater_counts_the_straggler_pool():
    """The twopc quiet config with a 5% heavy tail: leaf-equal to the JAX
    engine with coverage on, and the high water is the running maximum of
    main-pool plus straggler-pool occupancy, which the main pool alone
    does not reach on some lane."""
    jcfg = jax_quiet_config(buggify_delay_rate=0.05, horizon_us=3_000_000)
    cfg = SimConfig(**dataclasses.asdict(jcfg))
    steps = 250
    jst = JaxSim(jax_twopc_spec(5), jcfg, coverage=True).run(
        jnp.arange(16, dtype=jnp.uint32), max_steps=steps,
        dispatch_steps=steps)
    sim = BatchedSim(make_twopc_spec(5), cfg, coverage=True, device="cpu")
    st = sim.init(range(16))
    both = main = torch.zeros(16, dtype=torch.int64)
    for _ in range(steps):
        st = sim.step(st)
        m = st.msgs.valid.any(dim=1).sum(dim=1)
        main = torch.maximum(main, m)
        both = torch.maximum(both, m + st.strag.valid.sum(dim=1))
    got = state_to_numpy(st)
    assert_leaves_equal(jax_leaves(jst), got, "twopc tail")
    np.testing.assert_array_equal(got["cov.hiwater"], both.numpy())
    assert (both > main).any()


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_fold_of_minus_one_equals_jax(dtype):
    """A -1 word folds as 0xFFFFFFFF (phase 7b folds src = kind = -1 for
    timer events), held in int32 (the step's words) or int64."""
    keys = np.array([0, 1, 0x5EEDC0DE, 2**31, 2**32 - 1], np.uint32)
    want = np.asarray(jprng.fold(jnp.asarray(keys), jnp.int32(-1)))
    got = prng.fold(torch.as_tensor(keys.astype(np.int64)),
                    torch.tensor(-1, dtype=dtype))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    # as a mix input only the int32 word reads as 0xFFFFFFFF (prng.u32's
    # precondition)
    assert int(prng.mix(torch.tensor(-1, dtype=torch.int32))) == int(
        jprng.mix(jnp.uint32(2**32 - 1)))


def test_payload_bucket_equals_clz():
    """bit_length of payload[0] read as u32 == the JAX face's 32 - clz."""
    rng = np.random.default_rng(7)
    edges = np.array([0, 1, 2, 3, 2**15, 2**16 - 1, 2**31 - 1, 2**31,
                      2**32 - 1], np.uint32)
    x = np.concatenate([edges, rng.integers(0, 2**32, 4096,
                                            dtype=np.uint64).astype(np.uint32)])
    want = np.asarray(32 - jax.lax.clz(jnp.asarray(x)).astype(jnp.int32))
    got = tengine.bit_length32(torch.as_tensor(x.astype(np.int64)))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:len(edges)].tolist() == [0, 1, 2, 2, 16, 16, 31, 32, 32]
    # the int32 payload words of the step, read as u32
    i32 = x.view(np.int32)
    got32 = tengine.bit_length32(prng.u32(torch.as_tensor(i32)))
    np.testing.assert_array_equal(got32.numpy(), want)


@pytest.mark.parametrize("lanes", [1, 2, 7, 64])
def test_lane_or_reduction_equals_numpy(lanes):
    rng = np.random.default_rng(lanes)
    x = rng.integers(0, 2**32, (lanes, tengine.COV_WORDS), dtype=np.uint64)
    got = tengine._or_rows(torch.as_tensor(x.astype(np.int64)))
    np.testing.assert_array_equal(
        got.numpy(), np.bitwise_or.reduce(x, axis=0).astype(np.int64))


def test_popcount_rows_copy_equals_the_original():
    rng = np.random.default_rng(3)
    x = rng.integers(0, 2**32, (5, tengine.COV_WORDS),
                     dtype=np.uint64).astype(np.uint32)
    x[0] = 0
    x[1] = 2**32 - 1
    np.testing.assert_array_equal(tbatch.popcount_rows(x),
                                  jexplore.popcount_rows(x))
    assert tbatch.popcount_rows(x)[1] == tengine.COV_BITS
