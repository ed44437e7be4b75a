"""The port's device-resident search loop against the JAX package:
`make_devloop_plan`, `DevLoop`, `init_devloop`/`run_devloop`/
`devloop_results`, the generation boundary (`_devloop_boundary` with
`devloop_fold` and `devloop_population`), the device genome faces
(`tpu/nemesis.py:genome_hash64`, `genome_ctl_rows`) and
`Explorer(device_loop=True)` with the CLI's `--device-loop`.

The same inputs go through both faces on the CPU, at the JAX test's sizes
(tests/test_devloop.py: 16 admissions, 8 refill lanes, seen_cap 512,
meta-seed 11):
  * the plan and the genome faces equal the JAX face's;
  * one window from a cold start (an empty ring under a saturated union,
    so the boundary builds an all-fresh generation) and from a warm start
    (an uploaded ring, and a seen table whose planted rows make the first
    mutant a duplicate, so it takes the draw-free fresh fallback) equals
    the JAX face's window in every leaf, `loop.*` included, and in
    `devloop_results`; the port starts from the JAX face's initial state
    through `convert.state_from_numpy`;
  * the vectorised fold and population equal a sequential transcription
    of the JAX face's `fold_body`/`mut_body` written here, on inputs with
    novelty ties, ring overflow past K, duplicate mutants and planted
    rows at the edge of the seen prefix; the duplicate ranks equal their
    recurrence, 64-bit fallback collisions included;
  * the port's explorer on the device loop gives its host loop's
    fingerprint, corpus and curves for windows 2+1 and 3 over 3
    generations, with one `devloop_results` per window and fewer
    dispatches, reaches `PINNED_EXPLORE` and `PINNED_EXPLORE_CORPUS` over
    2, and the CLI's `--device-loop` prints the host fingerprint;
  * the JAX face's ValueErrors, message for message.

Tolerances: exact everywhere (integers, float32 values, bitmaps).
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

import chip_smoke
from madsim_tpu import explore as jex
from madsim_tpu.tpu import engine as je
from madsim_tpu.tpu import nemesis as jtn
from madsim_tpu.tpu.engine import named_leaves
from madsim_tpu_torch import explore, telemetry
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch.tpu import engine as te
from madsim_tpu_torch.tpu import nemesis as ttn
from madsim_tpu_torch.tpu.convert import state_from_numpy, state_to_numpy
from madsim_tpu_torch.tpu.digest import (
    EXPLORE_RUN, PINNED_EXPLORE, PINNED_EXPLORE_CORPUS, explore_corpus_digest,
)
from madsim_tpu_torch.tpu.raft import raft_bench_config
from madsim_tpu_torch.tpu.spec import SimConfig
from test_explore import _planted_workload
from test_torch_engine import assert_leaves_equal, shared_across_workers
from test_torch_explore import _jax_plan

LANES = 16
REFILL_LANES = 8
SEEN_CAP = 512
META_SEED = 11
GENS = 3
# the window tests' horizon: the planted workload cut to 0.5 virtual s (the
# boundary, not the horizon, is under test)
WINDOW_H_US = 500_000


def _port_sim(wl, **plan_kw):
    plan = te.make_devloop_plan(wl.config, pop=LANES, top_k=16,
                                seen_cap=SEEN_CAP, **plan_kw)
    return te.BatchedSim(wl.spec, wl.config, triage=True, coverage=True,
                         devloop=plan, device="cpu")


def _jax_leaves(state):
    return {k: np.asarray(v).astype(
                np.float64 if np.asarray(v).dtype.kind == "f" else np.int64)
            for k, v in named_leaves(state)}


def _assert_same(a, b, path="res"):
    """Nested dicts/lists of arrays and scalars equal, dtypes included."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and np.array_equal(a, b), path
    else:
        assert a == b, (path, a, b)


# ------------------------------------------------------------- the plan


def _plan_configs():
    storm = chip_smoke.storm_plan()
    return {
        "planted": (chip_smoke.explore_workload().config,
                    _planted_workload().config),
        "storm": (ttn.compile_plan(storm, raft_bench_config(10.0)),
                  jtn.compile_plan(_jax_plan(storm),
                                   je.SimConfig(**dataclasses.asdict(
                                       raft_bench_config(10.0))))),
        "no_toggle": (SimConfig(horizon_us=1_000_000),
                      je.SimConfig(horizon_us=1_000_000)),
    }


@pytest.mark.parametrize("name", ["planted", "storm", "no_toggle"])
def test_make_devloop_plan_equals_the_jax_face(name):
    cfg, jcfg = _plan_configs()[name]
    assert cfg.to_toml() == jcfg.to_toml()
    for kw in (dict(pop=16), dict(pop=4096, top_k=32, seen_cap=1 << 14),
               dict(pop=37, fresh_frac=0.25, mutant_frac=0.5,
                    swarm_group=5, fresh_stride=3)):
        got = te.make_devloop_plan(cfg, **kw)
        want = je.make_devloop_plan(jcfg, **kw)
        assert got._fields == want._fields
        assert tuple(got) == tuple(want), kw
    if name == "no_toggle":
        assert got.n_swarm == 0 and got.ops == ("horizon",)
    for face, c in ((te, cfg), (je, jcfg)):
        with pytest.raises(ValueError,
                           match="seen_cap must be a power of two, got 96"):
            face.make_devloop_plan(c, pop=16, seen_cap=96)


# ----------------------------------------------------- the genome faces


def _genomes(rng, shape):
    n_occ, n_rate = len(tn.OCC_CLAUSES), len(tn.RATE_CLAUSES)
    return (
        rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32),
        rng.integers(-2**31, 2**31, shape).astype(np.int32),
        rng.integers(-2**31, 2**31, shape + (n_occ,)).astype(np.int32),
        rng.choice(np.float32([0.25, 0.5, 1.0, 0.1, -0.0, 3e-5]),
                   shape + (n_rate,)).astype(np.float32),
        rng.integers(0, 2**31, shape).astype(np.int32),
    )


def _t(a):
    a = np.asarray(a)
    return torch.as_tensor(a.astype(np.int64) if a.dtype == np.uint32 else a)


def test_genome_faces_equal_the_jax_and_host_faces():
    rng = np.random.default_rng(3)
    g = _genomes(rng, (4096,))
    got = ttn.genome_hash64(*(_t(x) for x in g))
    want = jtn.genome_hash64(*g)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b).astype(np.int64))
    for i in range(0, 4096, 64):  # the host face, on every 64th genome
        key = (int(g[0][i]), int(g[1][i]), tuple(int(v) for v in g[2][i]),
               tuple(float(v) for v in g[3][i]), int(g[4][i]))
        assert explore.genome_hash64(key) == (int(got[0][i]),
                                              int(got[1][i]))
    # broadcasting over leading axes: scalar seed/off/h, [3, 5] genome rows
    b = _genomes(rng, (3, 5))
    args = (np.uint32(7), np.int32(-3), b[2], b[3], np.int32(0))
    got = ttn.genome_hash64(*(_t(x) for x in args))
    want = jtn.genome_hash64(*args)
    for a, w in zip(got, want):
        assert a.shape == (3, 5)
        assert np.array_equal(a.numpy(), np.asarray(w).astype(np.int64))
    h = np.concatenate([[0, 1, 2_500_000, 2_000_000_000],
                        rng.integers(0, 2**31, 64)]).astype(np.int32)
    for full in (2_500_000, 900_000_000):
        got = ttn.genome_ctl_rows(torch.as_tensor(h), full)
        want = jtn.genome_ctl_rows(h, full)
        for a, w in zip(got, want):
            assert a.dtype == torch.int32
            assert np.array_equal(a.numpy(), np.asarray(w))


# ------------------------------------------------------ one whole window


def _window_faces():
    pwl = chip_smoke.explore_workload()
    pwl = dataclasses.replace(pwl, config=dataclasses.replace(
        pwl.config, horizon_us=WINDOW_H_US))
    jwl = _planted_workload()
    jwl = dataclasses.replace(jwl, config=dataclasses.replace(
        jwl.config, horizon_us=WINDOW_H_US))
    assert pwl.config.to_toml() == jwl.config.to_toml()
    return pwl, jwl


def _horizon_counter(plan, meta_seed):
    """The first meta cursor whose mutant draws the horizon op with an even
    parameter draw: that mutant restores horizon 0, so on a parent of
    horizon 0 it IS its parent, whose claimed hash makes it a duplicate."""
    key = tn.key_from_seed(meta_seed)
    for c in range(10_000):
        op = plan.ops[tn.bits32(key, tn.META_SITE_DRAW, c + 1)
                      % len(plan.ops)]
        if op == "horizon" and tn.bits32(key, tn.META_SITE_DRAW,
                                         c + 2) % 2 == 0:
            return c
    raise AssertionError("no horizon draw in 10000 cursors")


def _window_inputs(kind, plan):
    """init_devloop's arguments (both faces) of the cold or warm window."""
    full_h = plan.full_h
    pop = [explore.Candidate(seed=100 + i) for i in range(LANES)]
    kw = dict(lanes=REFILL_LANES, window=2, step_cap=20_000,
              meta_seed=META_SEED, next_fresh=100 + LANES,
              gen_h_raw=[0] * LANES, gen_origin=[0] * LANES)
    if kind == "cold":
        kw.update(meta_counter=0,
                  union=np.full(te.COV_WORDS, 0xFFFFFFFF, np.uint32))
        return pop, kw
    rng = np.random.default_rng(5)
    n_occ, n_rate = len(tn.OCC_CLAUSES), len(tn.RATE_CLAUSES)
    rows = []
    for i, bits in enumerate((90, 90, 40, 40, 40, 7)):
        occ = [0] * n_occ
        occ[tn.OCC_ROW["crash"]] = int(rng.integers(0, 8))
        rows.append(explore.Candidate(
            seed=int(rng.integers(0, 100)), off=int(i % 2) *
            tn.TRIAGE_BIT["partition"], occ_off=tuple(occ),
            rate_scale=(1.0,) * n_rate, horizon_us=0, origin="mutant"))
    ring = {
        "n": len(rows), "bits": [90, 90, 40, 40, 40, 7],
        "seed": [c.seed for c in rows], "off": [c.off for c in rows],
        "occ": [list(c.occ_off) for c in rows],
        "rate": [list(c.rate_scale) for c in rows],
        "h": [c.horizon_us for c in rows],
    }
    # the host's seen set: the ring's genomes, generation 0's, and some
    # unrelated rows, one of them twice (a planted duplicate row)
    hs = [explore.genome_hash64(c.key()) for c in rows + pop]
    hs += [(int(a), int(b)) for a, b in rng.integers(0, 2**32, (40, 2))]
    hs.append(hs[-1])
    union = np.zeros(te.COV_WORDS, np.uint32)
    union[::3] = rng.integers(0, 2**32, len(union[::3])).astype(np.uint32)
    kw.update(
        meta_counter=_horizon_counter(plan, META_SEED), ring=ring,
        union=union, seen={"n": len(hs), "h1": [a for a, _ in hs],
                           "h2": [b for _, b in hs]},
    )
    return pop, kw


def _run_window_faces(kind):
    pwl, jwl = _window_faces()
    psim = _port_sim(pwl)
    jplan = je.make_devloop_plan(jwl.config, pop=LANES, top_k=16,
                                 seen_cap=SEEN_CAP)
    assert tuple(jplan) == tuple(psim.devloop)
    jsim = je.BatchedSim(jwl.spec, jwl.config, triage=True, coverage=True,
                         devloop=jplan)
    pop, kw = _window_inputs(kind, psim.devloop)
    seeds = np.asarray([c.seed for c in pop], np.uint32)
    jpop = [jex.Candidate(**dataclasses.asdict(c)) for c in pop]
    jst0 = jsim.init_devloop(
        seeds, ctl=jex.Explorer(jwl, sim=jsim, lanes=LANES,
                                seen_cap=SEEN_CAP)._ctl_for(jpop), **kw)
    pst0 = psim.init_devloop(
        seeds, ctl=explore.ctl_for(pop, pwl.config.horizon_us), **kw)
    jleaves0 = {k: np.asarray(v) for k, v in named_leaves(jst0)}
    jst = jsim.run_devloop(jst0)
    pst = psim.run_devloop(state_from_numpy(jleaves0, device="cpu"))
    return dict(
        jinit=_jax_leaves(jst0), pinit=state_to_numpy(pst0),
        jfinal=_jax_leaves(jst), pfinal=state_to_numpy(pst),
        jres=je.devloop_results(jst), pres=te.devloop_results(pst),
        nF=psim.devloop.n_fresh,
    )


@pytest.fixture(scope="module")
def windows(tmp_path_factory):
    return lambda kind: shared_across_workers(
        tmp_path_factory, f"devloop-window-{kind}",
        lambda: _run_window_faces(kind))


@pytest.mark.parametrize("kind", ["cold", "warm"])
def test_window_equals_the_jax_face(kind, windows):
    """One init_devloop + run_devloop window of 2 generations: the port's
    init state equals the JAX face's, and the port run from the JAX face's
    initial state (carried across by convert) ends equal in every leaf,
    `loop.*` included, with equal `devloop_results`."""
    w = windows(kind)
    assert_leaves_equal(w["jinit"], w["pinit"], f"{kind} init")
    assert any(k.startswith("loop.") for k in w["jfinal"])
    assert_leaves_equal(w["jfinal"], w["pfinal"], f"{kind} window")
    _assert_same(w["jres"], w["pres"])
    res = w["pres"]
    assert res["gens_done"] == 2 and res["seen_n"] == w["pinit"][
        "loop.seen_n"] + LANES
    origins = res["gens"][1]["origin"]
    if kind == "cold":
        # nothing is novel under the saturated union: the ring stays empty
        # and generation 1 is all fresh (the no-parents branch)
        assert res["ring"]["n"] == 0 and res["accepts"] == 0
        assert not origins.any()
        assert list(res["gens"][1]["seed"]) == list(range(116, 132))
    else:
        # generation 1 mixes all three origins, and its first mutant slot
        # took the draw-free fallback: the next fresh seed, no draws
        # the ring grows by the accepted admissions, up to K
        assert res["accepts"] > 0
        assert res["ring"]["n"] == min(6 + res["accepts"], 16)
        assert set(origins[w["nF"]:]) >= {1, 2}
        assert origins[w["nF"]] == 0
        assert res["gens"][1]["seed"][w["nF"]] == 116 + w["nF"]


# --------------------------- the boundary against a sequential transcription


M32 = 0xFFFFFFFF


def _seq_fold(union, ring, ring_n, bitmaps, rows, K):
    """The JAX face's fold_body, one admission at a time (numpy)."""
    union = union.copy()
    ring = [r.copy() for r in ring]
    rn, acc = ring_n, 0
    for i in range(bitmaps.shape[0]):
        bm = bitmaps[i]
        nb = sum(bin(int(w)).count("1") for w in bm & ~union)
        accept = nb > 0
        if accept:
            union = union | bm
        pos = int((ring[0] >= nb).sum())
        if accept and pos < K:
            vals = [nb] + [r[i] for r in rows[1:]]
            for r, v in zip(ring, vals):
                r[pos + 1:] = r[pos:-1].copy()
                r[pos] = v
            rn = min(rn + 1, K)
        acc += accept
    return union, ring, rn, acc


def _seq_population(plan, meta_key, counter, next_fresh, ring, ring_n,
                    sh1, sh2, sn):
    """The JAX face's build_mixed (mut_body and the swarm groups) or
    build_fresh, one candidate at a time (numpy and host hashes)."""
    A, K, S = plan.pop, plan.top_k, plan.seen_cap
    nF, nM, nS = plan.n_fresh, plan.n_mut, plan.n_swarm
    st = plan.fresh_stride
    n_occ, n_rate = len(tn.OCC_CLAUSES), len(tn.RATE_CLAUSES)
    sh1, sh2 = sh1.copy(), sh2.copy()

    def h64(seed, off, occ, rate, h):
        return explore.genome_hash64((int(seed), int(off),
                                      tuple(int(v) for v in occ),
                                      tuple(float(v) for v in rate), int(h)))

    def append(h, sn):
        if sn < S:
            sh1[sn], sh2[sn] = h
        return min(sn + 1, S)

    seeds = np.zeros(A, np.int64)
    offs = np.zeros(A, np.int32)
    occs = np.zeros((A, n_occ), np.int32)
    rates = np.ones((A, n_rate), np.float32)
    hs = np.zeros(A, np.int32)
    origins = np.zeros(A, np.int32)
    c, nf = counter, next_fresh
    if ring_n == 0:
        for i in range(A):
            seeds[i] = nf
            nf = (nf + st) & M32
            sn = append(h64(seeds[i], 0, occs[i], rates[i], 0), sn)
        return seeds, offs, occs, rates, hs, origins, c, nf, sh1, sh2, sn
    for i in range(nF):
        seeds[i] = nf
        nf = (nf + st) & M32
    menu = {"occ": 0, "clause": 1, "rate": 2, "horizon": 3}
    sched = plan.sched_rows or (0,)
    tog = plan.tog_bits or (0,)
    rrows = plan.rate_rows or (0,)
    for i in range(nM):
        d = [tn.bits32(meta_key, tn.META_SITE_DRAW, c + j) for j in range(4)]
        p = min(max(d[0] % max(ring_n, 1), 0), K - 1)
        p_seed, p_off, p_occ, p_rate, p_h = (r[p] for r in ring[1:])
        op = menu[plan.ops[d[1] % len(plan.ops)]]
        occ, off, rate, h = p_occ.copy(), p_off, p_rate.copy(), p_h
        if op == 0:
            occ[sched[d[2] % len(sched)]] ^= 1 << (d[3] % 10)
        elif op == 1:
            off = p_off ^ tog[d[2] % len(tog)]
        elif op == 2:
            rate[rrows[d[2] % len(rrows)]] = (0.25, 0.5, 1.0)[d[3] % 3]
        else:
            h_eff = plan.full_h if p_h == 0 else p_h
            h = 0 if d[2] % 2 == 0 else max(h_eff // 2, plan.full_h // 8)
        c += (4, 3, 4, 3)[op]
        hm = h64(p_seed, off, occ, rate, h)
        dup = bool(((np.arange(S) < sn) & (sh1 == hm[0])
                    & (sh2 == hm[1])).any())
        at = nF + i
        if dup:
            seeds[at] = nf
            sn = append(h64(nf, 0, np.zeros(n_occ), np.ones(n_rate), 0), sn)
            nf = (nf + st) & M32
        else:
            seeds[at], offs[at], occs[at], rates[at], hs[at] = (
                p_seed, off, occ, rate, h)
            origins[at] = 1
            sn = append(hm, sn)
    base = nF + nM
    for start in range(0, nS, plan.swarm_group):
        gsz = min(plan.swarm_group, nS - start)
        off = 0
        for b in plan.tog_bits:
            if (tn.bits32(meta_key, tn.META_SITE_DRAW, c) % tn.COIN_DENOM
                    < tn.COIN_DENOM // 2):
                off |= b
            c += 1
        for j in range(gsz):
            seeds[base + start + j] = nf
            offs[base + start + j] = off
            origins[base + start + j] = 2
            nf = (nf + st) & M32
    for i in list(range(nF)) + list(range(base, A)):
        sn = append(h64(seeds[i], offs[i], occs[i], rates[i], hs[i]), sn)
    return seeds, offs, occs, rates, hs, origins, c, nf, sh1, sh2, sn


def _boundary_inputs(seed, plan, ring_n):
    """Seeded inputs of one boundary: a sorted ring of `ring_n` valid rows
    (default rows after it) with novelty ties, admissions whose bitmaps
    draw from a small pool of bits (ties again), and a seen table holding
    the ring's genomes with one planted at the last row of its prefix and
    one just past it."""
    rng = np.random.default_rng(seed)
    A, K, S = plan.pop, plan.top_k, plan.seen_cap
    n_occ, n_rate = len(tn.OCC_CLAUSES), len(tn.RATE_CLAUSES)
    W = te.COV_WORDS
    bits = np.zeros(K, np.int32)
    bits[:ring_n] = np.sort(rng.choice([1, 2, 2, 5, 5, 5, 9], ring_n))[::-1]
    valid = np.arange(K) < ring_n
    ring = [
        bits,
        np.where(valid, rng.integers(0, 2**32, K), 0).astype(np.int64),
        np.where(valid, rng.choice(list(plan.tog_bits) or [0], K) *
                 rng.integers(0, 2, K), 0).astype(np.int32),
        np.where(valid[:, None], rng.integers(0, 4, (K, n_occ)),
                 0).astype(np.int32),
        np.where(valid[:, None], rng.choice([0.25, 0.5, 1.0], (K, n_rate)),
                 1.0).astype(np.float32),
        np.where(valid, rng.choice([0, 0, 300_000], K), 0).astype(np.int32),
    ]
    pool = rng.choice(W * 32, 24, replace=False)
    bitmaps = np.zeros((A, W), np.int64)
    for i in range(A):
        for b in rng.choice(pool, rng.integers(0, 4)):
            bitmaps[i, b // 32] |= 1 << (b % 32)
    union = np.zeros(W, np.int64)
    for b in rng.choice(pool, 6):
        union[b // 32] |= 1 << (b % 32)
    rows = [None, rng.integers(0, 2**32, A).astype(np.int64),
            rng.integers(0, 4, A).astype(np.int32),
            rng.integers(0, 4, (A, n_occ)).astype(np.int32),
            rng.choice([0.25, 1.0], (A, n_rate)).astype(np.float32),
            rng.choice([0, 200_000], A).astype(np.int32)]
    sn = 40
    sh1 = rng.integers(0, 2**32, S).astype(np.int64)
    sh2 = rng.integers(0, 2**32, S).astype(np.int64)
    for j in range(ring_n):
        h = explore.genome_hash64((int(ring[1][j]), int(ring[2][j]),
                                   tuple(int(v) for v in ring[3][j]),
                                   tuple(float(v) for v in ring[4][j]),
                                   int(ring[5][j])))
        at = (sn - 1, sn, j)[min(j, 2)]  # the prefix's last row, then past it
        sh1[at], sh2[at] = h
    return ring, bitmaps, union, rows, sh1, sh2, sn


def _boundary_plan(pop, vocab):
    """The storm plan's whole vocabulary (occ, clause, rate and horizon
    ops, swarm groups), or the horizon op alone (no chaos clause)."""
    cfg = (ttn.compile_plan(chip_smoke.storm_plan(), raft_bench_config(1.0))
           if vocab == "storm" else SimConfig(horizon_us=1_000_000))
    return te.make_devloop_plan(cfg, pop=pop, top_k=8, seen_cap=512)


@pytest.mark.parametrize("seed,pop,ring_n,vocab", [
    (0, 64, 0, "storm"), (1, 64, 3, "storm"), (2, 64, 8, "storm"),
    (3, 96, 1, "storm"), (4, 40, 5, "storm"), (5, 80, 8, "horizon"),
])
def test_boundary_equals_a_sequential_transcription(seed, pop, ring_n,
                                                    vocab):
    """devloop_fold and devloop_population against the JAX face's
    fold_body and mut_body run one admission and one candidate at a time:
    ties in novelty, ring overflow past K (ring_n 8 of 8), mutants equal
    to their parents or to earlier mutants, and ring genomes planted at
    the last row of the seen prefix and just past it."""
    plan = _boundary_plan(pop, vocab)
    ring, bitmaps, union, rows, sh1, sh2, sn = _boundary_inputs(
        seed, plan, ring_n)
    t = torch.as_tensor
    u, r, rn, acc = te.devloop_fold(
        t(union), tuple(t(x) for x in ring), t(np.int32(ring_n)),
        t(bitmaps), tuple(None if x is None else t(x) for x in rows),
        plan.top_k)
    wu, wr, wrn, wacc = _seq_fold(union, ring, ring_n, bitmaps, rows,
                                  plan.top_k)
    assert np.array_equal(u.numpy(), wu)
    for a, b in zip(r, wr):
        assert a.dtype == t(b).dtype and np.array_equal(a.numpy(), b)
    assert int(rn) == wrn and int(acc.sum()) == wacc
    if ring_n == 8:
        assert wacc > 0  # insertions into a full ring push rows out
    key = tn.key_from_seed(META_SEED + seed)
    got = te.devloop_population(
        plan, t(key), t(np.int32(7)), t(1000 + seed), r, rn, t(sh1),
        t(sh2), t(np.int32(sn)))
    want = _seq_population(plan, key, 7, 1000 + seed,
                           [x.numpy() for x in r], int(rn), sh1, sh2, sn)
    names = ("seeds", "off", "occ", "rate", "h", "origin", "counter",
             "next_fresh", "seen_h1", "seen_h2", "seen_n")
    for name, a, b in zip(names, got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), name
    block = got[5].numpy()[plan.n_fresh:plan.n_fresh + plan.n_mut]
    if ring_n:
        assert (block == 0).any()  # fallbacks ran
    if vocab == "horizon":
        # 16 distinct genomes at most (8 parents x 2 horizons) for
        # n_mut mutants: duplicates of earlier mutants must occur
        assert (block == 0).sum() >= plan.n_mut - 16


def test_dup_ranks_follow_their_recurrence():
    """_dup_ranks against the sequential recurrence, including fallback
    collisions (a mutant hash equal to an earlier fallback's fresh hash)
    that turn later mutants into duplicates."""
    rng = np.random.default_rng(9)
    for M in (1, 2, 7, 64, 300):
        for _ in range(4):
            base = rng.random(M) < 0.3
            first = np.where(rng.random(M) < 0.2, rng.integers(0, M, M), M)
            r, want = 0, []
            for i in range(M):
                want.append(r)
                r += bool(base[i] or first[i] < r)
            got = te._dup_ranks(torch.as_tensor(base), torch.as_tensor(first))
            assert got.tolist() == want


# ------------------------------------------------------------ the explorer


def _explorer(wl, sim, **kw):
    return explore.Explorer(wl, **{**EXPLORE_RUN, "seen_cap": SEEN_CAP,
                                   "sim": sim, **kw})


def _host_baseline():
    """The port's host loop over GENS generations on the pinned search
    (its report after 2, after 3, and its dispatch count)."""
    wl = chip_smoke.explore_workload()
    sim = _port_sim(wl)
    ex = _explorer(wl, sim)
    rep2 = ex.run(2)
    rep3 = ex.run(GENS - 2)
    return rep2, rep3, [e.to_dict() for e in ex.corpus], sim.dispatch_count


@pytest.fixture(scope="module")
def host(tmp_path_factory):
    return shared_across_workers(tmp_path_factory, "devloop-host-explorer",
                                 _host_baseline)


def _count_decodes(monkeypatch):
    calls = []
    real = te.devloop_results
    monkeypatch.setattr(te, "devloop_results",
                        lambda st: calls.append(1) or real(st))
    return calls


def _assert_reports_equal(dev, want):
    assert dev.fingerprint() == want.fingerprint()
    assert dev.coverage_curve == want.coverage_curve
    assert dev.corpus_curve == want.corpus_curve
    assert dev.violation_curve == want.violation_curve
    assert dev.corpus_digest == want.corpus_digest
    assert dev.violations == want.violations
    assert dev.seeds_run == want.seeds_run


def test_device_loop_windows_2_1_equal_the_host_loop(host, monkeypatch,
                                                     tmp_path):
    """Windows 2 then 1: after 2 generations the JAX face's pinned
    fingerprint and corpus, after 3 the host loop's report, corpus entry
    for entry, with one decode per window, fewer dispatches than the host
    loop, and telemetry observing the windows."""
    rep2, rep3, corpus, host_dispatches = host
    wl = chip_smoke.explore_workload()
    sim = _port_sim(wl)
    decodes = _count_decodes(monkeypatch)
    telemetry.enable(out_dir=str(tmp_path))
    try:
        ex = _explorer(wl, sim, device_loop=True, device_window=2)
        dev2 = ex.run(2)
        assert dev2.fingerprint() == PINNED_EXPLORE == rep2.fingerprint()
        assert explore_corpus_digest(ex) == PINNED_EXPLORE_CORPUS
        dev3 = ex.run(GENS - 2)
        reg = telemetry.get_registry()
        assert reg.counter("explore_devloop_generations").value(
            meta_seed=META_SEED) == GENS
        assert reg.gauge("explore_devloop_window_generations").value(
            meta_seed=META_SEED) == 1
        assert reg.gauge("explore_devloop_seen_rows").value(
            meta_seed=META_SEED) == GENS * LANES
    finally:
        telemetry.disable()
    _assert_reports_equal(dev3, rep3)
    assert [e.to_dict() for e in ex.corpus] == corpus
    assert len(decodes) == 2
    assert sim.dispatch_count < host_dispatches


def test_device_loop_one_window_serial_equals_the_host_loop(host,
                                                            monkeypatch):
    """All 3 generations in one window with pipeline=False (a dispatch-shape
    knob outside the search): the host loop's report, one decode."""
    _, rep3, corpus, _ = host
    wl = chip_smoke.explore_workload()
    decodes = _count_decodes(monkeypatch)
    ex = _explorer(wl, _port_sim(wl), device_loop=True, device_window=GENS,
                   pipeline=False)
    _assert_reports_equal(ex.run(GENS), rep3)
    assert [e.to_dict() for e in ex.corpus] == corpus
    assert len(decodes) == 1


def test_cli_device_loop_prints_the_host_fingerprint(host, monkeypatch,
                                                     capsys):
    """`--device-loop --device cpu` through main(): the JSON report has the
    host loop's fingerprint over the same generations."""
    rep2 = host[0]
    wl = chip_smoke.explore_workload()
    sim = _port_sim(wl)
    monkeypatch.setattr(explore, "_named_workload", lambda *a: wl)
    init = explore.Explorer.__init__
    monkeypatch.setattr(explore.Explorer, "__init__",
                        lambda self, *a, **k: init(self, *a,
                                                   **{**k, "sim": sim}))
    explore.main([
        "--meta-seed", str(META_SEED), "--lanes", str(LANES), "--chunk",
        str(EXPLORE_RUN["chunk"]), "--dispatches", "2", "--no-shrink",
        "--device-loop", "--device-window", "2", "--device", "cpu",
        "--json",
    ])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    rep = explore.ExploreReport.from_json(line)
    assert rep.fingerprint() == rep2.fingerprint() == PINNED_EXPLORE


# ------------------------------------------------------------ the refusals


def _error(call):
    with pytest.raises(ValueError) as e:
        call()
    return str(e.value)


def test_value_errors_equal_the_jax_face():
    pwl, jwl = chip_smoke.explore_workload(), _planted_workload()
    pplan = te.make_devloop_plan(pwl.config, pop=LANES, seen_cap=SEEN_CAP)
    jplan = je.make_devloop_plan(jwl.config, pop=LANES, seen_cap=SEEN_CAP)
    psim = te.BatchedSim(pwl.spec, pwl.config, triage=True, coverage=True,
                         devloop=pplan, device="cpu")
    jsim = je.BatchedSim(jwl.spec, jwl.config, triage=True, coverage=True,
                         devloop=jplan)
    bare = (te.BatchedSim(pwl.spec, pwl.config, triage=True, coverage=True,
                          device="cpu"),
            je.BatchedSim(jwl.spec, jwl.config, triage=True, coverage=True))
    pctl = explore.ctl_for([explore.Candidate(seed=i) for i in range(LANES)],
                           pwl.config.horizon_us)
    jctl = jex.Explorer(jwl, sim=jsim, lanes=LANES,
                        seen_cap=SEEN_CAP)._ctl_for(
        [jex.Candidate(seed=i) for i in range(LANES)])
    seeds = np.arange(LANES, dtype=np.uint32)
    faces = [
        (te, psim, bare[0], pctl, pwl, explore, dict(device="cpu")),
        (je, jsim, bare[1], jctl, jwl, jex, {}),
    ]
    msgs = []
    for eng, sim, no_plan, ctl, wl, exm, kw in faces:
        dkw = dict(lanes=REFILL_LANES, ctl=ctl)
        m = [
            _error(lambda: eng.BatchedSim(wl.spec, wl.config, triage=True,
                                          devloop=sim.devloop, **kw)),
            _error(lambda: no_plan.init_devloop(seeds, window=2, **dkw)),
            _error(lambda: sim.init_devloop(seeds, REFILL_LANES, None, 2)),
            _error(lambda: sim.init_devloop(seeds[:8], window=2, **dkw)),
            _error(lambda: sim.init_devloop(seeds, window=0, **dkw)),
            _error(lambda: sim.init_devloop(seeds, window=2, target_gens=3,
                                            **dkw)),
            _error(lambda: sim.init_devloop(seeds, window=2,
                                            ring={"n": 17}, **dkw)),
            _error(lambda: sim.init_devloop(
                seeds, window=2, seen={"n": SEEN_CAP - 31,
                                       "h1": [0] * 481, "h2": [0] * 481},
                **dkw)),
            _error(lambda: sim.init_devloop(seeds, window=2,
                                            union=np.zeros(8, np.uint32),
                                            **dkw)),
            _error(lambda: sim.run_devloop(types.SimpleNamespace(loop=None))),
            _error(lambda: eng.devloop_results(
                types.SimpleNamespace(loop=None))),
            _error(lambda: exm.Explorer(wl, lanes=LANES, sim=no_plan,
                                        device_loop=True)),
            _error(lambda: exm.Explorer(wl, lanes=32, sim=sim,
                                        device_loop=True)),
            _error(lambda: exm.Explorer(
                wl, lanes=LANES, sim=sim, seen_cap=SEEN_CAP,
                device_loop=True, device_window=2)._run_device_window(3)),
        ]
        msgs.append(m)
    assert msgs[0] == msgs[1]
    assert "capacity 512" in msgs[0][7] and "devloop plan" in msgs[0][12]
