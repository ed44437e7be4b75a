"""The batched discrete-event engine in PyTorch.

The port of `madsim_tpu/tpu/engine.py`: one step advances every lane to its
next conservative-DES window, picks each node's earliest in-window event
(message, straggler or timer), runs the spec's handlers (the fused
`on_event`, or `on_message` and `on_timer` with a 3-way state merge),
applies crash/restart, bipartition, link-clog, latency-spike, membership
(remove/join) and disk-fault (slow/crash/recover) chaos (legacy
trajectory-coupled knobs or the schedule-indexed `nem_*` knobs a FaultPlan
compiles to), keeps the durable watermark of specs that declare one, rolls
loss, duplication, reordering, latency and the heavy-tail straggler coin
for every send, places survivors in the message ring (node-pooled for fused
specs, per-candidate rings for two-handler specs) or the straggler side
pool, checks invariants and rebases lanes whose clock offset crossed
REBASE_US. Same state fields, same draws, same order: a seed's final state
is leaf for leaf the JAX engine's (tests/test_torch_engine.py,
tests/test_torch_nemesis.py, tests/test_torch_twohandler.py,
tests/test_torch_membership.py, tests/test_torch_triage.py).

`BatchedSim(..., triage=True)` threads a per-lane `TriageCtl` through the
step: clause and occurrence switches, message-rate scales and a horizon
per lane, so one batch evaluates a generation of shrink candidates. The
same step, asked for it, also returns the step's `TraceRecord`, the
per-lane event record `run_traced` collects (tpu/trace.py renders it).

State layout differs only in storage width: node, watermark and straggler
leaves are stored wide (the JAX face's u8/i8/u16 narrowing is a storage
choice, not a value one) and u32 values are int64 tensors (prng.py). The
bool planes rest packed, as on the JAX face (`alive_p`, `link_ok_p`,
`member_p`, `msgs.valid_p`); the straggler pool's `valid` stays unpacked,
as there.

`BatchedSim(..., coverage=True)` also accumulates each lane's coverage:
the bitmap of event classes it exercised, its pool-occupancy high water
and its count of state-changing events (tests/test_torch_coverage.py).

A refill sweep (`init_refill`/`run_refill`, continuous batching) runs a
queue of admissions over fewer lanes: a lane that violates, reaches its
horizon or its step budget retires, its result row is harvested, and it
re-initialises from the next queued seed (and ctl genome) inside the step
loop. Every admission's row equals the chunked sweep's row for its seed
(tests/test_torch_refill.py).

`BatchedSim(..., lineage=True)` also carries the causal-lineage plane:
per-node Lamport clocks, the lane's global event counter and a 16-bit
send-event stamp on every pooled message. It is observe-only: every other
leaf equals the same sim's with lineage off (tests/test_torch_lineage.py),
and a traced replay's records are the happens-before edge list that
`madsim_tpu_torch.causal` decodes.

`BatchedSim(..., devloop=make_devloop_plan(...))` carries the
device-resident search loop: a refill sweep whose generation boundary
(`_devloop_boundary`: archive, fold into the corpus ring and the coverage
union, mutate with genome-hash dedup, respawn every lane) runs inside the
step, so a window of explorer generations is one sweep and the host
decodes once per window (`devloop_results`). The boundary is vectorised
tensor code with the JAX face's sequential semantics: the fold is a
prefix-OR scan and a stable sort, the mutants' meta-draw chain a pointer
jump, the dedup a sorted membership test and a rank scan
(tests/test_torch_devloop.py holds it against a sequential transcription
and the window against the JAX face).

On a CUDA card, a sweep without a refill queue runs each block of
DONE_CHECK_STEPS gated steps as one replay of a captured CUDA graph
(`_run`): the JAX face compiles its whole loop into one program, and an
eager step is ~2000 kernel launches. The graph is the same step ops on
static buffers, so every leaf equals the eager loop's
(tests/test_torch_cuda.py holds them equal on the card).

A lane mesh (`tpu/mesh.py`) shards a sweep: `run(mesh=)` splits the lanes
into one contiguous block per shard (`shard_state`), and
`run_refill_sharded` splits the admission queue into one sub-queue per
shard, each shard the one-device refill state of its sub-queue. Each
shard runs the ordinary segment loop on its device's twin of the sim
(`on`), with its own early exit; nothing crosses shards until the
segment-end gather (`gather_state`, `refill_results_sharded`). No draw
folds the lane index, so every row equals the unsharded run's
(tests/test_torch_multichip.py).

Every entry point runs on the CUDA card unless the caller passes
`device="cpu"`; without a card it raises rather than fall back.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Any, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import bitpack, prng
from .mesh import Mesh, canonical_device, device_context
from ..nemesis import (
    COIN_DENOM,
    FIRE_INDEX,
    FIRE_KINDS,
    META_SITE_DRAW,
    NEM_SITE_CLOG_DST,
    NEM_SITE_CLOG_HEAL,
    NEM_SITE_CLOG_IV,
    NEM_SITE_CLOG_SRC,
    NEM_SITE_CRASH_DOWN,
    NEM_SITE_CRASH_IV,
    NEM_SITE_CRASH_VICTIM,
    NEM_SITE_CRASH_WIPE,
    NEM_SITE_DISK_DOWN,
    NEM_SITE_DISK_IV,
    NEM_SITE_DISK_SLOW,
    NEM_SITE_DISK_TORN,
    NEM_SITE_DISK_VICTIM,
    NEM_SITE_PART_HEAL,
    NEM_SITE_PART_IV,
    NEM_SITE_PART_SIDE,
    NEM_SITE_RECONF_DUR,
    NEM_SITE_RECONF_IV,
    NEM_SITE_RECONF_VICTIM,
    NEM_SITE_SKEW,
    NEM_SITE_SPIKE_DUR,
    NEM_SITE_SPIKE_IV,
    NET_SITE_DUP,
    NET_SITE_NEM_LOSS,
    NET_SITE_REORDER,
    NET_SITE_REORDER_EXTRA,
    OCC_CLAUSES,
    OCC_ROW,
    RATE_CLAUSES,
    fold32,
    key_from_seed,
    mutation_vocab,
    RATE_ROW,
    TRIAGE_BIT,
)
from .spec import (
    EID_NONE, INF_GUARD, INF_US, REBASE_US, HardCap, ProtocolSpec, RateFloor,
    SimConfig, derate_horizon, expand_to, popcount, tree_leaves, tree_map,
    tree_select,
)

DEFAULT_DISPATCH_STEPS = 10_000
# steps launched between two host reads of the all-done flag. Steps past the
# point where every lane is done are no-ops (see BatchedSim._step), so the
# check only bounds wasted work; it never changes a result.
DONE_CHECK_STEPS = 32
# idle steps of a traced run (every lane done) evaluated as one batch: a
# card's step costs about the same at 1 and at 16384 lanes, a CPU's grows
# with the lanes past ~1024
IDLE_BLOCK_STEPS = {"cpu": 1024}
IDLE_BLOCK_STEPS_DEFAULT = 16384

# coverage: each lane ORs one bit per exercised event class into a bitmap
# of COV_WORDS u32 words; the class is the murmur3 fold of COV_FIELDS from
# COV_SALT (the JAX face's constants, held equal by
# tests/test_torch_coverage.py)
COV_WORDS = 256
COV_BITS = COV_WORDS * 32
COV_SALT = 0x5EEDC0DE
COV_FIELDS = ("node", "src", "kind", "bucket")


class MsgPool(NamedTuple):
    """In-flight messages: per-destination validity + per-slot ring.

    Node n owns the SK contiguous ring slots [n*SK, (n+1)*SK); a slot holds
    one (deliver time, kind, payload), and validity is one bit per
    (destination, slot), packed along the slot axis."""

    valid_p: Any  # u32-in-int64 [L,N,ceil(CK/32)]
    deliver: Any  # int32 [L,CK] (offset us)
    kind: Any  # int32 [L,CK]
    payload: Any  # int32 [L,CK,P]
    sent_eid: Any = None  # int32 [L,CK] u16 send-event stamp | None (lineage)

    @property
    def valid(self):
        """bool [L,N,CK] validity view."""
        return bitpack.unpack_bits(self.valid_p, self.deliver.shape[-1])


class StragPool(NamedTuple):
    """Heavy-tail straggler side pool (present iff buggify_delay_rate > 0):
    one region of K4 slots per candidate position ([L, C, K4] flattened to
    [L, B]); the destination is stored per slot."""

    valid: Any  # bool [L,B]
    deliver: Any  # int32 [L,B] (offset us)
    dst: Any  # int32 [L,B]
    kind: Any  # int32 [L,B]
    payload: Any  # int32 [L,B,P]
    sent_eid: Any = None  # int32 [L,B] u16 send-event stamp | None (lineage)


class NemesisState(NamedTuple):
    """Per-lane nemesis bookkeeping (present iff a schedule-level clause or
    clock skew is enabled). Every nemesis draw is indexed by (lane base
    key, clause site, occurrence counter `*_k`), a pure function of the
    seed, never of the trajectory clock. The crash clause shares
    `SimState.chaos_at`/`crashed` and the partition clause shares
    `part_at`/`partitioned`/`link_ok` with the legacy knobs; clog, spike,
    reconfig and disk windows carry their own next-toggle offsets here."""

    crash_k: Any  # int32 [L] crash/restart cycle counter
    wipe: Any  # bool [L] current down node restarts with wiped state
    part_k: Any  # int32 [L] split/heal cycle counter
    clog_at: Any  # int32 [L] next clog toggle (offset us; INF_US disabled)
    clogged: Any  # bool [L] a directed link is currently clogged
    clog_src: Any  # int32 [L]
    clog_dst: Any  # int32 [L]
    clog_k: Any  # int32 [L]
    spike_at: Any  # int32 [L] next latency-spike toggle
    spiking: Any  # bool [L]
    spike_k: Any  # int32 [L]
    reconfig_at: Any  # int32 [L] next membership toggle (INF_US disabled)
    reconf_node: Any  # int32 [L] node currently out of the membership (-1:
    #           all in; the next reconfig event is a remove, else a join)
    reconfig_k: Any  # int32 [L] remove/join cycle counter
    disk_at: Any  # int32 [L] next disk-fault phase toggle (INF_US disabled)
    disk_phase: Any  # int32 [L] 0 healthy, 1 degraded, 2 down (the victim
    #           and torn bit are pure draws at (key0, site, disk_k))
    disk_k: Any  # int32 [L] disk-fault occurrence counter (bumps at recover)
    skew_ppm: Any  # int32 [L,N] per-node timer skew in ppm | None


class TriageCtl(NamedTuple):
    """Per-lane shrink controls (present iff `BatchedSim(..., triage=True)`).

    The shrinker (madsim_tpu_torch/triage.py) evaluates every candidate as
    a lane of one batch: all lanes share the config's compiled knobs, and
    these tensors switch clauses, single clause occurrences, message-coin
    rates and the horizon off per lane. A suppressed occurrence still
    advances the timing machinery through its window, so a candidate is
    the seed's trajectory minus exactly the suppressed faults."""

    off: Any  # int32 [L] clause-off bitmask over nemesis.TRIAGE_CLAUSES
    occ: Any  # int32 [L, len(OCC_CLAUSES)] occurrence-off bitmasks (bit k
    #           suppresses occurrence k; k >= 32 is always on, and bit 31,
    #           the int32 sign bit, is left unused by the shrinker)
    rate_scale: Any  # float32 [L, len(RATE_CLAUSES)] loss/dup/reorder rate
    #           scales (the coin is `u < rate * scale` on the same stream)
    h_epoch: Any  # int32 [L] per-lane horizon, epoch part
    h_off: Any  # int32 [L] per-lane horizon, offset part


class Coverage(NamedTuple):
    """Per-lane coverage accumulators (present iff
    `BatchedSim(coverage=True)`): the event-class bitmap, the message-pool
    occupancy high-water mark (main pool + straggler pool), and the count
    of delivered or timer events whose handler changed the node's state."""

    bitmap: Any  # u32 [L, COV_WORDS]
    hiwater: Any  # int32 [L]
    transitions: Any  # int32 [L]


class Lineage(NamedTuple):
    """Per-lane causal-lineage plane (present iff `BatchedSim(lineage=True)`).

    `lam` is a per-node Lamport clock over the lane's global event-id
    scale: a timer fire ticks it by one, a delivery sets it to max(lam,
    send eid) + 1, where the send eid is the delivered message's emitting
    event's id. `eid` is the lane's global event counter: every delivery
    and timer fire takes the next id, in node order within a step. Neither
    feeds a draw or a handler."""

    lam: Any  # int32 [L,N]
    eid: Any  # u32-in-int64 [L] next event id


class RefillQueue(NamedTuple):
    """The admission queue of a refill sweep: one row per admission (a
    seed, and in triage mode its ctl genome). It never changes during the
    sweep; only `RefillLog.cursor` moves."""

    seeds: Any  # u32 [A]
    off: Any  # int32 [A] | None (triage only, as the ctl rows below)
    occ: Any  # int32 [A, len(OCC_CLAUSES)] | None
    rate_scale: Any  # float32 [A, len(RATE_CLAUSES)] | None
    h_epoch: Any  # int32 [A] | None
    h_off: Any  # int32 [A] | None


class RefillLog(NamedTuple):
    """A refill sweep's bookkeeping: the queue cursor, each lane's current
    admission, the per-admission step budget, the occupancy counters, and
    the per-admission result rows, written once at the step the admission's
    lane retires (`refill_results` harvests lanes still live at the end)."""

    cursor: Any  # int32 [] next queue row to admit
    admitted: Any  # int32 [L] each lane's current admission
    step_cap: Any  # int32 [] per-admission step budget (the chunked
    #           path's max_steps: an admission reaching it retires
    #           truncated)
    iters: Any  # int32 [] sweep iterations run
    busy: Any  # int32 [L] active steps per lane
    retired: Any  # int32 [A] sweep iteration of retirement (-1 = live)
    violated: Any  # bool [A]
    deadlocked: Any  # bool [A]
    violation_at: Any  # int32 [A]
    violation_epoch: Any  # int32 [A]
    violation_step: Any  # int32 [A] (the admission's own step count)
    steps: Any  # int32 [A]
    events: Any  # int32 [A]
    overflow: Any  # int32 [A]
    dead_drops: Any  # int32 [A]
    nonmember_drops: Any  # int32 [A]
    unsynced_loss: Any  # int32 [A]
    clock: Any  # int32 [A]
    epoch: Any  # int32 [A]
    fires: Any  # int32 [A, len(FIRE_KINDS)]
    occ_fired: Any  # u32 [A, len(OCC_CLAUSES)] | None
    cov_bitmap: Any  # u32 [A, COV_WORDS] | None (coverage sims)
    cov_hiwater: Any  # int32 [A] | None
    cov_transitions: Any  # int32 [A] | None


# the lane counters a retiring lane's admission row is harvested from
# (RefillLog field -> SimState field), in RefillLog order
_HARVEST = (
    "violated", "deadlocked", "violation_at", "violation_epoch",
    "violation_step", "steps", "events", "overflow", "dead_drops",
    "nonmember_drops", "unsynced_loss", "clock", "epoch", "fires",
)


def _harvest_sources(state) -> dict:
    """RefillLog field -> the [L, ...] lane tensor it is harvested from."""
    out = {f: getattr(state, f) for f in _HARVEST}
    if state.occ_fired is not None:
        out["occ_fired"] = state.occ_fired
    if state.cov is not None:
        out.update(cov_bitmap=state.cov.bitmap, cov_hiwater=state.cov.hiwater,
                   cov_transitions=state.cov.transitions)
    return out


class DevLoopPlan(NamedTuple):
    """The STATIC parameters of the device-resident search loop: what the
    generation boundary bakes in. Fixed at `BatchedSim(..., devloop=plan)`;
    the population split and the mutation vocabulary are the host
    `Explorer`'s, field for field (build both through `make_devloop_plan`
    so they cannot drift): `ops` is the weighted op menu `Explorer._mutate`
    draws from, `sched_rows`/`tog_bits`/`rate_rows` the per-op choice
    tables."""

    pop: int  # A: candidates per generation (== the admission queue)
    top_k: int  # K: corpus-ring capacity (the host's top_k)
    seen_cap: int  # S: dedup-table capacity (append-only rows)
    n_fresh: int
    n_mut: int
    n_swarm: int
    swarm_group: int
    fresh_stride: int
    full_h: int  # the config horizon (genome horizon 0 decodes to this)
    ops: Tuple[str, ...]  # weighted mutation-op menu, host order
    sched_rows: Tuple[int, ...]  # OCC_ROW of each enabled schedule clause
    tog_bits: Tuple[int, ...]  # TRIAGE_BIT of each togglable clause
    rate_rows: Tuple[int, ...]  # RATE_ROW of each scalable message clause


def make_devloop_plan(
    config: SimConfig, pop: int, top_k: int = 16,
    seen_cap: int = 1 << 17, fresh_frac: float = 0.5,
    mutant_frac: float = 0.3, swarm_group: int = 8,
    fresh_stride: int = 1,
) -> DevLoopPlan:
    """The device-loop plan of a compiled SimConfig, with the vocabulary
    source (`nemesis.mutation_vocab`) and the split arithmetic of
    `explore.Explorer._population`, so the boundary and the host mirror
    agree on which clauses mutate and how a generation splits."""
    sched, rate, togglable = mutation_vocab(config)
    ops: list = []
    if sched:
        ops += ["occ"] * 3
    if togglable:
        ops += ["clause"] * 2
    if rate:
        ops.append("rate")
    ops.append("horizon")
    L = int(pop)
    n_mut = int(L * float(mutant_frac))
    n_fresh = int(L * float(fresh_frac))
    n_swarm = L - n_mut - n_fresh if togglable else 0
    n_fresh = L - n_mut - n_swarm
    if seen_cap & (seen_cap - 1):
        raise ValueError(f"seen_cap must be a power of two, got {seen_cap}")
    return DevLoopPlan(
        pop=L, top_k=int(top_k), seen_cap=int(seen_cap), n_fresh=n_fresh,
        n_mut=n_mut, n_swarm=n_swarm, swarm_group=max(1, int(swarm_group)),
        fresh_stride=max(1, int(fresh_stride)),
        full_h=int(config.horizon_us), ops=tuple(ops),
        sched_rows=tuple(OCC_ROW[n] for n in sched),
        tog_bits=tuple(TRIAGE_BIT[n] for n in togglable),
        rate_rows=tuple(RATE_ROW[n] for n in rate),
    )


class DevLoop(NamedTuple):
    """The device-loop carry: the corpus ring, the coverage union, the
    genome-dedup table, the meta-rng cursor and the per-generation
    archives, everything the host explorer rebuilds between generations.
    A = plan.pop admissions, K = plan.top_k ring rows, S = plan.seen_cap
    dedup rows, G = the window's generations. u32 values are int64
    tensors, as everywhere in the port.

    Every value is a pure function of the uploaded search state, the meta
    chain and the admission results: the fold takes admissions in
    admission order (the order the host `_fold_part` replays), the ring is
    the host corpus's stable top-K by novelty, and dedup compares the
    64-bit genome hash both faces compute."""

    meta_key: Any  # u32 [] key_from_seed(meta_seed)
    counter: Any  # int32 [] next MetaRng draw index
    next_fresh: Any  # u32 [] next fresh seed (advances by the stride)
    gens_done: Any  # int32 [] generations run and archived
    target_gens: Any  # int32 [] generations this window runs (<= G)
    accepts: Any  # int32 [] corpus-ring admissions this window
    ring_n: Any  # int32 [] valid ring rows
    ring_bits: Any  # int32 [K] new bits at admission (the sort key)
    ring_seed: Any  # u32 [K]
    ring_off: Any  # int32 [K]
    ring_occ: Any  # int32 [K, len(OCC_CLAUSES)]
    ring_rate: Any  # float32 [K, len(RATE_CLAUSES)]
    ring_h: Any  # int32 [K] raw genome horizon (0 = full)
    union: Any  # u32 [COV_WORDS] global coverage union
    seen_h1: Any  # u32 [S] append-only genome-hash rows; membership is
    seen_h2: Any  # u32 [S]   an exact test over the valid prefix
    seen_n: Any  # int32 []
    gen_h_raw: Any  # int32 [A] raw genome horizons of the live generation
    gen_origin: Any  # int32 [A] 0 fresh, 1 mutant, 2 swarm
    arch_seed: Any  # u32 [G, A]
    arch_off: Any  # int32 [G, A]
    arch_occ: Any  # int32 [G, A, len(OCC_CLAUSES)]
    arch_rate: Any  # float32 [G, A, len(RATE_CLAUSES)]
    arch_h: Any  # int32 [G, A]
    arch_origin: Any  # int32 [G, A]
    arch_violated: Any  # bool [G, A]
    arch_bitmap: Any  # u32 [G, A, COV_WORDS]
    arch_hiwater: Any  # int32 [G, A]
    arch_transitions: Any  # int32 [G, A]


# origin codes of DevLoop.gen_origin / arch_origin, in code order (the
# explorer's Candidate.origin strings)
DEVLOOP_ORIGINS = ("fresh", "mutant", "swarm")


def _prefix_or(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix OR along axis 0: a log-step scan."""
    s = 1
    while s < x.shape[0]:
        x = torch.cat([x[:s], x[s:] | x[:-s]])
        s *= 2
    return x


def devloop_fold(union, ring, ring_n, bitmaps, rows, top_k: int):
    """Fold one generation's admissions, in admission order, into the
    coverage union and the corpus ring: the sequential fold of the JAX
    face (novelty = popcount(bitmap & ~union) against the union as the
    admissions before it left it; a novel admission ORs its bitmap in and
    stable-inserts after every ring row with bits >= its own), in parallel
    form. A non-novel bitmap lies inside the union, so the union before
    admission i is the incoming union OR the exclusive prefix-OR of
    bitmaps 0..i-1; and the stable insertions, truncated to K, keep the
    first K rows of a stable descending sort of [the ring's valid rows,
    then the novel admissions in admission order].

    `ring` and `rows` are (bits, seed, off, occ, rate, h) tuples ([K, ...]
    and [A, ...]; rows' bits are ignored); ring rows at and past `ring_n`
    hold the defaults (bits 0, seed 0, off 0, occ 0, rate 1, h 0), as
    every ring `init_devloop` builds does. Returns (union, ring, ring_n,
    accepted [A] bool)."""
    dev = bitmaps.device
    incl = _prefix_or(bitmaps)
    before = torch.cat([union[None], union[None] | incl[:-1]])
    nb = popcount(bitmaps & ~before).sum(dim=1).to(torch.int32)
    accept = nb > 0
    K = int(top_k)
    kidx = torch.arange(K, device=dev)
    key = torch.where(torch.cat([kidx < ring_n, accept]),
                      torch.cat([ring[0], nb]).to(torch.int64), -1)
    order = torch.sort(-key, stable=True).indices[:K]
    new_n = torch.clamp(ring_n + accept.sum(dtype=torch.int32), max=K)
    keep = kidx < new_n
    defaults = (0, 0, 0, 0, 1.0, 0)
    new_ring = tuple(
        torch.where(expand_to(keep, r),
                    torch.cat([r, a.to(r.dtype) if i else nb]).index_select(
                        0, order), d)
        for i, (r, a, d) in enumerate(zip(ring, rows, defaults))
    )
    return union | incl[-1], new_ring, new_n.to(torch.int32), accept


def _hash_key(h1, h2):
    """One int64 sort key per (h1, h2) u32 pair, in lexicographic order:
    h1 offset by 2^31 first, so the packed value cannot overflow."""
    return ((h1 - (1 << 31)) << 32) | h2


def _seen_member(q1, q2, s1, s2, n):
    """bool [...]: (q1, q2) is among rows 0..n-1 of the (s1, s2) table.
    Exact: a sorted copy of the valid keys (rows past n sort last as the
    largest key, after any valid row equal to it) and a binary search."""
    S = s1.shape[0]
    valid = torch.arange(S, device=s1.device) < n
    srt = torch.sort(torch.where(valid, _hash_key(s1, s2),
                                 torch.iinfo(torch.int64).max),
                     stable=True).values
    q = _hash_key(q1, q2)
    left = torch.searchsorted(srt, q)
    return (left < n) & (srt[left.clamp(max=S - 1)] == q)


def _dup_ranks(base, first_hit):
    """Exclusive running count of duplicate mutants, exact: mutant i is a
    duplicate when `base[i]` (its hash is in the seen prefix or equals an
    earlier mutant's) or when its hash equals the fresh fallback hash of
    an earlier duplicate, i.e. fallback rank `first_hit[i]` < the number
    of duplicates before it (a 64-bit collision, `first_hit` = M when
    none). Each mutant maps a running count r to r + [r > t_i]; the
    prefix compositions of those maps, as tables over r in [0, M], give
    every count at once (log-step scan)."""
    M = base.shape[0]
    r = torch.arange(M + 1, device=base.device)
    thr = torch.where(base, -1, first_hit)
    tab = (r[None, :] + (r[None, :] > thr[:, None]).to(torch.int64)).clamp(
        max=M)
    s = 1
    while s < M:
        tab = torch.cat([tab[:s], torch.gather(tab[s:], 1, tab[:-s])])
        s *= 2
    return torch.cat([tab.new_zeros(1), tab[:-1, 0]])


def devloop_population(plan: DevLoopPlan, meta_key, counter, next_fresh,
                       ring, ring_n, seen_h1, seen_h2, seen_n):
    """The next generation, drawn as the host `Explorer._population` draws
    it: all fresh when the ring is empty; else a fresh block (no draws),
    the mutants (parent choice and `_mutate`'s op draws from the meta
    chain, dedup by genome hash against the seen table with a draw-free
    fresh fallback) and swarm groups (one coin per togglable clause per
    group). Every genome is claimed in the seen table in the host's order
    (mutants first, then fresh and swarm).

    In parallel form: a mutant's draws depend only on the key and its
    cursor, and the cursor chain c -> c + adv(op(c)) is walked for all
    mutants at once by pointer jumping; a mutant is a duplicate when its
    hash is in the seen prefix, equals an earlier mutant's, or (a 64-bit
    collision) equals an earlier fallback's fresh hash, which
    `_dup_ranks` resolves exactly. Writes past the seen table's capacity
    drop, as on the JAX face (`init_devloop`'s headroom check makes them
    unreachable). Returns (seeds, off, occ, rate, h, origin, counter,
    next_fresh, seen_h1, seen_h2, seen_n)."""
    from .nemesis import genome_hash64

    dev = seen_h1.device
    i64, i32 = torch.int64, torch.int32
    A, K, S = plan.pop, plan.top_k, plan.seen_cap
    nF, nM, nS = plan.n_fresh, plan.n_mut, plan.n_swarm
    stride = plan.fresh_stride
    n_occ, n_rate = len(OCC_CLAUSES), len(RATE_CLAUSES)
    c0 = counter.to(i64)
    nf0 = next_fresh.to(i64)

    def arange(n):
        return torch.arange(n, device=dev, dtype=i64)

    def fresh_seeds(start, n):
        return (start + stride * arange(n)) & prng.M32

    def blank(n):
        return (torch.zeros((n,), dtype=i32, device=dev),
                torch.zeros((n, n_occ), dtype=i32, device=dev),
                torch.ones((n, n_rate), dtype=torch.float32, device=dev),
                torch.zeros((n,), dtype=i32, device=dev))

    def draw(c):
        return prng.bits(meta_key, META_SITE_DRAW, c)

    def consts(vals):
        return torch.as_tensor(vals or (0,), dtype=i64, device=dev)

    def claim(seen, app, sn):
        # rows sn.. of the table take the appended hashes, in order
        j = arange(S) - sn
        take = (j >= 0) & (j < app.shape[0])
        return torch.where(take, app[j.clamp(0, app.shape[0] - 1)], seen)

    # -- all fresh (the host's `not parents`): no meta draws
    f_seeds = fresh_seeds(nf0, A)
    f_off, f_occ, f_rate, f_h = blank(A)
    fh1, fh2 = genome_hash64(f_seeds, f_off, f_occ, f_rate, f_h)
    fresh = (f_seeds, f_off, f_occ, f_rate, f_h,
             torch.zeros((A,), dtype=i32, device=dev), c0,
             (nf0 + stride * A) & prng.M32, fh1, fh2)

    # -- mixed: the fresh block
    seeds = [fresh_seeds(nf0, nF)]
    off, occ, rate, h = ([x] for x in blank(nF))
    origin = [torch.zeros((nF,), dtype=i32, device=dev)]
    nf_m = nf0 + stride * nF
    c_end = c0
    app1, app2 = [], []
    if nM:
        # the cursor chain: cursor offset t moves to t + adv(op(t)); the
        # mutants' cursors are its first nM + 1 positions from 0
        menu = consts([{"occ": 0, "clause": 1, "rate": 2, "horizon": 3}[o]
                       for o in plan.ops])
        adv_of = consts([4, 3, 4, 3])
        T = 4 * nM + 1
        t = arange(T)
        op_t = menu[draw(c0 + t + 1) % len(plan.ops)]
        jump = (t + adv_of[op_t]).clamp(max=T - 1)
        idx = arange(nM + 1)
        pos = torch.zeros_like(idx)
        k = 0
        while (1 << k) <= nM:
            pos = torch.where(((idx >> k) & 1) == 1, jump[pos], pos)
            jump = jump[jump]
            k += 1
        c = c0 + pos[:nM]
        c_end = c0 + pos[nM]
        op = op_t[pos[:nM]]
        d0, d2, d3 = draw(c), draw(c + 2), draw(c + 3)
        pidx = (d0 % ring_n.to(i64).clamp(min=1)).clamp(0, K - 1)
        p_seed, p_off, p_occ, p_rate, p_h = (
            x.index_select(0, pidx) for x in ring[1:])
        sched_rows = consts(plan.sched_rows)
        tog_bits = consts(plan.tog_bits)
        rate_rows = consts(plan.rate_rows)
        # occ: flip window bit k of one schedule clause's row
        occ_row = sched_rows[d2 % max(1, len(plan.sched_rows))]
        bit = (torch.ones_like(d3) << (d3 % 10)).to(i32)
        m_occ = torch.where(
            torch.arange(n_occ, device=dev)[None, :] == occ_row[:, None],
            p_occ ^ bit[:, None], p_occ)
        # clause: toggle one togglable clause's disable bit
        m_off = p_off ^ tog_bits[d2 % max(1, len(plan.tog_bits))].to(i32)
        # rate: set one message clause's scale from the menu
        rate_row = rate_rows[d2 % max(1, len(plan.rate_rows))]
        scale = torch.as_tensor([0.25, 0.5, 1.0], dtype=torch.float32,
                                device=dev)[d3 % 3]
        m_rate = torch.where(
            torch.arange(n_rate, device=dev)[None, :] == rate_row[:, None],
            scale[:, None], p_rate)
        # horizon: bisect toward the prefix, or restore full
        full_h = plan.full_h
        h_eff = torch.where(p_h == 0, full_h, p_h)
        alt = torch.clamp(h_eff // 2, min=full_h // 8)
        m_h = torch.where(d2 % 2 == 0, 0, alt).to(i32)
        cand_occ = torch.where((op == 0)[:, None], m_occ, p_occ)
        cand_off = torch.where(op == 1, m_off, p_off)
        cand_rate = torch.where((op == 2)[:, None], m_rate, p_rate)
        cand_h = torch.where(op == 3, m_h, p_h)
        hm1, hm2 = genome_hash64(p_seed, cand_off, cand_occ, cand_rate,
                                 cand_h)
        # dedup, and the fallback seeds nf_m + stride * (duplicates before)
        ii = arange(nM)
        earlier = ((hm1[:, None] == hm1[None, :])
                   & (hm2[:, None] == hm2[None, :])
                   & (ii[None, :] < ii[:, None])).any(dim=1)
        base = _seen_member(hm1, hm2, seen_h1, seen_h2, seen_n) | earlier
        fb = fresh_seeds(nf_m, nM)
        b_off, b_occ, b_rate, b_h = blank(nM)
        fb1, fb2 = genome_hash64(fb, b_off, b_occ, b_rate, b_h)
        hit = (hm1[:, None] == fb1[None, :]) & (hm2[:, None] == fb2[None, :])
        first_hit = torch.where(hit, ii[None, :], nM).min(dim=1).values
        rank = _dup_ranks(base, first_hit)
        dup = base | (first_hit < rank)
        seeds.append(torch.where(dup, fb[rank.clamp(max=nM - 1)], p_seed))
        off.append(torch.where(dup, 0, cand_off).to(i32))
        occ.append(torch.where(dup[:, None], 0, cand_occ).to(i32))
        rate.append(torch.where(dup[:, None], 1.0, cand_rate).to(
            torch.float32))
        h.append(torch.where(dup, 0, cand_h).to(i32))
        origin.append(torch.where(dup, 0, 1).to(i32))
        app1.append(torch.where(dup, fb1[rank.clamp(max=nM - 1)], hm1))
        app2.append(torch.where(dup, fb2[rank.clamp(max=nM - 1)], hm2))
        nf_m = nf_m + stride * dup.sum()
    # swarm groups: one coin per togglable clause per group
    c_fin = c_end
    if nS:
        n_groups = -(-nS // plan.swarm_group)
        nT = len(plan.tog_bits)
        cc = c_end + arange(n_groups * nT).reshape(n_groups, nT)
        coin = draw(cc) % COIN_DENOM < COIN_DENOM // 2
        off_g = torch.zeros((n_groups,), dtype=i32, device=dev)
        for b, tb in enumerate(plan.tog_bits):
            off_g = torch.where(coin[:, b], off_g | tb, off_g)
        c_fin = c_end + n_groups * nT
        seeds.append(fresh_seeds(nf_m, nS))
        _, s_occ, s_rate, s_h = blank(nS)
        off.append(off_g[arange(nS) // plan.swarm_group])
        occ.append(s_occ)
        rate.append(s_rate)
        h.append(s_h)
        origin.append(torch.full((nS,), 2, dtype=i32, device=dev))
    nf_fin = (nf_m + stride * nS) & prng.M32
    seeds, off, occ, rate, h, origin = (
        torch.cat(x) for x in (seeds, off, occ, rate, h, origin))
    # claims: the mutants' rows, then the fresh and swarm genomes
    cl = torch.cat([arange(nF), arange(nS) + nF + nM])
    ch1, ch2 = genome_hash64(seeds[cl], off[cl], occ[cl], rate[cl], h[cl])
    mixed = (seeds, off, occ, rate, h, origin, c_fin, nf_fin,
             torch.cat(app1 + [ch1]), torch.cat(app2 + [ch2]))
    use = ring_n > 0
    out = [torch.where(use, m, f) for m, f in zip(mixed, fresh)]
    sn = seen_n.to(i64)
    return (*out[:6], out[6].to(i32), out[7],
            claim(seen_h1, out[8], sn), claim(seen_h2, out[9], sn),
            torch.clamp(sn + A, max=S).to(i32))


def bit_length32(x: torch.Tensor) -> torch.Tensor:
    """int32 bit length of u32 values (int64 in [0, 2^32)): the JAX face's
    `32 - clz(x)`, by a 5-step binary search in integers."""
    n = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        t = x >> s
        hit = t != 0
        x = torch.where(hit, t, x)
        n = n + hit.to(x.dtype) * s
    return (n + (x != 0).to(x.dtype)).to(torch.int32)


def _or_rows(x: torch.Tensor) -> torch.Tensor:
    """Bitwise OR over dim 0 (torch has no OR reduction): halving."""
    while x.shape[0] > 1:
        h = x.shape[0] // 2
        y = x[:h] | x[h:2 * h]
        x = torch.cat([y, x[2 * h:]]) if x.shape[0] % 2 else y
    return x[0]


def default_ctl(L: int, horizon_us: int, device="cpu") -> TriageCtl:
    """The no-op ctl: every clause and occurrence on, full horizon."""
    eh, oh = divmod(int(horizon_us), REBASE_US)
    return TriageCtl(
        off=torch.zeros((L,), dtype=torch.int32, device=device),
        occ=torch.zeros((L, len(OCC_CLAUSES)), dtype=torch.int32,
                        device=device),
        rate_scale=torch.ones((L, len(RATE_CLAUSES)), dtype=torch.float32,
                              device=device),
        h_epoch=torch.full((L,), eh, dtype=torch.int32, device=device),
        h_off=torch.full((L,), oh, dtype=torch.int32, device=device),
    )


def _clause_on(ctl: TriageCtl, name: str) -> torch.Tensor:
    """bool [L]: clause `name` enabled per lane."""
    return (ctl.off & TRIAGE_BIT[name]) == 0


def _occ_on(ctl: TriageCtl, name: str, k: torch.Tensor) -> torch.Tensor:
    """bool [L]: occurrence k [L] of schedule clause `name` enabled per
    lane. The mask is read as u32 (held in int64), as on the JAX face."""
    bit = (
        prng.u32(ctl.occ[:, OCC_ROW[name]]) >> torch.clamp(k, 0, 31).long()
    ) & 1
    return _clause_on(ctl, name) & ((bit == 0) | (k >= 32))


def _scaled_rate(rate: float, ctl: TriageCtl, name: str) -> torch.Tensor:
    """float32 [L, 1]: a message clause's per-lane coin rate, the JAX
    face's f32(rate) * scale * f32(clause on). The product of two float32
    values rounds the same whether formed in float32 or in double, so the
    scalar needs no device tensor; with the default ctl it is f32(rate)."""
    return (
        ctl.rate_scale[:, RATE_ROW[name]] * prng.f32(rate)
        * _clause_on(ctl, name).to(torch.float32)
    )[:, None]


class TraceRecord(NamedTuple):
    """One step's observable events, for per-lane violation traces: every
    delivery, timer fire and chaos event with its virtual time. Leaves are
    [L, ...]; `run_traced` stacks them to [T, L, ...]. Times are offsets in
    the post-rebase basis (absolute = epoch * REBASE_US + offset)."""

    clock: Any  # int32 [L]
    epoch: Any  # int32 [L]
    t_evt: Any  # int32 [L,N] virtual time of node n's event this step
    msg_fired: Any  # bool [L,N] message delivered to node n this step
    msg_src: Any  # int32 [L,N]
    msg_kind: Any  # int32 [L,N]
    msg_payload: Any  # int32 [L,N,P]
    timer_fired: Any  # bool [L,N]
    crash: Any  # int32 [L] node crashed this step, -1 = none
    restart: Any  # int32 [L] node restarted this step, -1 = none
    split: Any  # bool [L] partition split this step
    heal: Any  # bool [L] partition healed this step
    side_mask: Any  # int32 [L] nodes on side A of the partition draw
    violation: Any  # bool [L] invariant first violated this step
    deadlock: Any  # bool [L]
    clog_src: Any  # int32 [L] link clogged this step, -1 = none
    clog_dst: Any  # int32 [L]
    unclog: Any  # bool [L]
    spike_on: Any  # bool [L] latency spike opened this step
    spike_off: Any  # bool [L]
    remove: Any  # int32 [L] node removed from membership, -1 = none
    join: Any  # int32 [L] node re-joined (fresh init), -1 = none
    disk_slow: Any  # int32 [L] disk degraded on node, -1 = none
    disk_crash: Any  # int32 [L] disk died on node, -1 = none
    disk_recover: Any  # int32 [L] node recovered from its watermark, -1 = none
    disk_torn: Any  # bool [L] the occurrence's torn coin (crash, recover)
    # lineage sims only, else None: post-step Lamport clocks, this step's
    # event ids (EID_NONE: no event) and each delivery's full send eid
    # (EID_NONE: no delivery)
    lam: Any = None  # int32 [L,N]
    evt_eid: Any = None  # u32-in-int64 [L,N]
    sent_eid: Any = None  # u32-in-int64 [L,N]


class SimState(NamedTuple):
    """The full per-lane state; the JAX face's field names. Fields of planes
    this slice does not carry are None."""

    clock: Any  # int32 [L] (offset us; see epoch)
    epoch: Any  # int32 [L]
    key: Any  # u32 [L] hash-chain key
    key0: Any  # u32 [L] the lane's base key
    done: Any  # bool [L]
    violated: Any  # bool [L]
    violation_at: Any  # int32 [L]
    violation_epoch: Any  # int32 [L]
    violation_step: Any  # int32 [L] first violating step (-1 = none)
    deadlocked: Any  # bool [L]
    steps: Any  # int32 [L]
    events: Any  # int32 [L]
    overflow: Any  # int32 [L] sends dropped: pool full
    dead_drops: Any  # int32 [L] sends dropped: destination down
    nonmember_drops: Any  # int32 [L] sends dropped: destination removed
    unsynced_loss: Any  # int32 [L] disk crashes that lost unsynced state
    fires: Any  # int32 [L, len(FIRE_KINDS)]
    occ_fired: Any  # u32 [L, len(OCC_CLAUSES)] occurrence bits | None
    alive_p: Any  # u32 [L,1] packed liveness bits
    crashed: Any  # int32 [L] node currently down, -1 = none
    chaos_at: Any  # int32 [L] next crash/restart event
    member_p: Any  # u32 [L,1] packed membership bits (reconfig clause)
    member_epoch: Any  # int32 [L]
    link_ok_p: Any  # u32 [L,N,1] packed directed-link bits, row = src
    partitioned: Any  # bool [L]
    part_at: Any  # int32 [L] next partition split/heal event
    timer: Any  # int32 [L,N]
    node: Any  # protocol NamedTuple, leaves [L,N,...]
    dur: Any  # durable watermark over spec.durable_fields, leaves [L,N,...]
    #           | None (present iff nem_disk is on and the spec declares
    #           durable_fields)
    msgs: MsgPool
    strag: Any  # StragPool | None
    nem: Any  # NemesisState | None
    ctl: Any  # TriageCtl | None (BatchedSim(..., triage=True) only)
    cov: Any  # Coverage | None (BatchedSim(..., coverage=True) only)
    lin: Any  # Lineage | None (BatchedSim(..., lineage=True) only)
    queue: Any  # RefillQueue | None (refill sweeps only)
    refill: Any  # RefillLog | None (refill sweeps only)
    loop: Any = None  # DevLoop | None (device-loop sweeps only)

    @property
    def alive(self):
        return bitpack.unpack_bits(self.alive_p, self.timer.shape[1])

    @property
    def link_ok(self):
        return bitpack.unpack_bits(self.link_ok_p, self.timer.shape[1])

    @property
    def member(self):
        return bitpack.unpack_bits(self.member_p, self.timer.shape[1])


class ShardedState:
    """A sharded sweep's state: `shards[d]` is a SimState on
    `mesh.devices[d]`. One tensor cannot span devices, so this sequence is
    the port's form of the JAX face's leading device axis. A plain sweep's
    shard d holds lanes [d*Ld, (d+1)*Ld); a sharded refill sweep's shard d
    is the one-device refill state of sub-queue d."""

    def __init__(self, shards, mesh: Mesh) -> None:
        self.shards: Tuple[SimState, ...] = tuple(shards)
        self.mesh = mesh
        if len(self.shards) != mesh.size:
            raise ValueError(
                f"{len(self.shards)} shards for a mesh of {mesh.size}"
            )

    @property
    def device(self) -> torch.device:
        """The first shard's device (where a decode of it starts)."""
        return self.shards[0].clock.device


def _shared_field(name: str) -> property:
    """A BatchedSim attribute kept in `_shared`, the dict a sim shares with
    its twins on other devices (`BatchedSim.on`)."""
    return property(lambda self: self._shared[name],
                    lambda self, v: self._shared.__setitem__(name, v))


def resolve_device(device) -> torch.device:
    """The engine's device: CUDA unless the caller asks for the CPU, with
    the card's index made explicit ("cuda" is the current card). A CUDA
    request without a card, or naming a card the host lacks, raises; it
    never falls back to another device."""
    return canonical_device(device)


def scale_delay_ppm(d: torch.Tensor, ppm) -> torch.Tensor:
    """Stretch an int32 microsecond delay by (1 + ppm * 1e-6), exactly:
    d + floor(d * |ppm| / 1e6) * sign(ppm), wrapped to int32.

    The JAX face splits the 64-bit product into int32-safe partial
    products; the product is exact in int64 (|d| < 2^31, |ppm| < 1e6), and
    floor division of the whole product equals the sum of its floored
    parts, so the result is the same int32 value for every input the
    engine passes (tests/test_torch_nemesis.py holds both on edge
    values)."""
    d64 = d.to(torch.int64)
    ppm64 = torch.as_tensor(ppm, device=d.device).to(torch.int64)
    adj = torch.div(d64 * ppm64.abs(), 1_000_000, rounding_mode="floor")
    return torch.where(ppm64 >= 0, d64 + adj, d64 - adj).to(torch.int32)


def _first_free(free: torch.Tensor, K: int) -> torch.Tensor:
    """First-free-slot mask along the last axis (length K, static),
    unrolled as on the JAX face."""
    if K == 1:
        return free
    prev = torch.zeros_like(free[..., 0])
    cols = []
    for k in range(K):
        cols.append(free[..., k] & ~prev)
        prev = prev | free[..., k]
    return torch.stack(cols, dim=-1)


# select NamedTuple leaves by an [L, N] mask, broadcasting trailing dims
# (the JAX engine's `_tree_where`)
_tree_where = tree_select


def _not_ported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to madsim_tpu_torch yet "
        f"(ROADMAP.md queue 1, {item})"
    )


class BatchedSim:
    """Vectorized multi-lane simulator for one ProtocolSpec."""

    def __init__(
        self, spec: ProtocolSpec, config: Optional[SimConfig] = None,
        triage: bool = False, coverage: bool = False,
        lineage: bool = False, devloop: Any = None, device="cuda",
    ) -> None:
        self.spec = spec
        self.config = config or SimConfig()
        self.triage = bool(triage)
        self.coverage = bool(coverage)
        self.lineage = bool(lineage)
        cfg = self.config
        N = spec.n_nodes
        # -- the JAX face's construction checks that apply to this slice,
        # with the same messages, so both faces accept the same configs
        if devloop is not None and not (triage and coverage):
            raise ValueError(
                "devloop needs BatchedSim(..., triage=True, coverage=True) "
                "— the device loop mutates ctl genomes and ranks coverage "
                "novelty in-jit"
            )
        if N < 2:
            raise ValueError(f"spec.n_nodes must be >= 2, got {N}")
        if N > 32:
            raise ValueError(
                f"spec.n_nodes must be <= 32 (packed bool planes), got {N}"
            )
        if spec.msg_kind_names is not None and len(spec.msg_kind_names) > 256:
            raise ValueError(
                "message kinds must fit u8 (pool `kind` is stored narrow): "
                f"got {len(spec.msg_kind_names)} named kinds"
            )
        narrow = dict(spec.narrow_fields or {})
        bad = set(narrow) & set(spec.time_fields)
        if bad:
            raise ValueError(
                "time_fields hold absolute epoch-rebased times and must "
                f"stay i32 — remove {sorted(bad)} from narrow_fields"
            )
        for fname, entry in (spec.rate_floors or {}).items():
            if not isinstance(entry, (RateFloor, HardCap)):
                raise ValueError(
                    f"rate_floors[{fname!r}] must be a RateFloor or "
                    f"HardCap, got {type(entry).__name__}"
                )
        if narrow and spec.narrow_horizon_us is not None:
            # the JAX face stores these fields narrow and would wrap them
            # past this horizon: refuse the same configs it refuses
            cap = derate_horizon(
                spec.narrow_horizon_us,
                cfg.nem_skew_max_ppm if cfg.nem_skew_enabled else 0,
            )
            if cfg.horizon_us > cap:
                raise ValueError(
                    f"horizon_us={cfg.horizon_us} exceeds this spec's "
                    f"narrow-dtype safe horizon ({cap} us"
                    + (" after clock-skew derating"
                       if cfg.nem_skew_enabled else "")
                    + "): strip spec.narrow_fields (dataclasses.replace("
                    "spec, narrow_fields=None)) for long soaks, or "
                    "shorten the horizon"
                )
        if spec.payload_width < 1 or spec.max_out < 1 or spec.max_out_msg < 1:
            raise ValueError(
                "spec payload_width / max_out / max_out_msg must be >= 1 "
                f"(got {spec.payload_width}/{spec.max_out}/{spec.max_out_msg})"
            )
        if cfg.latency_lo_us < 0 or cfg.latency_hi_us < cfg.latency_lo_us:
            raise ValueError(
                f"latency range [{cfg.latency_lo_us}, {cfg.latency_hi_us}] "
                "must satisfy 0 <= lo <= hi"
            )
        if not (0.0 <= cfg.loss_rate < 1.0):
            raise ValueError(f"loss_rate must be in [0, 1), got {cfg.loss_rate}")
        if cfg.horizon_us <= 0:
            raise ValueError(f"horizon_us must be positive, got {cfg.horizon_us}")
        for name in ("msg_depth_msg", "msg_depth_timer"):
            v = getattr(cfg, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1, got {v}")
        if cfg.msg_spare_slots < 0:
            raise ValueError(
                f"msg_spare_slots must be >= 0, got {cfg.msg_spare_slots}"
            )
        if spec.on_event is None and cfg.msg_spare_slots > 0:
            raise ValueError(
                "msg_spare_slots only applies to fused (on_event) specs — "
                "the two-handler path places per-candidate rings; use "
                "msg_depth_msg/msg_depth_timer there"
            )
        for name in (
            "nem_loss_rate", "nem_dup_rate", "nem_reorder_rate",
            "nem_crash_wipe_rate", "nem_disk_torn_rate",
        ):
            v = getattr(cfg, name)
            if not (0.0 <= v < 1.0):
                raise ValueError(f"{name} must be in [0, 1), got {v}")
        if cfg.nem_crash_enabled and cfg.chaos_enabled:
            raise ValueError(
                "nem_crash_* and crash_interval_* cannot both be enabled — "
                "one crash machinery, one time source (use the FaultPlan)"
            )
        if cfg.nem_partition_enabled and cfg.partition_enabled:
            raise ValueError(
                "nem_partition_* and partition_interval_* cannot both be "
                "enabled — one partition machinery, one time source"
            )
        for prefix, parts in (
            ("nem_crash", ("interval", "down")),
            ("nem_partition", ("interval", "heal")),
            ("nem_clog", ("interval", "heal")),
            ("nem_spike", ("interval", "duration")),
            ("nem_reconfig", ("interval", "down")),
            ("nem_disk", ("interval", "slow", "down")),
        ):
            if getattr(cfg, f"{prefix}_interval_hi_us") <= 0:
                continue
            for part in parts:
                lo = getattr(cfg, f"{prefix}_{part}_lo_us")
                hi = getattr(cfg, f"{prefix}_{part}_hi_us")
                if lo < 0 or hi < lo or hi <= 0:
                    raise ValueError(
                        f"{prefix}_{part} range [{lo}, {hi}] must satisfy "
                        "0 <= lo <= hi and hi > 0"
                    )
        if cfg.nem_reorder_rate > 0 and cfg.nem_reorder_window_us <= 0:
            raise ValueError(
                "nem_reorder_rate needs nem_reorder_window_us > 0, got "
                f"{cfg.nem_reorder_window_us}"
            )
        if cfg.nem_spike_enabled and cfg.nem_spike_extra_us <= 0:
            raise ValueError(
                f"nem_spike_extra_us must be > 0, got {cfg.nem_spike_extra_us}"
            )
        if not (0 <= cfg.nem_skew_max_ppm < 1_000_000):
            raise ValueError(
                "nem_skew_max_ppm must be in [0, 1e6) (the timer rate "
                f"1 + ppm*1e-6 must stay positive), got {cfg.nem_skew_max_ppm}"
            )
        if (
            cfg.latency_hi_us + cfg.nem_spike_extra_us
            + cfg.nem_reorder_window_us
        ) >= INF_GUARD // 4:
            raise ValueError(
                "latency_hi + nem_spike_extra + nem_reorder_window must stay "
                f"below {INF_GUARD // 4} us"
            )
        if spec.on_event is not None and cfg.msg_depth_timer is not None and (
            cfg.msg_depth_timer != cfg.msg_depth_msg
        ):
            raise ValueError(
                "fused (on_event) specs have ONE candidate class: "
                "msg_depth_timer has no effect and must equal msg_depth_msg "
                f"(got {cfg.msg_depth_timer} vs {cfg.msg_depth_msg}); tune "
                "msg_depth_msg and msg_spare_slots instead"
            )
        if spec.on_recover is not None and not spec.durable_fields:
            raise ValueError(
                "spec.on_recover requires spec.durable_fields — the hook "
                "receives the durable watermark, and without declared "
                "durable fields there is nothing durable to recover from"
            )
        if spec.durable_fields and spec.sync_field is None:
            raise ValueError(
                "spec.durable_fields requires spec.sync_field — the i32 "
                "node-state counter the spec's handlers bump at their "
                "fsync points; without it the watermark could never "
                "advance past boot"
            )
        if spec.durable_fields and spec.sync_field in spec.durable_fields:
            raise ValueError(
                "spec.sync_field must not itself be durable: the watermark "
                "advance compares its live value against the PREVIOUS "
                "step's, not against the snapshot"
            )
        bad_dur = set(spec.durable_fields) & set(spec.time_fields)
        if bad_dur:
            raise ValueError(
                "durable_fields cannot include time_fields (the watermark "
                "snapshot is not epoch-rebased; an absolute time in it "
                f"would go stale): remove {sorted(bad_dur)}"
            )
        # the device-resident search loop's plan: inert outside
        # `init_devloop` states, so one sim serves host and device loops
        self.devloop = devloop

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # every op of the step has a deterministic CUDA implementation;
            # this turns any future nondeterministic one into an error
            torch.use_deterministic_algorithms(True)
        dev = self.device
        # candidate positions, the fixed send sites of one step: a fused
        # spec's N * max_out rows; a two-handler spec's N * max_out_msg
        # on_message rows, then its N * max_out on_timer rows. Position
        # c's source node is a constant either way.
        self._fused = spec.on_event is not None
        if self._fused:
            src_of_c = np.arange(N * spec.max_out) // spec.max_out
        else:
            src_of_c = np.concatenate([
                np.arange(N * spec.max_out_msg) // spec.max_out_msg,
                np.arange(N * spec.max_out) // spec.max_out,
            ])
        # nemesis duplication doubles the candidate axis: position 2c is
        # the original send, 2c+1 its coin-gated copy (interleaved, so each
        # node's candidate block and each two-handler segment stays
        # contiguous with its bounds doubled); pool sizing follows
        self._dup = cfg.nem_dup_rate > 0
        mult = 2 if self._dup else 1
        self._Cb = src_of_c.size  # base (pre-duplication) candidates
        self._C = self._Cb * mult
        src_of_c = np.repeat(src_of_c, mult)
        uniform = max(1, cfg.msg_capacity // self._C)
        self._Km = cfg.msg_depth_msg or uniform
        if self._fused:
            # node-pooled placement: node n owns SK = E*K (+ spare)
            # contiguous ring slots, shared by all its sends
            self._E_pack = spec.max_out * mult
            self._SK = self._E_pack * self._Km + cfg.msg_spare_slots
            self._CK = N * self._SK
            src_of_slot = np.repeat(np.arange(N), self._SK)
            self._segs = None
        else:
            # per-candidate rings: position c owns K consecutive slots, K
            # per class (reply rows msg_depth_msg, timer rows
            # msg_depth_timer); equal depths collapse to one segment
            self._Kt = cfg.msg_depth_timer or uniform
            Cm = N * spec.max_out_msg * mult
            Sm = Cm * self._Km
            self._CK = Sm + (self._C - Cm) * self._Kt
            if self._Km == self._Kt:
                self._segs = ((0, self._C, self._Km, 0, self._CK),)
            else:
                self._segs = (
                    (0, Cm, self._Km, 0, Sm),
                    (Cm, self._C, self._Kt, Sm, self._CK),
                )
            # the candidate that owns each ring slot
            cand_of_slot = np.concatenate([
                np.repeat(np.arange(c0, c1), K)
                for c0, c1, K, _, _ in self._segs
            ])
            self._cand_of_slot = torch.as_tensor(cand_of_slot, device=dev)
            src_of_slot = src_of_c[cand_of_slot]
        self._src_of_c = torch.as_tensor(src_of_c, device=dev)  # int64 [C]
        self._src_of_slot = torch.as_tensor(
            src_of_slot, dtype=torch.int32, device=dev
        )  # [CK]
        # straggler side pool: K4 slots per candidate position
        if cfg.buggify_delay_rate > 0:
            self._K4 = max(1, cfg.buggify_depth)
            self._B = self._C * self._K4
            cand_of_b = np.repeat(np.arange(self._C), self._K4)
            self._cand_of_b = torch.as_tensor(cand_of_b, device=dev)
            self._src_of_b = torch.as_tensor(
                src_of_c[cand_of_b], dtype=torch.int32, device=dev
            )  # [B]
        else:
            self._K4 = self._B = 0
        # per-lane nemesis bookkeeping exists iff a schedule-level clause
        # (or skew) is on; occurrence bits iff a schedule clause is on
        self._occ_track = (
            cfg.nem_crash_enabled or cfg.nem_partition_enabled
            or cfg.nem_clog_enabled or cfg.nem_spike_enabled
            or cfg.nem_reconfig_enabled or cfg.nem_disk_enabled
        )
        self._nem_state = self._occ_track or cfg.nem_skew_enabled
        # durability plane: carried iff the disk clause can fire and the
        # spec declares what is durable
        self._dur_state = cfg.nem_disk_enabled and bool(spec.durable_fields)
        self._DurTuple = (
            collections.namedtuple("DurState", spec.durable_fields)
            if spec.durable_fields else None
        )
        self._narange = torch.arange(N, dtype=torch.int32, device=dev)
        self._slot_idx = torch.arange(self._CK, device=dev)
        self._cidx = torch.arange(self._C, device=dev)
        self._bidx = torch.arange(self._Cb, device=dev)
        if self._B:
            self._sidx = torch.arange(self._B, device=dev)
        self._warange = torch.arange(COV_WORDS, device=dev)
        # what a sim and its twins on other devices (`on`) share:
        #   dispatch_count: sweep programs started, one per init of a run,
        #     a refill sweep or a traced run, one per segment of
        #     `run_state`, one per traced scan, one per shard's init and one
        #     for the put of a sharded sweep, one per segment of the slowest
        #     shard (the explorer reports it as `device_dispatches`; the JAX
        #     face counts its own XLA programs, so the two counts differ);
        #   refill_read_s: host seconds refill steps spent in their one
        #     device read (the wait for the step's queued device work
        #     included);
        #   _eager_run: `_run` runs the eager loop instead of its captured
        #     blocks (for A/B comparisons)
        self._shared = {"dispatch_count": 0, "refill_read_s": 0.0,
                        "_eager_run": False}
        # this sim's twins by device, itself included (`on`)
        self._twins: Dict[torch.device, "BatchedSim"] = {self.device: self}
        self.step = self._step
        # `_run`'s captured block of DONE_CHECK_STEPS gated steps (CUDA
        # sims): (layout key, CUDAGraph, static state) for the newest state
        # layout only, since a graph holds its memory pool while it lives
        self._graph = None

    dispatch_count = _shared_field("dispatch_count")
    refill_read_s = _shared_field("refill_read_s")
    _eager_run = _shared_field("_eager_run")

    def on(self, device) -> "BatchedSim":
        """This sim on `device`: itself for its own device, else its twin
        there (the same spec, config and planes, built once and cached).
        Twins share the dispatch count, the refill read seconds and the
        eager-run switch. A sharded sweep runs each shard on
        its device's twin; `serve` moves a campaign's sweeps to the card a
        round placed it on."""
        dev = resolve_device(device)
        twin = self._twins.get(dev)
        if twin is None:
            twin = BatchedSim(
                self.spec, self.config, triage=self.triage,
                coverage=self.coverage, lineage=self.lineage,
                devloop=self.devloop, device=dev,
            )
            twin._twins = self._twins
            twin._shared = self._shared
            self._twins[dev] = twin
        return twin

    # ------------------------------------------------------------------ init

    def _seeds_tensor(self, seeds) -> torch.Tensor:
        """Seeds (any int sequence or array) as u32-in-int64 on the device."""
        if isinstance(seeds, torch.Tensor):
            return prng.u32(seeds.to(self.device))
        arr = np.asarray(list(seeds) if isinstance(seeds, range) else seeds)
        return torch.as_tensor(
            arr.astype(np.uint32).astype(np.int64), device=self.device
        )

    def init(self, seeds, ctl: Optional[TriageCtl] = None) -> SimState:
        """Build lane state for a batch of seeds. `ctl` (triage sims only)
        carries the per-lane shrink controls; by default every clause is
        on and the horizon is the config's."""
        spec, cfg, dev = self.spec, self.config, self.device
        seeds = self._seeds_tensor(seeds)
        L, N, CK = seeds.shape[0], spec.n_nodes, self._CK
        if ctl is not None and not self.triage:
            raise ValueError(
                "a TriageCtl requires BatchedSim(..., triage=True)"
            )
        if self.triage:
            ctl = (default_ctl(L, cfg.horizon_us, dev) if ctl is None
                   else TriageCtl(*(t.to(dev) for t in ctl)))

        key = prng.key_from(seeds)  # u32 [L]
        node_keys = prng.fold(key[:, None], self._narange)
        node_state, timer = spec.init(node_keys, self._narange)
        timer = timer.to(torch.int32)
        if spec.durable_fields:
            self._check_durable(node_state)

        def full(shape, v, dtype=torch.int32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        zi = full((L,), 0)
        zb = full((L,), False, torch.bool)
        fires = full((L, len(FIRE_KINDS)), 0)
        # per-node clock skew: integer ppm drawn once per (seed, node);
        # initial timers are armed at local t=0, so their delay scales
        skew_ppm = None
        if cfg.nem_skew_enabled:
            skew_ppm = prng.randint(
                key[:, None], NEM_SITE_SKEW, -cfg.nem_skew_max_ppm,
                cfg.nem_skew_max_ppm + 1, index=self._narange[None, :],
            )  # [L,N]
            if self.triage:
                # a skew-off lane runs every node at ppm 0; the draws
                # still happen, they just do not apply
                skew_ppm = torch.where(
                    _clause_on(ctl, "skew")[:, None], skew_ppm, 0
                ).to(torch.int32)
            fires[:, FIRE_INDEX["skew"]] = (skew_ppm != 0).sum(
                dim=1, dtype=torch.int32
            )
            sk_ok = (timer >= 0) & (timer < INF_GUARD)
            timer = torch.where(sk_ok, scale_delay_ppm(timer, skew_ppm), timer)

        if cfg.nem_crash_enabled:
            # occurrence-indexed: the first crash interval is draw k=0
            chaos_at = prng.randint(
                key, NEM_SITE_CRASH_IV, cfg.nem_crash_interval_lo_us,
                cfg.nem_crash_interval_hi_us, index=0,
            )
        elif cfg.chaos_enabled:
            chaos_at = prng.randint(
                key, 11, cfg.crash_interval_lo_us, cfg.crash_interval_hi_us
            )
        else:
            chaos_at = full((L,), INF_US)
        if cfg.nem_partition_enabled:
            part_at = prng.randint(
                key, NEM_SITE_PART_IV, cfg.nem_partition_interval_lo_us,
                cfg.nem_partition_interval_hi_us, index=0,
            )
        elif cfg.partition_enabled:
            part_at = prng.randint(
                key, 12, cfg.partition_interval_lo_us,
                cfg.partition_interval_hi_us,
            )
        else:
            part_at = full((L,), INF_US)

        nem = None
        if self._nem_state:
            def first_toggle(enabled, site, lo, hi):
                if enabled:
                    return prng.randint(key, site, lo, hi, index=0)
                return full((L,), INF_US)

            nem = NemesisState(
                crash_k=zi, wipe=zb, part_k=zi,
                clog_at=first_toggle(
                    cfg.nem_clog_enabled, NEM_SITE_CLOG_IV,
                    cfg.nem_clog_interval_lo_us, cfg.nem_clog_interval_hi_us,
                ),
                clogged=zb, clog_src=zi, clog_dst=zi, clog_k=zi,
                spike_at=first_toggle(
                    cfg.nem_spike_enabled, NEM_SITE_SPIKE_IV,
                    cfg.nem_spike_interval_lo_us,
                    cfg.nem_spike_interval_hi_us,
                ),
                spiking=zb, spike_k=zi,
                reconfig_at=first_toggle(
                    cfg.nem_reconfig_enabled, NEM_SITE_RECONF_IV,
                    cfg.nem_reconfig_interval_lo_us,
                    cfg.nem_reconfig_interval_hi_us,
                ),
                reconf_node=full((L,), -1), reconfig_k=zi,
                disk_at=first_toggle(
                    cfg.nem_disk_enabled, NEM_SITE_DISK_IV,
                    cfg.nem_disk_interval_lo_us, cfg.nem_disk_interval_hi_us,
                ),
                disk_phase=zi, disk_k=zi, skew_ppm=skew_ppm,
            )
        strag = None
        if self._B:
            B = self._B
            strag = StragPool(
                valid=full((L, B), False, torch.bool),
                deliver=full((L, B), INF_US),
                dst=full((L, B), 0),
                kind=full((L, B), 0),
                payload=full((L, B, spec.payload_width), 0),
                sent_eid=full((L, B), 0) if self.lineage else None,
            )
        all_n = bitpack.full_mask_word(N)
        return SimState(
            clock=zi, epoch=zi, key=key, key0=key, done=zb, violated=zb,
            violation_at=full((L,), INF_US), violation_epoch=zi,
            violation_step=full((L,), -1), deadlocked=zb, steps=zi,
            events=zi, overflow=zi, dead_drops=zi, nonmember_drops=zi,
            unsynced_loss=zi, fires=fires,
            occ_fired=(
                full((L, len(OCC_CLAUSES)), 0, torch.int64)
                if self._occ_track else None
            ),
            alive_p=full((L, 1), all_n, torch.int64),
            crashed=full((L,), -1), chaos_at=chaos_at,
            member_p=full((L, 1), all_n, torch.int64), member_epoch=zi,
            link_ok_p=full((L, N, 1), all_n, torch.int64),
            partitioned=zb, part_at=part_at, timer=timer, node=node_state,
            # boot is fsynced: the watermark starts as the init snapshot
            dur=self._dur_of(node_state) if self._dur_state else None,
            msgs=MsgPool(
                valid_p=full((L, N, bitpack.packed_words(CK)), 0, torch.int64),
                deliver=full((L, CK), INF_US),
                kind=full((L, CK), 0),
                payload=full((L, CK, spec.payload_width), 0),
                sent_eid=full((L, CK), 0) if self.lineage else None,
            ),
            strag=strag, nem=nem, ctl=ctl,
            cov=Coverage(
                bitmap=full((L, COV_WORDS), 0, torch.int64),
                hiwater=zi, transitions=zi,
            ) if self.coverage else None,
            lin=Lineage(
                lam=full((L, N), 0), eid=full((L,), 0, torch.int64),
            ) if self.lineage else None,
            queue=None, refill=None,
        )

    # ----------------------------------------------- durability watermark
    # spec.durable_fields: the disk clause's plane. The JAX face stores it
    # at the node carry's narrow dtypes; here, like the node, it is wide.

    def _check_durable(self, node) -> None:
        for f in self.spec.durable_fields:
            if not hasattr(node, f):
                raise ValueError(
                    f"durable_fields names unknown node-state field {f!r}"
                )
        sf = self.spec.sync_field
        if sf is not None and not hasattr(node, sf):
            raise ValueError(
                f"sync_field names unknown node-state field {sf!r}"
            )

    def _dur_of(self, node):
        """Snapshot the durable fields of a node pytree (the watermark)."""
        return self._DurTuple(**{
            f: getattr(node, f) for f in self.spec.durable_fields
        })

    # ------------------------------------------------------------------ step

    def _step(self, state: SimState, gate_key: bool = False,
              record: bool = False):
        """One engine step. With `gate_key`, a step taken when every lane is
        already done is a no-op: done lanes freeze every leaf but `key`, and
        the gate holds `key` too, so a sweep may run past its last live step
        without changing the result (the JAX loop stops at that step). With
        `record`, returns (state, TraceRecord of this step)."""
        spec, cfg = self.spec, self.config
        triage = self.triage
        ctl = state.ctl
        N, CK, P, C = spec.n_nodes, self._CK, spec.payload_width, self._C
        L = state.clock.shape[0]
        msgs = state.msgs
        strag = state.strag
        nst = state.nem
        narange = self._narange
        i32 = torch.int32
        clog_on, spike_on = cfg.nem_clog_enabled, cfg.nem_spike_enabled
        reconf_on, disk_on = cfg.nem_reconfig_enabled, cfg.nem_disk_enabled

        # -- 0. unpack the packed bool planes
        valid = bitpack.unpack_bits(msgs.valid_p, CK)  # bool [L,N,CK]
        alive = bitpack.unpack_bits(state.alive_p, N)  # bool [L,N]
        link_ok = bitpack.unpack_bits(state.link_ok_p, N)  # bool [L,N,N]
        node0 = state.node

        # -- 1. advance each lane to its next event window
        t_pend = torch.where(valid, msgs.deliver[:, None, :], INF_US)
        tmsg_main = t_pend.amin(dim=2)  # [L,N]
        tmsg_n = tmsg_main
        if self._B:
            # a node's earliest straggler: the side pool stores each
            # slot's destination
            sd_oh = strag.dst[:, :, None] == narange  # [L,B,N]
            ts_b = torch.where(strag.valid, strag.deliver, INF_US)  # [L,B]
            t_sn = torch.where(sd_oh, ts_b[:, :, None], INF_US)  # [L,B,N]
            tmsg_strag = t_sn.amin(dim=1)  # [L,N]
            tmsg_n = torch.minimum(tmsg_n, tmsg_strag)
        tmsg_n = torch.where(alive, tmsg_n, INF_US)
        ttmr_n = torch.where(alive, state.timer, INF_US)
        # the next chaos instant: crash/restart and partition toggles
        # (legacy or nemesis), and the nemesis clog/spike/reconfig/disk
        # toggles, which lanes advance to even when the protocol is quiet
        next_chaos = torch.minimum(state.chaos_at, state.part_at)
        for on, at in ((clog_on, "clog_at"), (spike_on, "spike_at"),
                       (reconf_on, "reconfig_at"), (disk_on, "disk_at")):
            if on:
                next_chaos = torch.minimum(next_chaos, getattr(nst, at))
        t_next = torch.minimum(
            torch.minimum(tmsg_n.amin(dim=1), ttmr_n.amin(dim=1)), next_chaos
        )
        deadlocked = (~state.done) & (t_next >= INF_US)
        active = (~state.done) & (t_next < INF_US)
        # conservative-DES lookahead window [t_next, t_next + latency_lo),
        # collapsed to the instant t_next when chaos falls inside it (the
        # straggler tail only lengthens latencies)
        lo_w = max(0, cfg.latency_lo_us - 1) if cfg.lookahead else 0
        w_end = torch.clamp(t_next, max=INF_US - lo_w - 1) + lo_w
        if lo_w and (
            cfg.any_crash_enabled or cfg.any_partition_enabled
            or clog_on or spike_on or reconf_on or disk_on
        ):
            w_end = torch.where(next_chaos <= w_end, t_next, w_end)

        # -- 2. advance per-lane keys
        key = prng.fold(state.key, 1)
        if gate_key:
            key = torch.where((~state.done).any(), key, state.key)
        node_key = prng.fold(key[:, None], narange)  # [L,N]
        mkeys = prng.fold(node_key, 101)
        rkeys = prng.fold(node_key, 103)
        ckey = prng.fold(key, 104)  # [L]

        # -- 3. pick each node's event: earliest in-window message or timer
        msg_due = active[:, None] & (tmsg_n <= w_end[:, None])
        tmr_due = active[:, None] & (ttmr_n <= w_end[:, None])
        if cfg.sched_randomize:
            timer_first = prng.bernoulli(prng.fold(node_key, 108), 1, 0.5)
        else:
            timer_first = torch.zeros_like(msg_due)
        tie = msg_due & tmr_due & (tmsg_n == ttmr_n)
        has_msg = msg_due & (
            ~tmr_due | (tmsg_n < ttmr_n) | (tie & ~timer_first)
        )
        due_t = tmr_due & (
            ~msg_due | (ttmr_n < tmsg_n) | (tie & timer_first)
        )
        t_evt = torch.where(
            has_msg, tmsg_n, torch.where(due_t, ttmr_n, t_next[:, None])
        )
        # slot choice among the node's earliest-time slots: argmin returns
        # the FIRST minimum on both devices, as jnp.argmin does
        head = valid & (t_pend == tmsg_n[:, :, None])  # [L,N,CK]
        if cfg.sched_randomize:
            prio = prng.bits(
                prng.fold(key, 107)[:, None], 1, index=self._slot_idx[None]
            )[:, None, :]  # u32 [L,1,CK]
            slot = torch.where(head, prio, prng.M32).argmin(dim=2)
        else:
            slot = torch.where(head, t_pend, INF_US).argmin(dim=2)
        pick_oh = self._slot_idx == slot[:, :, None]  # [L,N,CK]
        m_src = self._src_of_slot[slot]  # [L,N]
        m_kind = torch.gather(msgs.kind, 1, slot)
        m_pay = torch.gather(
            msgs.payload, 1, slot[:, :, None].expand(L, N, P)
        )
        if self._B:
            # a straggler beats the main pool only with a strictly earlier
            # time (same-instant cross-pool ties go to the main pool); among
            # a node's earliest stragglers the first slot wins
            strag_win = has_msg & (tmsg_strag < tmsg_main)
            s_slot = t_sn.argmin(dim=1)  # [L,N]
            m_src = torch.where(strag_win, self._src_of_b[s_slot], m_src)
            m_kind = torch.where(
                strag_win, torch.gather(strag.kind, 1, s_slot), m_kind
            )
            m_pay = torch.where(
                strag_win[:, :, None],
                torch.gather(
                    strag.payload, 1, s_slot[:, :, None].expand(L, N, P)
                ),
                m_pay,
            )
            consumed_main = has_msg & ~strag_win
        else:
            consumed_main = has_msg
        node_ids = torch.broadcast_to(narange, (L, N))

        # -- 3b. causal lineage (lineage sims only). Every delivery and
        # timer fire takes the lane's next event id, in node order within
        # the step. The delivered slot's 16-bit stamp widens back to the
        # full send eid: the largest value <= eid - 1 congruent to it mod
        # 2^16 (exact while fewer than 65536 lane events happen during one
        # flight; causal.graph_from_trace checks it). u32 values are int64
        # masked after every subtraction. Observe-only: nothing here feeds
        # a draw or a handler.
        lin = state.lin
        if lin is not None:
            evt_lin = has_msg | due_t  # [L,N]
            evt_i = evt_lin.to(torch.int64)
            # exclusive prefix count over the nodes, exact in int64
            rank = torch.cumsum(evt_i, dim=1) - evt_i
            evt_eid_full = (lin.eid[:, None] + rank) & prng.M32  # [L,N]
            new_lin_eid = (lin.eid + evt_i.sum(dim=1)) & prng.M32
            m_seid16 = torch.gather(msgs.sent_eid, 1, slot)
            if self._B:
                m_seid16 = torch.where(
                    strag_win, torch.gather(strag.sent_eid, 1, s_slot),
                    m_seid16,
                )
            prev_e = ((lin.eid - 1) & prng.M32)[:, None]
            m_seid = (prev_e - ((prev_e - m_seid16) & 0xFFFF)) & prng.M32
            new_lam = torch.where(
                has_msg, torch.maximum(lin.lam, m_seid.to(i32)) + 1,
                torch.where(due_t, lin.lam + 1, lin.lam),
            )

        # -- 4. handlers + state select (the masks are disjoint)
        any_crash = cfg.any_crash_enabled
        wipe_mask = None
        if any_crash:
            chaos_due = active & (state.chaos_at <= t_next)
            is_restart_evt = state.crashed >= 0
            do_crash = chaos_due & ~is_restart_evt
            do_restart = chaos_due & is_restart_evt
            if cfg.nem_crash_enabled:
                # victim k of the pure schedule: a function of the seed,
                # not of when the crash fires
                victim = prng.randint(
                    state.key0, NEM_SITE_CRASH_VICTIM, 0, N,
                    index=nst.crash_k,
                )
            else:
                victim = prng.randint(ckey, 1, 0, N)
            # triage: a suppressed occurrence keeps its timing (chaos_at,
            # crashed, crash_k advance as always) but applies no effect:
            # ap_* gate the kill, the restart, the pool drops, the trace
            # rows and the fire counts
            ap_crash, ap_restart = do_crash, do_restart
            if triage:
                crash_en = _occ_on(
                    ctl, "crash",
                    nst.crash_k if cfg.nem_crash_enabled
                    else torch.zeros_like(state.crashed),
                )
                ap_crash, ap_restart = do_crash & crash_en, do_restart & crash_en
            crash_mask = ap_crash[:, None] & (node_ids == victim[:, None])
            restart_node = torch.clamp(state.crashed, 0, N - 1)
            restart_mask = ap_restart[:, None] & (
                node_ids == restart_node[:, None]
            )
            ns_r, timer_r = spec.on_restart(node0, node_ids, t_next, rkeys)
            timer_r = timer_r.to(i32)
            if cfg.nem_crash_enabled and cfg.nem_crash_wipe_rate > 0:
                # crash-with-state-wipe: the marked node restarts from
                # `init`, its absolute time fields and first timer shifted
                # to the restart instant (the wipe flag was drawn at crash
                # time and rides nem.wipe through the down window)
                ns_w, timer_w = self._fresh(rkeys, t_next)
                wipe_mask = restart_mask & nst.wipe[:, None]
                if triage:
                    # wipe is its own atom: with it off, the occurrence
                    # still happens but restarts through on_restart
                    wipe_mask = wipe_mask & _clause_on(ctl, "wipe")[:, None]
                ns_r = _tree_where(wipe_mask, ns_w, ns_r)
                timer_r = torch.where(wipe_mask, timer_w, timer_r)
        if self._fused:
            evt = has_msg | due_t
            evt_kind = torch.where(has_msg, m_kind, -1)
            ns_e, out_e, timer_e = spec.on_event(
                node0, node_ids, m_src, evt_kind, m_pay, t_evt, mkeys
            )
            if any_crash:
                node = tree_map(
                    lambda old, e, r: torch.where(
                        expand_to(restart_mask, old), r,
                        torch.where(expand_to(evt, old), e, old),
                    ),
                    node0, ns_e, ns_r,
                )
            else:
                node = tree_map(
                    lambda old, e: torch.where(expand_to(evt, old), e, old),
                    node0, ns_e,
                )
            # deadlines are int32, as on the JAX face (a handler's Python
            # int constants can promote its arithmetic to int64; the cast
            # wraps as the JAX face's int32 arithmetic does)
            timer_m = timer_t = timer_e.to(i32)
        else:
            # both handlers run for every node; a 3-way select keeps the
            # one whose event fired (or the restart)
            tkeys = prng.fold(node_key, 102)
            ns_m, out_m, timer_m = spec.on_message(
                node0, node_ids, m_src, m_kind, m_pay, t_evt, mkeys
            )
            ns_t, out_t, timer_t = spec.on_timer(node0, node_ids, t_evt, tkeys)
            timer_m, timer_t = timer_m.to(i32), timer_t.to(i32)

            def merge(old, m, t, r=None):
                out = torch.where(
                    expand_to(due_t, old), t,
                    torch.where(expand_to(has_msg, old), m, old),
                )
                if r is not None:
                    out = torch.where(expand_to(restart_mask, old), r, out)
                return out

            if any_crash:
                node = tree_map(merge, node0, ns_m, ns_t, ns_r)
            else:
                node = tree_map(merge, node0, ns_m, ns_t)
        if cfg.nem_skew_enabled:
            # per-node clock skew: a handler's absolute deadline encodes a
            # delay from its own event time; stretch that delay by the
            # node's ppm (sentinels and keep/disarm negatives pass through)
            def skew_deadline(deadline, now):
                d = deadline - now
                stretched = now + scale_delay_ppm(d, nst.skew_ppm)
                ok = (deadline >= 0) & (deadline < INF_GUARD) & (d > 0)
                return torch.where(ok, stretched, deadline)

            if self._fused:
                timer_m = timer_t = skew_deadline(timer_m, t_evt)
            else:
                timer_m = skew_deadline(timer_m, t_evt)
                timer_t = skew_deadline(timer_t, t_evt)
            if any_crash:
                timer_r = skew_deadline(
                    timer_r, torch.broadcast_to(t_next[:, None], (L, N))
                )
        # message events keep the deadline on a negative timer; timer
        # events disarm on one
        timer = torch.where(has_msg & (timer_m >= 0), timer_m, state.timer)
        timer = torch.where(
            due_t, torch.where(timer_t >= 0, timer_t, INF_US), timer
        )
        if any_crash:
            timer = torch.where(restart_mask, timer_r, timer)
        # consume the delivered slot
        valid = valid & ~(pick_oh & consumed_main[:, :, None])
        if self._B:
            s_oh = (self._sidx == s_slot[:, :, None]) & strag_win[:, :, None]
            svalid = strag.valid & ~s_oh.any(dim=1)  # [L,B]
        clock = torch.where(
            active, torch.maximum(state.clock, t_evt.amax(dim=1)), state.clock
        )

        # -- 5. crash/restart chaos
        crashed, chaos_at = state.crashed, state.chaos_at
        nem_crash_k = nem_wipe = None
        if any_crash:
            alive = (alive & ~crash_mask) | restart_mask
            if cfg.nem_crash_enabled:
                # schedule arithmetic: next toggle = previous toggle time
                # plus an occurrence-indexed delta, never clock + delta
                ck_n = nst.crash_k
                restart_delay = prng.randint(
                    state.key0, NEM_SITE_CRASH_DOWN, cfg.nem_crash_down_lo_us,
                    cfg.nem_crash_down_hi_us, index=ck_n,
                )
                next_crash = prng.randint(
                    state.key0, NEM_SITE_CRASH_IV,
                    cfg.nem_crash_interval_lo_us,
                    cfg.nem_crash_interval_hi_us, index=ck_n + 1,
                )
                chaos_at = torch.where(
                    do_crash, state.chaos_at + restart_delay,
                    torch.where(
                        do_restart, state.chaos_at + next_crash,
                        state.chaos_at,
                    ),
                )
                nem_crash_k = ck_n + do_restart.to(i32)
                # integer schedule coin: bits % 1e6 < round(rate * 1e6)
                wipe_coin = (
                    prng.bits(state.key0, NEM_SITE_CRASH_WIPE, index=ck_n)
                    % COIN_DENOM
                ) < round(cfg.nem_crash_wipe_rate * COIN_DENOM)
                nem_wipe = torch.where(
                    do_crash, wipe_coin,
                    torch.where(do_restart, False, nst.wipe),
                )
            else:
                restart_delay = prng.randint(
                    ckey, 2, cfg.restart_delay_lo_us, cfg.restart_delay_hi_us
                )
                next_crash = prng.randint(
                    ckey, 3, cfg.crash_interval_lo_us,
                    cfg.crash_interval_hi_us,
                )
                chaos_at = torch.where(
                    do_crash, clock + restart_delay,
                    torch.where(do_restart, clock + next_crash, state.chaos_at),
                )
            crashed = torch.where(
                do_crash, victim, torch.where(do_restart, -1, state.crashed)
            )
            # in-flight messages to a crashed node are lost
            valid = valid & ~crash_mask[:, :, None]
            if self._B:
                svalid = svalid & ~(
                    ap_crash[:, None] & (strag.dst == victim[:, None])
                )

        # -- 5b. partition chaos: random bipartition splits, later heals
        partitioned, part_at = state.partitioned, state.part_at
        nem_part_k = None
        if cfg.any_partition_enabled:
            part_due = active & (state.part_at <= t_next)
            do_split = part_due & ~state.partitioned
            do_heal = part_due & state.partitioned
            if cfg.nem_partition_enabled:
                pk_n = nst.part_k
                # per-node side bit of occurrence k: index = k * 64 + node
                side = (
                    prng.bits(
                        state.key0[:, None], NEM_SITE_PART_SIDE,
                        index=prng.u32(pk_n)[:, None] * 64 + narange[None, :],
                    ) & 1
                ) == 1  # [L,N]
                heal_delay = prng.randint(
                    state.key0, NEM_SITE_PART_HEAL,
                    cfg.nem_partition_heal_lo_us,
                    cfg.nem_partition_heal_hi_us, index=pk_n,
                )
                next_split = prng.randint(
                    state.key0, NEM_SITE_PART_IV,
                    cfg.nem_partition_interval_lo_us,
                    cfg.nem_partition_interval_hi_us, index=pk_n + 1,
                )
                part_at = torch.where(
                    do_split, state.part_at + heal_delay,
                    torch.where(
                        do_heal, state.part_at + next_split, state.part_at
                    ),
                )
                nem_part_k = pk_n + do_heal.to(i32)
            else:
                pkey = prng.fold(key, 106)
                side = prng.uniform(
                    pkey[:, None], 7, index=narange[None, :]
                ) < 0.5
                heal_delay = prng.randint(
                    pkey, 8, cfg.partition_heal_lo_us, cfg.partition_heal_hi_us
                )
                next_split = prng.randint(
                    pkey, 9, cfg.partition_interval_lo_us,
                    cfg.partition_interval_hi_us,
                )
                part_at = torch.where(
                    do_split, clock + heal_delay,
                    torch.where(do_heal, clock + next_split, state.part_at),
                )
            # a suppressed occurrence toggles `partitioned` (timing) but
            # never touches link_ok
            ap_split, ap_heal = do_split, do_heal
            if triage:
                part_en = _occ_on(
                    ctl, "partition",
                    nst.part_k if cfg.nem_partition_enabled
                    else torch.zeros_like(state.crashed),
                )
                ap_split, ap_heal = do_split & part_en, do_heal & part_en
            same_side = side[:, :, None] == side[:, None, :]  # [L,N,N]
            link_ok = torch.where(
                ap_split[:, None, None], same_side,
                torch.where(ap_heal[:, None, None], True, link_ok),
            )
            partitioned = (state.partitioned | do_split) & ~do_heal

        # -- 5c. nemesis link-clog + latency-spike windows (schedule-timed
        # toggles; the clog is asymmetric: src->dst only)
        clogged = clog_src = clog_dst = None
        nem_clog_at = nem_clog_k = None
        if clog_on:
            clog_due = active & (nst.clog_at <= t_next)
            do_clog = clog_due & ~nst.clogged
            do_unclog = clog_due & nst.clogged
            kk = nst.clog_k
            # clog_k names the window open (or opening) this step: one gate
            # covers the toggle's trace rows and every in-window send
            ap_clog, ap_unclog = do_clog, do_unclog
            if triage:
                clog_en = _occ_on(ctl, "clog", kk)
                ap_clog, ap_unclog = do_clog & clog_en, do_unclog & clog_en
            src_d = prng.randint(state.key0, NEM_SITE_CLOG_SRC, 0, N, index=kk)
            dst_d = prng.randint(
                state.key0, NEM_SITE_CLOG_DST, 0, N - 1, index=kk
            )
            dst_d = dst_d + (dst_d >= src_d).to(i32)  # skip src
            clog_src = torch.where(do_clog, src_d, nst.clog_src)
            clog_dst = torch.where(do_clog, dst_d, nst.clog_dst)
            clogged = (nst.clogged | do_clog) & ~do_unclog
            heal_d = prng.randint(
                state.key0, NEM_SITE_CLOG_HEAL, cfg.nem_clog_heal_lo_us,
                cfg.nem_clog_heal_hi_us, index=kk,
            )
            next_d = prng.randint(
                state.key0, NEM_SITE_CLOG_IV, cfg.nem_clog_interval_lo_us,
                cfg.nem_clog_interval_hi_us, index=kk + 1,
            )
            nem_clog_at = torch.where(
                do_clog, nst.clog_at + heal_d,
                torch.where(do_unclog, nst.clog_at + next_d, nst.clog_at),
            )
            nem_clog_k = kk + do_unclog.to(i32)
        spiking = nem_spike_at = nem_spike_k = None
        if spike_on:
            spike_due = active & (nst.spike_at <= t_next)
            do_spike = spike_due & ~nst.spiking
            do_unspike = spike_due & nst.spiking
            sk = nst.spike_k
            ap_spike, ap_unspike = do_spike, do_unspike
            if triage:
                spike_en = _occ_on(ctl, "spike", sk)
                ap_spike = do_spike & spike_en
                ap_unspike = do_unspike & spike_en
            spiking = (nst.spiking | do_spike) & ~do_unspike
            dur_d = prng.randint(
                state.key0, NEM_SITE_SPIKE_DUR, cfg.nem_spike_duration_lo_us,
                cfg.nem_spike_duration_hi_us, index=sk,
            )
            next_d = prng.randint(
                state.key0, NEM_SITE_SPIKE_IV, cfg.nem_spike_interval_lo_us,
                cfg.nem_spike_interval_hi_us, index=sk + 1,
            )
            nem_spike_at = torch.where(
                do_spike, nst.spike_at + dur_d,
                torch.where(do_unspike, nst.spike_at + next_d, nst.spike_at),
            )
            nem_spike_k = sk + do_unspike.to(i32)

        # -- 5d. nemesis membership reconfiguration: a remove takes the
        # schedule-drawn victim out of the cluster (member and alive bits
        # cleared, in-flight messages to it lost); the paired join brings
        # the same node back as a fresh replica rebuilt through spec.init.
        # reconf_node doubles as the open/closed discriminator (-1: the
        # next event is a remove)
        member = None
        member_epoch = state.member_epoch
        nem_reconfig_at = nem_reconf_node = nem_reconfig_k = None
        if reconf_on:
            member = bitpack.unpack_bits(state.member_p, N)  # bool [L,N]
            reconf_due = active & (nst.reconfig_at <= t_next)
            do_remove = reconf_due & (nst.reconf_node < 0)
            do_join = reconf_due & (nst.reconf_node >= 0)
            rk = nst.reconfig_k
            # one gate per occurrence covers both halves (k bumps at the
            # join): a suppressed occurrence changes no membership at all
            ap_remove, ap_join = do_remove, do_join
            if triage:
                reconf_en = _occ_on(ctl, "reconfig", rk)
                ap_remove, ap_join = do_remove & reconf_en, do_join & reconf_en
            victim_d = prng.randint(
                state.key0, NEM_SITE_RECONF_VICTIM, 0, N, index=rk
            )
            join_node = torch.clamp(nst.reconf_node, 0, N - 1)
            remove_mask = ap_remove[:, None] & (node_ids == victim_d[:, None])
            join_mask = ap_join[:, None] & (node_ids == join_node[:, None])
            member = (member & ~remove_mask) | join_mask
            # liveness and membership stay independent planes, but a
            # remove also downs the node and a join revives it
            alive = (alive & ~remove_mask) | join_mask
            member_epoch = member_epoch + (ap_remove | ap_join).to(i32)
            valid = valid & ~remove_mask[:, :, None]
            if self._B:
                svalid = svalid & ~(
                    ap_remove[:, None] & (strag.dst == victim_d[:, None])
                )
            ns_j, timer_j = self._fresh(
                rkeys, t_next, nst.skew_ppm if cfg.nem_skew_enabled else None
            )
            node = _tree_where(join_mask, ns_j, node)
            timer = torch.where(join_mask, timer_j, timer)
            down_d = prng.randint(
                state.key0, NEM_SITE_RECONF_DUR, cfg.nem_reconfig_down_lo_us,
                cfg.nem_reconfig_down_hi_us, index=rk,
            )
            next_d = prng.randint(
                state.key0, NEM_SITE_RECONF_IV,
                cfg.nem_reconfig_interval_lo_us,
                cfg.nem_reconfig_interval_hi_us, index=rk + 1,
            )
            nem_reconfig_at = torch.where(
                do_remove, nst.reconfig_at + down_d,
                torch.where(do_join, nst.reconfig_at + next_d,
                            nst.reconfig_at),
            )
            nem_reconf_node = torch.where(
                do_remove, victim_d,
                torch.where(do_join, -1, nst.reconf_node),
            )
            nem_reconfig_k = rk + do_join.to(i32)

        # durability watermark advance: re-snapshot the durable fields of
        # every node whose sync counter rose this step. Done before the disk
        # clause, so a spec that syncs before acking never loses an acked
        # write to it, even when the sync and the crash land on one step
        dur_mid = state.dur
        if self._dur_state:
            sf = spec.sync_field
            dur_adv = getattr(node, sf) > getattr(node0, sf)  # [L,N]
            dur_mid = _tree_where(dur_adv, self._dur_of(node), state.dur)

        # -- 5e. nemesis disk-fault cycle (slow -> crash -> recover): the
        # victim is killed at the crash and, at recovery, rebuilt from its
        # durable watermark instead of live state. The victim and torn bit
        # are pure draws at index disk_k, recomputed at every phase
        drec_mask = None
        unsynced_lost = None
        nem_disk_at = nem_disk_phase = nem_disk_k = None
        if disk_on:
            disk_due = active & (nst.disk_at <= t_next)
            dk = nst.disk_k
            do_dslow = disk_due & (nst.disk_phase == 0)
            do_dcrash = disk_due & (nst.disk_phase == 1)
            do_drecover = disk_due & (nst.disk_phase == 2)
            # all three phases of occurrence k share one gate
            ap_dslow, ap_dcrash, ap_drecover = do_dslow, do_dcrash, do_drecover
            if triage:
                disk_en = _occ_on(ctl, "disk", dk)
                ap_dslow = do_dslow & disk_en
                ap_dcrash = do_dcrash & disk_en
                ap_drecover = do_drecover & disk_en
            dvictim = prng.randint(
                state.key0, NEM_SITE_DISK_VICTIM, 0, N, index=dk
            )
            if cfg.nem_disk_torn_rate > 0:
                torn = (
                    prng.bits(state.key0, NEM_SITE_DISK_TORN, index=dk)
                    % COIN_DENOM
                ) < round(cfg.nem_disk_torn_rate * COIN_DENOM)
            else:
                torn = torch.zeros_like(do_dslow)
            dcrash_mask = ap_dcrash[:, None] & (node_ids == dvictim[:, None])
            drec_mask = ap_drecover[:, None] & (node_ids == dvictim[:, None])
            alive = (alive & ~dcrash_mask) | drec_mask
            valid = valid & ~dcrash_mask[:, :, None]
            if self._B:
                svalid = svalid & ~(
                    ap_dcrash[:, None] & (strag.dst == dvictim[:, None])
                )
            # unsynced loss: the victim's durable fields differ from its
            # watermark at the crash instant (without a durable contract
            # the whole node state is unsynced)
            if self._dur_state:
                differs = torch.zeros_like(dcrash_mask)
                for f in spec.durable_fields:
                    d = getattr(dur_mid, f) != getattr(node, f)
                    differs = differs | d.reshape(L, N, -1).any(dim=2)
                unsynced_lost = (dcrash_mask & differs).any(dim=1).to(i32)
            else:
                unsynced_lost = ap_dcrash.to(i32)
            # recovery: a fresh init state with the durable fields replaced
            # by the watermark, refined by spec.on_recover (which sees the
            # torn bit); its timer is a delay from the recovery instant
            ns_d, timer_d = spec.init(rkeys, narange)
            if self._dur_state:
                ns_d = ns_d._replace(**{
                    f: getattr(dur_mid, f) for f in spec.durable_fields
                })
            if spec.on_recover is not None:
                ns_d, timer_d = spec.on_recover(
                    ns_d, node_ids, t_next, torn, rkeys
                )
            ns_d, timer_d = self._shift_fresh(
                ns_d, timer_d, t_next,
                nst.skew_ppm if cfg.nem_skew_enabled else None,
            )
            node = _tree_where(drec_mask, ns_d, node)
            timer = torch.where(drec_mask, timer_d, timer)
            slow_d = prng.randint(
                state.key0, NEM_SITE_DISK_SLOW, cfg.nem_disk_slow_lo_us,
                cfg.nem_disk_slow_hi_us, index=dk,
            )
            down_d = prng.randint(
                state.key0, NEM_SITE_DISK_DOWN, cfg.nem_disk_down_lo_us,
                cfg.nem_disk_down_hi_us, index=dk,
            )
            next_d = prng.randint(
                state.key0, NEM_SITE_DISK_IV, cfg.nem_disk_interval_lo_us,
                cfg.nem_disk_interval_hi_us, index=dk + 1,
            )
            nem_disk_at = torch.where(
                do_dslow, nst.disk_at + slow_d,
                torch.where(
                    do_dcrash, nst.disk_at + down_d,
                    torch.where(do_drecover, nst.disk_at + next_d,
                                nst.disk_at),
                ),
            )
            nem_disk_phase = torch.where(
                do_dslow, 1,
                torch.where(do_dcrash, 2,
                            torch.where(do_drecover, 0, nst.disk_phase)),
            ).to(i32)
            nem_disk_k = dk + do_drecover.to(i32)

        # durability watermark reset, the node now final: where wipe, join
        # or disk-recover installed a fresh state, that state is the new
        # on-disk truth. Reset targets are disjoint from advance targets
        new_dur = dur_mid
        if self._dur_state:
            reset = drec_mask
            if wipe_mask is not None:
                reset = reset | wipe_mask
            if reconf_on:
                reset = reset | join_mask
            new_dur = _tree_where(reset, self._dur_of(node), dur_mid)

        # -- 6. collect outboxes, roll the network, pack into the pool
        def flat(out, emitting, e):  # [L,N,e,...] -> [L, N*e, ...]
            return (
                (out.valid & emitting[:, :, None]).reshape(L, N * e),
                out.dst.reshape(L, N * e),
                out.kind.reshape(L, N * e),
                out.payload.reshape(L, N * e, P),
            )

        if self._fused:
            cand_valid, cd, cand_kind, cand_pay = flat(out_e, evt, spec.max_out)
        else:
            parts = (flat(out_m, has_msg, spec.max_out_msg),
                     flat(out_t, due_t, spec.max_out))
            cand_valid, cd, cand_kind, cand_pay = (
                torch.cat(xs, dim=1) for xs in zip(*parts)
            )
        cand_dst = torch.clamp(cd, 0, N - 1).long()
        net_key = prng.fold(key, 105)[:, None]
        zl = torch.zeros((L,), dtype=i32, device=self.device)
        dup_fires = loss_drops = reorder_fires = zl
        if self._dup:
            # nemesis duplication: interleave a coin-gated copy of every
            # candidate (position 2c+1 mirrors 2c); the copy rolls its own
            # loss and latency below
            # triage: a per-lane scaled rate on the same uniform stream
            dcoin = prng.uniform(
                net_key, NET_SITE_DUP, index=self._bidx[None, :]
            ) < (_scaled_rate(cfg.nem_dup_rate, ctl, "dup") if triage
                 else prng.f32(cfg.nem_dup_rate))
            dup_fires = (cand_valid & dcoin).sum(dim=1, dtype=i32)

            def il(x):
                return torch.repeat_interleave(x, 2, dim=1)

            cand_valid = torch.stack(
                [cand_valid, cand_valid & dcoin], dim=2
            ).reshape(L, C)
            cand_dst, cand_kind, cand_pay = (
                il(cand_dst), il(cand_kind), il(cand_pay)
            )
        cidx = self._cidx[None, :]
        u = prng.uniform(net_key, 1, index=cidx)
        lat = prng.randint(
            net_key, 2, cfg.latency_lo_us,
            max(cfg.latency_hi_us, cfg.latency_lo_us + 1), index=cidx,
        )
        keep = cand_valid & (u >= prng.f32(cfg.loss_rate))
        nonmember_dropped = zl
        if reconf_on:
            # membership filter first, so the drop classes stay disjoint: a
            # send to a removed node counts here, to a crashed member below
            member_dst = torch.gather(member, 1, cand_dst)
            nonmember_dropped = (keep & ~member_dst).sum(dim=1, dtype=i32)
            keep = keep & member_dst
        # sends to dead nodes drop, counted apart from pool overflow
        alive_dst = torch.gather(alive, 1, cand_dst)
        dead_dropped = (keep & ~alive_dst).sum(dim=1, dtype=i32)
        keep = keep & alive_dst
        if cfg.any_partition_enabled:
            # link test at send time, row = the candidate's static source
            link = link_ok.index_select(1, self._src_of_c)  # [L,C,N]
            keep = keep & torch.gather(link, 2, cand_dst[:, :, None])[..., 0]
        if clog_on:
            # asymmetric clog: drop candidates whose (static source,
            # destination) is the lane's clogged directed link
            clog_hit = (
                clogged[:, None]
                & (self._src_of_c[None, :] == clog_src[:, None])
                & (cand_dst == clog_dst[:, None])
            )
            if triage:
                clog_hit = clog_hit & clog_en[:, None]
            keep = keep & ~clog_hit
        if cfg.nem_loss_rate > 0:
            # the nemesis loss coin, rolled last: only on messages that
            # survived base loss, dead destinations, partitions and clogs
            u2 = prng.uniform(net_key, NET_SITE_NEM_LOSS, index=cidx)
            nem_lost = keep & (
                u2 < (_scaled_rate(cfg.nem_loss_rate, ctl, "loss") if triage
                      else prng.f32(cfg.nem_loss_rate))
            )
            loss_drops = nem_lost.sum(dim=1, dtype=i32)
            keep = keep & ~nem_lost
        if cfg.nem_reorder_rate > 0:
            # bounded reordering: an extra uniform delay in [0, window]
            rcoin = keep & (
                prng.uniform(net_key, NET_SITE_REORDER, index=cidx)
                < (_scaled_rate(cfg.nem_reorder_rate, ctl, "reorder")
                   if triage else prng.f32(cfg.nem_reorder_rate))
            )
            extra = prng.randint(
                net_key, NET_SITE_REORDER_EXTRA, 0,
                cfg.nem_reorder_window_us + 1, index=cidx,
            )
            lat = torch.where(rcoin, lat + extra, lat)
            reorder_fires = rcoin.sum(dim=1, dtype=i32)
        if spike_on:
            spike_open = spiking & spike_en if triage else spiking
            lat = torch.where(
                spike_open[:, None], lat + cfg.nem_spike_extra_us, lat
            )
        if self._B:
            # the heavy-tail straggler coin: a surviving message sometimes
            # takes seconds instead of milliseconds, and rides the side pool
            bug = keep & prng.bernoulli(
                net_key, 3, cfg.buggify_delay_rate, index=cidx
            )
            tail = prng.randint(
                net_key, 4, cfg.buggify_delay_lo_us,
                max(cfg.buggify_delay_hi_us, cfg.buggify_delay_lo_us + 1),
                index=cidx,
            )
            lat = torch.where(bug, tail, lat)
            send = keep & ~bug
        else:
            send = keep
        deliver_at = t_evt.index_select(1, self._src_of_c) + lat  # [L,C]
        # slots no destination references reset to INF_US (canonical state)
        referenced = valid.any(dim=1)
        old_deliver = torch.where(referenced, msgs.deliver, INF_US)

        if self._fused:
            # node-pooled placement: the i-th send of node n takes the i-th
            # free slot of n's SK-slot pool; a send ranked past the free
            # count drops and counts as overflow
            E, SK = self._E_pack, self._SK
            send_n = send.reshape(L, N, E)
            free = (~referenced).reshape(L, N, SK)
            send_i = send_n.to(i32)
            free_i = free.to(i32)
            r_send = torch.cumsum(send_i, dim=-1, dtype=i32) - send_i
            c_free = torch.cumsum(free_i, dim=-1, dtype=i32)
            r_free = c_free - free_i
            n_free = c_free[..., -1]
            place = (
                send_n[:, :, :, None]
                & free[:, :, None, :]
                & (r_send[:, :, :, None] == r_free[:, :, None, :])
            )  # [L,N,E,SK]: at most one row per slot
            ring_w = place.any(dim=2).reshape(L, CK)
            overflow = state.overflow + (
                send_n & (r_send >= n_free[:, :, None])
            ).sum(dim=(1, 2), dtype=i32)
            # the candidate that took each slot (masked by ring_w)
            row = (
                place.to(i32)
                * torch.arange(E, dtype=i32, device=self.device)[:, None]
            ).sum(dim=2, dtype=i32)  # [L,N,SK]
            cand_of_slot = (row + (narange * E)[None, :, None]).reshape(
                L, CK
            ).long()

            def to_slots(cand):
                if cand.dim() == 2:
                    return torch.gather(cand, 1, cand_of_slot)
                return torch.gather(
                    cand, 1, cand_of_slot[:, :, None].expand(L, CK, P)
                )
        else:
            # per-candidate rings: a send takes the first of its K ring
            # slots no destination still references; with all K pending it
            # drops and counts as overflow (per depth segment)
            ring_w_parts = []
            ovf = zl
            for c0, c1, K, s0, s1 in self._segs:
                nc = c1 - c0
                send_seg = send[:, c0:c1]
                free = (~referenced[:, s0:s1]).reshape(L, nc, K)
                ring_w_seg = send_seg[:, :, None] & _first_free(free, K)
                ovf = ovf + (send_seg & ~ring_w_seg.any(dim=2)).sum(
                    dim=1, dtype=i32
                )
                ring_w_parts.append(ring_w_seg.reshape(L, nc * K))
            ring_w = (
                ring_w_parts[0] if len(ring_w_parts) == 1
                else torch.cat(ring_w_parts, dim=1)
            )  # [L,CK]
            overflow = state.overflow + ovf

            def to_slots(cand):
                return cand.index_select(1, self._cand_of_slot)

        def put(ring, cand):
            """Write each placed candidate's value into its slot."""
            return torch.where(expand_to(ring_w, ring), to_slots(cand), ring)

        written = ring_w[:, None, :] & (
            to_slots(cand_dst)[:, None, :] == narange.long()[None, :, None]
        )  # [L,N,CK]: destination d references slot s
        new_valid = valid | written
        new_deliver = put(old_deliver, deliver_at)
        new_kind = put(msgs.kind, cand_kind)
        new_payload = put(msgs.payload, cand_pay)
        new_sent_eid = None
        if lin is not None:
            # a send carries its emitting event's id (the candidate's
            # source node is a constant per position, and a duplicate
            # shares its original's); slots no destination references
            # reset to 0 (canonical state)
            cand_seid16 = (
                evt_eid_full.index_select(1, self._src_of_c) & 0xFFFF
            ).to(i32)  # [L,C]
            new_sent_eid = put(torch.where(referenced, msgs.sent_eid, 0),
                               cand_seid16)

        new_strag = None
        if self._B:
            # straggler pack: candidate c's tail send takes the first free
            # of its K4 side-pool slots
            K4, B = self._K4, self._B
            sb = keep & bug  # [L,C]
            splace = sb[:, :, None] & _first_free(
                ~svalid.reshape(L, C, K4), K4
            )
            swritten = splace.reshape(L, B)
            overflow = overflow + (sb & ~splace.any(dim=2)).sum(
                dim=1, dtype=i32
            )

            def sput(pool, cand):
                inc = cand.index_select(1, self._cand_of_b)
                return torch.where(expand_to(swritten, pool), inc, pool)

            new_strag = StragPool(
                valid=svalid | swritten,
                deliver=sput(
                    torch.where(svalid, strag.deliver, INF_US), deliver_at
                ),
                dst=sput(strag.dst, cand_dst.to(i32)),
                kind=sput(strag.kind, cand_kind),
                payload=sput(strag.payload, cand_pay),
                sent_eid=None if lin is None else sput(
                    torch.where(svalid, strag.sent_eid, 0), cand_seid16
                ),
            )

        # -- 6b. chaos fire counts
        cols = [zl] * len(FIRE_KINDS)
        if any_crash:
            cols[FIRE_INDEX["crash"]] = ap_crash.to(i32)
            cols[FIRE_INDEX["restart"]] = ap_restart.to(i32)
            if cfg.nem_crash_enabled and cfg.nem_crash_wipe_rate > 0:
                ap_wipe = ap_crash & wipe_coin
                if triage:
                    ap_wipe = ap_wipe & _clause_on(ctl, "wipe")
                cols[FIRE_INDEX["wipe"]] = ap_wipe.to(i32)
        if cfg.any_partition_enabled:
            cols[FIRE_INDEX["partition"]] = ap_split.to(i32)
            cols[FIRE_INDEX["heal"]] = ap_heal.to(i32)
        if clog_on:
            cols[FIRE_INDEX["clog"]] = ap_clog.to(i32)
        if spike_on:
            cols[FIRE_INDEX["spike"]] = ap_spike.to(i32)
        if reconf_on:
            cols[FIRE_INDEX["remove"]] = ap_remove.to(i32)
            cols[FIRE_INDEX["join"]] = ap_join.to(i32)
        if disk_on:
            cols[FIRE_INDEX["disk_slow"]] = ap_dslow.to(i32)
            cols[FIRE_INDEX["disk_crash"]] = ap_dcrash.to(i32)
            cols[FIRE_INDEX["disk_recover"]] = ap_drecover.to(i32)
        cols[FIRE_INDEX["loss"]] = loss_drops
        cols[FIRE_INDEX["dup"]] = dup_fires
        cols[FIRE_INDEX["reorder"]] = reorder_fires
        fires = state.fires + torch.stack(cols, dim=1)

        # clause x occurrence fire bits: a window's bit is set when its
        # open half applies (suppressed occurrences stay unset)
        occ_fired = state.occ_fired
        if occ_fired is not None:
            ocols = [occ_fired[:, i] for i in range(len(OCC_CLAUSES))]

            def occ_mark(row, fired, k):
                bit = torch.bitwise_left_shift(
                    torch.ones_like(ocols[row]), torch.clamp(k, 0, 31).long()
                )
                ocols[row] = torch.where(fired, ocols[row] | bit, ocols[row])

            if cfg.nem_crash_enabled:
                occ_mark(OCC_ROW["crash"], ap_crash, nst.crash_k)
            if cfg.nem_partition_enabled:
                occ_mark(OCC_ROW["partition"], ap_split, nst.part_k)
            if clog_on:
                occ_mark(OCC_ROW["clog"], ap_clog, nst.clog_k)
            if spike_on:
                occ_mark(OCC_ROW["spike"], ap_spike, nst.spike_k)
            if reconf_on:
                occ_mark(OCC_ROW["reconfig"], ap_remove, nst.reconfig_k)
            if disk_on:
                occ_mark(OCC_ROW["disk"], ap_dslow, nst.disk_k)
            occ_fired = torch.stack(ocols, dim=1)

        # -- 7. invariants + lane lifecycle
        ok = spec.check_invariants(node, alive, clock)
        new_violation = active & ~ok & ~state.violated
        violated = state.violated | new_violation
        violation_at = torch.where(new_violation, clock, state.violation_at)
        violation_epoch = torch.where(
            new_violation, state.epoch, state.violation_epoch
        )
        violation_step = torch.where(
            new_violation, state.steps, state.violation_step
        )
        # horizon in (epoch, offset) space; triage lanes carry their own
        # (the shrinker's time-truncation axis)
        if triage:
            eh, oh = ctl.h_epoch, ctl.h_off
        else:
            eh, oh = divmod(int(cfg.horizon_us), REBASE_US)
        reached_horizon = (state.epoch > eh) | (
            (state.epoch == eh) & (clock >= oh)
        )
        done = state.done | deadlocked | reached_horizon | violated

        # -- 7b. coverage (coverage sims only), before the rebase so that
        # shifted time fields do not count as state changes. A delivery's
        # class is fold(COV_SALT, node, src, kind, bucket), a timer's
        # fold(COV_SALT, node, -1, -1, 0); bucket = bit_length(payload[0]
        # as u32). The -1 words are int32, which prng.u32 reads as
        # 0xFFFFFFFF, as JAX does.
        cov = state.cov
        if cov is not None:
            evt_cov = has_msg | due_t  # [L,N]
            src_w = torch.where(has_msg, m_src, -1)
            kind_w = torch.where(has_msg, m_kind, -1)
            p0 = prng.u32(torch.where(has_msg, m_pay[:, :, 0], 0))
            bucket = torch.where(has_msg, bit_length32(p0), 0)
            ck = prng.fold(COV_SALT, node_ids)
            for w in (src_w, kind_w, bucket):
                ck = prng.fold(ck, w)
            idx = prng.mix(ck) % COV_BITS  # [L,N]
            word = torch.where(evt_cov, idx // 32, -1)  # -1: no event
            wbit = torch.ones_like(idx) << (idx % 32)
            # a dense OR per node, as on the JAX face: under deterministic
            # algorithms a CUDA scatter runs as a sorting index_put, which
            # stepped slower on one H100 (PERF.md)
            bm = cov.bitmap
            for ni in range(N):
                bm = bm | torch.where(self._warange == word[:, ni:ni + 1],
                                      wbit[:, ni:ni + 1], 0)
            occupancy = new_valid.any(dim=1).sum(dim=1, dtype=i32)
            if self._B:
                occupancy = occupancy + new_strag.valid.sum(dim=1, dtype=i32)
            changed = torch.zeros_like(evt_cov)
            for old_leaf, new_leaf in zip(tree_leaves(node0),
                                          tree_leaves(node)):
                changed = changed | (old_leaf != new_leaf).reshape(
                    L, N, -1).any(dim=2)
            cov = Coverage(
                bitmap=bm,
                hiwater=torch.maximum(cov.hiwater, occupancy),
                transitions=cov.transitions
                + (evt_cov & changed).sum(dim=1, dtype=i32),
            )

        # -- 8. epoch rebase: unbounded virtual time, int32 offsets
        do_shift = (~done) & (clock >= REBASE_US)
        shift = torch.where(do_shift, REBASE_US, 0).to(i32)  # [L]

        def rb(x):  # rebase a live-offset tensor, guarding sentinels
            return torch.where(x < INF_GUARD, x - expand_to(shift, x), x)

        clock = clock - shift
        epoch = state.epoch + do_shift.to(i32)
        timer = rb(timer)
        chaos_at = rb(chaos_at)
        part_at = rb(part_at)
        new_deliver = rb(new_deliver)
        if new_strag is not None:
            new_strag = new_strag._replace(deliver=rb(new_strag.deliver))
        new_nem = None
        if nst is not None:
            def pick(new, old):
                return old if new is None else new

            new_nem = NemesisState(
                crash_k=pick(nem_crash_k, nst.crash_k),
                wipe=pick(nem_wipe, nst.wipe),
                part_k=pick(nem_part_k, nst.part_k),
                clog_at=rb(pick(nem_clog_at, nst.clog_at)),
                clogged=pick(clogged, nst.clogged),
                clog_src=pick(clog_src, nst.clog_src),
                clog_dst=pick(clog_dst, nst.clog_dst),
                clog_k=pick(nem_clog_k, nst.clog_k),
                spike_at=rb(pick(nem_spike_at, nst.spike_at)),
                spiking=pick(spiking, nst.spiking),
                spike_k=pick(nem_spike_k, nst.spike_k),
                reconfig_at=rb(pick(nem_reconfig_at, nst.reconfig_at)),
                reconf_node=pick(nem_reconf_node, nst.reconf_node),
                reconfig_k=pick(nem_reconfig_k, nst.reconfig_k),
                disk_at=rb(pick(nem_disk_at, nst.disk_at)),
                disk_phase=pick(nem_disk_phase, nst.disk_phase),
                disk_k=pick(nem_disk_k, nst.disk_k),
                skew_ppm=nst.skew_ppm,
            )
        if spec.time_fields:
            node = node._replace(**{
                f: getattr(node, f) - expand_to(shift, getattr(node, f))
                for f in spec.time_fields
            })

        new_state = SimState(
            clock=clock,
            epoch=epoch,
            key=key,
            key0=state.key0,
            done=done,
            violated=violated,
            violation_at=violation_at,
            violation_epoch=violation_epoch,
            violation_step=violation_step,
            deadlocked=state.deadlocked | deadlocked,
            steps=state.steps + active.to(i32),
            events=state.events
            + has_msg.sum(dim=1, dtype=i32)
            + due_t.sum(dim=1, dtype=i32),
            overflow=overflow,
            dead_drops=state.dead_drops + dead_dropped,
            nonmember_drops=state.nonmember_drops + nonmember_dropped,
            unsynced_loss=(
                state.unsynced_loss if unsynced_lost is None
                else state.unsynced_loss + unsynced_lost
            ),
            fires=fires,
            occ_fired=occ_fired,
            alive_p=bitpack.pack_bits(alive),
            crashed=crashed,
            chaos_at=chaos_at,
            member_p=(
                state.member_p if member is None else bitpack.pack_bits(member)
            ),
            member_epoch=member_epoch,
            link_ok_p=bitpack.pack_bits(link_ok),
            partitioned=partitioned,
            part_at=part_at,
            timer=timer,
            node=node,
            dur=new_dur,
            msgs=MsgPool(
                valid_p=bitpack.pack_bits(new_valid),
                deliver=new_deliver,
                kind=new_kind,
                payload=new_payload,
                sent_eid=new_sent_eid,
            ),
            strag=new_strag, nem=new_nem, ctl=state.ctl, cov=cov,
            lin=None if lin is None else Lineage(lam=new_lam,
                                                 eid=new_lin_eid),
            queue=state.queue, refill=state.refill, loop=state.loop,
        )
        # -- 9. refill sweeps: retire finished lanes, admit queued work;
        # -- 10. device-loop sweeps: the generation boundary, in the same
        # host read's branch (`_refill_apply`)
        if state.refill is not None:
            new_state = self._refill_apply(state, new_state, active, gate_key)
        if not record:
            return new_state

        # the step's trace record: effects only (suppressed triage
        # occurrences leave no row), event times in the post-rebase basis
        def none(dtype=i32):
            return torch.full((L,), -1 if dtype == i32 else False,
                              dtype=dtype, device=self.device)

        def node_or_none(fired, node):
            return torch.where(fired, node, -1)

        rec = dict(
            crash=none(), restart=none(), split=none(torch.bool),
            heal=none(torch.bool), side_mask=zl, clog_src=none(),
            clog_dst=none(), unclog=none(torch.bool),
            spike_on=none(torch.bool), spike_off=none(torch.bool),
            remove=none(), join=none(), disk_slow=none(), disk_crash=none(),
            disk_recover=none(), disk_torn=none(torch.bool),
        )
        if any_crash:
            rec.update(crash=node_or_none(ap_crash, victim),
                       restart=node_or_none(ap_restart, restart_node))
        if cfg.any_partition_enabled:
            rec.update(
                split=ap_split, heal=ap_heal,
                side_mask=(side.to(i32) * (1 << narange)).sum(dim=1, dtype=i32),
            )
        if clog_on:
            rec.update(clog_src=node_or_none(ap_clog, src_d),
                       clog_dst=node_or_none(ap_clog, dst_d), unclog=ap_unclog)
        if spike_on:
            rec.update(spike_on=ap_spike, spike_off=ap_unspike)
        if reconf_on:
            rec.update(remove=node_or_none(ap_remove, victim_d),
                       join=node_or_none(ap_join, join_node))
        if disk_on:
            rec.update(
                disk_slow=node_or_none(ap_dslow, dvictim),
                disk_crash=node_or_none(ap_dcrash, dvictim),
                disk_recover=node_or_none(ap_drecover, dvictim),
                disk_torn=(ap_dcrash | ap_drecover) & torn,
            )
        if lin is not None:
            rec.update(
                lam=new_lam,
                evt_eid=torch.where(evt_lin, evt_eid_full, EID_NONE),
                sent_eid=torch.where(has_msg, m_seid, EID_NONE),
            )
        return new_state, TraceRecord(
            clock=clock, epoch=epoch, t_evt=t_evt - shift[:, None],
            msg_fired=has_msg, msg_src=m_src, msg_kind=m_kind,
            msg_payload=m_pay, timer_fired=due_t,
            violation=new_violation, deadlock=deadlocked, **rec,
        )

    def _fresh(self, rkeys, t_next, skew_ppm=None):
        """A node rebuilt through `spec.init` at the instant t_next [L] (a
        wipe-restart or a join), shifted as `_shift_fresh` does."""
        ns, timer = self.spec.init(rkeys, self._narange)
        return self._shift_fresh(ns, timer, t_next, skew_ppm)

    def _shift_fresh(self, ns, timer, t_next, skew_ppm=None):
        """Shift an init-style state (first timer relative) to the instant
        t_next [L]: the timer and the spec's absolute time fields move by
        t_next, and with `skew_ppm` [L,N] the timer's positive delay is
        stretched by each node's ppm."""
        timer = timer.to(torch.int32)
        tn = t_next[:, None]
        ok = (timer >= 0) & (timer < INF_GUARD)
        timer = torch.where(ok, timer + tn, timer)
        if skew_ppm is not None:
            d = timer - tn
            timer = torch.where(
                ok & (d > 0), tn + scale_delay_ppm(d, skew_ppm), timer
            )
        if self.spec.time_fields:
            ns = ns._replace(**{
                f: getattr(ns, f) + expand_to(t_next, getattr(ns, f))
                for f in self.spec.time_fields
            })
        return ns, timer

    # ------------------------------------------------- continuous batching

    def _refill_apply(self, state: SimState, ns: SimState,
                      active: torch.Tensor, gate: bool) -> SimState:
        """Retire the lanes that finished this step and admit queued work.

        The occupancy counters tick (on a gated step only while some lane
        was live at its start: the JAX loop would not have run it); an
        admission at its step budget retires truncated. The JAX face then
        branches on the device (`lax.cond(any(just))`); here the host
        reads the retiring lanes, the lanes' admissions and the cursor once
        per step and, when some lane retires, harvests its counters into
        its admission's result row and re-initialises the first
        (A - cursor) retiring lanes, in lane order, from the next queue
        rows through the real `init`. `init` of those k seeds gives the
        rows an L-lane init gives them (no draw folds the lane index), and
        every per-lane leaf is replaced (the queue and the log are not
        per-lane), so an admission's trajectory is the chunked path's for
        its seed. Rows move by gather (`index_select`) and `where` on
        selectors the host builds, not by `index_copy`, which under
        deterministic algorithms runs on CUDA as a sorting index_put
        (several times slower per refill step on the card, PERF.md)."""
        rf, q = state.refill, state.queue
        dev = ns.done.device
        L, A = ns.done.shape[0], q.seeds.shape[0]
        tick = (~state.done).any().to(torch.int32) if gate else 1
        rf = rf._replace(iters=rf.iters + tick,
                         busy=rf.busy + active.to(torch.int32))
        done = ns.done | (ns.steps >= rf.step_cap)
        ns = ns._replace(done=done)
        just = done & ~state.done
        parts = [just.to(torch.int64), rf.admitted.to(torch.int64),
                 rf.cursor.reshape(1).to(torch.int64)]
        dl = state.loop
        if dl is not None:
            # the generation boundary's predicate rides the same read
            parts += [t.reshape(1).to(torch.int64) for t in (
                done.all(), dl.gens_done, dl.target_gens)]
        t0 = time.perf_counter()
        host = torch.cat(parts).cpu().numpy()
        self.refill_read_s += time.perf_counter() - t0
        lanes = np.nonzero(host[:L])[0]
        if not lanes.size:
            return ns._replace(refill=rf)
        admitted, cursor = host[L:2 * L].copy(), int(host[2 * L])
        n_take = min(lanes.size, A - cursor)
        take = lanes[:n_take]
        # selectors, -1 = keep: the lane each result row is harvested from,
        # and the fresh row each refilled lane takes
        row_src = np.full(A, -1, np.int64)
        row_src[admitted[lanes]] = lanes
        lane_src = np.full(L, -1, np.int64)
        lane_src[take] = np.arange(n_take)
        admitted[take] = cursor + np.arange(n_take)
        sel = torch.as_tensor(np.concatenate([row_src, lane_src, admitted]),
                              device=dev)

        def mover(src_idx):
            keep = src_idx < 0
            idx = src_idx.clamp(min=0)
            return lambda dst, src: torch.where(
                expand_to(keep, dst), dst, src.index_select(0, idx))

        harvest = mover(sel[:A])
        upd = {"retired": harvest(rf.retired, (rf.iters - 1).expand(L))}
        for f, src in _harvest_sources(ns).items():
            upd[f] = harvest(getattr(rf, f), src)
        if n_take > 0:
            adm = torch.arange(cursor, cursor + n_take, device=dev)
            ctl = None
            if self.triage:
                ctl = TriageCtl(q.off[adm], q.occ[adm], q.rate_scale[adm],
                                q.h_epoch[adm], q.h_off[adm])
            fresh = self.init(q.seeds[adm], ctl)
            lane_only = dict(queue=None, refill=None, loop=None)
            ns = tree_map(
                mover(sel[A:A + L]),
                ns._replace(**lane_only), fresh._replace(**lane_only),
            )._replace(queue=q, loop=state.loop)
            upd.update(cursor=rf.cursor + n_take,
                       admitted=sel[A + L:].to(torch.int32))
        ns = ns._replace(refill=rf._replace(**upd))
        if dl is not None:
            # the JAX face's `_devloop_apply`: the boundary fires on the
            # step the generation's last admission retires (queue drained,
            # every lane done) while the window has generations left; a
            # gated no-op step past the window's end never gets here
            all_done, gens_done, target = (int(v) for v in host[2 * L + 1:])
            if n_take == 0 and all_done and gens_done < target:
                ns = self._devloop_boundary(ns, (gens_done, target))
        return ns

    # ------------------------------------------- device-resident search

    def _devloop_boundary(self, ns: SimState, host=None) -> SimState:
        """One generation boundary: archive, fold, then mutate and respawn
        (the JAX face's `_devloop_boundary`, drawing the same meta chain).

          1. ARCHIVE the finished generation's genomes and per-admission
             results into the DevLoop arch_* row `gens_done`;
          2. FOLD the admissions, in admission order, into the coverage
             union and the corpus ring (`devloop_fold`);
          3. when the window has generations left, build the next
             population (`devloop_population`), write it as the admission
             queue, re-init EVERY lane through `init` on its head rows and
             reset the refill log's cursor and per-admission rows
             (`step_cap`, `iters` and `busy` carry over).

        `host` is (gens_done, target_gens) as the step's host read saw
        them; without it (a direct call) they are read here. Nothing else
        is read on the host: the ring, union, seen table and archives stay
        on the device until `devloop_results`."""
        from . import nemesis as tpun

        plan: DevLoopPlan = self.devloop
        dl, rf, q = ns.loop, ns.refill, ns.queue
        dev = ns.done.device
        L = ns.done.shape[0]
        A = plan.pop
        G = dl.arch_seed.shape[0]
        if host is None:
            host = (int(dl.gens_done), int(dl.target_gens))
        gens_done, target = host
        g = min(max(gens_done, 0), G - 1)

        def arch(dst, src):
            return torch.cat([dst[:g], src[None].to(dst.dtype), dst[g + 1:]])

        ring = (dl.ring_bits, dl.ring_seed, dl.ring_off, dl.ring_occ,
                dl.ring_rate, dl.ring_h)
        union, ring, ring_n, accept = devloop_fold(
            dl.union, ring, dl.ring_n, rf.cov_bitmap,
            (None, q.seeds, q.off, q.occ, q.rate_scale, dl.gen_h_raw),
            plan.top_k,
        )
        folded = dl._replace(
            gens_done=dl.gens_done + 1,
            accepts=dl.accepts + accept.sum(dtype=torch.int32),
            union=union, ring_n=ring_n, ring_bits=ring[0],
            ring_seed=ring[1], ring_off=ring[2], ring_occ=ring[3],
            ring_rate=ring[4], ring_h=ring[5],
            arch_seed=arch(dl.arch_seed, q.seeds),
            arch_off=arch(dl.arch_off, q.off),
            arch_occ=arch(dl.arch_occ, q.occ),
            arch_rate=arch(dl.arch_rate, q.rate_scale),
            arch_h=arch(dl.arch_h, dl.gen_h_raw),
            arch_origin=arch(dl.arch_origin, dl.gen_origin),
            arch_violated=arch(dl.arch_violated, rf.violated),
            arch_bitmap=arch(dl.arch_bitmap, rf.cov_bitmap),
            arch_hiwater=arch(dl.arch_hiwater, rf.cov_hiwater),
            arch_transitions=arch(dl.arch_transitions, rf.cov_transitions),
        )
        if gens_done + 1 >= target:
            return ns._replace(loop=folded)
        (seeds, off, occ, rate, h, origin, counter, next_fresh, sh1, sh2,
         sn) = devloop_population(
            plan, dl.meta_key, dl.counter, dl.next_fresh, ring, ring_n,
            dl.seen_h1, dl.seen_h2, dl.seen_n)
        h_ep, h_of = tpun.genome_ctl_rows(h, plan.full_h)
        queue = RefillQueue(seeds=seeds, off=off, occ=occ, rate_scale=rate,
                            h_epoch=h_ep, h_off=h_of)
        fresh = self.init(seeds[:L], TriageCtl(
            off[:L], occ[:L], rate[:L], h_ep[:L], h_of[:L]))

        def full(shape, v=0, dtype=torch.int32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        zi = full((A,))
        log = rf._replace(
            cursor=full((), L),
            admitted=torch.arange(L, dtype=torch.int32, device=dev),
            retired=full((A,), -1), violated=full((A,), False, torch.bool),
            deadlocked=full((A,), False, torch.bool),
            violation_at=full((A,), INF_US), violation_epoch=zi,
            violation_step=full((A,), -1), steps=zi, events=zi, overflow=zi,
            dead_drops=zi, nonmember_drops=zi, unsynced_loss=zi, clock=zi,
            epoch=zi, fires=full((A, len(FIRE_KINDS))),
            occ_fired=(None if rf.occ_fired is None
                       else full((A, len(OCC_CLAUSES)), 0, torch.int64)),
            cov_bitmap=full((A, COV_WORDS), 0, torch.int64),
            cov_hiwater=zi, cov_transitions=zi,
        )
        loop = folded._replace(
            counter=counter, next_fresh=next_fresh, seen_h1=sh1,
            seen_h2=sh2, seen_n=sn, gen_h_raw=h, gen_origin=origin,
        )
        return fresh._replace(queue=queue, refill=log, loop=loop)

    def init_refill(self, seeds, lanes: int, ctl: Optional[TriageCtl] = None,
                    step_cap: int = 100_000) -> SimState:
        """A refill state: `lanes` lanes fed from a queue of all `seeds`
        (one admission per seed). Admissions 0..L-1 start resident, the
        rest admit in retirement order. `ctl` (triage sims) gives every
        admission its own ctl row; `step_cap` is the per-admission step
        budget, the chunked path's max_steps. The queue holds copies of
        the caller's seeds and ctl."""
        dev = self.device
        seeds = self._seeds_tensor(seeds)
        if seeds.dim() != 1 or seeds.shape[0] == 0:
            raise ValueError("init_refill needs a non-empty 1-D seed array")
        A = int(seeds.shape[0])
        L = max(1, min(int(lanes), A))
        if ctl is not None and not self.triage:
            raise ValueError(
                "a refill ctl queue requires BatchedSim(..., triage=True)"
            )
        if self.triage:
            if ctl is None:
                ctl = default_ctl(A, self.config.horizon_us, dev)
            if int(ctl.off.shape[0]) != A:
                raise ValueError(
                    f"refill ctl has {int(ctl.off.shape[0])} rows for "
                    f"{A} admissions — one genome per admission"
                )
            ctl = TriageCtl(*(t.to(dev).clone() for t in ctl))
        if step_cap <= 0:
            raise ValueError(f"step_cap must be positive, got {step_cap}")
        state = self.init(
            seeds[:L], None if ctl is None else TriageCtl(*(t[:L] for t in ctl))
        )
        self.dispatch_count += 1

        def full(shape, v=0, dtype=torch.int32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        queue = RefillQueue(seeds.clone(), *(
            (None,) * len(TriageCtl._fields) if ctl is None else ctl
        ))
        zi = full((A,))
        log = RefillLog(
            cursor=full((), L), admitted=torch.arange(L, dtype=torch.int32,
                                                      device=dev),
            step_cap=full((), step_cap), iters=full((), 0), busy=full((L,)),
            retired=full((A,), -1), violated=full((A,), False, torch.bool),
            deadlocked=full((A,), False, torch.bool),
            violation_at=full((A,), INF_US), violation_epoch=zi,
            violation_step=full((A,), -1), steps=zi, events=zi, overflow=zi,
            dead_drops=zi, nonmember_drops=zi, unsynced_loss=zi, clock=zi,
            epoch=zi, fires=full((A, len(FIRE_KINDS))),
            occ_fired=(full((A, len(OCC_CLAUSES)), 0, torch.int64)
                       if self._occ_track else None),
            cov_bitmap=(full((A, COV_WORDS), 0, torch.int64)
                        if self.coverage else None),
            cov_hiwater=zi if self.coverage else None,
            cov_transitions=zi if self.coverage else None,
        )
        return state._replace(queue=queue, refill=log)

    def run_refill(
        self, seeds, lanes: int, max_steps: int = 100_000,
        dispatch_steps: int = DEFAULT_DISPATCH_STEPS,
        ctl: Optional[TriageCtl] = None, total_steps: Optional[int] = None,
    ) -> SimState:
        """Run all `seeds` as admissions of one continuously batched sweep
        over `lanes` lanes; decode with `refill_results` /
        `summarize_refill`. `max_steps` is the per-admission step budget
        with the chunked path's semantics (an admission reaching it retires
        truncated); `total_steps` bounds the sweep's iterations (default
        max_steps * A, which cannot bind)."""
        state = self.init_refill(seeds, lanes, ctl, step_cap=max_steps)
        if total_steps is None:
            total_steps = int(max_steps) * int(state.queue.seeds.shape[0])
        return self.run_state(state, total_steps, dispatch_steps)

    def init_devloop(
        self, seeds, lanes: int, ctl, window: int,
        step_cap: int = 100_000,
        meta_seed: int = 0, meta_counter: int = 0, next_fresh: int = 0,
        target_gens: Optional[int] = None,
        gen_h_raw=None, gen_origin=None,
        ring: Optional[dict] = None, union=None,
        seen: Optional[dict] = None,
    ) -> SimState:
        """A device-loop state: a refill sweep whose generation boundary
        (fold, rank, mutate, respawn) runs inside the step, so a window of
        up to `window` generations is one sweep with no host read of the
        search state.

        `seeds`/`ctl` are generation 0's population as the host
        `Explorer._population` built it; `meta_seed`/`meta_counter`/
        `next_fresh` resume the MetaRng cursor where the host left it;
        `gen_h_raw`/`gen_origin` carry generation 0's raw genome horizons
        and origin codes (the ctl encode is lossy: horizon 0 encodes as
        the full horizon). `ring`/`union`/`seen` upload the explorer's
        corpus top-K (sorted by novelty, descending), coverage union and
        genome-hash dedup set; all optional (a cold start is empty).
        `window` (G) sizes the archives; `target_gens` <= G lets a final
        partial window run fewer generations. Every upload is a copy."""
        plan = self.devloop
        if plan is None:
            raise ValueError(
                "init_devloop needs BatchedSim(..., devloop=plan)"
            )
        if ctl is None:
            raise ValueError("init_devloop requires a ctl queue (triage)")
        dev = self.device
        seeds = self._seeds_tensor(seeds)
        A = plan.pop
        if int(seeds.shape[0]) != A:
            raise ValueError(
                f"devloop population is {A} admissions per generation, "
                f"got {int(seeds.shape[0])} seeds"
            )
        G = int(window)
        if G < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        tg = G if target_gens is None else int(target_gens)
        if not 1 <= tg <= G:
            raise ValueError(
                f"target_gens must be in [1, {G}], got {target_gens}"
            )
        K, S = plan.top_k, plan.seen_cap
        n_occ, n_rate = len(OCC_CLAUSES), len(RATE_CLAUSES)
        state = self.init_refill(seeds, lanes, ctl, step_cap=step_cap)

        def t(a, dtype=torch.int64):
            a = np.asarray(a)
            if a.dtype == np.uint32:
                a = a.astype(np.int64)
            return torch.as_tensor(a, device=dev).to(dtype).clone()

        # -- the ring upload (the host corpus's top-K, sorted)
        ring = dict(ring or {})
        rn = int(ring.get("n", 0))
        if not 0 <= rn <= K:
            raise ValueError(f"ring has {rn} rows, capacity {K}")

        def buf(key, shape, dtype, fill=0):
            src = ring.get(key)
            out = np.full(shape, fill, dtype=dtype)
            if src is not None and rn:
                out[:rn] = np.asarray(src, dtype=dtype)[:rn]
            return out

        # -- the dedup table + headroom: a window appends at most one row
        # per candidate, so a full window must fit
        seen = dict(seen or {})
        sn = int(seen.get("n", 0))
        if sn + G * A > S:
            raise ValueError(
                f"seen table has {sn} rows + window appends {G * A} "
                f"> capacity {S}; raise seen_cap or shrink the window"
            )
        s1 = np.zeros((S,), np.uint32)
        s2 = np.zeros((S,), np.uint32)
        if sn:
            s1[:sn] = np.asarray(seen["h1"], np.uint32)[:sn]
            s2[:sn] = np.asarray(seen["h2"], np.uint32)[:sn]
        un = (np.zeros((COV_WORDS,), np.uint32) if union is None
              else np.asarray(union, np.uint32))
        if un.shape != (COV_WORDS,):
            raise ValueError(
                f"union bitmap must be [{COV_WORDS}] u32, got {un.shape}"
            )
        gh = np.zeros((A,), np.int32) if gen_h_raw is None else gen_h_raw
        go = np.zeros((A,), np.int32) if gen_origin is None else gen_origin
        i32 = torch.int32

        def full(shape, v=0, dtype=i32):
            return torch.full(shape, v, dtype=dtype, device=dev)

        loop = DevLoop(
            meta_key=t(key_from_seed(int(meta_seed))),
            counter=t(int(meta_counter), i32),
            next_fresh=t(int(next_fresh) & prng.M32),
            gens_done=full(()), target_gens=full((), tg), accepts=full(()),
            ring_n=full((), rn),
            ring_bits=t(buf("bits", (K,), np.int32), i32),
            ring_seed=t(buf("seed", (K,), np.uint32)),
            ring_off=t(buf("off", (K,), np.int32), i32),
            ring_occ=t(buf("occ", (K, n_occ), np.int32), i32),
            ring_rate=t(buf("rate", (K, n_rate), np.float32, fill=1.0),
                        torch.float32),
            ring_h=t(buf("h", (K,), np.int32), i32),
            union=t(un), seen_h1=t(s1), seen_h2=t(s2), seen_n=full((), sn),
            gen_h_raw=t(np.asarray(gh, np.int32), i32),
            gen_origin=t(np.asarray(go, np.int32), i32),
            arch_seed=full((G, A), 0, torch.int64),
            arch_off=full((G, A)), arch_occ=full((G, A, n_occ)),
            arch_rate=full((G, A, n_rate), 1.0, torch.float32),
            arch_h=full((G, A)), arch_origin=full((G, A)),
            arch_violated=full((G, A), False, torch.bool),
            arch_bitmap=full((G, A, COV_WORDS), 0, torch.int64),
            arch_hiwater=full((G, A)), arch_transitions=full((G, A)),
        )
        return state._replace(loop=loop)

    def run_devloop(
        self, state: SimState,
        dispatch_steps: int = DEFAULT_DISPATCH_STEPS,
        total_steps: Optional[int] = None,
    ) -> SimState:
        """Run a device-loop window to its end: `run_state`'s segments of
        the same step as every other mode, the generation boundary firing
        inside the step whenever a generation has retired. The default
        `total_steps` (step_cap * A * G) cannot bind, and the segment loop
        stops once the last generation drains. Decode once with
        `devloop_results`."""
        if state.loop is None:
            raise ValueError("run_devloop needs an init_devloop state")
        A = int(state.queue.seeds.shape[0])
        G = int(state.loop.arch_seed.shape[0])
        if total_steps is None:
            total_steps = int(state.refill.step_cap) * A * G
        return self.run_state(state, total_steps, dispatch_steps)

    # ------------------------------------------------------------ sharding

    def shard_state(self, state: SimState, mesh: Mesh,
                    node_axis: Optional[str] = None) -> ShardedState:
        """Split a plain sweep's lanes over `mesh`: shard d takes the
        contiguous block d of L / mesh.size lanes, copied to
        `mesh.devices[d]`. Lanes are independent, so nothing crosses shards
        until the segment-end gather (`gather_state`). Node-axis sharding
        (the JAX face's 2-D `node_axis` layout, a memory lever that loses
        at every N measured there) is not ported."""
        if node_axis is not None:
            raise _not_ported(
                "node-axis sharding (shard_state(node_axis=...))",
                "item 14b",
            )
        if state.refill is not None or state.loop is not None:
            raise ValueError(
                "shard_state splits a plain sweep's lanes; a sharded refill "
                "sweep starts from init_refill_sharded"
            )
        L, D = int(state.clock.shape[0]), mesh.size
        if L % D:
            raise ValueError(
                f"lane count {L} not divisible by mesh size {D}; pad the "
                "seed batch (run_batch does this automatically)"
            )
        Ld = L // D
        return ShardedState((
            tree_map(lambda x, d=d: x[d * Ld:(d + 1) * Ld].to(
                mesh.devices[d], copy=True), state)
            for d in range(D)
        ), mesh)

    def gather_state(self, state: ShardedState) -> SimState:
        """The segment-end gather: every shard's leaves, concatenated in
        shard (= lane) order on this sim's device."""
        return tree_map(
            lambda *xs: torch.cat([x.to(self.device) for x in xs]),
            *state.shards,
        )

    def init_refill_sharded(
        self, seeds, lanes: int, mesh: Mesh,
        ctl: Optional[TriageCtl] = None, step_cap: int = 100_000,
    ) -> ShardedState:
        """A sharded refill state: the admission list split into
        mesh.size contiguous sub-queues of equal length (the tail padded
        with repeats of the first seed and its ctl row; the pad runs and
        `refill_results_sharded` strips it), shard d the one-device
        `init_refill` of sub-queue d over `lanes` lanes on
        `mesh.devices[d]`. Concatenating the shards' rows in shard order
        restores the global admission (= seed) order."""
        if isinstance(seeds, torch.Tensor):
            seeds = seeds.cpu().numpy()
        seeds = np.asarray(
            list(seeds) if isinstance(seeds, range) else seeds
        ).astype(np.uint32)
        if seeds.ndim != 1 or seeds.shape[0] == 0:
            raise ValueError(
                "init_refill_sharded needs a non-empty 1-D seed array"
            )
        D, A = mesh.size, int(seeds.shape[0])
        Ad = -(-A // D)  # per-shard sub-queue length
        pad = Ad * D - A
        seeds = np.concatenate([seeds, np.repeat(seeds[:1], pad)])
        if ctl is not None:
            if int(ctl.off.shape[0]) != A:
                raise ValueError(
                    f"refill ctl has {int(ctl.off.shape[0])} rows for "
                    f"{A} admissions — one genome per admission"
                )
            ctl = TriageCtl(*(
                torch.cat([x, x[:1].repeat((pad,) + (1,) * (x.dim() - 1))])
                for x in ctl
            ))
        shards = [
            self.on(dev).init_refill(
                seeds[d * Ad:(d + 1) * Ad], lanes,
                None if ctl is None else TriageCtl(
                    *(x[d * Ad:(d + 1) * Ad] for x in ctl)),
                step_cap=step_cap,
            )
            for d, dev in enumerate(mesh.devices)
        ]
        self.dispatch_count += 1  # the put
        return ShardedState(shards, mesh)

    def run_state_sharded(
        self, state: ShardedState, max_steps: int,
        dispatch_steps: int = DEFAULT_DISPATCH_STEPS,
    ) -> ShardedState:
        """run_state's segment loop on every shard, one shard after
        another, each on its device's twin (under that device's context)
        with its own early exit: nothing crosses shards inside a segment.
        The dispatch count grows by the slowest shard's segments, as the
        JAX face counts one sharded program per segment."""
        start, segments, shards = self.dispatch_count, [], []
        for st, dev in zip(state.shards, state.mesh.devices):
            with device_context(dev):
                shards.append(
                    self.on(dev).run_state(st, max_steps, dispatch_steps))
            segments.append(self.dispatch_count - start)
            self.dispatch_count = start
        self.dispatch_count += max(segments)
        return ShardedState(shards, state.mesh)

    def run_refill_sharded(
        self, seeds, lanes: int, mesh: Mesh, max_steps: int = 100_000,
        dispatch_steps: int = DEFAULT_DISPATCH_STEPS,
        ctl: Optional[TriageCtl] = None, total_steps: Optional[int] = None,
    ) -> ShardedState:
        """All `seeds` as admissions of mesh.size independent refill sweeps
        of `lanes` lanes each; decode with `refill_results_sharded(state,
        admissions=len(seeds))`. `max_steps` is the per-admission budget;
        `total_steps` bounds each shard's iterations (default max_steps *
        the sub-queue length, which cannot bind). Every admission's row
        equals run_refill's."""
        state = self.init_refill_sharded(seeds, lanes, mesh, ctl,
                                         step_cap=max_steps)
        if total_steps is None:
            total_steps = int(max_steps) * int(
                state.shards[0].queue.seeds.shape[0])
        return self.run_state_sharded(state, total_steps, dispatch_steps)

    # ------------------------------------------------------------------ run

    def _run(self, state: SimState, max_steps: int) -> SimState:
        """Step until every lane is done or `max_steps` steps ran: the JAX
        face's while-loop, with the all-done flag read every
        DONE_CHECK_STEPS steps (gated steps past it are no-ops). On a CUDA
        sim a full block is one replay of the captured block
        (`_block_graph`) and a shorter tail runs eagerly; refill and
        device-loop states, whose steps read the host, always run eagerly.
        The returned state never aliases the graph's buffers."""
        captured = (
            self.device.type == "cuda" and not self._eager_run
            and state.refill is None and state.loop is None
        )
        graph = static = None
        i = 0
        while i < max_steps:
            k = min(DONE_CHECK_STEPS, max_steps - i)
            if captured and k == DONE_CHECK_STEPS:
                if graph is None:
                    graph, static = self._block_graph(state)
                    for dst, src in zip(tree_leaves(static),
                                        tree_leaves(state)):
                        dst.copy_(src)
                graph.replay()
                state = static
            else:
                for _ in range(k):
                    state = self._step(state, gate_key=True)
            i += k
            if bool(state.done.all()):
                break
        if graph is not None:
            # a later run replays into `static`; an eager tail's pass-through
            # leaves are static's own tensors
            state = tree_map(torch.clone, state)
        return state

    def _block_graph(self, state: SimState):
        """(CUDAGraph, static state) of DONE_CHECK_STEPS gated steps over
        `state`'s layout: the graph reads the static state and writes the
        last step's leaves back into it, so replays chain on the card. It
        is captured once per layout (leaf shapes and dtypes, which planes
        are present) and deterministic-mode setting, after a warm-up on a
        side stream; a failed capture raises."""
        import torch.utils.deterministic as tdet

        key = (_layout(state), torch.are_deterministic_algorithms_enabled(),
               tdet.fill_uninitialized_memory)
        if self._graph is not None and self._graph[0] == key:
            return self._graph[1], self._graph[2]
        with _CAPTURE_LOCK:
            return self._capture(state, key)

    def _capture(self, state: SimState, key):
        """`_block_graph`'s capture, one at a time in the process (the
        capture lock): on a stream of its own in the thread-local error
        mode, so other threads' CUDA work (serve's slice lanes) may run
        beside it, while the collector switch and
        `torch.cuda.graph`'s device-wide synchronize never overlap another
        capture."""
        import gc

        self._graph = None  # release the previous layout's pool first
        static = tree_map(torch.clone, state)
        dev_stream = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(device=self.device)
        side.wait_stream(dev_stream)
        with torch.cuda.stream(side):
            warm = static
            for _ in range(2):
                warm = self._step(warm, gate_key=True)
            del warm
        dev_stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a dead sim (a sim is a reference cycle) collected mid-capture
        # would free its graph inside this capture, which CUDA refuses and
        # which ends the capture: no cyclic collection while capturing
        gc_on = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                out = static
                for _ in range(DONE_CHECK_STEPS):
                    out = self._step(out, gate_key=True)
                if _layout(out) != key[0]:
                    raise RuntimeError(
                        "the captured step changed the state's layout"
                    )
                dst_leaves = tree_leaves(static)
                held = {t.untyped_storage().data_ptr() for t in dst_leaves}
                # an output that views a static buffer other than its own
                # is copied out before any write-back
                src_leaves = [
                    s if s is d or s.untyped_storage().data_ptr() not in held
                    else s.clone()
                    for d, s in zip(dst_leaves, tree_leaves(out))
                ]
                for d, s in zip(dst_leaves, src_leaves):
                    if s is not d:
                        d.copy_(s)
                del out, src_leaves
        finally:
            if gc_on:
                gc.enable()
        self._graph = (key, graph, static)
        return graph, static

    def run(
        self, seeds, max_steps: int = 100_000,
        dispatch_steps: int = DEFAULT_DISPATCH_STEPS,
        ctl: Optional[TriageCtl] = None, mesh: Optional[Mesh] = None,
    ) -> SimState:
        """Run lanes until every lane is done (or max_steps). `ctl` gives
        a triage sim's lanes their shrink controls. With `mesh`, the lanes
        split over its shards (`shard_state`; the lane count must divide
        evenly), each shard runs the segment loop on its device, and the
        result is gathered in lane order onto this sim's device: leaf for
        leaf the unsharded run, since no draw folds the lane index."""
        if dispatch_steps <= 0:
            raise ValueError(
                f"dispatch_steps must be positive, got {dispatch_steps}"
            )
        state = self.init(seeds, ctl)
        self.dispatch_count += 1
        if mesh is None:
            return self.run_state(state, max_steps, dispatch_steps)
        sharded = self.shard_state(state, mesh)
        del state
        self.dispatch_count += 1  # the put
        return self.gather_state(
            self.run_state_sharded(sharded, max_steps, dispatch_steps))

    def run_state(
        self, state: SimState, max_steps: int,
        dispatch_steps: int = DEFAULT_DISPATCH_STEPS,
    ) -> SimState:
        """run()'s segment loop on a pre-built state: segments of
        `dispatch_steps`, stopping once every lane is done. The result
        equals one loop of `max_steps` (the JAX face's semantics)."""
        if dispatch_steps <= 0:
            raise ValueError(
                f"dispatch_steps must be positive, got {dispatch_steps}"
            )
        remaining = max_steps
        while remaining > 0:
            n = min(dispatch_steps, remaining)
            state = self._run(state, n)
            self.dispatch_count += 1
            remaining -= n
            if bool(state.done.all()):
                break
        return state

    def run_steps(self, state: SimState, n_steps: int) -> SimState:
        """Exactly `n_steps` ungated steps (the JAX face's fixed-step scan:
        `key` keeps advancing after every lane is done)."""
        for _ in range(n_steps):
            state = self._step(state)
        return state

    def run_traced(
        self, seed: int, max_steps: int = 20_000,
        ctl: Optional[TriageCtl] = None,
    ):
        """Re-run one seed with full event capture (the violation
        microscope): (final state, TraceRecord with [T, 1, ...] leaves) of
        exactly T = max_steps ungated steps, the JAX face's traced scan.
        The records come out of the same step a sweep runs, so the traced
        lane is the batch lane's trajectory. `ctl` (triage sims) traces a
        shrunk candidate."""
        state = self.init([seed], ctl)
        self.dispatch_count += 2  # init + the traced scan
        recs = []
        while len(recs) < max_steps:
            state, rec = self._step(state, record=True)
            recs.append(rec)
            if len(recs) % DONE_CHECK_STEPS == 0 and bool(state.done.all()):
                break
        if len(recs) < max_steps:
            state, tail = self._idle_steps(state, max_steps - len(recs))
            recs.extend(tail)
        return state, TraceRecord(*(
            None if leaves[0] is None else torch.cat(
                [x.reshape((-1, state.clock.shape[0]) + x.shape[1:])
                 for x in leaves]
            )
            for leaves in zip(*recs)
        ))

    def _idle_steps(self, state: SimState, n: int):
        """`n` more ungated steps of a state whose lanes are all done, as
        (final state, list of [R, L, ...] records). Such a step changes
        `key` alone (key' = fold(key, 1)) and its record depends on the
        state and that key only, and lanes never interact, so R such steps
        run as ONE step of R*L lanes: lane block j holds the state under
        the key of idle step j. Same step, same records, R times fewer
        launches."""
        L = state.clock.shape[0]
        keys = [int(k) for k in state.key.cpu().tolist()]
        recs = []
        left = n
        while left > 0:
            R = min(left, IDLE_BLOCK_STEPS.get(self.device.type,
                                               IDLE_BLOCK_STEPS_DEFAULT))
            block = []  # [R, L] key chain of these steps
            for _ in range(R):
                block.append(keys)
                keys = [fold32(k, 1) for k in keys]
            rep_state = tree_map(
                lambda t: t.repeat((R,) + (1,) * (t.dim() - 1)), state
            )._replace(key=torch.as_tensor(
                np.asarray(block, np.int64).reshape(R * L),
                device=self.device,
            ))
            _, rec = self._step(rep_state, record=True)
            recs.append(rec)
            left -= R
        return state._replace(key=torch.as_tensor(
            np.asarray(keys, np.int64), device=self.device
        )), recs


# one CUDA graph capture at a time in the process (`BatchedSim._capture`)
_CAPTURE_LOCK = threading.Lock()


def _layout(tree):
    """The structure of a state: None, a tuple of its fields' layouts, or a
    tensor's (shape, dtype)."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        return tuple(_layout(x) for x in tree)
    return (tuple(tree.shape), tree.dtype)


def abs_time_us(state: SimState) -> np.ndarray:
    """Absolute virtual time per lane as int64 numpy (epoch * REBASE + off)."""
    return (
        state.epoch.cpu().numpy().astype(np.int64) * REBASE_US
        + state.clock.cpu().numpy().astype(np.int64)
    )


def _sum64(x: torch.Tensor, axis=0):
    """Exact lane sum of a non-negative i32 tensor as two u32 partials
    (16-bit halves), the JAX face's reduction; both partials stay below
    2^32 only for lanes <= 65536, so a bigger batch is refused."""
    if x.shape[axis] > 65536:
        raise ValueError(
            f"_sum64: lane axis {x.shape[axis]} > 65536 would overflow "
            "the u32 partial sums — summarize in chunks"
        )
    xu = prng.u32(x)
    return (
        torch.sum(xu >> 16, dim=axis),
        torch.sum(xu & 0xFFFF, dim=axis),
    )


def _join64(hi, lo) -> int:
    return int(
        np.asarray(hi.cpu() if isinstance(hi, torch.Tensor) else hi, np.int64)
        * 65536
        + np.asarray(lo.cpu() if isinstance(lo, torch.Tensor) else lo, np.int64)
    )


def _summary_reduction(state: SimState) -> dict:
    """Every per-summary reduction, on the device."""
    violated = state.violated
    out = {
        "violations": violated.sum(),
        "deadlocked": state.deadlocked.sum(),
        "events64": _sum64(state.events),
        "overflow64": _sum64(state.overflow),
        "dead_drops64": _sum64(state.dead_drops),
        "nonmember_drops64": _sum64(state.nonmember_drops),
        "unsynced_loss64": _sum64(state.unsynced_loss),
        "steps64": _sum64(state.steps),
        "epoch64": _sum64(state.epoch),
        "clock64": _sum64(state.clock),
        "first_violation_step": torch.where(
            violated, state.violation_step, 2**31 - 1
        ).amin(),
        "fires64": _sum64(state.fires, axis=0),
        # per-(clause row, occurrence bit) lane counts [R, 32]
        "occ_counts": None if state.occ_fired is None else (
            (state.occ_fired[:, :, None] >> torch.arange(
                32, device=state.occ_fired.device
            )) & 1
        ).sum(dim=0),
    }
    if state.cov is not None:
        out["cov_union"] = _or_rows(state.cov.bitmap)  # [COV_WORDS]
        out["cov_union_bits"] = popcount(out["cov_union"]).sum()
        out["cov_hiwater"] = state.cov.hiwater.amax()
        out["cov_transitions64"] = _sum64(state.cov.transitions)
    return out


def summarize(state: SimState, spec: Optional[ProtocolSpec] = None) -> dict:
    """Host-side summary of a finished batch; the JAX face's keys and
    values. Pass the spec to include its `lane_metrics` diagnostics."""
    red = _summary_reduction(state)
    violated = state.violated.cpu().numpy()
    L = int(violated.shape[0])
    steps_total = _join64(*red["steps64"])
    vt_total_us = (
        _join64(*red["epoch64"]) * REBASE_US + _join64(*red["clock64"])
    )
    out = {
        "lanes": L,
        "violations": int(red["violations"]),
        "violation_lanes": np.nonzero(violated)[0].tolist()[:32],
        "deadlocked": int(red["deadlocked"]),
        "total_events": _join64(*red["events64"]),
        "total_overflow": _join64(*red["overflow64"]),
        "total_dead_drops": _join64(*red["dead_drops64"]),
        "total_nonmember_drops": _join64(*red["nonmember_drops64"]),
        "total_unsynced_loss": _join64(*red["unsynced_loss64"]),
        "mean_steps": steps_total / L,
        "mean_virtual_secs": vt_total_us / L / 1e6,
    }
    if out["violations"]:
        out["first_violation_step"] = int(red["first_violation_step"])
    f_hi, f_lo = red["fires64"]
    f_hi = f_hi.cpu().numpy().astype(np.int64)
    f_lo = f_lo.cpu().numpy().astype(np.int64)
    for i, name in enumerate(FIRE_KINDS):
        out[f"fires_{name}"] = int(f_hi[i] * 65536 + f_lo[i])
    # per-occurrence fire counts (nemesis schedule clauses only): lanes in
    # which occurrence k of the clause applied
    if red["occ_counts"] is not None:
        occ_counts = red["occ_counts"].cpu().numpy()
        for row, clause in enumerate(OCC_CLAUSES):
            for k in range(32):
                n = int(occ_counts[row, k])
                if n:
                    out[f"occfires_{clause}_k{k}"] = n
    if state.cov is not None:
        out["coverage_bits"] = int(red["cov_union_bits"])
        out["coverage_hiwater"] = int(red["cov_hiwater"])
        out["coverage_transitions"] = _join64(*red["cov_transitions64"])
    if spec is not None and spec.lane_metrics is not None:
        for name, arr in spec.lane_metrics(state.node).items():
            a = arr.cpu().numpy()
            if a.dtype == np.bool_:
                out[name] = int(a.sum())
            else:
                out[name] = float(a.mean())
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def refill_results(state: SimState) -> dict:
    """Decode a finished refill sweep into per-admission numpy rows, in
    admission (= seed) order, so they compare row for row with a chunked
    sweep's lanes. Admissions still live when the sweep's step budget ran
    out are harvested here from their lane's final state (the chunked
    path's truncation). Also the lane occupancy: busy lane-steps / lane-
    steps. The JAX face's keys and dtypes (u32 bitmaps and occurrence
    words)."""
    if isinstance(state, ShardedState):
        raise ValueError(
            "state is sharded (run_refill_sharded) — decode it with "
            "refill_results_sharded"
        )
    rf = state.refill
    if rf is None:
        raise ValueError("refill_results needs a run_refill final state")
    out = {}
    for f in ("retired",) + _HARVEST + ("occ_fired", "cov_bitmap",
                                        "cov_hiwater", "cov_transitions"):
        v = getattr(rf, f)
        # copies: the final harvest below writes rows in place
        out[f] = None if v is None else (
            _np(v).astype(np.uint32) if f in ("occ_fired", "cov_bitmap")
            else _np(v).copy()
        )
    live = ~_np(state.done)
    li = _np(rf.admitted)[live]
    if li.size:
        for f, src in _harvest_sources(state).items():
            out[f][li] = _np(src)[live]
    iters = int(rf.iters)
    busy = int(_np(rf.busy).astype(np.int64).sum())
    L = int(rf.busy.shape[0])
    out.update(
        admissions=int(out["violated"].shape[0]), lanes=L, iters=iters,
        busy_lane_steps=busy, total_lane_steps=iters * L,
        occupancy=busy / max(iters * L, 1), truncated=int(live.sum()),
    )
    return out


def refill_results_sharded(state: ShardedState,
                           admissions: Optional[int] = None) -> dict:
    """Decode a finished sharded refill sweep (run_refill_sharded) into
    `refill_results`'s per-admission rows, in global admission (= seed)
    order: shard d's rows are sub-queue d's, concatenated in shard order
    and stripped of the tail pad (`admissions` = the un-padded seed
    count). This is the segment-end gather: each shard's rows are a
    one-device refill of its sub-queue. `truncated` counts the stripped
    rows that never retired; occupancy comes back aggregate and per shard
    (`per_device`: busy lane-steps over the shard's own iterations), and
    `lane_steps_per_iter` is the busy lane-steps over the slowest shard's
    iterations (one shard caps at `lanes`, D shards at D * lanes)."""
    if not isinstance(state, ShardedState):
        if getattr(state, "refill", None) is None:
            raise ValueError(
                "refill_results_sharded needs a run_refill_sharded final "
                "state"
            )
        raise ValueError(
            "state has no leading device axis — use refill_results for "
            "single-device refill sweeps"
        )
    if any(s.refill is None for s in state.shards):
        raise ValueError(
            "refill_results_sharded needs a run_refill_sharded final state"
        )
    per = [refill_results(s) for s in state.shards]
    out: dict = {}
    for f in ("retired",) + _HARVEST + ("occ_fired", "cov_bitmap",
                                        "cov_hiwater", "cov_transitions"):
        if per[0][f] is None:
            out[f] = None
            continue
        rows = np.concatenate([p[f] for p in per])
        out[f] = rows if admissions is None else rows[:admissions]
    D = len(per)
    iters = [p["iters"] for p in per]
    busy = [p["busy_lane_steps"] for p in per]
    total = [p["total_lane_steps"] for p in per]
    out.update(
        admissions=int(out["violated"].shape[0]), lanes=per[0]["lanes"],
        devices=D, iters=max(iters), busy_lane_steps=sum(busy),
        total_lane_steps=sum(total),
        occupancy=sum(busy) / max(sum(total), 1),
        # from the stripped rows: a truncated admission never retired, so
        # its row is still -1 (the per-shard counts include the pad)
        truncated=int((out["retired"] == -1).sum()),
        per_device=[
            {"iters": iters[d], "busy_lane_steps": busy[d],
             "total_lane_steps": total[d],
             "occupancy": busy[d] / max(total[d], 1)}
            for d in range(D)
        ],
        lane_steps_per_iter=sum(busy) / max(max(iters), 1),
    )
    return out


def devloop_results(state: SimState) -> dict:
    """Decode a finished device-loop window, the window's one read of the
    search state: the cursors (meta counter, next_fresh, seen_n), the
    corpus ring and the coverage union as upload-ready dicts (they feed
    `init_devloop` of the next window), and one dict per generation run
    with its archived genomes and per-admission results in admission
    order, which the host `Explorer` folds to rebuild its corpus. Arrays
    come out in the JAX face's dtypes (u32 values as uint32)."""
    dl = state.loop
    if dl is None:
        raise ValueError("devloop_results needs a run_devloop final state")
    rf = state.refill

    def arr(x):
        a = x.detach().cpu().numpy()
        return a.astype(np.uint32) if a.dtype == np.int64 else a

    rn = int(dl.ring_n)
    gens_done = int(dl.gens_done)
    out = {
        "gens_done": gens_done,
        "target_gens": int(dl.target_gens),
        "counter": int(dl.counter),
        "next_fresh": int(dl.next_fresh),
        "accepts": int(dl.accepts),
        "seen_n": int(dl.seen_n),
        "union": arr(dl.union),
        "ring": {
            "n": rn,
            **{f: arr(getattr(dl, "ring_" + f))[:rn]
               for f in ("bits", "seed", "off", "occ", "rate", "h")},
        },
        "iters": int(rf.iters),
        "busy_lane_steps": int(rf.busy.to(torch.int64).sum()),
    }
    arch = {
        f: arr(getattr(dl, "arch_" + f))
        for f in ("seed", "off", "occ", "rate", "h", "origin", "violated",
                  "bitmap", "hiwater", "transitions")
    }
    out["gens"] = [
        {f: a[g] for f, a in arch.items()} for g in range(gens_done)
    ]
    return out


def summarize_refill(res: dict) -> dict:
    """summarize()'s keys over `refill_results` rows, aggregated over
    admissions (lane_metrics need final node state, which a refilled lane
    no longer holds)."""
    A = int(res["admissions"])
    violated = res["violated"]

    def total(f):
        return int(res[f].astype(np.int64).sum())

    out = {
        "lanes": A,
        "violations": int(violated.sum()),
        "violation_lanes": np.nonzero(violated)[0].tolist()[:32],
        "deadlocked": int(res["deadlocked"].sum()),
        "total_events": total("events"),
        "total_overflow": total("overflow"),
        "total_dead_drops": total("dead_drops"),
        "total_nonmember_drops": total("nonmember_drops"),
        "total_unsynced_loss": total("unsynced_loss"),
        "mean_steps": total("steps") / A,
        "mean_virtual_secs": (
            total("epoch") * REBASE_US + total("clock")
        ) / A / 1e6,
        "occupancy": round(float(res["occupancy"]), 4),
    }
    if out["violations"]:
        out["first_violation_step"] = int(
            res["violation_step"][violated].min()
        )
    fires = res["fires"].astype(np.int64).sum(axis=0)
    for i, name in enumerate(FIRE_KINDS):
        out[f"fires_{name}"] = int(fires[i])
    if res.get("occ_fired") is not None:
        occ_counts = ((
            res["occ_fired"][:, :, None]
            >> np.arange(32, dtype=np.uint32)[None, None, :]
        ) & np.uint32(1)).sum(axis=0)
        for row, clause in enumerate(OCC_CLAUSES):
            for k in range(32):
                n = int(occ_counts[row, k])
                if n:
                    out[f"occfires_{clause}_k{k}"] = n
    if res.get("cov_bitmap") is not None:
        union = np.bitwise_or.reduce(res["cov_bitmap"], axis=0)
        out["coverage_bits"] = int(np.unpackbits(union.view(np.uint8)).sum())
        out["coverage_hiwater"] = int(res["cov_hiwater"].max())
        out["coverage_transitions"] = total("cov_transitions")
    return out
