"""Two-phase commit as [L, N]-batched PyTorch handlers.

The port of `madsim_tpu/tpu/twopc.py`: node 0 is the coordinator, nodes
1..N-1 participants, running one-shot atomic-commit rounds with presumed
abort and cooperative termination. The coordinator's timer starts a
transaction (broadcast PREPARE) or presumed-aborts an open one;
participants vote (a seeded coin per (lane, node, tid)) and record the
vote durably; the coordinator decides on the first NO or on all YES and
broadcasts OUTCOME; in-doubt participants ask (DREQ) for the outcome of
their oldest unresolved yes-vote. Outcomes and votes live in rings keyed
by absolute tid.

Safety invariants per lane: atomicity (no two nodes record different
outcomes for one tid) and vote respect (no node records COMMIT for a tid
it voted NO on).

One fused handler, every expression the JAX face's over explicit leading
[L, N] axes (tests/test_torch_kv.py holds both faces equal).
`unilateral_abort_spec` is the planted participant of the repo's
heavy-tail test (tests/test_buggify.py): it replaces `on_timer` through
`replace_handlers`, so the engine runs it on the two-handler path.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .spec import (
    Outbox, ProtocolSpec, RateFloor, SimConfig, bit, replace_handlers,
    stack_fields, wraps_event,
)

NONE, COMMIT, ABORT = 0, 1, 2
PREPARE, VOTE, OUTCOME, DREQ = 0, 1, 2, 3
PAYLOAD_WIDTH = 3  # (tid, flag, spare)


class TpcState(NamedTuple):
    """Per-node 2PC state, int32 leaves [L, N] or [L, N, TXN]."""

    tid_cur: torch.Tensor  # coordinator: last txn started (durable)
    vote_mask: torch.Tensor  # coordinator: yes-voter bitmask (volatile)
    o_tid: torch.Tensor  # [TXN] outcome ring, absolute tid, -1 empty
    o_val: torch.Tensor  # [TXN] COMMIT/ABORT (durable)
    v_tid: torch.Tensor  # [TXN] own-vote ring, absolute tid, -1 empty
    v_val: torch.Tensor  # [TXN] COMMIT(yes)/ABORT(no) (durable)
    decided: torch.Tensor  # outcomes recorded (diagnostics)


def make_twopc_spec(
    n_nodes: int = 5,
    txn_ring: int = 16,
    txn_gap_us: int = 40_000,
    prepare_timeout_us: int = 120_000,
    doubt_retry_us: int = 80_000,
    vote_yes_p: float = 0.85,
) -> ProtocolSpec:
    """The JAX face's make_twopc_spec, same parameters and draws."""
    N, TXN = n_nodes, txn_ring
    assert N >= 3
    i32 = torch.int32
    ALL_YES = (1 << N) - 2  # bits 1..N-1
    IDLE_FAR = 2**28  # "unarmed" participant timer offset
    yes_p = prng.f32(vote_yes_p)

    def tidx_of(like):
        return torch.arange(TXN, dtype=i32, device=like.device)

    def record_outcome(s: TpcState, do, tid, outcome):
        """Claim slot tid % TXN for (tid, outcome) where `do`; the first
        write for a tid wins, and a tid TXN or more behind the newest
        recorded one is dropped."""
        at = tidx_of(tid) == torch.remainder(tid, TXN)[..., None]
        not_stale = tid > s.o_tid.amax(dim=-1) - TXN
        fresh = do & not_stale & ~(at & (s.o_tid == tid[..., None])).any(-1)
        w = at & fresh[..., None]
        return s._replace(
            o_tid=torch.where(w, tid[..., None], s.o_tid),
            o_val=torch.where(w, outcome[..., None], s.o_val),
            decided=s.decided + fresh.to(i32),
        )

    def record_vote(s: TpcState, do, tid, vote):
        w = do[..., None] & (
            tidx_of(tid) == torch.remainder(tid, TXN)[..., None]
        )
        return s._replace(
            v_tid=torch.where(w, tid[..., None], s.v_tid),
            v_val=torch.where(w, vote[..., None], s.v_val),
        )

    def outcome_of(s: TpcState, tid):
        """Recorded outcome for absolute tid, NONE if absent."""
        hit = (tidx_of(tid) == torch.remainder(tid, TXN)[..., None]) & (
            s.o_tid == tid[..., None]
        )
        return torch.where(hit, s.o_val, 0).sum(dim=-1, dtype=i32)

    def unresolved_yes(s: TpcState):
        """[..., TXN]: yes-votes with no recorded outcome for their tid."""
        voted_yes = (s.v_tid >= 0) & (s.v_val == COMMIT)
        resolved = (s.v_tid == s.o_tid) & (s.o_tid >= 0)
        return voted_yes & ~resolved

    # ------------------------------------------------------------------ init

    def init(key, nid):
        L = key.shape[0]

        def full(v, shape=()):
            return torch.full((L, N) + shape, v, dtype=i32, device=key.device)

        state = TpcState(
            tid_cur=full(-1), vote_mask=full(0),
            o_tid=full(-1, (TXN,)), o_val=full(0, (TXN,)),
            v_tid=full(-1, (TXN,)), v_val=full(0, (TXN,)),
            decided=full(0),
        )
        first = torch.where(
            nid == 0, prng.randint(key, 31, 1_000, txn_gap_us), IDLE_FAR
        )
        return state, first

    # ----------------------------------------------------------- fused event

    def on_event(s: TpcState, nid, src, kind, payload, now, key):
        """All events, PREPARE/VOTE/OUTCOME/DREQ and the timer tick
        (kind == -1), as one masked handler."""
        peers = torch.arange(N, dtype=i32, device=nid.device)
        tidx = tidx_of(nid)
        f = payload
        is_timer = kind == -1
        is_coord = nid == 0
        tid_msg = f[..., 0]
        flag = f[..., 1]
        out_msg = outcome_of(s, tid_msg)

        # ====================== timer path (kind == -1) ===================
        # coordinator: an open undecided txn is presumed-aborted (prepare
        # deadline passed, or post-restart recovery); else start the next
        open_undecided = (s.tid_cur >= 0) & (outcome_of(s, s.tid_cur) == NONE)
        do_abort = is_timer & is_coord & open_undecided
        do_start = is_timer & is_coord & ~open_undecided
        new_tid = s.tid_cur + 1
        # participant: cooperative termination for the oldest in-doubt vote
        doubt = unresolved_yes(s)
        in_doubt = (~is_coord) & doubt.any(-1)
        dreq_tid = torch.where(doubt, s.v_tid, 2**30).amin(dim=-1)
        do_dreq_send = is_timer & in_doubt

        # ====================== message path (kind >= 0) ==================
        is_prep = kind == PREPARE
        is_vote = kind == VOTE
        is_outc = kind == OUTCOME
        is_dreq = kind == DREQ

        # -- PREPARE: a re-PREPARE of a decided or already-voted txn must
        # not re-roll the vote
        voted = (
            (tidx == torch.remainder(tid_msg, TXN)[..., None])
            & (s.v_tid == tid_msg[..., None])
        ).any(-1)
        do_prep = is_prep & (nid != 0) & ~((out_msg != NONE) | voted)
        yes = prng.uniform(prng.fold(key, tid_msg), 33) < yes_p
        vote_flag = torch.where(yes, COMMIT, ABORT).to(i32)

        # -- VOTE: any NO => ABORT, all N-1 YES => COMMIT
        live = (
            is_vote & is_coord & (tid_msg == s.tid_cur) & (out_msg == NONE)
        )
        no = live & (flag == ABORT)
        mask = torch.where(
            live & (flag == COMMIT), s.vote_mask | bit(src), s.vote_mask
        )
        all_yes = live & (mask == ALL_YES)
        decide = no | all_yes

        # -- DREQ: re-send a recorded outcome (silent while undecided)
        have = is_dreq & is_coord & (out_msg != NONE)

        # -- one ring pass for every outcome write (masks are exclusive)
        rec_do = do_abort | (do_prep & ~yes) | decide | is_outc
        rec_tid = torch.where(do_abort, s.tid_cur, tid_msg)
        rec_val = torch.where(
            do_abort | (do_prep & ~yes) | no, ABORT,
            torch.where(all_yes, COMMIT, flag),
        )
        state = s._replace(
            tid_cur=torch.where(do_start, new_tid, s.tid_cur),
            vote_mask=torch.where(do_start | do_abort | decide, 0, mask),
        )
        state = record_vote(state, do_prep, tid_msg, vote_flag)
        state = record_outcome(state, rec_do, rec_tid, rec_val)

        # ================== merged outbox (E = N rows) ====================
        # broadcasts (coordinator): presumed-abort OUTCOME, next PREPARE,
        # decide OUTCOME. Single-message events use outbox row dst.
        bcast = do_abort | do_start | decide
        bc_kind = torch.where(do_start, PREPARE, OUTCOME).to(i32)
        bc_tid = torch.where(
            do_abort, s.tid_cur, torch.where(do_start, new_tid, tid_msg)
        )
        bc_flag = torch.where(
            do_start, 0, torch.where(do_abort | no, ABORT, COMMIT)
        ).to(i32)
        single = do_prep | have | do_dreq_send
        s_dst = torch.where(do_dreq_send, 0, src)
        s_kind = torch.where(
            do_prep, VOTE, torch.where(have, OUTCOME, DREQ)
        ).to(i32)
        s_tid = torch.where(do_dreq_send, dreq_tid, tid_msg)
        s_flag = torch.where(
            do_prep, vote_flag, torch.where(have, out_msg, 0)
        )
        at_row = peers == s_dst[..., None]  # [L,N,N]
        bcx = bcast[..., None]
        out = Outbox(
            valid=torch.where(bcx, peers != 0, single[..., None] & at_row),
            dst=torch.where(
                bcx, peers,
                torch.where(single, s_dst, 0)[..., None].expand(at_row.shape),
            ),
            kind=torch.where(
                bcast, bc_kind, torch.where(single, s_kind, 0)
            )[..., None].expand(at_row.shape),
            payload=torch.where(
                bcx[..., None],
                stack_fields(bc_tid, bc_flag, 0)[..., None, :],
                torch.where(
                    (single[..., None] & at_row)[..., None],
                    stack_fields(s_tid, s_flag, 0)[..., None, :], 0,
                ),
            ),
        )

        # -- timers: the coordinator re-arms every tick; a yes-voting
        # participant arms its in-doubt retry; a deciding coordinator
        # schedules the next round; everything else keeps its deadline
        timer_t = torch.where(
            is_coord,
            torch.where(
                do_start,
                now + prepare_timeout_us,
                now + prng.randint(key, 32, txn_gap_us // 2, txn_gap_us),
            ),
            now + torch.where(in_doubt, doubt_retry_us, IDLE_FAR),
        )
        timer_m = torch.where(
            do_prep & yes,
            now + doubt_retry_us,
            torch.where(
                decide,
                now + prng.randint(key, 34, txn_gap_us // 2, txn_gap_us),
                -1,
            ),
        )
        return state, out, torch.where(is_timer, timer_t, timer_m)

    @wraps_event(on_event)
    def on_message(s: TpcState, nid, src, kind, payload, now, key):
        return on_event(s, nid, src, kind, payload, now, key)

    @wraps_event(on_event)
    def on_timer(s: TpcState, nid, now, key):
        z = torch.zeros_like(now)
        return on_event(
            s, nid, z, z - 1,
            torch.zeros(now.shape + (PAYLOAD_WIDTH,), dtype=i32,
                        device=now.device),
            now, key,
        )

    # --------------------------------------------------------------- restart

    def on_restart(s: TpcState, nid, now, key):
        """`now` is per lane [L]."""
        state = s._replace(vote_mask=torch.zeros_like(s.vote_mask))
        now_n = now[:, None]
        first = torch.where(
            nid == 0,
            # fire soon: an open undecided tid_cur gets presumed-aborted
            now_n + prng.randint(key, 35, 1_000, txn_gap_us),
            now_n + torch.where(
                unresolved_yes(s).any(-1), doubt_retry_us, IDLE_FAR
            ),
        )
        return state, first

    # ------------------------------------------------------------ invariants

    def check_invariants(ns: TpcState, alive, now):
        """ok [L]: atomicity and vote respect (slot-aligned joins)."""
        ot, ov = ns.o_tid, ns.o_val  # [L,N,TXN]
        same_tid = (ot[:, :, None, :] == ot[:, None, :, :]) & (
            ot[:, :, None, :] >= 0
        )
        diff_out = ov[:, :, None, :] != ov[:, None, :, :]
        atomicity = ~(same_tid & diff_out).flatten(1).any(1)
        joined = (
            (ns.o_tid == ns.v_tid)
            & (ns.o_tid >= 0)
            & (ns.o_val == COMMIT)
            & (ns.v_val == ABORT)
        )
        return atomicity & ~joined.flatten(1).any(1)

    # ------------------------------------------------------------ diagnostics

    def lane_metrics(node):
        voted_yes = (node.v_tid >= 0) & (node.v_val == COMMIT)  # [L,N,TXN]
        resolved = (
            (node.v_tid[..., :, None] == node.o_tid[..., None, :])
            & (node.o_tid[..., None, :] >= 0)
        ).any(-1)
        return {
            "mean_decided_txns": node.decided[:, 0].to(torch.float32),
            "in_doubt_lanes": (
                voted_yes[:, 1:] & ~resolved[:, 1:]
            ).flatten(1).any(1),
        }

    return ProtocolSpec(
        name=f"twopc{N}",
        n_nodes=N,
        payload_width=PAYLOAD_WIDTH,
        max_out=N,
        max_out_msg=N,  # a VOTE receipt can broadcast the OUTCOME
        init=init,
        on_message=on_message,
        on_timer=on_timer,
        on_event=on_event,
        on_restart=on_restart,
        check_invariants=check_invariants,
        lane_metrics=lane_metrics,
        msg_kind_names=("PREPARE", "VOTE", "OUTCOME", "DREQ"),
        # the JAX face's storage narrowing table (this face stores wide);
        # it drives the narrow_horizon_us refusal below
        narrow_fields={
            **({"vote_mask": np.uint8} if N <= 8 else
               {"vote_mask": np.uint16} if N <= 16 else {}),
            "o_val": np.uint8,
            "v_val": np.uint8,
            "tid_cur": np.int16,
            "o_tid": np.int16,
            "v_tid": np.int16,
        },
        # i16 tids hold while mints are >= 1 ms apart: every coordinator
        # re-arm draws >= 1_000 us
        narrow_horizon_us=32_767 * 1_000,
        rate_floors={
            f: RateFloor(
                floor_us=1_000, ratchet=1,
                why="a mint needs a coordinator timer fire; every re-arm "
                "(init, post-start, retry, restart) draws >= 1_000 us",
            )
            for f in ("tid_cur", "o_tid", "v_tid")
        },
    )


def unilateral_abort_spec(n_nodes: int = 5) -> ProtocolSpec:
    """The canonical wrong 2PC participant: when its in-doubt retry timer
    fires for its newest vote, it records a local ABORT for the oldest
    unresolved yes-vote instead of asking the coordinator (and sends no
    DREQ). Safe under millisecond latencies; an OUTCOME riding the
    heavy-tail straggler pool exposes it. The same handler, over [L, N]
    axes, as tests/test_buggify.py's JAX spec."""
    spec = make_twopc_spec(n_nodes)
    inner = spec.on_timer
    i32 = torch.int32

    def on_timer(s: TpcState, nid, now, key):
        state, out, timer = inner(s, nid, now, key)
        voted_yes = (s.v_tid >= 0) & (s.v_val == COMMIT)
        resolved = (s.v_tid == s.o_tid) & (s.o_tid >= 0)
        doubt = voted_yes & ~resolved
        dreq_tid = torch.where(doubt, s.v_tid, 2**30).amin(-1)
        # only the newest vote counts as timed out (ring-recycled ancient
        # doubts would fire it at any latency)
        in_doubt = (nid != 0) & doubt.any(-1) & (
            dreq_tid == s.v_tid.amax(-1)
        )
        TXN = s.o_tid.shape[-1]
        at = torch.arange(TXN, dtype=i32, device=nid.device) == (
            torch.remainder(dreq_tid, TXN)[..., None]
        )
        fresh = in_doubt & ~(at & (s.o_tid == dreq_tid[..., None])).any(-1)
        w = at & fresh[..., None]
        state = state._replace(
            o_tid=torch.where(w, dreq_tid[..., None], state.o_tid),
            o_val=torch.where(w, ABORT, state.o_val),
        )
        # suppress the DREQ it would have sent (participants only)
        out = out._replace(valid=out.valid & ~in_doubt[..., None])
        return state, out, timer

    return replace_handlers(spec, on_timer=on_timer)


def twopc_workload(
    n_nodes: int = 5,
    virtual_secs: float = 10.0,
    loss_rate: float = 0.1,
    spec: "ProtocolSpec | None" = None,
):
    """The 2PC atomicity fuzz under loss, coordinator crashes and
    partitions (the JAX face's config). A violating seed gets both
    microscopes: the device trace and the host twin
    (workloads/twopc_host.py, verified by the same atomicity + vote-respect
    oracle) through `host_repro`."""
    from ..workloads import twopc_host
    from .batch import BatchWorkload, twin_repro

    host_repro = twin_repro(
        twopc_host.fuzz_one_seed, twopc_host.InvariantViolation,
        n_nodes=n_nodes, virtual_secs=virtual_secs,
        loss_rate=loss_rate,
    )

    cfg = SimConfig(
        horizon_us=int(virtual_secs * 1e6),
        msg_depth_msg=2,
        msg_depth_timer=2,
        loss_rate=loss_rate,
        crash_interval_lo_us=400_000,
        crash_interval_hi_us=2_000_000,
        restart_delay_lo_us=200_000,
        restart_delay_hi_us=1_000_000,
        partition_interval_lo_us=400_000,
        partition_interval_hi_us=1_500_000,
        partition_heal_lo_us=300_000,
        partition_heal_hi_us=1_200_000,
    )
    return BatchWorkload(
        spec=spec if spec is not None else make_twopc_spec(n_nodes),
        config=cfg,
        host_repro=host_repro,
    )
