"""Two-Phase Commit, as a speclang spec source.

The port of `madsim_tpu/speclang/specs/twopc.py`: the same protocol as the
hand-written `tpu/twopc.py` (presumed abort, cooperative termination,
static coordinator on node 0; see that module's header), re-derived. The
handler bodies below are the port's hand module's fused `on_event` over
[L, N] axes, verbatim (same ops, same PRNG sites 31-35, same state field
order); the state NamedTuple, init, on_restart, narrow_fields,
rate_floors, narrow_horizon_us and msg_kind_names are DERIVED from the
`Field` declarations (copied from the JAX spec source) by
`speclang.device`. tests/test_torch_speclang.py holds the generated spec
to the hand spec's golden digest `GOLDEN["twopc"]`.
"""

from __future__ import annotations

import torch

from ...tpu import prng
from ...tpu.spec import Outbox, SimConfig, bit, stack_fields
from ..lang import Field, KnobDecl, Protocol, Rate

NONE, COMMIT, ABORT = 0, 1, 2
PREPARE, VOTE, OUTCOME, DREQ = 0, 1, 2, 3
PAYLOAD_WIDTH = 3  # (tid, flag, spare)

_TID_WHY = (
    "a mint needs a coordinator timer fire; every re-arm "
    "(init, post-start, retry, restart) draws >= 1_000 us"
)


def _fields(p):
    N, TXN = p.n_nodes, p.txn_ring
    # the i16 tid bound is a RATE argument (one global mint per 1 ms
    # hard floor, ratchet=1 — only the coordinator mints); o_tid/v_tid
    # hold COPIES of minted tids, so tid_cur's bound is theirs too.
    tid_rate = Rate(floor_us=1_000, ratchet=1, inc=1, why=_TID_WHY)
    return (
        Field("tid_cur", init=-1, narrow="i16", rate=tid_rate,
              doc="coordinator: last txn started"),
        Field("vote_mask", durable=False,
              narrow=("u8" if N <= 8 else "u16" if N <= 16 else None),
              doc="coordinator: yes-voter bitmask (volatile)"),
        Field("o_tid", init=-1, shape=(TXN,), narrow="i16", rate=tid_rate,
              doc="outcome ring: absolute tid, -1 empty (slot = tid % TXN)"),
        Field("o_val", shape=(TXN,), narrow="u8",
              doc="outcome ring: COMMIT/ABORT"),
        Field("v_tid", init=-1, shape=(TXN,), narrow="i16", rate=tid_rate,
              doc="own-vote ring: absolute tid, -1 empty"),
        Field("v_val", shape=(TXN,), narrow="u8",
              doc="own-vote ring: COMMIT(yes)/ABORT(no)"),
        Field("decided", doc="outcomes recorded (diagnostics, stays i32)"),
    )


def _body(p, State):
    N, TXN = p.n_nodes, p.txn_ring
    assert N >= 3
    txn_gap_us = p.txn_gap_us
    prepare_timeout_us = p.prepare_timeout_us
    doubt_retry_us = p.doubt_retry_us
    yes_p = prng.f32(p.vote_yes_p)
    i32 = torch.int32
    ALL_YES = (1 << N) - 2  # bits 1..N-1
    IDLE_FAR = 2**28  # "unarmed" participant timer offset

    def tidx_of(like):
        return torch.arange(TXN, dtype=i32, device=like.device)

    def record_outcome(s, do, tid, outcome):
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

    def record_vote(s, do, tid, vote):
        w = do[..., None] & (
            tidx_of(tid) == torch.remainder(tid, TXN)[..., None]
        )
        return s._replace(
            v_tid=torch.where(w, tid[..., None], s.v_tid),
            v_val=torch.where(w, vote[..., None], s.v_val),
        )

    def outcome_of(s, tid):
        """Recorded outcome for absolute tid, NONE if absent."""
        hit = (tidx_of(tid) == torch.remainder(tid, TXN)[..., None]) & (
            s.o_tid == tid[..., None]
        )
        return torch.where(hit, s.o_val, 0).sum(dim=-1, dtype=i32)

    def unresolved_yes(s):
        """[..., TXN]: yes-votes with no recorded outcome for their tid."""
        voted_yes = (s.v_tid >= 0) & (s.v_val == COMMIT)
        resolved = (s.v_tid == s.o_tid) & (s.o_tid >= 0)
        return voted_yes & ~resolved

    def first_timer(key, nid):
        return torch.where(
            nid == 0, prng.randint(key, 31, 1_000, txn_gap_us), IDLE_FAR
        )

    def on_event(s, nid, src, kind, payload, now, key):
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

    def restart_timer(s, nid, now, key):
        # receives the PRE-reset state: the participant arm inspects the
        # surviving in-doubt set; `now` is per lane [L]
        now_n = now[:, None]
        return torch.where(
            nid == 0,
            # fire soon: an open undecided tid_cur gets presumed-aborted
            now_n + prng.randint(key, 35, 1_000, txn_gap_us),
            now_n + torch.where(
                unresolved_yes(s).any(-1), doubt_retry_us, IDLE_FAR
            ),
        )

    def check_invariants(ns, alive, now):
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

    return {
        "on_event": on_event,
        "first_timer": first_timer,
        "restart_timer": restart_timer,
        "check_invariants": check_invariants,
        "lane_metrics": lane_metrics,
    }


def _workload(spec, p, virtual_secs, loss_rate):
    # the hand twopc_workload's chaos recipe: loss, coordinator crashes
    # (the blocking case) and partitions; ring depth 2 for overlapping
    # OUTCOME re-sends and back-to-back PREPARE/OUTCOME broadcasts
    return SimConfig(
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


PROTOCOL = Protocol(
    name="twopc-gen",
    messages=("PREPARE", "VOTE", "OUTCOME", "DREQ"),
    payload_width=PAYLOAD_WIDTH,
    params=dict(
        n_nodes=5,
        txn_ring=16,
        txn_gap_us=40_000,
        prepare_timeout_us=120_000,
        doubt_retry_us=80_000,
        vote_yes_p=0.85,
    ),
    fields=_fields,
    body=_body,
    fused=True,
    max_out=lambda p: p.n_nodes,
    max_out_msg=lambda p: p.n_nodes,  # a VOTE receipt can broadcast
    knobs=(
        KnobDecl("txn_ring", param="txn_ring", values=(8, 16, 32),
                 default=16),
    ),
    workload=_workload,
    doc="two-phase commit (presumed abort, cooperative termination)",
)
