"""Raft as [L, N]-batched PyTorch handlers — the flagship fuzz workload.

The port of `madsim_tpu/tpu/raft.py`: leader election with randomized
timeouts, single-entry AppendEntries replication, majority commit, client
writes at leaders, and log compaction with InstallSnapshot over a circular
log window. Every expression is the JAX face's, written over explicit
leading [L, N] axes instead of under a lanes x nodes vmap, and must give
the same values bit for bit (tests/test_torch_raft.py holds one step of
both engines against each other).

Where the JAX face contracts a one-hot with `jnp.einsum` (window lookups,
the invariant check's prefix hashes), this face selects with `where` and
sums: CUDA has no integer matmul, and a one-hot has one nonzero term, so
the sum is exact.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .spec import (
    Outbox, ProtocolSpec, RateFloor, SimConfig, buggify, popcount, wraps_event,
)

FOLLOWER, CANDIDATE, LEADER = 0, 1, 2
REQUEST_VOTE, VOTE_RESP, APPEND, APPEND_RESP, SNAP = 0, 1, 2, 3, 4
PAYLOAD_WIDTH = 6


class RaftState(NamedTuple):
    """Per-node Raft state, leaves [L, N, ...]. i32 fields are int32;
    `log_chain` holds u32 chain hashes in int64 (see prng.py)."""

    term: torch.Tensor  # (durable)
    voted_for: torch.Tensor  # -1 = none (durable)
    role: torch.Tensor  # (volatile)
    votes: torch.Tensor  # bitmask (volatile)
    # log window: absolute indices [base, log_len) in a circular buffer;
    # absolute index i lives at physical slot (i - base + head) % LOG
    base: torch.Tensor
    head: torch.Tensor
    base_hash: torch.Tensor  # i32 chain hash of [0, base)
    base_term: torch.Tensor  # term of entry base-1
    log_term: torch.Tensor  # [LOG]
    log_cmd: torch.Tensor  # [LOG]
    log_chain: torch.Tensor  # u32 [LOG]: hash of prefix [0, base + r]
    log_len: torch.Tensor
    commit: torch.Tensor
    next_idx: torch.Tensor  # [N]
    match_idx: torch.Tensor  # [N]
    next_cmd: torch.Tensor
    reply_parity: torch.Tensor  # which outbox row the next reply uses


def _chain_fold(h, term, cmd):
    """Order-sensitive hash fold of one (term, cmd) entry (u32 result)."""
    return prng.fold(prng.fold(h, term), cmd)


@functools.lru_cache(maxsize=64)
def _arange(n: int, device: torch.device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device)


def _lead(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """Broadcast a per-node [L,N] tensor against an index tensor `like` of
    shape [L,N] or [L,N,K]."""
    return x.reshape(x.shape + (1,) * (like.dim() - x.dim()))


def make_raft_spec(
    n_nodes: int = 5,
    log_capacity: int = 24,
    election_lo_us: int = 150_000,
    election_hi_us: int = 300_000,
    heartbeat_us: int = 50_000,
    client_rate: float = 0.5,
    buggify_rate: float = 0.0,
) -> ProtocolSpec:
    """The JAX face's make_raft_spec, with the same parameters and draws.
    `buggify_rate` arms the cooperative fault point: a leader whose timer
    fires occasionally skips its whole broadcast."""
    N, LOG = n_nodes, log_capacity
    client_p = prng.f32(client_rate)

    def election_deadline(now, key, site):
        return now + prng.randint(key, site, election_lo_us, election_hi_us)

    def phys_oh(s: RaftState, i):
        """bool [..., LOG]: one-hot of absolute index i's physical slot,
        all-false when i is outside the retained window [base, base+LOG).
        `i` is [L,N] or [L,N,K]."""
        rel = i - _lead(s.base, i)
        phys = torch.remainder(rel + _lead(s.head, i), LOG)
        in_win = (rel >= 0) & (rel < LOG)
        return (_arange(LOG, i.device) == phys[..., None]) & in_win[..., None]

    def at_abs(s: RaftState, log_arr, i, oh=None):
        """log_arr [L,N,LOG] at absolute index i; 0 outside the window.
        `oh` passes a phys_oh(s, i) the caller already built."""
        oh = phys_oh(s, i) if oh is None else oh
        arr = log_arr.reshape(
            log_arr.shape[:2] + (1,) * (i.dim() - 2) + (LOG,)
        )
        return torch.where(oh, arr, 0).sum(-1, dtype=log_arr.dtype)

    def term_at(s: RaftState, i, oh=None):
        win = at_abs(s, s.log_term, i, oh)
        return torch.where(
            i == _lead(s.base, i) - 1, _lead(s.base_term, i), win
        )

    def hash_at(s: RaftState, i, oh=None):
        """u32 chain hash of prefix [0, i] (valid iff base-1 <= i < log_len)."""
        win = at_abs(s, s.log_chain, i, oh)
        return torch.where(
            i == _lead(s.base, i) - 1, _lead(prng.u32(s.base_hash), i), win
        )

    def pack(*fields):
        """Stack [L,N]-broadcastable int fields into an int32 [..., P]."""
        ts = [f for f in fields if isinstance(f, torch.Tensor)]
        shape = torch.broadcast_shapes(*(t.shape for t in ts))
        dev = ts[0].device
        return torch.stack([
            torch.broadcast_to(f.to(torch.int32), shape)
            if isinstance(f, torch.Tensor)
            else torch.full(shape, f, dtype=torch.int32, device=dev)
            for f in fields
        ], dim=-1)

    # ------------------------------------------------------------------ init

    def init(key, nid):
        L = key.shape[0]
        dev = key.device

        def full(shape, v, dtype=torch.int32):
            return torch.full((L, N) + shape, v, dtype=dtype, device=dev)

        state = RaftState(
            term=full((), 0),
            voted_for=full((), -1),
            role=full((), FOLLOWER),
            votes=full((), 0),
            base=full((), 0),
            head=full((), 0),
            base_hash=full((), 0x9E37),
            base_term=full((), 0),
            log_term=full((LOG,), 0),
            log_cmd=full((LOG,), 0),
            log_chain=full((LOG,), 0, torch.int64),
            log_len=full((), 0),
            commit=full((), -1),
            next_idx=full((N,), 0),
            match_idx=full((N,), -1),
            next_cmd=full((), 1),
            reply_parity=full((), 0),
        )
        return state, election_deadline(0, key, 20)

    # ------------------------------------------------------------ compaction

    D_COMPACT = max(LOG // 4, 2)

    def compact(s: RaftState) -> RaftState:
        """Fold exactly D_COMPACT committed entries into the snapshot when
        the window is pressured; pointer arithmetic only."""
        D = D_COMPACT
        pressure = (s.log_len - s.base) > (LOG // 2)
        do = pressure & (s.commit + 1 - s.base >= D)
        nb_idx = s.base + D - 1
        nb_oh = phys_oh(s, nb_idx)
        nb_hash = hash_at(s, nb_idx, nb_oh)
        nb_term = term_at(s, nb_idx, nb_oh)
        return s._replace(
            base=torch.where(do, s.base + D, s.base),
            head=torch.where(do, torch.remainder(s.head + D, LOG), s.head),
            base_hash=torch.where(do, prng.to_i32(nb_hash), s.base_hash),
            base_term=torch.where(do, nb_term, s.base_term),
        )

    # ----------------------------------------------------------- fused event

    def on_event(s: RaftState, nid, src, kind, payload, now, key):
        """All events (five message kinds and the timer, kind == -1) as one
        masked handler; see the JAX face for the per-kind rationale."""
        s = compact(s)
        dev = kind.device
        peers = _arange(N, dev)  # [N]
        nid = torch.broadcast_to(nid, kind.shape)
        f = payload  # [L,N,P]
        is_timer = kind == -1
        is_msg = ~is_timer
        is_rv = kind == REQUEST_VOTE
        is_vr = kind == VOTE_RESP
        is_ae = kind == APPEND
        is_ar = kind == APPEND_RESP
        is_sn = kind == SNAP
        msg_term = f[..., 0]

        my_last_idx = s.log_len - 1
        last_oh = phys_oh(s, my_last_idx)
        my_last_term = term_at(s, my_last_idx, last_oh)
        my_last_hash = hash_at(s, my_last_idx, last_oh)

        # ====================== timer path (kind == -1) ===================
        is_leader = is_timer & (s.role == LEADER)
        can_append = (s.log_len - s.base) < LOG
        do_append = (
            is_leader & can_append & (prng.uniform(key, 26) < client_p)
        )
        at_end = phys_oh(s, s.log_len)  # [L,N,LOG]
        new_cmd = nid * 100_000 + s.next_cmd
        t_wr = do_append[..., None] & at_end
        append_h = _chain_fold(my_last_hash, s.term, new_cmd)
        log_len_t = s.log_len + do_append.to(torch.int32)

        prev_idx = s.next_idx - 1  # [L,N,N]
        prev_term = term_at(s, prev_idx)
        ae_has_entry = s.next_idx < log_len_t[..., None]
        at_appended = do_append[..., None] & (s.next_idx == s.log_len[..., None])
        next_oh = phys_oh(s, s.next_idx)
        e_term_out = torch.where(
            at_appended, s.term[..., None],
            torch.where(
                ae_has_entry, at_abs(s, s.log_term, s.next_idx, next_oh), 0
            ),
        )
        e_cmd_out = torch.where(
            at_appended, new_cmd[..., None],
            torch.where(
                ae_has_entry, at_abs(s, s.log_cmd, s.next_idx, next_oh), 0
            ),
        )
        needs_snap = s.next_idx < s.base[..., None]  # [L,N,N]
        start_el = is_timer & ~is_leader

        # ====================== message path (kind >= 0) ==================
        newer = is_msg & (msg_term > s.term)
        term = torch.where(
            newer, msg_term, torch.where(start_el, s.term + 1, s.term)
        )
        voted_for = torch.where(
            newer, -1, torch.where(start_el, nid, s.voted_for)
        )
        role = torch.where(
            newer, FOLLOWER, torch.where(start_el, CANDIDATE, s.role)
        )
        stale_ldr = msg_term < s.term
        ldr_contact = (is_ae | is_sn) & ~stale_ldr
        role = torch.where(ldr_contact, FOLLOWER, role)

        # -- REQUEST_VOTE: grant iff the candidate's log is up to date
        log_ok = (f[..., 2] > my_last_term) | (
            (f[..., 2] == my_last_term) & (f[..., 1] >= my_last_idx)
        )
        grant = (
            is_rv & (msg_term == term)
            & ((voted_for == -1) | (voted_for == src)) & log_ok
        )
        voted_for = torch.where(grant, src, voted_for)

        # -- VOTE_RESP: tally; majority => leader
        one = torch.ones_like(src)
        tally = is_vr & (role == CANDIDATE) & (msg_term == term) & (f[..., 1] > 0)
        votes = torch.where(
            tally, s.votes | torch.bitwise_left_shift(one, src),
            torch.where(start_el, torch.bitwise_left_shift(one, nid), s.votes),
        )
        won = is_vr & (role == CANDIDATE) & (popcount(votes) > N // 2)
        role = torch.where(won, LEADER, role)

        # -- APPEND: consistency check, window write, commit advance
        m_prev_idx, prev_term_in, e_term, e_cmd, l_commit = (
            f[..., 1], f[..., 2], f[..., 3], f[..., 4], f[..., 5],
        )
        prev_oh = phys_oh(s, m_prev_idx)
        prev_ok = (m_prev_idx < 0) | (
            (m_prev_idx < s.log_len)
            & (m_prev_idx >= s.base - 1)
            & (term_at(s, m_prev_idx, prev_oh) == prev_term_in)
        )
        ae_ok = is_ae & ~stale_ldr & prev_ok
        has_entry = e_term > 0
        write_at = m_prev_idx + 1
        rel_w = write_at - s.base
        in_window = (rel_w >= 0) & (rel_w < LOG)
        do_write = ae_ok & has_entry & in_window
        at_w = phys_oh(s, write_at)
        existing_term = at_abs(s, s.log_term, write_at, at_w)
        same = (write_at < s.log_len) & (existing_term == e_term)
        # the predecessor of write_at is m_prev_idx
        write_h = _chain_fold(hash_at(s, m_prev_idx, prev_oh), e_term, e_cmd)
        match_ae = torch.where(
            ae_ok, torch.where(has_entry & in_window, write_at, m_prev_idx), -1
        )

        # -- SNAP: adopt the leader's compacted prefix wholesale
        snap_idx, snap_term, snap_hash = f[..., 1], f[..., 2], f[..., 3]
        adopt = is_sn & ~stale_ldr & (snap_idx > s.commit)
        match_sn = torch.where(
            adopt, snap_idx,
            torch.where(stale_ldr, -1, torch.minimum(snap_idx, s.commit)),
        )

        # -- APPEND_RESP: leader replication bookkeeping + majority commit
        ar_success, ar_match = f[..., 1], f[..., 2]
        ar_live = is_ar & (role == LEADER) & (msg_term == term)
        at_src = peers == src[..., None]  # [L,N,N]
        upd = (ar_live & (ar_success > 0))[..., None] & at_src
        back = (ar_live & (ar_success == 0))[..., None] & at_src
        match_idx = torch.where(
            upd, torch.maximum(s.match_idx, ar_match[..., None]), s.match_idx
        )
        next_idx = torch.where(
            upd, torch.maximum(s.next_idx, ar_match[..., None] + 1), s.next_idx
        )
        next_idx = torch.where(
            back, torch.clamp(s.next_idx - 1, min=0), next_idx
        )
        is_self = peers == nid[..., None]  # [L,N,N]
        last = (s.log_len - 1)[..., None]
        match_idx = torch.where(
            won[..., None], torch.where(is_self, last, -1), match_idx
        )
        next_idx = torch.where(won[..., None], s.log_len[..., None], next_idx)
        my_match = torch.where(is_self, last, match_idx)
        majority_idx = torch.sort(my_match, dim=-1).values[..., N - (N // 2 + 1)]
        can_commit = ar_live & (majority_idx > s.commit) & (
            term_at(s, majority_idx) == term
        )

        # ================== merged field writes (disjoint masks) ==========
        w_ae = do_write[..., None] & at_w
        log_term_new = torch.where(
            t_wr, s.term[..., None],
            torch.where(w_ae, e_term[..., None], s.log_term),
        )
        log_cmd_new = torch.where(
            t_wr, new_cmd[..., None],
            torch.where(w_ae, e_cmd[..., None], s.log_cmd),
        )
        log_chain_new = torch.where(
            t_wr, append_h[..., None],
            torch.where(w_ae, write_h[..., None], s.log_chain),
        )
        log_len_new = torch.where(
            do_write, torch.where(same, s.log_len, write_at + 1),
            torch.where(adopt, snap_idx + 1, log_len_t),
        )
        commit = torch.where(
            ae_ok, torch.maximum(s.commit, torch.minimum(l_commit, match_ae)),
            torch.where(
                can_commit, majority_idx,
                torch.where(adopt, snap_idx, s.commit),
            ),
        )
        replies = is_rv | is_ae | is_sn
        state = s._replace(
            term=term, role=role, voted_for=voted_for, votes=votes,
            base=torch.where(adopt, snap_idx + 1, s.base),
            base_hash=torch.where(adopt, snap_hash, s.base_hash),
            base_term=torch.where(adopt, snap_term, s.base_term),
            log_term=log_term_new, log_cmd=log_cmd_new,
            log_chain=log_chain_new, log_len=log_len_new,
            commit=commit, next_idx=next_idx, match_idx=match_idx,
            next_cmd=s.next_cmd + do_append.to(torch.int32),
            reply_parity=torch.where(
                replies, 1 - s.reply_parity, s.reply_parity
            ),
        )

        # ================== merged outbox (E = N rows) ====================
        bN = (N,)
        ae_payload = pack(
            s.term[..., None], prev_idx, prev_term, e_term_out, e_cmd_out,
            s.commit[..., None],
        )  # [L,N,N,P]
        snap_payload = torch.broadcast_to(
            pack(s.term, s.base - 1, s.base_term, s.base_hash, 0, s.commit)
            [..., None, :], ae_payload.shape,
        )
        rv_payload = torch.broadcast_to(
            pack(term, my_last_idx, my_last_term, 0, 0, 0)[..., None, :],
            ae_payload.shape,
        )
        if buggify_rate > 0:
            mute = is_leader & buggify(key, 28, buggify_rate)
        else:
            mute = torch.zeros_like(is_leader)
        ldr = is_leader[..., None]  # [L,N,1]
        bcast_kind = torch.where(
            ldr, torch.where(needs_snap, SNAP, APPEND), REQUEST_VOTE
        ).to(torch.int32)
        bcast_pay = torch.where(
            ldr[..., None],
            torch.where(needs_snap[..., None], snap_payload, ae_payload),
            rv_payload,
        )
        r_kind = torch.where(is_rv, VOTE_RESP, APPEND_RESP).to(torch.int32)
        r_f1 = torch.where(
            is_rv, grant, torch.where(is_ae, ae_ok, ~stale_ldr)
        ).to(torch.int32)
        r_f2 = torch.where(is_ae, match_ae, match_sn)
        at_row = peers == s.reply_parity[..., None]  # [L,N,N]
        tm = is_timer[..., None]
        out = Outbox(
            valid=torch.where(
                tm, (peers != nid[..., None]) & ~mute[..., None],
                at_row & replies[..., None],
            ),
            dst=torch.where(
                tm, peers, torch.broadcast_to(src[..., None], src.shape + bN)
            ),
            kind=torch.where(tm, bcast_kind, r_kind[..., None]),
            payload=torch.where(
                tm[..., None],
                bcast_pay,
                torch.where(
                    at_row[..., None],
                    pack(term, r_f1, r_f2, 0, 0, 0)[..., None, :],
                    0,
                ),
            ),
        )

        reset = grant | ((is_ae | is_sn) & ~stale_ldr)
        timer = torch.where(
            is_timer,
            torch.where(
                is_leader, now + heartbeat_us, election_deadline(now, key, 22)
            ),
            torch.where(
                won, now,
                torch.where(reset, election_deadline(now, key, 24), -1),
            ),
        )
        return state, out, timer

    @wraps_event(on_event)
    def on_message(s: RaftState, nid, src, kind, payload, now, key):
        return on_event(s, nid, src, kind, payload, now, key)

    @wraps_event(on_event)
    def on_timer(s: RaftState, nid, now, key):
        z = torch.zeros_like(now)
        return on_event(
            s, nid, z, z - 1,
            torch.zeros(now.shape + (PAYLOAD_WIDTH,), dtype=torch.int32,
                        device=now.device),
            now, key,
        )

    # --------------------------------------------------------------- restart

    def on_restart(s: RaftState, nid, now, key):
        """`now` is per lane [L]."""
        state = s._replace(
            role=torch.full_like(s.role, FOLLOWER),
            votes=torch.zeros_like(s.votes),
            commit=s.base - 1,
            next_idx=torch.zeros_like(s.next_idx),
            match_idx=torch.full_like(s.match_idx, -1),
            reply_parity=torch.zeros_like(s.reply_parity),
        )
        return state, election_deadline(now[:, None], key, 25)

    # ------------------------------------------------------------ invariants

    def check_invariants(ns: RaftState, alive, now):
        """ok [L]: election safety, committed-prefix agreement via chain
        hashes, and leader completeness (see the JAX face)."""
        dev = ns.term.device
        is_leader = ns.role == LEADER  # [L,N]
        same_term = ns.term[:, :, None] == ns.term[:, None, :]  # [L,N,N]
        both_lead = is_leader[:, :, None] & is_leader[:, None, :]
        off_diag = ~torch.eye(N, dtype=torch.bool, device=dev)
        election_safety = ~(same_term & both_lead & off_diag).flatten(1).any(1)

        # committed-prefix agreement: node a's prefix hash at
        # m = min(commit_a, commit_b), wherever both retain index m
        m = torch.minimum(ns.commit[:, :, None], ns.commit[:, None, :])
        h_a = hash_at(ns, m)  # [L,N,N]: row a's hash at m[a, b]
        known_a = (m >= ns.base[:, :, None] - 1) & (m < ns.log_len[:, :, None])
        h_b = h_a.transpose(1, 2)
        known_b = known_a.transpose(1, 2)
        comparable = known_a & known_b & (m >= 0)
        log_matching = ~(comparable & (h_a != h_b)).flatten(1).any(1)

        # leader completeness: pair (leader l, node a) bound when
        # term[a] <= term[l]; l must extend past commit[a] and agree there
        ca = ns.commit[:, None, :]  # [L,1,N] column = node a
        bind = (
            alive[:, :, None]
            & is_leader[:, :, None]
            & (ns.term[:, None, :] <= ns.term[:, :, None])
            & (ca >= 0)
        )
        len_ok = (ns.log_len[:, :, None] - 1) >= ca
        ca_mat = torch.broadcast_to(ca, (ca.shape[0], N, N))
        h_l = hash_at(ns, ca_mat)  # row l's hash at column a's commit
        known_l = (ca >= ns.base[:, :, None] - 1) & (ca < ns.log_len[:, :, None])
        h_self = hash_at(ns, ns.commit)  # [L,N]
        hash_ok = (h_l == h_self[:, None, :]) | ~known_l
        leader_completeness = ~(bind & (~len_ok | ~hash_ok)).flatten(1).any(1)

        return election_safety & log_matching & leader_completeness

    # ------------------------------------------------------------ diagnostics

    def lane_metrics(node):
        window_full = (node.log_len - node.base) >= LOG
        cannot_compact = (node.commit + 1 - node.base) < D_COMPACT
        return {
            "log_saturated_lanes": (window_full & cannot_compact).any(dim=-1),
            "mean_log_len": node.log_len.to(torch.float32).mean(dim=-1),
            "mean_compacted": node.base.to(torch.float32).mean(dim=-1),
        }

    return ProtocolSpec(
        name=f"raft{N}",
        n_nodes=N,
        payload_width=PAYLOAD_WIDTH,
        max_out=N,
        max_out_msg=N,
        init=init,
        on_message=on_message,
        on_timer=on_timer,
        on_event=on_event,
        on_restart=on_restart,
        check_invariants=check_invariants,
        lane_metrics=lane_metrics,
        msg_kind_names=("REQUEST_VOTE", "VOTE_RESP", "APPEND", "APPEND_RESP", "SNAP"),
        # the JAX face's storage narrowing table (this face stores wide);
        # kept for the narrow_horizon_us refusal below
        narrow_fields={
            "role": np.uint8,
            "reply_parity": np.uint8,
            "voted_for": np.int8,
            **({"votes": np.uint8} if N <= 8 else
               {"votes": np.uint16} if N <= 16 else {}),
            "term": np.uint16,
            "base_term": np.uint16,
            "log_term": np.uint16,
        },
        # u16 terms hold up to this horizon: each node self-increments at
        # most once per election_lo and adoption ratchets the global max at
        # most N times per window
        narrow_horizon_us=65_535 * election_lo_us // N,
        rate_floors={
            f: RateFloor(
                floor_us=election_lo_us, ratchet=N,
                why="election deadlines (incl. restart) draw >= "
                "election_lo; adoption ratchets the global max <= N "
                "times per window",
            )
            for f in ("term", "base_term", "log_term")
        },
    )


def verify_chain_cache(node) -> bool:
    """Debug oracle for the incremental chain cache: recompute every
    (lane, node) chain hash from base_hash + the raw window in numpy and
    compare against the maintained `log_chain` (valid slots only)."""

    def mix(x):
        x = x.astype(np.uint32)
        x ^= x >> 16
        x = (x * np.uint32(0x85EBCA6B)) & np.uint32(0xFFFFFFFF)
        x ^= x >> 13
        x = (x * np.uint32(0xC2B2AE35)) & np.uint32(0xFFFFFFFF)
        x ^= x >> 16
        return x

    def fold(h, w):
        return mix(h ^ (w.astype(np.uint32) * np.uint32(0x9E3779B9)))

    def host(t):
        return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

    base_hash = host(node.base_hash).astype(np.int64).astype(np.uint32)
    log_term = host(node.log_term).astype(np.int64)
    log_cmd = host(node.log_cmd).astype(np.int64)
    log_chain = host(node.log_chain).astype(np.uint32)
    n_valid = host(node.log_len) - host(node.base)
    head = host(node.head)
    LOG = log_term.shape[-1]

    idx = (head[:, :, None] + np.arange(LOG)[None, None, :]) % LOG
    log_term = np.take_along_axis(log_term, idx, axis=-1)
    log_cmd = np.take_along_axis(log_cmd, idx, axis=-1)
    log_chain = np.take_along_axis(log_chain, idx, axis=-1)

    h = base_hash
    ok = True
    with np.errstate(over="ignore"):
        for r in range(LOG):
            h = fold(fold(h, log_term[:, :, r]), log_cmd[:, :, r])
            valid = r < n_valid
            ok = ok and bool(np.all(~valid | (h == log_chain[:, :, r])))
    return ok


def raft_bench_config(virtual_secs: float) -> SimConfig:
    """The headline sweep's config (the repo's bench.py `raft_bench_config`):
    legacy crash/restart, 10% loss and bipartitions, with the node-pooled
    slot budget (depth 1 x N + 3 spare) measured for zero overflow."""
    return SimConfig(
        horizon_us=int(virtual_secs * 1e6),
        msg_depth_msg=1,
        msg_spare_slots=3,
        loss_rate=0.10,
        crash_interval_lo_us=500_000,
        crash_interval_hi_us=3_000_000,
        restart_delay_lo_us=300_000,
        restart_delay_hi_us=2_000_000,
        partition_interval_lo_us=300_000,
        partition_interval_hi_us=1_500_000,
        partition_heal_lo_us=500_000,
        partition_heal_hi_us=2_000_000,
    )


def raft_workload(
    n_nodes: int = 5,
    virtual_secs: float = 10.0,
    loss_rate: float = 0.1,
    chaos: bool = True,
    spec: "ProtocolSpec | None" = None,
):
    """The Raft fuzz as a BatchWorkload: the batched spec + the host-runtime
    reproducer (same config as the JAX face's). Violating lanes hand their
    seed to `host_repro`, which re-runs it on the host twin
    (workloads/raft_host.py). Pass `spec` to fuzz a modified (e.g.
    deliberately buggy) spec under the same chaos config."""
    from .batch import BatchWorkload

    def host_repro(seed: int):
        from ..workloads.raft_host import fuzz_one_seed

        return fuzz_one_seed(
            seed, n_nodes=n_nodes, virtual_secs=virtual_secs,
            loss_rate=loss_rate, chaos=chaos,
        )

    cfg = SimConfig(
        horizon_us=int(virtual_secs * 1e6),
        loss_rate=loss_rate,
        crash_interval_lo_us=500_000 if chaos else 0,
        crash_interval_hi_us=3_000_000 if chaos else 0,
        restart_delay_lo_us=300_000,
        restart_delay_hi_us=2_000_000,
    )
    return BatchWorkload(
        spec=spec if spec is not None else make_raft_spec(n_nodes=n_nodes),
        config=cfg,
        host_repro=host_repro,
    )
