"""Replicated KV with quorum reads and writes as [L, N]-batched handlers.

The port of `madsim_tpu/tpu/kv.py`: primary/backup with epoch claims and
quorum rounds, every node both a replica and a client. A replica that
misses heartbeats claims a higher epoch and merges its acknowledgers'
stores; a new primary re-commits every merged key under its own epoch
before serving (mandate recovery); writes and reads each run a
majority-quorum round; every acknowledged client op is recorded per node
as (kind, key, val, rev, t_invoke, t_response).

The device oracle checks each node's most recently acked op against the
recorded histories and the per-(node, key) max-revision watermarks:
real-time revision monotonicity and same-revision value coherence. The
exact per-key linearizability check over the histories runs on the host
(`linearize.py`, wired as the workload's `lane_check`).

`buggy_local_read_spec` plants the stale-read bug (any node answers a
read from its local store), which partitions expose.

Every expression is the JAX face's over explicit leading [L, N] axes; its
one-hot multiply-and-sum lookups become select-and-sum and its static
`.at[i].set` payload builds become `torch.stack` (tests/test_torch_kv.py
holds both faces equal).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .spec import (
    Outbox, ProtocolSpec, RateFloor, SimConfig, bit, majority, pool_kw_for,
    select_sum, stack_fields, wraps_event,
)

REPLICA, CLAIMING, PRIMARY = 0, 1, 2
HB, CLAIM, CLAIM_ACK, WREP, WACK, RPROBE, RACK, CREQ, CRSP = range(9)
OP_READ, OP_WRITE = 1, 2
# writes-per-epoch headroom before a revision collision
REV_STRIDE = 1 << 15


class KvState(NamedTuple):
    """Per-node KV state, int32 leaves [L, N], [L, N, K] or [L, N, OPS]."""

    role: torch.Tensor  # (volatile)
    epoch: torch.Tensor  # (durable)
    last_hb: torch.Tensor  # (volatile)
    kv_val: torch.Tensor  # [K] (durable)
    kv_rev: torch.Tensor  # [K] (durable)
    claim_acks: torch.Tensor  # bitmask (volatile)
    claim_t: torch.Tensor  # (volatile)
    pend_kind: torch.Tensor  # the primary's one quorum round, 0 = none
    pend_key: torch.Tensor
    pend_val: torch.Tensor
    pend_rev: torch.Tensor  # (also the probe id)
    pend_acks: torch.Tensor
    pend_client: torch.Tensor
    pend_tinv: torch.Tensor
    pend_t: torch.Tensor
    pend_recover: torch.Tensor  # bool: mandate-recovery round
    recover_left: torch.Tensor  # keys still to re-commit
    wcount: torch.Tensor
    creq_kind: torch.Tensor  # client side (volatile), 0 = none
    creq_key: torch.Tensor
    creq_val: torch.Tensor
    creq_t: torch.Tensor
    ccount: torch.Tensor  # (durable)
    h_kind: torch.Tensor  # [OPS] acked-op history, 0 = empty (durable)
    h_key: torch.Tensor  # [OPS]
    h_val: torch.Tensor  # [OPS]
    h_rev: torch.Tensor  # [OPS]
    h_tinv: torch.Tensor  # [OPS]
    h_trsp: torch.Tensor  # [OPS]
    h_len: torch.Tensor
    wm_rev: torch.Tensor  # [K] per-key acked max revision (durable)
    wm_t: torch.Tensor  # [K] the response time that established it
    la_kind: torch.Tensor  # most recently acked op register (durable)
    la_key: torch.Tensor
    la_val: torch.Tensor
    la_rev: torch.Tensor
    la_tinv: torch.Tensor
    la_trsp: torch.Tensor


def make_kv_spec(
    n_nodes: int = 5,
    n_keys: int = 4,
    ops_capacity: int = 24,
    tick_us: int = 25_000,
    hb_timeout_lo_us: int = 150_000,
    hb_timeout_hi_us: int = 300_000,
    claim_retry_us: int = 200_000,
    req_timeout_us: int = 400_000,
    pend_timeout_us: int = 150_000,
    client_rate: float = 0.7,
    write_frac: float = 0.5,
) -> ProtocolSpec:
    """The JAX face's make_kv_spec, same parameters and draws."""
    N, K, OPS = n_nodes, n_keys, ops_capacity
    P = 2 * K + 2  # CLAIM_ACK carries the whole store: epoch + K vals + K revs
    assert P >= 6  # CRSP needs 6 fields
    i32 = torch.int32
    client_p = prng.f32(client_rate)
    write_p = prng.f32(write_frac)

    def fields(*vals):
        return stack_fields(*vals, width=P)

    # ------------------------------------------------------------------ init

    def init(key, nid):
        L = key.shape[0]

        def full(v, shape=()):
            return torch.full((L, N) + shape, v, dtype=i32, device=key.device)

        state = KvState(
            role=full(REPLICA), epoch=full(0), last_hb=full(0),
            kv_val=full(0, (K,)), kv_rev=full(0, (K,)),
            claim_acks=full(0), claim_t=full(0),
            pend_kind=full(0), pend_key=full(0), pend_val=full(0),
            pend_rev=full(0), pend_acks=full(0), pend_client=full(0),
            pend_tinv=full(0), pend_t=full(0), pend_recover=full(0),
            recover_left=full(0), wcount=full(0),
            creq_kind=full(0), creq_key=full(0), creq_val=full(0),
            creq_t=full(0), ccount=full(1),
            h_kind=full(0, (OPS,)), h_key=full(0, (OPS,)),
            h_val=full(0, (OPS,)), h_rev=full(0, (OPS,)),
            h_tinv=full(0, (OPS,)), h_trsp=full(0, (OPS,)), h_len=full(0),
            wm_rev=full(0, (K,)), wm_t=full(0, (K,)),
            la_kind=full(0), la_key=full(0), la_val=full(0), la_rev=full(0),
            la_tinv=full(0), la_trsp=full(0),
        )
        # stagger first ticks so the initial election isn't a thundering herd
        return state, prng.randint(key, 30, 0, tick_us)

    # ----------------------------------------------------------- fused event

    def on_event(s: KvState, nid, src, kind, payload, now, key):
        """All events, the nine message kinds and the timer tick
        (kind == -1), as one masked handler."""
        dev = nid.device
        peers = torch.arange(N, dtype=i32, device=dev)
        kidx = torch.arange(K, dtype=i32, device=dev)
        oidx = torch.arange(OPS, dtype=i32, device=dev)
        f = payload
        f0, f1, f2, f3, f4, f5 = (f[..., i] for i in range(6))
        is_timer = kind == -1

        # ====================== timer path (kind == -1) ===================
        is_primary_t = is_timer & (s.role == PRIMARY)

        # -- election: a replica missing heartbeats claims a higher epoch;
        #    a claimer stuck too long retries with a fresh one
        jitter = prng.randint(key, 31, hb_timeout_lo_us, hb_timeout_hi_us)
        start_claim = is_timer & (s.role == REPLICA) & (now - s.last_hb > jitter)
        retry_claim = (
            is_timer & (s.role == CLAIMING) & (now - s.claim_t > claim_retry_us)
        )
        claim = start_claim | retry_claim
        gen = torch.div(s.epoch, N, rounding_mode="floor") + 1
        t_epoch = torch.where(claim, gen * N + nid, s.epoch)

        # -- primary: drop a quorum round that never reached majority
        pend_expired = is_primary_t & (s.pend_kind > 0) & (
            now - s.pend_t > pend_timeout_us
        )
        t_pend_kind = torch.where(pend_expired, 0, s.pend_kind)

        # -- mandate recovery: re-commit the next merged key under this
        #    epoch, one write-quorum round at a time
        start_rec = is_primary_t & (s.recover_left > 0) & (t_pend_kind == 0)
        rec_key = torch.clamp(K - s.recover_left, 0, K - 1)
        rec_val = select_sum(kidx == rec_key[..., None], s.kv_val)
        rid_rec = s.epoch * REV_STRIDE + s.wcount + 1

        # -- client: expire a stuck request, else maybe issue a new one
        req_expired = is_timer & (s.creq_kind > 0) & (
            now - s.creq_t > req_timeout_us
        )
        t_creq_kind = torch.where(req_expired, 0, s.creq_kind)
        issue = is_timer & (t_creq_kind == 0) & (
            prng.uniform(key, 32) < client_p
        )
        is_write_t = prng.uniform(key, 33) < write_p
        op_kind = torch.where(is_write_t, OP_WRITE, OP_READ).to(i32)
        op_key = prng.randint(key, 34, 0, K)
        op_val = torch.where(is_write_t, nid * 100_000 + s.ccount, 0)
        believed_primary = torch.remainder(s.epoch, N)

        # ====================== message path (kind >= 0) ==================
        is_hb = kind == HB
        is_claim = kind == CLAIM
        is_cack = kind == CLAIM_ACK
        is_wrep = kind == WREP
        is_wack = kind == WACK
        is_rprobe = kind == RPROBE
        is_rack = kind == RACK
        is_creq = kind == CREQ
        is_crsp = kind == CRSP

        # -- epoch adoption: HB/WREP/RPROBE adopt a higher epoch and
        # refresh last_hb on >=; a CLAIM additionally deposes
        adopty = is_hb | is_wrep | is_rprobe
        higher = f0 > s.epoch
        accept = is_claim & higher
        adopt = (adopty | is_claim) & higher
        epoch = torch.where(adopt, f0, t_epoch)
        role = torch.where(
            adopt, REPLICA, torch.where(claim, CLAIMING, s.role)
        )
        last_hb = torch.where(
            (adopty & (f0 >= s.epoch)) | accept, now, s.last_hb
        )

        # -- CLAIM_ACK: tally; merge the responder's store (highest rev
        # per key); majority => PRIMARY with a full recovery mandate
        cmine = is_cack & (s.role == CLAIMING) & (f0 == s.epoch)
        claim_acks = torch.where(
            cmine, s.claim_acks | bit(src),
            torch.where(claim, bit(nid), s.claim_acks),
        )
        r_val = f[..., 1: 1 + K]
        r_rev = f[..., 1 + K: 1 + 2 * K]
        ca_newer = cmine[..., None] & (r_rev > s.kv_rev)  # [L,N,K]
        won = cmine & majority(claim_acks, N)
        role = torch.where(won, PRIMARY, role)

        # -- WREP: apply the replicated write if fresh, from a current+
        # epoch sender
        wrep_ok = is_wrep & (f0 >= s.epoch)
        wrep_apply = (
            wrep_ok[..., None] & (kidx == f2[..., None])
            & (f1[..., None] > s.kv_rev)
        )

        # -- WACK / RACK: the primary's one outstanding quorum round
        wmine = (
            is_wack & (s.role == PRIMARY) & (s.pend_kind == OP_WRITE)
            & (f1 == s.pend_rev)
        )
        rmine = (
            is_rack & (s.role == PRIMARY) & (s.pend_kind == OP_READ)
            & (f1 == s.pend_rev)
        )
        qmine = wmine | rmine
        pend_acks = torch.where(qmine, s.pend_acks | bit(src), s.pend_acks)
        commit_w = wmine & majority(pend_acks, N)
        commit_r = rmine & majority(pend_acks, N)
        at_p = kidx == s.pend_key[..., None]  # [L,N,K]
        wack_apply = (
            commit_w[..., None] & at_p & (s.pend_rev[..., None] > s.kv_rev)
        )
        is_rec = s.pend_recover > 0
        cur_val = select_sum(at_p, s.kv_val)
        cur_rev = select_sum(at_p, s.kv_rev)

        # -- CREQ: an idle, fully recovered primary starts a quorum round
        start = (
            is_creq & (s.role == PRIMARY) & (s.pend_kind == 0) & (f1 > 0)
            & (s.recover_left == 0)
        )
        rid = s.epoch * REV_STRIDE + s.wcount + 1

        # -- CRSP: the client records its acked op (invocation time from
        # local state, which rebases with the lane)
        rmatch = (
            is_crsp & (s.creq_kind > 0) & (f5 == s.creq_t)
            & (f1 == s.creq_kind)
        )
        at_o = rmatch[..., None] & (
            oidx == torch.remainder(s.h_len, OPS)[..., None]
        )  # [L,N,OPS]
        at_k = kidx == f2[..., None]
        raise_wm = rmatch[..., None] & at_k & (f4[..., None] > s.wm_rev)

        def x(v):  # a per-node value against a [L,N,K|OPS] leaf
            return v[..., None]

        state = s._replace(
            epoch=epoch,
            role=role,
            last_hb=last_hb,
            claim_acks=claim_acks,
            claim_t=torch.where(claim, now, s.claim_t),
            kv_val=torch.where(
                ca_newer, r_val,
                torch.where(wrep_apply, x(f3),
                            torch.where(wack_apply, x(s.pend_val), s.kv_val)),
            ),
            kv_rev=torch.where(
                ca_newer, r_rev,
                torch.where(wrep_apply, x(f1),
                            torch.where(wack_apply, x(s.pend_rev), s.kv_rev)),
            ),
            pend_kind=torch.where(
                accept | won | commit_w | commit_r, 0,
                torch.where(
                    start, f1,
                    torch.where(start_rec, OP_WRITE, t_pend_kind),
                ),
            ),
            pend_key=torch.where(
                start, f2, torch.where(start_rec, rec_key, s.pend_key)
            ),
            pend_val=torch.where(
                start, f3, torch.where(start_rec, rec_val, s.pend_val)
            ),
            pend_rev=torch.where(
                start, rid, torch.where(start_rec, rid_rec, s.pend_rev)
            ),
            pend_acks=torch.where(start | start_rec, bit(nid), pend_acks),
            pend_client=torch.where(start, src, s.pend_client),
            pend_tinv=torch.where(start, f4, s.pend_tinv),
            pend_t=torch.where(start | start_rec, now, s.pend_t),
            pend_recover=torch.where(
                accept | commit_w, 0,
                torch.where(
                    start_rec, 1,
                    torch.where(pend_expired, 0, s.pend_recover),
                ),
            ),
            recover_left=torch.where(
                won, K,
                torch.where(
                    commit_w & is_rec,
                    torch.clamp(s.recover_left - 1, min=0),
                    s.recover_left,
                ),
            ),
            wcount=torch.where(
                won, 0,
                s.wcount + start.to(i32) + start_rec.to(i32),
            ),
            creq_kind=torch.where(
                rmatch, 0, torch.where(issue, op_kind, t_creq_kind)
            ),
            creq_key=torch.where(issue, op_key, s.creq_key),
            creq_val=torch.where(issue, op_val, s.creq_val),
            creq_t=torch.where(issue, now, s.creq_t),
            ccount=s.ccount + (issue & is_write_t).to(i32),
            h_kind=torch.where(at_o, x(f1), s.h_kind),
            h_key=torch.where(at_o, x(f2), s.h_key),
            h_val=torch.where(at_o, x(f3), s.h_val),
            h_rev=torch.where(at_o, x(f4), s.h_rev),
            h_tinv=torch.where(at_o, x(s.creq_t), s.h_tinv),
            h_trsp=torch.where(at_o, x(now), s.h_trsp),
            h_len=s.h_len + rmatch.to(i32),
            wm_rev=torch.where(raise_wm, x(f4), s.wm_rev),
            wm_t=torch.where(raise_wm, x(now), s.wm_t),
            la_kind=torch.where(rmatch, f1, s.la_kind),
            la_key=torch.where(rmatch, f2, s.la_key),
            la_val=torch.where(rmatch, f3, s.la_val),
            la_rev=torch.where(rmatch, f4, s.la_rev),
            la_tinv=torch.where(rmatch, s.creq_t, s.la_tinv),
            la_trsp=torch.where(rmatch, now, s.la_trsp),
        )

        # -- outbox: at most one reply (row dst) OR one broadcast (CREQ)
        zero = torch.zeros_like(epoch)
        ca_fields = torch.cat(
            [epoch[..., None], s.kv_val, s.kv_rev]
            + [zero[..., None]] * (P - 1 - 2 * K), dim=-1,
        )  # CLAIM_ACK carries the whole (unmodified-by-claim) store
        reply_valid = (
            accept | wrep_ok | (is_rprobe & (f0 >= s.epoch))
            | (commit_w & ~is_rec) | commit_r
        )
        reply_dst = torch.where(commit_w | commit_r, s.pend_client, src)
        reply_kind = torch.where(
            accept, CLAIM_ACK,
            torch.where(wrep_ok, WACK, torch.where(is_rprobe, RACK, CRSP)),
        ).to(i32)

        def sel(cond, a, b):  # per-node condition over [L,N,P] rows
            return torch.where(cond[..., None], a, b)

        reply_pay = sel(
            accept, ca_fields,
            sel(
                wrep_ok, fields(epoch, f1),
                sel(
                    is_rprobe, fields(epoch, f1),
                    sel(
                        commit_w,
                        fields(s.epoch, OP_WRITE, s.pend_key, s.pend_val,
                               s.pend_rev, s.pend_tinv),
                        fields(s.epoch, OP_READ, s.pend_key, cur_val,
                               cur_rev, s.pend_tinv),
                    ),
                ),
            ),
        )
        is_write = f1 == OP_WRITE
        bc_pay = sel(
            is_write, fields(s.epoch, rid, f2, f3), fields(s.epoch, rid, f2)
        )
        bc_kind = torch.where(is_write, WREP, RPROBE).to(i32)

        # ================== merged outbox (E = N + 1 rows) ================
        # timer event: rows 0..N-1 broadcast (CLAIM when claiming, the
        # recovery WREP when re-committing, else HB), row N the client
        # CREQ. Message event: rows 0..N-1 carry the quorum broadcast
        # (start) or the single reply; row N unused.
        bc_valid_t = (
            is_timer[..., None] & (peers != nid[..., None])
            & (is_primary_t | claim)[..., None]
        )
        bc_kind_t = torch.where(
            claim, CLAIM, torch.where(start_rec, WREP, HB)
        ).to(i32)
        bc_pay_t = sel(
            start_rec, fields(t_epoch, rid_rec, rec_key, rec_val),
            fields(t_epoch),
        )
        creq_pay = fields(t_epoch, op_kind, op_key, op_val, now)

        rows = nid.shape + (N,)
        at_row = peers == reply_dst[..., None]  # [L,N,N]
        tx, stx = is_timer[..., None], start[..., None]
        out = Outbox(
            valid=torch.cat([
                torch.where(
                    tx, bc_valid_t,
                    torch.where(
                        stx, peers != nid[..., None],
                        reply_valid[..., None] & at_row,
                    ),
                ),
                issue[..., None],
            ], dim=-1),
            dst=torch.cat([
                torch.where(
                    tx | stx, peers, reply_dst[..., None].expand(rows)
                ),
                believed_primary[..., None],
            ], dim=-1),
            kind=torch.cat([
                torch.where(
                    is_timer, bc_kind_t,
                    torch.where(start, bc_kind, reply_kind),
                )[..., None].expand(rows),
                torch.full(nid.shape + (1,), CREQ, dtype=i32, device=dev),
            ], dim=-1),
            payload=torch.cat([
                torch.where(
                    tx[..., None], bc_pay_t[..., None, :],
                    torch.where(
                        stx[..., None], bc_pay[..., None, :],
                        torch.where(
                            at_row[..., None], reply_pay[..., None, :], 0
                        ),
                    ),
                ),
                creq_pay[..., None, :],
            ], dim=-2),
        )
        return state, out, torch.where(is_timer, now + tick_us, -1)

    @wraps_event(on_event)
    def on_message(s: KvState, nid, src, kind, payload, now, key):
        return on_event(s, nid, src, kind, payload, now, key)

    @wraps_event(on_event)
    def on_timer(s: KvState, nid, now, key):
        z = torch.zeros_like(now)
        return on_event(
            s, nid, z, z - 1,
            torch.zeros(now.shape + (P,), dtype=i32, device=now.device),
            now, key,
        )

    # --------------------------------------------------------------- restart

    def on_restart(s: KvState, nid, now, key):
        """`now` is per lane [L]."""
        z = torch.zeros_like(s.role)
        now_n = torch.broadcast_to(now[:, None], s.role.shape)
        state = s._replace(
            role=z + REPLICA,
            last_hb=now_n,  # grace period before claiming
            claim_acks=z, claim_t=z,
            pend_kind=z, pend_acks=z, pend_recover=z, recover_left=z,
            creq_kind=z,
            wcount=z,
        )
        return state, now_n + prng.randint(key, 35, 0, tick_us)

    # ------------------------------------------------------------ invariants

    def check_invariants(ns: KvState, alive, now):
        """ok [L]: each node's most recently acked op (la_*) against every
        ring op, the watermarks, and value coherence."""
        kidx = torch.arange(K, dtype=i32, device=ns.role.device)
        la_ok = ns.la_kind > 0  # [L,N]
        valid = ns.h_kind > 0  # [L,N,OPS]

        def la(v):  # register value [L,Nla] -> [L,Nla,1,1]
            return v[:, :, None, None]

        def ring(v):  # ring value [L,N,X] -> [L,1,N,X]
            return v[:, None]

        base = (
            la(la_ok) & ring(valid) & (la(ns.la_key) == ring(ns.h_key))
        )  # [L,Nla,N,OPS]
        la_rev, h_rev = la(ns.la_rev), ring(ns.h_rev)
        bad_pair = (
            ((la(ns.la_tinv) > ring(ns.h_trsp)) & (la_rev < h_rev))
            | ((ring(ns.h_tinv) > la(ns.la_trsp)) & (h_rev < la_rev))
            | ((la_rev == h_rev) & (la(ns.la_val) != ring(ns.h_val)))
        )
        key_oh = la(ns.la_key) == kidx  # [L,Nla,1,K]
        wm_stale = (
            la(la_ok)
            & key_oh
            & (ring(ns.wm_t) < la(ns.la_tinv))
            & (ring(ns.wm_rev) > la_rev)
        )  # [L,Nla,N,K]
        return ~(
            (base & bad_pair).flatten(1).any(1)
            | wm_stale.flatten(1).any(1)
        )

    # ------------------------------------------------------------ diagnostics

    def lane_metrics(node):
        return {
            "rev_stride_pressure_lanes": (
                node.wcount > (REV_STRIDE * 3) // 4
            ).any(dim=-1),
            "history_wrapped_lanes": (node.h_len > OPS).any(dim=-1),
            "mean_acked_ops": node.h_len.sum(dim=-1, dtype=i32).to(
                torch.float32
            ),
        }

    return ProtocolSpec(
        name=f"kv{N}",
        n_nodes=N,
        payload_width=P,
        max_out=N + 1,  # broadcast + the client's CREQ
        max_out_msg=N + 1,
        init=init,
        on_message=on_message,
        on_timer=on_timer,
        on_event=on_event,
        on_restart=on_restart,
        check_invariants=check_invariants,
        lane_metrics=lane_metrics,
        msg_kind_names=(
            "HB", "CLAIM", "CLAIM_ACK", "WRITE_REP", "WRITE_ACK",
            "READ_PROBE", "READ_ACK", "CLIENT_REQ", "CLIENT_RSP",
        ),
        time_fields=(
            "last_hb", "claim_t", "pend_tinv", "pend_t", "creq_t",
            "h_tinv", "h_trsp", "wm_t", "la_tinv", "la_trsp",
        ),
        # the JAX face's storage narrowing table (this face stores wide);
        # it drives the narrow_horizon_us refusal below
        narrow_fields={
            "role": np.uint8,
            "pend_kind": np.uint8,
            "creq_kind": np.uint8,
            "h_kind": np.uint8,
            "pend_recover": np.uint8,
            "epoch": np.uint16,
            **({"claim_acks": np.uint8, "pend_acks": np.uint8}
               if N <= 8 else
               {"claim_acks": np.uint16, "pend_acks": np.uint16}
               if N <= 16 else {}),
            **({"pend_key": np.uint8, "creq_key": np.uint8,
                "h_key": np.uint8, "recover_left": np.uint8}
               if K <= 255 else {}),
        },
        rate_floors={
            "epoch": RateFloor(
                floor_us=hb_timeout_lo_us, ratchet=N, inc=2 * N - 1,
                why="a claim needs >= hb_timeout_lo of missed heartbeats "
                "(retry floor is higher); one claim jumps epoch by "
                "<= 2N-1; N claimers ratchet the global max per window",
            ),
        },
        narrow_horizon_us=(
            65_535 * hb_timeout_lo_us // (N * (2 * N - 1))
        ),
    )


def buggy_local_read_spec(base: "ProtocolSpec | None" = None, **kw) -> ProtocolSpec:
    """The injected stale-read bug: any node answers a read CREQ at once
    from its local store, skipping the quorum probe. Wraps the fused
    handler (kind == -1 never matches CREQ, so the bug is message-only)."""
    spec = base or make_kv_spec(**kw)
    inner_on_event = spec.on_event
    P = spec.payload_width

    def on_event(s, nid, src, kind, payload, now, key):
        state, out, timer = inner_on_event(s, nid, src, kind, payload, now, key)
        is_read_req = (kind == CREQ) & (payload[..., 1] == OP_READ)
        K = s.kv_val.shape[-1]
        at = torch.arange(K, dtype=torch.int32, device=nid.device) == (
            payload[..., 2][..., None]
        )
        local_val = select_sum(at, s.kv_val)
        local_rev = select_sum(at, s.kv_rev)
        # overwrite slot 0 of the outbox with an immediate local answer
        E = out.valid.shape[-1]
        slot0 = torch.arange(E, device=nid.device) == 0
        bug_pay = stack_fields(
            s.epoch, OP_READ, payload[..., 2], local_val, local_rev,
            payload[..., 4], width=P,
        )
        hit = is_read_req[..., None] & slot0  # [L,N,E]
        out = Outbox(
            valid=torch.where(is_read_req[..., None], slot0, out.valid),
            dst=torch.where(hit, src[..., None], out.dst),
            kind=torch.where(hit, CRSP, out.kind),
            payload=torch.where(
                hit[..., None], bug_pay[..., None, :], out.payload
            ),
        )
        return state, out, timer

    @wraps_event(on_event)
    def on_timer(s, nid, now, key):
        z = torch.zeros_like(now)
        return on_event(
            s, nid, z, z - 1,
            torch.zeros(now.shape + (P,), dtype=torch.int32,
                        device=now.device),
            now, key,
        )

    return dataclasses.replace(
        spec, on_event=on_event, on_message=on_event, on_timer=on_timer
    )


def kv_workload(
    n_nodes: int = 5,
    virtual_secs: float = 10.0,
    loss_rate: float = 0.05,
    partitions: bool = True,
    spec: "ProtocolSpec | None" = None,
    ops_capacity: "int | None" = None,
    device="cuda",
):
    """The replicated-KV linearizability fuzz (the JAX face's config): the
    history ring sized to the horizon, partitions and loss, and the exact
    per-key linearizability check wired as the workload's `lane_check`.
    `host_repro` re-runs a seed as one engine lane on `device` (the card
    unless the caller asks for the CPU) under the exact checker, then on
    the host twin."""
    from .batch import BatchWorkload

    if ops_capacity is None:
        ops_capacity = max(24, min(128, int(virtual_secs * 6.4)))
    the_spec = (
        spec if spec is not None
        else make_kv_spec(n_nodes=n_nodes, ops_capacity=ops_capacity)
    )
    pool_kw = pool_kw_for(
        the_spec,
        fused=dict(msg_depth_msg=2, msg_spare_slots=2),
        two_handler=dict(msg_depth_msg=3, msg_depth_timer=2),
    )
    cfg = SimConfig(
        horizon_us=int(virtual_secs * 1e6),
        **pool_kw,
        loss_rate=loss_rate,
        partition_interval_lo_us=400_000 if partitions else 0,
        partition_interval_hi_us=2_000_000 if partitions else 0,
        partition_heal_lo_us=500_000,
        partition_heal_hi_us=2_000_000,
    )

    def lane_check(state, lanes):
        """Per-key Wing-Gong linearizability over the recorded histories."""
        from . import linearize

        return linearize.check_lanes(state.node, lanes)

    def host_repro(seed: int):
        """Two microscopes for one seed: (a) re-run it as one engine lane
        on `device` and hand the full history to the exact
        linearizability checker; (b) run the host twin
        (workloads/kv_host.py) under the same seed's chaos flavor,
        verified by the same oracle."""
        from . import linearize
        from ..workloads import kv_host
        from .engine import BatchedSim

        sim = BatchedSim(the_spec, cfg, device=device)
        state = sim.run([seed], max_steps=int(virtual_secs * 1200) + 2000)
        out = {"device": linearize.check_lane(state.node, 0)}
        try:
            out["host_twin"] = kv_host.fuzz_one_seed(
                seed, n_nodes=n_nodes, virtual_secs=virtual_secs,
                loss_rate=loss_rate, partitions=partitions,
            )
        except Exception as e:  # noqa: BLE001 - the twin's failure IS the
            # finding; it must never discard the computed device verdict
            out["host_twin"] = e
        out["violations"] = out["device"]["violations"]
        return out

    return BatchWorkload(
        spec=the_spec,
        config=cfg,
        host_repro=host_repro,
        lane_check=lane_check,
        lane_check_sample=64,
    )
