"""Chain replication as [L, N]-batched PyTorch handlers.

The port of `madsim_tpu/tpu/chain.py`: a fixed linear topology 0 (head) ->
N-1 (tail). Writes enter at the head, which assigns a per-key monotone
version and forwards hop by hop with per-hop acks and retransmission;
writes commit when they reach the tail, which acks the writing client;
linearizable reads are served at the tail. Every node is also a client
with one outstanding op.

Device invariants per lane: chain monotonicity (versions never increase
downstream), version coherence (same (key, version) => same value), and
client-observed monotonicity against per-(node, key) acked watermarks.

Planted bugs, as on the JAX face: `buggy_blind_apply` drops the
apply-if-newer guard, so a late duplicate forward rolls a replica's store
back and chain monotonicity fires; `buggy_read_at_head` serves reads at
the head (a dirty read the per-step oracle cannot see, since head-assigned
versions are globally monotone).

Every expression is the JAX face's over explicit leading [L, N] axes; its
one-hot multiply-and-sum lookups become select-and-sum
(tests/test_torch_workloads.py holds both faces equal).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .spec import (
    Outbox, ProtocolSpec, SimConfig, fuse_two_handlers, pool_kw_for,
    select_sum, stack_fields,
)

FWD, HACK, WREQ, RREQ, RRSP, CACK = range(6)
OP_READ, OP_WRITE = 1, 2
PAYLOAD_WIDTH = 5  # (key, val, ver, writer, echo_t)


class ChainState(NamedTuple):
    """Per-node chain state, int32 leaves [L, N] or [L, N, K]."""

    kv_val: torch.Tensor  # [K] (durable)
    kv_ver: torch.Tensor  # [K] (durable)
    vnext: torch.Tensor  # [K] head's next version per key (durable)
    fw_valid: torch.Tensor  # the one outstanding forward (volatile)
    fw_key: torch.Tensor
    fw_val: torch.Tensor
    fw_ver: torch.Tensor
    fw_writer: torch.Tensor
    fw_echo: torch.Tensor  # the writer's invocation-time echo
    fw_t: torch.Tensor  # last (re)transmit time
    creq_kind: torch.Tensor  # client side (volatile), 0 = none
    creq_key: torch.Tensor
    creq_t: torch.Tensor
    ccount: torch.Tensor  # (durable)
    wm_ver: torch.Tensor  # [K] oracle memory (durable)
    wm_t: torch.Tensor  # [K]
    la_kind: torch.Tensor  # most recently acked op register
    la_key: torch.Tensor
    la_ver: torch.Tensor
    la_tinv: torch.Tensor


def make_chain_spec(
    n_nodes: int = 5,
    n_keys: int = 4,
    tick_us: int = 20_000,
    retx_us: int = 60_000,
    req_timeout_us: int = 300_000,
    client_rate: float = 0.6,
    write_frac: float = 0.5,
    buggy_read_at_head: bool = False,
    buggy_blind_apply: bool = False,
) -> ProtocolSpec:
    """The JAX face's make_chain_spec, same parameters and draws."""
    N, K = n_nodes, n_keys
    assert N >= 3
    HEAD, TAIL = 0, N - 1
    i32 = torch.int32
    client_p = prng.f32(client_rate)
    write_p = prng.f32(write_frac)

    def kidx_of(like):
        return torch.arange(K, dtype=i32, device=like.device)

    # ------------------------------------------------------------------ init

    def init(key, nid):
        L = key.shape[0]

        def full(v, shape=()):
            return torch.full((L, N) + shape, v, dtype=i32, device=key.device)

        state = ChainState(
            kv_val=full(0, (K,)), kv_ver=full(0, (K,)), vnext=full(1, (K,)),
            fw_valid=full(0), fw_key=full(0), fw_val=full(0), fw_ver=full(0),
            fw_writer=full(0), fw_echo=full(0), fw_t=full(0),
            creq_kind=full(0), creq_key=full(0), creq_t=full(0),
            ccount=full(1),
            wm_ver=full(0, (K,)), wm_t=full(0, (K,)),
            la_kind=full(0), la_key=full(0), la_ver=full(0), la_tinv=full(0),
        )
        return state, prng.randint(key, 50, 0, tick_us)

    # ----------------------------------------------------------------- timer

    def on_timer(s: ChainState, nid, now, key):
        is_tail = nid == TAIL
        # retransmit the pending forward to the next hop
        retx = (s.fw_valid > 0) & ~is_tail & (now - s.fw_t > retx_us)
        # client: expire a stuck request, maybe issue a new one
        req_expired = (s.creq_kind > 0) & (now - s.creq_t > req_timeout_us)
        creq_kind = torch.where(req_expired, 0, s.creq_kind)
        issue = (creq_kind == 0) & (prng.uniform(key, 51) < client_p)
        is_write = prng.uniform(key, 52) < write_p
        op_kind = torch.where(is_write, OP_WRITE, OP_READ).to(i32)
        op_key = prng.randint(key, 53, 0, K)
        op_val = torch.where(is_write, nid * 100_000 + s.ccount, 0)
        read_target = HEAD if buggy_read_at_head else TAIL

        state = s._replace(
            fw_t=torch.where(retx, now, s.fw_t),
            creq_kind=torch.where(issue, op_kind, creq_kind),
            creq_key=torch.where(issue, op_key, s.creq_key),
            creq_t=torch.where(issue, now, s.creq_t),
            ccount=s.ccount + (issue & is_write).to(i32),
        )
        # row 0: the retransmitted FWD; row 1: the client op
        fwd_pay = stack_fields(
            s.fw_key, s.fw_val, s.fw_ver, s.fw_writer, s.fw_echo
        )
        req_pay = stack_fields(op_key, op_val, 0, nid, now)
        wr = issue & is_write
        out = Outbox(
            valid=torch.stack([retx, issue], dim=-1),
            dst=torch.stack([
                torch.clamp(nid + 1, max=N - 1),
                torch.where(wr, HEAD, read_target).to(i32),
            ], dim=-1),
            kind=torch.stack([
                torch.full_like(nid, FWD),
                torch.where(wr, WREQ, RREQ).to(i32),
            ], dim=-1),
            payload=torch.stack([fwd_pay, req_pay], dim=-2),
        )
        return state, out, now + tick_us

    # --------------------------------------------------------------- message

    def on_message(s: ChainState, nid, src, kind, payload, now, key):
        f = payload
        f0, f1, f2, f3, f4 = (f[..., i] for i in range(5))
        is_fwd = kind == FWD
        is_hack = kind == HACK
        is_wreq = kind == WREQ
        is_rreq = kind == RREQ
        is_rrsp = kind == RRSP
        is_cack = kind == CACK
        is_head = nid == HEAD
        is_tail = nid == TAIL
        at_k = kidx_of(nid) == f0[..., None]  # [L,N,K]

        # -- WREQ (head only): assign a fresh per-key version, apply,
        # take the forward slot (drop when busy: the client retries)
        w_ok = is_wreq & is_head & (s.fw_valid == 0) & (f1 != 0)
        new_ver = select_sum(at_k, s.vnext)
        w_apply = w_ok[..., None] & at_k

        # -- FWD: accept iff my slot is free (or I'm the tail);
        # apply-if-newer makes redelivery idempotent
        f_ok = is_fwd & (is_tail | (s.fw_valid == 0))
        if buggy_blind_apply:
            f_apply = f_ok[..., None] & at_k
        else:
            f_apply = f_ok[..., None] & at_k & (f2[..., None] > s.kv_ver)

        # -- HACK from downstream: clear the matching forward
        h_clear = is_hack & (s.fw_valid > 0) & (f2 == s.fw_ver) & (
            f0 == s.fw_key
        )

        # -- CACK / RRSP at the client: record the acked op (matched on
        # the echoed invocation time)
        mine = (is_cack | is_rrsp) & (s.creq_kind > 0) & (f4 == s.creq_t)
        raise_wm = mine[..., None] & at_k & (f2[..., None] > s.wm_ver)

        take_fw = w_ok | (f_ok & ~is_tail & is_fwd)
        state = s._replace(
            kv_val=torch.where(
                w_apply, f1[..., None],
                torch.where(f_apply, f1[..., None], s.kv_val),
            ),
            kv_ver=torch.where(
                w_apply, new_ver[..., None],
                torch.where(f_apply, f2[..., None], s.kv_ver),
            ),
            vnext=torch.where(w_apply, s.vnext + 1, s.vnext),
            fw_valid=torch.where(
                take_fw, 1, torch.where(h_clear, 0, s.fw_valid)
            ),
            fw_key=torch.where(take_fw, f0, s.fw_key),
            fw_val=torch.where(take_fw, f1, s.fw_val),
            fw_ver=torch.where(
                w_ok, new_ver, torch.where(take_fw, f2, s.fw_ver)
            ),
            fw_writer=torch.where(take_fw, f3, s.fw_writer),
            fw_echo=torch.where(take_fw, f4, s.fw_echo),
            fw_t=torch.where(take_fw, now, s.fw_t),
            creq_kind=torch.where(mine, 0, s.creq_kind),
            wm_ver=torch.where(raise_wm, f2[..., None], s.wm_ver),
            wm_t=torch.where(raise_wm, now[..., None], s.wm_t),
            la_kind=torch.where(
                mine, torch.where(is_cack, OP_WRITE, OP_READ).to(i32),
                s.la_kind,
            ),
            la_key=torch.where(mine, f0, s.la_key),
            la_ver=torch.where(mine, f2, s.la_ver),
            la_tinv=torch.where(mine, s.creq_t, s.la_tinv),
        )

        # -- outbox (2 rows). Row 0: the new FWD downstream or the read
        # response (the tail's HACK when it has neither). Row 1: the
        # hop-ack upstream or the tail's commit ack to the writer.
        fwd_ver = torch.where(w_ok, new_ver, f2)
        serve_read = is_rreq & (is_tail | buggy_read_at_head)
        r_val = select_sum(at_k, s.kv_val)
        r_ver = select_sum(at_k, s.kv_ver)
        row0_fwd = (w_ok | (f_ok & is_fwd)) & ~is_tail
        row0_valid = row0_fwd | serve_read
        row0_dst = torch.where(serve_read, src, torch.clamp(nid + 1, max=N - 1))
        row0_kind = torch.where(serve_read, RRSP, FWD).to(i32)
        row0_pay = torch.where(
            serve_read[..., None],
            stack_fields(f0, r_val, r_ver, f3, f4),
            stack_fields(f0, f1, fwd_ver, f3, f4),
        )
        row1_hack = f_ok & is_fwd
        row1_cack = f_ok & is_fwd & is_tail
        row1_valid = row1_hack | row1_cack
        row0_valid = row0_valid | (row1_hack & is_tail)
        tail_hack = row1_hack & is_tail & ~serve_read
        hack_pay = stack_fields(f0, 0, f2, 0, 0)
        upstream = torch.clamp(nid - 1, min=0)
        row0_dst = torch.where(tail_hack, upstream, row0_dst)
        row0_kind = torch.where(tail_hack, HACK, row0_kind).to(i32)
        row0_pay = torch.where(tail_hack[..., None], hack_pay, row0_pay)
        row1_dst = torch.where(row1_cack, f3, upstream)
        row1_kind = torch.where(row1_cack, CACK, HACK).to(i32)
        row1_pay = torch.where(
            row1_cack[..., None], stack_fields(f0, f1, f2, f3, f4), hack_pay
        )
        out = Outbox(
            valid=torch.stack([
                row0_valid, torch.where(is_tail, row1_cack, row1_valid)
            ], dim=-1),
            dst=torch.stack([row0_dst, row1_dst], dim=-1),
            kind=torch.stack([row0_kind, row1_kind], dim=-1),
            payload=torch.stack([row0_pay, row1_pay], dim=-2),
        )
        return state, out, torch.full_like(now, -1)

    # --------------------------------------------------------------- restart

    def on_restart(s: ChainState, nid, now, key):
        """`now` is per lane [L]."""
        state = s._replace(
            fw_valid=torch.zeros_like(s.fw_valid),
            creq_kind=torch.zeros_like(s.creq_kind),
        )
        return state, now[:, None] + prng.randint(key, 54, 0, tick_us)

    # ------------------------------------------------------------ invariants

    def check_invariants(ns: ChainState, alive, now):
        """ok [L]: chain monotonicity, version coherence, client-observed
        monotonicity."""
        ver, val = ns.kv_ver, ns.kv_val  # [L,N,K]
        mono = ~(ver[:, :-1] < ver[:, 1:]).flatten(1).any(1)
        same_ver = (ver[:, :, None, :] == ver[:, None, :, :]) & (
            ver[:, :, None, :] > 0
        )
        diff_val = val[:, :, None, :] != val[:, None, :, :]
        coherent = ~(same_ver & diff_val).flatten(1).any(1)
        la_ok = ns.la_kind > 0  # [L,N]
        key_oh = ns.la_key[:, :, None, None] == kidx_of(ver)  # [L,N,1,K]
        wm_stale = (
            la_ok[:, :, None, None]
            & key_oh
            & (ns.wm_t[:, None, :, :] < ns.la_tinv[:, :, None, None])
            & (ns.wm_ver[:, None, :, :] > ns.la_ver[:, :, None, None])
        )
        return mono & coherent & ~wm_stale.flatten(1).any(1)

    # ------------------------------------------------------------ diagnostics

    def lane_metrics(node):
        return {
            "mean_committed_vers": node.kv_ver[:, -1].sum(
                dim=-1, dtype=i32
            ).to(torch.float32),
            "mean_acked_like": node.ccount.sum(dim=-1, dtype=i32).to(
                torch.float32
            ),
        }

    return fuse_two_handlers(ProtocolSpec(
        name=f"chain{N}",
        n_nodes=N,
        payload_width=PAYLOAD_WIDTH,
        max_out=2,
        max_out_msg=2,
        init=init,
        on_message=on_message,
        on_timer=on_timer,
        on_restart=on_restart,
        check_invariants=check_invariants,
        lane_metrics=lane_metrics,
        msg_kind_names=("FWD", "HACK", "WREQ", "RREQ", "RRSP", "CACK"),
        time_fields=("fw_t", "fw_echo", "creq_t", "wm_t", "la_tinv"),
        # the JAX face's storage narrowing table (this face stores wide)
        narrow_fields={
            "fw_valid": np.uint8,
            "fw_writer": np.uint8,
            "creq_kind": np.uint8,
            "la_kind": np.uint8,
            **({"fw_key": np.uint8, "creq_key": np.uint8,
                "la_key": np.uint8} if K <= 255 else {}),
        },
        rate_floors={},
    ))


def chain_workload(n_nodes: int = 5, virtual_secs: float = 10.0,
                   loss_rate: float = 0.1):
    """Chain replication under loss + crash/restart chaos (the JAX face's
    config). A violating seed gets both microscopes: the device trace and
    the host twin (workloads/chain_host.py) through `host_repro`."""
    from ..workloads import chain_host
    from .batch import BatchWorkload, twin_repro

    spec = make_chain_spec(n_nodes)

    host_repro = twin_repro(
        chain_host.fuzz_one_seed, chain_host.InvariantViolation,
        n_nodes=n_nodes, virtual_secs=virtual_secs,
        loss_rate=loss_rate,
    )
    cfg = SimConfig(
        horizon_us=int(virtual_secs * 1e6),
        **pool_kw_for(
            spec,
            fused=dict(msg_depth_msg=2, msg_spare_slots=2),
            two_handler=dict(msg_depth_msg=2, msg_depth_timer=2),
        ),
        loss_rate=loss_rate,
        crash_interval_lo_us=400_000,
        crash_interval_hi_us=2_000_000,
        restart_delay_lo_us=200_000,
        restart_delay_hi_us=1_000_000,
    )
    return BatchWorkload(spec=spec, config=cfg, host_repro=host_repro)
