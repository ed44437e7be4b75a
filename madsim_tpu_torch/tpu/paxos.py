"""Single-decree Paxos as [L, N]-batched PyTorch handlers.

The port of `madsim_tpu/tpu/paxos.py`: ballot-numbered two-phase consensus
where every node is proposer, acceptor and learner at once. An undecided
node's timer starts a PREPARE round with a fresh unique ballot; on a
promise majority the proposer pushes the highest-ballot accepted value it
discovered (its own only if phase 1 found none); on an ACCEPTED majority it
decides and broadcasts DECIDED, and decided nodes gossip the decision.
Safety invariant: AGREEMENT, all recorded decisions in a lane name one
value.

Every expression is the JAX face's, written over explicit leading [L, N]
axes; the spec is fused from its two handlers by `fuse_two_handlers` as on
the JAX face, so both run the same trajectories bit for bit
(tests/test_torch_workloads.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .spec import (
    Outbox, ProtocolSpec, SimConfig, bit, fuse_two_handlers, majority,
    pool_kw_for, stack_fields,
)

PREPARE, PROMISE, ACCEPT, ACCEPTED, DECIDED = range(5)
PAYLOAD_WIDTH = 3  # (ballot, value, acc_ballot)


class PaxosState(NamedTuple):
    """Per-node Paxos state, int32 leaves [L, N]."""

    promised: torch.Tensor  # highest ballot promised (durable)
    acc_bal: torch.Tensor  # accepted ballot, -1 none (durable)
    acc_val: torch.Tensor  # accepted value (durable)
    decided: torch.Tensor  # decided value, 0 none (durable)
    prop_bal: torch.Tensor  # my live ballot, -1 none
    prop_phase: torch.Tensor  # 0 idle | 1 preparing | 2 accepting
    prop_val: torch.Tensor  # value being pushed in phase 2
    best_bal: torch.Tensor  # highest accepted ballot seen in phase 1
    best_val: torch.Tensor  # its value
    acks: torch.Tensor  # bitmask (promises or accepteds for prop_bal)
    round: torch.Tensor  # ballot round counter (durable)


def make_paxos_spec(
    n_nodes: int = 5,
    retry_lo_us: int = 150_000,
    retry_hi_us: int = 400_000,
    gossip_us: int = 200_000,
    buggy_ignore_discovered: bool = False,
) -> ProtocolSpec:
    """The JAX face's make_paxos_spec, same parameters and draws.
    `buggy_ignore_discovered=True` plants the canonical Paxos mistake:
    phase 2 proposes the proposer's own value even when phase 1 discovered
    an accepted one."""
    N = n_nodes
    i32 = torch.int32

    def peers_of(like):
        return torch.arange(N, dtype=i32, device=like.device)

    def broadcast_rows(row, like):
        """[L,N,P] payload row -> [L,N,N,P] (every outbox row the same)."""
        return torch.broadcast_to(row[..., None, :], like.shape + (N, PAYLOAD_WIDTH))

    # ------------------------------------------------------------------ init

    def init(key, nid):
        L = key.shape[0]

        def full(v):
            return torch.full((L, N), v, dtype=i32, device=key.device)

        state = PaxosState(
            promised=full(-1), acc_bal=full(-1), acc_val=full(0),
            decided=full(0), prop_bal=full(-1), prop_phase=full(0),
            prop_val=full(0), best_bal=full(-1), best_val=full(0),
            acks=full(0), round=full(0),
        )
        return state, prng.randint(key, 40, 0, retry_hi_us)

    # ----------------------------------------------------------------- timer

    def on_timer(s: PaxosState, nid, now, key):
        peers = peers_of(nid)
        is_decided = s.decided != 0
        new_round = s.round + 1
        bal = new_round * N + nid
        start = ~is_decided
        # the proposer's own node is an acceptor too: it self-promises
        # (recorded) only if the fresh ballot beats every prior promise,
        # and phase 1 starts from its own accepted (ballot, value)
        self_prom = start & (bal > s.promised)
        state = s._replace(
            promised=torch.where(self_prom, bal, s.promised),
            prop_bal=torch.where(start, bal, s.prop_bal),
            prop_phase=torch.where(start, 1, s.prop_phase),
            prop_val=torch.where(start, nid * 100_000 + new_round, s.prop_val),
            best_bal=torch.where(start, s.acc_bal, s.best_bal),
            best_val=torch.where(start, s.acc_val, s.best_val),
            acks=torch.where(
                start, torch.where(self_prom, bit(nid), 0), s.acks
            ),
            round=torch.where(start, new_round, s.round),
        )
        pay = torch.where(
            is_decided[..., None],
            stack_fields(0, s.decided, 0),
            stack_fields(bal, 0, 0),
        )
        out = Outbox(
            valid=peers != nid[..., None],
            dst=torch.broadcast_to(peers, nid.shape + (N,)),
            kind=torch.broadcast_to(
                torch.where(is_decided, DECIDED, PREPARE).to(i32)[..., None],
                nid.shape + (N,),
            ),
            payload=broadcast_rows(pay, nid),
        )
        timer = now + torch.where(
            is_decided, gossip_us,
            prng.randint(key, 41, retry_lo_us, retry_hi_us),
        )
        return state, out, timer

    # --------------------------------------------------------------- message

    def on_message(s: PaxosState, nid, src, kind, payload, now, key):
        """All five kinds, mask-merged."""
        peers = peers_of(nid)
        bal, val, a_bal = payload[..., 0], payload[..., 1], payload[..., 2]
        is_prep = kind == PREPARE
        is_prom = kind == PROMISE
        is_acc = kind == ACCEPT
        is_acd = kind == ACCEPTED
        is_dec = kind == DECIDED

        # -- acceptor: promise iff the ballot beats any prior promise;
        # accept iff not promised beyond this ballot
        prep_ok = is_prep & (bal > s.promised)
        acc_ok = is_acc & (bal >= s.promised)
        promised = torch.where(
            prep_ok | acc_ok, torch.maximum(s.promised, bal), s.promised
        )
        acc_bal = torch.where(acc_ok, bal, s.acc_bal)
        acc_val = torch.where(acc_ok, val, s.acc_val)

        # -- proposer, PROMISE tally (phase 1)
        p_live = (s.prop_phase == 1) & (bal == s.prop_bal)
        prom_mine = is_prom & p_live
        acks = torch.where(prom_mine, s.acks | bit(src), s.acks)
        better = prom_mine & (a_bal > s.best_bal)
        best_bal = torch.where(better, a_bal, s.best_bal)
        best_val = torch.where(better, val, s.best_val)
        to_phase2 = prom_mine & majority(acks, N)
        # THE rule: push the discovered value when one exists
        if buggy_ignore_discovered:
            push_val = s.prop_val
        else:
            push_val = torch.where(best_bal >= 0, best_val, s.prop_val)

        # -- proposer, ACCEPTED tally (phase 2)
        a_live = (s.prop_phase == 2) & (bal == s.prop_bal)
        acd_mine = is_acd & a_live
        acks = torch.where(acd_mine, acks | bit(src), acks)
        wins = acd_mine & majority(acks, N)

        # -- learner
        decided = torch.where(
            is_dec & (s.decided == 0), val,
            torch.where(wins & (s.decided == 0), s.prop_val, s.decided),
        )

        # entering phase 2, the proposer self-accepts (recorded) iff its
        # ballot still satisfies its own acceptor's promise
        self_acc = to_phase2 & (s.prop_bal >= promised)
        state = s._replace(
            promised=torch.where(
                self_acc, torch.maximum(promised, s.prop_bal), promised
            ),
            acc_bal=torch.where(self_acc, s.prop_bal, acc_bal),
            acc_val=torch.where(self_acc, push_val, acc_val),
            decided=decided,
            prop_phase=torch.where(
                to_phase2, 2, torch.where(wins, 0, s.prop_phase)
            ),
            prop_val=torch.where(to_phase2, push_val, s.prop_val),
            best_bal=best_bal,
            best_val=best_val,
            acks=torch.where(
                to_phase2, torch.where(self_acc, bit(nid), 0), acks
            ),
        )

        # -- outbox: replies are single-target (row `src`); phase
        # transitions broadcast from all rows
        bc = to_phase2 | wins
        bc_kind = torch.where(to_phase2, ACCEPT, DECIDED).to(torch.int32)
        bc_pay = torch.where(
            to_phase2[..., None],
            stack_fields(s.prop_bal, push_val, 0),
            stack_fields(0, decided, 0),
        )
        reply = prep_ok | acc_ok
        r_kind = torch.where(is_prep, PROMISE, ACCEPTED).to(torch.int32)
        r_pay = torch.where(
            is_prep[..., None],
            stack_fields(bal, s.acc_val, s.acc_bal),
            stack_fields(bal, 0, 0),
        )
        at_row = peers == torch.where(bc, -1, src)[..., None]  # [L,N,N]
        bcx = bc[..., None]
        out = Outbox(
            valid=torch.where(bcx, peers != nid[..., None], reply[..., None] & at_row),
            dst=torch.where(bcx, peers, src[..., None]),
            kind=torch.broadcast_to(
                torch.where(bc, bc_kind, r_kind)[..., None], nid.shape + (N,)
            ),
            payload=torch.where(
                bcx[..., None],
                broadcast_rows(bc_pay, nid),
                torch.where(at_row[..., None], r_pay[..., None, :], 0),
            ),
        )
        return state, out, torch.full_like(now, -1)

    # --------------------------------------------------------------- restart

    def on_restart(s: PaxosState, nid, now, key):
        """`now` is per lane [L]."""
        state = s._replace(
            prop_bal=torch.full_like(s.prop_bal, -1),
            prop_phase=torch.zeros_like(s.prop_phase),
            prop_val=torch.zeros_like(s.prop_val),
            best_bal=torch.full_like(s.best_bal, -1),
            best_val=torch.zeros_like(s.best_val),
            acks=torch.zeros_like(s.acks),
        )
        return state, now[:, None] + prng.randint(key, 42, 0, retry_hi_us)

    # ------------------------------------------------------------ invariants

    def check_invariants(ns: PaxosState, alive, now):
        """ok [L]: AGREEMENT, all nonzero decisions equal."""
        d = ns.decided
        have = d != 0
        disagree = (
            have[:, :, None] & have[:, None, :]
            & (d[:, :, None] != d[:, None, :])
        )
        return ~disagree.flatten(1).any(1)

    def lane_metrics(node):
        have = node.decided != 0  # [L,N]
        return {
            "all_decided_lanes": have.all(dim=-1),
            "mean_decided_nodes": have.sum(dim=-1, dtype=i32).to(torch.float32),
        }

    return fuse_two_handlers(ProtocolSpec(
        name=f"paxos{N}",
        n_nodes=N,
        payload_width=PAYLOAD_WIDTH,
        max_out=N,
        max_out_msg=N,  # a final PROMISE/ACCEPTED triggers a broadcast
        init=init,
        on_message=on_message,
        on_timer=on_timer,
        on_restart=on_restart,
        check_invariants=check_invariants,
        lane_metrics=lane_metrics,
        msg_kind_names=("PREPARE", "PROMISE", "ACCEPT", "ACCEPTED", "DECIDED"),
        # the JAX face's storage narrowing table (this face stores wide)
        narrow_fields={
            "prop_phase": np.uint8,
            **({"acks": np.uint8} if N <= 8 else
               {"acks": np.uint16} if N <= 16 else {}),
        },
        rate_floors={},
    ))


def paxos_workload(n_nodes: int = 5, virtual_secs: float = 10.0,
                   loss_rate: float = 0.1):
    """Single-decree consensus under the full chaos battery (the JAX face's
    config). A violating seed gets both microscopes: the device trace and
    the host twin (workloads/paxos_host.py, verified by the same agreement
    oracle) through `host_repro`."""
    from ..workloads import paxos_host
    from .batch import BatchWorkload, twin_repro

    host_repro = twin_repro(
        paxos_host.fuzz_one_seed, paxos_host.InvariantViolation,
        n_nodes=n_nodes, virtual_secs=virtual_secs,
        loss_rate=loss_rate,
    )

    the_spec = make_paxos_spec(n_nodes)
    pool_kw = pool_kw_for(
        the_spec,
        fused=dict(msg_depth_msg=2, msg_spare_slots=2),
        two_handler=dict(msg_depth_msg=3, msg_depth_timer=2),
    )
    cfg = SimConfig(
        horizon_us=int(virtual_secs * 1e6),
        **pool_kw,
        loss_rate=loss_rate,
        crash_interval_lo_us=400_000,
        crash_interval_hi_us=2_000_000,
        restart_delay_lo_us=200_000,
        restart_delay_hi_us=1_000_000,
        partition_interval_lo_us=300_000,
        partition_interval_hi_us=1_500_000,
        partition_heal_lo_us=400_000,
        partition_heal_hi_us=1_500_000,
    )
    return BatchWorkload(spec=the_spec, config=cfg, host_repro=host_repro)
