"""Kafka-family ISR log replication as [L, N]-batched PyTorch handlers.

The port of `madsim_tpu/tpu/isr.py`: a fixed leader (node 0) with a dynamic
In-Sync Replica set. Followers FETCH(leo, sent_t) every tick; the leader
applies a fetch only when its sent time beats the last one it applied from
that replica, records the acked offset `fa[src] = min(f_leo, leo)`, admits
the replica to the ISR iff that ack has caught up to the high watermark,
and replies FRESP(leo, hw, echo), which the follower adopts when the echo
matches its latest fetch. The leader produces on its tick, evicts replicas
whose last applied fetch is older than `repl_timeout_us`, and advances
`hw = max(hw, min over the ISR of fa)`.

Device invariants per lane (leader-local or node-local): every replica in
node 0's ISR has `fa[r] >= hw`, and `hw <= leo` on every node.

Planted bug, as on the JAX face: `buggy_stale_isr` re-admits a fetching
replica unconditionally, so a replica removed by the reconfig clause and
re-joined fresh (fetching at offset 0) re-enters the ISR behind `hw`.

Every expression is the JAX face's over explicit leading [L, N] axes
(tests/test_torch_membership.py holds both faces equal).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import prng
from .spec import (
    Outbox, ProtocolSpec, RateFloor, SimConfig, fuse_two_handlers,
    pool_kw_for, stack_fields,
)

FETCH, FRESP = range(2)
PAYLOAD_WIDTH = 3  # FETCH: (leo, sent_t, 0) / FRESP: (leo, hw, echo)


class IsrState(NamedTuple):
    """Per-node ISR state, int32 leaves [L, N] or [L, N, N]."""

    leo: torch.Tensor  # log end offset (durable)
    hw: torch.Tensor  # high watermark (leader authoritative)
    in_sync: torch.Tensor  # [N] 0|1, replica r in the ISR (leader only)
    fa: torch.Tensor  # [N] last acked offset per replica (leader only)
    lf_t: torch.Tensor  # [N] sent time of the last applied fetch
    ft: torch.Tensor  # sent time of my latest FETCH (volatile)


def make_isr_spec(
    n_nodes: int = 5,
    tick_us: int = 25_000,
    repl_timeout_us: int = 150_000,
    produce_rate: float = 0.7,
    buggy_stale_isr: bool = False,
) -> ProtocolSpec:
    """The JAX face's make_isr_spec, same parameters and draws."""
    N = n_nodes
    assert N >= 3
    LEADER = 0
    i32 = torch.int32
    produce_p = prng.f32(produce_rate)

    def peers_of(like):
        return torch.arange(N, dtype=i32, device=like.device)

    def _min_acked(member, fa):
        # min over ISR members' acked offsets; the leader's bit is pinned,
        # so falling back to fa[LEADER] gives the true member minimum
        return torch.where(member, fa, fa[..., LEADER:LEADER + 1]).amin(-1)

    # ------------------------------------------------------------------ init

    def init(key, nid):
        L = key.shape[0]

        def full(v, shape=()):
            return torch.full((L, N) + shape, v, dtype=i32, device=key.device)

        state = IsrState(
            leo=full(0), hw=full(0), in_sync=full(1, (N,)),
            fa=full(0, (N,)), lf_t=full(0, (N,)), ft=full(0),
        )
        return state, tick_us + prng.randint(key, 60, 0, tick_us)

    # ----------------------------------------------------------------- timer

    def on_timer(s: IsrState, nid, now, key):
        peers = peers_of(nid)
        is_leader = nid == LEADER
        # leader: produce at most one record per tick
        produce = is_leader & (prng.uniform(key, 61) < produce_p)
        leo = s.leo + produce.to(i32)
        fa = torch.where(
            (produce[..., None] & (peers == nid[..., None])),
            leo[..., None], s.fa,
        )
        # leader: evict replicas whose last applied fetch went stale; the
        # leader's own bit is pinned
        stale = (
            is_leader[..., None] & (peers != nid[..., None])
            & (now[..., None] - s.lf_t > repl_timeout_us)
        )
        in_sync = torch.where(stale, 0, s.in_sync)
        hw = torch.where(
            is_leader, torch.maximum(s.hw, _min_acked(in_sync > 0, fa)), s.hw
        )
        # follower: fetch every tick
        fetch = ~is_leader
        state = s._replace(
            leo=leo, hw=hw, in_sync=in_sync, fa=fa,
            ft=torch.where(fetch, now, s.ft),
        )
        zero = torch.zeros_like(nid)
        out = Outbox(
            valid=fetch[..., None],
            dst=zero[..., None] + LEADER,
            kind=zero[..., None] + FETCH,
            payload=stack_fields(s.leo, now, 0)[..., None, :],
        )
        return state, out, now + tick_us

    # --------------------------------------------------------------- message

    def on_message(s: IsrState, nid, src, kind, payload, now, key):
        f = payload
        peers = peers_of(nid)
        is_leader = nid == LEADER
        is_fetch = (kind == FETCH) & is_leader
        is_fresp = (kind == FRESP) & ~is_leader

        # leader: apply a fetch only when it beats the last applied one
        # from this replica (a wipe-join's offset regression applies)
        sel = (
            is_fetch[..., None] & (peers == src[..., None])
            & (f[..., 1:2] > s.lf_t)
        )  # [L,N,N]
        ack = torch.minimum(f[..., 0], s.leo)
        fa = torch.where(sel, ack[..., None], s.fa)
        lf_t = torch.where(sel, f[..., 1:2], s.lf_t)
        if buggy_stale_isr:
            # THE PLANTED BUG: unconditional re-admission
            in_sync = torch.where(sel, 1, s.in_sync)
        else:
            # Kafka contract: in the ISR iff caught up to the watermark
            in_sync = torch.where(
                sel, (ack >= s.hw).to(i32)[..., None], s.in_sync
            )
        hw = torch.where(
            is_fetch, torch.maximum(s.hw, _min_acked(in_sync > 0, fa)), s.hw
        )

        # follower: adopt the leader's (leo, hw) when the echo matches my
        # latest fetch
        adopt = is_fresp & (f[..., 2] == s.ft) & (s.ft > 0)
        resp_pay = stack_fields(s.leo, hw, f[..., 1])
        state = s._replace(
            leo=torch.where(adopt, f[..., 0], s.leo),
            hw=torch.where(adopt, f[..., 1], hw),
            in_sync=in_sync, fa=fa, lf_t=lf_t,
        )
        out = Outbox(
            valid=is_fetch[..., None],
            dst=src.to(i32)[..., None],
            kind=torch.zeros_like(nid)[..., None] + FRESP,
            payload=resp_pay[..., None, :],
        )
        return state, out, torch.full_like(now, -1)

    # --------------------------------------------------------------- restart

    def on_restart(s: IsrState, nid, now, key):
        """`now` is per lane [L]."""
        state = s._replace(ft=torch.zeros_like(s.ft))
        return state, now[:, None] + tick_us + prng.randint(key, 62, 0, tick_us)

    # ------------------------------------------------------------ invariants

    def check_invariants(ns: IsrState, alive, now):
        """ok [L]: the ISR catch-up contract and watermark sanity."""
        member = ns.in_sync[:, LEADER] > 0  # [L,N]
        fa0, hw0 = ns.fa[:, LEADER], ns.hw[:, LEADER]
        catch_up = ~(member & (fa0 < hw0[:, None])).any(-1)
        hw_sane = (ns.hw <= ns.leo).all(-1)
        return catch_up & hw_sane

    # ------------------------------------------------------------ diagnostics

    def lane_metrics(node):
        return {
            "mean_hw": node.hw[:, LEADER].to(torch.float32),
            "mean_isr_size": (
                node.in_sync[:, LEADER] > 0
            ).sum(-1).to(torch.float32),
        }

    floor_why = (
        "leo advances by at most 1 per leader tick: produce happens only "
        "in on_timer, the re-arm is always now + tick_us, and init/"
        "restart arm the first fire >= tick_us out"
    )
    return fuse_two_handlers(ProtocolSpec(
        name=f"isr{N}",
        n_nodes=N,
        payload_width=PAYLOAD_WIDTH,
        max_out=1,
        max_out_msg=1,
        init=init,
        on_message=on_message,
        on_timer=on_timer,
        on_restart=on_restart,
        check_invariants=check_invariants,
        lane_metrics=lane_metrics,
        msg_kind_names=("FETCH", "FRESP"),
        time_fields=("lf_t", "ft"),
        # the JAX face's storage narrowing table (this face stores wide)
        narrow_fields={
            "in_sync": np.uint8,
            "leo": np.uint16,
            "hw": np.uint16,
            "fa": np.uint16,
        },
        rate_floors={
            "leo": RateFloor(floor_us=tick_us, ratchet=1, inc=1,
                             why=floor_why),
            "hw": RateFloor(floor_us=tick_us, ratchet=1, inc=1,
                            why="copy: max/min over fa, itself leo copies"),
            "fa": RateFloor(floor_us=tick_us, ratchet=1, inc=1,
                            why="copy: min(fetched leo, own leo)"),
        },
        narrow_horizon_us=65_535 * tick_us // 2,
    ))


def isr_workload(n_nodes: int = 5, virtual_secs: float = 10.0,
                 loss_rate: float = 0.1, buggy: bool = False):
    """ISR replication under loss + crash + reconfig chaos (the JAX face's
    config). A violating seed gets both microscopes: the device trace and
    the host twin (workloads/isr_host.py) through `host_repro`."""
    from ..workloads import isr_host
    from .batch import BatchWorkload, twin_repro

    spec = make_isr_spec(n_nodes, buggy_stale_isr=buggy)

    host_repro = twin_repro(
        isr_host.fuzz_one_seed, isr_host.InvariantViolation,
        n_nodes=n_nodes, virtual_secs=virtual_secs,
        loss_rate=loss_rate, buggy=buggy,
    )

    cfg = SimConfig(
        horizon_us=int(virtual_secs * 1e6),
        **pool_kw_for(
            spec,
            fused=dict(msg_depth_msg=2, msg_spare_slots=2),
            two_handler=dict(msg_depth_msg=2, msg_depth_timer=2),
        ),
        loss_rate=loss_rate,
        crash_interval_lo_us=500_000,
        crash_interval_hi_us=2_000_000,
        restart_delay_lo_us=200_000,
        restart_delay_hi_us=900_000,
        # down windows comfortably above repl_timeout, so the removed
        # replica is evicted before its fresh join
        nem_reconfig_interval_lo_us=600_000,
        nem_reconfig_interval_hi_us=1_800_000,
        nem_reconfig_down_lo_us=300_000,
        nem_reconfig_down_hi_us=900_000,
    )
    return BatchWorkload(spec=spec, config=cfg, host_repro=host_repro)
