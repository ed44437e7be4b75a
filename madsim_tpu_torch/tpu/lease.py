"""etcd-family lease/watch as [L, N]-batched PyTorch handlers.

The port of `madsim_tpu/tpu/lease.py`: a lease server (node 0) grants
time-bound exclusive leases to client nodes, with keepalive renewal,
fenced release and a best-effort watch plane (NOTIFY). Every client draws a
durable incarnation nonce at init: a crash/restart keeps it, a reconfig
wipe-join re-runs init and draws a fresh one.

ACQUIRE(inc, req_t) is granted when the lease is free or expired and
renews when the caller is the current holder (holder id and incarnation
must both match); GRANT(token, expiry, echo) creates belief only against
the pending request. KA/KACK extend a live lease and bump the fencing
token; RELEASE(token, inc) frees the lease iff holder and token match; the
server's tick NOTIFYs one random watcher of the lease head.

Device invariant per lane: whenever the server records client i as holder
and i believes it holds the lease, the recorded incarnation is i's current
one.

Planted bug, as on the JAX face: `buggy_zombie_lease` matches a renewal on
the holder id alone, so a removed client rejoining with a fresh nonce
renews its old incarnation's live lease.

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

ACQUIRE, GRANT, KA, KACK, RELEASE, NOTIFY = range(6)
PAYLOAD_WIDTH = 3


class LeaseState(NamedTuple):
    """Per-node lease state, int32 leaves [L, N]."""

    inc: torch.Tensor  # incarnation nonce (durable, init-drawn)
    held: torch.Tensor  # 0|1 client belief (durable)
    my_token: torch.Tensor  # fencing token of my lease
    my_expiry: torch.Tensor  # server-stamped expiry
    pend: torch.Tensor  # 0|1 acquire outstanding (volatile)
    req_t: torch.Tensor  # acquire send time (GRANT echo)
    ka_t: torch.Tensor  # last keepalive send time
    wseen: torch.Tensor  # max token observed via NOTIFY (diagnostics)
    l_holder: torch.Tensor  # lease head (server only): node id, -1 free
    l_inc: torch.Tensor  # holder's incarnation at grant
    l_token: torch.Tensor  # monotone fencing token
    l_expiry: torch.Tensor


def make_lease_spec(
    n_nodes: int = 5,
    tick_us: int = 25_000,
    ttl_us: int = 1_500_000,
    ka_interval_us: int = 200_000,
    req_timeout_us: int = 300_000,
    acquire_rate: float = 0.5,
    release_rate: float = 0.04,
    buggy_zombie_lease: bool = False,
) -> ProtocolSpec:
    """The JAX face's make_lease_spec, same parameters and draws."""
    N = n_nodes
    assert N >= 3
    SERVER = 0
    i32 = torch.int32
    acquire_p = prng.f32(acquire_rate)
    release_p = prng.f32(release_rate)

    # ------------------------------------------------------------------ init

    def init(key, nid):
        L = key.shape[0]

        def full(v):
            return torch.full((L, N), v, dtype=i32, device=key.device)

        state = LeaseState(
            inc=prng.randint(key, 70, 1, 1 << 30),
            held=full(0), my_token=full(0), my_expiry=full(0),
            pend=full(0), req_t=full(0), ka_t=full(0), wseen=full(0),
            l_holder=full(-1), l_inc=full(0), l_token=full(0),
            l_expiry=full(0),
        )
        return state, tick_us + prng.randint(key, 71, 0, tick_us)

    # ----------------------------------------------------------------- timer

    def on_timer(s: LeaseState, nid, now, key):
        is_server = nid == SERVER
        is_client = ~is_server
        # client: local expiry ends belief
        holding = is_client & (s.held > 0) & (now <= s.my_expiry)
        held = torch.where(is_client & (s.held > 0) & ~holding, 0, s.held)
        # client: release (rare), else keepalive, else maybe acquire
        send_rel = holding & (prng.uniform(key, 72) < release_p)
        held = torch.where(send_rel, 0, held)  # stop believing first
        send_ka = holding & ~send_rel & (now - s.ka_t > ka_interval_us)
        pend = torch.where(
            is_client & (s.pend > 0) & (now - s.req_t > req_timeout_us),
            0, s.pend,
        )
        send_acq = (
            is_client & ~holding & (held == 0) & (pend == 0)
            & (prng.uniform(key, 73) < acquire_p)
        )
        # server: watch plane, tell one random watcher the lease head
        watcher = prng.randint(key, 74, 1, N)

        state = s._replace(
            held=held,
            pend=torch.where(send_acq, 1, pend),
            req_t=torch.where(send_acq, now, s.req_t),
            ka_t=torch.where(send_ka, now, s.ka_t),
        )
        c_pay = torch.where(
            send_acq[..., None],
            stack_fields(s.inc, now, 0),
            torch.where(
                send_rel[..., None],
                stack_fields(s.my_token, s.inc, 0),
                stack_fields(s.inc, s.my_token, 0),  # KA
            ),
        )
        c_kind = torch.where(
            send_acq, ACQUIRE, torch.where(send_rel, RELEASE, KA)
        ).to(i32)
        out = Outbox(
            valid=(is_server | send_acq | send_rel | send_ka)[..., None],
            dst=torch.where(is_server, watcher, SERVER).to(i32)[..., None],
            kind=torch.where(is_server, NOTIFY, c_kind).to(i32)[..., None],
            payload=torch.where(
                is_server[..., None],
                stack_fields(s.l_token, s.l_holder, 0),
                c_pay,
            )[..., None, :],
        )
        return state, out, now + tick_us

    # --------------------------------------------------------------- message

    def on_message(s: LeaseState, nid, src, kind, payload, now, key):
        f = payload
        is_server = nid == SERVER
        live = now <= s.l_expiry

        # server: ACQUIRE, grant when free/expired, renew for the holder
        is_acq = (kind == ACQUIRE) & is_server
        if buggy_zombie_lease:
            # THE PLANTED BUG: renewal matches the holder node id alone
            match_holder = s.l_holder == src
        else:
            match_holder = (s.l_holder == src) & (s.l_inc == f[..., 0])
        free = (s.l_holder < 0) | ~live
        grant_new = is_acq & free
        renew = is_acq & ~free & match_holder
        granted = grant_new | renew
        # server: KA extends a live lease for the matching holder
        ka_ok = (kind == KA) & is_server & live & match_holder
        # every renewal bumps the fencing token
        bump = granted | ka_ok
        l_token = torch.where(bump, s.l_token + 1, s.l_token)
        # server: RELEASE frees iff holder and token match
        rel_ok = (
            (kind == RELEASE) & is_server
            & (s.l_holder == src) & (s.l_token == f[..., 0])
        )

        # client: GRANT, believe only against the pending request
        is_grant = (
            (kind == GRANT) & ~is_server & (s.pend > 0)
            & (f[..., 2] == s.req_t)
        )
        # client: KACK folds in the renewed token/expiry
        is_kack = (
            (kind == KACK) & ~is_server & (s.held > 0)
            & (f[..., 0] >= s.my_token)
        )
        # client: NOTIFY, the watch plane
        is_ntf = (kind == NOTIFY) & ~is_server

        state = s._replace(
            l_holder=torch.where(
                grant_new, src, torch.where(rel_ok, -1, s.l_holder)
            ),
            l_inc=torch.where(grant_new, f[..., 0], s.l_inc),
            l_token=l_token,
            l_expiry=torch.where(bump, now + ttl_us, s.l_expiry),
            held=torch.where(is_grant, 1, s.held),
            my_token=torch.where(is_grant | is_kack, f[..., 0], s.my_token),
            my_expiry=torch.where(
                is_grant, f[..., 1],
                torch.where(
                    is_kack, torch.maximum(s.my_expiry, f[..., 1]),
                    s.my_expiry,
                ),
            ),
            pend=torch.where(is_grant, 0, s.pend),
            ka_t=torch.where(is_grant, now, s.ka_t),
            wseen=torch.where(
                is_grant | is_kack | is_ntf,
                torch.maximum(s.wseen, f[..., 0]), s.wseen,
            ),
        )
        out = Outbox(
            valid=(granted | ka_ok)[..., None],
            dst=src.to(i32)[..., None],
            kind=torch.where(granted, GRANT, KACK).to(i32)[..., None],
            payload=stack_fields(
                l_token, now + ttl_us, torch.where(granted, f[..., 1], 0),
            )[..., None, :],
        )
        return state, out, torch.full_like(now, -1)

    # --------------------------------------------------------------- restart

    def on_restart(s: LeaseState, nid, now, key):
        """`now` is per lane [L]. inc/held/my_* are durable: a restarted
        client renews under the same incarnation."""
        state = s._replace(pend=torch.zeros_like(s.pend))
        return state, now[:, None] + tick_us + prng.randint(key, 75, 0, tick_us)

    # ------------------------------------------------------------ invariants

    def check_invariants(ns: LeaseState, alive, now):
        """ok [L]: a believing holder's recorded incarnation is current."""
        peers = torch.arange(N, dtype=i32, device=ns.inc.device)
        lh, li = ns.l_holder[:, SERVER], ns.l_inc[:, SERVER]  # [L]
        believer = (
            (peers != SERVER) & (ns.held > 0) & (now[:, None] <= ns.my_expiry)
        )
        checked = believer & (lh[:, None] == peers)
        ok = ~checked | (li[:, None] == ns.inc)
        return ok.all(-1)

    # ------------------------------------------------------------ diagnostics

    def lane_metrics(node):
        return {
            "mean_lease_token": node.l_token[:, SERVER].to(torch.float32),
            "mean_believers": (
                (node.held[:, 1:] > 0).sum(-1).to(torch.float32)
            ),
            "mean_wseen": node.wseen[:, 1:].amax(-1).to(torch.float32),
        }

    floor_why = (
        "the server bumps l_token at most once per arriving lease "
        "message; each client sends at most one lease message per tick "
        "(the timer's three sends are mutually exclusive, re-arm is "
        "now + tick_us, init/restart arm >= tick_us out), so <= N-1 "
        "bumps per tick window, doubled for the Duplicate clause"
    )
    return fuse_two_handlers(ProtocolSpec(
        name=f"lease{N}",
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
        msg_kind_names=("ACQUIRE", "GRANT", "KA", "KACK", "RELEASE",
                        "NOTIFY"),
        time_fields=("my_expiry", "req_t", "ka_t", "l_expiry"),
        # the JAX face's storage narrowing table (this face stores wide)
        narrow_fields={
            "held": np.uint8,
            "pend": np.uint8,
            "l_token": np.uint16,
            "my_token": np.uint16,
            "wseen": np.uint16,
        },
        rate_floors={
            "l_token": RateFloor(floor_us=tick_us, ratchet=2 * N, inc=1,
                                 why=floor_why),
            "my_token": RateFloor(floor_us=tick_us, ratchet=2 * N, inc=1,
                                  why="copy: GRANT/KACK payload of l_token"),
            "wseen": RateFloor(floor_us=tick_us, ratchet=2 * N, inc=1,
                               why="copy: max over observed l_token values"),
        },
        narrow_horizon_us=65_535 * tick_us // (4 * N),
    ))


def lease_workload(n_nodes: int = 5, virtual_secs: float = 10.0,
                   loss_rate: float = 0.1, buggy: bool = False):
    """Lease/watch under loss + crash + reconfig chaos (the JAX face's
    config). A violating seed gets both microscopes: the device trace and
    the host twin (workloads/lease_host.py) through `host_repro`."""
    from ..workloads import lease_host
    from .batch import BatchWorkload, twin_repro

    spec = make_lease_spec(n_nodes, buggy_zombie_lease=buggy)

    host_repro = twin_repro(
        lease_host.fuzz_one_seed, lease_host.InvariantViolation,
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
        # down windows well under ttl_us: the removed holder's lease is
        # still live when its fresh incarnation rejoins and re-acquires
        nem_reconfig_interval_lo_us=600_000,
        nem_reconfig_interval_hi_us=1_800_000,
        nem_reconfig_down_lo_us=300_000,
        nem_reconfig_down_hi_us=900_000,
    )
    return BatchWorkload(spec=spec, config=cfg, host_repro=host_repro)
