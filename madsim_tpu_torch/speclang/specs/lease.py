"""etcd-family lease/watch, as a speclang spec source.

The port of `madsim_tpu/speclang/specs/lease.py`: the same protocol as the
hand-written `tpu/lease.py` (lease server on node 0, keepalive renewal,
fenced release, best-effort watch plane, durable incarnation nonces
rotated only by reconfig wipe-joins; see that module's header),
re-derived. The two-handler bodies below are the port's hand module's
over [L, N] axes, verbatim (same ops, same PRNG sites 70-75, same state
field order); the state NamedTuple, init, on_restart, narrow_fields,
rate_floors, narrow_horizon_us, time_fields and msg_kind_names are
DERIVED from the `Field` declarations (copied from the JAX spec source).
The planted zombie-lease bug (`buggy_zombie_lease`) rides along as a spec
param, so the generated workload keeps the membership-axis planted-bug
contract.
"""

from __future__ import annotations

import torch

from ...tpu import prng
from ...tpu.spec import Outbox, SimConfig, pool_kw_for, stack_fields
from ..lang import Field, Protocol, Rate

ACQUIRE, GRANT, KA, KACK, RELEASE, NOTIFY = range(6)
PAYLOAD_WIDTH = 3
SERVER = 0

_TOKEN_WHY = (
    "the server bumps l_token at most once per arriving lease "
    "message; each client sends at most one lease message per tick "
    "(the timer's three sends are mutually exclusive, re-arm is "
    "now + tick_us, init/restart arm >= tick_us out), so <= N-1 "
    "bumps per tick window, doubled for the Duplicate clause"
)


def _fields(p):
    N = p.n_nodes
    # u16 token budget at <= 2N bumps per tick, halved again (margin=2)
    # for skew derating headroom; my_token and wseen hold COPIES of
    # l_token
    def tok_rate(why):
        return Rate(floor_us=p.tick_us, ratchet=2 * N, inc=1, margin=2,
                    why=why)

    return (
        Field("inc",
              init=lambda key, nid: prng.randint(key, 70, 1, 1 << 30),
              doc="client identity: durable init-drawn incarnation nonce "
                  "(a wipe-join rotates it; i32 — narrowing a 30-bit "
                  "nonce would collide incarnations)"),
        Field("held", narrow="u8", doc="client belief flag"),
        Field("my_token", narrow="u16",
              rate=tok_rate("copy: GRANT/KACK payload of l_token"),
              doc="fencing token of my lease"),
        Field("my_expiry", time=True, doc="server-stamped expiry"),
        Field("pend", durable=False, narrow="u8",
              doc="acquire outstanding (volatile)"),
        Field("req_t", time=True, doc="acquire send time (GRANT echo)"),
        Field("ka_t", time=True, doc="last keepalive send time"),
        Field("wseen", narrow="u16",
              rate=tok_rate("copy: max over observed l_token values"),
              doc="watch plane: max token observed via NOTIFY"),
        Field("l_holder", init=-1,
              doc="lease head (server only): holder node id, -1 = free "
                  "(i32 for the sentinel)"),
        Field("l_inc", doc="holder's incarnation at grant"),
        Field("l_token", narrow="u16", rate=tok_rate(_TOKEN_WHY),
              doc="monotone fencing token"),
        Field("l_expiry", time=True),
    )


def _body(p, State):
    N = p.n_nodes
    assert N >= 3
    tick_us = p.tick_us
    ttl_us = p.ttl_us
    ka_interval_us = p.ka_interval_us
    req_timeout_us = p.req_timeout_us
    acquire_p = prng.f32(p.acquire_rate)
    release_p = prng.f32(p.release_rate)
    buggy_zombie_lease = p.buggy_zombie_lease
    i32 = torch.int32

    def first_timer(key, nid):
        # first fire >= tick_us out (part of the l_token rate-floor
        # argument: at most one lease message per client per tick)
        return tick_us + prng.randint(key, 71, 0, tick_us)

    def on_timer(s, nid, now, key):
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

    def on_message(s, nid, src, kind, payload, now, key):
        f = payload
        is_server = nid == SERVER
        live = now <= s.l_expiry

        # server: ACQUIRE, grant when free/expired, renew for the holder
        is_acq = (kind == ACQUIRE) & is_server
        if buggy_zombie_lease:
            # THE PLANTED BUG: renewal matches the holder NODE ID alone
            # — the incarnation is ignored, so a wipe-joined client's
            # fresh ACQUIRE renews the removed incarnation's live lease
            match_holder = s.l_holder == src
        else:
            match_holder = (s.l_holder == src) & (s.l_inc == f[..., 0])
        free = (s.l_holder < 0) | ~live
        grant_new = is_acq & free
        renew = is_acq & ~free & match_holder
        granted = grant_new | renew
        # server: KA extends a live lease for the matching holder
        ka_ok = (kind == KA) & is_server & live & match_holder
        # every renewal bumps the fencing token (etcd-revision style)
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

    def restart_timer(s, nid, now, key):
        # inc/held/my_* are durable: a restarted client resumes a live
        # lease and renews under the SAME incarnation — crash/restart is
        # deliberately invisible to the lease server; `now` is per lane [L]
        return now[:, None] + tick_us + prng.randint(key, 75, 0, tick_us)

    def check_invariants(ns, alive, now):
        """ok [L]: whenever the server records node i as holder AND i
        itself currently believes, the recorded incarnation is i's
        CURRENT one."""
        peers = torch.arange(N, dtype=i32, device=ns.inc.device)
        lh, li = ns.l_holder[:, SERVER], ns.l_inc[:, SERVER]  # [L]
        believer = (
            (peers != SERVER) & (ns.held > 0) & (now[:, None] <= ns.my_expiry)
        )
        checked = believer & (lh[:, None] == peers)
        ok = ~checked | (li[:, None] == ns.inc)
        return ok.all(-1)

    def lane_metrics(node):
        return {
            "mean_lease_token": node.l_token[:, SERVER].to(torch.float32),
            "mean_believers": (
                (node.held[:, 1:] > 0).sum(-1).to(torch.float32)
            ),
            "mean_wseen": node.wseen[:, 1:].amax(-1).to(torch.float32),
        }

    return {
        "on_message": on_message,
        "on_timer": on_timer,
        "first_timer": first_timer,
        "restart_timer": restart_timer,
        "check_invariants": check_invariants,
        "lane_metrics": lane_metrics,
    }


def _workload(spec, p, virtual_secs, loss_rate):
    # the hand lease_workload's chaos recipe: loss + crash + RECONFIG
    # (crash/restart keeps the durable nonce, so only the membership
    # axis rotates client identity — the zombie-lease bug cannot fire
    # without a wipe-join)
    return SimConfig(
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


PROTOCOL = Protocol(
    name="lease-gen",
    messages=("ACQUIRE", "GRANT", "KA", "KACK", "RELEASE", "NOTIFY"),
    payload_width=PAYLOAD_WIDTH,
    params=dict(
        n_nodes=5,
        tick_us=25_000,
        ttl_us=1_500_000,
        ka_interval_us=200_000,
        req_timeout_us=300_000,
        acquire_rate=0.5,
        release_rate=0.04,
        buggy_zombie_lease=False,
    ),
    fields=_fields,
    body=_body,
    fused=False,  # authored two-handler; fused via fuse_two_handlers
    max_out=lambda p: 1,
    buggy_param="buggy_zombie_lease",
    workload=_workload,
    doc="etcd-family lease/watch with durable incarnation nonces",
)
