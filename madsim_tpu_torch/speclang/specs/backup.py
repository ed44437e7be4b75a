"""Primary-backup log shipping, the first speclang-native protocol.

The port of `madsim_tpu/speclang/specs/backup.py`, line for line over
[L, N] axes: this protocol never existed as a hand module; the whole
thing is this one spec source, and its device face is generated.

Shape: node 0 is the PRIMARY, nodes 1..N-1 are BACKUPS. The primary's
timer mints versions and broadcasts REPL(ver, val) to every backup
(fsync-before-ack: the apply bumps `syncs`, the spec's sync_field, in
the same step), and occasionally reads from one random backup
(READ -> RESP(b_ver, b_val)), the stand-in for a client hitting a read
replica. A backup applies a REPL iff it is NEWER than what it holds
(`ver > b_ver`) and ACKs; it answers READs from its local copy.

Safety, monotone reads per replica: the versions one backup serves never
go backwards. Each backup tracks `served_max` (the highest b_ver it has
ever answered a READ with) and latches the sticky `regress` flag the
moment it is about to serve an OLDER version. Detection is local to the
backup (no cross-node join), and every reset path moves the plane
together: a reconfig wipe re-inits b_ver/served_max/regress as one, a
disk crash rolls all three back to the same watermark (they share the
durable plane), a plain restart keeps all three.

THE PLANTED BUG (`buggy=True`): the apply guard degrades from
`ver > b_ver` to `ver != b_ver`. A DUPLICATED or REORDERED stale REPL
then re-applies an old version over a newer one, the next READ observes
b_ver < served_max, and the invariant fires. The bug lives purely on the
duplicate/reorder axis (the workload arms `nem_dup_rate` and
`nem_reorder_rate`), which is what lets ddmin shrink a repro down to
those clauses.

PRNG sites: 90 (repl-vs-read coin), 91 (read target), 92 (timer re-arm),
93 (first fire), 94 (restart fire).
"""

from __future__ import annotations

import torch

from ...tpu import prng
from ...tpu.spec import Outbox, SimConfig, pool_kw_for, stack_fields
from ..lang import DiskPlane, Field, Protocol, Rate

REPL, ACK, READ, RESP = 0, 1, 2, 3
PAYLOAD_WIDTH = 3  # (ver, val, spare)

_VER_WHY = (
    "only the primary mints, at most one ver per timer fire; every "
    "primary arm (first, re-arm, restart) draws >= tick_us, margin 2 "
    "for skew derating"
)


def _fields(p):
    N = p.n_nodes
    # ver is the one minted counter; b_ver/served_max/ack_ver hold
    # COPIES of it (REPL / served REPL / ACK payloads)
    def ver_rate(why):
        return Rate(floor_us=p.tick_us, ratchet=1, inc=1, margin=2,
                    why=why)

    return (
        Field("ver", narrow="u16", rate=ver_rate(_VER_WHY),
              doc="primary: latest minted version"),
        Field("val", doc="primary: payload of the latest version"),
        Field("b_ver", narrow="u16", rate=ver_rate("copy: REPL payload"),
              doc="backup: version held"),
        Field("b_val", doc="backup: value held"),
        Field("served_max", narrow="u16",
              rate=ver_rate("copy: max over served b_ver values"),
              doc="backup: highest version ever served to a READ"),
        Field("regress", narrow="u8",
              doc="backup: sticky monotone-reads violation flag "
                  "(step-closed in {0,1})"),
        Field("ack_ver", shape=(N,), durable=False, narrow="u16",
              rate=ver_rate("copy: ACK payload of minted vers"),
              doc="primary: highest ver acked per backup (volatile)"),
        Field("r_seen", durable=False,
              doc="primary: highest version read back (diagnostics)"),
        Field("syncs", durable=False,
              doc="fsync counter — the spec's sync_field"),
        Field("serves", durable=False,
              doc="backup: READs answered (diagnostics)"),
    )


def _body(p, State):
    N = p.n_nodes
    assert N >= 3
    tick_us = p.tick_us
    repl_p = prng.f32(p.repl_rate)
    buggy = p.buggy
    i32 = torch.int32
    IDLE_FAR = 2**28  # backups never self-fire

    def first_timer(key, nid):
        # first fire >= tick_us out: part of the ver rate-floor argument
        return torch.where(
            nid == 0, tick_us + prng.randint(key, 93, 0, tick_us), IDLE_FAR
        )

    def on_event(s, nid, src, kind, payload, now, key):
        peers = torch.arange(N, dtype=i32, device=nid.device)
        f = payload
        is_timer = kind == -1
        is_primary = nid == 0

        # ================= timer path (primary only) ==================
        coin = prng.uniform(key, 90) < repl_p
        do_repl = is_timer & is_primary & coin
        do_read = is_timer & is_primary & ~coin
        new_ver = s.ver + 1
        new_val = new_ver * 7 + 1  # deterministic payload for the ver
        target = prng.randint(key, 91, 1, N)

        # ================= message path (kind >= 0) ===================
        is_repl = kind == REPL
        if buggy:
            # THE PLANTED BUG: "anything different must be news" — a
            # duplicated/reordered STALE REPL re-applies an old version
            news = f[..., 0] != s.b_ver
        else:
            news = f[..., 0] > s.b_ver
        apply = is_repl & ~is_primary & news
        serve = (kind == READ) & ~is_primary
        ackin = (kind == ACK) & is_primary
        respin = (kind == RESP) & is_primary

        state = s._replace(
            ver=torch.where(do_repl, new_ver, s.ver),
            val=torch.where(do_repl, new_val, s.val),
            b_ver=torch.where(apply, f[..., 0], s.b_ver),
            b_val=torch.where(apply, f[..., 1], s.b_val),
            # latch BEFORE folding this serve into served_max
            regress=torch.where(serve & (s.b_ver < s.served_max),
                                1, s.regress),
            served_max=torch.where(
                serve, torch.maximum(s.served_max, s.b_ver), s.served_max
            ),
            ack_ver=torch.where(
                ackin[..., None] & (peers == src[..., None]),
                torch.maximum(s.ack_ver, f[..., 0:1]), s.ack_ver,
            ),
            r_seen=torch.where(respin, torch.maximum(s.r_seen, f[..., 0]),
                               s.r_seen),
            # fsync-before-ack: mint and apply both hit the disk plane
            syncs=s.syncs + (do_repl | apply).to(i32),
            serves=s.serves + serve.to(i32),
        )

        # ============== merged outbox (E = N rows) ====================
        # REPL broadcasts on rows 1..N-1; single-message events (READ,
        # ACK, RESP) put the payload in outbox ROW dst
        bcast = do_repl
        single = do_read | apply | serve
        s_dst = torch.where(do_read, target, src)
        s_kind = torch.where(
            do_read, READ, torch.where(apply, ACK, RESP)
        ).to(i32)
        s_a = torch.where(do_read, 0, torch.where(apply, f[..., 0], s.b_ver))
        s_b = torch.where(serve, s.b_val, 0)
        at_row = peers == s_dst[..., None]  # [L,N,N]
        bcx = bcast[..., None]
        out = Outbox(
            valid=torch.where(bcx, peers != 0, single[..., None] & at_row),
            dst=torch.where(
                bcx, peers,
                torch.where(single, s_dst, 0)[..., None].expand(at_row.shape),
            ),
            kind=torch.where(
                bcast, REPL, torch.where(single, s_kind, 0)
            )[..., None].expand(at_row.shape),
            payload=torch.where(
                bcx[..., None],
                stack_fields(new_ver, new_val, 0)[..., None, :],
                torch.where(
                    (single[..., None] & at_row)[..., None],
                    stack_fields(s_a, s_b, 0)[..., None, :], 0,
                ),
            ),
        )

        # primary re-arms every tick (draw >= tick_us: the rate floor);
        # backups stay unarmed; message events keep their deadline
        timer_t = torch.where(
            is_primary,
            now + prng.randint(key, 92, tick_us, 2 * tick_us),
            now + IDLE_FAR,
        )
        return state, out, torch.where(is_timer, timer_t, -1)

    def restart_timer(s, nid, now, key):
        # `now` is per lane [L]
        now_n = now[:, None]
        return torch.where(
            nid == 0,
            now_n + tick_us + prng.randint(key, 94, 0, tick_us),
            now_n + IDLE_FAR,
        )

    def check_invariants(ns, alive, now):
        # monotone reads per replica, detected locally by each backup:
        # the sticky flag is the violation. No cross-node join — wipes
        # and disk rollbacks reset/rewind the whole plane together, so
        # the CORRECT spec holds under every chaos axis.
        return (ns.regress[:, 1:] == 0).all(-1)

    def lane_metrics(node):
        return {
            "mean_primary_ver": node.ver[:, 0].to(torch.float32),
            "mean_backup_ver": (
                node.b_ver[:, 1:].to(torch.float32).mean(-1)
            ),
            "regressed_lanes": (node.regress[:, 1:] > 0).any(-1),
        }

    return {
        "on_event": on_event,
        "first_timer": first_timer,
        "restart_timer": restart_timer,
        "check_invariants": check_invariants,
        "lane_metrics": lane_metrics,
    }


def _workload(spec, p, virtual_secs, loss_rate):
    # the bug's axes: duplicates and reorder (plus loss to create the
    # version gaps stale re-applies land in); plain crash/restart rides
    # along to prove the durable plane keeps the invariant wipe-safe
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
        nem_dup_rate=0.1,
        # the window must span several REPL gaps (a mint every
        # tick..2*tick, REPL on ~60% of fires => ~100_000 us apart):
        # a reordered stale REPL has to land AFTER a newer apply for
        # the planted guard to regress b_ver
        nem_reorder_rate=0.25,
        nem_reorder_window_us=250_000,
    )


PROTOCOL = Protocol(
    name="backup",
    messages=("REPL", "ACK", "READ", "RESP"),
    payload_width=PAYLOAD_WIDTH,
    params=dict(
        n_nodes=5,
        tick_us=40_000,
        repl_rate=0.6,
        buggy=False,
    ),
    fields=_fields,
    body=_body,
    fused=True,
    max_out=lambda p: p.n_nodes,
    disk=DiskPlane(
        fields=("ver", "val", "b_ver", "b_val", "served_max", "regress"),
        sync_field="syncs",
    ),
    buggy_param="buggy",
    workload=_workload,
    doc="primary-backup log shipping with monotone-read replicas",
)
