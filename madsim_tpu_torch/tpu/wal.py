"""Write-ahead-log append service as [L, N]-batched PyTorch handlers.

The port of `madsim_tpu/tpu/wal.py`, the durability-chaos workload: a WAL
server (node 0) applies client appends to an append-only log and acks
them, with a group-commit fsync cadence. The server's `nonce` and
`log_len` are its durable fields (rolled back to the per-node watermark on
a disk crash) and its `syncs` counter is the spec's `sync_field` (every
bump is an fsync point that re-snapshots the watermark).

Device invariant per lane (the lost-ack claim): a client whose last ack
was observed under the server's current nonce is never ahead of the
server's log. Crash-preserve never moves `log_len` back and a wipe rotates
the nonce, so only a disk-fault recovery (same nonce, `log_len` back to the
watermark) can break it.

Planted bug, as on the JAX face: `buggy_ack_before_fsync` acks an append
the moment it is applied and syncs it only at the next group-commit tick;
the correct server bumps `syncs` in the same step as the append, and the
engine advances the watermark after the handlers and before any disk crash
of the step.

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

APPEND, ACK = 0, 1
PAYLOAD_WIDTH = 2
SERVER = 0


class WalState(NamedTuple):
    """Per-node WAL state, int32 leaves [L, N]."""

    nonce: torch.Tensor  # init-drawn incarnation (durable)
    log_len: torch.Tensor  # appends applied to the WAL (server, durable)
    syncs: torch.Tensor  # fsync counter, the spec's sync_field
    dirty: torch.Tensor  # appends since the last fsync
    sent: torch.Tensor  # appends issued (client diagnostics)
    acked: torch.Tensor  # highest acked append count observed (client)
    srv_nonce: torch.Tensor  # server nonce the ack was observed under
    recovered: torch.Tensor  # 0|1, written by on_recover
    torn_seen: torch.Tensor  # 0|1, written by on_recover


def make_wal_spec(
    n_nodes: int = 4,
    tick_us: int = 20_000,
    sync_us: int = 120_000,
    append_rate: float = 0.7,
    buggy_ack_before_fsync: bool = False,
) -> ProtocolSpec:
    """The JAX face's make_wal_spec, same parameters and draws."""
    N = n_nodes
    assert N >= 2
    i32 = torch.int32
    append_p = prng.f32(append_rate)

    def period_of(nid):
        return torch.where(nid == SERVER, sync_us, tick_us).to(i32)

    # ------------------------------------------------------------------ init

    def init(key, nid):
        L = key.shape[0]

        def full(v):
            return torch.full((L, N), v, dtype=i32, device=key.device)

        state = WalState(
            # drawn fresh at every (re-)init: a wipe-join rotates it; a
            # disk recovery puts the watermark copy back
            nonce=prng.randint(key, 80, 1, 1 << 30),
            log_len=full(0), syncs=full(0), dirty=full(0),
            sent=full(0), acked=full(0), srv_nonce=full(0),
            recovered=full(0), torn_seen=full(0),
        )
        return state, period_of(nid) + prng.randint(key, 81, 0, tick_us)

    # ----------------------------------------------------------------- timer

    def on_timer(s: WalState, nid, now, key):
        is_server = nid == SERVER
        # server: group commit, fsync whatever accumulated since the last
        # tick (the sync-point bump re-snapshots the watermark this step)
        do_sync = is_server & (s.dirty > 0)
        # client: issue an append (fire-and-forget)
        send = ~is_server & (prng.uniform(key, 82) < append_p)
        sent = s.sent + send.to(i32)
        state = s._replace(
            syncs=s.syncs + do_sync.to(i32),
            dirty=torch.where(do_sync, 0, s.dirty),
            sent=sent,
        )
        zero = torch.zeros_like(nid)
        out = Outbox(
            valid=send[..., None],
            dst=zero[..., None] + SERVER,
            kind=zero[..., None] + APPEND,
            payload=stack_fields(sent, 0)[..., None, :],
        )
        return state, out, now + period_of(nid)

    # --------------------------------------------------------------- message

    def on_message(s: WalState, nid, src, kind, payload, now, key):
        f = payload
        is_server = nid == SERVER
        is_app = (kind == APPEND) & is_server
        applied = is_app.to(i32)
        log_len = s.log_len + applied
        if buggy_ack_before_fsync:
            # THE PLANTED BUG: the ack leaves now, the append reaches the
            # durable watermark only at the next group-commit tick
            syncs = s.syncs
            dirty = s.dirty + applied
        else:
            # fsync-before-ack: the sync-point bump lands in the same step
            syncs = s.syncs + applied
            dirty = s.dirty
        # client: fold an ACK (same nonce raises the observation; a new
        # nonce means a fresh server incarnation, adopt it)
        is_ack = (kind == ACK) & ~is_server
        same = is_ack & (f[..., 0] == s.srv_nonce)
        fresh = is_ack & (f[..., 0] != s.srv_nonce)
        state = s._replace(
            log_len=log_len,
            syncs=syncs,
            dirty=dirty,
            acked=torch.where(
                same, torch.maximum(s.acked, f[..., 1]),
                torch.where(fresh, f[..., 1], s.acked),
            ),
            srv_nonce=torch.where(fresh, f[..., 0], s.srv_nonce),
        )
        out = Outbox(
            valid=is_app[..., None],
            dst=src.to(i32)[..., None],
            kind=torch.zeros_like(nid)[..., None] + ACK,
            payload=stack_fields(s.nonce, log_len)[..., None, :],
        )
        return state, out, torch.full_like(now, -1)

    # --------------------------------------------------------------- restart

    def on_restart(s: WalState, nid, now, key):
        """`now` is per lane [L]. Crash-preserve: nothing is lost."""
        return s, (
            now[:, None] + period_of(nid) + prng.randint(key, 83, 0, tick_us)
        )

    # --------------------------------------------------------------- recover

    def on_recover(ds: WalState, nid, now, torn, key):
        """`ds` is a fresh init state whose nonce/log_len are the
        watermark's; `now` and `torn` are per lane [L]. The torn bit is
        recorded, not applied (records are checksummed). The returned timer
        is a delay from the recovery instant."""
        state = ds._replace(
            recovered=torch.ones_like(ds.recovered),
            torn_seen=torch.broadcast_to(
                torn[:, None], ds.torn_seen.shape
            ).to(i32),
        )
        return state, period_of(nid) + prng.randint(key, 84, 0, tick_us)

    # ------------------------------------------------------------ invariants

    def check_invariants(ns: WalState, alive, now):
        """ok [L]: no client acked past the current server's log."""
        peers = torch.arange(N, dtype=i32, device=ns.nonce.device)
        lost = (
            (peers != SERVER)
            & (ns.srv_nonce == ns.nonce[:, SERVER:SERVER + 1])
            & (ns.acked > ns.log_len[:, SERVER:SERVER + 1])
        )
        return ~lost.any(-1)

    # ------------------------------------------------------------ diagnostics

    def lane_metrics(node):
        return {
            "mean_log_len": node.log_len[:, SERVER].to(torch.float32),
            "mean_acked": node.acked[:, 1:].to(torch.float32).mean(dim=-1),
            "recovered_lanes": (node.recovered > 0).any(dim=-1),
            "torn_lanes": (node.torn_seen > 0).any(dim=-1),
        }

    append_floor_why = (
        "each client issues at most one APPEND per tick (the timer's "
        "single send; re-arm is now + tick_us, init/restart arm >= "
        "tick_us out), so the server applies <= N-1 appends per tick "
        "window, doubled for the Duplicate clause"
    )
    return fuse_two_handlers(ProtocolSpec(
        name=f"wal{N}",
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
        msg_kind_names=("APPEND", "ACK"),
        # the JAX face's storage narrowing table (this face stores wide)
        narrow_fields={
            "log_len": np.uint16,
            "acked": np.uint16,
            "sent": np.uint16,
            "syncs": np.uint16,
            "dirty": np.uint16,
            "recovered": np.uint8,
            "torn_seen": np.uint8,
        },
        rate_floors={
            "log_len": RateFloor(
                floor_us=tick_us, ratchet=2 * (N - 1), inc=1,
                why=append_floor_why,
            ),
            "acked": RateFloor(
                floor_us=tick_us, ratchet=2 * (N - 1), inc=1,
                why="copy: ACK payload of log_len values",
            ),
            "dirty": RateFloor(
                floor_us=tick_us, ratchet=2 * (N - 1), inc=1,
                why="bounded by unsynced appends (subset of log_len "
                "bumps)",
            ),
            "sent": RateFloor(
                floor_us=tick_us, ratchet=2, inc=1,
                why="one client APPEND issue per own tick",
            ),
            "syncs": RateFloor(
                floor_us=tick_us, ratchet=2 * N, inc=1,
                why="at most one group-commit bump per server tick "
                "plus one per arriving APPEND (fsync-before-ack "
                "variant), both tick-rate-bounded",
            ),
        },
        narrow_horizon_us=65_535 * tick_us // (4 * N),
        durable_fields=("nonce", "log_len"),
        sync_field="syncs",
        on_recover=on_recover,
    ))


def buggy_ack_before_fsync_spec(**kw) -> ProtocolSpec:
    """The planted lost-ack bug as a ready-made spec."""
    return make_wal_spec(buggy_ack_before_fsync=True, **kw)


def wal_workload(
    n_nodes: int = 4,
    virtual_secs: float = 8.0,
    loss_rate: float = 0.02,
    buggy: bool = False,
    disk: bool = True,
):
    """The WAL lost-ack fuzz under DiskFault chaos (the JAX face's config).
    `disk=False` is the quiet-disk control leg: without the durability axis
    even the buggy spec reports zero violations. A violating seed gets
    both microscopes: the device trace and the host twin
    (workloads/wal_host.py: real fs.File appends, real fsync, real
    torn-tail parse on recovery) through `host_repro`."""
    from ..workloads import wal_host
    from .batch import BatchWorkload, twin_repro

    spec = make_wal_spec(n_nodes, buggy_ack_before_fsync=buggy)

    host_repro = twin_repro(
        wal_host.fuzz_one_seed, wal_host.InvariantViolation,
        n_nodes=n_nodes, virtual_secs=virtual_secs,
        loss_rate=loss_rate, buggy=buggy, disk=disk,
    )

    disk_kw = dict(
        nem_disk_interval_lo_us=300_000,
        nem_disk_interval_hi_us=1_200_000,
        nem_disk_slow_lo_us=80_000,
        nem_disk_slow_hi_us=250_000,
        nem_disk_down_lo_us=200_000,
        nem_disk_down_hi_us=800_000,
        nem_disk_torn_rate=0.5,
        nem_disk_extra_us=30_000,
    ) if disk else {}
    cfg = SimConfig(
        horizon_us=int(virtual_secs * 1e6),
        **pool_kw_for(
            spec,
            fused=dict(msg_depth_msg=2, msg_spare_slots=2),
            two_handler=dict(msg_depth_msg=2, msg_depth_timer=2),
        ),
        loss_rate=loss_rate,
        **disk_kw,
    )
    return BatchWorkload(spec=spec, config=cfg, host_repro=host_repro)
