"""The speclang host backend: a generic host-runtime twin.

The port of `madsim_tpu/speclang/hostrt.py`. The hand-written
`workloads/<x>_host.py` twins re-implement each protocol as bespoke
coroutines; the speclang twin runs the SAME handler bodies the device face
runs — `spec.on_message` / `spec.on_timer` from `device.build(proto)` — as
one task per node over the host runtime's simulated network
(`net.Endpoint` raw datagrams, so loss/delay/dup come from the runtime,
not the engine). There is no second implementation to drift.

The port's handlers take explicit `[L, N]` axes (`tpu/spec.py`), so a twin
node is one lane of one node: its state leaves are `[1, 1, ...]` tensors on
the kit's `device`, each handler call gets `[1, 1]` scalars, and the
invariant check concatenates the n node states along the node axis into
`[1, n, ...]`. One handler call per event, as on the JAX face (no CUDA
graph, no batching of events): each scalar of the event is copied to
the device on its own and each outbox field read back on its own.

Per-node event loop = the device contract, verbatim:
  * wait for a datagram until the node's timer deadline; deliver it via
    `on_message` (a negative returned timer KEEPS the deadline),
  * on deadline, fire `on_timer` (a negative returned timer DISARMS),
  * send every valid outbox row as a raw datagram to its destination.

Chaos mirrors the hand twins: host-native kill/restart (durable state
survives through `spec.on_restart`; a wipe fraction rebuilds from
`spec.init` — the membership epoch), or NemesisDriver plan mode
(`plan=`) with `on_wipe` doing the rebuild. The oracle is the spec's own
`check_invariants` over the stacked node states, run by a periodic
checker task — the same function, same masks, as the device face.

`fuzz_one_seed(proto, seed, ..., device="cuda")` is the debugging
microscope the generated `<x>_host.py` modules re-export with the
protocol bound; pass `device="cpu"` to run the handlers on the CPU.
"""

from __future__ import annotations

from typing import List, Optional

import torch

import madsim_tpu_torch as ms
from ..net import Endpoint, NetSim
from ..tpu import prng
from ..tpu.mesh import canonical_device
from . import device as _device
from .lang import Protocol

_PORT = 7900
_TAG = 0
WIPE_FRAC = 0.5  # host-native chaos: fraction of restarts that wipe
CHECK_EVERY = 0.05  # virtual seconds between invariant sweeps


class InvariantViolation(AssertionError):
    pass


# one twin kit per (protocol, overrides, device): a fuzz sweep over many
# seeds builds the spec once
_KITS: dict = {}


class _TwinKit:
    def __init__(self, proto: Protocol, overrides: dict, dev: torch.device):
        self.proto = proto
        self.device = dev
        self.spec = _device.build(proto, **overrides)
        self.n_nodes = self.spec.n_nodes
        self.payload_width = self.spec.payload_width
        self.calls = 0
        self._warm()
        # handler calls (timer fires + deliveries) of every run on this
        # kit, the divisor of a per-call time
        self.calls = 0

    def _warm(self) -> None:
        """Call every handler once, outside any simulation: torch imports
        some modules on first use (sympy among them), and a module that
        seeds a `random.Random()` at import would draw from the
        simulation's RNG if its first import happened inside a run."""
        with torch.inference_mode():
            state, _ = self.init(0, 0)
            self.restart(state, 0, 0, 1)
            self.on_timer(state, 0, 0, 2)
            self.on_message(state, 0, 0, 0, [0] * self.payload_width, 0, 3)
            self.check([state] * self.n_nodes, [True] * self.n_nodes, 0)

    def _u32(self, key: int) -> torch.Tensor:
        """A u32 key as the handlers take it: [1, 1] int64."""
        return torch.tensor([[key]], dtype=torch.int64, device=self.device)

    def _i32(self, v, shape=(1, 1)) -> torch.Tensor:
        return torch.tensor(v, dtype=torch.int32,
                            device=self.device).reshape(shape)

    def init(self, key: int, nid: int):
        return self.spec.init(self._u32(key), self._i32(nid))

    def restart(self, state, nid: int, now_us: int, key: int):
        return self.spec.on_restart(state, self._i32(nid),
                                    self._i32(now_us, (1,)), self._u32(key))

    def _sends(self, state, out, timer):
        """(state, [(dst, (kind, payload))] of the valid outbox rows, the
        deadline wrapped to int32 as the engine reads it)."""
        valid = out.valid.reshape(-1).tolist()
        dst = out.dst.reshape(-1).tolist()
        kind = out.kind.reshape(-1).tolist()
        payload = out.payload.reshape(len(valid), -1).tolist()
        sends = [(dst[r], (kind[r], tuple(payload[r])))
                 for r in range(len(valid)) if valid[r]]
        return state, sends, _timer(timer)

    def on_timer(self, state, nid: int, now_us: int, key: int):
        self.calls += 1
        return self._sends(*self.spec.on_timer(
            state, self._i32(nid), self._i32(now_us), self._u32(key)))

    def on_message(self, state, nid: int, src: int, kind: int, vals,
                   now_us: int, key: int):
        self.calls += 1
        return self._sends(*self.spec.on_message(
            state, self._i32(nid), self._i32(src), self._i32(kind),
            self._i32(list(vals), (1, 1, -1)), self._i32(now_us),
            self._u32(key)))

    def check(self, states: list, alive: list, now_us: int) -> bool:
        ns = type(states[0])(*(
            torch.cat(leaves, dim=1) for leaves in zip(*states)
        ))
        ok = self.spec.check_invariants(
            ns, torch.tensor([alive], dtype=torch.bool, device=self.device),
            torch.tensor([now_us], dtype=torch.int32, device=self.device),
        )
        return bool(ok.reshape(-1)[0])


def kit_for(proto: Protocol, device="cuda", **overrides) -> _TwinKit:
    dev = canonical_device(device)
    key = (id(proto), tuple(sorted(overrides.items())), str(dev))
    if key not in _KITS:
        _KITS[key] = _TwinKit(proto, overrides, dev)
    return _KITS[key]


def _timer(t: torch.Tensor) -> int:
    """A handler's deadline as the engine reads it: wrapped to int32."""
    return int(t.to(torch.int32).reshape(-1)[0])


class _TwinNode:
    """One node: the device state + timer deadline, driven by events."""

    def __init__(self, kit: _TwinKit, nid: int, seed: int,
                 addrs: List[str], born_us: int):
        self.kit = kit
        self.nid = nid
        self.seed = seed
        self.addrs = addrs
        self._draws = 0
        state, first = kit.init(self._key(), nid)
        self.state = state
        # init's deadline is an offset from the node's birth (a fresh
        # wipe-join init starts its clock at the join, like the engine)
        self.timer: Optional[int] = born_us + _timer(first)

    def _key(self) -> int:
        # a private deterministic key chain per (seed, node, draw): the
        # twin needs determinism, not the engine's lane key stream
        self._draws += 1
        return prng.fold(prng.fold(self.seed & prng.M32, self.nid + 1),
                         self._draws)

    def apply_restart(self, now_us: int) -> None:
        state, t = self.kit.restart(self.state, self.nid, now_us,
                                    self._key())
        self.state = state
        self.timer = _timer(t)

    async def _deliver(self, sends) -> None:
        for dst, msg in sends:
            try:
                await self.ep.send_to_raw(
                    (self.addrs[dst], _PORT), _TAG, msg
                )
            except (OSError, ms.sync.ChannelClosed):
                pass

    async def run(self) -> None:
        self.ep = await Endpoint.bind(f"{self.addrs[self.nid]}:{_PORT}")
        t = ms.time.current()
        while True:
            now_us = int(t.elapsed() * 1e6)
            if self.timer is not None and self.timer <= now_us:
                st, sends, nt = self.kit.on_timer(
                    self.state, self.nid, now_us, self._key(),
                )
                self.state = st
                self.timer = nt if nt >= 0 else None  # negative disarms
                await self._deliver(sends)
                continue
            wait = (
                (self.timer - now_us) / 1e6 if self.timer is not None
                else 3600.0
            )
            try:
                data, frm = await ms.time.timeout(
                    wait, self.ep.recv_from_raw(_TAG)
                )
            except ms.time.TimeoutError_:
                continue  # the timer branch fires on the next pass
            except (OSError, ms.sync.ChannelClosed):
                return
            kind, vals = data
            src = self.addrs.index(frm[0])
            now_us = int(t.elapsed() * 1e6)
            st, sends, nt = self.kit.on_message(
                self.state, self.nid, src, kind, vals, now_us, self._key(),
            )
            self.state = st
            if nt >= 0:  # negative keeps the deadline on a message
                self.timer = nt
            await self._deliver(sends)


def _check_now(kit: _TwinKit, cns: list, alive: list, now_us: int):
    if not kit.check([c.state for c in cns], alive, now_us):
        raise InvariantViolation(
            f"{kit.spec.name}: check_invariants failed at t={now_us}us "
            "on the host twin (same oracle as the device face)"
        )


def _state_digest(c: "_TwinNode") -> tuple:
    # leaves widened to int64 before the sum (u32 values are int64 in
    # [0, 2^32) here, so they sum as the JAX face's widened uint32 do)
    return tuple(int(leaf.to(torch.int64).sum()) for leaf in c.state)


async def _fuzz_body(
    kit: _TwinKit,
    seed: int,
    virtual_secs: float,
    chaos: bool,
    plan=None,
    occ_off=None,
) -> dict:
    handle = ms.Handle.current()
    n = kit.n_nodes
    addrs = [f"10.0.9.{i + 1}" for i in range(n)]
    cns: list = [None] * n
    alive = [True] * n
    t = ms.time.current()

    def make_node(i: int, wipe: bool) -> _TwinNode:
        now_us = int(t.elapsed() * 1e6)
        old = cns[i]
        if old is None or wipe:
            fresh = _TwinNode(kit, i, seed, addrs, born_us=now_us)
        else:
            fresh = old
            fresh.apply_restart(now_us)
        cns[i] = fresh
        return fresh

    nodes = []
    if plan is not None:
        def make_init(i: int):
            def _init():
                # plan-mode wipes route through on_wipe (below), which
                # marks the slot; init rebuilds accordingly
                return make_node(i, wipe=cns[i] is None).run()

            return _init

        for i in range(n):
            node = (
                handle.create_node()
                .name(f"{kit.spec.name}-{i}")
                .ip(addrs[i])
                .init(make_init(i))
                .build()
            )
            nodes.append(node)
    else:
        for i in range(n):
            node = handle.create_node().name(
                f"{kit.spec.name}-{i}"
            ).ip(addrs[i]).build()
            node.spawn(make_node(i, wipe=True).run())
            nodes.append(node)

    async def chaos_task() -> None:
        while True:
            await ms.time.sleep(0.5 + ms.rand() * 1.5)
            victim = ms.randrange(n)
            alive[victim] = False
            handle.kill(nodes[victim].id)
            await ms.time.sleep(0.3 + ms.rand() * 0.6)
            wipe = ms.rand() < WIPE_FRAC
            if wipe:
                cns[victim] = None
            fresh = make_node(victim, wipe=wipe)
            alive[victim] = True
            handle.restart(nodes[victim].id)
            nodes[victim].spawn(fresh.run())

    if chaos and plan is None:
        ms.spawn(chaos_task())

    driver = None
    if plan is not None:
        from .. import nemesis as nem

        def on_wipe(i: int) -> None:
            cns[i] = None

        driver = nem.NemesisDriver(
            plan,
            handle,
            node_ids=[nd.id for nd in nodes],
            horizon_us=int(virtual_secs * 1e6),
            seed=seed,
            on_wipe=on_wipe,
            occ_off=occ_off,
        )
        driver.install()

    end = t.elapsed() + virtual_secs
    checks = 0
    while t.elapsed() < end:
        await ms.time.sleep(CHECK_EVERY)
        if all(c is not None for c in cns):
            _check_now(kit, cns, alive, int(t.elapsed() * 1e6))
            checks += 1
    stats = {
        "checks": checks,
        "events": ms.plugin.simulator(NetSim).stat().msg_count,
        "state": [_state_digest(c) if c is not None else None
                  for c in cns],
    }
    if driver is not None:
        stats["nemesis"] = {
            "applied": list(driver.applied),
            "occ_fired": dict(driver.occ_fired),
            "node_skew": dict(getattr(handle.time, "node_skew", {}) or {}),
            "node_ids": [nd.id for nd in nodes],
            "coins": driver.coins,
            "fires": driver.fire_counts(),
            "state": stats["state"],
        }
    return stats


def fuzz_one_seed(
    proto: Protocol,
    seed: int,
    n_nodes: Optional[int] = None,
    virtual_secs: float = 10.0,
    loss_rate: float = 0.1,
    chaos: bool = True,
    buggy: bool = False,
    plan=None,
    occ_off=None,
    lineage: bool = False,  # accepted for twin-runner parity; unused
    device="cuda",
) -> dict:
    """One complete fuzzed host execution of a speclang protocol, verified
    by the spec's own invariant, with the handlers on `device` (the card
    unless the caller asks for the CPU). Raises InvariantViolation."""
    overrides = {}
    if n_nodes is not None:
        overrides["n_nodes"] = n_nodes
    if buggy:
        if proto.buggy_param is None:
            raise ValueError(f"{proto.name}: no planted-bug param declared")
        overrides[proto.buggy_param] = True
    kit = kit_for(proto, device=device, **overrides)
    cfg = ms.Config()
    cfg.net.packet_loss_rate = loss_rate
    rt = ms.Runtime(seed=seed, config=cfg)
    with torch.inference_mode():
        return rt.block_on(
            _fuzz_body(kit, seed, virtual_secs, chaos, plan=plan,
                       occ_off=occ_off)
        )
