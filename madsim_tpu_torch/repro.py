"""Replay a triage repro bundle: `python -m madsim_tpu_torch.repro bundle.json`.

The port of `madsim_tpu/repro.py`'s device replay. It rebuilds the
ProtocolSpec from the bundle's `spec_ref` (or takes `spec=`), the SimConfig
from its TOML (hash-checked), runs the seed under the bundle's shrink ctl
`repeats` times, asserts the final states are bitwise identical, and
asserts the violation fires at the recorded step and virtual time. A bundle
from either face replays on the other.

    python -m madsim_tpu_torch.repro bundle.json              # on the card
    python -m madsim_tpu_torch.repro bundle.json --device cpu --trace 40
    python -m madsim_tpu_torch.repro bundle.json --explain 8  # causal slice
    python -m madsim_tpu_torch.repro bundle.json --perfetto t.json

`--explain N` replays once more with the causal-lineage plane on and
prints the last N links of the violation's causal slice; a bundle that
carries a causal digest has its sha cross-checked. The device backend is
`device`, or `tpu` as the JAX face names it. `--perfetto PATH` writes the
replayed trajectory as a Chrome-trace/Perfetto timeline.

    python -m madsim_tpu_torch.repro bundle.json --backend host  # schedule twin
    python -m madsim_tpu_torch.repro bundle.json --backend both  # device + host

Host replay (`--backend host`) drives the bundle's SHRUNK FaultPlan through a
fresh host runtime's NemesisDriver (idle nodes; the schedule needs no
traffic) and asserts the applied fault stream equals the occurrence-filtered
pure schedule. `both` replays the device half first, on `--device`.

Divergence bundles (`violation_kind == "divergence"`, written by
madsim_tpu_torch/oracle.py or the JAX face's oracle) are differential by
construction, so every backend routes to the oracle replay: the shrunk plan
re-runs schedule-matched on the host twin `--repeats` times, each run must
reproduce the same first divergent event bit-identically, and the bundle's
`causal` digest is cross-checked against the replayed host slice. A
reproduced divergence prints the first-divergent-event report and the CLI
exits 1: the backends still disagree, which is a live bug.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from .triage import ReproBundle


# the device backend's names: the port's, and the JAX face's
DEVICE_BACKENDS = ("device", "tpu")


class ReplayError(AssertionError):
    """The bundle did not replay as recorded."""


def resolve_spec(spec_ref: str, spec_kwargs: Optional[Dict[str, Any]] = None):
    """Rebuild a ProtocolSpec from a dotted "module:factory" reference. A
    reference into the JAX package is refused: it would build a JAX spec,
    and the port never imports that package."""
    mod_name, _, fn_name = spec_ref.partition(":")
    if not mod_name or not fn_name:
        raise ValueError(
            f"spec_ref must look like 'package.module:factory', got {spec_ref!r}"
        )
    if mod_name == "madsim_tpu" or mod_name.startswith("madsim_tpu."):
        raise ValueError(
            f"spec_ref {spec_ref!r} names a module of the JAX package, which "
            "madsim_tpu_torch does not import: pass the port's spec "
            "explicitly (replay_device(bundle, spec=...)) or a spec_ref into "
            "a torch module (--spec-ref)"
        )
    # bundles written inside a checkout reference modules by their
    # repo-relative dotted path: put the cwd on sys.path for the import
    cwd = os.getcwd()
    sys.path.insert(0, cwd)
    try:
        mod = importlib.import_module(mod_name)
    finally:
        try:
            sys.path.remove(cwd)
        except ValueError:
            pass
    return getattr(mod, fn_name)(**(spec_kwargs or {}))


def replay_device(
    bundle: ReproBundle,
    spec=None,
    repeats: int = 2,
    trace: int = 0,
    perfetto: Optional[str] = None,
    explain: int = 0,
    out=print,
    device="cuda",
) -> Dict[str, Any]:
    """Device replay: the violation must fire at the recorded step and
    time, bit-identically across `repeats` runs. `trace=N` prints the last
    N trace events of the replayed violation; `perfetto=PATH` writes the
    whole replayed trajectory as a Chrome-trace/Perfetto timeline
    (`telemetry.write_perfetto`): one track per node, deliveries as
    src->dst flow arrows, chaos windows as slices, the violation as an
    instant marker. `explain=N` replays once
    more with the causal-lineage plane on and prints the last N links of
    the violation's causal slice; when the bundle carries a causal digest,
    the replayed slice's sha must equal it. Returns a report dict."""
    from .tpu.convert import state_to_numpy
    from .tpu.engine import BatchedSim
    from .tpu.spec import REBASE_US
    from .tpu.trace import trace_seed

    if spec is None:
        if not bundle.spec_ref:
            raise ReplayError(
                "bundle has no spec_ref — pass the ProtocolSpec explicitly "
                "(replay_device(bundle, spec=...)) or re-emit the bundle "
                "with shrink_seed(spec_ref=...)"
            )
        spec = resolve_spec(bundle.spec_ref, bundle.spec_kwargs)
    if spec.n_nodes != bundle.n_nodes:
        raise ReplayError(
            f"spec has {spec.n_nodes} nodes, bundle recorded {bundle.n_nodes}"
        )
    cfg = bundle.config()  # hash-checked
    sim = BatchedSim(spec, cfg, triage=True, device=device)
    ctl = bundle.ctl(1)
    states = [
        sim.run([bundle.seed], max_steps=bundle.max_steps, ctl=ctl)
        for _ in range(max(1, repeats))
    ]
    first = state_to_numpy(states[0])
    for i, st in enumerate(states[1:], start=2):
        for name, leaf in state_to_numpy(st).items():
            if not np.array_equal(leaf, first[name]):
                raise ReplayError(
                    f"replay {i} diverged from replay 1 at state leaf "
                    f"{name} — the device stream is not bit-deterministic"
                )
    violated = bool(first["violated"][0])
    step = int(first["violation_step"][0])
    t_us = int(first["violation_epoch"][0] * REBASE_US
               + first["violation_at"][0])
    if not violated:
        raise ReplayError(
            f"seed {bundle.seed} did NOT violate under the bundle's shrunk "
            "configuration — stale bundle or schema drift"
        )
    if step != bundle.violation_step or t_us != bundle.violation_t_us:
        raise ReplayError(
            f"violation replayed at step {step} / t={t_us}us but the bundle "
            f"recorded step {bundle.violation_step} / "
            f"t={bundle.violation_t_us}us"
        )
    if trace > 0 or perfetto:
        events = trace_seed(
            sim, bundle.seed, max_steps=step + 2,
            kind_names=spec.msg_kind_names, ctl=ctl,
        )
        for e in events[-trace:] if trace > 0 else []:
            out(str(e))
        if perfetto:
            from . import telemetry

            telemetry.write_perfetto(
                perfetto, events, n_nodes=spec.n_nodes,
                label=f"{bundle.spec_name} seed {bundle.seed}",
            )
            out(f"perfetto timeline: {perfetto}")
    rep = {"violated": True, "step": step, "t_us": t_us, "repeats": repeats}
    if explain > 0:
        from . import causal

        g, sl = causal.explain(spec, cfg, bundle.seed, ctl=ctl,
                               max_steps=step + 2, device=device)
        digest = causal.causal_digest(sl)
        tail = (causal.causal_slice(g, max_len=explain)
                if len(sl.chain) > explain else sl)
        out(causal.format_slice(tail))
        if bundle.causal is not None and (
            bundle.causal.get("sha") != digest["sha"]
        ):
            raise ReplayError(
                "causal slice diverged from the bundle's recorded digest "
                f"({digest['sha']} != {bundle.causal.get('sha')}) — the "
                "lineage plane or the slice semantics drifted"
            )
        rep["causal"] = digest
    out(
        f"device replay OK: seed {bundle.seed} violates at step {step}, "
        f"t={t_us}us, bit-identical across {max(1, repeats)} runs"
    )
    if bundle.signature:
        provenance = ""
        if bundle.campaign is not None:
            provenance = f" (campaign {bundle.campaign}"
            if bundle.generation is not None:
                provenance += f", generation {bundle.generation}"
            provenance += ")"
        out(f"bug signature: {bundle.signature}{provenance}")
        rep["signature"] = bundle.signature
    return rep


def replay_host(bundle: ReproBundle, out=print) -> Dict[str, Any]:
    """Host schedule twin: a fresh runtime's NemesisDriver applies exactly
    the shrunk plan's occurrence-filtered pure schedule."""
    import madsim_tpu_torch as ms
    from .nemesis import NemesisDriver, filter_schedule

    plan = bundle.shrunk_plan()
    horizon_us = int(bundle.horizon_us)
    n = int(bundle.n_nodes)

    async def body():
        handle = ms.Handle.current()

        async def idle():
            while True:
                await ms.time.sleep(3600.0)

        nodes = [
            handle.create_node().name(f"r{i}").ip(f"10.9.9.{i + 1}")
            .init(idle).build()
            for i in range(n)
        ]
        driver = NemesisDriver(
            plan, handle, [nd.id for nd in nodes], horizon_us=horizon_us,
            seed=bundle.seed, occ_off=bundle.occ_off,
        )
        driver.install()
        t = ms.time.current()
        end = t.elapsed() + horizon_us / 1e6 + 0.001
        while t.elapsed() < end:
            await ms.time.sleep(0.05)
        return driver

    rt = ms.Runtime(seed=bundle.seed)
    driver = rt.block_on(body())
    want = [
        e for e in filter_schedule(
            plan.schedule(bundle.seed, horizon_us, n), bundle.occ_off
        )
        if e.kind != "skew"  # applied at install time, not replayed
    ]
    got = list(driver.applied)
    if got != want:
        raise ReplayError(
            "host driver stream diverged from the shrunk pure schedule:\n"
            f"  want ({len(want)}): {[str(e) for e in want]}\n"
            f"  got  ({len(got)}): {[str(e) for e in got]}"
        )
    out(
        f"host schedule twin OK: {len(want)} shrunk fault events applied "
        "exactly as scheduled"
    )
    return {"events": len(want)}


def replay_divergence(
    bundle: ReproBundle, repeats: int = 2, out=print,
) -> Dict[str, Any]:
    """Replay a host/device divergence bundle (madsim_tpu_torch/oracle.py):
    re-run the shrunk plan schedule-matched on the host twin `repeats`
    times and assert the SAME first divergent event reproduces
    bit-identically every time. Raises ReplayError when the lane no
    longer diverges (stale bundle / fixed tree) or when repeats disagree
    (the replay itself is nondeterministic — a worse bug). Returns a
    report with `diverged=True`; callers treat that as a failing exit,
    because a reproduced divergence means the backends still disagree."""
    from . import oracle

    plan = bundle.shrunk_plan()
    horizon_us = int(bundle.horizon_us)
    n = int(bundle.n_nodes)
    loss_rate = 0.1
    if bundle.config_toml:
        loss_rate = float(getattr(bundle.config(), "loss_rate", 0.1))
    repeats = max(1, repeats)
    reps = [
        oracle.check_seed(
            bundle.spec_name, plan, bundle.seed, horizon_us, n_nodes=n,
            loss_rate=loss_rate, occ_off=bundle.occ_off, repeats=1,
        )
        for _ in range(repeats)
    ]
    for i, rep in enumerate(reps, start=1):
        if not rep.diverged:
            raise ReplayError(
                f"replay {i}: seed {bundle.seed} did NOT diverge under the "
                "bundle's shrunk plan — stale bundle, or the host/device "
                "skew it recorded has been fixed"
            )

    def ident(r):
        d = r.first
        return (d.kind, d.site, d.index, d.applied, d.expected, d.eid,
                r.digest, len(r.divergences))

    first = reps[0]
    for i, rep in enumerate(reps[1:], start=2):
        if ident(rep) != ident(first):
            raise ReplayError(
                "divergence replay is not bit-deterministic: replay "
                f"{i} reproduced {ident(rep)} but replay 1 gave "
                f"{ident(first)}"
            )
    d = first.first
    if bundle.causal is not None and d.slice_digest is not None and (
        bundle.causal.get("sha") != d.slice_digest.get("sha")
    ):
        raise ReplayError(
            "host causal slice diverged from the bundle's recorded digest "
            f"({d.slice_digest.get('sha')} != {bundle.causal.get('sha')}) — "
            "the lineage plane or the slice semantics drifted"
        )
    out(first.render())
    out(
        f"divergence reproduced bit-identically across {repeats} "
        "schedule-matched host replays — the backends still disagree"
    )
    return {
        "diverged": True,
        "repeats": repeats,
        "first": d.to_dict(),
        "digest": first.digest,
    }


def replay(
    bundle: ReproBundle, backend: str = "device", spec=None,
    repeats: int = 2, trace: int = 0, perfetto: Optional[str] = None,
    explain: int = 0, out=print, device="cuda",
) -> Dict[str, Any]:
    """Replay a bundle on `backend`: "device" (or "tpu", the JAX face's
    name for it) replays on the batched engine on `device`, "host" runs the
    shrunk plan's schedule twin on the host runtime, "both" does the two.
    A divergence bundle routes to `replay_divergence` whatever the
    backend."""
    if bundle.violation_kind == "divergence":
        # differential by construction: there is no single-backend replay
        # of a host-vs-device divergence, so every backend routes here
        return replay_divergence(bundle, repeats=repeats, out=out)
    if backend == "host":
        return replay_host(bundle, out=out)
    if backend not in DEVICE_BACKENDS + ("both",):
        raise ValueError(
            f"unknown backend {backend!r} (device|tpu|host|both)")
    rep = replay_device(bundle, spec=spec, repeats=repeats, trace=trace,
                        perfetto=perfetto, explain=explain, out=out,
                        device=device)
    if backend == "both":
        rep.update(replay_host(bundle, out=out))
    return rep


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m madsim_tpu_torch.repro",
        description="Replay a triage repro bundle on the port and assert the "
        "violation still fires at the recorded step and time.",
    )
    p.add_argument("bundle", help="path to a repro bundle JSON")
    p.add_argument(
        "--backend", choices=DEVICE_BACKENDS + ("host", "both"),
        default="device",
        help="device (or tpu, the JAX face's name): replay the violation on "
        "the batched engine; host: assert the shrunk plan's schedule twin "
        "on the host runtime; both: the two",
    )
    p.add_argument("--device", default="cuda",
                   help="torch device of the replay (default cuda)")
    p.add_argument(
        "--spec-ref", default=None,
        help="override the bundle's 'module:factory' ProtocolSpec reference",
    )
    p.add_argument("--repeats", type=int, default=2,
                   help="device replays to compare bitwise (default 2)")
    p.add_argument("--trace", type=int, default=0, metavar="N",
                   help="print the last N trace events of the violation")
    p.add_argument(
        "--explain", nargs="?", const=20, type=int, default=0, metavar="N",
        help="replay once more with the causal-lineage plane on and print "
        "the last N links (default 20) of the violation's causal slice; "
        "cross-checks the bundle's causal digest when it has one",
    )
    p.add_argument(
        "--perfetto", default=None, metavar="PATH",
        help="write the replayed trajectory as a Chrome-trace/Perfetto "
        "timeline JSON (open in ui.perfetto.dev)",
    )
    args = p.parse_args(argv)
    bundle = ReproBundle.load(args.bundle)
    if args.spec_ref:
        bundle.spec_ref = args.spec_ref
    try:
        rep = replay(bundle, backend=args.backend, repeats=args.repeats,
                     trace=args.trace, perfetto=args.perfetto,
                     explain=args.explain, device=args.device)
    except (ReplayError, ValueError) as e:
        print(f"REPLAY FAILED: {e}", file=sys.stderr)
        return 1
    if rep.get("diverged"):
        # the divergence reproduced: a live host-vs-device bug, so the CLI
        # fails even though the replay itself succeeded
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
