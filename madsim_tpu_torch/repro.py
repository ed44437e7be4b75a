"""Replay a triage repro bundle: `python -m madsim_tpu_torch.repro bundle.json`.

The port of `madsim_tpu/repro.py`'s device replay. It rebuilds the
ProtocolSpec from the bundle's `spec_ref` (or takes `spec=`), the SimConfig
from its TOML (hash-checked), runs the seed under the bundle's shrink ctl
`repeats` times, asserts the final states are bitwise identical, and
asserts the violation fires at the recorded step and virtual time. A bundle
from either face replays on the other.

    python -m madsim_tpu_torch.repro bundle.json              # on the card
    python -m madsim_tpu_torch.repro bundle.json --device cpu --trace 40

Not ported: the host-runtime schedule twin (`--backend host|both`; the
host runtime is not part of the port), the Perfetto timeline
(`--perfetto`, the telemetry plane) and the causal slice (`--explain`,
lineage, ROADMAP item 9). Each raises NotImplementedError.
"""

from __future__ import annotations

import argparse
import importlib
import os
import sys
from typing import Any, Dict, List, Optional

import numpy as np

from .triage import ReproBundle, _not_ported


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
    N trace events of the replayed violation. Returns a report dict."""
    from .tpu.convert import state_to_numpy
    from .tpu.engine import BatchedSim
    from .tpu.spec import REBASE_US
    from .tpu.trace import trace_seed

    if perfetto:
        raise NotImplementedError(
            "replay_device(perfetto=...) writes through the telemetry "
            "plane, which is not ported to madsim_tpu_torch"
        )
    if explain > 0:
        raise _not_ported("replay_device(explain=...) (lineage)", "item 9")
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
    if trace > 0:
        events = trace_seed(
            sim, bundle.seed, max_steps=step + 2,
            kind_names=spec.msg_kind_names, ctl=ctl,
        )
        for e in events[-trace:]:
            out(str(e))
    out(
        f"device replay OK: seed {bundle.seed} violates at step {step}, "
        f"t={t_us}us, bit-identical across {max(1, repeats)} runs"
    )
    rep = {"violated": True, "step": step, "t_us": t_us, "repeats": repeats}
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


def replay(
    bundle: ReproBundle, backend: str = "device", spec=None,
    repeats: int = 2, trace: int = 0, out=print, device="cuda",
) -> Dict[str, Any]:
    if bundle.violation_kind == "divergence" or backend in ("host", "both"):
        raise NotImplementedError(
            "host replay (the schedule twin and divergence bundles) runs on "
            "the host runtime, which is not part of madsim_tpu_torch: "
            "replay such bundles with the JAX package's repro"
        )
    if backend != "device":
        raise ValueError(f"unknown backend {backend!r} (device|host|both)")
    return replay_device(bundle, spec=spec, repeats=repeats, trace=trace,
                         out=out, device=device)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m madsim_tpu_torch.repro",
        description="Replay a triage repro bundle on the port and assert the "
        "violation still fires at the recorded step and time.",
    )
    p.add_argument("bundle", help="path to a repro bundle JSON")
    p.add_argument(
        "--backend", choices=("device", "host", "both"), default="device",
        help="device: replay the violation on the batched engine (host and "
        "both need the host runtime, which the port does not carry)",
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
    args = p.parse_args(argv)
    bundle = ReproBundle.load(args.bundle)
    if args.spec_ref:
        bundle.spec_ref = args.spec_ref
    try:
        replay(bundle, backend=args.backend, repeats=args.repeats,
               trace=args.trace, device=args.device)
    except (ReplayError, ValueError) as e:
        print(f"REPLAY FAILED: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
