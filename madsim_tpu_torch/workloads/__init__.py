"""The workload registry: one row per protocol, every face in one place.

The port of `madsim_tpu/workloads/__init__.py`. Each `WorkloadEntry` names
the module that holds a protocol's spec factory and `BatchWorkload`
factory; the explorer CLI (`python -m madsim_tpu_torch.explore
--workload <name>`) and any later consumer read the rows here instead of
keeping private lists.

The port has the JAX registry's rows, field for field: the eight
hand-written workloads, pointing at `madsim_tpu_torch.tpu.<x>` and their
host twins `madsim_tpu_torch.workloads.<x>_host`, and the three
speclang-generated ones (`twopc-gen`, `lease-gen`, `backup`), pointing at
the device and host modules that `python -m madsim_tpu_torch.speclang
emit` writes into `madsim_tpu_torch/speclang/generated/`. `host_fuzz`
answers for every row; raft and chain are the differential oracle's two
standing twins (`oracle_twins`). wal stays unexplorable, as there.

Entries hold dotted module paths and attribute names, resolved on first
use, so importing this package imports no workload module.
"""

from __future__ import annotations

import dataclasses
import importlib
from typing import Callable, Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class WorkloadEntry:
    """One protocol's wiring (the JAX face's row, field for field)."""

    name: str
    # device face: the module exposing the spec factory and the
    # BatchWorkload factory
    module: str
    spec_attr: str
    workload_attr: str
    # host face: module exposing `fuzz_one_seed` (+ `InvariantViolation`)
    host_module: Optional[str] = None
    # schedule-matched plan-mode twin for the differential oracle
    oracle_twin: bool = False
    # member of the tune CLI sweep list
    tunable: bool = False
    # member of the explore CLI factory table
    explorable: bool = True
    # analysis target (static analysis is a later slice, item 15)
    analysis: bool = True
    # emitted by speclang from a spec source (`source_module` names it)
    generated: bool = False
    source_module: Optional[str] = None
    # optional tune SpecKnob hook on `module`
    knobs_attr: Optional[str] = None


_TPU = "madsim_tpu_torch.tpu"
_HOST = "madsim_tpu_torch.workloads"
_GEN = "madsim_tpu_torch.speclang.generated"
_SRC = "madsim_tpu_torch.speclang.specs"

ENTRIES: Tuple[WorkloadEntry, ...] = (
    WorkloadEntry("raft", f"{_TPU}.raft", "make_raft_spec", "raft_workload",
                  host_module=f"{_HOST}.raft_host",
                  oracle_twin=True, tunable=True),
    WorkloadEntry("kv", f"{_TPU}.kv", "make_kv_spec", "kv_workload",
                  host_module=f"{_HOST}.kv_host", tunable=True),
    WorkloadEntry("twopc", f"{_TPU}.twopc", "make_twopc_spec",
                  "twopc_workload", host_module=f"{_HOST}.twopc_host",
                  tunable=True),
    WorkloadEntry("paxos", f"{_TPU}.paxos", "make_paxos_spec",
                  "paxos_workload", host_module=f"{_HOST}.paxos_host",
                  tunable=True),
    WorkloadEntry("chain", f"{_TPU}.chain", "make_chain_spec",
                  "chain_workload", host_module=f"{_HOST}.chain_host",
                  oracle_twin=True, tunable=True),
    WorkloadEntry("isr", f"{_TPU}.isr", "make_isr_spec", "isr_workload",
                  host_module=f"{_HOST}.isr_host"),
    WorkloadEntry("lease", f"{_TPU}.lease", "make_lease_spec",
                  "lease_workload", host_module=f"{_HOST}.lease_host"),
    # wal is an analysis and twin-test workload, not an explore CLI target
    # (as on the JAX face)
    WorkloadEntry("wal", f"{_TPU}.wal", "make_wal_spec", "wal_workload",
                  host_module=f"{_HOST}.wal_host", explorable=False),
    # --- speclang-generated (one spec source, both faces emitted) ---
    WorkloadEntry("twopc-gen", f"{_GEN}.twopc_device", "make_spec",
                  "make_workload", host_module=f"{_GEN}.twopc_host",
                  generated=True, source_module=f"{_SRC}.twopc",
                  knobs_attr="spec_knobs"),
    WorkloadEntry("lease-gen", f"{_GEN}.lease_device", "make_spec",
                  "make_workload", host_module=f"{_GEN}.lease_host",
                  generated=True, source_module=f"{_SRC}.lease"),
    WorkloadEntry("backup", f"{_GEN}.backup_device", "make_spec",
                  "make_workload", host_module=f"{_GEN}.backup_host",
                  generated=True, source_module=f"{_SRC}.backup"),
)

_BY_NAME: Dict[str, WorkloadEntry] = {e.name: e for e in ENTRIES}
if len(_BY_NAME) != len(ENTRIES):  # pragma: no cover - authoring error
    raise RuntimeError("duplicate workload registry names")


def get(name: str) -> WorkloadEntry:
    try:
        return _BY_NAME[name]
    except KeyError:
        raise KeyError(
            f"unknown workload {name!r} (choose from {sorted(_BY_NAME)})"
        ) from None


def names(
    *,
    explorable: Optional[bool] = None,
    tunable: Optional[bool] = None,
    analysis: Optional[bool] = None,
    oracle_twin: Optional[bool] = None,
    generated: Optional[bool] = None,
) -> Tuple[str, ...]:
    """Registry names filtered by face flags (None = don't filter), in
    registry order."""
    out = []
    for e in ENTRIES:
        if explorable is not None and e.explorable != explorable:
            continue
        if tunable is not None and e.tunable != tunable:
            continue
        if analysis is not None and e.analysis != analysis:
            continue
        if oracle_twin is not None and e.oracle_twin != oracle_twin:
            continue
        if generated is not None and e.generated != generated:
            continue
        out.append(e.name)
    return tuple(out)


def _resolve(module: str, attr: str):
    return getattr(importlib.import_module(module), attr)


def spec_factory(name: str) -> Callable:
    e = get(name)
    return _resolve(e.module, e.spec_attr)


def workload_factory(name: str) -> Callable:
    e = get(name)
    return _resolve(e.module, e.workload_attr)


def spec_factories(**filters) -> Dict[str, Callable]:
    """{name -> spec factory} for every (filtered) registry entry."""
    return {n: spec_factory(n) for n in names(**filters)}


def host_fuzz(name: str) -> Callable:
    """The host twin's fuzz_one_seed for one entry (KeyError if the entry
    ships no host face)."""
    e = get(name)
    if e.host_module is None:
        raise KeyError(f"workload {name!r} has no host twin module")
    return _resolve(e.host_module, "fuzz_one_seed")


def _plan_twin(host_module: str) -> Callable[..., dict]:
    def run(seed, plan, occ_off, n_nodes, virtual_secs, loss_rate):
        fuzz = _resolve(host_module, "fuzz_one_seed")
        return fuzz(
            seed, n_nodes=n_nodes, virtual_secs=virtual_secs,
            loss_rate=loss_rate, chaos=False, plan=plan, occ_off=occ_off,
            lineage=True,
        )

    return run


def oracle_twins() -> Dict[str, Callable[..., dict]]:
    """{spec-name prefix -> plan-mode twin runner} for oracle.HOST_TWINS:
    every entry flagged oracle_twin, run with NemesisDriver plan mode and
    lineage on (the artifact surface the comparator consumes)."""
    return {
        e.name: _plan_twin(e.host_module)
        for e in ENTRIES
        if e.oracle_twin and e.host_module is not None
    }


def spec_knobs(name: str, virtual_secs: float) -> tuple:
    """The entry's tune SpecKnob hooks ((), if it declares none)."""
    e = get(name)
    if e.knobs_attr is None:
        return ()
    return tuple(_resolve(e.module, e.knobs_attr)(virtual_secs))
