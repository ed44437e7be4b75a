"""The port's speclang device face against the JAX face's.

`madsim_tpu_torch/speclang/` holds a copy of the language surface
(`lang.py`, its code equal to the JAX face's), the device backend over the
port's [L, N] spec contract, the three spec sources and the emitter of
their checked-in device modules. Held here:

  * the copy and the restrictions: `lang.py`'s code equals the original's,
    and `validate_protocol` refuses the JAX tests' bad bodies;
  * derivation: every table `device.build` derives equals the JAX face's
    for all three specs, and the port's hand twopc and lease tables;
  * emit: every `SPECLANG_DIGEST` pins its port source, `emit --check` is
    clean, and the generated literal tables equal the JAX generated ones;
  * re-derivation is exact: twopc-gen's 16-lane x 1500-step CHAOS_PLAN run
    reaches `GOLDEN["twopc"]`, lease-gen equals the hand lease leaf for
    leaf under the JAX test's RICH_PLAN;
  * the speclang-native backup, buggy and correct, is leaf-equal to the
    JAX generated backup at 64 lanes x 2000 steps, violating on the same
    lanes at the same steps (>= 5 lanes buggy, none correct), and the
    explorer over the buggy build gives the JAX face's fingerprint.

Tolerance: exact for every integer leaf (widened to int64); `summarize`'s
float lane means at rtol 1e-6.
"""

import ast
import dataclasses
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest

from madsim_tpu import explore as jexplore
from madsim_tpu import nemesis as jn
from madsim_tpu.speclang import device as jdevice
from madsim_tpu.speclang import lang as jlang
from madsim_tpu.speclang.generated import backup_device as j_backup
from madsim_tpu.speclang.generated import lease_device as j_lease
from madsim_tpu.speclang.generated import twopc_device as j_twopc
from madsim_tpu.speclang.specs import PROTOCOLS as JPROTOCOLS
from madsim_tpu.tpu import SimConfig as JaxConfig
from madsim_tpu.tpu import summarize as jax_summarize
from madsim_tpu.tpu.nemesis import compile_plan as jax_compile_plan
from madsim_tpu_torch import explore
from madsim_tpu_torch import nemesis as tn
from madsim_tpu_torch import workloads as registry
from madsim_tpu_torch.speclang import device, emit, lang
from madsim_tpu_torch.speclang.generated import (
    backup_device, lease_device, twopc_device,
)
from madsim_tpu_torch.speclang.specs import PROTOCOLS
from madsim_tpu_torch.tpu import (
    BatchedSim, SimConfig, compile_plan, make_lease_spec, make_twopc_spec,
    summarize,
)
from madsim_tpu_torch.tpu.convert import state_to_numpy
from madsim_tpu_torch.tpu.digest import (
    CHAOS_PLAN, GOLDEN, GOLDEN_LANES, GOLDEN_STEPS, canonical_digest,
)
from test_state_layout import CHAOS_PLAN as JAX_CHAOS_PLAN
from test_torch_engine import (
    assert_leaves_equal, assert_summaries_equal, jax_leaves,
)
from test_torch_workloads import run_both, violations

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SPECS = ("twopc", "lease", "backup")
GEN = {"twopc": twopc_device, "lease": lease_device, "backup": backup_device}
JGEN = {"twopc": j_twopc, "lease": j_lease, "backup": j_backup}
LITERALS = ("STATE_FIELDS", "NARROW_FIELDS", "RATE_FLOORS",
            "NARROW_HORIZON_US", "TIME_FIELDS", "MSG_KIND_NAMES",
            "DURABLE_FIELDS", "SYNC_FIELD")


# ---------------------------------------------------- the copy, restrictions


def _code(module) -> str:
    """A module's AST with every docstring dropped (comments never enter
    the AST): the code, without its prose."""
    tree = ast.parse(inspect.getsource(module))
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(body, list) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


def test_lang_copy_equals_the_original():
    assert _code(lang) == _code(jlang)
    assert lang.NARROW_MAX == jlang.NARROW_MAX
    assert lang._FORBIDDEN_CALLS == jlang._FORBIDDEN_CALLS
    assert lang._PRNG_SITE_ARG == jlang._PRNG_SITE_ARG


def _port_protocol(proto):
    """A JAX-face Protocol re-declared with the port's `Protocol` class."""
    return lang.Protocol(**{f.name: getattr(proto, f.name)
                            for f in dataclasses.fields(proto)})


def test_restriction_walk_refuses_bad_bodies():
    """The JAX test's bad spec source: an unbounded loop, a host callback,
    a computed draw site and an ambient-entropy import, each refused."""
    from tests.fixtures import speclang_bad

    with pytest.raises(ValueError) as ei:
        lang.validate_protocol(_port_protocol(speclang_bad.PROTOCOL))
    with pytest.raises(ValueError) as ej:
        jlang.validate_protocol(speclang_bad.PROTOCOL)
    assert str(ei.value) == str(ej.value)
    for needle in ("while loop", "host callback",
                   "site must be an int literal", "ambient-entropy import"):
        assert needle in str(ei.value), needle
    for proto in PROTOCOLS.values():
        lang.validate_protocol(proto)


def test_resolve_refuses_unknown_params():
    with pytest.raises(ValueError, match="unknown spec params"):
        device.build(PROTOCOLS["backup"], nonesuch=3)


def test_fused_spec_stale_wrapper_guard():
    spec = device.build(PROTOCOLS["twopc"])

    def patched(s, nid, src, kind, payload, now, key):
        return spec.on_message(s, nid, src, kind, payload, now, key)

    with pytest.raises(ValueError, match="does not derive"):
        dataclasses.replace(spec, on_message=patched)


# ------------------------------------------------------------- derivation


def _floor_view(floors):
    return {
        name: (type(fl).__name__, tuple(
            (a, getattr(fl, a)) for a in ("floor_us", "ratchet", "inc", "cap")
            if hasattr(fl, a)))
        for name, fl in (floors or {}).items()
    }


def _tables(spec):
    return {
        "name": spec.name, "n_nodes": spec.n_nodes,
        "payload_width": spec.payload_width,
        "max_out": (spec.max_out, spec.max_out_msg),
        "narrow_fields": {k: np.dtype(v) for k, v in
                          (spec.narrow_fields or {}).items()},
        "narrow_horizon_us": spec.narrow_horizon_us,
        "time_fields": tuple(spec.time_fields or ()),
        "msg_kind_names": tuple(spec.msg_kind_names),
        "rate_floors": _floor_view(spec.rate_floors),
        "durable_fields": tuple(spec.durable_fields or ()),
        "sync_field": spec.sync_field,
        "fused": spec.on_event is not None,
    }


@pytest.mark.parametrize("name", SPECS)
def test_derived_tables_equal_the_jax_face_and_the_hand_specs(name):
    gen = device.build(PROTOCOLS[name])
    assert _tables(gen) == _tables(jdevice.build(JPROTOCOLS[name]))
    hand = {"twopc": make_twopc_spec, "lease": make_lease_spec}.get(name)
    if hand is not None:
        want = _tables(hand()) | {"name": gen.name}
        assert _tables(gen) == want
    # the same declarations resolve the same params on both faces
    assert vars(PROTOCOLS[name].resolve()) == vars(
        JPROTOCOLS[name].resolve())
    assert tuple(f.name for f in PROTOCOLS[name].fields(
        PROTOCOLS[name].resolve())) == GEN[name].STATE_FIELDS


# ------------------------------------------------------------ emit and pins


def test_emit_check_clean_and_digests_pin_sources():
    clean, drifted = emit.emit(check=True)
    assert not drifted, drifted
    assert clean == sorted(f"{n}_{face}.py" for n in PROTOCOLS
                           for face in ("device", "host"))
    for name in SPECS:
        assert GEN[name].SPECLANG_DIGEST == emit.source_digest(name)
    out = subprocess.run(
        [sys.executable, "-m", "madsim_tpu_torch.speclang", "emit",
         "--check"], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    assert "DRIFT" not in out.stdout


@pytest.mark.parametrize("name", SPECS)
def test_generated_literal_tables_equal_the_jax_generated(name):
    for attr in LITERALS:
        assert getattr(GEN[name], attr) == getattr(JGEN[name], attr), attr


def test_registry_generated_rows_and_refused_knobs(capsys):
    assert registry.names(generated=True) == ("twopc-gen", "lease-gen",
                                              "backup")
    spec = registry.spec_factory("backup")()
    assert spec.name == "backup5" and spec.durable_fields
    wl = registry.workload_factory("twopc-gen")(virtual_secs=2.0)
    assert wl.host_repro is not None
    jwl = j_twopc.make_workload(virtual_secs=2.0)
    assert wl.config.to_toml() == jwl.config.to_toml()
    # the tune SpecKnob rows (refused until tune came, item 12): the JAX
    # face's names, values and defaults, each rebuilding the spec
    rows = registry.spec_knobs("twopc-gen", 2.0)
    jrows = j_twopc.spec_knobs(2.0)
    assert [(r.name, r.values, r.default) for r in rows] == \
        [(r.name, r.values, r.default) for r in jrows] and rows
    for r in rows:
        spec = r.rebuild(wl, r.values[0]).spec
        assert spec.name == wl.spec.name and spec is not wl.spec
    # the explorer CLI takes a generated row through the registry
    explore.main(["--workload", "backup", "--virtual-secs", "0.2",
                  "--lanes", "4", "--dispatches", "1", "--no-shrink",
                  "--json", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    api = explore.Explorer(explore._named_workload("backup", 0.2, False),
                           lanes=4, shrink_violations=False,
                           device="cpu").run(1)
    assert explore.ExploreReport.from_json(line).fingerprint() == \
        api.fingerprint()


# ------------------------------------------------------- bit-identity bars


def _chaos_cfg(plan):
    return compile_plan(plan, SimConfig(horizon_us=30_000_000))


def _run(spec, cfg, lanes=GOLDEN_LANES, steps=GOLDEN_STEPS):
    return BatchedSim(spec, cfg, device="cpu").run(
        list(range(lanes)), max_steps=steps, dispatch_steps=steps)


def test_generated_twopc_matches_golden_digest():
    st = _run(twopc_device.make_spec(), _chaos_cfg(CHAOS_PLAN))
    leaves = state_to_numpy(st)
    assert (leaves["steps"] == GOLDEN_STEPS).all()
    assert canonical_digest(leaves) == GOLDEN["twopc"]
    assert summarize(st)["total_events"] > 0


# every message clause armed on top of the layout plan
# (tests/test_speclang.py:76-82)
RICH_PLAN = tn.FaultPlan(
    name="speclang-rich",
    clauses=CHAOS_PLAN.clauses + (
        tn.Duplicate(rate=0.1),
        tn.Reorder(rate=0.2, window_us=120_000),
    ),
)


def test_generated_lease_equals_hand_lease_under_rich_plan():
    cfg = _chaos_cfg(RICH_PLAN)
    jrich = jn.FaultPlan(name="speclang-rich", clauses=(
        JAX_CHAOS_PLAN.clauses + (jn.Duplicate(rate=0.1),
                                  jn.Reorder(rate=0.2, window_us=120_000))))
    assert cfg.to_toml() == jax_compile_plan(
        jrich, JaxConfig(horizon_us=30_000_000)).to_toml()
    hand = state_to_numpy(_run(make_lease_spec(), cfg))
    gen_st = _run(lease_device.make_spec(), cfg)
    gen = state_to_numpy(gen_st)
    assert_leaves_equal(hand, gen, "lease-gen vs hand lease")
    assert summarize(gen_st)["total_events"] > 0
    fires = dict(zip(tn.FIRE_KINDS, gen["fires"].sum(0)))
    assert fires["dup"] > 0 and fires["reorder"] > 0, fires


@pytest.mark.parametrize("buggy", [True, False], ids=["buggy", "correct"])
def test_backup_leaf_equal_to_the_jax_generated_backup(buggy):
    """The JAX test's 64 lanes x 2000 steps (every lane reaches its
    10-virtual-second horizon first): every leaf and the summary equal;
    the buggy build violates on the same lanes at the same steps, on at
    least the JAX test's 5 lanes; the correct build never violates."""
    jw = j_backup.make_workload(buggy=buggy)
    tw = backup_device.make_workload(buggy=buggy)
    assert tw.host_repro is not None
    jst, pst = run_both(jw.spec, jw.config, tw.spec, tw.config,
                        list(range(64)), 2000)
    want, got = jax_leaves(jst), state_to_numpy(pst)
    assert_leaves_equal(want, got, f"backup buggy={buggy}")
    assert_summaries_equal(jax_summarize(jst, jw.spec),
                           summarize(pst, tw.spec))
    assert violations(got) == violations(want)
    assert got["events"].sum() > 0
    if buggy:
        assert len(violations(got)) >= 5
    else:
        assert not got["violated"].any()


def test_backup_explorer_matches_the_jax_fingerprint():
    jrep = jexplore.Explorer(j_backup.make_workload(buggy=True), meta_seed=0,
                             lanes=16, shrink_violations=False).run(1)
    rep = explore.Explorer(backup_device.make_workload(buggy=True),
                           meta_seed=0, lanes=16, shrink_violations=False,
                           device="cpu").run(1)
    assert rep.violations, "planted stale-read bug not found in 16 lanes"
    assert rep.fingerprint() == jrep.fingerprint()
    assert rep.coverage_curve == jrep.coverage_curve
