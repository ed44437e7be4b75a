"""The port's speclang host face against the JAX package's.

  * the generated twins (`madsim_tpu_torch.speclang.generated.<x>_host`,
    the torch `hostrt` with the protocol bound) on `device="cpu"` give the
    JAX generated twins' result dicts on `digest.HOSTRT_RUNS` (backup seed
    3, lease-gen seed 1 and twopc-gen seed 3 at 6 virtual s, the correct
    backup under the Duplicate + Reorder plan at 8), and both faces'
    `hostrt_digest` is `digest.PINNED_HOSTRT`;
  * the buggy backup on seed 0 under that plan raises the JAX message;
  * `emit --check` is clean over the six generated files;
  * `build_workload(...).host_repro` equals the JAX face's.

Tolerance: exact (integer dicts, digests and messages).
"""

import importlib

import pytest

from madsim_tpu import nemesis as jn
from madsim_tpu_torch.speclang import emit, hostrt
from madsim_tpu_torch.speclang.specs import PROTOCOLS
from madsim_tpu_torch.tpu import digest

GEN = "madsim_tpu_torch.speclang.generated"
JGEN = "madsim_tpu.speclang.generated"


def jax_plan():
    """digest.HOSTRT_PLAN on the JAX face's nemesis."""
    return jn.FaultPlan(name="backup-bug", clauses=(
        jn.Duplicate(rate=0.15),
        jn.Reorder(rate=0.3, window_us=250_000),
    ))


@pytest.fixture(scope="module")
def jax_runs():
    out = []
    for mod, seed, kw in digest.HOSTRT_RUNS:
        twin = importlib.import_module(f"{JGEN}.{mod}")
        out.append(twin.fuzz_one_seed(
            seed, **digest.hostrt_kwargs(kw, jax_plan())))
    return out


@pytest.fixture(scope="module")
def port_runs():
    return digest.hostrt_runs("cpu")


@pytest.mark.parametrize(
    "row", range(len(digest.HOSTRT_RUNS)),
    ids=[f"{m[:-5]}-s{s}" + ("-plan" if "plan" in kw else "")
         for m, s, kw in digest.HOSTRT_RUNS])
def test_generated_twin_equal_to_the_jax_twin(row, jax_runs, port_runs):
    got, want = port_runs[row], jax_runs[row]
    assert digest.hostrt_result(got) == digest.hostrt_result(want)
    assert got["checks"] > 0 and got["events"] > 0
    assert sorted(got) == sorted(want)


def test_both_faces_reach_the_pin(jax_runs, port_runs):
    assert digest.hostrt_digest(jax_runs) == digest.PINNED_HOSTRT
    assert digest.hostrt_digest(port_runs) == digest.PINNED_HOSTRT


def test_buggy_backup_raises_under_the_plan():
    from madsim_tpu.speclang.generated import backup_host as jb
    from madsim_tpu_torch.speclang.generated import backup_host as tb

    kw = dict(virtual_secs=8.0, chaos=False, buggy=True)
    with pytest.raises(jb.InvariantViolation) as je:
        jb.fuzz_one_seed(0, plan=jax_plan(), **kw)
    with pytest.raises(tb.InvariantViolation) as te:
        tb.fuzz_one_seed(0, plan=digest.HOSTRT_PLAN, device="cpu", **kw)
    assert str(te.value) == str(je.value)
    assert tb.InvariantViolation is hostrt.InvariantViolation


def test_emit_check_clean_over_both_faces():
    clean, drifted = emit.emit(check=True)
    assert not drifted, drifted
    assert clean == sorted(f"{n}_{face}.py" for n in PROTOCOLS
                           for face in ("device", "host")) and len(clean) == 6
    for name in PROTOCOLS:
        host = importlib.import_module(f"{GEN}.{name}_host")
        assert host.SPECLANG_DIGEST == emit.source_digest(name)
        assert host.fuzz_one_seed.__module__ == f"{GEN}.{name}_host"


@pytest.mark.parametrize("name,kw,seeds", [
    ("backup", dict(virtual_secs=4.0, buggy=True), (0, 1)),
    ("twopc", dict(virtual_secs=3.0), (2, 3)),
])
def test_build_workload_host_repro_equals_the_jax_one(name, kw, seeds):
    tw = importlib.import_module(f"{GEN}.{name}_device").make_workload(
        device="cpu", **kw)
    jw = importlib.import_module(f"{JGEN}.{name}_device").make_workload(**kw)
    for seed in seeds:
        assert tw.host_repro(seed) == jw.host_repro(seed), (name, seed)


def test_twin_device_defaults_to_the_card():
    """Like every entry point of the port, the twin's handlers run on the
    card unless the caller asks for the CPU: a card the host lacks
    raises, and the kit counts one handler call per event."""
    from madsim_tpu_torch.speclang.generated import backup_host

    with pytest.raises((RuntimeError, ValueError)):
        backup_host.fuzz_one_seed(0, virtual_secs=0.5, device="cuda:99")
    kit = hostrt.kit_for(PROTOCOLS["backup"], device="cpu")
    before = kit.calls
    r = backup_host.fuzz_one_seed(3, virtual_secs=1.0, device="cpu")
    assert kit.calls - before >= r["events"] // 2 > 0
