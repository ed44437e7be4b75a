"""The port stands alone: no module of `madsim_tpu_torch/`, nor
`chip_smoke.py`, imports `jax` or anything of the `madsim_tpu` package."""

import ast
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "madsim_tpu")


def _sources():
    pkg = os.path.join(ROOT, "madsim_tpu_torch")
    for d, _, files in os.walk(pkg):
        for f in sorted(files):
            if f.endswith(".py"):
                path = os.path.join(d, f)
                mod = os.path.relpath(path, ROOT)[:-3].replace(os.sep, ".")
                if mod.endswith(".__init__"):
                    mod = mod[: -len(".__init__")]
                    package = mod
                else:
                    package = mod.rsplit(".", 1)[0]
                yield path, package
    yield os.path.join(ROOT, "chip_smoke.py"), ""


def _imported_modules(path, package):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                parts = package.split(".")
                assert node.level <= len(parts), (path, node.lineno)
                base = ".".join(parts[: len(parts) - node.level + 1])
                yield f"{base}.{node.module}" if node.module else base
            else:
                yield node.module


def _banned(mod):
    return any(mod == b or mod.startswith(b + ".") for b in BANNED)


def test_no_port_module_imports_jax_or_the_jax_package():
    seen = set()
    for path, package in _sources():
        assert os.path.exists(path), path
        bad = [m for m in _imported_modules(path, package) if _banned(m)]
        assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"
        seen.add(os.path.relpath(path, ROOT))
    assert len(seen) >= 10
    assert {os.path.join("madsim_tpu_torch", f) for f in (
        "telemetry.py", "explore.py", os.path.join("workloads", "__init__.py"),
        os.path.join("speclang", "lang.py"),
        os.path.join("speclang", "device.py"),
        os.path.join("speclang", "specs", "backup.py"),
        os.path.join("speclang", "generated", "backup_device.py"),
        os.path.join("tpu", "mesh.py"),
        "oracle.py", "fs.py", "repro.py",
        os.path.join("core", "runtime.py"),
        os.path.join("core", "interpose.py"),
        os.path.join("net", "netsim.py"),
        os.path.join("workloads", "raft_host.py"),
        os.path.join("workloads", "chain_host.py"),
        os.path.join("speclang", "hostrt.py"),
        os.path.join("speclang", "generated", "backup_host.py"),
        os.path.join("speclang", "generated", "lease_host.py"),
        os.path.join("speclang", "generated", "twopc_host.py"),
    ) + tuple(os.path.join("workloads", f"{x}_host.py") for x in (
        "kv", "twopc", "paxos", "isr", "lease", "wal"))} <= seen


def test_importing_the_port_loads_no_jax():
    code = (
        "import sys; import madsim_tpu_torch.tpu, madsim_tpu_torch.tpu.digest, "
        "madsim_tpu_torch.tpu.convert, madsim_tpu_torch.tpu.mesh, "
        "madsim_tpu_torch.telemetry, "
        "madsim_tpu_torch.explore, madsim_tpu_torch.workloads, "
        "madsim_tpu_torch.speclang.emit, madsim_tpu_torch.core, "
        "madsim_tpu_torch.oracle, madsim_tpu_torch.repro, "
        "madsim_tpu_torch.workloads.raft_host, "
        "madsim_tpu_torch.workloads.chain_host, "
        "madsim_tpu_torch.speclang.hostrt; "
        "from madsim_tpu_torch import workloads; "
        "[workloads.workload_factory(n) for n in workloads.names()]; "
        "[workloads.host_fuzz(n) for n in workloads.names()]; "
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        f"{BANNED!r}]; "
        "assert not bad, bad"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=120)
