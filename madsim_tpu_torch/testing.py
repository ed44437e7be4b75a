"""The repro one-liner a violation report prints.

A copy of `single_seed_repro_command` from `madsim_tpu/testing.py` (the
port imports nothing of the JAX package): `BatchViolation` puts it in its
message so a CI log is a self-serve repro.
"""

from __future__ import annotations

import os
import shlex


def single_seed_repro_command(seed: int) -> str:
    """The exact one-liner that re-runs one failing seed: env (seed, count,
    and any config/time-limit overrides active in this run) plus the pytest
    node id when running under pytest."""
    env = os.environ
    parts = [f"MADSIM_TEST_SEED={seed}", "MADSIM_TEST_NUM=1"]
    for var in ("MADSIM_TEST_CONFIG", "MADSIM_TEST_TIME_LIMIT"):
        if var in env:
            parts.append(f"{var}={shlex.quote(env[var])}")
    current = env.get("PYTEST_CURRENT_TEST", "")
    if current:
        # "tests/test_x.py::test_y[param with spaces] (call)" -> the node
        # id: strip only the trailing " (stage)" suffix
        node_id = current.rsplit(" (", 1)[0]
        parts.append(f"python -m pytest {shlex.quote(node_id)} -x")
    else:
        parts.append("<rerun the test entry point>")
    return " ".join(parts)
