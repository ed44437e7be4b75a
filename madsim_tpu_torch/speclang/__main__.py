"""CLI: `python -m madsim_tpu_torch.speclang emit [--check]`.

`emit` regenerates the checked-in modules under `speclang/generated/`
from the spec sources under `speclang/specs/`; `emit --check` diffs
instead of writing and exits nonzero on drift (the drift gate)."""

from __future__ import annotations

import argparse
import sys

from . import emit as emit_mod


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m madsim_tpu_torch.speclang")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p_emit = sub.add_parser(
        "emit", help="regenerate speclang/generated/ from specs/"
    )
    p_emit.add_argument(
        "--check", action="store_true",
        help="diff against the checked-in files; exit 1 on drift",
    )
    args = ap.parse_args(argv)

    clean, drifted = emit_mod.emit(check=args.check)
    for f in clean:
        print(f"  ok  {f}")
    for f in drifted:
        print(f"DRIFT {f} (re-run `python -m madsim_tpu_torch.speclang emit`)")
    if drifted:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
