"""Speclang generated modules, checked in, never hand-edited.

Every `<x>_device.py` here is emitted from the single spec source
`speclang/specs/<x>.py` by `python -m madsim_tpu_torch.speclang emit`,
carries the source file's sha256 as `SPECLANG_DIGEST`, and is
drift-checked by `emit --check`. The workload registry's generated rows
(`twopc-gen`, `lease-gen`, `backup`) point at these modules."""
