"""Counter-based murmur3 draw chain, bit-equal to `madsim_tpu/tpu/prng.py`.

Every draw on the engine's device path is this integer hash chain: a
murmur3 fmix32 over (lane word, step word, site, index), with a distinct
compile-time `site` constant per draw site so sites are independent
streams. The port must reproduce it bit for bit, so the u32 arithmetic is
explicit here:

* torch has no shift, `%`, comparison or argmin on `uint32` (CPU build),
  so u32 values live in int64 tensors holding [0, 2^32); an int64 tensor
  argument is taken to hold such a value already;
* `_mul32` multiplies two u32 values in int64 and keeps the low 32 bits.
  The product can pass 2^63 and wrap; the wrap is two's complement on
  both devices (x86-64 `imul`, PTX `mul.lo.s64`), so the low 32 bits are
  exact. tests/test_torch_prng.py pins it against numpy's uint32
  arithmetic on the CPU, and chip_smoke.py on the card.

Python-int arguments are folded on the host, so a draw whose key is a
tensor and whose words are constants costs only the tensor-side ops.
"""

from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF
GOLDEN = 0x9E3779B9
_SEED_WORD = 0x2545F491


def u32(x):
    """A u32 value as int64 in [0, 2^32) (a Python int stays an int).

    Signed int32 inputs reinterpret their two's complement bits, exactly as
    `jnp.asarray(x, uint32)` does. Precondition: an int64 input must
    already lie in [0, 2^32); it passes through unmasked (masking every
    int64 input would add an op to every draw). A -1 held in int64 is not
    0xFFFFFFFF here: as a `fold` word the multiply happens to mask it, as a
    key or a `mix` input it does not. Hold such values as int32
    (tests/test_torch_coverage.py pins both dtypes)."""
    if isinstance(x, (int, np.integer)):
        return int(x) & M32
    if x.dtype == torch.int64:
        return x
    return x.to(torch.int64) & M32


def to_i32(x: torch.Tensor) -> torch.Tensor:
    """u32 (int64 in [0, 2^32)) -> int32 with the same bits
    (`x.astype(int32)` on a uint32 array)."""
    return (x - ((x >> 31) << 32)).to(torch.int32)


def _mul32(x, c: int):
    """(x * c) mod 2^32 for a u32 value x and a u32 constant c (the int64
    product may wrap; its low 32 bits are exact, see the module doc)."""
    return (x * c) & M32


def mix(x):
    """murmur3 fmix32: full-avalanche 32-bit mixer."""
    x = u32(x)
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def fold(key, word):
    """Mix one more word into a key (broadcasting)."""
    return mix(u32(key) ^ _mul32(u32(word), GOLDEN))


def key_from(*words):
    """Build a key by folding words together (broadcasting)."""
    k = _SEED_WORD
    for w in words:
        k = fold(k, w)
    return k


def bits(key, site: int, index=0):
    """Raw uniform u32 stream: distinct per (key, site, index)."""
    return mix(fold(fold(key, site), index))


def uniform(key, site: int, index=0) -> torch.Tensor:
    """float32 in [0, 1): the top 24 bits scaled by 2^-24 (exact)."""
    return (bits(key, site, index) >> 8).to(torch.float32) * (1.0 / (1 << 24))


def randint(key, site: int, lo, hi, index=0) -> torch.Tensor:
    """int32 in [lo, hi) by modulo. A degenerate range (hi <= lo) yields lo."""
    if isinstance(lo, int) and isinstance(hi, int):
        span = max(hi - lo, 1)
    else:
        span = torch.clamp(torch.as_tensor(hi) - lo, min=1).to(torch.int64)
    return (lo + bits(key, site, index) % span).to(torch.int32)


def f32(p: float) -> float:
    """A rate as the float32 value JAX compares against, kept as a Python
    float: a float32 value widened to double compares exactly as in float32
    whichever precision torch picks for a tensor-scalar comparison."""
    return float(np.float32(p))


def bernoulli(key, site: int, p, index=0) -> torch.Tensor:
    return uniform(key, site, index) < (f32(p) if isinstance(p, float) else p)
