"""Bit-packed bool planes, value-equal to `madsim_tpu/tpu/bitpack.py`.

The engine's validity planes (`alive [L,N]`, `link_ok [L,N,N]`, the pool's
`valid [L,N,CK]`) rest packed 32 to a word along their last axis, bit j of
word w holding element w * 32 + j, trailing pad bits 0. Words are u32
values held in int64 (see prng.py for why).
"""

from __future__ import annotations

import torch


def packed_words(k: int) -> int:
    """Words needed to hold `k` bits (ceil(k / 32))."""
    return -(-k // 32)


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """bool [..., K] -> u32-in-int64 [..., ceil(K/32)]."""
    K = mask.shape[-1]
    W = packed_words(K)
    pad = W * 32 - K
    if pad:
        mask = torch.cat(
            [mask, mask.new_zeros(mask.shape[:-1] + (pad,))], dim=-1
        )
    b = mask.reshape(mask.shape[:-1] + (W, 32)).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    # the shifted bits are disjoint, so the sum IS the bitwise OR
    return (b << shifts).sum(dim=-1)


def unpack_bits(words: torch.Tensor, k: int) -> torch.Tensor:
    """u32-in-int64 [..., W] -> bool [..., k] (inverse of pack_bits)."""
    shifts = torch.arange(32, dtype=torch.int64, device=words.device)
    b = (words[..., :, None] >> shifts) & 1
    flat = b.reshape(words.shape[:-1] + (words.shape[-1] * 32,))
    return flat[..., :k] != 0


def full_mask_word(n: int) -> int:
    """The packed representation of n all-true bits in one word (n <= 32)."""
    if not 0 <= n <= 32:
        raise ValueError(f"n must be in [0, 32], got {n}")
    return (1 << n) - 1 if n < 32 else 0xFFFFFFFF
