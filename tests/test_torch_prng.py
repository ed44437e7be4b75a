"""The port's primitives against the JAX package's, bit for bit.

prng (the murmur3 draw chain), bitpack, popcount, the u32/i32 casts, the
SimConfig serialization and the copied constants. Inputs are numpy arrays
made from a seed, fed to both faces; every comparison is exact.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from madsim_tpu import nemesis as jax_nemesis
from madsim_tpu.tpu import bitpack as jbitpack
from madsim_tpu.tpu import prng as jprng
from madsim_tpu.tpu import spec as jspec
from madsim_tpu_torch import nemesis as tnemesis
from madsim_tpu_torch.tpu import bitpack as tbitpack
from madsim_tpu_torch.tpu import prng as tprng
from madsim_tpu_torch.tpu import spec as tspec
from madsim_tpu_torch.tpu.raft import raft_bench_config

BOUNDARY = np.array(
    [0, 1, 2, 0xFFFF, 0x10000, 2**31 - 1, 2**31, 2**31 + 1, 2**32 - 2,
     2**32 - 1], dtype=np.uint32,
)


def _words(n=4096, seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([
        BOUNDARY, rng.integers(0, 2**32, size=n, dtype=np.uint64).astype(np.uint32)
    ])


def _t(a):
    """numpy u32 -> the port's u32 representation (int64)."""
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _np(t):
    return t.numpy().astype(np.int64)


def _j(a):
    return np.asarray(a).astype(np.int64)


def test_u32_mix_product_wraps_exactly():
    """The u32 trap: the int64 product inside mix can pass 2^63; its low 32
    bits must equal numpy's uint32 arithmetic on every input."""
    x = _words(1 << 16, seed=1)
    for c in (0x85EBCA6B, 0xC2B2AE35, tprng.GOLDEN):
        with np.errstate(over="ignore"):
            want = (x * np.uint32(c)).astype(np.int64)
        got = _np(tprng._mul32(_t(x), c))
        np.testing.assert_array_equal(got, want)


def test_mix_fold_key_from_bits_equal_jax():
    x = _words(seed=2)
    w = _words(seed=3)
    np.testing.assert_array_equal(_np(tprng.mix(_t(x))), _j(jprng.mix(x)))
    np.testing.assert_array_equal(
        _np(tprng.fold(_t(x), _t(w))), _j(jprng.fold(x, w))
    )
    np.testing.assert_array_equal(
        _np(tprng.key_from(_t(x))), _j(jprng.key_from(x))
    )
    for site in (1, 26, 101, 2**31 - 1):
        np.testing.assert_array_equal(
            _np(tprng.bits(_t(x), site, index=_t(w))),
            _j(jprng.bits(x, site, index=w)),
        )
        np.testing.assert_array_equal(
            _np(tprng.bits(_t(x), site)), _j(jprng.bits(x, site))
        )


def test_i32_u32_casts_reinterpret_twos_complement():
    """The cast trap: negative int32 words fold as their u32 bits
    (`h.astype(uint32)`), and u32 hashes store back as int32 with the same
    bits (`nb_hash.astype(int32)`)."""
    rng = np.random.default_rng(4)
    neg = np.concatenate([
        np.array([-1, -2, -(2**31), 2**31 - 1, 0], np.int32),
        rng.integers(-(2**31), 2**31, size=4096, dtype=np.int64).astype(np.int32),
    ])
    key = _words(neg.size - BOUNDARY.size, seed=5)
    np.testing.assert_array_equal(
        _np(tprng.fold(_t(key), torch.as_tensor(neg))),
        _j(jprng.fold(key, jnp.asarray(neg))),
    )
    np.testing.assert_array_equal(
        _np(tprng.u32(torch.as_tensor(neg))),
        np.asarray(jnp.asarray(neg).astype(jnp.uint32)).astype(np.int64),
    )
    u = _words(seed=6)
    got = tprng.to_i32(_t(u))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jnp.asarray(u).astype(jnp.int32))
    )


@pytest.mark.parametrize("lo,hi", [
    (0, 5), (150_000, 300_000), (7, 7), (9, 3), (-3, 4), (0, 2**31 - 1),
    (1000, 1001),
])
def test_randint_equal_jax_including_degenerate_ranges(lo, hi):
    key = _words(seed=7)
    idx = np.arange(key.size, dtype=np.uint32)
    got = tprng.randint(_t(key), 11, lo, hi, index=_t(idx))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jprng.randint(key, 11, lo, hi, index=idx))
    )


@pytest.mark.parametrize("p", [0.1, 0.5, 0.25, 1e-7, 0.999999])
def test_uniform_and_bernoulli_float32_equal_jax(p):
    """The float32 trap: uniform is (bits >> 8) * 2^-24 in float32 and the
    coin compares against the float32 rate."""
    key = _words(1 << 15, seed=8)
    u = tprng.uniform(_t(key), 26)
    assert u.dtype == torch.float32
    np.testing.assert_array_equal(u.numpy(), np.asarray(jprng.uniform(key, 26)))
    np.testing.assert_array_equal(
        tprng.bernoulli(_t(key), 26, p).numpy(),
        np.asarray(jprng.bernoulli(key, 26, p)),
    )
    # a threshold equal to a drawn value: `<` must exclude it on both faces
    t = float(u[3])
    np.testing.assert_array_equal(
        (u < tprng.f32(t)).numpy(), np.asarray(jprng.uniform(key, 26) < t)
    )


def test_popcount_equal_jax():
    """The popcount trap: SWAR bit arithmetic equals
    jax.lax.population_count, and majority equals spec.majority."""
    import jax

    x = _words(seed=9)
    np.testing.assert_array_equal(
        _np(tspec.popcount(_t(x))),
        np.asarray(jax.lax.population_count(jnp.asarray(x))).astype(np.int64),
    )
    masks = np.arange(64, dtype=np.int32)
    for n in (3, 5, 6):
        np.testing.assert_array_equal(
            tspec.majority(torch.as_tensor(masks), n).numpy(),
            np.asarray(jspec.majority(jnp.asarray(masks), n)),
        )


@pytest.mark.parametrize("k", [1, 5, 31, 32, 33, 40, 50, 64, 70])
def test_bitpack_equal_jax_with_pad_bits(k):
    rng = np.random.default_rng(k)
    m = rng.random((7, 3, k)) < 0.5
    got = tbitpack.pack_bits(torch.as_tensor(m))
    want = np.asarray(jbitpack.pack_bits(jnp.asarray(m)))
    assert got.shape == want.shape == (7, 3, tbitpack.packed_words(k))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))
    np.testing.assert_array_equal(tbitpack.unpack_bits(got, k).numpy(), m)
    # all-ones and all-zero planes, and the words the engine initializes to
    for plane in (np.ones((2, k), bool), np.zeros((2, k), bool)):
        np.testing.assert_array_equal(
            tbitpack.pack_bits(torch.as_tensor(plane)).numpy(),
            np.asarray(jbitpack.pack_bits(jnp.asarray(plane))).astype(np.int64),
        )
    for n in (0, 1, 5, 31, 32):
        assert tbitpack.full_mask_word(n) == jbitpack.full_mask_word(n)
    with pytest.raises(ValueError):
        tbitpack.full_mask_word(33)


def _bench_cfg_jax():
    import bench

    return bench.raft_bench_config(10.0)


@pytest.mark.parametrize("which", ["default", "bench", "entry", "random"])
def test_simconfig_toml_and_hash_byte_equal(which):
    if which == "default":
        pairs = [(jspec.SimConfig(), tspec.SimConfig())]
    elif which == "bench":
        pairs = [(_bench_cfg_jax(), raft_bench_config(10.0))]
    elif which == "entry":
        kw = dict(horizon_us=5_000_000, loss_rate=0.1,
                  crash_interval_lo_us=500_000, crash_interval_hi_us=3_000_000)
        pairs = [(jspec.SimConfig(**kw), tspec.SimConfig(**kw))]
    else:
        rng = np.random.default_rng(10)
        fields = dataclasses.fields(jspec.SimConfig)
        pairs = []
        for _ in range(20):
            kw = {}
            for f in fields:
                if rng.random() < 0.3:
                    v = getattr(jspec.SimConfig(), f.name)
                    if isinstance(v, bool):
                        kw[f.name] = bool(rng.random() < 0.5)
                    elif isinstance(v, float):
                        kw[f.name] = float(rng.random())
                    else:
                        kw[f.name] = int(rng.integers(0, 10**7))
            pairs.append((jspec.SimConfig(**kw), tspec.SimConfig(**kw)))
    assert [f.name for f in dataclasses.fields(jspec.SimConfig)] == [
        f.name for f in dataclasses.fields(tspec.SimConfig)
    ]
    for a, b in pairs:
        assert a.to_toml() == b.to_toml()
        assert a.hash() == b.hash()


def test_copied_constants_equal():
    assert tnemesis.FIRE_KINDS == jax_nemesis.FIRE_KINDS
    assert tnemesis.FIRE_INDEX == jax_nemesis.FIRE_INDEX
    assert tnemesis.OCC_CLAUSES == jax_nemesis.OCC_CLAUSES
    assert tspec.INF_US == int(jspec.INF_US)
    assert tspec.EID_NONE == int(jspec.EID_NONE)
    assert tspec.REBASE_US == jspec.REBASE_US
    assert tspec.INF_GUARD == int(jspec.INF_GUARD)
    for cap, ppm in ((1_966_050_000, 0), (10**9, 123_456), (7, 999_999)):
        assert tspec.derate_horizon(cap, ppm) == jspec.derate_horizon(cap, ppm)
    with pytest.raises(ValueError):
        tspec.derate_horizon(1, 1_000_000)
