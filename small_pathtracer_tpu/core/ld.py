"""Low-discrepancy sampling: hash-based Owen-scrambled 2D Sobol points.

The reference draws every random number from stateful LCGs (dual-RNG
contract C6, /root/reference/src/smallpt.cpp:503,530) — plain independent
uniforms. This module adds the production-renderer upgrade the reference
never had: per-pixel Owen-scrambled (0,2)-sequences for the sample
dimensions that dominate variance (pixel jitter, lens disk, the light-plane
point and the scatter angles of each bounce), with every other decision
(RR/mixture/selection coins) left on the counter-hash RNG.

Design ("padded 2D Sobol", the construction used by most production path
tracers, after Burley, "Practical Hash-Based Owen Scrambling", JCGT 2020):

- Each 2D *decision* (pixel jitter; lens; per-bounce light pair; per-bounce
  scatter pair) gets its own independently shuffled + scrambled copy of the
  first-two-dimension Sobol (0,2)-sequence, keyed by
  ``hash(seed, pixel, decision)``. Within a pixel, the N = spp samples of a
  decision form a scrambled (0, 2)-net: 1D projections land exactly one
  sample per 1/N stratum, 2D elementary intervals hold exactly one sample
  (tests/test_ld.py) — direct-light and AA variance drops from O(1/N)
  toward O(N^-1.5 .. N^-2) on smooth integrands.
- Across decisions and across pixels the scramble keys are independent
  hashes, so joint dimensions decouple ("padding") and neighboring pixels
  do not alias.
- Owen scrambling keeps every draw marginally uniform on [0,1), so all
  estimators remain unbiased — only the per-pixel JOINT distribution of a
  decision's N samples changes (anti-correlated instead of independent).

Everything here is pure elementwise uint32 jnp — add/mul/xor/shift/select
only, no gathers, no u32->f32 casts — and is shared verbatim
by the jnp wavefront and the Pallas megakernel, so the schedules stay
bit-identical per sample (the same guarantee the murmur backend has).

The sample-within-pixel index is recovered from the packed path id
(path_id = pixel * spp + sample, integrator/wavefront.py _chunk_paths) with
an exact constant-divisor divmod (Granlund-Montgomery magic via 16-bit-limb
mulhi) — no u64, no dynamic division. (The limb form and the cast detour
below were needed by an earlier kernel compiler; ROADMAP lists them for
simplification.)
"""

from __future__ import annotations

import math

import jax.numpy as jnp
import numpy as np

from . import rng

# Purpose tokens for the camera draws (counters 0..3 at spawn, below
# DRAWS_PER_BOUNCE — camera/pinhole.primary_rays_cfg). Bounce draws use the
# rng.P_* ints as their purpose hints.
CAM_U = "cam_u"
CAM_V = "cam_v"
LENS_U = "lens_u"
LENS_V = "lens_v"

# Largest spp the Sobol index shuffle supports (16 index bits keeps the
# second-dimension evaluation at <= 16 unrolled steps).
MAX_SPP = 1 << 16

# (decision-slot offset, component) per LD purpose. Camera decisions own
# slots 0/1; bounce b >= 1 uses slots 2*b + {2 (light pair), 3 (scatter
# pair)} — disjoint from the camera slots because b >= 1.
_CAM_DECISIONS = {CAM_U: (0, 0), CAM_V: (0, 1), LENS_U: (1, 0), LENS_V: (1, 1)}
_BOUNCE_DECISIONS = {
    rng.P_LIGHT_U: (2, 0),
    rng.P_LIGHT_V: (2, 1),
    rng.P_SCATTER_U: (3, 0),
    rng.P_SCATTER_V: (3, 1),
}

_INV_2_24 = np.float32(1.0 / (1 << 24))


def _u32(x):
    return jnp.asarray(x, jnp.uint32)


def rev32(x):
    """Bit-reverse a uint32 (5-stage butterfly)."""
    x = _u32(x)
    x = ((x & np.uint32(0x55555555)) << np.uint32(1)) | (
        (x >> np.uint32(1)) & np.uint32(0x55555555))
    x = ((x & np.uint32(0x33333333)) << np.uint32(2)) | (
        (x >> np.uint32(2)) & np.uint32(0x33333333))
    x = ((x & np.uint32(0x0F0F0F0F)) << np.uint32(4)) | (
        (x >> np.uint32(4)) & np.uint32(0x0F0F0F0F))
    x = ((x & np.uint32(0x00FF00FF)) << np.uint32(8)) | (
        (x >> np.uint32(8)) & np.uint32(0x00FF00FF))
    return (x << np.uint32(16)) | (x >> np.uint32(16))


def lk_hash(x, key):
    """Laine-Karras-style hash: flips bit j of x based only on bits < j
    (and the key), i.e. an Owen scramble of the REVERSED-bit domain.
    Constants from Burley, JCGT 2020 (listing 4)."""
    x = _u32(x)
    x = x + _u32(key)
    x = x ^ (x * np.uint32(0x6C50B47C))
    x = x ^ (x * np.uint32(0xB82F1E52))
    x = x ^ (x * np.uint32(0xC7AFE638))
    x = x ^ (x * np.uint32(0x8D22F6E6))
    return x


def _fmix32(h):
    h = _u32(h)
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def sobol_dim1(idx, nbits: int):
    """Second Sobol dimension (the classic direction numbers v_0 =
    0x80000000, v_k = v_{k-1} ^ (v_{k-1} >> 1)) of index ``idx``, which must
    be < 2**nbits. Unrolled GF(2) matrix-vector product: nbits masked XORs."""
    idx = _u32(idx)
    out = jnp.zeros_like(idx)
    v = np.uint32(0x80000000)
    for k in range(nbits):
        bit = (idx >> np.uint32(k)) & np.uint32(1)
        # mask = 0xFFFFFFFF when the bit is set, else 0 (branch-free).
        mask = np.uint32(0) - bit
        out = out ^ (np.uint32(v) & mask)
        v = np.uint32(v ^ (v >> np.uint32(1)))
    return out


def _bits_to_f01(bits):
    """Top-24-bit uint32 -> f32 in [0,1), matching the murmur backends'
    precision. Values < 2^24 are exact through the i32 view
    (ops/megakernel._uniform uses the same trick)."""
    q = (bits >> np.uint32(8)).view(jnp.int32)
    return q.astype(jnp.float32) * _INV_2_24


# ---------------------------------------------------------------------------
# Exact u32 divmod by a compile-time constant (Granlund-Montgomery /
# Hacker's Delight 10-10 "magicu"), built from 16-bit-limb multiplies so it
# runs without u64 or hardware division.
# ---------------------------------------------------------------------------


def _magicu(d: int) -> tuple[int, int]:
    """(M, p) with floor(n/d) == (n*M) >> p for all n < 2^32 (M may be 33
    bits — callers handle the overflow fixup)."""
    nc = (1 << 32) // d * d - 1
    for p in range(32, 64):
        if (1 << p) > nc * (d - 1 - ((1 << p) - 1) % d):
            m = ((1 << p) + d - 1 - ((1 << p) - 1) % d) // d
            return m, p
    raise AssertionError(f"no magic for divisor {d}")  # unreachable


def _mulhi_const(n, m: int):
    """High 32 bits of (uint32 n) * (uint32 constant m), via 16-bit limbs."""
    n = _u32(n)
    m_lo = np.uint32(m & 0xFFFF)
    m_hi = np.uint32(m >> 16)
    n_lo = n & np.uint32(0xFFFF)
    n_hi = n >> np.uint32(16)
    p0 = n_lo * m_lo
    p1 = n_lo * m_hi
    p2 = n_hi * m_lo
    p3 = n_hi * m_hi
    mid = (p0 >> np.uint32(16)) + (p1 & np.uint32(0xFFFF)) + (
        p2 & np.uint32(0xFFFF))
    return p3 + (p1 >> np.uint32(16)) + (p2 >> np.uint32(16)) + (
        mid >> np.uint32(16))


def make_divmod_u32(d: int):
    """Returns divmod(n) -> (n // d, n % d), exact for every uint32 n."""
    assert d >= 1
    if d == 1:
        return lambda n: (_u32(n), jnp.zeros_like(_u32(n)))
    if d & (d - 1) == 0:
        sh = np.uint32(d.bit_length() - 1)
        lo = np.uint32(d - 1)

        def divmod_pow2(n):
            n = _u32(n)
            return n >> sh, n & lo

        return divmod_pow2

    m, p = _magicu(d)
    if m < (1 << 32):
        sh = np.uint32(p - 32)

        def divmod_magic(n):
            n = _u32(n)
            q = _mulhi_const(n, m) >> sh
            return q, n - q * np.uint32(d)

        return divmod_magic

    # 33-bit magic: q = ((((n - t) >> 1) + t) >> (p - 33)), t = mulhi(n, m').
    a = m - (1 << 32)
    sh = np.uint32(p - 33)

    def divmod_fixup(n):
        n = _u32(n)
        t = _mulhi_const(n, a)
        q = (((n - t) >> np.uint32(1)) + t) >> sh
        return q, n - q * np.uint32(d)

    return divmod_fixup


# ---------------------------------------------------------------------------
# The sampler.
# ---------------------------------------------------------------------------


def shuffled_index(samp, key, kbits: int):
    """Owen-shuffled sample index: a hierarchical permutation of
    [0, 2^kbits) (Burley's nested_uniform_scramble restricted to the top
    kbits — valid because lk_hash's bit j depends only on bits <= j, so the
    top-k window is closed under the permutation)."""
    y = lk_hash(rev32(samp), key)
    mask = np.uint32((1 << kbits) - 1) if kbits < 32 else np.uint32(0xFFFFFFFF)
    return rev32(y) & mask


def make_sobol_uniform(spp: int, base):
    """uniform(seed, path_id, ctr, purpose=None) -> f32 in [0,1).

    ``purpose`` is the trace-time hint call sites attach to each draw: one
    of the rng.P_* ints for bounce draws (ctr == depth*DRAWS_PER_BOUNCE +
    purpose) or the CAM_*/LENS_* tokens for the spawn draws (ctr == 0..3).
    Light/scatter pairs and camera pairs take the Owen-Sobol path; every
    other purpose (RR/mixture/selection coins, or purpose=None from callers
    that predate the hint) falls through to ``base`` — the murmur counter
    hash — unchanged.

    path_id must be pixel * spp + sample (the packed id every schedule
    uses); ``spp`` is the compile-time samples-per-pixel.
    """
    if spp > MAX_SPP:
        raise ValueError(
            f"sampler='sobol' supports spp <= {MAX_SPP} (got {spp}); "
            "use sampler='random' beyond that"
        )
    kbits = max(1, math.ceil(math.log2(max(2, spp))))
    dm = make_divmod_u32(spp)

    def uniform(seed, path_id, ctr, purpose=None):
        if purpose in _CAM_DECISIONS:
            dec_const, comp = _CAM_DECISIONS[purpose]
            dec = np.uint32(dec_const)
        elif purpose in _BOUNCE_DECISIONS:
            off, comp = _BOUNCE_DECISIONS[purpose]
            # bounce = ctr >> 3 >= 1; decision slot 2*bounce + off.
            dec = ((_u32(ctr) >> np.uint32(3)) << np.uint32(1)) + np.uint32(off)
        else:
            return base(seed, path_id, ctr)

        pixel, samp = dm(path_id)
        key_sh = rng.hash_u32(_u32(seed), pixel, dec)
        key_val = _fmix32(
            key_sh ^ np.uint32(0x9E3779B9 if comp else 0x61C88647)
        )
        sidx = shuffled_index(samp, key_sh, kbits)
        if comp == 0:
            # Dim 0 is rev32(sidx); the value scramble rev-lk-rev telescopes
            # to rev32(lk(sidx)).
            pre = sidx
        else:
            pre = rev32(sobol_dim1(sidx, kbits))
        bits = rev32(lk_hash(pre, key_val))
        return _bits_to_f01(bits)

    return uniform


def make_uniform_cfg(cfg, base):
    """The per-config uniform closure: Owen-Sobol when cfg.sampler ==
    'sobol', otherwise ``base`` wrapped to accept (and ignore) the purpose
    hint. ``base`` is the context's hash uniform — core/rng.make_uniform_fn
    for jnp callers, ops/megakernel._uniform_for inside the kernel (their
    u32->f32 conventions produce identical values; see _bits_to_f01)."""
    if getattr(cfg, "sampler", "random") == "sobol":
        return make_sobol_uniform(cfg.spp, base)

    def uniform(seed, path_id, ctr, purpose=None):
        return base(seed, path_id, ctr)

    return uniform
