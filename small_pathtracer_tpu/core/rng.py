"""Counter-based, sharding-invariant RNG for the wavefront path tracer.

Design (SURVEY.md section 7, "Sharding-invariant RNG"): every random draw is a
pure function of ``(seed, path_id, counter)`` where ``counter`` packs
``(bounce, purpose)``.  This makes the rendered image independent of device
mesh shape, wavefront slot assignment, and regeneration schedule: a path's
randomness depends only on its global (pixel, sample) identity.

The reference uses two stateful RNGs (dual-RNG contract C6,
``/root/reference/src/smallpt.cpp:503,530`` and
``/root/reference/src/utilities.h:26-51``): C ``rand()`` seeded with
``time(NULL)`` and a per-row re-seeded rand48 LCG.  Because the reference is
not even self-reproducible (time seed), parity with it is *statistical*, so we
are free to use a proper counter-based generator.  Two backends:

- ``"mix"`` (default): a murmur3-style 2-word finalizer, ~15 integer ops per
  draw. The fast path; quality validated by chi-square tests
  (``tests/test_rng.py``).
- ``"threefry"``: ``jax.random`` threefry, for gold-standard cross-checks.

A bit-exact rand48 (numpy, host-side) is provided for A/B debugging against
the reference's ``erand48`` (``utilities.h:26-51``).
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

# How many distinct random draws one bounce may consume. Counters are packed
# as bounce * DRAWS_PER_BOUNCE + purpose.
DRAWS_PER_BOUNCE = 8

# Purpose slots within a bounce.
P_RR = 0          # Russian-roulette survival coin          (C10)
P_LIGHT_U = 1     # light sample, u extent                  (C13)
P_LIGHT_V = 2     # light sample, v extent                  (C13)
P_SCATTER_U = 3   # hemisphere sample, angle                (C11/C12)
P_SCATTER_V = 4   # hemisphere sample, radius               (C11/C12)
P_MIX_COIN = 5    # NEE-vs-BSDF mixture coin q              (C13)
P_REFR_COIN = 6   # dielectric reflect/refract RR coin      (C16)
P_LIGHT_SEL = 7  # multi-emitter light-list index draw (scene.lights)

_INV_2_24 = np.float32(1.0 / (1 << 24))


def _u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=jnp.uint32)


def _rotl32(x: jnp.ndarray, r: int) -> jnp.ndarray:
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def _fmix32(h: jnp.ndarray) -> jnp.ndarray:
    h = h ^ (h >> np.uint32(16))
    h = h * np.uint32(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * np.uint32(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def hash_u32(seed, path_id, ctr) -> jnp.ndarray:
    """murmur3_x86_32 over the two words (path_id, ctr) with ``seed``.

    All inputs broadcast; returns uint32 of the broadcast shape.
    """
    seed = _u32(seed)
    h = seed
    for block in (_u32(path_id), _u32(ctr)):
        k = block * np.uint32(0xCC9E2D51)
        k = _rotl32(k, 15)
        k = k * np.uint32(0x1B873593)
        h = h ^ k
        h = _rotl32(h, 13)
        h = h * np.uint32(5) + np.uint32(0xE6546B64)
    h = h ^ np.uint32(8)  # len in bytes
    return _fmix32(h)


def uniform_mix(seed, path_id, ctr) -> jnp.ndarray:
    """f32 uniform in [0, 1): top 24 bits of the hash."""
    bits = hash_u32(seed, path_id, ctr)
    return (bits >> np.uint32(8)).astype(jnp.float32) * _INV_2_24


_INV_2_16 = np.float32(1.0 / (1 << 16))


def uniform_mix_packed(seed, path_id, ctr) -> jnp.ndarray:
    """Packed variant: ONE hash yields TWO 16-bit draws — counter pairs
    (2k, 2k+1) share the hash of counter k and take the low/high half.

    Halves of a murmur-finalized word are statistically independent; 16-bit
    resolution (2^-16 ~ 1.5e-5) is far below MC noise at any practical spp.
    Saves ~40% of RNG ALU on NEE bounces (5 draws -> 3 hashes) — the
    megakernel headroom experiment from round-1 PERF.md. A distinct
    backend (not the default) because it changes the sampled sequence."""
    ctr = _u32(ctr)
    bits = hash_u32(seed, path_id, ctr >> np.uint32(1))
    half = jnp.where(
        (ctr & np.uint32(1)) != 0, bits >> np.uint32(16),
        bits & np.uint32(0xFFFF),
    )
    return half.astype(jnp.float32) * _INV_2_16


def uniform_threefry(seed, path_id, ctr) -> jnp.ndarray:
    """Gold-standard backend: the threefry-2x32 block cipher applied to the
    per-draw counter pair (path_id, ctr) under key (seed, seed^golden).

    Same counter-RNG contract as ``uniform_mix`` (pure function of
    (seed, path_id, ctr); sharding/schedule invariant), ~10x more ALU — used
    to cross-validate the cheap mixer's statistical quality.
    """
    from jax.extend.random import threefry_2x32

    path_id = _u32(path_id)
    ctr = jnp.broadcast_to(_u32(ctr), path_id.shape)
    key = (_u32(seed), _u32(seed) ^ np.uint32(0x9E3779B9))
    flat = jnp.concatenate([path_id.ravel(), ctr.ravel()])
    bits = threefry_2x32(jnp.stack(jnp.broadcast_arrays(*key)), flat)
    out = bits[: path_id.size].reshape(path_id.shape)
    return (out >> np.uint32(8)).astype(jnp.float32) * _INV_2_24


def make_uniform_fn(backend: str = "mix"):
    """uniform(seed, path_id, ctr, purpose=None) for the hash backend.

    The optional ``purpose`` keyword is the trace-time draw-site hint the
    Owen-Sobol sampler specializes on (core/ld.py); the hash backends are
    purpose-blind and ignore it."""
    if backend == "mix":
        base = uniform_mix
    elif backend == "mix_packed":
        base = uniform_mix_packed
    elif backend == "threefry":
        base = uniform_threefry
    else:
        raise ValueError(f"unknown rng backend: {backend!r}")

    def uniform(seed, path_id, ctr, purpose=None):
        return base(seed, path_id, ctr)

    return uniform


# ---------------------------------------------------------------------------
# Bit-exact rand48 (host-side numpy) for A/B vs the reference's erand48.
# Semantics match /root/reference/src/utilities.h:26-51: 48-bit LCG with
# multiplier 0x5DEECE66D and addend 0xB; erand48 returns the 48-bit state
# scaled by 2^-48. State seeding follows the reference driver
# (smallpt.cpp:530): Xi = {0, 0, (unsigned short)(y*y*y)} per image row.
# ---------------------------------------------------------------------------

RAND48_MULT = np.uint64(0x5DEECE66D)
RAND48_ADD = np.uint64(0xB)
RAND48_MASK = np.uint64((1 << 48) - 1)


def rand48_seed_row(y: int) -> np.uint64:
    """Row seed per smallpt.cpp:530: Xi = {0,0,(u16)(y^3)} => high 16 bits."""
    hi = np.uint64((y * y * y) & 0xFFFF)
    return hi << np.uint64(32)


def erand48_sequence(state: np.uint64, n: int) -> tuple[np.ndarray, np.uint64]:
    """Generate n doubles in [0,1) exactly as POSIX erand48 would."""
    out = np.empty(n, dtype=np.float64)
    s = np.uint64(state)
    for i in range(n):
        s = (s * RAND48_MULT + RAND48_ADD) & RAND48_MASK
        out[i] = float(s) * (2.0 ** -48)
    return out, s
