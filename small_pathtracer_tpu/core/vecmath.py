"""Batched 3-vector math over (..., 3) arrays.

Array replacement for the reference's scalar ``Vec`` class
(/root/reference/src/smallpt.cpp:24-62): positions and RGB colors are both
(..., 3) float32 arrays; everything is elementwise and fuses under XLA.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Precision for every float32 dot_general/einsum/matmul in the renderer: on
# a GPU a float32 product may otherwise run in TF32 (~3 decimal digits).
HIGHEST = jax.lax.Precision.HIGHEST


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched dot product over the trailing axis. (...,3),(...,3) -> (...,)."""
    return jnp.sum(a * b, axis=-1)


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Batched cross product (reference ``operator%``, smallpt.cpp:56-58)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def norm(a: jnp.ndarray) -> jnp.ndarray:
    """Normalize over the trailing axis (reference ``Vec::norm``)."""
    return a * jax.lax.rsqrt(jnp.sum(a * a, axis=-1, keepdims=True))


def magnitude(a: jnp.ndarray) -> jnp.ndarray:
    return jnp.sqrt(jnp.sum(a * a, axis=-1))


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection ``d - n*2*(n.d)`` (commented SPEC branch,
    smallpt.cpp:482-483). Sign of n does not matter."""
    return d - n * (2.0 * dot(n, d))[..., None]


def orient_normal(n: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Flip n to face against the incoming ray: ``n.dot(d) < 0 ? n : -n``
    (contract C9, smallpt.cpp:118-124 etc.). Note dot==0 yields -n, matching
    the reference's ternary."""
    return jnp.where((dot(n, d) < 0.0)[..., None], n, -n)


def onb_from_w(w: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Orthonormal frame used by both hemisphere samplers (contract C11/C12,
    smallpt.cpp:344-346): u = normalize(cross(|w.x|>.1 ? (0,1,0) : (1,0,0), w)),
    v = cross(w, u). Returns (u, v)."""
    pick = (jnp.abs(w[..., 0]) > 0.1)[..., None]
    a = jnp.where(
        pick,
        jnp.asarray([0.0, 1.0, 0.0], dtype=w.dtype),
        jnp.asarray([1.0, 0.0, 0.0], dtype=w.dtype),
    )
    u = norm(cross(a, w))
    v = cross(w, u)
    return u, v


def sincos_2pi(u: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(sin, cos) of ``2*pi*u`` for uniform draws ``u`` in [0, 1).

    Quarter-wave minimax polynomial instead of the transcendental pair:
    every scatter-frame site burns one sincos per bounce. The quadrant is exact
    (u is a binade-bounded uniform draw, so ``u*4`` and the fold are
    exact float ops); within a quadrant both values come from the same
    degree-9 odd polynomial for sin(pi/2 f) (cos via the complementary
    angle), max abs error 2.1e-7 vs float64 — f32-rounding-limited
    (tests/test_core.py).

    EVERY render path (jnp wavefront, Pallas megakernel, adjoint replay,
    path guiding) must use this helper: the schedules' bit-for-bit
    per-sample parity contract includes the scatter frame.
    """
    f32 = jnp.float32
    x4 = u.astype(jnp.float32) * f32(4.0)
    qd = jnp.floor(x4)
    f = x4 - qd
    g = f32(1.0) - f

    def qsin(t):
        t2 = t * t
        return t * (f32(1.5707962973) + t2 * (f32(-0.6459634395)
                    + t2 * (f32(0.0796887379) + t2 * (f32(-0.0046725480)
                    + t2 * f32(0.0001509561)))))

    s0 = qsin(f)            # sin(pi/2 * f)
    c0 = qsin(g)            # cos(pi/2 * f) = sin(pi/2 * (1 - f))
    qi = qd.astype(jnp.int32) & jnp.int32(3)
    swap = (qi & jnp.int32(1)) == jnp.int32(1)
    sb = jnp.where(swap, c0, s0)
    cb = jnp.where(swap, s0, c0)
    sin = jnp.where(qi < jnp.int32(2), sb, -sb)
    cos = jnp.where((qi == jnp.int32(0)) | (qi == jnp.int32(3)), cb, -cb)
    return sin, cos


def pow_const(x, k: float):
    """x ** k for a BAKED exponent: small integer k lowers to a
    multiply/squaring chain (3 multiplies for k=8) instead of a
    multi-pass transcendental pow. Shared by the jnp guided estimator
    (experiment/path_guiding.py) and the Pallas kernel
    (ops/megakernel.py) so both produce identical floats (the
    bit-parity contract). Falls back to ** for non-integer/large k."""
    kf = float(k)
    if kf.is_integer() and 1 <= kf <= 64:
        n = int(kf)
        result = None
        base = x
        while n:
            if n & 1:
                result = base if result is None else result * base
            n >>= 1
            if n:
                base = base * base
        return result
    return x ** kf
