"""Batched scene intersection — the hot kernel (SURVEY.md section 2, row 9).

jnp reference implementation of the nearest-hit query over all primitives:
(N rays) x (R rects + S spheres) -> argmin over the object axis. The Pallas
fused version lives in ``ops/``; this module defines the semantics.

Reference semantics reproduced (contracts C8/C9/C15,
/root/reference/src/smallpt.cpp:102-112, 229-239, 323-335, 371-377):

- rect hit: t = (k - o[axis]) / d[axis]; reject if the hit point is outside
  the in-plane bounds (inclusive accept) or t <= 0 (the reference rejects
  t < 0 and a literal t == 0 is discarded by the falsy ``(d=...) &&`` test);
- sphere hit: quadratic with eps = 1e-4, near root preferred;
- nearest t over all objects, miss sentinel 1e20;
- on miss: object id is 0 (the reference leaves the caller's ``int id = 0``
  unwritten) and the hit point is (0,0,0) (``hittingPoint`` returns Vec()).

Deviation (documented): rects also use a small epsilon (SELF_HIT_EPS) instead
of accepting any t > 0, suppressing floating-point self-intersection of the
bounce origin with its own surface. In f64 the reference dodges this at ~1e-14
scale by luck of rounding; in f32 an epsilon is required. Statistically
invisible (grazing hits below 1e-3 units at scene scale ~100).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.types import OTHER_AXES, Scene, gloss_arrays, object_arrays

MISS_T = 1e20  # smallpt.cpp:326
SPHERE_EPS = 1e-4  # smallpt.cpp:231
SELF_HIT_EPS = 1e-3  # f32 self-hit guard for rects (see module docstring)
# Radius-proportional sphere eps floor: in f32 a bounce origin ON a sphere
# of radius r carries ~tens-of-ulps(r) rounding, so a re-intersection of the
# same sphere yields a spurious t up to ~4e-6*r — far above the reference's
# fixed 1e-4 for giant (radius-1e5) spheres (t noise ~0.4 units => shadow
# acne). eps_i = max(1e-4, 4e-6 * r_i): identical to the reference's eps for
# every scene-scale sphere (4e-6*16.5 = 6.6e-5 < 1e-4), acne-free for the
# original-smallpt giant walls. The reference never faces this: it runs f64
# where ulp(1e5) ~ 1e-11 (smallpt.cpp:231).
SPHERE_EPS_REL = 4e-6


class Hit(NamedTuple):
    t: jnp.ndarray        # (N,) distance, MISS_T on miss
    obj_id: jnp.ndarray   # (N,) int32 global object id, 0 on miss (C15)
    hit: jnp.ndarray      # (N,) bool


def intersect_rects(rects, o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Per-rect hit distances. o, d: (N,3). Returns (N,R), MISS_T on miss."""
    R = rects.k.shape[0]
    if R == 0:
        return jnp.full((o.shape[0], 0), MISS_T, o.dtype)
    ax = rects.axis                     # (R,)
    other = jnp.asarray(OTHER_AXES)[ax]  # (R,2)
    o_n = o[:, ax]                      # (N,R) origin component along normal
    d_n = d[:, ax]                      # (N,R)
    # Reciprocal-multiply: ONE divide per ray axis (3 total), reused by all
    # R rects — divisions are multi-op and this is the hot loop.
    # Double-where guard: a literal /0 would poison reverse-mode AD
    # (0-cotangent times inf tangent = NaN), so invert a sanitized
    # denominator and exclude parallel rays in `valid` instead. The Pallas
    # megakernel uses the identical formula for bit-parity.
    d_ok = d != 0.0                     # (N,3)
    inv_d = 1.0 / jnp.where(d_ok, d, 1.0)
    hit_plane = d_ok[:, ax]             # (N,R)
    t = (rects.k[None, :] - o_n) * inv_d[:, ax]  # (N,R)
    # In-plane hit coordinates on the two bounded axes.
    p0 = o[:, other[:, 0]] + t * d[:, other[:, 0]]
    p1 = o[:, other[:, 1]] + t * d[:, other[:, 1]]
    inb = (
        (p0 >= rects.lo[None, :, 0])
        & (p0 <= rects.hi[None, :, 0])
        & (p1 >= rects.lo[None, :, 1])
        & (p1 <= rects.hi[None, :, 1])
    )
    valid = inb & (t > SELF_HIT_EPS) & hit_plane
    return jnp.where(valid, t, MISS_T)


def intersect_quads(quads, o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Per-quad hit distances for general parallelograms. Returns (N,Q).

    Ray-plane via the quad normal, then barycentric (a, b) from the 2x2
    Gram solve; accept a,b in [0,1] (inclusive, matching the rects' C8
    bounds convention). Two-sided."""
    Q = quads.corner.shape[0]
    if Q == 0:
        return jnp.full((o.shape[0], 0), MISS_T, o.dtype)
    n = vm.cross(quads.edge_u, quads.edge_v)         # (Q,3), unnormalized
    denom = jnp.einsum("nk,qk->nq", d, n, precision=vm.HIGHEST)  # (N,Q)
    ok = denom != 0.0
    denom_safe = jnp.where(ok, denom, 1.0)
    t = jnp.einsum("nqk,qk->nq", quads.corner[None] - o[:, None], n,
                   precision=vm.HIGHEST) / denom_safe
    p = o[:, None, :] + t[..., None] * d[:, None, :] - quads.corner[None]
    # Gram matrix solve for (a, b).
    uu = jnp.sum(quads.edge_u * quads.edge_u, axis=-1)
    vv = jnp.sum(quads.edge_v * quads.edge_v, axis=-1)
    uv = jnp.sum(quads.edge_u * quads.edge_v, axis=-1)
    pu = jnp.einsum("nqk,qk->nq", p, quads.edge_u, precision=vm.HIGHEST)
    pv = jnp.einsum("nqk,qk->nq", p, quads.edge_v, precision=vm.HIGHEST)
    det = uu * vv - uv * uv
    det_safe = jnp.where(det != 0.0, det, 1.0)
    a = (pu * vv - pv * uv) / det_safe
    b = (pv * uu - pu * uv) / det_safe
    inb = (a >= 0.0) & (a <= 1.0) & (b >= 0.0) & (b <= 1.0) & (det != 0.0)
    valid = ok & inb & (t > SELF_HIT_EPS)
    return jnp.where(valid, t, MISS_T)


def intersect_spheres(spheres, o: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Per-sphere hit distances (smallpt.cpp:229-239 semantics). Returns (N,S).

    Numerically ROBUST f32 quadratic (recentered / vector-rejection form):
    the reference's textbook discriminant ``b^2 - |op|^2 + r^2``
    (smallpt.cpp:235) catastrophically cancels in f32 for giant spheres
    (|op| ~ r ~ 1e5 => three ~1e10 terms whose ~1e4 difference drowns in
    ~2^10 rounding). Instead we shift the ray origin to the closest-approach
    point in the SPHERE frame: m = (o - c) + b*d is the center-to-line
    rejection vector (scene-scale magnitude; the 1e5-sized components cancel
    with only additive ~ulp(1e5) error), and the discriminant is factored
    as det = (r - |m|)(r + |m|) — no large-term cancellation left. Roots
    t = b -/+ sqrt(det) as in the reference; eps = 1e-4, near root
    preferred. Measured (tests/test_geometry.py giant-sphere case): f32 t
    error vs an f64 oracle < 5e-4 relative at radius 1e5, vs ~O(1) for the
    textbook form. For scene-scale spheres the forms agree to float
    rounding (and this module + ops/megakernel.py share this exact
    expression tree for bit-parity)."""
    S = spheres.radius.shape[0]
    if S == 0:
        return jnp.full((o.shape[0], 0), MISS_T, o.dtype)
    op = spheres.center[None, :, :] - o[:, None, :]       # (N,S,3)
    b = jnp.sum(op * d[:, None, :], axis=-1)              # (N,S)
    m = b[..., None] * d[:, None, :] - op                 # (N,S,3) rejection
    m2 = jnp.sum(m * m, axis=-1)
    # Double-where guards: sqrt'(0) = inf would NaN reverse-mode AD for
    # through-center / grazing / miss lanes even though they are
    # where()-masked out downstream.
    m2_pos = m2 > 0.0
    mlen = jnp.where(m2_pos, jnp.sqrt(jnp.where(m2_pos, m2, 1.0)), 0.0)
    rad = spheres.radius[None, :]
    det = (rad - mlen) * (rad + mlen)
    det_pos = det > 0.0
    sdet = jnp.sqrt(jnp.where(det_pos, det, 1.0))
    t_near = b - sdet
    t_far = b + sdet
    eps = jnp.maximum(SPHERE_EPS, SPHERE_EPS_REL * rad)
    t = jnp.where(t_near > eps, t_near, t_far)
    valid = det_pos & (t > eps)
    return jnp.where(valid, t, MISS_T)


def trace(scene: Scene, o: jnp.ndarray, d: jnp.ndarray) -> Hit:
    """Nearest hit over all objects (smallpt.cpp:323-335)."""
    ts = jnp.concatenate(
        [
            intersect_rects(scene.rects, o, d),
            intersect_quads(scene.quads, o, d),
            intersect_spheres(scene.spheres, o, d),
        ],
        axis=1,
    )  # (N, R+Q+S)
    obj_id = jnp.argmin(ts, axis=1).astype(jnp.int32)  # 0 on all-miss => C15
    t = jnp.min(ts, axis=1)
    return Hit(t=t, obj_id=obj_id, hit=t < MISS_T)


class Shade(NamedTuple):
    x: jnp.ndarray         # (N,3) hit point, (0,0,0) on miss (C15)
    n: jnp.ndarray         # (N,3) normal oriented against the ray (C9)
    n_geom: jnp.ndarray    # (N,3) unoriented geometric normal (for REFR)
    albedo: jnp.ndarray    # (N,3)
    emission: jnp.ndarray  # (N,3)
    refl: jnp.ndarray      # (N,) int32
    gloss: jnp.ndarray     # (N,) Phong exponent (GLOS extension; 0 else)


def shade_info(scene: Scene, o, d, hit: Hit) -> Shade:
    """Hit point + oriented normal + material for each ray.

    Mirrors ``Hitable::normal`` (smallpt.cpp:118-124, 161-167, 204-210,
    246-253) and ``hittingPoint`` (:371-377): on miss the stale id (0) is
    shaded at x = (0,0,0) — the reference does NOT early-return (C15).
    """
    R = scene.rects.k.shape[0]
    Q = scene.quads.corner.shape[0]
    x = jnp.where(hit.hit[:, None], o + hit.t[:, None] * d, 0.0)

    albedo_all, emission_all, refl_all = object_arrays(scene)
    albedo = albedo_all[hit.obj_id]
    emission = emission_all[hit.obj_id]
    refl = refl_all[hit.obj_id]
    gloss = gloss_arrays(scene)[hit.obj_id]

    # Rect normal: unit vector along the rect's normal axis.
    is_quad = (hit.obj_id >= R) & (hit.obj_id < R + Q)
    is_sphere = hit.obj_id >= R + Q
    rect_id = jnp.clip(hit.obj_id, 0, max(R - 1, 0))
    if R > 0:
        eye = jnp.eye(3, dtype=x.dtype)
        n_rect = eye[scene.rects.axis[rect_id]]
    else:
        n_rect = jnp.zeros_like(x)
    # Quad normal: normalize(cross(edge_u, edge_v)).
    if Q > 0:
        quad_id = jnp.clip(hit.obj_id - R, 0, Q - 1)
        n_quad = vm.norm(
            vm.cross(scene.quads.edge_u, scene.quads.edge_v)
        )[quad_id]
    else:
        n_quad = jnp.zeros_like(x)
    # Sphere normal: (x - center) normalized (smallpt.cpp:246-253).
    S = scene.spheres.radius.shape[0]
    if S > 0:
        sph_id = jnp.clip(hit.obj_id - R - Q, 0, S - 1)
        n_sph = vm.norm(x - scene.spheres.center[sph_id])
    else:
        n_sph = jnp.zeros_like(x)
    n_geom = jnp.where(
        is_sphere[:, None], n_sph, jnp.where(is_quad[:, None], n_quad, n_rect)
    )
    n = vm.orient_normal(n_geom, d)
    return Shade(x=x, n=n, n_geom=n_geom, albedo=albedo, emission=emission,
                 refl=refl, gloss=gloss)
