"""Direction samplers (contracts C11/C12/C13).

Pure batched functions; randomness comes in as explicit uniform arguments so
the integrator controls the counter-RNG stream.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..core import vecmath as vm
from ..scene.types import (
    LIGHT_RECT, LIGHT_SPHERE, LightList, LightSampler, SphereLight,
)


def sample_cosine(nl: jnp.ndarray, u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Cosine-weighted hemisphere direction around nl (contract C11,
    /root/reference/src/smallpt.cpp:337-348):
    r1 = 2*pi*u1, r2 = u2; dir = u*cos(r1)*sqrt(r2) + v*sin(r1)*sqrt(r2)
    + w*sqrt(1-r2), normalized."""
    sr1, cr1 = vm.sincos_2pi(u1)
    r2s = jnp.sqrt(u2)
    u, v = vm.onb_from_w(nl)
    d = (
        u * (cr1 * r2s)[..., None]
        + v * (sr1 * r2s)[..., None]
        + nl * jnp.sqrt(1.0 - u2)[..., None]
    )
    return vm.norm(d)


def sample_uniform(nl: jnp.ndarray, u1: jnp.ndarray, u2: jnp.ndarray) -> jnp.ndarray:
    """Uniform hemisphere direction (contract C12, the commented variant at
    smallpt.cpp:352-360): cos(theta) = 1 - r2 (uniform in solid angle);
    dir = u*cos(r1)*sqrt(r2*(2-r2)) + v*sin(r1)*sqrt(r2*(2-r2)) + w*(1-r2)."""
    sr1, cr1 = vm.sincos_2pi(u1)
    sin_t = jnp.sqrt(u2 * (2.0 - u2))
    u, v = vm.onb_from_w(nl)
    d = (
        u * (cr1 * sin_t)[..., None]
        + v * (sr1 * sin_t)[..., None]
        + nl * (1.0 - u2)[..., None]
    )
    return vm.norm(d)


def sample_phong(
    mirror: jnp.ndarray, u1: jnp.ndarray, u2: jnp.ndarray, n_exp: jnp.ndarray
) -> jnp.ndarray:
    """Power-cosine lobe around the mirror direction (the GLOS extension —
    no reference analogue; Refl_t stops at REFR, smallpt.cpp:72-74).

    cos(alpha) = u2^(1/(n+1)), phi = 2*pi*u1 in the onb_from_w frame of
    ``mirror`` — the exact sampler for the modified-Phong pdf
    p(w) = (n+1)/(2*pi) * cos^n(alpha). n_exp may be per-lane (N,).

    Sampled directions can fall below the SURFACE hemisphere (the lobe
    straddles it for grazing mirrors); callers must zero/kill those lanes
    (phong_weight returns 0 there)."""
    sr1, cr1 = vm.sincos_2pi(u1)
    cos_a = u2 ** (1.0 / (n_exp + 1.0))
    sin_a = jnp.sqrt(jnp.maximum(1.0 - cos_a * cos_a, 0.0))
    u, v = vm.onb_from_w(mirror)
    d = (
        u * (cr1 * sin_a)[..., None]
        + v * (sr1 * sin_a)[..., None]
        + mirror * cos_a[..., None]
    )
    return vm.norm(d)


def _pow_safe(base: jnp.ndarray, n_exp: jnp.ndarray) -> jnp.ndarray:
    """max(base, 0)^n with an AD-safe 0 base (d/dx x^n at x=0 NaNs for
    n < 1 through the exp/log lowering; double-where keeps the primal and
    the cotangent finite)."""
    pos = base > 0.0
    safe = jnp.where(pos, base, 1.0)
    return jnp.where(pos, safe**n_exp, 0.0)


def phong_pdf(
    d: jnp.ndarray, mirror: jnp.ndarray, n_exp: jnp.ndarray
) -> jnp.ndarray:
    """Solid-angle density of sample_phong at direction d:
    (n+1)/(2*pi) * max(d . mirror, 0)^n."""
    cos_a = vm.dot(d, mirror)
    return (n_exp + 1.0) * (1.0 / (2.0 * math.pi)) * _pow_safe(cos_a, n_exp)


def phong_brdf_over_albedo(
    d: jnp.ndarray, mirror: jnp.ndarray, n_exp: jnp.ndarray
) -> jnp.ndarray:
    """Modified-Phong BRDF divided by albedo:
    f / rho = (n+2)/(2*pi) * max(d . mirror, 0)^n. Energy-conserving
    (integral of f * cos over the hemisphere <= rho for any mirror tilt)."""
    cos_a = vm.dot(d, mirror)
    return (n_exp + 2.0) * (1.0 / (2.0 * math.pi)) * _pow_safe(cos_a, n_exp)


def phong_weight(
    d: jnp.ndarray, mirror: jnp.ndarray, nl: jnp.ndarray, n_exp: jnp.ndarray
) -> jnp.ndarray:
    """Path weight (f * cos / (pdf * albedo)) for a sample_phong direction:
    (n+2)/(n+1) * max(d . nl, 0) — the cos^n factors cancel exactly.
    Zero when the lobe sample fell below the surface (absorbed; callers
    kill the lane)."""
    del mirror  # cancels against the pdf; kept for signature symmetry
    return (
        (n_exp + 2.0) / (n_exp + 1.0)
    ) * jnp.maximum(vm.dot(d, nl), 0.0)


def light_area_normal(light: LightSampler):
    """Area and unit normal of the NEE sample parallelogram. For the Cornell
    presets: area = |(36,0,0) x (0,0,36)| = 1296 (the reference's hard-coded
    constant, smallpt.cpp:471) and normal = (0,1,0)."""
    c = vm.cross(light.edge_u, light.edge_v)
    area = vm.magnitude(c)
    # [..., None]: broadcasts for both the scalar single-light case ((3,)
    # edges) and the lane-batched multi-light case ((N, 3) edges).
    # Degenerate (zero-area) rows — sphere entries of a mixed LightList
    # store edge_v = 0 — must not emit NaN normals (NaNs poison the
    # jnp.where selects downstream even on masked lanes).
    area_safe = jnp.where(area > 0.0, area, 1.0)
    return area, c / area_safe[..., None]


# ---------------------------------------------------------------------------
# Spherical emitters (scene/types.SphereLight) — uniform cone sampling.
# The solid-angle analogue of the parallelogram area sampler: draw a
# direction uniformly inside the cone the sphere subtends from the shading
# point; density 1/(2*pi*(1-cos_theta_max)) per steradian.
# ---------------------------------------------------------------------------


def sphere_cone(center, radius, x: jnp.ndarray):
    """Cone geometry of a sphere light seen from ``x`` ((N,3)).

    Returns (w_hat (N,3) unit axis toward the center, cos_max (N,),
    pdf_inv (N,) = 2*pi*(1-cos_max) — the inverse solid-angle density of
    ``sample_sphere_dir``). A point INSIDE the sphere (or at its center)
    degrades to uniform-over-all-directions: cos_max = -1, pdf_inv = 4*pi.
    center may be (3,) or lane-batched (N,3); radius () or (N,)."""
    wc = center - x
    d2 = vm.dot(wc, wc)
    # Double-where: keep rsqrt/sqrt away from 0 for reverse-mode AD.
    d2_pos = d2 > 0.0
    d2_safe = jnp.where(d2_pos, d2, 1.0)
    w_hat = jnp.where(
        d2_pos[..., None],
        wc * jax.lax.rsqrt(d2_safe)[..., None],
        jnp.asarray([0.0, 0.0, 1.0], x.dtype),
    )
    sin2 = (radius * radius) / d2_safe
    outside = d2_pos & (sin2 < 1.0)
    cos_max = jnp.where(
        outside,
        jnp.sqrt(jnp.where(outside, 1.0 - sin2, 1.0)),
        -1.0,
    )
    pdf_inv = (2.0 * math.pi) * (1.0 - cos_max)
    return w_hat, cos_max, pdf_inv


def sample_sphere_dir(center, radius, x, u1, u2):
    """Uniform direction in the sphere light's cone from ``x``:
    cos_theta = 1 - u2*(1 - cos_max), phi = 2*pi*u1 in the onb_from_w frame
    of the center axis. Returns (N,3) unit directions. Same frame/normalize
    expression trees as sample_cosine for kernel bit-parity."""
    w_hat, cos_max, _ = sphere_cone(center, radius, x)
    cos_t = 1.0 - u2 * (1.0 - cos_max)
    sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
    sr1, cr1 = vm.sincos_2pi(u1)
    u, v = vm.onb_from_w(w_hat)
    d = (
        u * (cr1 * sin_t)[..., None]
        + v * (sr1 * sin_t)[..., None]
        + w_hat * cos_t[..., None]
    )
    return vm.norm(d)


def sphere_nee_weight(center, radius, x, d_hat, nl):
    """C13-style sphere-light path weight: PDF_inverse * BRDF =
    [2*pi*(1-cos_max)] * |d_hat . nl| / pi — the cone sampler's exact
    analogue of nee_weight's |area*cos_l|/t^2 * |d.nl|/pi."""
    _, _, pdf_inv = sphere_cone(center, radius, x)
    return pdf_inv * jnp.abs(vm.dot(d_hat, nl)) * (1.0 / math.pi)


def make_sphere_list_entry(center, radius):
    """Packed LightList row for a spherical emitter (host-side helper):
    corner = center, edge_u = (radius, 0, 0), edge_v = 0 — see
    scene/types.LightList.kind."""
    return (
        tuple(float(v) for v in center),
        (float(radius), 0.0, 0.0),
        (0.0, 0.0, 0.0),
    )


def list_entry_sphere_params(light: LightSampler):
    """(center, radius) view of a (possibly lane-batched) LightSampler
    whose rows are LIGHT_SPHERE entries (make_sphere_list_entry packing)."""
    return light.corner, light.edge_u[..., 0]


# Shadow-ray origin lift for multi-emitter (light-list) NEE probes, in
# absolute scene units along the shading normal. The single-light C13
# sampler targets a plane 0.1 BEYOND the light surface (the 81.6-vs-81.5
# reference quirk, scene/presets.py), which incidentally keeps its probes
# away from any self-intersection knife edge; list samplers target the true
# light plane, so a probe fired from a surface NEAR-COPLANAR with the light
# (e.g. the Cornell ceiling at y=81.6 toward a light at y=81.5) is almost
# parallel to its own surface and re-hits it at t ~ (f32 hit-point
# rounding)/|d_y| ~ 4e-3 — above the 1e-4 intersection eps, so ~half of
# such probes falsely self-occlude, with the outcome decided by the LAST
# BIT of the hit point. Lifting the probe origin by SHADOW_EPS (~100x the
# f32 rounding of Cornell-scale coordinates, and small enough that the
# cos/t^2 weight shifts by O(1e-5) relative) removes the false occlusion
# and makes the estimator implementation-rounding-stable. Applied ONLY on
# the light-list path — the single-light path reproduces the reference's
# exact probe geometry (smallpt.cpp:463-470).
SHADOW_EPS = 1e-3


def sample_light_point(
    light: LightSampler, u1: jnp.ndarray, u2: jnp.ndarray
) -> jnp.ndarray:
    """Uniform point on the NEE parallelogram (contract C13,
    smallpt.cpp:363-369). Returns (N,3)."""
    return (
        light.corner
        + u1[..., None] * light.edge_u
        + u2[..., None] * light.edge_v
    )


def _glibc_overflow_offset(u: jnp.ndarray) -> jnp.ndarray:
    """Reproduce ``rand() * 36 / double(RAND_MAX)`` under glibc.

    The reference's light sampler (smallpt.cpp:365-366) multiplies ``rand()``
    (int, up to RAND_MAX = 2^31-1 on glibc) by 36 in int arithmetic, which
    overflows and wraps to a signed value in [-2^31, 2^31); dividing by
    RAND_MAX yields an offset in (-1, 1) instead of [0, 36). On the author's
    MinGW toolchain (RAND_MAX = 32767, per the committed Eclipse project
    files) there is no overflow — so the committed renders used the intended
    full-range sampling while a Linux build samples a ~2x2 patch at the
    light's corner. Verified this session by instrumenting a /tmp build:
    intended => 62.8% NEE success, mean path 2.50; overflow => 16.4%, 5.13.
    """
    # u carries 24 random bits, so u * 2^31 is exact in f32 (= bits << 7) and
    # converts losslessly to uint32; uint32 multiply wraps mod 2^32 like the
    # reference's int arithmetic, then reinterpret as signed.
    r = (u * jnp.float32(2147483648.0)).astype(jnp.uint32)
    wrapped = (r * jnp.uint32(36)).view(jnp.int32).astype(jnp.float32)
    return wrapped * jnp.float32(1.0 / 2147483647.0)


def sample_light_point_glibc(
    light: LightSampler, u1: jnp.ndarray, u2: jnp.ndarray
) -> jnp.ndarray:
    """Bit-faithful glibc-overflow light sample (see _glibc_overflow_offset).

    Offsets are in absolute scene units along the *unit* edge directions —
    exactly matching the reference for the Cornell presets (|edge| = 36)."""
    eu = light.edge_u / vm.magnitude(light.edge_u)
    ev = light.edge_v / vm.magnitude(light.edge_v)
    return (
        light.corner
        + _glibc_overflow_offset(u1)[..., None] * eu
        + _glibc_overflow_offset(u2)[..., None] * ev
    )


def nee_weight(
    light: LightSampler,
    d_hat: jnp.ndarray,
    nl: jnp.ndarray,
    t: jnp.ndarray,
) -> jnp.ndarray:
    """The reference's NEE path weight PDF_inverse * BRDF (smallpt.cpp:471-472):
    PDF_inverse = |area * (d_hat . n_light)| / t^2,  BRDF = |d_hat . nl| / pi,
    where t is the traced distance to the light object."""
    area, n_light = light_area_normal(light)
    pdf_inv = jnp.abs(area * vm.dot(d_hat, n_light)) / (t * t)
    brdf = jnp.abs(vm.dot(d_hat, nl)) * (1.0 / math.pi)
    return pdf_inv * brdf


# ---------------------------------------------------------------------------
# Multi-emitter light-list selection (generalizing the reference's single
# explicit light, smallpt.cpp:363-369/467, to K parallelogram emitters —
# scene/types.LightList).
# ---------------------------------------------------------------------------


def light_select_probs(lights: LightList, emission: jnp.ndarray,
                       mode: str = "power") -> jnp.ndarray:
    """Discrete light-selection probabilities q (K,).

    mode="power": q_k proportional to area_k * luminance(emission_k) — the
    standard power heuristic (a bright/large light is proportionally more
    likely to matter). mode="uniform": q_k = 1/K.

    Probabilities are stop_gradient'ed: the 1/q_k importance weight keeps
    the ESTIMATOR unbiased for any fixed q, so q is a sampling-strategy
    constant, not a differentiable model parameter (differentiating through
    q would need a score-function term the pathwise pass does not carry).
    """
    k = lights.obj_id.shape[0]
    if mode == "uniform":
        return jnp.full((k,), 1.0 / k, jnp.float32)
    if mode != "power":
        raise ValueError(f"unknown light_select mode {mode!r}")
    area = vm.magnitude(vm.cross(lights.edge_u, lights.edge_v))
    if lights.kind is not None:
        # Sphere entries (LIGHT_SPHERE): surface area 4*pi*r^2 stands in
        # for the parallelogram area in the power heuristic.
        r_sph = lights.edge_u[:, 0]
        area = jnp.where(
            lights.kind == LIGHT_SPHERE,
            (4.0 * math.pi) * r_sph * r_sph,
            area,
        )
    e = emission[lights.obj_id]
    lum = e[:, 0] * 0.2126 + e[:, 1] * 0.7152 + e[:, 2] * 0.0722
    w = area * lum
    total = jnp.sum(w)
    # All-dark light list: fall back to uniform rather than 0/0.
    probs = jnp.where(total > 0.0, w / jnp.where(total > 0.0, total, 1.0),
                      1.0 / k)
    return jax.lax.stop_gradient(probs)


def sample_light_index(probs: jnp.ndarray, u: jnp.ndarray) -> jnp.ndarray:
    """Inverse-CDF draw of a light index: idx = #{k < K-1 : u >= cdf_k}.

    Branch-free over the (tiny) K axis — a (N, K-1) compare + sum, the
    vectorized form of std::upper_bound. Returns (N,) int32 in [0, K)."""
    cdf = jnp.cumsum(probs)
    return jnp.sum(
        (u[..., None] >= cdf[None, :-1]).astype(jnp.int32), axis=-1
    )


def gather_light(lights: LightList, idx: jnp.ndarray) -> LightSampler:
    """Per-lane single-light view of the list: a batched LightSampler whose
    leaves are gathered at ``idx`` ((N,3)/(N,) fields). Downstream samplers
    (sample_light_point, nee_weight) broadcast over the lane axis, so the
    chosen-light path is the single-light code unchanged."""
    return LightSampler(
        corner=lights.corner[idx],
        edge_u=lights.edge_u[idx],
        edge_v=lights.edge_v[idx],
        light_obj_id=lights.obj_id[idx],
    )


def gather_light_kind(lights: LightList, idx: jnp.ndarray):
    """Per-lane geometry kind of the gathered light ((N,) int32), or None
    for an all-parallelogram list (kind is None — the common case keeps
    its sphere-free code path)."""
    return None if lights.kind is None else lights.kind[idx]
