"""Edge-sampled boundary gradients for sphere geometry.

Pathwise AD through the wavefront (grad/adjoint.py) differentiates the
smooth integrand along FIXED paths and therefore misses the boundary term
of geometry parameters: translating or scaling a sphere moves its
silhouette across pixels, and that visibility discontinuity carries most
of the in-image-plane gradient (the same failure mode pinned for camera
translation in tests/test_grad.py; grad/score.py's docstring flags this as
the remaining "edge/boundary sampling" gap). The soft renderer
(grad/soft.py) works around it by blurring the image; this module
estimates the TRUE boundary term of the hard render instead.

Method (Reynolds transport / differentiable-rendering edge sampling a la
Li et al. 2018, specialized to spheres under the pinhole camera):

    I_p(theta) = (1/A) ∫_pixel L ds dt,   A = pixel area = 1/(w*h)
    dI_p/dtheta = interior (pathwise AD)
        + w*h * ∫_{silhouette ∩ pixel} (L_in - L_out) (V . n̂) dl

where V = dS/dtheta is the screen-space velocity of the silhouette point
and n̂ the outward (away-from-sphere) screen normal. A sphere's silhouette
is the analytic limb circle

    c_l = c - (r^2/D) d̂,  rho = r sqrt(1 - (r/D)^2),  d̂ = (c - o)/D,

so the curve is sampled EXACTLY (uniform in the limb angle phi) and every
screen quantity — position S(phi; theta), arc measure |dS/dphi|, velocity
dS/dtheta — comes out of jax.jacfwd through the projection chain; no
hand-derived Jacobians. L_in/L_out are path-traced estimates through film
points straddling the edge at +-delta_px with COMMON path ids, so where
another object occludes the limb both rays see the same first hit and the
contribution cancels exactly — occlusion needs no explicit test.

Everything is fixed-shape and batched over the phi samples: one
path_trace_fixed call of 2*n_phi*n_sub lanes — shaped like any other
wavefront launch.

Two boundary estimators live here:

- edge_grad — the PRIMARY-visibility silhouette term (limb as seen from
  the camera, jump path-traced through straddling film points).
- shadow_edge_grad — the CAST-SHADOW boundary of the textbook NEE direct
  term at primary diffuse vertices: from each shading point x the
  blocker's limb (w.r.t. origin x) projects to a curve on the light
  plane; the area-domain integrand f_A = T alb E |cos_l||cos_s|/(pi t^2)
  (sampling.nee_weight's integrand) jumps across it, and the same
  jacfwd-velocity + straddling-probe recipe applies, with the visibility
  jump estimated by two shadow probes (other occluders and the light
  rectangle's own theta-independent edge fall out automatically).

- indirect_edge_grad — the SECONDARY-vertex silhouette term for
  BSDF-transport estimators (cosine / uniform / uniform_corrected): from
  each primary diffuse vertex x the sphere's limb is a curve on the unit
  sphere of bounce directions omega(phi; theta) = normalize(q(phi) - x);
  the hemisphere integrand f = alb * w(omega) * L(x, omega) jumps across
  it (w = cos/pi for cosine-pdf estimators, 1/(2*pi) for the as-committed
  uniform C12), and the same jacfwd-velocity + straddling recipe applies
  with L_in/L_out path-traced through straddling DIRECTIONS at common
  path ids.

Remaining out of scope: silhouettes seen from depth>=2 vertices (the
indirect term stops at the first diffuse vertex; deeper terms decay with
the albedo product), and the NEE estimators' indirect term (their
BSDF-sampled continuation suppresses emitter hits differently —
grad/soft.py's softened visibility stays the approximate tool there).
On a direct-lighting scene (pathwise + edge_grad + shadow_edge_grad)
reproduces the full FD gradient, and on an emissive-sphere scene under
the cosine estimator (pathwise=0 + edge_grad + indirect_edge_grad) does
(tests/test_edge.py composition tests).

Validated (tests/test_edge.py): (1) the screen machinery against a
brute-force FD of the analytic coverage integral (1-3%); (2) the full
estimator against render FD on an emissive-sphere/black-box scene where
the image gradient IS the primary boundary term (pathwise ~ 0); (3) the
shadow term against render FD on a black-walls direct-lighting scene
where FD = primary edge + shadow edge exactly.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..core import vecmath as vm
from ..integrator.wavefront import path_trace_fixed
from ..scene.types import Scene


def project_film(cam: CameraParams, X: jnp.ndarray) -> jnp.ndarray:
    """World points (..., 3) -> film coords (s, t) (..., 2).

    Inverts the C5 ray relation X - o = lam * (ll - o + s*H + t*V): with
    M = [ll-o | H | V], M^-1 (X - o) = (lam, lam*s, lam*t); closed-form
    rows via cross products (same algebra as grad/warp._flow_jacobian)."""
    A = jnp.asarray(cam.lower_left, jnp.float32) - jnp.asarray(
        cam.origin, jnp.float32
    )
    H = jnp.asarray(cam.horizontal, jnp.float32)
    V = jnp.asarray(cam.vertical, jnp.float32)
    det = jnp.dot(A, jnp.cross(H, V), precision=vm.HIGHEST)
    r0 = jnp.cross(H, V) / det
    r1 = jnp.cross(V, A) / det
    r2 = jnp.cross(A, H) / det
    Xo = X - jnp.asarray(cam.origin, jnp.float32)
    y0 = jnp.dot(Xo, r0, precision=vm.HIGHEST)
    y1 = jnp.dot(Xo, r1, precision=vm.HIGHEST)
    y2 = jnp.dot(Xo, r2, precision=vm.HIGHEST)
    y0 = jnp.where(jnp.abs(y0) > 1e-9, y0, 1e-9)
    return jnp.stack([y1 / y0, y2 / y0], axis=-1)


def _limb_point(o_cam, center, radius, phi):
    """Silhouette (limb) point of the sphere seen from o_cam at angle phi
    around the view axis. Differentiable in (center, radius)."""
    dvec = center - o_cam
    D2 = jnp.dot(dvec, dvec, precision=vm.HIGHEST)
    D = jnp.sqrt(D2)
    dn = dvec / D
    # Guard D > r (camera outside the sphere); callers check visibility.
    rr = jnp.minimum(radius / D, 0.999)
    cl = center - (radius * rr) * dn
    rho = radius * jnp.sqrt(1.0 - rr * rr)
    e1, e2 = vm.onb_from_w(dn[None])
    e1, e2 = e1[0], e2[0]
    return cl + rho * (jnp.cos(phi) * e1 + jnp.sin(phi) * e2)


def _film_point(theta, phi, cam):
    """S(phi; theta) on film, theta = [cx, cy, cz, r]."""
    p = _limb_point(
        jnp.asarray(cam.origin, jnp.float32), theta[:3], theta[3], phi
    )
    return project_film(cam, p)


def silhouette_screen(cam: CameraParams, center, radius, n_phi: int):
    """Screen geometry of a sphere's silhouette at n_phi limb angles:
    (S (K,2) film position, J (K,2,4) dS/d[cx,cy,cz,r], n_hat (K,2)
    outward film normal, dl (K,) arc measure |dS/dphi|). All derivatives
    via jax.jacfwd through the limb+projection chain — no hand-derived
    Jacobians. Validated against a brute-force FD of the screen coverage
    integral in tests/test_edge.py."""
    theta = jnp.concatenate([center, radius[None]])
    phis = (jnp.arange(n_phi, dtype=jnp.float32) + 0.5) * (
        2.0 * jnp.pi / n_phi
    )
    S = jax.vmap(lambda p: _film_point(theta, p, cam))(phis)      # (K, 2)
    J = jax.vmap(lambda p: jax.jacfwd(_film_point)(theta, p, cam))(
        phis
    )                                                             # (K, 2, 4)
    tau = jax.vmap(
        lambda p: jax.jacfwd(_film_point, argnums=1)(theta, p, cam)
    )(phis)                                                       # (K, 2)
    dl = jnp.linalg.norm(tau, axis=-1)                            # (K,)
    t_hat = tau / jnp.maximum(dl, 1e-12)[:, None]
    n_hat = jnp.stack([t_hat[:, 1], -t_hat[:, 0]], axis=-1)
    Sc = project_film(cam, center)
    flip = jnp.sum(n_hat * (S - Sc), axis=-1) < 0.0
    n_hat = jnp.where(flip[:, None], -n_hat, n_hat)
    return S, J, n_hat, dl


@partial(jax.jit, static_argnums=(2, 4, 5, 6, 7))
def _edge_grad_impl(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                    g_img, sphere_idx: int, n_phi: int, n_sub: int,
                    n_bounces: int, seed, delta_px):
    w, h = cfg.width, cfg.height
    center = scene.spheres.center[sphere_idx]
    radius = scene.spheres.radius[sphere_idx]
    S, J, n_hat, dl = silhouette_screen(cam, center, radius, n_phi)

    # Pixel bin + loss cotangent at each edge sample (film -> C4 indices).
    px = jnp.floor(S[:, 0] * w + 0.5).astype(jnp.int32)
    row = jnp.floor(S[:, 1] * h + 0.5).astype(jnp.int32)
    py = h - 1 - row
    inside = (px >= 0) & (px < w) & (py >= 0) & (py < h)
    pxc = jnp.clip(px, 0, w - 1)
    pyc = jnp.clip(py, 0, h - 1)
    g = jnp.asarray(g_img, jnp.float32)[pyc, pxc]                 # (K, 3)
    g = g * inside[:, None].astype(jnp.float32)

    # L_in / L_out through straddling film points: offset delta_px PIXELS
    # along the pixel-metric edge normal (anisotropy-correct), mapped back
    # to film units. Common path ids across the pair (and across
    # sub-samples of a pair) => occluded arcs cancel exactly.
    n_pix = jnp.stack([n_hat[:, 0] * w, n_hat[:, 1] * h], axis=-1)
    n_pix = n_pix / jnp.maximum(
        jnp.linalg.norm(n_pix, axis=-1, keepdims=True), 1e-12
    )
    off = jnp.stack(
        [n_pix[:, 0] * (delta_px / w), n_pix[:, 1] * (delta_px / h)],
        axis=-1,
    )

    def rays_at(Spts):
        D = (
            jnp.asarray(cam.lower_left, jnp.float32)[None]
            + Spts[:, 0:1] * jnp.asarray(cam.horizontal, jnp.float32)[None]
            + Spts[:, 1:2] * jnp.asarray(cam.vertical, jnp.float32)[None]
            - jnp.asarray(cam.origin, jnp.float32)[None]
        )
        d = vm.norm(D)
        o = jnp.broadcast_to(
            jnp.asarray(cam.origin, jnp.float32)[None], d.shape
        )
        return o, d

    S_in = jnp.repeat(S - off, n_sub, axis=0)                 # (K*n_sub, 2)
    S_out = jnp.repeat(S + off, n_sub, axis=0)
    o_in, d_in = rays_at(S_in)
    o_out, d_out = rays_at(S_out)
    pid = jnp.arange(n_phi * n_sub, dtype=jnp.uint32)
    L_in, _ = path_trace_fixed(
        scene, cfg, jnp.uint32(seed), o_in, d_in, pid, n_bounces
    )
    L_out, _ = path_trace_fixed(
        scene, cfg, jnp.uint32(seed), o_out, d_out, pid, n_bounces
    )
    f_in = L_in.reshape(n_phi, n_sub, 3).mean(axis=1)
    f_out = L_out.reshape(n_phi, n_sub, 3).mean(axis=1)

    # d loss / d theta_j = sum_k  <g, f_in - f_out> (V_j . n̂) dl (2π/K) wh
    gdot = jnp.sum(g * (f_in - f_out), axis=-1)                   # (K,)
    v_n = jnp.einsum("kij,ki->kj", J, n_hat,
                     precision=vm.HIGHEST)                          # (K, 4)
    contrib = (gdot * dl)[:, None] * v_n
    d_theta = contrib.sum(axis=0) * (2.0 * jnp.pi / n_phi) * (w * h)
    return d_theta[:3], d_theta[3]


def edge_grad(scene: Scene, cam: CameraParams, cfg: RenderConfig,
              g_img, sphere_idx: int, seed=0, n_phi: int = 1024,
              n_sub: int = 4, n_bounces: int = 8,
              delta_px: float = 0.25):
    """Boundary term of d(loss)/d(sphere center, radius).

    g_img: loss cotangent d loss / d image, (h, w, 3) — same convention as
    grad/warp.camera_origin_warp_grad. Returns (d_center (3,), d_radius
    scalar). Add to the pathwise gradient (jax.grad of
    adjoint.render_linear) for the full geometry gradient; use a seed
    distinct from the render's to decorrelate the edge estimator."""
    return _edge_grad_impl(
        scene, cam, cfg, g_img, int(sphere_idx), int(n_phi), int(n_sub),
        int(n_bounces), seed, jnp.float32(delta_px),
    )


def _light_plane_hit(x, q, corner, n_l):
    """Intersection of the ray x->q with the light plane: y = x + t*(q-x),
    t = ((corner-x).n_l) / ((q-x).n_l). Returns (y (3,), t)."""
    dirv = q - x
    denom = jnp.dot(dirv, n_l, precision=vm.HIGHEST)
    denom = jnp.where(jnp.abs(denom) > 1e-9, denom, 1e-9)
    t = jnp.dot(corner - x, n_l, precision=vm.HIGHEST) / denom
    return x + t * dirv, t


def _shadow_curve_point(theta, phi, x, corner, n_l):
    """y(phi; theta): the blocker's limb point seen from shading point x,
    projected onto the light plane. The shadow boundary on the light."""
    q = _limb_point(x, theta[:3], theta[3], phi)
    y, _ = _light_plane_hit(x, q, corner, n_l)
    return y


@partial(jax.jit, static_argnums=(2, 4, 5, 8))
def _shadow_edge_impl(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                      g_img, sphere_idx: int, n_phi: int, seed, delta,
                      light_idx: int = -1):
    from ..core import rng
    from ..geometry.intersect import shade_info, trace
    from ..integrator.sampling import (
        SHADOW_EPS, gather_light, light_area_normal,
    )
    from ..scene.types import DIFF, object_arrays

    w, h = cfg.width, cfg.height
    # light_idx < 0: the single scene.light; >= 0: one member of the
    # multi-emitter list (the caller sums the per-light curve integrals —
    # the list estimator is unbiased for the SUM of per-light direct
    # terms, so its boundary term is the sum of per-light boundaries).
    from ..scene.types import SphereLight

    if isinstance(scene.light, SphereLight) or (
        scene.lights is not None and scene.lights.kind is not None
    ):
        raise NotImplementedError(
            "edge-sampled shadow boundary terms are built for "
            "parallelogram lights; the sphere-light silhouette integral "
            "is a documented waiver (COVERAGE.md) — interior gradients "
            "flow through jax.grad of the jnp wavefront"
        )
    if light_idx < 0:
        light = scene.light
    else:
        light = gather_light(scene.lights, jnp.int32(light_idx))
    area, n_l = light_area_normal(light)
    corner = jnp.asarray(light.corner, jnp.float32)
    eu = jnp.asarray(light.edge_u, jnp.float32)
    ev = jnp.asarray(light.edge_v, jnp.float32)
    light_oid = jnp.asarray(light.light_obj_id, jnp.int32)
    _, emission_all, _ = object_arrays(scene)
    e_light = emission_all[light_oid]

    center = scene.spheres.center[sphere_idx]
    radius = scene.spheres.radius[sphere_idx]
    theta = jnp.concatenate([center, radius[None]])

    # Shading points: one JITTERED primary hit per (pixel, phi) lane.
    # The pixel value is an integral over the pixel footprint; the
    # shadow-curve geometry varies across it, so a pixel-center shading
    # point biases the estimate (measured ~25% on the x component of the
    # composition test). Jittering x per lane makes the estimator
    # unbiased over the pixel integral as well.
    lane = jnp.arange(w * h * n_phi, dtype=jnp.uint32)
    pix = lane // jnp.uint32(n_phi)
    pxi = (pix % jnp.uint32(w)).astype(jnp.int32)
    pyi = (pix // jnp.uint32(w)).astype(jnp.int32)
    from ..camera.pinhole import primary_rays
    uniform = rng.make_uniform_fn("mix")
    ux = uniform(jnp.uint32(seed), lane, jnp.uint32(1))
    uy = uniform(jnp.uint32(seed), lane, jnp.uint32(2))
    o_r, d_r = primary_rays(cam, w, h, pxi, pyi, ux, uy)
    hit = trace(scene, o_r, d_r)
    sh = shade_info(scene, o_r, d_r, hit)
    xf = sh.x                                                   # (N*K, 3)
    dvec = xf - center[None]
    outside = jnp.linalg.norm(dvec, axis=-1) > radius * 1.001
    # The number of sphere objects precedes nothing: blocker's global id.
    n_rects = scene.rects.albedo.shape[0]
    n_quads = scene.quads.albedo.shape[0]
    blocker_oid = jnp.int32(n_rects + n_quads + sphere_idx)
    valid_x = (
        hit.hit & (sh.refl == DIFF) & (hit.obj_id != blocker_oid)
        & (hit.obj_id != light_oid) & outside
    )

    # Stratified limb angles with a per-pixel counter-RNG rotation.
    u_rot = uniform(jnp.uint32(seed), pix, jnp.uint32(0))       # (N*K,)
    js = (lane % jnp.uint32(n_phi)).astype(jnp.float32)
    pf = (js + u_rot) * jnp.float32(2.0 * jnp.pi / n_phi)       # (N*K,)

    def y_of(theta_, phi_, x_):
        return _shadow_curve_point(theta_, phi_, x_, corner, n_l)

    y = jax.vmap(lambda p_, x_: y_of(theta, p_, x_))(pf, xf)    # (N*K, 3)
    Jy = jax.vmap(lambda p_, x_: jax.jacfwd(y_of)(theta, p_, x_))(
        pf, xf
    )                                                           # (N*K, 3, 4)
    ty = jax.vmap(
        lambda p_, x_: jax.jacfwd(y_of, argnums=1)(theta, p_, x_)
    )(pf, xf)                                                   # (N*K, 3)
    dl = jnp.linalg.norm(ty, axis=-1)
    t_hat = ty / jnp.maximum(dl, 1e-12)[:, None]

    # Occluder must sit between x and the light plane: the limb point is
    # at ray parameter 1, the plane at t_plane — require t_plane > 1.
    _, t_plane = jax.vmap(
        lambda p_, x_: _light_plane_hit(
            x_, _limb_point(x_, theta[:3], theta[3], p_), corner, n_l
        )
    )(pf, xf)
    between = t_plane > 1.0

    # Inside the light parallelogram (general Gram solve).
    wvec = y - corner[None]
    a11 = jnp.dot(eu, eu, precision=vm.HIGHEST)
    a12 = jnp.dot(eu, ev, precision=vm.HIGHEST)
    a22 = jnp.dot(ev, ev, precision=vm.HIGHEST)
    det = a11 * a22 - a12 * a12
    b1 = jnp.dot(wvec, eu, precision=vm.HIGHEST)
    b2 = jnp.dot(wvec, ev, precision=vm.HIGHEST)
    ua = (a22 * b1 - a12 * b2) / det
    ub = (a11 * b2 - a12 * b1) / det
    on_light = (ua > 0.0) & (ua < 1.0) & (ub > 0.0) & (ub < 1.0)

    # In-plane outward (away-from-shadow) normal: away from the projected
    # blocker-center point; orthogonalize against the tangent.
    yc = jax.vmap(
        lambda x_: _light_plane_hit(x_, center, corner, n_l)[0]
    )(xf)
    n_raw = y - yc
    n_raw = n_raw - jnp.sum(n_raw * t_hat, axis=-1, keepdims=True) * t_hat
    n_hat = n_raw / jnp.maximum(
        jnp.linalg.norm(n_raw, axis=-1, keepdims=True), 1e-12
    )

    # Visibility jump across the curve via two straddling shadow probes
    # from the lifted shading point (common origin; other occluders and
    # double-blocked arcs cancel to 0).
    nf = sh.n
    albf = sh.albedo
    po = xf + SHADOW_EPS * nf
    y_out = y + delta * n_hat
    y_in = y - delta * n_hat

    def probe_reaches(yp):
        d_l = vm.norm(yp - po)
        pr = trace(scene, po, d_l)
        return pr.hit & (pr.obj_id == light_oid)

    v_out = probe_reaches(y_out)
    v_in = probe_reaches(y_in)
    vjump = v_out.astype(jnp.float32) - v_in.astype(jnp.float32)

    # Area-domain direct integrand at the curve (textbook NEE term at a
    # primary vertex: T=1, pre-RR): f_A = alb*E*|cos_l||cos_s|/(pi t^2).
    # t2 hits exactly 0 on lanes whose shading point lies ON the light
    # plane (light-pixel hits: y = x). Those lanes are masked out below,
    # but NaN * 0 = NaN — divide by the guarded t2 instead (d_l -> 0,
    # f_A -> 0 on those lanes).
    seg = y - xf
    t2 = jnp.maximum(jnp.sum(seg * seg, axis=-1), 1e-12)
    d_l = seg / jnp.sqrt(t2)[:, None]
    cos_l = jnp.abs(jnp.dot(d_l, n_l, precision=vm.HIGHEST))
    cos_s = jnp.abs(jnp.sum(d_l * nf, axis=-1))
    f_A = albf * e_light[None] * (
        cos_l * cos_s / (jnp.float32(jnp.pi) * t2)
    )[:, None]                                                  # (N*K, 3)

    g = jnp.asarray(g_img, jnp.float32).reshape(w * h, 3)
    gf = g[pix.astype(jnp.int32)]
    gdot = jnp.sum(gf * f_A, axis=-1)

    mask = (valid_x & between & on_light).astype(jnp.float32)

    # dI/dtheta = -∮ f_A (V . n̂_out-of-shadow) dl  (Reynolds over the
    # shadowed subset of the light); vjump replaces the analytic jump
    # sign/existence.
    v_n = jnp.einsum("kij,ki->kj", Jy, n_hat,
                     precision=vm.HIGHEST)                        # (N*K, 4)
    contrib = (mask * vjump * gdot * dl)[:, None] * v_n
    d_theta = -contrib.sum(axis=0) * (2.0 * jnp.pi / n_phi)
    return d_theta[:3], d_theta[3]


def shadow_edge_grad(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                     g_img, sphere_idx: int, seed=0, n_phi: int = 8,
                     delta: float = 0.5):
    """Cast-shadow boundary term of d(loss)/d(sphere center, radius) for
    the textbook-NEE direct lighting of primary diffuse vertices.

    g_img: d loss / d image (h, w, 3). delta: straddle distance on the
    light plane in WORLD units (the probes must clear the blocker's f32
    grazing band; 0.5 on the 100-unit box). One curve sample costs two
    shadow probes, all pixels batched. Multi-emitter scenes
    (scene.lights) sum one curve integral per listed light — the list
    estimator is unbiased for the sum of per-light direct terms, so the
    boundary term sums too. Add to pathwise + edge_grad for the full
    gradient of direct-lighting scenes (module docstring scope)."""
    if scene.lights is None:
        return _shadow_edge_impl(
            scene, cam, cfg, g_img, int(sphere_idx), int(n_phi), seed,
            jnp.float32(delta), -1,
        )
    d_c = jnp.zeros(3, jnp.float32)
    d_r = jnp.float32(0.0)
    for k in range(scene.lights.corner.shape[0]):
        dc_k, dr_k = _shadow_edge_impl(
            scene, cam, cfg, g_img, int(sphere_idx), int(n_phi), seed,
            jnp.float32(delta), k,
        )
        d_c = d_c + dc_k
        d_r = d_r + dr_k
    return d_c, d_r


def _omega_of(theta, phi, x):
    """Bounce DIRECTION to the blocker's limb point seen from shading
    point x: the silhouette curve on the unit sphere of directions."""
    q = _limb_point(x, theta[:3], theta[3], phi)
    return vm.norm((q - x)[None])[0]


@partial(jax.jit, static_argnums=(2, 4, 5, 6, 9))
def _indirect_edge_impl(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                        g_img, sphere_idx: int, n_phi: int,
                        n_bounces: int, seed, delta, depths=(1,)):
    from ..core import rng
    from ..geometry.intersect import shade_info, trace
    from ..integrator.sampling import (
        SHADOW_EPS, sample_cosine, sample_uniform,
    )
    from ..scene.types import DIFF

    w, h = cfg.width, cfg.height
    center = scene.spheres.center[sphere_idx]
    radius = scene.spheres.radius[sphere_idx]
    theta = jnp.concatenate([center, radius[None]])

    # One JITTERED primary hit per (pixel, phi) lane — the pixel integral
    # over the footprint, same estimator layout as _shadow_edge_impl.
    lane = jnp.arange(w * h * n_phi, dtype=jnp.uint32)
    pix = lane // jnp.uint32(n_phi)
    pxi = (pix % jnp.uint32(w)).astype(jnp.int32)
    pyi = (pix // jnp.uint32(w)).astype(jnp.int32)
    from ..camera.pinhole import primary_rays
    uniform = rng.make_uniform_fn("mix")
    ux = uniform(jnp.uint32(seed), lane, jnp.uint32(1))
    uy = uniform(jnp.uint32(seed), lane, jnp.uint32(2))
    o_r, d_r = primary_rays(cam, w, h, pxi, pyi, ux, uy)
    hit = trace(scene, o_r, d_r)
    sh = shade_info(scene, o_r, d_r, hit)

    n_rects = scene.rects.albedo.shape[0]
    n_quads = scene.quads.albedo.shape[0]
    blocker_oid = jnp.int32(n_rects + n_quads + sphere_idx)
    g = jnp.asarray(g_img, jnp.float32).reshape(w * h, 3)
    gf = g[pix.astype(jnp.int32)]
    js = (lane % jnp.uint32(n_phi)).astype(jnp.float32)

    def curve_term(xf, n_l, albedo, T, depth):
        """Boundary integral of the bounce-direction estimator at the
        vertices xf (oriented normal n_l, local albedo), weighted by the
        prefix path throughput T. Returns (N*K, 4) cotangent rows."""
        # Stratified limb angles, per-(pixel, depth) counter-RNG rotation
        # (stream 0 at depth 1 — the original single-depth stream).
        u_rot = uniform(
            jnp.uint32(seed), pix,
            jnp.uint32(0 if depth == 1 else 32 + depth),
        )
        pf = (js + u_rot) * jnp.float32(2.0 * jnp.pi / n_phi)   # (N*K,)

        omega = jax.vmap(lambda p_, x_: _omega_of(theta, p_, x_))(pf, xf)
        Jw = jax.vmap(
            lambda p_, x_: jax.jacfwd(_omega_of)(theta, p_, x_)
        )(pf, xf)                                               # (N*K, 3, 4)
        tw = jax.vmap(
            lambda p_, x_: jax.jacfwd(_omega_of, argnums=1)(theta, p_, x_)
        )(pf, xf)                                               # (N*K, 3)
        dl = jnp.linalg.norm(tw, axis=-1)
        t_hat = tw / jnp.maximum(dl, 1e-12)[:, None]

        # In-tangent-plane outward normal: |omega|=1 makes d(omega)
        # tangent automatically; the sphere's direction region is
        # centered on d_c = normalize(center - x), so outward =
        # -(tangent-plane projection of d_c), orthogonalized against the
        # curve tangent.
        d_c = vm.norm(center[None] - xf)
        proj = d_c - jnp.sum(d_c * omega, axis=-1, keepdims=True) * omega
        proj = proj - jnp.sum(
            proj * t_hat, axis=-1, keepdims=True
        ) * t_hat
        n_hat = -proj / jnp.maximum(
            jnp.linalg.norm(proj, axis=-1, keepdims=True), 1e-12
        )

        # Straddling directions: delta WORLD units at the limb distance
        # (matches shadow_edge_grad's world-unit straddle; must clear the
        # f32 grazing band on the in-side).
        q = jax.vmap(
            lambda p_, x_: _limb_point(x_, theta[:3], theta[3], p_)
        )(pf, xf)
        dist_l = jnp.maximum(jnp.linalg.norm(q - xf, axis=-1), 1e-6)
        d_ang = (delta / dist_l)[:, None]
        d_out = vm.norm(omega + d_ang * n_hat)
        d_in = vm.norm(omega - d_ang * n_hat)

        # L_in / L_out: full-estimator radiance from the lifted vertex
        # along the straddling directions, common path ids => occluded
        # arcs cancel. (Depth caveat: the continuation restarts its RR
        # depth counter at 1 where the true estimator would be deeper —
        # a divergence only past depth 5, geometrically suppressed by the
        # albedo product.)
        po = xf + SHADOW_EPS * n_l
        lane_d = lane + jnp.uint32((depth - 1) * w * h * n_phi)
        L_in, _ = path_trace_fixed(
            scene, cfg, jnp.uint32(seed), po, d_in, lane_d, n_bounces
        )
        L_out, _ = path_trace_fixed(
            scene, cfg, jnp.uint32(seed), po, d_out, lane_d, n_bounces
        )

        # Hemisphere integrand weight at the curve (estimator-exact):
        # cosine / uniform_corrected sample+weight to alb*(cos/pi)*L;
        # the as-committed uniform (C12) to alb*L/(2*pi).
        cos_s = jnp.maximum(jnp.sum(omega * n_l, axis=-1), 0.0)
        if cfg.estimator == "uniform":
            w_ang = jnp.full_like(cos_s, 1.0 / (2.0 * jnp.pi))
        else:
            w_ang = cos_s / jnp.float32(jnp.pi)
        f_jump = (T * albedo) * (w_ang[:, None] * (L_in - L_out))
        gdot = jnp.sum(gf * f_jump, axis=-1)
        v_n = jnp.einsum("kij,ki->kj", Jw, n_hat,
                         precision=vm.HIGHEST)                    # (N*K, 4)
        return (gdot * dl)[:, None] * v_n

    # Walk the prefix path depth by depth (static unroll). T carries the
    # estimator-exact prefix weight: each sampled DIFF bounce contributes
    # alb (cosine / as-committed uniform — the pdf cancels the transport
    # kernel) or alb*2*cos (uniform_corrected: cos/pi integrand over a
    # 1/(2*pi) pdf); non-DIFF or missed prefixes zero out.
    d_theta = jnp.zeros(4, jnp.float32)
    T = jnp.ones((lane.shape[0], 3), jnp.float32)
    for depth in range(1, max(depths) + 1):
        if depth > 1:
            nl = sh.n
            u1 = uniform(jnp.uint32(seed), lane, jnp.uint32(2 * depth + 14))
            u2 = uniform(jnp.uint32(seed), lane, jnp.uint32(2 * depth + 15))
            if cfg.estimator == "cosine":
                nd = sample_cosine(nl, u1, u2)
                wgt = sh.albedo
            else:
                nd = sample_uniform(nl, u1, u2)
                if cfg.estimator == "uniform":
                    wgt = sh.albedo
                else:  # uniform_corrected
                    cos_b = jnp.maximum(jnp.sum(nd * nl, axis=-1), 0.0)
                    wgt = sh.albedo * (2.0 * cos_b)[:, None]
            alive = (hit.hit & (sh.refl == DIFF)).astype(jnp.float32)
            T = T * wgt * alive[:, None]
            po = sh.x + SHADOW_EPS * nl
            o_r, d_r = po, nd
            hit = trace(scene, o_r, d_r)
            sh = shade_info(scene, o_r, d_r, hit)
        if depth not in depths:
            continue
        xf = sh.x                                               # (N*K, 3)
        dvec = xf - center[None]
        outside = jnp.linalg.norm(dvec, axis=-1) > radius * 1.001
        valid_x = (
            hit.hit & (sh.refl == DIFF) & (hit.obj_id != blocker_oid)
            & outside
        )
        contrib = curve_term(
            xf, sh.n, sh.albedo, T * valid_x[:, None].astype(jnp.float32),
            depth,
        )
        d_theta = d_theta + contrib.sum(axis=0) * (2.0 * jnp.pi / n_phi)
    return d_theta[:3], d_theta[3]


def indirect_edge_grad(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                       g_img, sphere_idx: int, seed=0, n_phi: int = 8,
                       n_bounces: int = 4, delta: float = 0.5,
                       depths=(1,)):
    """Deep-vertex silhouette boundary term of d(loss)/d(sphere center,
    radius): the blocker's limb as seen from each path vertex at the
    requested depths (1 = the primary hit), crossing the bounce-direction
    integral of BSDF-transport estimators (cosine / uniform /
    uniform_corrected). Vertices past depth 1 are reached by sampling the
    estimator's own DIFF bounce chain with the counter RNG; the prefix
    weight is estimator-exact (alb per bounce for cosine / as-committed
    uniform, alb*2*cos for uniform_corrected), so each depth's term is an
    unbiased estimate of that depth's boundary integral — no Russian
    roulette is needed in the prefix because the EXPECTED render the loss
    differentiates is RR-free.

    g_img: d loss / d image (h, w, 3). delta: straddle distance in WORLD
    units at the limb (same convention as shadow_edge_grad). One curve
    sample costs two fixed-length path traces per requested depth; all
    pixels batched. depths: tuple of vertex depths to include, e.g.
    (1, 2) adds the one-bounce-indirect silhouette term. NEE estimators
    are rejected — their BSDF continuation suppresses emitter hits
    differently (module docstring scope). Non-DIFF prefix vertices
    terminate the chain (SPEC/REFR continuation is out of scope)."""
    if cfg.estimator not in ("cosine", "uniform", "uniform_corrected"):
        raise ValueError(
            "indirect_edge_grad models BSDF-transport estimators "
            "(cosine/uniform/uniform_corrected); got "
            f"{cfg.estimator!r}"
        )
    depths = tuple(sorted(set(int(d) for d in depths)))
    if not depths or depths[0] < 1:
        raise ValueError(f"depths must be >= 1, got {depths}")
    return _indirect_edge_impl(
        scene, cam, cfg, g_img, int(sphere_idx), int(n_phi),
        int(n_bounces), seed, jnp.float32(delta), depths,
    )


@partial(jax.jit, static_argnums=(2, 5, 6))
def _mse_pathwise(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                  seed, target, sphere_idx: int, n_bounces: int):
    """MSE loss + pathwise (interior) gradient w.r.t. sphere
    (center, radius), jit-cached across fit steps."""
    from .adjoint import render_linear

    center0 = scene.spheres.center[sphere_idx]
    radius0 = scene.spheres.radius[sphere_idx]

    def loss_fn(center, radius):
        s2 = scene._replace(spheres=scene.spheres._replace(
            center=scene.spheres.center.at[sphere_idx].set(center),
            radius=scene.spheres.radius.at[sphere_idx].set(radius),
        ))
        img = render_linear(s2, cam, cfg, seed, n_bounces)
        return jnp.mean((img - target) ** 2), img

    (loss, img), (d_c, d_r) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True
    )(center0, radius0)
    return loss, img, d_c, d_r


def geometry_loss_and_grad(scene: Scene, cam: CameraParams,
                           cfg: RenderConfig, seed, target,
                           sphere_idx: int, n_bounces: int = 8,
                           edge_seed=None, n_phi: int = 1024,
                           n_sub: int = 2, delta_px: float = 0.25,
                           shadow=None, shadow_n_phi: int = 32,
                           shadow_delta: float = 0.25,
                           indirect=None, indirect_n_phi: int = 8,
                           indirect_depths=(1,)):
    """Full MSE-loss gradient w.r.t. one sphere's (center, radius):
    pathwise interior term (jax.grad through adjoint.render_linear) +
    primary-silhouette boundary (edge_grad) + the estimator's secondary
    boundary — cast-shadow (shadow_edge_grad) for textbook NEE, or the
    secondary-vertex silhouette (indirect_edge_grad) for BSDF-transport
    estimators.

    loss = mean((render_linear - target)^2), target linear (h, w, 3).
    Returns (loss, (d_center (3,), d_radius scalar)).

    shadow=None / indirect=None auto-enable each term exactly in the
    regime it models (shadow: estimator 'nee_textbook', single- or
    multi-emitter; indirect: estimator cosine/uniform/uniform_corrected);
    pass
    True/False to force. indirect_depths extends the indirect term to
    deeper path vertices (e.g. (1, 2) adds the one-bounce-indirect
    silhouette — see indirect_edge_grad). edge_seed defaults to seed+1
    to decorrelate the boundary estimators from the render's sample
    stream.
    """
    from .adjoint import render_linear

    if edge_seed is None:
        edge_seed = int(seed) + 1
    if shadow is None:
        shadow = cfg.estimator == "nee_textbook"
    if indirect is None:
        indirect = cfg.estimator in (
            "cosine", "uniform", "uniform_corrected"
        )

    loss, img, d_c, d_r = _mse_pathwise(
        scene, cam, cfg, jnp.uint32(seed), target, int(sphere_idx),
        int(n_bounces),
    )

    # Loss cotangent for the boundary estimators: d loss / d image.
    g_img = 2.0 * (img - target) / jnp.float32(img.size)

    dc_e, dr_e = edge_grad(
        scene, cam, cfg, g_img, sphere_idx, seed=edge_seed, n_phi=n_phi,
        n_sub=n_sub, n_bounces=n_bounces, delta_px=delta_px,
    )
    d_c = d_c + dc_e
    d_r = d_r + dr_e
    if shadow:
        dc_s, dr_s = shadow_edge_grad(
            scene, cam, cfg, g_img, sphere_idx, seed=edge_seed,
            n_phi=shadow_n_phi, delta=shadow_delta,
        )
        d_c = d_c + dc_s
        d_r = d_r + dr_s
    if indirect:
        dc_i, dr_i = indirect_edge_grad(
            scene, cam, cfg, g_img, sphere_idx, seed=edge_seed,
            n_phi=indirect_n_phi, n_bounces=n_bounces,
            depths=indirect_depths,
        )
        d_c = d_c + dc_i
        d_r = d_r + dr_i
    return loss, (d_c, d_r)
