"""Exact camera-translation boundary gradients by scene-edge sampling.

Pathwise AD through the wavefront is pinned blind to camera translation
(tests/test_grad.py: FD ~ 13 vs AD ~ -0.04 on the box scene): translating
the camera advects every object edge across the film, and that visibility
discontinuity carries essentially the whole gradient. grad/warp.py models
it with a first-order parallax-flow approximation; this module estimates
the TRUE boundary term of the hard render, the same Reynolds-transport
recipe as grad/edge.py but with velocities taken w.r.t. the camera:

    dI_p/dt = interior (pathwise AD)
        + w*h * sum_curves ∫_{curve ∩ pixel} (L_- - L_+) (dS/dt . n̂) dl

The discontinuity set of this scene family is ANALYTIC: the 4 border
segments of every axis-rect / quad (shared box edges deduped — each
geometric curve must be counted once) and each sphere's limb circle
(which itself moves with the camera: the limb point and the projection
both depend on the origin, and jax.jacfwd differentiates through the
whole chain). A pure camera translation shifts ``origin`` and
``lower_left`` together, so the film-basis vectors are unchanged and the
projection of a world point X is a function of X - origin - t only.

L_- / L_+ are path-traced through film points straddling the projected
curve at +-delta_px pixels with COMMON path ids, so occluded curve arcs
and concave creases whose radiance happens to be continuous cancel to
(near) zero automatically — no visibility classification is needed, and
the straddle-pair estimate captures whatever jump actually exists
(silhouette against background, shading-normal crease, shadow boundary
crossing the edge). The (L_- - L_+)(V . n̂) product is invariant under
n̂ -> -n̂, so curve orientation needs no bookkeeping either.

Scope: d(loss)/d(camera translation) (3,) via ``camera_edge_grad`` and
d(loss)/d(camera rotation) (3, axis-angle about the origin) via
``camera_rotation_edge_grad``. Rotation reuses the same machinery
through an equivalence: rotating the camera basis by R(w) leaves the
inverse-projection rows r_i -> R r_i, so film coords become
dot(R^T (X-origin), r_i)/dot(R^T (X-origin), r_0) — i.e. rotating the
camera by +w is projecting world points rotated by R^T about the
origin, to first order X -> X - w x (X - origin). The discontinuity
curves themselves are rotation-invariant (the sphere limb depends on
the origin only), so only the velocity chain differs. (The reference's
camera is fixed: /root/reference/src/smallpt.cpp:65,521.)

Validated (tests/test_camera_edge.py): pathwise + this term reproduces
the render FD of camera translation (and rotation) on the box scene
where pathwise alone is pinned ~300x too small.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..core import vecmath as vm
from ..integrator.wavefront import path_trace_fixed
from ..scene.types import Scene
from .edge import _limb_point


def scene_edge_segments(scene: Scene):
    """Deduped world-space boundary segments (A (M,3), B (M,3)) of every
    rect and quad. Edges shared by two faces (the boxes' creases, the
    room's wall-floor junctions) appear ONCE — each geometric
    discontinuity curve gets exactly one curve integral."""
    segs = {}

    def add(p, q):
        a = tuple(np.round(np.asarray(p, np.float64), 5))
        b = tuple(np.round(np.asarray(q, np.float64), 5))
        key = (a, b) if a <= b else (b, a)
        segs[key] = (
            np.asarray(p, np.float32), np.asarray(q, np.float32)
        )

    rects = scene.rects
    axis = np.asarray(rects.axis)
    k = np.asarray(rects.k)
    lo = np.asarray(rects.lo)
    hi = np.asarray(rects.hi)
    for i in range(axis.shape[0]):
        a = int(axis[i])
        o1, o2 = [d for d in range(3) if d != a]
        corners = []
        for (u, v) in (
            (lo[i, 0], lo[i, 1]), (hi[i, 0], lo[i, 1]),
            (hi[i, 0], hi[i, 1]), (lo[i, 0], hi[i, 1]),
        ):
            p = np.zeros(3)
            p[a] = k[i]
            p[o1] = u
            p[o2] = v
            corners.append(p)
        for j in range(4):
            add(corners[j], corners[(j + 1) % 4])
    if scene.quads is not None and np.asarray(scene.quads.corner).size:
        qc = np.asarray(scene.quads.corner)
        eu = np.asarray(scene.quads.edge_u)
        ev = np.asarray(scene.quads.edge_v)
        for i in range(qc.shape[0]):
            c0, c1 = qc[i], qc[i] + eu[i]
            c2, c3 = qc[i] + eu[i] + ev[i], qc[i] + ev[i]
            for pq in ((c0, c1), (c1, c2), (c2, c3), (c3, c0)):
                add(*pq)
    A = np.stack([v[0] for v in segs.values()])
    B = np.stack([v[1] for v in segs.values()])
    return A, B


def _proj_rows(cam: CameraParams):
    """Inverse-projection rows (same algebra as edge.project_film) — the
    film basis A=ll-o, H, V is translation-invariant."""
    A = jnp.asarray(cam.lower_left, jnp.float32) - jnp.asarray(
        cam.origin, jnp.float32
    )
    H = jnp.asarray(cam.horizontal, jnp.float32)
    V = jnp.asarray(cam.vertical, jnp.float32)
    det = jnp.dot(A, jnp.cross(H, V), precision=vm.HIGHEST)
    return (
        jnp.cross(H, V) / det, jnp.cross(V, A) / det, jnp.cross(A, H) / det,
    )


def _film_shifted(rows, origin, t, X):
    """Film coords (s, t_film) of world point X under camera translation
    t, plus the projective depth y0 (<=0 means at/behind the camera)."""
    r0, r1, r2 = rows
    Xo = X - origin - t
    y0 = jnp.dot(Xo, r0, precision=vm.HIGHEST)
    y0g = jnp.where(jnp.abs(y0) > 1e-9, y0, 1e-9)
    return jnp.stack([jnp.dot(Xo, r1, precision=vm.HIGHEST) / y0g,
                      jnp.dot(Xo, r2, precision=vm.HIGHEST) / y0g]), y0


def _accumulate(cam, cfg, scene, g, S, J, tau, y0, measure, seed, lane0,
                n_sub, n_bounces, delta_px):
    """Shared tail of the segment / limb estimators: pixel lookup,
    pixel-metric straddle, path-traced jump, Reynolds contraction.
    measure: per-lane curve measure (dl * du-weight). Returns (3,)."""
    w, h = cfg.width, cfg.height
    n = S.shape[0]
    dl = jnp.linalg.norm(tau, axis=-1)
    t_hat = tau / jnp.maximum(dl, 1e-12)[:, None]
    n_hat = jnp.stack([t_hat[:, 1], -t_hat[:, 0]], axis=-1)

    px = jnp.floor(S[:, 0] * w + 0.5).astype(jnp.int32)
    row = jnp.floor(S[:, 1] * h + 0.5).astype(jnp.int32)
    py = h - 1 - row
    inside = (
        (px >= 0) & (px < w) & (py >= 0) & (py < h) & (y0 > 1e-4)
    )
    gk = jnp.asarray(g, jnp.float32)[
        jnp.clip(py, 0, h - 1), jnp.clip(px, 0, w - 1)
    ]
    gk = gk * inside[:, None].astype(jnp.float32)

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

    S_m = jnp.repeat(S - off, n_sub, axis=0)
    S_p = jnp.repeat(S + off, n_sub, axis=0)
    o_m, d_m = rays_at(S_m)
    o_p, d_p = rays_at(S_p)
    pid = lane0 + jnp.arange(n * n_sub, dtype=jnp.uint32)
    L_m, _ = path_trace_fixed(
        scene, cfg, jnp.uint32(seed), o_m, d_m, pid, n_bounces
    )
    L_p, _ = path_trace_fixed(
        scene, cfg, jnp.uint32(seed), o_p, d_p, pid, n_bounces
    )
    f_m = L_m.reshape(n, n_sub, 3).mean(axis=1)
    f_p = L_p.reshape(n, n_sub, 3).mean(axis=1)

    gdot = jnp.sum(gk * (f_m - f_p), axis=-1)
    v_n = jnp.einsum("kij,ki->kj", J, n_hat,
                     precision=vm.HIGHEST)                        # (n, 3)
    return (gdot * measure)[:, None] * v_n


def rotate_camera(cam: CameraParams, omega) -> CameraParams:
    """CameraParams rotated by the axis-angle vector omega (radians)
    about the camera origin: origin fixed; the film basis A=ll-o, H, V
    all rotate by R(omega) (exact Rodrigues, series-safe at 0 so
    jax.grad through it is exact). Used for the interior (pathwise)
    term and for FD probes of the rotation gradient."""
    w = jnp.asarray(omega, jnp.float32)
    t2 = jnp.dot(w, w, precision=vm.HIGHEST)
    small = t2 < 1e-12
    t2s = jnp.where(small, 1.0, t2)
    th = jnp.sqrt(t2s)
    a = jnp.where(small, 1.0 - t2 / 6.0, jnp.sin(th) / th)
    b = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(th)) / t2s)
    K = jnp.array([
        [0.0, -w[2], w[1]],
        [w[2], 0.0, -w[0]],
        [-w[1], w[0], 0.0],
    ], jnp.float32)
    R = jnp.eye(3, dtype=jnp.float32) + a * K + b * jnp.matmul(
        K, K, precision=vm.HIGHEST)
    o = jnp.asarray(cam.origin, jnp.float32)
    A = jnp.asarray(cam.lower_left, jnp.float32) - o
    return cam._replace(
        origin=o,
        lower_left=o + jnp.matmul(R, A, precision=vm.HIGHEST),
        horizontal=jnp.matmul(R, jnp.asarray(cam.horizontal, jnp.float32),
                              precision=vm.HIGHEST),
        vertical=jnp.matmul(R, jnp.asarray(cam.vertical, jnp.float32),
                            precision=vm.HIGHEST),
    )


@partial(jax.jit, static_argnums=(2, 4, 5, 6, 7, 12))
def _camera_edge_impl(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                      g_img, n_u: int, n_phi: int, n_sub: int,
                      n_bounces: int, seed, delta_px, segA, segB,
                      mode: str = "translate"):
    from ..core import rng

    w, h = cfg.width, cfg.height
    rows = _proj_rows(cam)
    origin = jnp.asarray(cam.origin, jnp.float32)
    uniform = rng.make_uniform_fn("mix")
    t0 = jnp.zeros(3, jnp.float32)

    def film_of(t, X):
        """Film coords of world point X under the camera perturbation t:
        translation shifts the origin; rotation by +t is equivalent to
        projecting X - t x (X - origin) with the unrotated camera
        (module docstring), exact to first order at t=0 — all that
        jacfwd at t0=0 reads."""
        if mode == "rotate":
            return _film_shifted(
                rows, origin, t0, X - jnp.cross(t, X - origin)
            )
        return _film_shifted(rows, origin, t, X)

    # --- rect/quad border segments -------------------------------------
    M = segA.shape[0]
    lane = jnp.arange(M * n_u, dtype=jnp.uint32)
    seg_i = lane // jnp.uint32(n_u)
    ju = (lane % jnp.uint32(n_u)).astype(jnp.float32)
    uj = uniform(jnp.uint32(seed), lane, jnp.uint32(0))
    u = (ju + uj) / jnp.float32(n_u)
    Aw = segA[seg_i]
    Dw = (segB - segA)[seg_i]

    def film_seg(t, A_, D_, u_):
        st, _ = film_of(t, A_ + u_ * D_)
        return st

    S, y0 = jax.vmap(
        lambda A_, D_, u_: film_of(t0, A_ + u_ * D_)
    )(Aw, Dw, u)
    J = jax.vmap(
        lambda A_, D_, u_: jax.jacfwd(film_seg)(t0, A_, D_, u_)
    )(Aw, Dw, u)                                                # (n, 2, 3)
    tau = jax.vmap(
        lambda A_, D_, u_: jax.jacfwd(film_seg, argnums=3)(t0, A_, D_, u_)
    )(Aw, Dw, u)                                                # (n, 2)
    dl = jnp.linalg.norm(tau, axis=-1)
    contrib = _accumulate(
        cam, cfg, scene, g_img, S, J, tau, y0, dl / jnp.float32(n_u),
        seed, jnp.uint32(0), n_sub, n_bounces, delta_px,
    )
    d_t = contrib.sum(axis=0)

    # --- sphere limbs (the limb itself moves with the camera) ----------
    n_sph = scene.spheres.center.shape[0]
    lane_base = M * n_u * n_sub
    for si in range(n_sph):
        center = scene.spheres.center[si]
        radius = scene.spheres.radius[si]
        lane_s = jnp.arange(n_phi, dtype=jnp.uint32)
        ur = uniform(
            jnp.uint32(seed), lane_s + jnp.uint32(lane_base),
            jnp.uint32(1),
        )
        phis = (lane_s.astype(jnp.float32) + ur) * jnp.float32(
            2.0 * jnp.pi / n_phi
        )

        def film_limb(t, phi_):
            # Translation moves the limb itself (it is origin-relative);
            # rotation about the origin leaves the limb curve fixed and
            # only sweeps its projection.
            o_eye = origin + t if mode == "translate" else origin
            q = _limb_point(o_eye, center, radius, phi_)
            st, _ = film_of(t, q)
            return st

        S_l = jax.vmap(lambda p_: film_limb(t0, p_))(phis)
        y0_l = jax.vmap(
            lambda p_: film_of(
                t0, _limb_point(origin, center, radius, p_)
            )[1]
        )(phis)
        J_l = jax.vmap(lambda p_: jax.jacfwd(film_limb)(t0, p_))(phis)
        tau_l = jax.vmap(
            lambda p_: jax.jacfwd(film_limb, argnums=1)(t0, p_)
        )(phis)
        dl_l = jnp.linalg.norm(tau_l, axis=-1)
        contrib_l = _accumulate(
            cam, cfg, scene, g_img, S_l, J_l, tau_l, y0_l,
            dl_l * jnp.float32(2.0 * jnp.pi / n_phi), seed,
            jnp.uint32(lane_base), n_sub, n_bounces, delta_px,
        )
        d_t = d_t + contrib_l.sum(axis=0)
        lane_base += n_phi * n_sub

    return d_t * jnp.float32(w * h)


def camera_edge_grad(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                     g_img, seed=0, n_u: int = 128, n_phi: int = 1024,
                     n_sub: int = 2, n_bounces: int = 8,
                     delta_px: float = 0.25):
    """Boundary term of d(loss)/d(camera translation) (3,).

    g_img: loss cotangent d loss / d image, (h, w, 3) — same convention
    as edge_grad. Add to the pathwise gradient of render_linear w.r.t. a
    shifted CameraParams (origin and lower_left move together) for the
    full translation gradient; use a seed distinct from the render's.
    n_u: samples per border segment; n_phi: samples per sphere limb."""
    segA, segB = scene_edge_segments(scene)
    return _camera_edge_impl(
        scene, cam, cfg, g_img, int(n_u), int(n_phi), int(n_sub),
        int(n_bounces), seed, jnp.float32(delta_px),
        jnp.asarray(segA), jnp.asarray(segB), "translate",
    )


def camera_rotation_edge_grad(scene: Scene, cam: CameraParams,
                              cfg: RenderConfig, g_img, seed=0,
                              n_u: int = 128, n_phi: int = 1024,
                              n_sub: int = 2, n_bounces: int = 8,
                              delta_px: float = 0.25):
    """Boundary term of d(loss)/d(camera rotation) (3,), axis-angle in
    radians about the camera origin (the convention of rotate_camera).
    Add to the pathwise gradient of render_linear through
    rotate_camera(cam, omega) at omega=0 for the full rotation
    gradient. Same estimator as camera_edge_grad with the rotation
    velocity chain (module docstring)."""
    segA, segB = scene_edge_segments(scene)
    return _camera_edge_impl(
        scene, cam, cfg, g_img, int(n_u), int(n_phi), int(n_sub),
        int(n_bounces), seed, jnp.float32(delta_px),
        jnp.asarray(segA), jnp.asarray(segB), "rotate",
    )
