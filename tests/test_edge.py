"""Edge-sampled sphere-geometry boundary gradients (grad/edge.py).

Two-level validation:
1. The screen machinery (silhouette position / velocity / normal / arc
   measure) against a brute-force FD of the analytic coverage integral
   sum_p g_p * mean[primary ray hits sphere] — no renderer, no MC noise
   beyond the jittered coverage estimate.
2. The full estimator (path-traced L_in/L_out) against render FD on an
   emissive-sphere/black-box scene, where the image gradient IS the
   primary-visibility boundary term and pathwise AD is exactly zero.

Module scope (primary silhouettes only — no shadow/secondary boundary
terms) is documented in grad/edge.py; the emissive scene is constructed
so that scope covers the whole gradient.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import small_pathtracer_tpu as spt
from small_pathtracer_tpu.grad.adjoint import render_linear
from small_pathtracer_tpu.grad.edge import (
    edge_grad,
    project_film,
    silhouette_screen,
)

W, H = 64, 48


@pytest.fixture(scope="module")
def cam():
    return spt.make_camera(aspect=W / H)


@pytest.fixture(scope="module")
def smooth_g():
    yy, xx = np.mgrid[0:H, 0:W]
    return (np.sin(xx / 7.0) + np.cos(yy / 5.0) + 0.3).astype(np.float32)


def _coverage(cam, center, radius, spp=192, seed=1):
    """Brute-force jittered screen coverage of the sphere (numpy)."""
    r = np.random.default_rng(seed)
    pix = np.arange(W * H)
    px, py = pix % W, pix // W
    o = np.asarray(cam.origin, np.float64)
    ll = np.asarray(cam.lower_left, np.float64)
    Hh = np.asarray(cam.horizontal, np.float64)
    Vv = np.asarray(cam.vertical, np.float64)
    acc = np.zeros(W * H)
    for _ in range(spp):
        s = (px - 0.5 + r.random(W * H)) / W
        t = ((H - py - 1) - 0.5 + r.random(W * H)) / H
        D = ll[None] + s[:, None] * Hh[None] + t[:, None] * Vv[None] - o
        d = D / np.linalg.norm(D, axis=1, keepdims=True)
        oc = center - o
        b = (d * oc[None]).sum(1)
        disc = b * b - ((oc * oc).sum() - radius ** 2)
        acc += (disc > 0) & (b - np.sqrt(np.maximum(disc, 0)) > 0)
    return (acc / spp).reshape(H, W)


def test_silhouette_screen_vs_coverage_fd(cam, smooth_g):
    """Machinery check: edge estimate of d(sum g*coverage)/d(theta) with
    unit jump vs central differences of the coverage integral."""
    s = spt.get_scene("cornell_spheres")
    center = np.asarray(s.spheres.center[0], np.float64)
    radius = float(s.spheres.radius[0])
    g = smooth_g

    S, J, n_hat, dl = silhouette_screen(
        cam, s.spheres.center[0], s.spheres.radius[0], 4096
    )
    px = jnp.floor(S[:, 0] * W + 0.5).astype(jnp.int32)
    py = H - 1 - jnp.floor(S[:, 1] * H + 0.5).astype(jnp.int32)
    gk = jnp.asarray(g)[jnp.clip(py, 0, H - 1), jnp.clip(px, 0, W - 1)]
    v_n = jnp.einsum("kij,ki->kj", J, n_hat)
    est = np.asarray(
        ((gk * dl)[:, None] * v_n).sum(0) * (2.0 * np.pi / 4096) * (W * H)
    )

    fd = np.zeros(4)
    h = 0.5
    for ax in range(3):
        cp, cm = center.copy(), center.copy()
        cp[ax] += h
        cm[ax] -= h
        fd[ax] = (
            (_coverage(cam, cp, radius) - _coverage(cam, cm, radius)) * g
        ).sum() / (2 * h)
    fd[3] = (
        (_coverage(cam, center, radius + 0.25)
         - _coverage(cam, center, radius - 0.25)) * g
    ).sum() / 0.5
    # Measured agreement 1-6% (axes) at this config; finite-h sweep and
    # coverage-MC noise set the floor.
    assert np.abs(est - fd).max() < 0.12 * np.abs(fd).max(), (est, fd)
    assert np.all(np.sign(est) == np.sign(fd))


@pytest.fixture(scope="module")
def emissive_scene():
    """Black box + emissive sphere 0: radiance = emission * [primary ray
    hits sphere] => the whole geometry gradient is the boundary term."""
    s0 = spt.get_scene("cornell_spheres")
    Z = jnp.zeros_like(s0.rects.albedo)
    return s0._replace(
        rects=s0.rects._replace(albedo=Z, emission=Z),
        spheres=s0.spheres._replace(
            albedo=jnp.zeros((2, 3)),
            emission=jnp.asarray([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]]),
        ),
    )


def test_edge_grad_matches_render_fd(cam, smooth_g, emissive_scene):
    s = emissive_scene
    NB, SPP = 2, 64
    cfg = spt.RenderConfig(width=W, height=H, spp=SPP, estimator="cosine",
                           seed=7)
    g = jnp.asarray(np.repeat(smooth_g[:, :, None], 3, axis=2))

    def loss_c(center):
        s2 = s._replace(spheres=s.spheres._replace(
            center=s.spheres.center.at[0].set(center)))
        return jnp.sum(g * render_linear(s2, cam, cfg, jnp.uint32(7), NB))

    c0 = jnp.asarray(s.spheres.center[0])
    # Pathwise AD sees NO center dependence here (emission is constant
    # along fixed paths) — the gradient is purely the boundary term.
    pw = np.asarray(jax.grad(loss_c)(c0))
    np.testing.assert_allclose(pw, 0.0, atol=1e-5)

    c0n = np.asarray(c0)
    h = 0.5
    fd = np.zeros(3)
    for ax in range(3):
        cp, cm = c0n.copy(), c0n.copy()
        cp[ax] += h
        cm[ax] -= h
        fd[ax] = (
            float(loss_c(jnp.asarray(cp))) - float(loss_c(jnp.asarray(cm)))
        ) / (2 * h)

    dc, dr = edge_grad(s, cam, cfg, g, 0, seed=1234, n_phi=2048, n_sub=2,
                       n_bounces=NB, delta_px=0.5)
    dc = np.asarray(dc)
    # Measured 1-8% per axis on the CPU backend; FD finite-h sweep and
    # the edge estimator's MC noise both contribute.
    assert np.abs(dc - fd).max() < 0.15 * np.abs(fd).max(), (dc, fd)

    def loss_r(r):
        s2 = s._replace(spheres=s.spheres._replace(
            radius=s.spheres.radius.at[0].set(r)))
        return jnp.sum(g * render_linear(s2, cam, cfg, jnp.uint32(7), NB))

    r0 = float(s.spheres.radius[0])
    fdr = (
        float(loss_r(jnp.asarray(r0 + 0.25)))
        - float(loss_r(jnp.asarray(r0 - 0.25)))
    ) / 0.5
    assert abs(float(dr) - fdr) < 0.15 * abs(fdr), (float(dr), fdr)


def test_project_film_roundtrip(cam):
    """project_film inverts the C5 ray relation: a point along the ray
    through film coords (s, t) projects back to (s, t)."""
    s = jnp.asarray([0.2, 0.5, 0.83], jnp.float32)
    t = jnp.asarray([0.7, 0.4, 0.11], jnp.float32)
    D = (
        jnp.asarray(cam.lower_left)[None]
        + s[:, None] * jnp.asarray(cam.horizontal)[None]
        + t[:, None] * jnp.asarray(cam.vertical)[None]
        - jnp.asarray(cam.origin)[None]
    )
    X = jnp.asarray(cam.origin)[None] + 3.7 * D
    st = np.asarray(project_film(cam, X))
    np.testing.assert_allclose(st[:, 0], np.asarray(s), atol=1e-5)
    np.testing.assert_allclose(st[:, 1], np.asarray(t), atol=1e-5)


@pytest.fixture(scope="module")
def direct_lighting_scene():
    """Direct lighting only: white floor, black walls, black absorber
    sphere 0 (the blocker), sphere 1 neutralized. Every theta-dependence
    of the image is a visibility boundary: the blocker's screen
    silhouette (edge_grad) + its cast shadow on the floor
    (shadow_edge_grad). Pathwise AD is exactly zero."""
    s0 = spt.get_scene("cornell_spheres")
    alb = jnp.zeros_like(s0.rects.albedo).at[4].set(
        jnp.asarray([0.75, 0.75, 0.75]))
    return s0._replace(
        rects=s0.rects._replace(albedo=alb),
        spheres=s0.spheres._replace(
            albedo=jnp.zeros((2, 3)),
            emission=jnp.zeros((2, 3)),
            radius=s0.spheres.radius.at[1].set(1e-3),
        ),
    )


def test_shadow_edge_composition(cam, smooth_g, direct_lighting_scene):
    """FD == pathwise(0) + primary edge + shadow edge on the
    direct-lighting scene (module docstring scope claim)."""
    from small_pathtracer_tpu.grad.edge import shadow_edge_grad

    s = direct_lighting_scene
    NB, SPP = 2, 128
    cfg = spt.RenderConfig(width=W, height=H, spp=SPP,
                           estimator="nee_textbook", seed=7)
    g = jnp.asarray(np.repeat(smooth_g[:, :, None], 3, axis=2))

    def loss_c(center):
        s2 = s._replace(spheres=s.spheres._replace(
            center=s.spheres.center.at[0].set(center)))
        return jnp.sum(g * render_linear(s2, cam, cfg, jnp.uint32(7), NB))

    c0 = jnp.asarray(s.spheres.center[0])
    pw = np.asarray(jax.grad(loss_c)(c0))
    np.testing.assert_allclose(pw, 0.0, atol=1e-5)

    c0n = np.asarray(c0)
    h = 0.5
    fd = np.zeros(3)
    for ax in range(3):
        cp, cm = c0n.copy(), c0n.copy()
        cp[ax] += h
        cm[ax] -= h
        fd[ax] = (
            float(loss_c(jnp.asarray(cp))) - float(loss_c(jnp.asarray(cm)))
        ) / (2 * h)

    dc_e, dr_e = edge_grad(s, cam, cfg, g, 0, seed=1234, n_phi=2048,
                           n_sub=2, n_bounces=NB, delta_px=0.5)
    dc_s, dr_s = shadow_edge_grad(s, cam, cfg, g, 0, seed=77, n_phi=16,
                                  delta=0.5)
    total = np.asarray(dc_e) + np.asarray(dc_s)
    assert np.abs(total - fd).max() < 0.2 * np.abs(fd).max(), (
        total, fd, np.asarray(dc_e), np.asarray(dc_s))

    def loss_r(r):
        s2 = s._replace(spheres=s.spheres._replace(
            radius=s.spheres.radius.at[0].set(r)))
        return jnp.sum(g * render_linear(s2, cam, cfg, jnp.uint32(7), NB))

    r0 = float(s.spheres.radius[0])
    fdr = (
        float(loss_r(jnp.asarray(r0 + 0.25)))
        - float(loss_r(jnp.asarray(r0 - 0.25)))
    ) / 0.5
    total_r = float(dr_e) + float(dr_s)
    assert abs(total_r - fdr) < 0.2 * abs(fdr), (
        total_r, fdr, float(dr_e), float(dr_s))


def test_shadow_edge_multilight_partition(cam, smooth_g,
                                          direct_lighting_scene):
    """Multi-emitter shadow term: splitting the single light rect into a
    two-member LightList (same physical emitter) must reproduce the
    single-light curve integral — the per-light on_light masks partition
    the curve, everything else is lane-identical."""
    from small_pathtracer_tpu.grad.edge import shadow_edge_grad
    from small_pathtracer_tpu.scene.types import LightList

    s = direct_lighting_scene
    cfg = spt.RenderConfig(width=W, height=H, spp=8,
                           estimator="nee_textbook", seed=7)
    g = jnp.asarray(np.repeat(smooth_g[:, :, None], 3, axis=2))

    dc1, dr1 = shadow_edge_grad(s, cam, cfg, g, 0, seed=77, n_phi=16,
                                delta=0.5)

    c = jnp.asarray(s.light.corner, jnp.float32)
    eu = jnp.asarray(s.light.edge_u, jnp.float32)
    ev = jnp.asarray(s.light.edge_v, jnp.float32)
    oid = jnp.asarray(s.light.light_obj_id, jnp.int32)
    s2 = s._replace(lights=LightList(
        corner=jnp.stack([c, c + 0.5 * eu]),
        edge_u=jnp.stack([0.5 * eu, 0.5 * eu]),
        edge_v=jnp.stack([ev, ev]),
        obj_id=jnp.stack([oid, oid]),
    ))
    dc2, dr2 = shadow_edge_grad(s2, cam, cfg, g, 0, seed=77, n_phi=16,
                                delta=0.5)
    np.testing.assert_allclose(np.asarray(dc2), np.asarray(dc1),
                               rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(float(dr2), float(dr1),
                               rtol=1e-3, atol=1e-5)


@pytest.fixture(scope="module")
def indirect_scene():
    """Emissive sphere 0 LIFTED off the floor (cy=30, so cy - R > 0)
    lighting a white floor in an otherwise black box (sphere albedo 0,
    walls black, sphere 1 neutralized): under the cosine estimator a
    floor pixel's value is alb * E * (R/D)^2 * cos(theta_c) — the exact
    point-to-sphere form factor, valid because the lifted sphere stays
    entirely above every floor point's horizon. Every theta-dependence
    is a visibility boundary (pathwise AD is exactly zero), and the
    masked loss below isolates the limb-seen-from-floor-vertices term
    (indirect_edge_grad). The sphere is lifted because at the tangent
    pose the unclipped form factor's cy/R derivatives over-count the
    below-horizon cap (measured 24% off); the estimator's cos-clipped
    integrand handles tangency correctly, but then no closed-form
    target exists."""
    s0 = spt.get_scene("cornell_spheres")
    alb = jnp.zeros_like(s0.rects.albedo).at[4].set(
        jnp.asarray([0.75, 0.75, 0.75]))
    return s0._replace(
        rects=s0.rects._replace(
            albedo=alb, emission=jnp.zeros_like(s0.rects.emission)),
        spheres=s0.spheres._replace(
            center=s0.spheres.center.at[0, 1].set(30.0),
            albedo=jnp.zeros((2, 3)),
            emission=jnp.asarray([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]]),
            radius=s0.spheres.radius.at[1].set(1e-3),
        ),
    )


def test_indirect_edge_grad_matches_analytic(cam, smooth_g,
                                             indirect_scene):
    """g masked to pixels that cannot see the sphere directly (dilated
    screen coverage = 0): the gradient of the masked loss is the
    secondary silhouette term alone, and the loss itself has the closed
    form sum_p g_p * alb * E * (R/D)^2 cos(theta_c) over the pixels'
    floor points — AD through that is a deterministic target (no FD, no
    MC noise beyond the estimator's own, measured 1-3% at n_phi=16)."""
    from small_pathtracer_tpu.camera.pinhole import primary_rays
    from small_pathtracer_tpu.geometry.intersect import trace
    from small_pathtracer_tpu.grad.edge import indirect_edge_grad

    s = indirect_scene
    NB = 2
    cfg = spt.RenderConfig(width=W, height=H, spp=32, estimator="cosine",
                           seed=7)
    center = np.asarray(s.spheres.center[0], np.float64)
    radius = float(s.spheres.radius[0])
    cov = _coverage(cam, center, radius + 3.5, spp=64)
    gmask = np.repeat(smooth_g[:, :, None], 3, axis=2) * (
        cov[:, :, None] == 0.0
    )
    g = jnp.asarray(gmask.astype(np.float32))

    # Pathwise AD through the renderer is exactly zero on this scene.
    def loss_render(center_):
        s2 = s._replace(spheres=s.spheres._replace(
            center=s.spheres.center.at[0].set(center_)))
        return jnp.sum(g * render_linear(s2, cam, cfg, jnp.uint32(7), NB))

    pw = np.asarray(jax.grad(loss_render)(jnp.asarray(s.spheres.center[0])))
    np.testing.assert_allclose(pw, 0.0, atol=1e-5)

    # Analytic target: supersampled floor hit points (theta-independent
    # — no masked pixel's rays can reach the sphere), closed-form value.
    NS = 4
    pix = np.arange(W * H)
    px = jnp.asarray((pix % W).astype(np.int32))
    py = jnp.asarray((pix // W).astype(np.int32))
    g_flat = jnp.asarray(gmask.reshape(W * H, 3).astype(np.float32))
    E = jnp.asarray([1.0, 2.0, 3.0])
    ALB = 0.75
    xs, gs = [], []
    for a in range(NS):
        for b in range(NS):
            ux = jnp.full((W * H,), (a + 0.5) / NS, jnp.float32)
            uy = jnp.full((W * H,), (b + 0.5) / NS, jnp.float32)
            o, d = primary_rays(cam, W, H, px, py, ux, uy)
            hit = trace(s, o, d)
            isf = np.asarray(hit.hit & (hit.obj_id == 4))
            x = np.asarray(o) + np.asarray(hit.t)[:, None] * np.asarray(d)
            xs.append(x[isf])
            gs.append(np.asarray(g_flat)[isf])
    X = jnp.asarray(np.concatenate(xs), jnp.float32)
    G = jnp.asarray(np.concatenate(gs), jnp.float32) / (NS * NS)

    def loss_analytic(theta):
        c, R = theta[:3], theta[3]
        dv = c[None] - X
        D2 = jnp.sum(dv * dv, axis=-1)
        cosq = jnp.maximum(dv[:, 1], 0.0) / jnp.sqrt(D2)
        F = (R * R / D2) * cosq
        return jnp.sum(G * (ALB * F[:, None] * E[None]))

    theta0 = jnp.asarray(list(center) + [radius], jnp.float32)
    an = np.asarray(jax.grad(loss_analytic)(theta0))

    dc, dr = indirect_edge_grad(s, cam, cfg, g, 0, seed=1234, n_phi=16,
                                n_bounces=NB, delta=0.5)
    est = np.concatenate([np.asarray(dc), [float(dr)]])
    # Measured 1-3% per component at this config (all four parameters).
    assert np.abs(est - an).max() < 0.08 * np.abs(an).max(), (est, an)


def test_indirect_edge_grad_depth2_matches_analytic(cam, indirect_scene):
    """depths=(2,): the blocker's limb as seen from SECONDARY vertices
    (one sampled cosine bounce past the primary hit). Scene: the
    indirect fixture with the front wall (rect 0, the z=0 wall the
    camera faces) made reflective too, g masked to front-wall pixels —
    their depth-2 vertices (mostly on the floor) see the emissive
    sphere's limb. Target: semi-analytic — stratified primary jitter x
    stratified cosine prefix directions, closed-form point-to-sphere
    form factor alb*E*(R/D)^2*cos at each traced secondary vertex
    (valid: the lifted sphere clears every wall/floor horizon), AD
    through it. Continuation n_bounces=1 makes the estimator's limb
    jump exactly E vs 0, matching the form factor's assumption.
    Measured 5-6% at n_phi=16 on all four parameter components."""
    from small_pathtracer_tpu.camera.pinhole import primary_rays
    from small_pathtracer_tpu.geometry.intersect import shade_info, trace
    from small_pathtracer_tpu.grad.edge import indirect_edge_grad
    from small_pathtracer_tpu.integrator.sampling import (
        SHADOW_EPS, sample_cosine,
    )

    s = indirect_scene._replace(
        rects=indirect_scene.rects._replace(
            albedo=indirect_scene.rects.albedo.at[0].set(
                jnp.asarray([0.75, 0.75, 0.75])
            )
        )
    )
    center = np.asarray(s.spheres.center[0], np.float64)
    radius = float(s.spheres.radius[0])
    E = jnp.asarray([1.0, 2.0, 3.0])
    ALB = 0.75

    yy, xx = np.mgrid[0:H, 0:W]
    gs = (np.sin(xx / 7.0) + np.cos(yy / 5.0) + 0.3).astype(np.float32)
    pix = np.arange(W * H)
    px = jnp.asarray((pix % W).astype(np.int32))
    py = jnp.asarray((pix // W).astype(np.int32))
    half = jnp.full((W * H,), 0.5, jnp.float32)
    o, d = primary_rays(cam, W, H, px, py, half, half)
    front = np.asarray(trace(s, o, d).hit) & (
        np.asarray(trace(s, o, d).obj_id) == 0
    )
    gmask = (gs.reshape(-1) * front).astype(np.float32)
    g = jnp.asarray(np.repeat(gmask.reshape(H, W)[:, :, None], 3, axis=2))

    # Semi-analytic target: NS^2 primary jitters, MD^2 stratified cosine
    # prefix directions, closed form at the traced secondary vertex.
    NS, MD = 2, 16
    xs, ns, gl = [], [], []
    for a in range(NS):
        for b in range(NS):
            ux = jnp.full((W * H,), (a + 0.5) / NS, jnp.float32)
            uy = jnp.full((W * H,), (b + 0.5) / NS, jnp.float32)
            o1, d1 = primary_rays(cam, W, H, px, py, ux, uy)
            h1 = trace(s, o1, d1)
            sh1 = shade_info(s, o1, d1, h1)
            ok = np.asarray(h1.hit & (h1.obj_id == 0)) & front
            xs.append(np.asarray(sh1.x)[ok])
            ns.append(np.asarray(sh1.n)[ok])
            gl.append(gmask[ok])
    X1 = jnp.asarray(np.concatenate(xs), jnp.float32)
    N1 = jnp.asarray(np.concatenate(ns), jnp.float32)
    G1 = jnp.asarray(np.concatenate(gl), jnp.float32) / (NS * NS)

    x2s, n2s, a2s = [], [], []
    for ia in range(MD):
        u1 = jnp.full((X1.shape[0] * MD,), (ia + 0.5) / MD, jnp.float32)
        u2 = jnp.tile(
            (jnp.arange(MD, dtype=jnp.float32) + 0.5) / MD, X1.shape[0]
        )
        Xr = jnp.repeat(X1, MD, axis=0)
        Nr = jnp.repeat(N1, MD, axis=0)
        dirs = sample_cosine(Nr, u1, u2)
        o2 = Xr + SHADOW_EPS * Nr
        h2 = trace(s, o2, dirs)
        sh2 = shade_info(s, o2, dirs, h2)
        x2s.append(np.asarray(sh2.x))
        n2s.append(np.asarray(sh2.n))
        a2s.append(np.asarray(sh2.albedo))
    X2 = jnp.asarray(np.concatenate(x2s), jnp.float32)
    N2 = jnp.asarray(np.concatenate(n2s), jnp.float32)
    A2 = jnp.asarray(np.concatenate(a2s), jnp.float32)
    GR = jnp.concatenate([jnp.repeat(G1, MD)] * MD)

    def loss_analytic(theta):
        c, R = theta[:3], theta[3]
        dv = c[None] - X2
        D2 = jnp.sum(dv * dv, axis=-1)
        cosq = jnp.maximum(jnp.sum(dv * N2, axis=-1), 0.0) / jnp.sqrt(D2)
        F = (R * R / D2)[:, None] * cosq[:, None] * E[None]
        return jnp.sum(GR * (ALB * jnp.sum(A2 * F, axis=-1))) / (MD * MD)

    theta0 = jnp.asarray(list(center) + [radius], jnp.float32)
    an = np.asarray(jax.grad(loss_analytic)(theta0))

    cfg = spt.RenderConfig(width=W, height=H, spp=32, estimator="cosine",
                           seed=7)
    dc, dr = indirect_edge_grad(s, cam, cfg, g, 0, seed=1234, n_phi=16,
                                n_bounces=1, delta=0.5, depths=(2,))
    est = np.concatenate([np.asarray(dc), [float(dr)]])
    assert np.abs(est - an).max() < 0.12 * np.abs(an).max(), (est, an)


def test_geometry_fit_cosine_composition(cam, indirect_scene):
    """geometry_loss_and_grad auto-enables the indirect term for the
    cosine estimator: SGD recovers a displaced emissive sphere on the
    full (unmasked) MSE where primary silhouette + secondary glow both
    drive the pose."""
    from small_pathtracer_tpu.grad.edge import geometry_loss_and_grad

    s_true = indirect_scene
    cfg = spt.RenderConfig(width=W, height=H, spp=8, estimator="cosine",
                           seed=3)
    target = render_linear(s_true, cam, cfg, jnp.uint32(99), 2)
    c_true = np.asarray(s_true.spheres.center[0])

    s = s_true._replace(spheres=s_true.spheres._replace(
        center=s_true.spheres.center.at[0].add(
            jnp.asarray([4.0, 0.0, -3.0]))))
    err0 = np.linalg.norm(np.asarray(s.spheres.center[0]) - c_true)

    lr = 2e2
    for i in range(10):
        _, (d_c, d_r) = geometry_loss_and_grad(
            s, cam, cfg, 2 * i, target, 0, n_bounces=2, n_phi=256,
        )
        step = np.clip(-lr * np.asarray(d_c), -2.0, 2.0)
        s = s._replace(spheres=s.spheres._replace(
            center=s.spheres.center.at[0].add(jnp.asarray(step))))
    err = np.linalg.norm(np.asarray(s.spheres.center[0]) - c_true)
    assert err < 0.5 * err0, (err, err0, np.asarray(s.spheres.center[0]))


def test_geometry_fit_recovers_displacement(cam):
    """SGD on geometry_loss_and_grad recovers a displaced sphere pose on
    the standard cornell_spheres scene: the silhouette + shadow boundary
    terms drive the pose, pathwise the shading."""
    from small_pathtracer_tpu.grad.edge import geometry_loss_and_grad

    s_true = spt.get_scene("cornell_spheres")
    cfg = spt.RenderConfig(width=W, height=H, spp=8,
                           estimator="nee_textbook", seed=3)
    target = render_linear(s_true, cam, cfg, jnp.uint32(99), 3)

    c_true = np.asarray(s_true.spheres.center[0])
    r_true = float(s_true.spheres.radius[0])
    s = s_true._replace(spheres=s_true.spheres._replace(
        center=s_true.spheres.center.at[0].add(jnp.asarray([4.0, 0.0, -3.0])),
        radius=s_true.spheres.radius.at[0].multiply(1.1),
    ))
    err0_c = np.linalg.norm(np.asarray(s.spheres.center[0]) - c_true)
    err0_r = abs(float(s.spheres.radius[0]) - r_true)

    lr = 1e3
    for i in range(12):
        _, (d_c, d_r) = geometry_loss_and_grad(
            s, cam, cfg, 2 * i, target, 0, n_bounces=3, n_phi=256,
        )
        s = s._replace(spheres=s.spheres._replace(
            center=s.spheres.center.at[0].add(-lr * d_c),
            radius=s.spheres.radius.at[0].add(-lr * d_r),
        ))
    err_c = np.linalg.norm(np.asarray(s.spheres.center[0]) - c_true)
    err_r = abs(float(s.spheres.radius[0]) - r_true)
    assert err_c < 0.6 * err0_c, (err_c, err0_c, np.asarray(s.spheres.center[0]))
    assert err_r < 0.6 * err0_r, (err_r, err0_r, float(s.spheres.radius[0]))
