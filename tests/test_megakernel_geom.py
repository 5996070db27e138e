"""Geometry-adjoint megakernel tests (ops/megakernel_geom.py).

Validation strategy (each layer catches a different failure class):
 1. The kernel's own forward image agrees statistically with the forward
    table megakernel (same estimator + RNG; paths can flip on sphere
    scenes at FMA level — the documented kernel-vs-jnp divergence class,
    tests/test_megakernel.py sphere tolerances).
 2. MATERIAL gradients are validated by CRN central differences through
    the kernel's OWN forward (identical path set by construction — the
    two-call design) — interior-exact for materials.
 3. GEOMETRY gradients are validated against jax.grad through the jnp
    wavefront (adjoint.render_linear) on STABLE paths: pixels whose
    kernel/jnp radiance agrees to float noise (no topology flip in any
    of their samples) must have gradients agreeing to ~1%; whole-image
    gradients agree to a looser statistical tolerance (grazing paths
    whose discrete structure flips under ulp-level value differences
    dominate the residual).
 4. A displaced-sphere fit recovers the true pose (functional proof).
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import small_pathtracer_tpu as spt
from small_pathtracer_tpu.config import RenderConfig
from small_pathtracer_tpu.ops import megakernel_geom as mg
from small_pathtracer_tpu.scene.presets import get_scene
from small_pathtracer_tpu.camera.pinhole import make_camera

H, W = 18, 24


@pytest.fixture(scope="module")
def scene():
    return get_scene("cornell_spheres")


@pytest.fixture(scope="module")
def cam():
    return make_camera()


def _cfg(**kw):
    base = dict(width=W, height=H, spp=2, estimator="nee", max_bounces=6,
                sphere_table="on")
    base.update(kw)
    return RenderConfig(**base)


@pytest.fixture(scope="module")
def twolight_scene():
    """cornell_twolights' walls + two colored ceiling lights, with the
    cornell_spheres pair riding the sphere table — the multi-emitter
    geometry-adjoint exercise (per-lane light selection, q folds,
    lifted probe origin, per-light emission cotangent routing)."""
    from small_pathtracer_tpu.scene.presets import (
        AX_Y, DIFF, _ZERO, _cornell_walls, make_scene)
    from small_pathtracer_tpu.scene.types import LightList, LightSampler

    walls = _cornell_walls()[:6]
    light_rects = [
        (AX_Y, 81.5, (15.0, 63.0), (40.0, 88.0), _ZERO,
         (17.0, 12.0, 4.0), DIFF),
        (AX_Y, 81.5, (60.0, 68.0), (80.0, 88.0), _ZERO,
         (4.0, 10.0, 18.0), DIFF),
    ]
    spheres = [
        ((27.0, 16.5, 47.0), 16.5, (0.999, 0.999, 0.999), _ZERO, DIFF),
        ((73.0, 16.5, 78.0), 16.5, (0.75, 0.75, 0.75), _ZERO, DIFF),
    ]
    light = LightSampler(
        corner=jnp.asarray([15.0, 81.5, 63.0], jnp.float32),
        edge_u=jnp.asarray([25.0, 0.0, 0.0], jnp.float32),
        edge_v=jnp.asarray([0.0, 0.0, 25.0], jnp.float32),
        light_obj_id=jnp.asarray(6, jnp.int32),
    )
    lights = LightList(
        corner=jnp.asarray(
            [[15.0, 81.5, 63.0], [60.0, 81.5, 68.0]], jnp.float32),
        edge_u=jnp.asarray(
            [[25.0, 0.0, 0.0], [20.0, 0.0, 0.0]], jnp.float32),
        edge_v=jnp.asarray(
            [[0.0, 0.0, 25.0], [0.0, 0.0, 20.0]], jnp.float32),
        obj_id=jnp.asarray([6, 7], jnp.int32),
    )
    return make_scene(walls + light_rects, spheres, light, lights=lights)


def test_forward_image_matches_table_kernel(scene, cam):
    """geom_run's pass-A image vs the forward table megakernel: same
    estimator and RNG, statistically equal (sphere-scene FMA flips allow
    a few divergent pixels, not a systematic shift)."""
    from small_pathtracer_tpu.ops.megakernel import render_pallas

    cfg = _cfg(spp=4)
    a, _, _, _ = mg.geom_run(scene, cam, cfg, 7, None)
    b, _ = render_pallas(scene, cam, cfg, 7)
    a = np.asarray(a) / cfg.spp
    b = np.asarray(b) / cfg.spp
    assert np.isfinite(a).all()
    # Most pixels bit-agree; the flip class touches isolated pixels.
    close = np.isclose(a, b, rtol=1e-5, atol=1e-6).mean()
    assert close > 0.9, close
    assert abs(a.mean() - b.mean()) < 0.02


def test_material_grads_match_crn_fd(scene, cam):
    """Sphere albedo, light emission, and wall albedo cotangents vs CRN
    central differences through the kernel's own forward (identical
    paths — interior-exact for materials)."""
    cfg = _cfg(spp=4, width=32, height=24, max_bounces=8)
    target = np.zeros((24, 32, 3), np.float32)
    seed = 5

    def loss_of(s2):
        img, _, _, _ = mg.geom_run(s2, cam, cfg, seed, None)
        img = np.asarray(img) / cfg.spp
        return float(np.mean((img - target) ** 2))

    loss, g = mg.loss_and_geom_grads(scene, cam, cfg, seed, target)
    assert loss == pytest.approx(loss_of(scene), rel=1e-5)

    checks = [
        ("sphere albedo",
         lambda d: scene._replace(spheres=scene.spheres._replace(
             albedo=scene.spheres.albedo.at[0, 1].add(d))),
         float(np.asarray(g.spheres.albedo)[0, 1])),
        ("light emission",
         lambda d: scene._replace(rects=scene.rects._replace(
             emission=scene.rects.emission.at[6, 0].add(d))),
         float(np.asarray(g.rects.emission)[6, 0])),
        ("wall albedo",
         lambda d: scene._replace(rects=scene.rects._replace(
             albedo=scene.rects.albedo.at[2, 1].add(d))),
         float(np.asarray(g.rects.albedo)[2, 1])),
    ]
    for name, pert, ad in checks:
        d = 1e-3
        fd = (loss_of(pert(+d)) - loss_of(pert(-d))) / (2 * d)
        assert ad == pytest.approx(fd, rel=5e-2, abs=1e-6), (name, ad, fd)


def _stable_pixel_grads(scene, cam, cfg, seed):
    """(kernel grads, jnp grads) per interior sphere pixel whose
    kernel/jnp radiance agrees to float noise."""
    from small_pathtracer_tpu.grad.adjoint import render_linear

    img_k, _, _, _ = mg.geom_run(scene, cam, cfg, seed, None)
    img_k = np.asarray(img_k) / cfg.spp
    img_j = np.asarray(render_linear(scene, cam, cfg, jnp.uint32(seed),
                                     cfg.max_bounces))
    stable = np.abs(img_k - img_j).max(axis=-1) < 1e-5
    # Pixels covering sphere 0's silhouette interior: probe the center
    # rays (cheap hit test via the jnp tracer).
    from small_pathtracer_tpu.camera.pinhole import primary_rays_cfg
    from small_pathtracer_tpu.core import rng as crng
    from small_pathtracer_tpu.geometry.intersect import trace

    uniform = crng.make_uniform_fn(cfg.rng_backend)
    ys, xs = np.mgrid[0:cfg.height, 0:cfg.width]
    pid = (ys.ravel() * cfg.width + xs.ravel()).astype(np.uint32) * cfg.spp
    o, d = primary_rays_cfg(cam, cfg, jnp.asarray(xs.ravel(), jnp.int32),
                            jnp.asarray(ys.ravel(), jnp.int32),
                            jnp.asarray(pid), jnp.uint32(seed), uniform)
    base = (int(np.asarray(scene.rects.k).shape[0])
            + int(np.asarray(scene.quads.corner).shape[0]))
    hit_sph = (np.asarray(trace(scene, o, d).obj_id) >= base).reshape(
        cfg.height, cfg.width
    )
    pixels = [
        (x, y)
        for y in range(1, cfg.height - 1)
        for x in range(1, cfg.width - 1)
        if hit_sph[y - 1:y + 2, x - 1:x + 2].all() and stable[y, x]
    ]
    return pixels


def test_geometry_grads_match_jnp_on_stable_paths(scene, cam):
    """Center/radius cotangents on paths with no kernel-vs-jnp topology
    flip must match jax.grad through the jnp wavefront to ~1% — the
    surgical full-chain check (lambda propagation, sigma recovery, VJP
    bounce, NEE weight derivatives, multi-bounce)."""
    from small_pathtracer_tpu.grad.adjoint import render_linear

    cfg = _cfg()
    seed = 9
    pixels = _stable_pixel_grads(scene, cam, cfg, seed)
    assert pixels, "no stable interior sphere pixels at this config/seed"
    checked = 0
    for (x, y) in pixels[:2]:
        g_img = np.zeros((H, W, 3), np.float32)
        g_img[y, x, :] = 1.0
        gtab, galb, gemi = mg.geom_vjp(scene, cam, cfg, seed, g_img)
        gk = mg.grads_to_scene(scene, gtab, galb, gemi)

        def val(cen, rad):
            s2 = scene._replace(spheres=scene.spheres._replace(
                center=cen, radius=rad))
            img = render_linear(s2, cam, cfg, jnp.uint32(seed),
                                cfg.max_bounces)
            return img[y, x, :].sum() * cfg.spp  # kernel sums over spp

        gc, gr = jax.grad(val, argnums=(0, 1))(
            scene.spheres.center, scene.spheres.radius
        )
        a = np.concatenate([np.asarray(gk.spheres.center).ravel(),
                            np.asarray(gk.spheres.radius).ravel()])
        b = np.concatenate([np.asarray(gc).ravel(),
                            np.asarray(gr).ravel()])
        scale = np.abs(b).max()
        assert scale > 0
        assert np.abs(a - b).max() / scale < 1e-2, (x, y, a, b)
        checked += 1
    assert checked >= 1


def test_geometry_grads_match_jnp_mis(scene, cam):
    """estimator="mis" in the geometry kernel (round-4 extension): the
    balance weights introduce two flows the other estimators lack — the
    pickup weight w_b(t, d, mpdf) and the cross-bounce mpdf chain
    (lambda_mpdf routes the pickup weight's carry-cotangent back to the
    PREVIOUS bounce's continuation-pdf output). Stable paths must match
    jax.grad through the jnp wavefront to ~1e-3 across center, radius,
    AND albedo (the direct-term material pickup shares the gate)."""
    from small_pathtracer_tpu.grad.adjoint import render_linear

    cfg = _cfg(estimator="mis")
    seed = 9
    pixels = _stable_pixel_grads(scene, cam, cfg, seed)
    assert pixels, "no stable interior sphere pixels at this config/seed"
    for (x, y) in pixels[:2]:
        g_img = np.zeros((H, W, 3), np.float32)
        g_img[y, x, :] = 1.0
        gtab, galb, gemi = mg.geom_vjp(scene, cam, cfg, seed, g_img)
        gk = mg.grads_to_scene(scene, gtab, galb, gemi)

        def val(cen, rad, alb):
            s2 = scene._replace(spheres=scene.spheres._replace(
                center=cen, radius=rad, albedo=alb))
            img = render_linear(s2, cam, cfg, jnp.uint32(seed),
                                cfg.max_bounces)
            return img[y, x, :].sum() * cfg.spp

        gc, gr, ga = jax.grad(val, argnums=(0, 1, 2))(
            scene.spheres.center, scene.spheres.radius,
            scene.spheres.albedo,
        )
        a = np.concatenate([np.asarray(gk.spheres.center).ravel(),
                            np.asarray(gk.spheres.radius).ravel(),
                            np.asarray(gk.spheres.albedo).ravel()])
        b = np.concatenate([np.asarray(gc).ravel(),
                            np.asarray(gr).ravel(),
                            np.asarray(ga).ravel()])
        scale = np.abs(b).max()
        assert scale > 0
        assert np.abs(a - b).max() / scale < 2e-3, (x, y, a, b)


@pytest.mark.parametrize("est", ["nee", "mis"])
def test_multilight_grads_match_jnp(twolight_scene, cam, est):
    """Light lists through the geometry kernel (round-4 late addition):
    per-lane selection replay, 1/q_k NEE weights, q-folded pickup
    densities (mis), the SHADOW_EPS-lifted probe origin riding the
    differentiable normal, and per-SAMPLED-light emission-cotangent
    routing. Stable paths must match jax.grad through the jnp wavefront
    at float level across center/radius/albedo AND both light rects'
    emission rows (measured <= 9e-8 at this config)."""
    from small_pathtracer_tpu.grad.adjoint import render_linear

    scene = twolight_scene
    cfg = _cfg(estimator=est, spp=2, max_bounces=4)
    seed = 7
    img_sum, _, _, _ = mg.geom_run(scene, cam, cfg, seed)
    img_k = np.asarray(img_sum) / cfg.spp
    img_j = np.asarray(render_linear(scene, cam, cfg, jnp.uint32(seed),
                                     cfg.max_bounces))
    stable = np.abs(img_k - img_j).max(axis=-1) < 1e-5
    pixels = [(y, x) for y in range(10, H - 1) for x in range(2, W - 2)
              if stable[y, x]]
    assert len(pixels) > 20, "multi-light forward diverged from jnp"
    rows_seen = np.zeros(2, bool)
    # Spread the probes across the image so the two (spatially separated)
    # lights both contribute somewhere.
    probe = [pixels[0], pixels[len(pixels) // 2], pixels[-1]]
    for (y, x) in probe:
        g_img = np.zeros((H, W, 3), np.float32)
        g_img[y, x, :] = 1.0
        gtab, galb, gemi = mg.geom_vjp(scene, cam, cfg, seed, g_img)
        gk = mg.grads_to_scene(scene, gtab, galb, gemi)

        def val(cen, rad, alb, remi):
            s2 = scene._replace(
                spheres=scene.spheres._replace(
                    center=cen, radius=rad, albedo=alb),
                rects=scene.rects._replace(emission=remi))
            img = render_linear(s2, cam, cfg, jnp.uint32(seed),
                                cfg.max_bounces)
            return img[y, x, :].sum() * cfg.spp

        gc, gr, ga, ge = jax.grad(val, argnums=(0, 1, 2, 3))(
            scene.spheres.center, scene.spheres.radius,
            scene.spheres.albedo, scene.rects.emission)
        a = np.concatenate([np.asarray(gk.spheres.center).ravel(),
                            np.asarray(gk.spheres.radius).ravel(),
                            np.asarray(gk.spheres.albedo).ravel(),
                            np.asarray(gk.rects.emission).ravel()])
        b = np.concatenate([np.asarray(v).ravel()
                            for v in (gc, gr, ga, ge)])
        scale = np.abs(b).max()
        assert scale > 0
        assert np.abs(a - b).max() / scale < 1e-4, (est, x, y)
        rows_seen |= np.asarray(gk.rects.emission)[6:8].sum(axis=1) > 0
    # Across the probe pixels, emission cotangents land on BOTH light
    # rows (the per-SAMPLED-light routing, not a single static slot).
    assert rows_seen.all(), rows_seen


@pytest.mark.parametrize("est", ["cosine", "mis"])
def test_glossy_grads_match_jnp(scene, cam, est):
    """GLOS through the geometry kernel (round-4 late addition): the
    modified-Phong lobe replay (reflected axis differentiable via d,
    frame/draws detached), the phong NEE weight + mis balance pdfs, the
    phong continuation pdf in the mpdf chain, and the below-horizon
    absorb. Stable paths on a glossy-floor sphere scene must match
    jax.grad across center/radius/albedo AND the glossy rect's own
    albedo row. cosine is float-exact (<= 2e-7 measured); mis carries
    the balance-weight ratio sensitivity — a 1-ulp FMA difference in the
    mpdf carry between the kernel and jnp paths (the documented
    sphere-scene contraction divergence) shifts w_b = mpdf/(mpdf + p_l)
    derivatives by ~1e-4..5e-3 while the radiance stays stable, the same
    residual class the single-light mis test measures — so mis uses the
    module contract's ~1% stable-path tolerance."""
    from small_pathtracer_tpu.grad.adjoint import render_linear

    r = scene.rects
    axes = np.asarray(r.axis)
    ks = np.asarray(r.k)
    floor = int(np.where((axes == 1) & (ks == 0.0))[0][0])
    glos = scene._replace(rects=r._replace(
        refl=r.refl.at[floor].set(3),
        gloss=r.gloss.at[floor].set(40.0)))
    cfg = _cfg(estimator=est, spp=2, max_bounces=5)
    seed = 9
    img_sum, _, _, _ = mg.geom_run(glos, cam, cfg, seed)
    img_k = np.asarray(img_sum) / cfg.spp
    img_j = np.asarray(render_linear(glos, cam, cfg, jnp.uint32(seed),
                                     cfg.max_bounces))
    stable = np.abs(img_k - img_j).max(axis=-1) < 1e-5
    # Lit pixels only: a dead-path black pixel has all-zero gradients on
    # both sides (a vacuous 0 == 0 agreement).
    pixels = [(y, x) for y in range(11, H - 1) for x in range(2, W - 2)
              if stable[y, x] and img_j[y, x].sum() > 1e-3]
    # cosine at spp=2 leaves many dead-path pixels on the dark glossy
    # floor; a handful of lit stable pixels is enough to probe.
    assert len(pixels) > 5, "glossy forward diverged from jnp"
    for (y, x) in [pixels[0], pixels[-1]]:
        g_img = np.zeros((H, W, 3), np.float32)
        g_img[y, x, :] = 1.0
        gtab, galb, gemi = mg.geom_vjp(glos, cam, cfg, seed, g_img)
        gk = mg.grads_to_scene(glos, gtab, galb, gemi)

        def val(cen, rad, alb, ralb):
            s2 = glos._replace(
                spheres=glos.spheres._replace(
                    center=cen, radius=rad, albedo=alb),
                rects=glos.rects._replace(albedo=ralb))
            img = render_linear(s2, cam, cfg, jnp.uint32(seed),
                                cfg.max_bounces)
            return img[y, x, :].sum() * cfg.spp

        gc, gr, ga, gra = jax.grad(val, argnums=(0, 1, 2, 3))(
            glos.spheres.center, glos.spheres.radius,
            glos.spheres.albedo, glos.rects.albedo)
        a = np.concatenate([np.asarray(gk.spheres.center).ravel(),
                            np.asarray(gk.spheres.radius).ravel(),
                            np.asarray(gk.spheres.albedo).ravel(),
                            np.asarray(gk.rects.albedo).ravel()])
        b = np.concatenate([np.asarray(v).ravel()
                            for v in (gc, gr, ga, gra)])
        scale = np.abs(b).max()
        assert scale > 0
        tol = 1e-4 if est == "cosine" else 1e-2
        assert np.abs(a - b).max() / scale < tol, (est, x, y)
    # Batched check over ALL lit stable pixels at once: the union carries
    # real glossy-floor signal (nonzero d/d floor-albedo), and the
    # kernel's batched cotangent matches jax.grad on it — proving the
    # lobe replay transports radiance through the glossy bounce, not
    # just agreeing on diffuse-only paths.
    g_img = np.zeros((H, W, 3), np.float32)
    for (y, x) in pixels:
        g_img[y, x, :] = 1.0
    gtab, galb, gemi = mg.geom_vjp(glos, cam, cfg, seed, g_img)
    gk = mg.grads_to_scene(glos, gtab, galb, gemi)

    def val_all(ralb):
        s2 = glos._replace(rects=glos.rects._replace(albedo=ralb))
        img = render_linear(s2, cam, cfg, jnp.uint32(seed),
                            cfg.max_bounces)
        return (img * g_img).sum() * cfg.spp

    gra = np.asarray(jax.grad(val_all)(glos.rects.albedo))
    gkr = np.asarray(gk.rects.albedo)
    assert gra[floor].sum() > 1.0, gra[floor]
    assert np.abs(gkr - gra).max() / np.abs(gra).max() < (
        1e-4 if est == "cosine" else 1e-2)


def test_whole_image_grads_statistical(scene, cam):
    """Whole-image center/radius gradients vs jnp AD: agree within a
    loose statistical tolerance (flip-class paths perturb both sides)."""
    from small_pathtracer_tpu.grad.adjoint import render_linear

    cfg = _cfg(width=48, height=36, spp=4, max_bounces=8)
    target = np.zeros((36, 48, 3), np.float32)
    ks, js = [], []
    for seed in (1, 2):
        _, gk = mg.loss_and_geom_grads(scene, cam, cfg, seed, target)

        def loss_fn(cen, rad):
            s2 = scene._replace(spheres=scene.spheres._replace(
                center=cen, radius=rad))
            img = render_linear(s2, cam, cfg, jnp.uint32(seed),
                                cfg.max_bounces)
            return jnp.mean((img - target) ** 2)

        gc, gr = jax.grad(loss_fn, argnums=(0, 1))(
            scene.spheres.center, scene.spheres.radius
        )
        ks.append(np.concatenate([np.asarray(gk.spheres.center).ravel(),
                                  np.asarray(gk.spheres.radius).ravel()]))
        js.append(np.concatenate([np.asarray(gc).ravel(),
                                  np.asarray(gr).ravel()]))
    km, jm = np.mean(ks, axis=0), np.mean(js, axis=0)
    scale = np.abs(jm).max()
    assert np.abs(km - jm).max() / scale < 0.25
    # Directional agreement of the dominant components.
    cos = float(km @ jm / (np.linalg.norm(km) * np.linalg.norm(jm)))
    assert cos > 0.9, cos


@pytest.mark.parametrize("est", ["cosine", "mixture", "uniform",
                                 "uniform_corrected", "nee_textbook",
                                 "mis"])
def test_estimators_finite_and_consistent(scene, cam, est):
    """Every supported estimator: finite gradients; the forward image
    matches the estimator's table-kernel render statistically."""
    from small_pathtracer_tpu.ops.megakernel import render_pallas

    cfg = _cfg(estimator=est, spp=2, max_bounces=4)
    target = np.zeros((H, W, 3), np.float32)
    loss, g = mg.loss_and_geom_grads(scene, cam, cfg, 11, target)
    assert np.isfinite(float(loss))
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(g))
    a, _, _, _ = mg.geom_run(scene, cam, cfg, 11, None)
    b, _ = render_pallas(scene, cam, cfg, 11)
    assert abs(float(np.asarray(a).mean()) - float(np.asarray(b).mean())) \
        < 0.05 * max(float(np.asarray(b).mean()), 1.0)


def test_glibc_mode_runs(scene, cam):
    cfg = _cfg(light_sample_mode="glibc_overflow", spp=2, max_bounces=4)
    target = np.zeros((H, W, 3), np.float32)
    loss, g = mg.loss_and_geom_grads(scene, cam, cfg, 2, target)
    assert np.isfinite(float(loss))
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(g))


def test_spec_refr_scene(cam):
    """SPEC/REFR table spheres: gradients flow through the
    reflect/refract chain (smallpt.cpp:481-495 semantics) and stay
    finite; the mirror sphere's center picks up nonzero cotangent."""
    scene = get_scene("smallpt_original")
    cfg = RenderConfig(width=16, height=12, spp=2, estimator="nee",
                       max_bounces=5, sphere_table="on")
    target = np.zeros((12, 16, 3), np.float32)
    loss, g = mg.loss_and_geom_grads(scene, cam, cfg, 4, target)
    assert np.isfinite(float(loss))
    assert all(np.isfinite(np.asarray(x)).all()
               for x in jax.tree.leaves(g))
    assert np.abs(np.asarray(g.spheres.center)).max() > 0


def test_fit_recovers_displaced_sphere(scene, cam):
    """Functional recovery, same contract class as test_fd.py's
    (the center is weakly identifiable at CI size — see its docstring):
    monotone best-loss descent of >= 1.35x, and the pose must not walk
    AWAY from the truth."""
    cfg = _cfg(spp=4, width=32, height=24, max_bounces=6)
    img, _, _, _ = mg.geom_run(scene, cam, cfg, 13, None)
    target = np.asarray(img) / cfg.spp
    displaced = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center.at[0].add(
            jnp.asarray([5.0, 0.0, -3.0], jnp.float32))
    ))
    fitted, losses = mg.fit_pallas_geom(
        displaced, cam, cfg, target, sphere_idx=0,
        fields=("center",), steps=10, lr=2.0, seed=13, )
    d0 = float(jnp.linalg.norm(
        displaced.spheres.center[0] - scene.spheres.center[0]))
    d1 = float(jnp.linalg.norm(
        fitted.spheres.center[0] - scene.spheres.center[0]))
    assert min(losses) < losses[0] / 1.35, losses
    assert losses[-1] == min(losses)  # losses[-1] = returned iterate
    assert d1 < d0 + 0.8, (d0, d1)


def test_no_recompile_across_geometry(scene, cam):
    """Geometry/material edits reuse the compiled kernel (the property
    that makes per-step fitting cheap)."""
    cfg = _cfg(spp=1, max_bounces=3)
    mg.geom_run(scene, cam, cfg, 1, None)
    n = len(mg._CACHE)
    moved = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center + jnp.asarray([1.0, 0.5, -2.0]),
        radius=scene.spheres.radius * 1.1,
        albedo=scene.spheres.albedo * 0.9,
    ))
    a, _, _, _ = mg.geom_run(moved, cam, cfg, 1, None)
    assert len(mg._CACHE) == n
    b, _, _, _ = mg.geom_run(scene, cam, cfg, 1, None)
    assert np.abs(np.asarray(a) - np.asarray(b)).max() > 1e-3


def test_sharded_train_step_matches_single_device(scene, cam):
    """geom_train_step_sharded on the 8-device CPU mesh: loss and every
    gradient table must match loss_and_geom_grads bit-nearly (same
    counter-RNG sample set; only float summation order differs), for
    both a pure pixel mesh (8x1) and a pixel x sample mesh (4x2) — the
    4x2 case is the regression pin for the loss psum/n_dp under-count
    this test caught in both sharded train steps."""
    from small_pathtracer_tpu.ops.megakernel import _sphere_tables
    from small_pathtracer_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    cfg = _cfg(width=24, height=16, spp=8, max_bounces=4)
    target = np.zeros((16, 24, 3), np.float32)
    loss_1, gsc_1 = mg.loss_and_geom_grads(scene, cam, cfg, 3, target)
    alb, emi, packed = _sphere_tables(scene)
    for shape in ((8, 1), (4, 2)):
        mesh = make_mesh(devices[:8], mesh_shape=shape)
        step = mg.geom_train_step_sharded(scene, cam, cfg, mesh, target)
        loss_s, img_s, gtab_s, galb_s, gemi_s = step(alb, emi, packed, 3)
        gsc_s = mg.grads_to_scene(scene, gtab_s, galb_s, gemi_s)
        assert abs(float(loss_s) - float(loss_1)) < 1e-5, shape
        # The assembled image is the same radiance sum geom_run reports.
        img_1, _, _, _ = mg.geom_run(scene, cam, cfg, 3, None)
        np.testing.assert_allclose(np.asarray(img_s), np.asarray(img_1),
                                   atol=2e-5)
        np.testing.assert_allclose(
            np.asarray(gsc_s.spheres.center),
            np.asarray(gsc_1.spheres.center), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(gsc_s.spheres.radius),
            np.asarray(gsc_1.spheres.radius), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(gsc_s.rects.albedo),
            np.asarray(gsc_1.rects.albedo), atol=1e-6)
        np.testing.assert_allclose(
            np.asarray(gsc_s.rects.emission),
            np.asarray(gsc_1.rects.emission), atol=1e-6)


def test_fit_mesh_matches_single_device(scene, cam):
    """fit_pallas_geom(mesh=...) must walk the SAME trust-region
    trajectory as the single-device fitter: the sharded evaluator
    returns the identical CRN loss and a float-sum-order-equal gradient,
    and the normalized step (grad/|grad|) absorbs the residual — so the
    losses and iterates match exactly (`fit --pallas --mesh SPxDP`)."""
    from small_pathtracer_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    cfg = _cfg(width=24, height=16, spp=8, max_bounces=4)
    img_t, _, _, _ = mg.geom_run(scene, cam, cfg, 3, None)
    target = np.asarray(img_t) / cfg.spp
    displaced = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center.at[0].add(
            jnp.asarray([3.0, 0.0, -2.0], jnp.float32))))
    fit_1, losses_1 = mg.fit_pallas_geom(
        displaced, cam, cfg, target, sphere_idx=0, fields=("center",),
        steps=3, lr=1.5, seed=3)
    mesh = make_mesh(devices[:8], mesh_shape=(4, 2))
    fit_m, losses_m = mg.fit_pallas_geom(
        displaced, cam, cfg, target, sphere_idx=0, fields=("center",),
        steps=3, lr=1.5, seed=3, mesh=mesh)
    assert losses_m[0] == pytest.approx(losses_1[0], abs=1e-6)
    assert min(losses_m) == pytest.approx(min(losses_1), abs=1e-6)
    np.testing.assert_allclose(np.asarray(fit_m.spheres.center),
                               np.asarray(fit_1.spheres.center),
                               atol=1e-4)


def test_validation_errors(scene, cam):
    from small_pathtracer_tpu.scene.types import LightList

    box = get_scene("cornell_box")
    with pytest.raises(ValueError, match="no spheres"):
        mg.build_geom_grad_kernel(box, cam, _cfg())
    glos = scene._replace(spheres=scene.spheres._replace(
        refl=scene.spheres.refl.at[0].set(3)))
    with pytest.raises(ValueError, match="GLOS"):
        mg.build_geom_grad_kernel(glos, cam, _cfg(estimator="cosine"))
    # Light lists are supported (round-4 late addition) — but every
    # emitter must be an unrolled rect/quad, not a table sphere.
    base = int(np.asarray(scene.rects.k).shape[0]) + int(
        np.asarray(scene.quads.corner).shape[0])
    ll = LightList(
        obj_id=jnp.asarray([base], jnp.int32),
        corner=jnp.asarray(scene.rects.k[6] * jnp.ones(3))[None],
        edge_u=jnp.eye(3, dtype=jnp.float32)[:1],
        edge_v=jnp.eye(3, dtype=jnp.float32)[1:2],
    )
    bad = scene._replace(lights=ll)
    with pytest.raises(ValueError, match="table sphere"):
        mg.build_geom_grad_kernel(bad, cam, _cfg())


@pytest.mark.parametrize("extra", [0, 1])
def test_sphere_count_limit(cam, extra):
    """The kernel takes tables up to GEOM_MAX_SPHERES spheres and refuses
    larger ones before it traces anything."""
    from small_pathtracer_tpu.scene.presets import sphere_grid

    big = sphere_grid(mg.GEOM_MAX_SPHERES + extra)
    if extra:
        with pytest.raises(ValueError, match="at most"):
            mg.build_geom_grad_kernel(big, cam, _cfg())
    else:
        _, _, n_sph = mg.build_geom_grad_kernel(big, cam, _cfg())
        assert n_sph == mg.GEOM_MAX_SPHERES
