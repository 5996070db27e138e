"""Adjoint megakernel validation (interpret mode on CPU).

The adjoint kernel (ops/megakernel_grad.py) must reproduce jax.grad
through the jnp lax.scan wavefront exactly (same pathwise scope, same
paths via the shared counter RNG): forward parity is bitwise, gradient
parity is float-accumulation-level."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
from small_pathtracer_tpu.grad.adjoint import render_linear
from small_pathtracer_tpu.ops.megakernel import render_pallas, trace_totals
from small_pathtracer_tpu.ops.megakernel_grad import (
    fit_pallas,
    loss_and_material_grads,
    material_grads_to_scene,
    pack_materials,
    render_pallas_mat,
    render_pallas_vjp,
    unpack_materials,
)

CFG = RenderConfig(width=16, height=12, spp=4, estimator="nee", seed=3,
                   max_bounces=8)


def test_pack_unpack_roundtrip():
    scene = get_scene("cornell_spheres")
    alb, emi = pack_materials(scene)
    assert alb.shape == (9, 3) and emi.shape == (9, 3)
    s2 = unpack_materials(scene, alb, emi)
    for a, b in zip(jax.tree.leaves(scene), jax.tree.leaves(s2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fwd_runtime_materials_matches_baked():
    """mat_refs=True kernel == baked kernel, bit for bit, at equal
    materials (same RNG, same float expression trees)."""
    scene = get_scene("cornell_box")
    cam = make_camera()
    a, ta = render_pallas(scene, cam, CFG, 3)
    ta = trace_totals(ta)
    alb, emi = pack_materials(scene)
    b, tb = render_pallas_mat(scene, cam, CFG, alb, emi, 3)
    tb = trace_totals(tb)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))


def _jnp_loss_and_grads(scene, cam, cfg, seed, target):
    def loss_fn(sc):
        img = render_linear(sc, cam, cfg, jnp.uint32(seed),
                            n_bounces=cfg.max_bounces)
        return jnp.mean((img - target) ** 2)

    loss, g = jax.value_and_grad(loss_fn, allow_int=True)(scene)
    galb, gemi = pack_materials(g)
    return float(loss), np.asarray(galb), np.asarray(gemi)


@pytest.mark.parametrize("est", ["nee", "cosine", "mixture",
                                 "nee_textbook", "mis"])
def test_vjp_matches_jnp_adjoint(est):
    """Kernel adjoint == jax.grad of the jnp scan wavefront on the box
    scene (identical paths; both pathwise with the RR 1/p term).

    nee_textbook excludes the LIGHT's albedo row: its gradient is a
    knife-edge artifact of the C13 81.5-vs-81.6 plane mismatch — shadow
    rays from vertices on/near the light plane produce 1/t^2 fireflies
    whose probe success flips under float-rounding differences between
    program variants (even lax.scan autodiff vs an op-identical eager
    rollout of the SAME jnp code disagree by >2x on it, while some seeds
    match to 1e-6). A zero-albedo emitter's albedo is not a meaningful
    training target; every other row must match tightly."""
    import dataclasses

    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = dataclasses.replace(CFG, estimator=est)
    target = render_linear(
        scene._replace(
            rects=scene.rects._replace(emission=scene.rects.emission * 1.4)
        ),
        cam, cfg, jnp.uint32(9), n_bounces=cfg.max_bounces,
    )
    l_jnp, ga_jnp, ge_jnp = _jnp_loss_and_grads(scene, cam, cfg, cfg.seed,
                                                target)
    l_k, ga_k, ge_k = loss_and_material_grads(
        scene, cam, cfg, jnp.uint32(cfg.seed), target)
    assert abs(float(l_k) - l_jnp) < 1e-5 * max(1.0, abs(l_jnp))
    ga_k = np.asarray(ga_k).copy()
    ga_jnp = np.asarray(ga_jnp).copy()
    if est in ("nee_textbook", "mis"):
        light = int(np.asarray(scene.light.light_obj_id))
        ga_k[light] = 0.0
        ga_jnp[light] = 0.0
    scale_a = np.abs(ga_jnp).max()
    scale_e = np.abs(ge_jnp).max()
    np.testing.assert_allclose(ga_k, ga_jnp,
                               atol=5e-3 * scale_a, rtol=5e-3)
    np.testing.assert_allclose(np.asarray(ge_k), ge_jnp,
                               atol=5e-3 * scale_e, rtol=5e-3)


@pytest.mark.parametrize("est,sel", [
    ("nee", "power"), ("nee", "uniform"), ("mixture", "power"),
    ("nee_textbook", "power"),
])
def test_vjp_matches_jnp_adjoint_multilight(est, sel):
    """Multi-emitter (light list) scene: the adjoint replays the per-lane
    selection draw and routes the textbook direct-term emission cotangent
    to the SAMPLED light's row; parity vs jax.grad through the jnp
    wavefront for both selection heuristics (q is stop-gradient'ed in
    sampling.light_select_probs, so "power" has no quotient terms).

    nee_textbook: BOTH listed lights' albedo rows are excluded — the same
    knife-edge 1/t^2 shadow-ray artifact as the single-light case."""
    import dataclasses

    scene = get_scene("cornell_twolights")
    cam = make_camera()
    cfg = dataclasses.replace(CFG, estimator=est, light_select=sel)
    target = render_linear(
        scene._replace(
            rects=scene.rects._replace(emission=scene.rects.emission * 1.3)
        ),
        cam, cfg, jnp.uint32(7), n_bounces=cfg.max_bounces,
    )
    l_jnp, ga_jnp, ge_jnp = _jnp_loss_and_grads(scene, cam, cfg, cfg.seed,
                                                target)
    l_k, ga_k, ge_k = loss_and_material_grads(
        scene, cam, cfg, jnp.uint32(cfg.seed), target)
    assert abs(float(l_k) - l_jnp) < 1e-5 * max(1.0, abs(l_jnp))
    ga_k = np.asarray(ga_k).copy()
    ga_jnp = np.asarray(ga_jnp).copy()
    if est == "nee_textbook":
        for lid in np.asarray(scene.lights.obj_id):
            ga_k[int(lid)] = 0.0
            ga_jnp[int(lid)] = 0.0
    scale_a = np.abs(ga_jnp).max()
    scale_e = np.abs(ge_jnp).max()
    np.testing.assert_allclose(ga_k, ga_jnp,
                               atol=5e-3 * scale_a, rtol=5e-3)
    np.testing.assert_allclose(np.asarray(ge_k), ge_jnp,
                               atol=5e-3 * scale_e, rtol=5e-3)


def test_fwd_runtime_materials_matches_baked_multilight():
    """mat_refs kernel == baked kernel bit-for-bit on a light-list scene
    ("power" selection: the runtime-emission CDF must round identically
    to the baked f32 constants)."""
    import dataclasses

    scene = get_scene("cornell_twolights")
    cam = make_camera()
    cfg = dataclasses.replace(CFG, estimator="nee", light_select="power")
    a, ta = render_pallas(scene, cam, cfg, 3)
    ta = trace_totals(ta)
    alb, emi = pack_materials(scene)
    b, tb = render_pallas_mat(scene, cam, cfg, alb, emi, 3)
    tb = trace_totals(tb)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))


def test_vjp_matches_jnp_adjoint_spec_refr():
    """SPEC mirror + REFR glass scene: the albedo/emission adjoint flows
    through Fresnel-weighted throughput identically to jnp."""
    import dataclasses

    scene = get_scene("smallpt_original")
    cam = make_camera()
    cfg = dataclasses.replace(CFG, estimator="cosine", spp=4)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    l_jnp, ga_jnp, ge_jnp = _jnp_loss_and_grads(scene, cam, cfg, cfg.seed,
                                                target)
    l_k, ga_k, ge_k = loss_and_material_grads(
        scene, cam, cfg, jnp.uint32(cfg.seed), target)
    assert abs(float(l_k) - l_jnp) < 1e-5 * max(1.0, abs(l_jnp))
    scale_a = np.abs(ga_jnp).max()
    scale_e = np.abs(ge_jnp).max()
    np.testing.assert_allclose(np.asarray(ga_k), ga_jnp,
                               atol=1e-2 * scale_a, rtol=1e-2)
    np.testing.assert_allclose(np.asarray(ge_k), ge_jnp,
                               atol=1e-2 * scale_e, rtol=1e-2)


@pytest.mark.parametrize("est", ["cosine", "nee_textbook", "mis"])
def test_vjp_matches_jnp_adjoint_glos(est):
    """GLOS (modified-Phong) materials in the adjoint kernel (round-3
    VERDICT composition-matrix item): a glossy RECT on the sphere-free
    box scene keeps paths bit-identical between kernel and jnp, so the
    adjoint must match jax.grad to float noise across the glossy
    estimators (lobe replay, Phong direct-term weight, mis pdf carry,
    below-horizon absorption kill)."""
    import dataclasses

    scene = get_scene("cornell_box")
    scene = scene._replace(rects=scene.rects._replace(
        refl=scene.rects.refl.at[2].set(3),
        gloss=scene.rects.gloss.at[2].set(60.0),
    ))
    cam = make_camera()
    cfg = dataclasses.replace(CFG, estimator=est)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    l_jnp, ga_jnp, ge_jnp = _jnp_loss_and_grads(scene, cam, cfg, cfg.seed,
                                                target)
    l_k, ga_k, ge_k = loss_and_material_grads(
        scene, cam, cfg, jnp.uint32(cfg.seed), target)
    assert abs(float(l_k) - l_jnp) < 1e-5 * max(1.0, abs(l_jnp))
    ga_k = np.asarray(ga_k).copy()
    ga_jnp = np.asarray(ga_jnp).copy()
    if est in ("nee_textbook", "mis"):
        light = int(np.asarray(scene.light.light_obj_id))
        ga_k[light] = 0.0
        ga_jnp[light] = 0.0
    np.testing.assert_allclose(ga_k, ga_jnp,
                               atol=5e-3 * np.abs(ga_jnp).max(), rtol=5e-3)
    np.testing.assert_allclose(np.asarray(ge_k), np.asarray(ge_jnp),
                               atol=5e-3 * np.abs(ge_jnp).max(), rtol=5e-3)


def test_fd_validates_kernel_gradient():
    """Central finite differences of the KERNEL forward (runtime
    materials) vs the kernel adjoint — self-contained FD validation, no
    jnp reference involved."""
    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = CFG
    alb, emi = pack_materials(scene)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)

    def loss(alb_, emi_):
        img_sum, _ = render_pallas_mat(scene, cam, cfg, alb_, emi_, 3)
        img = img_sum / cfg.spp
        return float(jnp.mean((img - target) ** 2))

    img_sum, _ = render_pallas_mat(scene, cam, cfg, alb, emi, 3)
    img = img_sum / cfg.spp
    g_img = (img - target) * (2.0 / (img.size * cfg.spp))
    galb, gemi = render_pallas_vjp(scene, cam, cfg, alb, emi, 3, g_img)

    h = 1e-3
    # Light emission (obj 6, ch 0) and a wall albedo (obj 2 green, ch 0 —
    # a NON-max channel: perturbing the max channel shifts the RR survival
    # threshold, a discrete effect FD sees but pathwise gradients exclude
    # by design; the RR 1/p term itself is validated against the jnp
    # adjoint in test_vjp_matches_jnp_adjoint).
    for table, gtab, idx in [
        (emi, gemi, (6, 0)),
        (alb, galb, (2, 0)),
    ]:
        tp = table.at[idx].add(h)
        tm = table.at[idx].add(-h)
        if table is emi:
            fd = (loss(alb, tp) - loss(alb, tm)) / (2 * h)
        else:
            fd = (loss(tp, emi) - loss(tm, emi)) / (2 * h)
        g = float(gtab[idx])
        assert abs(fd - g) < 2e-2 * max(abs(fd), abs(g), 1e-6), (
            idx, fd, g
        )


def test_fit_pallas_recovers_emission():
    """Kernel-path inverse rendering: recover a brighter light from its
    render. Materials are runtime inputs — no per-step recompile."""
    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = RenderConfig(width=16, height=12, spp=8, estimator="nee", seed=5,
                       max_bounces=8)
    bright = scene._replace(
        rects=scene.rects._replace(emission=scene.rects.emission * 1.5)
    )
    img_sum, _ = render_pallas(bright, cam, cfg, 9)
    target = img_sum / cfg.spp

    fitted, losses = fit_pallas(
        scene, cam, cfg, target, steps=12, lr=8.0,
        train_fields=("emission",), seed=5, )
    assert losses[-1] < 0.65 * losses[0], losses
    # The light's emission moved toward 18 (= 12 * 1.5).
    e0 = float(np.asarray(scene.rects.emission)[6, 0])
    e1 = float(np.asarray(fitted.rects.emission)[6, 0])
    assert e1 > e0 + 1.0, (e0, e1)


def test_sharded_material_step_loss_on_sample_mesh():
    """Regression: on a pixel x SAMPLE mesh (n_dp > 1) the sharded step's
    loss must equal the single-device loss. The per-device partial loss
    is already replicated along the sample axis (it is built from the
    sample-psum'd image), so the reduction must psum the pixel axis ONLY
    — the previous AXIS_PIXEL-psum / n_dp under-counted by n_dp."""
    from small_pathtracer_tpu.ops.megakernel_grad import (
        loss_and_material_grads,
        material_train_step_sharded,
        pack_materials,
    )
    from small_pathtracer_tpu.parallel.mesh import make_mesh

    devices = jax.devices()
    if len(devices) < 8:
        pytest.skip("needs the 8-device CPU mesh (tests/conftest.py)")
    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = RenderConfig(width=24, height=16, spp=8, estimator="nee",
                       max_bounces=4)
    target = np.zeros((16, 24, 3), np.float32)
    loss_1, galb_1, gemi_1 = loss_and_material_grads(
        scene, cam, cfg, jnp.uint32(3), target)
    alb, emi = pack_materials(scene)
    for shape in ((8, 1), (4, 2)):
        mesh = make_mesh(devices[:8], mesh_shape=shape)
        step = material_train_step_sharded(scene, cam, cfg, mesh, target)
        loss_s, galb_s, gemi_s = step(alb, emi, 3)
        assert abs(float(loss_s) - float(loss_1)) < 1e-5, shape
        np.testing.assert_allclose(np.asarray(galb_s),
                                   np.asarray(galb_1), atol=1e-5)
        np.testing.assert_allclose(np.asarray(gemi_s),
                                   np.asarray(gemi_1), atol=1e-5)


def test_material_grads_to_scene_shape():
    scene = get_scene("cornell_box")
    alb, emi = pack_materials(scene)
    g = material_grads_to_scene(scene, alb * 0 + 1, emi * 0 + 2)
    assert float(np.asarray(g.rects.albedo).min()) == 1.0
    assert float(np.asarray(g.rects.emission).max()) == 2.0
    np.testing.assert_array_equal(np.asarray(g.rects.k),
                                  np.zeros_like(np.asarray(scene.rects.k)))
