"""Tests that need the card (marker ``gpu``): the kernels compiled by the
GPU compiler, run, and compared with the jnp paths. On the CPU the
``gpu_device`` fixture skips them; ``python chip_smoke.py`` runs them on
the GPU (``pytest -m gpu tests/``)."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
from small_pathtracer_tpu.integrator.wavefront import render_regen
from small_pathtracer_tpu.ops import megakernel as mk
from small_pathtracer_tpu.ops import route

pytestmark = pytest.mark.gpu


def test_route_is_triton(gpu_device):
    assert route.platform() == "gpu"
    assert route.pallas_call_kwargs()["backend"] == "triton"
    assert route.block_lanes() == route.GPU_BLOCK_LANES


@pytest.mark.parametrize("scene_name,est,tab", [
    ("cornell_box", "nee", "auto"),
    ("cornell_box", "mis", "auto"),
    ("cornell_twolights", "nee_textbook", "auto"),
    ("smallpt_original", "cosine", "auto"),
    ("sphere_grid", "nee", "on"),
])
def test_forward_kernel_on_gpu_matches_jnp(gpu_device, scene_name, est,
                                           tab):
    """The compiled kernel (Triton custom call in the HLO) agrees with
    the jnp wavefront: same per-sample RNG, differences only from FMA
    contraction flips (statistical on sphere scenes)."""
    scene = get_scene(scene_name)
    cam = make_camera()
    cfg = RenderConfig(width=64, height=64, spp=16, estimator=est, seed=5,
                       sphere_table=tab)
    use_tab, _, tables = mk._scene_inputs(scene, cam, cfg)
    run = mk._build_render(scene, cam, cfg, cfg.spp, use_tab)
    hlo = run.lower(jnp.uint32(5), jnp.uint32(0),
                    *tables).compile().as_text()
    assert "xla.gpu.triton" in hlo
    img_k, tr_k = mk.render_pallas(scene, cam, cfg, 5)
    tr_k = mk.trace_totals(tr_k)
    img_j, tr_j = render_regen(scene, cam, cfg, jnp.uint32(5))
    a = np.asarray(img_k) / cfg.spp
    b = np.asarray(img_j) / cfg.spp
    assert np.isfinite(a).all()
    assert abs(a.mean() - b.mean()) < 5e-3
    tk, tj = float(np.sum(tr_k)), float(np.sum(tr_j))
    assert abs(tk - tj) / tj < 2e-2


def test_budgets_and_span_on_gpu(gpu_device):
    """Adaptive-wave and checkpoint-span launchers on the card: uniform
    budgets and two half spans reproduce the full render."""
    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=32, spp=8, estimator="nee", seed=2)
    full, tr = mk.render_pallas(scene, cam, cfg, 2)
    tr = mk.trace_totals(tr)
    n_pix = 32 * 32
    L, tr_b = mk.render_pallas_budgets(
        scene, cam, cfg, 2, np.zeros(n_pix, np.uint32),
        np.full(n_pix, 8, np.uint32))
    tr_b = mk.trace_totals(tr_b)
    np.testing.assert_allclose(np.asarray(L), np.asarray(full).reshape(-1, 3),
                               rtol=1e-5, atol=1e-5)
    h1, _ = mk.render_pallas_span(scene, cam, cfg, 2, 0, 4)
    h2, _ = mk.render_pallas_span(scene, cam, cfg, 2, 4, 4)
    np.testing.assert_allclose(np.asarray(h1) + np.asarray(h2),
                               np.asarray(full), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tr, tr_b)


def test_material_adjoint_on_gpu_matches_jax_grad(gpu_device):
    from small_pathtracer_tpu.grad.adjoint import render_linear
    from small_pathtracer_tpu.ops.megakernel_grad import (
        loss_and_material_grads,
        pack_materials,
    )

    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=24, spp=4, estimator="nee", seed=3,
                       max_bounces=8)
    target = jnp.zeros((24, 32, 3), jnp.float32)
    l_k, ga_k, ge_k = loss_and_material_grads(scene, cam, cfg,
                                              jnp.uint32(3), target)

    def loss(sc):
        img = render_linear(sc, cam, cfg, jnp.uint32(3), 8)
        return jnp.mean((img - target) ** 2)

    l_j, g = jax.value_and_grad(loss, allow_int=True)(scene)
    ga_j, ge_j = pack_materials(g)
    assert abs(float(l_k) - float(l_j)) <= 1e-3 * abs(float(l_j))
    light = int(np.asarray(scene.light.light_obj_id))
    ga_k = np.asarray(ga_k).copy()
    ga_j = np.asarray(ga_j).copy()
    ga_k[light] = ga_j[light] = 0.0
    for k, j in ((ga_k, ga_j), (np.asarray(ge_k), np.asarray(ge_j))):
        assert np.abs(k - j).max() <= 2e-2 * np.abs(j).max()


def test_geometry_adjoint_on_gpu(gpu_device):
    """Finite gradients, and the image-only and full calls of the one
    program see the same paths (the two-call CRN property)."""
    from small_pathtracer_tpu.ops import megakernel_geom as mgeo

    scene = get_scene("cornell_spheres")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=24, spp=4, estimator="nee", seed=3,
                       max_bounces=8, sphere_table="on")
    img0, _, _, _ = mgeo.geom_run(scene, cam, cfg, 3)
    g = np.full((24, 32, 3), 1e-3, np.float32)
    img1, gtab, galb, gemi = mgeo.geom_run(scene, cam, cfg, 3, g)
    np.testing.assert_array_equal(np.asarray(img0), np.asarray(img1))
    for x in (gtab, galb, gemi):
        assert np.isfinite(np.asarray(x)).all()
    assert np.abs(np.asarray(gtab)).max() > 0


def test_sharded_kernel_single_device_mesh(gpu_device):
    from small_pathtracer_tpu.parallel.mesh import make_mesh

    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=32, spp=8, estimator="nee", seed=4)
    mesh = make_mesh(jax.devices()[:1], mesh_shape=(1, 1))
    a, ta = mk.render_pallas(scene, cam, cfg, 4)
    ta = mk.trace_totals(ta)
    b, tb = mk.render_pallas_sharded(scene, cam, cfg, mesh, 4)
    tb = mk.trace_totals(tb)
    np.testing.assert_array_equal(ta, tb)
    np.testing.assert_allclose(np.asarray(b).reshape(32, 32, 3),
                               np.asarray(a), rtol=1e-6, atol=1e-6)
