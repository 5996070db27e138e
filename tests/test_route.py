"""Kernel routing, lane layout and per-block reductions (ops/route.py,
ops/megakernel*.py launchers), on the CPU.

The GPU route is checked here without a GPU by lowering the jitted
launchers for CUDA: the Triton custom call must appear, so every kernel
passes the Triton lowering rules. What the GPU compiler makes of it is
checked on the card (tests/test_gpu.py, chip_smoke.py)."""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
from small_pathtracer_tpu.ops import megakernel as mk
from small_pathtracer_tpu.ops import route


@pytest.mark.parametrize("plat,expect", [
    ("gpu", "triton"),
    ("cpu", "interpret"),
    ("metal", None),
    ("rocm", None),
])
def test_route_choice(plat, expect):
    """gpu -> the named Triton route; cpu -> the interpreter; any other
    backend raises instead of falling back."""
    if expect is None:
        with pytest.raises(RuntimeError, match="no route"):
            route.pallas_call_kwargs(plat)
        with pytest.raises(RuntimeError, match="no route"):
            route.block_lanes(plat)
        return
    kw = route.pallas_call_kwargs(plat)
    if expect == "triton":
        assert kw["backend"] == "triton"
        assert kw["compiler_params"].num_warps == route.GPU_NUM_WARPS
        assert "interpret" not in kw
        assert route.block_lanes(plat) == route.GPU_BLOCK_LANES
    else:
        assert kw == {"interpret": True}
        assert route.block_lanes(plat) == route.CPU_BLOCK_LANES


def test_gpu_block_is_whole_warps():
    """One lane per thread: the GPU block is a power of two and a whole
    number of the block's warps."""
    b = route.GPU_BLOCK_LANES
    assert b & (b - 1) == 0
    assert b == 32 * route.GPU_NUM_WARPS


@pytest.fixture
def as_gpu(monkeypatch):
    """Pretend the backend is a GPU (for lowering only)."""
    monkeypatch.setattr(route, "platform", lambda: "gpu")


def _lowered_for_cuda(fn, *args) -> str:
    return jax.jit(fn).trace(*args).lower(
        lowering_platforms=("cuda",)
    ).as_text()


@pytest.mark.parametrize("scene_name,est,tab", [
    ("cornell_box", "nee", "auto"),
    ("cornell_twolights", "mis", "auto"),
    ("sphere_grid", "nee", "on"),
])
def test_forward_kernel_lowers_to_triton(as_gpu, scene_name, est, tab):
    scene = get_scene(scene_name)
    cam = make_camera()
    cfg = RenderConfig(width=16, height=16, spp=2, estimator=est,
                       sphere_table=tab)
    use_tab, _, tables = mk._scene_inputs(scene, cam, cfg)
    run = mk._build_render(scene, cam, cfg, cfg.spp, use_tab)
    txt = _lowered_for_cuda(run, jnp.uint32(1), jnp.uint32(0), *tables)
    assert txt.count("__gpu$xla.gpu.triton") == 1


def test_adjoint_kernels_lower_to_triton(as_gpu):
    from small_pathtracer_tpu.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu.ops import megakernel_grad as mgrad

    cam = make_camera()
    cfg = RenderConfig(width=16, height=16, spp=2, estimator="nee",
                       max_bounces=4)
    scene = get_scene("cornell_box")
    alb, emi = mgrad.pack_materials(scene)
    g = jnp.zeros((16, 16, 3), jnp.float32)
    txt = _lowered_for_cuda(mgrad._build_vjp(scene, cam, cfg), alb, emi,
                            jnp.uint32(1), g)
    assert txt.count("__gpu$xla.gpu.triton") == 1
    gscene = get_scene("cornell_spheres")
    gcfg = dataclasses.replace(cfg, sphere_table="on")
    ga, ge, packed = mk._sphere_tables(gscene)
    txt = _lowered_for_cuda(mgeo._build_geom_run(gscene, cam, gcfg), ga, ge,
                            packed, jnp.uint32(1), jnp.int32(1), g)
    assert txt.count("__gpu$xla.gpu.triton") == 1


def test_trace_totals_exact_beyond_int32():
    """Per-block i32 counts sum exactly in int64, past 2^31 and 2^24."""
    per_block = np.array([[2**31 - 1, 5], [2**31 - 1, 7], [3, 2**24 + 1]],
                         np.int32)
    tot = mk.trace_totals(per_block)
    assert tot.dtype == np.int64
    assert tot.tolist() == [2**32 + 1, 2**24 + 13]


def test_lane_planes_pad_born_dead(monkeypatch):
    """Padding lanes (past the last live lane, up to a whole block) get
    s_start == s_stop == 0, so they are born dead."""
    monkeypatch.setattr(route, "CPU_BLOCK_LANES", 128)
    cfg = RenderConfig(width=10, height=10, spp=4)
    g, per, n_lanes, n_blocks = mk.lane_layout(100, 4)
    assert n_blocks == -(-n_lanes // 128)
    pix = jnp.repeat(jnp.arange(100, dtype=jnp.uint32), g)
    s_start = jnp.tile(jnp.arange(g, dtype=jnp.uint32) * per, 100)
    planes = mk.lane_planes(cfg, pix, s_start, s_start + per, n_blocks)
    for p in planes:
        assert p.shape == (n_blocks * 128,)
    s0, s1 = np.asarray(planes[3]), np.asarray(planes[4])
    assert (s0[n_lanes:] == 0).all() and (s1[n_lanes:] == 0).all()
    assert (s1[:n_lanes] > s0[:n_lanes]).all()


@pytest.mark.parametrize("block", [64, 256, 4096])
def test_forward_blocks_partition_exactly(monkeypatch, block):
    """Per-block trace rows sum to the same totals, and the image is the
    same, whatever the block size — including sizes that do not divide
    the lane count (the last block is part padding)."""
    scene = get_scene("cornell_box")
    cam = make_camera(aspect=20 / 14)
    cfg = RenderConfig(width=20, height=14, spp=2, estimator="nee", seed=4)
    ref_img, ref_tr = mk.render_pallas(scene, cam, cfg, 4)
    ref_tr = mk.trace_totals(ref_tr)
    monkeypatch.setattr(route, "CPU_BLOCK_LANES", block)
    g, per, n_lanes, n_blocks = mk.lane_layout(20 * 14, 2)
    assert n_blocks == -(-n_lanes // block)
    img, tr = mk.render_pallas(scene, cam, cfg, 4)
    tr = mk.trace_totals(tr)
    np.testing.assert_array_equal(np.asarray(tr), np.asarray(ref_tr))
    np.testing.assert_allclose(np.asarray(img), np.asarray(ref_img),
                               rtol=0, atol=0)


def test_material_grads_blocks_sum_to_totals(monkeypatch):
    """The material adjoint's per-block cotangent rows sum to the same
    gradients at any block size (float summation order only)."""
    from small_pathtracer_tpu.ops import megakernel_grad as mgrad

    scene = get_scene("cornell_box")
    cam = make_camera(aspect=12 / 10)
    cfg = RenderConfig(width=12, height=10, spp=2, estimator="nee",
                       seed=3, max_bounces=6)
    alb, emi = mgrad.pack_materials(scene)
    g = jnp.full((10, 12, 3), 0.01, jnp.float32)
    ref = mgrad.render_pallas_vjp(scene, cam, cfg, alb, emi, 3, g)
    monkeypatch.setattr(route, "CPU_BLOCK_LANES", 32)
    got = mgrad.render_pallas_vjp(scene, cam, cfg, alb, emi, 3, g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-7)


def test_geometry_grads_blocks_sum_to_totals(monkeypatch):
    """Same for the geometry adjoint: sphere-table rows and unrolled
    material rows, any block size."""
    from small_pathtracer_tpu.ops import megakernel_geom as mgeo

    scene = get_scene("cornell_spheres")
    cam = make_camera(aspect=12 / 10)
    cfg = RenderConfig(width=12, height=10, spp=2, estimator="nee",
                       seed=3, max_bounces=4, sphere_table="on")
    g = np.full((10, 12, 3), 0.01, np.float32)
    ref = mgeo.geom_run(scene, cam, cfg, 3, g)
    monkeypatch.setattr(route, "CPU_BLOCK_LANES", 32)
    got = mgeo.geom_run(scene, cam, cfg, 3, g)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)
    gtab = np.asarray(got[1]).reshape(-1, mk.TAB_STRIDE)
    assert (gtab[:, mgeo.G_COLS:] == 0).all()  # pad slots stay zero
