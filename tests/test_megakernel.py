"""Pallas megakernel parity vs the jnp wavefront (interpreter on the CPU).

The box scene must match bit-for-bit-level (identical RNG + identical float
expression trees => identical trace counts); the sphere scene is allowed
statistical-level differences (FMA-contraction rounding flips grazing hits
at sphere silhouettes — documented in ops/megakernel.py)."""

import numpy as np
import pytest

import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
from small_pathtracer_tpu.integrator.wavefront import render_regen
from small_pathtracer_tpu.ops.megakernel import render_pallas, trace_totals


@pytest.mark.parametrize("est", ["nee", "cosine", "uniform", "mixture",
                                 "nee_textbook", "mis"])
def test_box_scene_matches_jnp(est):
    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=24, spp=4, estimator=est, seed=3)
    a, ta = render_regen(scene, cam, cfg, jnp.uint32(3))
    b, tb = render_pallas(scene, cam, cfg, 3)
    tb = trace_totals(tb)
    # Both extend and probe counters must match exactly.
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize(
    "est,sel",
    [("nee", "power"), ("nee", "uniform"), ("nee_textbook", "power"),
     ("mixture", "uniform"), ("mis", "power"), ("mis", "uniform")],
)
def test_twolights_matches_jnp(est, sel):
    """Multi-emitter light-list NEE in the kernel (per-lane inverse-CDF
    selection + chained K-way constant select) vs the jnp wavefront's
    _select_light/gather_light path. Both fire probes from the
    SHADOW_EPS-lifted origin (sampling.SHADOW_EPS), which keeps the
    success test away from the near-coplanar ceiling knife edge — trace
    counts must agree EXACTLY; radiance to f32-rounding tolerance."""
    scene = get_scene("cornell_twolights")
    cam = make_camera(aspect=1.0)
    cfg = RenderConfig(
        width=24, height=24, spp=4, estimator=est, seed=3, light_select=sel
    )
    a, ta = render_regen(scene, cam, cfg, jnp.uint32(3))
    b, tb = render_pallas(scene, cam, cfg, 3)
    tb = trace_totals(tb)
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_allclose(
        np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4
    )


@pytest.mark.parametrize("est", ["nee", "cosine", "nee_textbook"])
def test_box_scene_matches_jnp_sobol(est):
    """Owen-Sobol sampler (cfg.sampler='sobol'): the kernel and the jnp
    wavefront share core/ld.py verbatim, so trace counts match exactly and
    radiance to f32 tolerance — same contract as the hash backend."""
    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=24, spp=4, estimator=est, seed=3,
                       sampler="sobol")
    a, ta = render_regen(scene, cam, cfg, jnp.uint32(3))
    b, tb = render_pallas(scene, cam, cfg, 3)
    tb = trace_totals(tb)
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    # The sobol sequence happens to include one grazing NEE sample whose
    # radiance flips by ~3e-4 with XLA CPU fusion/FMA contraction (the
    # flip appears/disappears with --xla_force_host_platform_device_count
    # — same rounding class as the documented sphere-silhouette caveat).
    # Identical trace counts above pin the path structure; allow isolated
    # rounding outliers in the values.
    a, b = np.asarray(a), np.asarray(b)
    d = np.abs(a - b)
    assert (d < 1e-4).mean() > 0.995, (d < 1e-4).mean()
    assert d.max() < 5e-3, d.max()


def test_sphere_scene_statistical():
    scene = get_scene("cornell_spheres")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=32, spp=16, estimator="nee", seed=3)
    a, _ = render_regen(scene, cam, cfg, jnp.uint32(3))
    b, _ = render_pallas(scene, cam, cfg, 3)
    a = np.asarray(a) / cfg.spp
    b = np.asarray(b) / cfg.spp
    assert abs(a.mean() - b.mean()) < 5e-3
    # The vast majority of per-sample paths are identical (measured 0.945
    # at this config; FMA grazing-hit flips account for the rest — bound
    # left with headroom for compiler/hardware rounding variation).
    same = (np.abs(a - b) < 1e-6).mean()
    assert same > 0.88, same


def test_spec_refr_scene():
    """SPEC mirror + REFR glass (C16) — smallpt_original scene vs jnp."""
    scene = get_scene("smallpt_original")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=32, spp=8, estimator="cosine", seed=5)
    a, ta = render_regen(scene, cam, cfg, jnp.uint32(5))
    b, tb = render_pallas(scene, cam, cfg, 5)
    tb = trace_totals(tb)
    a = np.asarray(a) / cfg.spp
    b = np.asarray(b) / cfg.spp
    assert abs(a.mean() - b.mean()) < 1e-2
    # Measured 0.989 at this config (round 2) — the round-1 0.7 blanket
    # left far too much headroom; 0.93 keeps margin for compiler/hardware
    # rounding variation.
    same = (np.abs(a - b) < 1e-6).mean()
    assert same > 0.93, same


@pytest.mark.parametrize("mesh_shape", [(4, 2), (2, 4)])
def test_sharded_megakernel_matches_single(mesh_shape):
    """Megakernel inside shard_map: identical traces, float-sum-order-level
    image agreement across mesh shapes."""
    from small_pathtracer_tpu.ops.megakernel import render_pallas_sharded
    from small_pathtracer_tpu.parallel.mesh import make_mesh

    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=24, spp=8, estimator="nee", seed=3)
    a, ta = render_pallas(scene, cam, cfg, 3)
    ta = trace_totals(ta)
    mesh = make_mesh(mesh_shape=mesh_shape)
    b, tb = render_pallas_sharded(scene, cam, cfg, mesh, 3)
    tb = trace_totals(tb)
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_allclose(
        np.asarray(a), np.asarray(b).reshape(24, 32, 3), atol=1e-5
    )


def test_tilted_light_quad_scene():
    """Quad primitive in the kernel: tilted-light preset vs jnp."""
    scene = get_scene("cornell_tilted_light")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=32, spp=8, estimator="nee", seed=1)
    a, ta = render_regen(scene, cam, cfg, jnp.uint32(1))
    b, tb = render_pallas(scene, cam, cfg, 1)
    tb = trace_totals(tb)
    a = np.asarray(a) / cfg.spp
    b = np.asarray(b) / cfg.spp
    # Gram-solve rounding differs (reciprocal-multiply constants), so
    # statistical-level agreement like the sphere scenes.
    assert abs(a.mean() - b.mean()) < 1e-2
    assert abs(float(ta.sum()) - float(tb.sum())) / float(ta.sum()) < 1e-3


def test_max_bounces_cap_consistent_across_schedules():
    """All three schedules truncate at cfg.max_bounces identically
    (per-path cap == the scan wave cap since scan lanes share depth)."""
    scene = get_scene("cornell_box")
    cam = make_camera()
    import dataclasses

    base = RenderConfig(width=16, height=16, spp=4, estimator="cosine",
                        seed=9, max_bounces=6)
    import small_pathtracer_tpu as spt

    a, ta = spt.render(scene, cam, dataclasses.replace(base, wavefront="scan"))
    b, tb = spt.render(scene, cam, dataclasses.replace(base, wavefront="regen"))
    c, tc = render_pallas(scene, cam, base, base.seed)
    tc = trace_totals(tc)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-5)
    assert ta == tb == float(tc.sum())
    # And the cap bites: uncapped render differs.
    d, td = spt.render(
        scene, cam, dataclasses.replace(base, max_bounces=256)
    )
    assert td > tb


def test_sphere_grid_scalability():
    """71-object scene (walls + light + 64 spheres incl. mirrors): the jnp
    path scales O(N); the kernel takes it through the looped sphere table
    (sphere_table="auto" switches at 48 spheres — TestSphereTable); both
    agree."""
    scene = get_scene("sphere_grid")
    from small_pathtracer_tpu.scene.types import num_objects

    assert num_objects(scene) == 7 + 64
    cam = make_camera()
    cfg = RenderConfig(width=24, height=24, spp=4, estimator="nee", seed=4)
    a, ta = render_regen(scene, cam, cfg, jnp.uint32(4))
    b, tb = render_pallas(scene, cam, cfg, 4)
    tb = trace_totals(tb)
    a = np.asarray(a) / cfg.spp
    b = np.asarray(b) / cfg.spp
    assert np.all(np.isfinite(a)) and np.all(np.isfinite(b))
    assert abs(a.mean() - b.mean()) < 1e-2
    # 64 spheres => many grazing hits; FMA-rounding path flips are ~0.5%
    # of traces here (vs ~0 for the box scene).
    assert abs(float(ta.sum()) - float(tb.sum())) / float(ta.sum()) < 2e-2


def test_packed_rng_backend_matches_jnp_and_is_unbiased():
    """rng_backend="mix_packed" (one hash -> two 16-bit draws, the PERF.md
    headroom experiment): kernel and jnp wavefront stay bit-identical on
    the box scene, and the estimate agrees statistically with the default
    backend (independent streams, same estimator)."""
    scene = get_scene("cornell_box")
    cam = make_camera()
    cfg = RenderConfig(width=32, height=24, spp=8, estimator="nee", seed=3,
                       rng_backend="mix_packed")
    a, ta = render_regen(scene, cam, cfg, jnp.uint32(3))
    b, tb = render_pallas(scene, cam, cfg, 3)
    tb = trace_totals(tb)
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-4,
                               atol=1e-4)
    cfg_mix = RenderConfig(width=32, height=24, spp=64, estimator="nee",
                           seed=3)
    cfg_pk = RenderConfig(width=32, height=24, spp=64, estimator="nee",
                          seed=3, rng_backend="mix_packed")
    m, _ = render_regen(scene, cam, cfg_mix, jnp.uint32(3))
    p, _ = render_regen(scene, cam, cfg_pk, jnp.uint32(3))
    m = np.asarray(m) / 64
    p = np.asarray(p) / 64
    assert abs(m.mean() - p.mean()) < 5e-3, (m.mean(), p.mean())


def test_nee_textbook_ignores_glibc_mode():
    """Regression (round-1 advisor finding): with estimator=nee_textbook +
    light_sample_mode=glibc_overflow the kernel used to apply the glibc
    corner-patch offset to the textbook shadow ray while the jnp path used
    the intended full-area sampler (image means 2.85 vs 1.73 on a tiny
    render, and a statistically biased kernel estimate). Both paths must
    use the intended sampler for the textbook direct term."""
    cam = make_camera()
    scene = get_scene("cornell_box")
    cfg_g = RenderConfig(width=16, height=12, spp=4,
                         estimator="nee_textbook", seed=3,
                         light_sample_mode="glibc_overflow")
    a, ta = render_regen(scene, cam, cfg_g, jnp.uint32(3))
    b, tb = render_pallas(scene, cam, cfg_g, 3)
    tb = trace_totals(tb)
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)
    # And the mode is a no-op for the textbook estimator.
    cfg_i = RenderConfig(width=16, height=12, spp=4,
                         estimator="nee_textbook", seed=3,
                         light_sample_mode="intended")
    c, _ = render_regen(scene, cam, cfg_i, jnp.uint32(3))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(c))


def test_nee_textbook_kernel_matches_jnp():
    """Unbiased shadow-ray NEE on the kernel path: bit-exact on the box
    scene, statistical on spheres (grazing-hit divergence)."""
    cam = make_camera()
    cfg = RenderConfig(width=32, height=24, spp=4, estimator="nee_textbook",
                       seed=3)
    scene = get_scene("cornell_box")
    a, ta = render_regen(scene, cam, cfg, jnp.uint32(3))
    b, tb = render_pallas(scene, cam, cfg, 3)
    tb = trace_totals(tb)
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-3)


@pytest.mark.parametrize(
    "preset,est,lsm",
    [("cornell_box", "nee", "intended"),
     ("cornell_box", "nee", "glibc_overflow"),
     ("cornell_box", "mixture", "intended"),
     ("cornell_twolights", "nee", "intended"),
     ("cornell_spheres", "nee", "intended")],
)
def test_nee_fold_bit_identical(preset, est, lsm, monkeypatch):
    """The NEE continuation fold (ops/megakernel.build_kernel: a successful
    probe + zero-albedo light resolve the next bounce analytically) is a
    pure scheduling optimization: image AND both trace counters must be
    bit-identical with the fold disabled."""
    scene = get_scene(preset)
    cam = make_camera(aspect=32 / 24)
    cfg = RenderConfig(width=32, height=24, spp=4, estimator=est, seed=5,
                       light_sample_mode=lsm)
    a, ta = render_pallas(scene, cam, cfg, 5)
    ta = trace_totals(ta)
    monkeypatch.setenv("SPT_NO_NEE_FOLD", "1")
    b, tb = render_pallas(scene, cam, cfg, 5)
    tb = trace_totals(tb)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))


class TestSphereTable:
    """Scalable-scene mode: the megakernel's looped runtime sphere table
    (build_kernel sphere_tab=True) vs full unrolling. Same estimator,
    same scan order; equality is statistical — the compiler contracts the
    sphere discriminant differently for baked constants vs loop scalars
    (FMA), and grazing hits amplify that to ~30 ulps of t (measured; see
    build_kernel docstring)."""

    def test_trace_contract_vs_unrolled(self):
        """Random-ray fuzz of the nearest-hit itself: every DISCRETE field
        (hit/is_light/is_spec/is_refr and the winning object's materials)
        must agree exactly; t agrees to FMA-level relative tolerance; the
        probe (any-occluder chain) agrees exactly on success."""
        from small_pathtracer_tpu.ops import megakernel as mk

        scene = get_scene("sphere_grid")
        rects, quads, spheres, _, _ = mk._scene_consts(scene)
        alb, emi, packed = mk._sphere_tables(scene)
        base = len(rects) + len(quads)
        rng = np.random.default_rng(0)
        N = 20000
        o = rng.uniform([2, 1, 1], [98, 80, 169], (N, 3)).astype(np.float32)
        d = rng.normal(size=(N, 3)).astype(np.float32)
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ox, oy, oz = (jnp.asarray(o[:, i]) for i in range(3))
        dx, dy, dz = (jnp.asarray(d[:, i]) for i in range(3))
        # The kernel ships ONE flat packed per-sphere table
        # (_sphere_tables); mirror that here.
        tab = (packed, len(spheres), base)

        import jax

        @jax.jit
        def both():
            A = mk._trace_unrolled(rects, quads, spheres, 6,
                                   ox, oy, oz, dx, dy, dz,
                                   want_shading=True, want_obj=True)
            B = mk._trace_unrolled(rects, quads, [], 6,
                                   ox, oy, oz, dx, dy, dz,
                                   want_shading=True, want_obj=True,
                                   sphere_tab=tab)
            PA = mk._probe_unrolled(rects, quads, spheres, 6,
                                    ox, oy, oz, dx, dy, dz)
            PB = mk._probe_unrolled(rects, quads, [], 6,
                                    ox, oy, oz, dx, dy, dz, sphere_tab=tab)
            return A, B, PA, PB

        A, B, (ta, sa), (tb, sb) = both()
        for k in ("hit", "is_light", "is_spec", "is_refr", "obj"):
            np.testing.assert_array_equal(
                np.asarray(A[k]), np.asarray(B[k]), err_msg=k
            )
        for k in ("alb", "emi"):
            for c in range(3):
                np.testing.assert_array_equal(
                    np.asarray(A[k][c]), np.asarray(B[k][c]), err_msg=k
                )
        np.testing.assert_allclose(
            np.asarray(A["t"]), np.asarray(B["t"]), rtol=2e-4
        )
        # Winner normals: identical where the winner is not a table sphere,
        # and FMA-level close on table-sphere wins.
        for c in range(3):
            np.testing.assert_allclose(
                np.asarray(A["nrm"][c]), np.asarray(B["nrm"][c]), atol=2e-3
            )
        np.testing.assert_array_equal(np.asarray(sa), np.asarray(sb))
        np.testing.assert_allclose(np.asarray(ta), np.asarray(tb), rtol=2e-4)

    @pytest.mark.parametrize("est", ["nee", "nee_textbook"])
    def test_render_matches_unrolled_statistically(self, est):
        import dataclasses

        scene = get_scene("sphere_grid")
        cam = make_camera()
        cfg = RenderConfig(width=16, height=16, spp=2, estimator=est,
                           seed=4, sphere_table="off")
        a, ta = render_pallas(scene, cam, cfg, 4)
        ta = trace_totals(ta)
        b, tb = render_pallas(
            scene, cam, dataclasses.replace(cfg, sphere_table="on"), 4,
        )
        tb = trace_totals(tb)
        a = np.asarray(a) / cfg.spp
        b = np.asarray(b) / cfg.spp
        # Identical estimator + RNG: only FMA-level grazing-hit path flips
        # differ. Nearly all pixels bitwise equal, the rest MC-close.
        frac_ident = (a == b).all(axis=-1).mean()
        assert frac_ident > 0.9, frac_ident
        assert abs(a.mean() - b.mean()) < 2e-3
        assert np.abs(a - b).max() < 0.1
        ta, tb = np.asarray(ta), np.asarray(tb)
        assert np.abs(ta - tb).sum() / ta.sum() < 5e-3

    def test_no_recompile_on_geometry_or_material_edit(self):
        """The whole point of the table: moving/recoloring spheres reuses
        the compiled kernel (the build cache key hashes only the
        structure), and the output tracks the edit."""
        from small_pathtracer_tpu.ops import megakernel as mk

        scene = get_scene("sphere_grid")
        cam = make_camera()
        cfg = RenderConfig(width=8, height=8, spp=1, estimator="nee",
                           seed=1, sphere_table="on")
        a, _ = render_pallas(scene, cam, cfg, 1)
        n_built = len(mk._CACHE)
        moved = scene._replace(spheres=scene.spheres._replace(
            center=scene.spheres.center + jnp.asarray([0.0, 3.0, 0.0]),
            radius=scene.spheres.radius * 1.3,
            albedo=scene.spheres.albedo * 0.5,
        ))
        b, _ = render_pallas(moved, cam, cfg, 1)
        assert len(mk._CACHE) == n_built  # cache hit: no new build
        assert np.abs(np.asarray(a) - np.asarray(b)).max() > 1e-3

    def test_auto_threshold_and_validation(self):
        from small_pathtracer_tpu.ops.megakernel import (
            _use_sphere_table,
            build_kernel,
        )

        cam = make_camera()
        few = get_scene("cornell_spheres")
        many = get_scene("sphere_grid")
        cfg = RenderConfig(width=8, height=8, spp=1)
        assert not _use_sphere_table(few, cfg)
        assert _use_sphere_table(many, cfg)
        import dataclasses

        assert _use_sphere_table(
            few, dataclasses.replace(cfg, sphere_table="on"))
        assert not _use_sphere_table(
            many, dataclasses.replace(cfg, sphere_table="off"))
        with pytest.raises(ValueError, match="mat_refs"):
            build_kernel(many, cam, cfg, sphere_tab=True)

    def test_auto_falls_back_when_table_incompatible(self):
        """auto mode must NOT select the table for scenes that violate the
        build constraints (ADVICE r3): a GLOS sphere above the threshold
        renders via the unrolled path instead of hard-erroring; explicit
        "on" still errors with the diagnostic."""
        import dataclasses

        from small_pathtracer_tpu.ops.megakernel import (
            _use_sphere_table,
            build_kernel,
        )

        cam = make_camera()
        many = get_scene("sphere_grid")
        cfg = RenderConfig(width=8, height=8, spp=1, estimator="cosine")
        # Make one sphere glossy: table now incompatible.
        glos = many._replace(spheres=many.spheres._replace(
            refl=many.spheres.refl.at[0].set(3)))
        assert _use_sphere_table(many, cfg)
        assert not _use_sphere_table(glos, cfg)
        with pytest.raises(ValueError, match="GLOS"):
            build_kernel(glos, cam,
                         dataclasses.replace(cfg, sphere_table="on"),
                         mat_refs=True, sphere_tab=True)
        # A light-list entry pointing at a table sphere is rejected with a
        # clear message, not a downstream IndexError (ADVICE r3 #2).
        from small_pathtracer_tpu.scene.types import LightList

        base = (int(np.asarray(many.rects.k).shape[0])
                + int(np.asarray(many.quads.corner).shape[0]))
        ll = LightList(
            obj_id=jnp.asarray([base], jnp.int32),
            corner=jnp.zeros((1, 3), jnp.float32),
            edge_u=jnp.eye(3, dtype=jnp.float32)[:1],
            edge_v=jnp.eye(3, dtype=jnp.float32)[1:2],
        )
        bad = many._replace(lights=ll)
        assert not _use_sphere_table(bad, cfg)
        with pytest.raises(ValueError, match="light-list"):
            build_kernel(bad, cam, cfg, mat_refs=True, sphere_tab=True)

    def test_large_scene_renders(self):
        """256 spheres through the table: finite image, light visible, and
        the jnp wavefront agrees statistically (same estimator + RNG)."""
        scene = get_scene("sphere_grid_256")
        cam = make_camera()
        cfg = RenderConfig(width=12, height=12, spp=2, estimator="nee",
                           seed=2, sphere_table="on")
        img, traces = render_pallas(scene, cam, cfg, 2)
        traces = trace_totals(traces)
        img = np.asarray(img) / cfg.spp
        assert np.isfinite(img).all()
        a, ta = render_regen(scene, cam, cfg, jnp.uint32(2))
        a = np.asarray(a) / cfg.spp
        assert abs(a.mean() - img.mean()) < 2e-2
        t_jnp = float(np.asarray(ta).sum())
        t_tab = float(np.asarray(traces).sum())
        assert abs(t_tab - t_jnp) / t_jnp < 2e-2

    def test_sharded_table_matches_single(self):
        """Table kernel inside shard_map (multi-chip scalable scenes):
        tables replicate on every device; image and trace counts match
        the single-device table render (same kernel program => same FMA
        choices; only float sum order differs)."""
        from small_pathtracer_tpu.ops.megakernel import render_pallas_sharded
        from small_pathtracer_tpu.parallel.mesh import make_mesh

        scene = get_scene("sphere_grid")
        cam = make_camera()
        cfg = RenderConfig(width=16, height=16, spp=4, estimator="nee",
                           seed=5, sphere_table="on")
        a, ta = render_pallas(scene, cam, cfg, 5)
        ta = trace_totals(ta)
        mesh = make_mesh(mesh_shape=(4, 2))
        b, tb = render_pallas_sharded(scene, cam, cfg, mesh, 5)
        tb = trace_totals(tb)
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b).reshape(16, 16, 3), atol=1e-5
        )

    def test_budgets_table_matches_full_render(self):
        """Adaptive-wave runner in table mode: uniform budgets [0, spp)
        reproduce the plain table render (per-sample purity — only the
        lane schedule differs)."""
        from small_pathtracer_tpu.ops.megakernel import render_pallas_budgets

        scene = get_scene("sphere_grid")
        cam = make_camera()
        cfg = RenderConfig(width=12, height=12, spp=4, estimator="nee",
                           seed=6, sphere_table="on")
        a, ta = render_pallas(scene, cam, cfg, 6)
        ta = trace_totals(ta)
        n_pix = cfg.width * cfg.height
        L, tb = render_pallas_budgets(
            scene, cam, cfg, 6,
            np.zeros(n_pix, np.uint32),
            np.full(n_pix, cfg.spp, np.uint32),
        )
        tb = trace_totals(tb)
        np.testing.assert_allclose(
            np.asarray(a).reshape(n_pix, 3), np.asarray(L),
            rtol=1e-5, atol=1e-5,
        )
        np.testing.assert_allclose(np.asarray(ta), np.asarray(tb), rtol=5e-3)

    def test_checkpoint_spans_compose_with_table(self, tmp_path):
        """Span rendering (the --checkpoint/--preview unit) through the
        table kernel: chunked spans sum to the full render."""
        from small_pathtracer_tpu.utils.checkpoint import (
            render_with_checkpoints,
        )

        scene = get_scene("sphere_grid")
        cam = make_camera()
        cfg = RenderConfig(width=12, height=12, spp=4, estimator="nee",
                           seed=8, use_pallas=True, sphere_table="on")
        img1, tr1 = render_with_checkpoints(
            scene, cam, cfg, str(tmp_path / "a.ckpt"), 0
        )
        img2, tr2 = render_with_checkpoints(
            scene, cam, cfg, str(tmp_path / "b.ckpt"), 2
        )
        np.testing.assert_allclose(
            np.asarray(img1), np.asarray(img2), rtol=2e-5, atol=2e-6
        )
        assert tr1 == pytest.approx(tr2, rel=1e-6)
