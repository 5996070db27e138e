"""Spherical emitters (round-4 VERDICT item 3): cone-sampled NEE.

Covers the full contract:
- chi-square on the cone sampler (uniform in solid angle within the cone);
- analytic direct-lighting exactness (sin^2 theta_max closed form);
- estimator cross-consistency on the sphere-light presets
  (cosine / nee / nee_textbook / mis converge to the same image);
- the front-side gate (no light transmitted through a tangent wall);
- kernel-vs-jnp parity (interpret mode) on both new presets;
- FD-vs-adjoint gradients for the sphere light's emission and center
  (jnp adjoint: jax.grad through path_trace_fixed);
- mixed-kind LightList (rect + sphere) consistency.

Reference lineage: the round ceiling light of the committed historic
renders (/root/reference/image_32pps_totalrandom.ppm et al., SURVEY.md
section 4.2) and original smallpt's rad-600 sky sphere (the commented
sphere heritage at /root/reference/src/smallpt.cpp:297-298).
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import small_pathtracer_tpu as spt
from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
from small_pathtracer_tpu.geometry.intersect import trace
from small_pathtracer_tpu.integrator import sampling
from small_pathtracer_tpu.integrator.wavefront import (
    path_trace_fixed, render_regen,
)
from small_pathtracer_tpu.scene.types import (
    DIFF, LIGHT_RECT, LIGHT_SPHERE, LightList, LightSampler, Scene,
    SphereLight, make_scene,
)
from small_pathtracer_tpu.ops.megakernel import trace_totals


class TestConeSampler:
    def test_chi_square_uniform_in_cone(self):
        """sample_sphere_dir is uniform in solid angle within the cone:
        cos(theta) uniform on [cos_max, 1], phi uniform on [0, 2pi)."""
        center = jnp.asarray([0.0, 10.0, 0.0])
        radius = jnp.asarray(4.0)
        n = 200000
        x = jnp.zeros((n, 3))
        rng = np.random.default_rng(0)
        u1 = jnp.asarray(rng.uniform(size=n), jnp.float32)
        u2 = jnp.asarray(rng.uniform(size=n), jnp.float32)
        d = np.asarray(
            sampling.sample_sphere_dir(center, radius, x, u1, u2)
        )
        _, cos_max, _ = sampling.sphere_cone(center, radius, x)
        cos_max = float(np.asarray(cos_max)[0])
        cos_t = d[:, 1]  # axis = +y
        assert cos_t.min() >= cos_max - 1e-5
        # chi-square on 20 equal-probability cos bins x 8 phi bins.
        kc, kp = 20, 8
        cbin = np.clip(
            ((1.0 - cos_t) / (1.0 - cos_max) * kc).astype(int), 0, kc - 1
        )
        phi = np.arctan2(d[:, 2], d[:, 0])
        pbin = np.clip(((phi + math.pi) / (2 * math.pi) * kp).astype(int),
                       0, kp - 1)
        counts = np.bincount(cbin * kp + pbin, minlength=kc * kp)
        expected = n / (kc * kp)
        chi2 = ((counts - expected) ** 2 / expected).sum()
        dof = kc * kp - 1
        # 99.9th percentile of chi2(159) ~ 228.
        assert chi2 < 230, chi2

    def test_pdf_inv_matches_solid_angle(self):
        """pdf_inv = 2 pi (1 - cos_max) = the cone's solid angle."""
        center = jnp.asarray([0.0, 50.0, 0.0])
        x = jnp.zeros((1, 3))
        for r in (5.0, 25.0, 49.0):
            _, cm, pdf_inv = sampling.sphere_cone(
                center, jnp.asarray(r), x
            )
            want = 2 * math.pi * (1 - math.sqrt(1 - (r / 50.0) ** 2))
            np.testing.assert_allclose(
                float(pdf_inv[0]), want, rtol=1e-5
            )

    def test_inside_sphere_degrades_to_uniform(self):
        center = jnp.asarray([0.0, 1.0, 0.0])
        x = jnp.zeros((1, 3))
        _, cm, pdf_inv = sampling.sphere_cone(center, jnp.asarray(5.0), x)
        assert float(cm[0]) == -1.0
        np.testing.assert_allclose(float(pdf_inv[0]), 4 * math.pi,
                                   rtol=1e-6)

    def test_direct_lighting_analytic(self):
        """Unoccluded sphere light overhead: one-sample NEE estimate of
        direct radiance equals albedo * Le * sin^2(theta_max)."""
        rects = [(1, 0.0, (-1e3, -1e3), (1e3, 1e3), (0.7, 0.7, 0.7),
                  (0, 0, 0), DIFF)]
        spheres = [((0.0, 50.0, 0.0), 10.0, (0, 0, 0), (5.0, 5.0, 5.0),
                    DIFF)]
        light = SphereLight(
            center=jnp.asarray([0.0, 50.0, 0.0]),
            radius=jnp.asarray(10.0),
            light_obj_id=jnp.asarray(1, jnp.int32),
        )
        scene = make_scene(rects, spheres, light)
        n = 100000
        x = jnp.zeros((n, 3))
        nl = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
        rng = np.random.default_rng(1)
        u1 = jnp.asarray(rng.uniform(size=n), jnp.float32)
        u2 = jnp.asarray(rng.uniform(size=n), jnp.float32)
        d = sampling.sample_sphere_dir(light.center, light.radius, x, u1, u2)
        h = trace(scene, x + 1e-3 * nl, d)
        succ = np.asarray(h.hit & (h.obj_id == 1))
        w = np.asarray(sampling.sphere_nee_weight(
            light.center, light.radius, x, d, nl
        ))
        est = (succ * w).mean() * 0.7 * 5.0
        want = 0.7 * 5.0 * (10.0 / 50.0) ** 2
        np.testing.assert_allclose(est, want, rtol=2e-3)


class TestEstimatorConsistency:
    @pytest.mark.parametrize("preset", ["cornell_spheres_roundlight",
                                        "smallpt_original_true"])
    def test_estimators_agree_unclamped(self, preset):
        """nee / nee_textbook / mis / cosine converge to the same
        unclamped mean — the front-side gate and fallback suppression
        keep the sphere-light continuation unbiased (without them,
        smallpt_original_true's nee blows up ~6x)."""
        scene = get_scene(preset)
        cam = make_camera()
        means = {}
        for est in ("nee", "nee_textbook", "mis", "cosine"):
            cfg = RenderConfig(width=32, height=32, spp=96, estimator=est,
                               seed=11)
            img, _ = render_regen(scene, cam, cfg, jnp.uint32(11))
            means[est] = float(np.asarray(img).mean()) / cfg.spp
        ref = means["nee_textbook"]
        for est, m in means.items():
            assert abs(m - ref) / ref < 0.08, (means, est)

    def test_no_light_through_tangent_wall(self):
        """A closed box whose ceiling is tangent-grazed by a huge sphere
        light OUTSIDE it must stay pitch black (the front-side gate;
        without it the cone sampler shines through the ceiling)."""
        # Closed 20-unit box of rects; light sphere far above, tangent
        # to the ceiling plane.
        rects = [
            (2, 0.0, (0.0, 0.0), (20.0, 20.0), (0.75,) * 3, (0,) * 3, DIFF),
            (2, 20.0, (0.0, 0.0), (20.0, 20.0), (0.75,) * 3, (0,) * 3, DIFF),
            (0, 0.0, (0.0, 0.0), (20.0, 20.0), (0.75,) * 3, (0,) * 3, DIFF),
            (0, 20.0, (0.0, 0.0), (20.0, 20.0), (0.75,) * 3, (0,) * 3, DIFF),
            (1, 0.0, (0.0, 0.0), (20.0, 20.0), (0.75,) * 3, (0,) * 3, DIFF),
            (1, 20.0, (0.0, 0.0), (20.0, 20.0), (0.75,) * 3, (0,) * 3, DIFF),
        ]
        spheres = [((10.0, 520.1, 10.0), 500.0, (0, 0, 0),
                    (12.0, 12.0, 12.0), DIFF)]
        light = SphereLight(
            center=jnp.asarray([10.0, 520.1, 10.0]),
            radius=jnp.asarray(500.0),
            light_obj_id=jnp.asarray(6, jnp.int32),
        )
        scene = make_scene(rects, spheres, light)
        # Camera is outside this box; trace the estimator directly from
        # interior points instead of rendering.
        n = 4096
        rng = np.random.default_rng(3)
        o = jnp.asarray(
            np.stack([rng.uniform(1, 19, n), rng.uniform(1, 19, n),
                      rng.uniform(1, 19, n)], 1), jnp.float32)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        cfg = RenderConfig(width=8, height=8, spp=1, estimator="nee",
                           seed=3)
        L, _ = path_trace_fixed(
            scene, cfg, jnp.uint32(3), o, jnp.asarray(d, jnp.float32),
            jnp.arange(n, dtype=jnp.uint32), n_bounces=12,
        )
        assert float(jnp.max(L)) == 0.0


class TestKernelParity:
    @pytest.mark.parametrize(
        "preset,est",
        [("cornell_spheres_roundlight", "nee"),
         ("cornell_spheres_roundlight", "nee_textbook"),
         ("cornell_spheres_roundlight", "mis"),
         ("cornell_spheres_roundlight", "mixture"),
         ("smallpt_original_true", "nee"),
         ("smallpt_original_true", "mis")],
    )
    def test_kernel_matches_jnp(self, preset, est):
        """Megakernel sphere-light branch vs the jnp wavefront: identical
        trace counts (path structure is bit-identical), radiance to the
        sphere-scene FMA tolerance (ops/megakernel.py docstring)."""
        from small_pathtracer_tpu.ops.megakernel import render_pallas

        scene = get_scene(preset)
        cam = make_camera()
        cfg = RenderConfig(width=24, height=24, spp=4, estimator=est,
                           seed=3)
        a, ta = render_regen(scene, cam, cfg, jnp.uint32(3))
        b, tb = render_pallas(scene, cam, cfg, 3)
        tb = trace_totals(tb)
        # Trace counts: near-exact. Sphere-light scenes admit isolated
        # +-1 path-structure flips (observed: 1 sample in 2304 at
        # roundlight/nee): XLA fuses the jnp cone math with FMA
        # contraction while interpret-mode Pallas executes op-by-op, and
        # a cone sample that grazes the light's silhouette can flip its
        # probe success on that last ulp — the same rounding class as
        # the documented sphere-silhouette FMA gap (ops/megakernel.py).
        # Bound: 0.25% of each counter (giant-sphere scenes hit more
        # knife-edge geometry per path — observed 11/8545 on
        # smallpt_original_true).
        ta, tb = np.asarray(ta), np.asarray(tb)
        assert np.abs(ta - tb).max() <= max(3.0, 0.0025 * ta.sum()), (ta, tb)
        a, b = np.asarray(a), np.asarray(b)
        d = np.abs(a - b)
        # Each flipped path owns one pixel at spp=4; allow the flip
        # budget above (~2% of pixels on the giant-sphere scene), with
        # everything else bit-close.
        assert (d < 1e-3).mean() > 0.96, (d < 1e-3).mean()
        assert np.median(d) < 1e-5, np.median(d)

    @pytest.mark.parametrize("est,sel", [
        ("nee", "power"), ("nee_textbook", "power"),
        ("mis", "power"), ("mixture", "uniform"),
    ])
    def test_kernel_mixed_list_matches_jnp(self, est, sel):
        """Mixed rect+sphere light LISTS in the kernel (round-5 late
        addition — removes the list waiver): per-lane kind select routes
        sphere rows through _cone_sample_kernel; the selection CDF uses
        4*pi*r^2 sphere areas like light_select_probs; suppression hits
        sphere rows only. Must match the jnp wavefront like the other
        sphere-light configs (near-exact traces, pixels bit-close)."""
        from small_pathtracer_tpu.ops.megakernel import render_pallas

        scene = _mixed_list_scene()
        cam = make_camera()
        cfg = RenderConfig(width=24, height=24, spp=4, estimator=est,
                           seed=3, light_select=sel)
        a, ta = render_regen(scene, cam, cfg, jnp.uint32(3))
        b, tb = render_pallas(scene, cam, cfg, 3)
        tb = trace_totals(tb)
        ta, tb = np.asarray(ta), np.asarray(tb)
        assert np.abs(ta - tb).max() <= max(3.0, 0.0025 * ta.sum()), (ta, tb)
        d = np.abs(np.asarray(a) - np.asarray(b))
        assert (d < 1e-3).mean() > 0.96, (d < 1e-3).mean()
        assert np.median(d) < 1e-5, np.median(d)


def _mixed_list_scene() -> Scene:
    """Cornell walls + rect light (id 6) + sphere light (id 8): a
    mixed-kind LightList scene."""
    from small_pathtracer_tpu.scene.presets import (
        _cornell_light_sampler, _cornell_walls,
    )

    walls = _cornell_walls()
    spheres = [
        ((73.0, 16.5, 78.0), 16.5, (0.75,) * 3, (0.0,) * 3, DIFF),
        ((30.0, 60.0, 100.0), 8.0, (0.0,) * 3, (6.0, 6.0, 6.0), DIFF),
    ]
    s_ctr, s_eu, s_ev = sampling.make_sphere_list_entry(
        (30.0, 60.0, 100.0), 8.0
    )
    lights = LightList(
        corner=jnp.asarray([[32.0, 81.6, 63.0], s_ctr], jnp.float32),
        edge_u=jnp.asarray([[36.0, 0.0, 0.0], s_eu], jnp.float32),
        edge_v=jnp.asarray([[0.0, 0.0, 36.0], s_ev], jnp.float32),
        obj_id=jnp.asarray([6, 8], jnp.int32),
        kind=jnp.asarray([LIGHT_RECT, LIGHT_SPHERE], jnp.int32),
    )
    return make_scene(walls, spheres, _cornell_light_sampler(),
                      lights=lights)


class TestMixedList:
    @pytest.mark.parametrize("est", ["nee_textbook", "mis"])
    def test_unbiased_estimators_agree_with_cosine(self, est):
        """nee_textbook / mis are UNBIASED — on a mixed rect+sphere list
        they must converge to the BSDF-sampling mean."""
        scene = _mixed_list_scene()
        cam = make_camera()
        cfg = RenderConfig(width=24, height=24, spp=128, estimator=est,
                           seed=13)
        img, _ = render_regen(scene, cam, cfg, jnp.uint32(13))
        m = float(np.asarray(img).mean()) / cfg.spp
        cfgc = RenderConfig(width=24, height=24, spp=128,
                            estimator="cosine", seed=13)
        imgc, _ = render_regen(scene, cam, cfgc, jnp.uint32(13))
        mc = float(np.asarray(imgc).mean()) / cfgc.spp
        assert abs(m - mc) / mc < 0.12, (est, m, mc)

    def test_continuation_nee_runs_in_family_band(self):
        """The C13-continuation family ("nee") is the PARITY estimator,
        not an unbiased one: a probe success REPLACES the bounce, so the
        estimator's expectation is direct*(1+P_fail) + indirect*P_fail
        (smallpt.cpp:457-479 — SURVEY C13, 'resisting the urge to fix
        it'); our sphere extension removes only the sphere-direct double
        count. On the mixed list this lands within a structural band of
        the unbiased mean (measured ~-14%), NOT on it — pin the band so
        a real regression (sign error, lost 1/q_k) still fails."""
        scene = _mixed_list_scene()
        cam = make_camera()
        cfg = RenderConfig(width=24, height=24, spp=128, estimator="nee",
                           seed=13)
        img, _ = render_regen(scene, cam, cfg, jnp.uint32(13))
        m = float(np.asarray(img).mean()) / cfg.spp
        cfgc = RenderConfig(width=24, height=24, spp=128,
                            estimator="cosine", seed=13)
        imgc, _ = render_regen(scene, cam, cfgc, jnp.uint32(13))
        mc = float(np.asarray(imgc).mean()) / cfgc.spp
        assert 0.7 * mc < m < 1.2 * mc, (m, mc)


class TestSphereLightGradients:
    """FD vs jnp adjoint (jax.grad through path_trace_fixed) for the
    sphere light's emission and center — the VERDICT item-3 gradient
    contract. Kernel-side sphere-light adjoints are a documented waiver
    (ops/megakernel_grad.py raises with pointers here)."""

    def _loss(self, scene, cfg, o, d, pid):
        L, _ = path_trace_fixed(scene, cfg, jnp.uint32(5), o, d, pid,
                                n_bounces=8)
        return jnp.mean(L)

    def _setup(self):
        scene = get_scene("cornell_spheres_roundlight")
        cfg = RenderConfig(width=16, height=16, spp=2, estimator="nee",
                           seed=5)
        n = 512
        rng = np.random.default_rng(5)
        o = jnp.asarray(np.stack(
            [rng.uniform(10, 90, n), rng.uniform(5, 70, n),
             rng.uniform(20, 150, n)], 1), jnp.float32)
        d = rng.normal(size=(n, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        return scene, cfg, o, jnp.asarray(d, jnp.float32), jnp.arange(
            n, dtype=jnp.uint32)

    def test_emission_gradient_fd(self):
        """d loss / d light-emission scale: exact pathwise gradient
        (emission enters linearly through every pickup)."""
        scene, cfg, o, d, pid = self._setup()

        def loss_of_scale(s):
            sc = scene._replace(
                spheres=scene.spheres._replace(
                    emission=scene.spheres.emission * s
                )
            )
            return self._loss(sc, cfg, o, d, pid)

        g = float(jax.grad(loss_of_scale)(jnp.asarray(1.0)))
        eps = 1e-2
        fd = (float(loss_of_scale(jnp.asarray(1.0 + eps)))
              - float(loss_of_scale(jnp.asarray(1.0 - eps)))) / (2 * eps)
        np.testing.assert_allclose(g, fd, rtol=1e-3)

    def test_center_gradient_fd_unoccluded(self):
        """d loss / d light-center-y where the pathwise adjoint is
        COMPLETE: with an unoccluded sphere light, every cone sample
        succeeds, so moving the center changes no discrete outcome —
        the boundary term has measure zero and jax.grad through the cone
        sampler + probe chain must match CRN central differences
        (analytic check: direct = a*Le*r^2/D^2 => d/dD = -2 a Le r^2/D^3)."""
        rects = [(1, 0.0, (-1e3, -1e3), (1e3, 1e3), (0.7, 0.7, 0.7),
                  (0, 0, 0), DIFF)]
        spheres = [((0.0, 50.0, 0.0), 10.0, (0, 0, 0), (5.0, 5.0, 5.0),
                    DIFF)]
        light = SphereLight(
            center=jnp.asarray([0.0, 50.0, 0.0]),
            radius=jnp.asarray(10.0),
            light_obj_id=jnp.asarray(1, jnp.int32),
        )
        base = make_scene(rects, spheres, light)
        cfg = RenderConfig(width=16, height=16, spp=2, estimator="nee",
                           seed=5)
        n = 2048
        rng = np.random.default_rng(7)
        o = jnp.asarray(np.stack(
            [rng.uniform(-30, 30, n), np.full(n, 1e-3),
             rng.uniform(-30, 30, n)], 1), jnp.float32)
        d = rng.normal(size=(n, 3))
        d[:, 1] = np.abs(d[:, 1]) + 0.1
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        d = jnp.asarray(d, jnp.float32)
        pid = jnp.arange(n, dtype=jnp.uint32)

        def loss_of_dy(dy):
            new_center = base.light.center + jnp.asarray(
                [0.0, 1.0, 0.0]) * dy
            sc = base._replace(
                light=base.light._replace(center=new_center),
                spheres=base.spheres._replace(
                    center=base.spheres.center.at[0].set(new_center)
                ),
            )
            return self._loss(sc, cfg, o, d, pid)

        g = float(jax.grad(loss_of_dy)(jnp.asarray(0.0)))
        eps = 0.05
        fd = (float(loss_of_dy(jnp.asarray(eps)))
              - float(loss_of_dy(jnp.asarray(-eps)))) / (2 * eps)
        # Raising the light reduces the subtended angle: both negative.
        assert g < 0 and fd < 0, (g, fd)
        assert abs(g - fd) / abs(fd) < 0.05, (g, fd)

    def test_center_gradient_occluded_boundary_dominated(self):
        """The occluded case (roundlight: the ceiling clips the cone) is
        BOUNDARY-dominated: moving the light mostly changes which probes
        succeed — a discrete event the interior pathwise adjoint cannot
        see (measured: interior -0.0025 vs CRN FD -0.0155 at this
        config). Rect lights estimate that edge integral separately
        (grad/edge.py); for sphere lights it is a DOCUMENTED WAIVER
        (COVERAGE.md). This test pins the contract: interior sign agrees,
        and the gap is attributed, not hidden."""
        scene, cfg, o, d, pid = self._setup()

        def loss_of_dy(dy):
            new_center = scene.light.center + jnp.asarray(
                [0.0, 1.0, 0.0]) * dy
            sc = scene._replace(
                light=scene.light._replace(center=new_center),
                spheres=scene.spheres._replace(
                    center=scene.spheres.center.at[2].set(new_center)
                ),
            )
            return self._loss(sc, cfg, o, d, pid)

        g = float(jax.grad(loss_of_dy)(jnp.asarray(0.0)))
        eps = 0.05
        fd = (float(loss_of_dy(jnp.asarray(eps)))
              - float(loss_of_dy(jnp.asarray(-eps)))) / (2 * eps)
        assert np.sign(g) == np.sign(fd), (g, fd)
