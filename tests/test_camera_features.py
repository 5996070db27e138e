"""Tent pixel filter + thin-lens depth of field (camera.pinhole extensions).

The reference camera is a pure pinhole with a uniform box filter (contract
C4/C5, smallpt.cpp:256-285,533-534); original smallpt — the reference's
ancestor (README.md:3-4) — uses a 2-pixel tent filter. Both extensions are
config flags (pixel_filter / aperture / focus_dist), shared bit-for-bit by
the jnp wavefront and the Pallas megakernel.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
from small_pathtracer_tpu.camera.pinhole import (
    filter_jitter,
    make_camera as _mk,
    primary_rays,
)
from small_pathtracer_tpu.integrator.wavefront import render_regen
from small_pathtracer_tpu.ops.megakernel import render_pallas, trace_totals


class TestTentFilter:
    def test_box_is_identity(self):
        xi = jnp.linspace(0.0, 0.999, 64)
        ju, jv = filter_jitter(xi, xi, "box")
        np.testing.assert_array_equal(np.asarray(ju), np.asarray(xi))
        np.testing.assert_array_equal(np.asarray(jv), np.asarray(xi))

    def test_tent_distribution(self):
        """offset - 0.5 must follow the triangle density on (-1, 1):
        mean 0, variance 1/6, and the exact inverse-CDF mapping."""
        xi = jnp.asarray(np.random.default_rng(7).random(200_000),
                         jnp.float32)
        off, _ = filter_jitter(xi, xi, "tent")
        t = np.asarray(off, np.float64) - 0.5
        assert t.min() > -1.0 and t.max() < 1.0
        assert abs(t.mean()) < 5e-3
        assert abs(t.var() - 1.0 / 6.0) < 2e-3
        # Exact inverse-CDF values: xi=0.125 -> sqrt(.25)-1 = -0.5;
        # xi=0.875 -> 1-sqrt(.25) = +0.5.
        lo, _ = filter_jitter(jnp.float32(0.125), jnp.float32(0.125), "tent")
        hi, _ = filter_jitter(jnp.float32(0.875), jnp.float32(0.875), "tent")
        assert np.isclose(float(lo) - 0.5, -0.5, atol=1e-6)
        assert np.isclose(float(hi) - 0.5, 0.5, atol=1e-6)

    def test_kernel_matches_jnp(self):
        scene = get_scene("cornell_box")
        cam = make_camera()
        cfg = RenderConfig(width=24, height=16, spp=4, estimator="nee",
                           seed=5, pixel_filter="tent")
        a, ta = render_regen(scene, cam, cfg, jnp.uint32(5))
        b, tb = render_pallas(scene, cam, cfg, 5)
        tb = trace_totals(tb)
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4
        )

    def test_tent_mean_matches_box(self):
        """The filter reshapes per-pixel weighting, not total light: means
        of box and tent renders agree statistically."""
        scene = get_scene("cornell_box")
        cam = make_camera(aspect=1.5)
        box = RenderConfig(width=24, height=16, spp=32, estimator="nee",
                           seed=1)
        tent = RenderConfig(width=24, height=16, spp=32, estimator="nee",
                            seed=1, pixel_filter="tent")
        a, _ = render_regen(scene, cam, box, jnp.uint32(1))
        b, _ = render_regen(scene, cam, tent, jnp.uint32(1))
        a = np.asarray(a) / box.spp
        b = np.asarray(b) / tent.spp
        assert abs(a.mean() - b.mean()) < 0.015, (a.mean(), b.mean())


class TestThinLens:
    APERTURE = 2.5
    FOCUS = 120.0

    def _rays(self, n=4096, seed=3):
        cam = _mk(aspect=1.0)
        r = np.random.default_rng(seed)
        px = jnp.asarray(r.integers(0, 64, n), jnp.int32)
        py = jnp.asarray(r.integers(0, 64, n), jnp.int32)
        ju = jnp.asarray(r.random(n), jnp.float32)
        jv = jnp.asarray(r.random(n), jnp.float32)
        lu = jnp.asarray(r.random(n), jnp.float32)
        lv = jnp.asarray(r.random(n), jnp.float32)
        o_pin, d_pin = primary_rays(cam, 64, 64, px, py, ju, jv)
        o_l, d_l = primary_rays(
            cam, 64, 64, px, py, ju, jv, "box",
            self.APERTURE, self.FOCUS, lu, lv,
        )
        return cam, o_pin, d_pin, o_l, d_l

    def test_lens_rays_hit_the_pinhole_focal_point(self):
        """The defining thin-lens property: every lens ray intersects the
        focal plane exactly where its pinhole ray does."""
        cam, o_pin, d_pin, o_l, d_l = self._rays()
        w = np.asarray(cam.lower_left - cam.origin
                       + 0.5 * cam.horizontal + 0.5 * cam.vertical)
        w = w / np.linalg.norm(w)  # view axis (|w|=1 in make_camera)
        o_pin, d_pin = np.asarray(o_pin), np.asarray(d_pin)
        o_l, d_l = np.asarray(o_l, np.float64), np.asarray(d_l, np.float64)
        t_pin = self.FOCUS / (d_pin @ w)
        p_focus = o_pin + d_pin * t_pin[:, None]
        t_l = (self.FOCUS - (o_l - o_pin) @ w) / (d_l @ w)
        p_lens = o_l + d_l * t_l[:, None]
        np.testing.assert_allclose(p_lens, p_focus, rtol=0, atol=5e-3)

    def test_lens_origins_uniform_on_disk(self):
        cam, _, _, o_l, _ = self._rays(n=20000)
        rel = np.asarray(o_l, np.float64) - np.asarray(cam.origin)
        u = np.asarray(cam.horizontal, np.float64)
        u /= np.linalg.norm(u)
        v = np.asarray(cam.vertical, np.float64)
        v /= np.linalg.norm(v)
        x, y = rel @ u, rel @ v
        r = np.hypot(x, y)
        assert r.max() <= self.APERTURE * (1 + 1e-5)
        # Uniform disk: E[r^2] = R^2/2, E[x] = E[y] = 0.
        assert abs((r**2).mean() - self.APERTURE**2 / 2) < 0.05
        assert abs(x.mean()) < 0.05 and abs(y.mean()) < 0.05
        # Off-plane component is zero: the lens lives in the (u, v) plane.
        w = np.cross(u, v)
        assert np.abs(rel @ w).max() < 1e-3

    def test_kernel_matches_jnp(self):
        scene = get_scene("cornell_box")
        cam = make_camera()
        cfg = RenderConfig(width=24, height=16, spp=4, estimator="nee",
                           seed=9, aperture=3.0, focus_dist=120.0)
        a, ta = render_regen(scene, cam, cfg, jnp.uint32(9))
        b, tb = render_pallas(scene, cam, cfg, 9)
        tb = trace_totals(tb)
        np.testing.assert_array_equal(np.asarray(ta), np.asarray(tb))
        np.testing.assert_allclose(
            np.asarray(a), np.asarray(b), rtol=1e-4, atol=1e-4
        )

    def test_defocus_blurs_off_plane_geometry(self):
        """Focus on the near sphere of cornell_spheres: the in-focus
        region's pixels move much less (pinhole -> lens) than the
        out-of-focus far wall / second sphere region."""
        scene = get_scene("cornell_spheres")
        cam = make_camera()
        # Near sphere center (27, 16.5, 47); camera at (50, 40, 168) ->
        # view-axis distance ~ 121.
        pin = RenderConfig(width=48, height=48, spp=64, estimator="nee",
                           seed=2)
        dof = RenderConfig(width=48, height=48, spp=64, estimator="nee",
                           seed=2, aperture=6.0, focus_dist=121.0)
        a, _ = render_regen(scene, cam, pin, jnp.uint32(2))
        b, _ = render_regen(scene, cam, dof, jnp.uint32(2))
        a = np.asarray(a) / pin.spp
        b = np.asarray(b) / dof.spp
        diff = np.abs(a - b).mean(axis=-1)
        # Pixel blocks (rows, cols): near-sphere region vs ceiling-light
        # edge region (strong radiance discontinuity far off-plane).
        infocus = diff[26:38, 8:22].mean()
        offplane = diff[2:10, 14:34].mean()
        assert offplane > 2.0 * infocus, (infocus, offplane)

    def test_config_validation(self):
        with pytest.raises(ValueError):
            RenderConfig(aperture=-1.0)
        with pytest.raises(ValueError):
            RenderConfig(focus_dist=0.0)
        with pytest.raises(ValueError):
            RenderConfig(pixel_filter="gauss")
