"""Kernel-speed sphere-geometry fitting: common-random-number finite
differences through the TABLE megakernel.

The pathwise adjoint kernels (ops/megakernel_grad.py) differentiate
materials; sphere GEOMETRY gradients previously required the jnp-side
boundary estimators (grad/edge.py, grad/soft.py), which run the slow
wavefront. The sphere-table kernel (ops/megakernel.py sphere_tab) removes
the blocker for a third route: geometry edits re-run WITHOUT recompiling,
so a central difference is just two more kernel renders. With COMMON
RANDOM NUMBERS (identical seed -> identical per-sample decision stream on
both sides of the difference) the FD of the fixed-seed estimator is
low-variance, and at practical deltas (~0.1-1 scene units) it captures
BOTH the smooth shading terms and the discrete silhouette/occlusion flips
the pathwise adjoint misses — the same mechanism the oracle FD parity
tests rely on (tests/test_parity_grad.py).

Cost per SGD step: 2*P + 1 renders for P scalar parameters (central
differences + one loss log), each at full kernel speed. For one sphere's
center+radius that is 9 renders/step, independent of how many OTHER
spheres the scene holds (the reference has no optimization story at all).
"""

from __future__ import annotations

import dataclasses
import sys

import numpy as np

import jax.numpy as jnp

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..ops.megakernel import render_pallas
from ..scene.types import Scene

# (field, component-count) the FD fitter can train, in update order.
FIELDS = {"center": 3, "radius": 1, "albedo": 3, "emission": 3}


def _table_cfg(cfg: RenderConfig) -> RenderConfig:
    """Force the sphere table on: FD probes must not recompile per step."""
    if cfg.sphere_table == "on":
        return cfg
    return dataclasses.replace(cfg, sphere_table="on")


def _render_mean(scene, cam, cfg, seed):
    img, _ = render_pallas(scene, cam, cfg, seed)
    return jnp.asarray(img, jnp.float32) / jnp.float32(cfg.spp)


def _loss(scene, cam, cfg, seed, target):
    # Unclamped linear MSE, matching grad/adjoint.render_linear's fitting
    # convention (clamping would zero gradients on emissive pixels).
    img = _render_mean(scene, cam, cfg, seed)
    return float(jnp.mean((img - target) ** 2))


def _perturb(scene: Scene, si: int, field: str, comp: int, eps: float):
    s = scene.spheres
    if field == "center":
        arr = s.center.at[si, comp].add(eps)
        return scene._replace(spheres=s._replace(center=arr))
    if field == "radius":
        return scene._replace(spheres=s._replace(
            radius=s.radius.at[si].add(eps)))
    if field == "albedo":
        return scene._replace(spheres=s._replace(
            albedo=s.albedo.at[si, comp].add(eps)))
    if field == "emission":
        return scene._replace(spheres=s._replace(
            emission=s.emission.at[si, comp].add(eps)))
    raise ValueError(f"unknown field {field!r}; one of {sorted(FIELDS)}")


def fd_loss_and_grad(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                     target, sphere_idx: int, fields=("center", "radius"),
                     delta: float = 0.5, seed: int = 0):
    """Loss + central-difference gradient w.r.t. the listed fields of
    sphere ``sphere_idx``. Every render shares ``seed`` (CRN). delta is in
    scene units for center/radius and albedo/emission units otherwise.

    Returns (loss, {field: np.ndarray gradient})."""
    cfg = _table_cfg(cfg)
    loss = _loss(scene, cam, cfg, seed, target)
    grads = {}
    for field in fields:
        n = FIELDS[field]
        g = np.zeros(n, np.float64)
        d = delta if field in ("center", "radius") else min(delta, 0.05)
        for c in range(n):
            lp = _loss(_perturb(scene, sphere_idx, field, c, +d),
                       cam, cfg, seed, target)
            lm = _loss(_perturb(scene, sphere_idx, field, c, -d),
                       cam, cfg, seed, target)
            g[c] = (lp - lm) / (2.0 * d)
        grads[field] = g
    return loss, grads


def fit_fd(scene: Scene, cam: CameraParams, cfg: RenderConfig, target,
           sphere_idx: int, fields=("center", "radius"), steps: int = 10,
           lr: float = 1.0, delta: float = 0.5, seed: int = 0,
           log=None):
    """Normalized-step descent on FD gradients through the table kernel.
    Returns (fitted scene, [losses]).

    The FD gradient's MAGNITUDE spans decades (it scales with the
    sphere's visible pixel fraction), so fixed-lr SGD is hopeless; its
    DIRECTION is reliable. Each step moves ``cap`` units along -g/|g| per
    field (same convention as fit --camera-edge), with a backtracking
    trust region on the DETERMINISTIC (CRN) loss: a step that made things
    worse is rejected — return to the best iterate and halve the cap
    (the re-evaluated FD there is identical, so the retry just steps
    shorter); acceptance regrows the cap toward its initial value.
    lr = the INITIAL step length in scene units (materials use
    min(lr, 0.1) in albedo/emission units)."""
    cfg = _table_cfg(cfg)
    cap0_geo = float(lr)
    cap0_mat = min(float(lr), 0.1)
    cap_geo, cap_mat = cap0_geo, cap0_mat
    losses = []
    s = scene
    best_loss, best_s = float("inf"), scene
    for i in range(steps):
        loss, g = fd_loss_and_grad(
            s, cam, cfg, target, sphere_idx, fields,
            delta=delta, seed=seed,
        )
        if loss > best_loss:
            s = best_s
            cap_geo *= 0.5
            cap_mat *= 0.5
            # Record the BEST loss so far, not the rejected proposal's —
            # the function returns best_s, so losses[-1] must describe the
            # returned iterate (ADVICE r3; cmd_fit reports losses[-1]).
            losses.append(best_loss)
            if log is not None:
                print(f"step {i}: loss {loss:.6f} rejected "
                      f"(cap -> {cap_geo:.3f})", file=log or sys.stderr)
            continue
        best_loss, best_s = loss, s
        cap_geo = min(1.2 * cap_geo, cap0_geo)
        cap_mat = min(1.2 * cap_mat, cap0_mat)
        losses.append(loss)
        sp = s.spheres

        def step(grad, cap):
            n = float(np.linalg.norm(grad))
            if n < 1e-30:
                return jnp.zeros(len(grad), jnp.float32)
            return jnp.asarray(-cap * grad / n, jnp.float32)

        if "center" in g:
            sp = sp._replace(center=sp.center.at[sphere_idx].add(
                step(g["center"], cap_geo)))
        if "radius" in g:
            r_new = float(sp.radius[sphere_idx]) + float(
                step(g["radius"], cap_geo)[0])
            sp = sp._replace(radius=sp.radius.at[sphere_idx].set(
                max(r_new, 1e-3)))
        if "albedo" in g:
            sp = sp._replace(albedo=jnp.clip(
                sp.albedo.at[sphere_idx].add(step(g["albedo"], cap_mat)),
                0.0, 1.0))
        if "emission" in g:
            sp = sp._replace(emission=jnp.maximum(
                sp.emission.at[sphere_idx].add(
                    step(g["emission"], cap_mat)),
                0.0))
        s = s._replace(spheres=sp)
        if log is not None:
            c = [round(float(v), 3) for v in s.spheres.center[sphere_idx]]
            print(
                f"step {i}: loss {loss:.6f} center {c} "
                f"radius {float(s.spheres.radius[sphere_idx]):.3f}",
                file=log or sys.stderr,
            )
    # The last proposal may be unevaluated/worse; hand back the best
    # iterate actually measured.
    return best_s, losses
