"""Scalable scenes + kernel-speed geometry fitting, end to end.

1. Render a 263-object scene (walls + light + 256 spheres, some mirrors)
   through the megakernel's packed runtime sphere table: compiled code size
   is O(unrolled objects) — the same executable serves ANY sphere
   positions/radii/materials, so step 2's probes never recompile.
2. Move one sphere, then recover its center/radius by common-random-number
   central differences through the same kernel (grad/fd.py): a
   deterministic loss, a backtracking trust region, 2P+1 renders/step.

Runs on a GPU; with JAX_PLATFORMS=cpu the kernels run in the (slow)
interpreter — shrink SIZE/SPP for a CPU try-out.

Usage:  python examples/scalable_scene.py
"""

import numpy as np

import jax.numpy as jnp

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import small_pathtracer_tpu as spt
from small_pathtracer_tpu.core import film
from small_pathtracer_tpu.grad.fd import _render_mean, _table_cfg, fit_fd
from small_pathtracer_tpu.ops.megakernel import render_pallas

SIZE = (320, 240)
SPP = 64

scene = spt.get_scene("sphere_grid_256")
cam = spt.make_camera(aspect=SIZE[0] / SIZE[1])
cfg = _table_cfg(spt.RenderConfig(
    width=SIZE[0], height=SIZE[1], spp=SPP, estimator="nee", seed=0,
))

# 1. Render through the sphere table.
img_sum, traces = render_pallas(scene, cam, cfg, cfg.seed)
img = np.asarray(film.finalize(np.asarray(img_sum) / cfg.spp))
film.write_ppm("sphere_grid.ppm", np.asarray(film.tonemap_u8(img)))
print(f"rendered {SIZE[0]}x{SIZE[1]}x{SPP}spp, "
      f"{float(np.asarray(traces).sum()):.0f} traces -> sphere_grid.ppm")

# 2. Displace a FRONT-layer sphere (one the camera actually sees — an
#    interior sphere is occluded by the grid and carries no image signal)
#    and recover it: every FD probe reuses the compiled kernel (geometry
#    is a runtime table input).
SI = int(np.argmax(np.asarray(scene.spheres.center)[:, 2]
                   - np.abs(np.asarray(scene.spheres.center)[:, 0] - 50.0)))
target = _render_mean(scene, cam, cfg, cfg.seed)
bad = scene._replace(spheres=scene.spheres._replace(
    center=scene.spheres.center.at[SI].add(jnp.asarray([3.0, 0.0, -2.0])),
))
fitted, losses = fit_fd(
    bad, cam, cfg, target, sphere_idx=SI, fields=("center",),
    steps=8, lr=1.0, delta=0.5, seed=cfg.seed,
    log=__import__("sys").stderr,
)
err0 = float(np.linalg.norm([3.0, 0.0, -2.0]))
err1 = float(np.linalg.norm(
    np.asarray(fitted.spheres.center[SI] - scene.spheres.center[SI])
))
print(f"center error {err0:.2f} -> {err1:.2f} scene units "
      f"(loss {losses[0]:.2e} -> {min(losses):.2e})")
