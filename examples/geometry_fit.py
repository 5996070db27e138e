"""Kernel-speed GEOMETRY fitting: recover a sphere's pose through the
geometry-adjoint megakernel (ops/megakernel_geom.py).

A target Cornell-spheres image is rendered once; sphere 0 is then
displaced and its center recovered by normalized-step descent on
pathwise interior gradients + the edge-sampled silhouette boundary term
(grad/edge.py), all through ONE adjoint kernel launch per step — no
recompiles (geometry rides the runtime sphere table) and no
finite-difference probes (grad/fd.py pays 2P+1 renders per step).

Runs anywhere:

    JAX_PLATFORMS=cpu python examples/geometry_fit.py        # interpreter
    python examples/geometry_fit.py                          # on a GPU

Expected (12 steps): loss drops monotonically in its best iterate and
the recovered center moves most of the displaced distance back (the
residual is the CRN landscape's own minimum at this spp — raise spp for
a tighter pose; see tests/test_megakernel_geom.py and test_fd.py for
the identifiability discussion).
"""

from __future__ import annotations

import sys
import time

import numpy as np

import os

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

import small_pathtracer_tpu as spt
from small_pathtracer_tpu.ops.megakernel_geom import (
    fit_pallas_geom,
    geom_run,
)


def main() -> int:
    on_gpu = jax.devices()[0].platform == "gpu"
    scene = spt.get_scene("cornell_spheres")
    cam = spt.make_camera(aspect=4 / 3)
    size = (128, 96, 16) if on_gpu else (32, 24, 4)
    cfg = spt.RenderConfig(
        width=size[0], height=size[1], spp=size[2], estimator="nee",
        max_bounces=8, sphere_table="on", seed=13,
    )

    print(f"target render {cfg.width}x{cfg.height}x{cfg.spp}spp "
          f"({'gpu' if on_gpu else 'cpu interpreter'})...")
    img_sum, _, _, _ = geom_run(scene, cam, cfg, cfg.seed)
    target = np.asarray(img_sum) / cfg.spp

    displaced = scene._replace(spheres=scene.spheres._replace(
        center=scene.spheres.center.at[0].add(
            jnp.asarray([5.0, 0.0, -3.0], jnp.float32))
    ))
    d0 = float(jnp.linalg.norm(
        displaced.spheres.center[0] - scene.spheres.center[0]))
    print(f"sphere 0 displaced by {d0:.2f} units; fitting center...")

    t0 = time.time()
    fitted, losses = fit_pallas_geom(
        displaced, cam, cfg, target, sphere_idx=0, fields=("center",),
        steps=12, lr=2.0, seed=cfg.seed, log=sys.stderr,
    )
    dt = time.time() - t0
    d1 = float(jnp.linalg.norm(
        fitted.spheres.center[0] - scene.spheres.center[0]))
    print(f"done in {dt:.1f}s ({dt / 12:.2f}s/step): "
          f"loss {losses[0]:.5f} -> {min(losses):.5f}, "
          f"center error {d0:.2f} -> {d1:.2f}")
    return 0 if (min(losses) < losses[0] and d1 < d0 + 0.8) else 1


if __name__ == "__main__":
    raise SystemExit(main())
