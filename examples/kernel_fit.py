"""Kernel-speed inverse rendering via the forward + adjoint Pallas
megakernels (ops/megakernel_grad.py).

Unlike examples/inverse_rendering.py (jnp lax.scan adjoint), both the
render and its material gradients run as fused GPU kernels with RUNTIME
material tables, so the whole optimization compiles once and each step costs
about three forward renders (PERF.md has the time per step against
jax.grad of the jnp renderer).

    python examples/kernel_fit.py          # GPU; JAX_PLATFORMS=cpu runs the
                                           # kernels in the (slow) interpreter
"""

from __future__ import annotations

import numpy as np

import jax.numpy as jnp

import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import small_pathtracer_tpu as spt
from small_pathtracer_tpu.ops.megakernel import render_pallas
from small_pathtracer_tpu.ops.megakernel_grad import fit_pallas


def main(steps: int = 30, lr: float = 8.0) -> None:
    cfg = spt.RenderConfig(width=64, height=48, spp=32, estimator="nee",
                           seed=5, max_bounces=32)
    cam = spt.make_camera(aspect=64 / 48)
    scene0 = spt.get_scene("cornell_box")

    # Ground truth: brighter light.
    truth = scene0._replace(rects=scene0.rects._replace(
        emission=scene0.rects.emission * 1.5))
    img_sum, _ = render_pallas(truth, cam, cfg, 99)
    target = img_sum / cfg.spp

    fitted, losses = fit_pallas(
        scene0, cam, cfg, target, steps=steps, lr=lr,
        train_fields=("emission",), seed=cfg.seed,
    )
    print("loss:", round(losses[0], 5), "->", round(losses[-1], 5))
    print("recovered light emission:",
          np.asarray(fitted.rects.emission)[6].round(2), "(truth 18.0)")


if __name__ == "__main__":
    main()
