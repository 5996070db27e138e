#!/usr/bin/env python3
"""Kernel timings on one NVIDIA GPU: each Pallas kernel against the plain
version XLA compiles, and the sweeps that chose the kernels' constants.
PERF.md quotes what it prints.

    python tools/kernel_timings.py

Every line names the card and its power limit. Compiles are cold (the
persistent compilation cache is off); steady times are the best of three
calls, each timed around ``block_until_ready``. With no GPU it exits
non-zero. Parts, in order:

1. ``GEOM_S``: the geometry adjoint vs ``jax.grad`` of
   ``grad/adjoint.render_linear`` at growing sphere counts
   (``cornell_spheres``, then ``sphere_grid(n)``), at the fit config. Each
   count runs in its own child process with a time limit (the kernel's
   per-lane carries grow with the count, and so may its compile), before
   this process opens the card; the first count that fails or runs out of
   time ends the part.
2. ``FWD``: the forward kernel vs ``render_regen`` at the north-star frame,
   for four estimators.
3. ``MAT``: the material adjoint step vs ``jax.grad`` at the fit config.
4. ``SWEEP`` / ``ADJ_SWEEP``: lanes and warps per block, for the forward
   kernel at the north star and for both adjoints at the fit config.
5. ``LANE_TARGET``: lanes per launch, at the north star and the fit
   config.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
NORTH_STAR = dict(width=1024, height=768, spp=512)
FIT = dict(width=256, height=192, spp=16, bounces=16)
SPHERE_COUNTS = (2, 8, 16, 32, 64, 128)
CASE_SECONDS = 240
FWD_BLOCKS = ((32, 1), (64, 2), (128, 4), (256, 8), (64, 1), (128, 2),
              (256, 4), (512, 4), (512, 16))
ADJ_BLOCKS = ((32, 1), (64, 2), (128, 4))
LANE_TARGETS = (1 << 16, 1 << 18, 1 << 20, 1 << 21)


def _setup():
    """Imports for a measuring process: GPU required, cache off."""
    sys.path.insert(0, str(ROOT))
    import jax

    from small_pathtracer_tpu.utils.device_info import (
        card_name_and_power_limit,
        require_gpu,
    )

    require_gpu()
    jax.config.update("jax_enable_compilation_cache", False)
    return card_name_and_power_limit()


def best_of(fn, n=3):
    """(best seconds, all seconds) over n calls of fn."""
    import jax

    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return min(ts), ts


def _first(fn):
    """Seconds of the first call (compile included)."""
    import jax

    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


def _ms(ts):
    return [round(t * 1e3, 3) for t in ts]


def _fit_cfg(**kw):
    from small_pathtracer_tpu import RenderConfig, make_camera

    cfg = RenderConfig(width=FIT["width"], height=FIT["height"],
                       spp=FIT["spp"], estimator="nee",
                       max_bounces=FIT["bounces"], seed=3, **kw)
    return make_camera(aspect=FIT["width"] / FIT["height"]), cfg


def _north_star(**kw):
    from small_pathtracer_tpu import RenderConfig, make_camera

    cfg = RenderConfig(width=NORTH_STAR["width"],
                       height=NORTH_STAR["height"], spp=NORTH_STAR["spp"],
                       estimator="nee", seed=1, **kw)
    return make_camera(aspect=cfg.width / cfg.height), cfg


def _jnp_step(cam, cfg, target, make_scene):
    """jit(value_and_grad) of the MSE of render_linear at the fit config;
    make_scene(params) builds the scene from the differentiated params."""
    import jax
    import jax.numpy as jnp

    from small_pathtracer_tpu.grad.adjoint import render_linear

    @jax.jit
    def step(params, seed):
        def loss(p):
            img = render_linear(make_scene(p), cam, cfg, seed, FIT["bounces"])
            return jnp.mean((img - target) ** 2)
        return jax.value_and_grad(loss, allow_int=True)(params)

    return step


def geom_count_case(n_sph: int):
    """One sphere count of part 1 (run in a child process)."""
    import jax.numpy as jnp
    import numpy as np

    from small_pathtracer_tpu import get_scene
    from small_pathtracer_tpu.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu.scene.presets import sphere_grid

    card = _setup()
    scene = get_scene("cornell_spheres") if n_sph == 2 else sphere_grid(n_sph)
    # Measure past the kernel's accepted count too: this is how it was set.
    mgeo.GEOM_MAX_SPHERES = max(mgeo.GEOM_MAX_SPHERES, n_sph)
    cam, cfg = _fit_cfg(sphere_table="on")
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)

    def kernel():
        return mgeo.loss_and_geom_grads(scene, cam, cfg, 3, target)

    first_k = _first(kernel)
    best_k, ts_k = best_of(kernel)
    step = _jnp_step(cam, cfg, target, lambda p: scene._replace(
        spheres=scene.spheres._replace(center=p[0], radius=p[1])))
    params = (scene.spheres.center, scene.spheres.radius)
    t0 = time.perf_counter()
    step.lower(params, jnp.uint32(3)).compile()
    comp_j = time.perf_counter() - t0
    best_j, ts_j = best_of(lambda: step(params, jnp.uint32(3)))
    print(f"GEOM_S S={n_sph}: kernel first call {first_k:.2f} s, step "
          f"{best_k * 1e3:.2f} ms {_ms(ts_k)}; jax.grad compile "
          f"{comp_j:.2f} s, step {best_j * 1e3:.2f} ms {_ms(ts_j)}; "
          f"jax.grad / kernel {best_j / best_k:.2f}x [{card}]", flush=True)


def part_sphere_counts() -> int:
    """Part 1, one child process per count; returns 0, or the rc of a
    child that found no GPU."""
    for n_sph in SPHERE_COUNTS:
        code = (f"import sys; sys.path.insert(0, {str(ROOT / 'tools')!r}); "
                f"import kernel_timings as k; k.geom_count_case({n_sph})")
        try:
            out = subprocess.run([sys.executable, "-c", code],
                                 timeout=CASE_SECONDS, cwd=ROOT)
        except subprocess.TimeoutExpired:
            print(f"GEOM_S S={n_sph}: not finished within {CASE_SECONDS} s; "
                  "larger counts not measured", flush=True)
            return 0
        if out.returncode != 0:
            if n_sph == SPHERE_COUNTS[0]:
                return out.returncode
            print(f"GEOM_S S={n_sph}: failed (rc {out.returncode}); larger "
                  "counts not measured", flush=True)
            return 0
    return 0


def part_forward(card):
    import dataclasses

    import jax.numpy as jnp

    from small_pathtracer_tpu import get_scene
    from small_pathtracer_tpu.integrator.wavefront import render_regen
    from small_pathtracer_tpu.ops import megakernel as mk

    scene = get_scene("cornell_box")
    cam, base = _north_star()
    for est in ("nee", "mis", "nee_textbook", "cosine"):
        cfg = dataclasses.replace(base, estimator=est)

        def kernel():
            return mk.render_pallas(scene, cam, cfg, 1)

        def regen():
            return render_regen(scene, cam, cfg, jnp.uint32(1))

        first_k, first_r = _first(kernel), _first(regen)
        best_k, ts_k = best_of(kernel)
        best_r, ts_r = best_of(regen)
        rays = float(mk.trace_totals(kernel()[1]).sum())
        print(f"FWD {est}: kernel first call {first_k:.2f} s, "
              f"{best_k * 1e3:.2f} ms {_ms(ts_k)} "
              f"{rays / best_k / 1e6:.0f} Mrays/s; render_regen first call "
              f"{first_r:.2f} s, {best_r * 1e3:.2f} ms {_ms(ts_r)} "
              f"{rays / best_r / 1e6:.0f} Mrays/s; regen / kernel "
              f"{best_r / best_k:.2f}x [{card}]", flush=True)


def part_material(card):
    import jax.numpy as jnp
    import numpy as np

    from small_pathtracer_tpu import get_scene
    from small_pathtracer_tpu.ops.megakernel_grad import (
        loss_and_material_grads,
    )

    scene = get_scene("cornell_box")
    cam, cfg = _fit_cfg()
    target = np.zeros((cfg.height, cfg.width, 3), np.float32)

    def kernel():
        return loss_and_material_grads(scene, cam, cfg, jnp.uint32(3),
                                       target)

    first_k = _first(kernel)
    step = _jnp_step(cam, cfg, target, lambda p: p)
    t0 = time.perf_counter()
    step.lower(scene, jnp.uint32(3)).compile()
    comp_j = time.perf_counter() - t0
    best_k, ts_k = best_of(kernel)
    best_j, ts_j = best_of(lambda: step(scene, jnp.uint32(3)))
    print(f"MAT: kernel first call {first_k:.2f} s, step "
          f"{best_k * 1e3:.2f} ms {_ms(ts_k)}; jax.grad compile "
          f"{comp_j:.2f} s, step {best_j * 1e3:.2f} ms {_ms(ts_j)}; "
          f"jax.grad / kernel {best_j / best_k:.2f}x [{card}]", flush=True)


def _clear_caches():
    from small_pathtracer_tpu.ops import megakernel as mk
    from small_pathtracer_tpu.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu.ops import megakernel_grad as mgrad

    for mod in (mk, mgrad, mgeo):
        mod._CACHE.clear()


def part_blocks(card):
    import jax.numpy as jnp
    import numpy as np

    from small_pathtracer_tpu import get_scene
    from small_pathtracer_tpu.ops import megakernel as mk
    from small_pathtracer_tpu.ops import megakernel_geom as mgeo
    from small_pathtracer_tpu.ops import megakernel_grad as mgrad
    from small_pathtracer_tpu.ops import route

    kept = route.GPU_BLOCK_LANES, route.GPU_NUM_WARPS
    box, sph = get_scene("cornell_box"), get_scene("cornell_spheres")
    cam, cfg = _north_star()
    fcam, fcfg = _fit_cfg()
    _, gcfg = _fit_cfg(sphere_table="on")
    tgt = np.zeros((fcfg.height, fcfg.width, 3), np.float32)
    try:
        for lanes, warps in FWD_BLOCKS:
            route.GPU_BLOCK_LANES, route.GPU_NUM_WARPS = lanes, warps
            _clear_caches()

            def kernel():
                return mk.render_pallas(box, cam, cfg, 1)

            first = _first(kernel)
            best, ts = best_of(kernel)
            rays = float(mk.trace_totals(kernel()[1]).sum())
            print(f"SWEEP lanes={lanes} warps={warps}: first call "
                  f"{first:.2f} s, {best * 1e3:.2f} ms {_ms(ts)} "
                  f"{rays / best / 1e6:.0f} Mrays/s [{card}]", flush=True)
        for lanes, warps in ADJ_BLOCKS:
            route.GPU_BLOCK_LANES, route.GPU_NUM_WARPS = lanes, warps
            _clear_caches()

            def mat():
                return mgrad.loss_and_material_grads(
                    box, fcam, fcfg, jnp.uint32(3), tgt)

            def geo():
                return mgeo.loss_and_geom_grads(sph, fcam, gcfg, 3, tgt)

            _first(mat)
            _first(geo)
            dm, tm = best_of(mat)
            dg, tg = best_of(geo)
            print(f"ADJ_SWEEP lanes={lanes} warps={warps}: material step "
                  f"{dm * 1e3:.2f} ms {_ms(tm)}, geometry step "
                  f"{dg * 1e3:.2f} ms {_ms(tg)} [{card}]", flush=True)
    finally:
        route.GPU_BLOCK_LANES, route.GPU_NUM_WARPS = kept
        _clear_caches()


def part_lane_target(card):
    import jax.numpy as jnp
    import numpy as np

    from small_pathtracer_tpu import get_scene
    from small_pathtracer_tpu.ops import megakernel as mk
    from small_pathtracer_tpu.ops import megakernel_grad as mgrad

    kept = mk.LANE_TARGET
    box = get_scene("cornell_box")
    cam, cfg = _north_star()
    fcam, fcfg = _fit_cfg()
    tgt = np.zeros((fcfg.height, fcfg.width, 3), np.float32)
    try:
        for target in LANE_TARGETS:
            mk.LANE_TARGET = target
            _clear_caches()
            for tag, c, cm in (("north star", cfg, cam),
                               ("fit-config frame", fcfg, fcam)):
                def kernel():
                    return mk.render_pallas(box, cm, c, 1)

                _first(kernel)
                best, ts = best_of(kernel)
                g = mk.lane_layout(c.width * c.height, c.spp)[0]
                rays = float(mk.trace_totals(kernel()[1]).sum())
                print(f"LANE_TARGET 2^{target.bit_length() - 1} {tag} "
                      f"(g={g}): {best * 1e3:.3f} ms {_ms(ts)} "
                      f"{rays / best / 1e6:.0f} Mrays/s [{card}]",
                      flush=True)

            def mat():
                return mgrad.loss_and_material_grads(
                    box, fcam, fcfg, jnp.uint32(3), tgt)

            _first(mat)
            dm, tm = best_of(mat)
            print(f"LANE_TARGET 2^{target.bit_length() - 1} material step "
                  f"{dm * 1e3:.2f} ms {_ms(tm)} [{card}]", flush=True)
    finally:
        mk.LANE_TARGET = kept
        _clear_caches()


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        raise SystemExit("usage: python tools/kernel_timings.py "
                         "(it takes no arguments)")
    rc = part_sphere_counts()
    if rc:
        return rc
    card = _setup()
    part_forward(card)
    part_material(card)
    part_blocks(card)
    part_lane_target(card)
    print("kernel timings done", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
