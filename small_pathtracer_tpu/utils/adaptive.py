"""Adaptive sampling: variance-driven per-pixel sample budgets.

The reference renders a fixed ``samps`` per pixel
(/root/reference/src/smallpt.cpp:508,531) — flat regions get exactly the
samples they don't need and noisy regions exactly the samples they lack.
This module adds the production-renderer alternative: render in WAVES and
stop each pixel once the standard error of its running mean falls below a
luminance-relative tolerance, reallocating the remaining budget to the
pixels that still need it.

Design:

- A wave renders sample indices [n_i, n_i + wave) of every still-active
  pixel i. Because every random draw is a pure function of
  (pixel, sample index) (core/rng.py, core/ld.py), a pixel's estimate
  after n samples is bit-identical to any other schedule's first-n-sample
  mean — adaptive stopping changes WHICH samples are rendered, never their
  values (tests/test_adaptive.py pins this).
- Per-pixel Welford over the wave means (luma) estimates the standard
  error of the pixel's final mean: stderr = sqrt(var(wave_means) / K)
  after K waves. A pixel stops when K >= 2 and
  stderr <= tol * (luma + 0.02) (the +0.02 keeps near-black pixels from
  demanding absolute precision), or when it reaches cfg.spp (the cap).
- Waves run through either the jnp regenerating wavefront
  (path_trace_regen with per-lane spans) or the Pallas megakernel
  (ops/megakernel.render_pallas_budgets) — both already take per-lane
  sample spans, so the kernels are reused unchanged and compile ONCE for
  all waves.

Caveat (standard for adaptive MC): stopping on a data-dependent criterion
makes the estimator very slightly biased (stopped pixels are those whose
sample variance underestimates); with wave >= 8 and tol in the practical
range the effect is far below the residual noise floor (test_adaptive.py
bounds it against an equal-effort uniform render).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..scene.types import Scene

_LUMA = np.array([0.2126, 0.7152, 0.0722], np.float32)


@dataclasses.dataclass
class AdaptiveResult:
    image: np.ndarray      # (h, w, 3) linear mean, clamped to [0,1] (C3)
    spp_map: np.ndarray    # (h, w) int32 samples actually rendered
    traces: tuple[float, float]  # (extend, probe) totals
    waves: int
    total_samples: int     # sum of spp_map
    uniform_samples: int   # h * w * cfg.spp (what a uniform render costs)


def _wave_jnp(scene, cam, cfg, seed, s_start, s_stop):
    from ..integrator.wavefront import path_trace_regen

    n_pix = cfg.width * cfg.height
    pix = jnp.arange(n_pix, dtype=jnp.uint32)
    return path_trace_regen(scene, cfg, seed, cam, pix, s_start, s_stop)


_wave_jnp_jit = jax.jit(_wave_jnp, static_argnums=(2,))


def adaptive_render(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                    tol: float = 0.01, wave: int = 0,
                    log=None) -> AdaptiveResult:
    """Adaptive render up to cfg.spp samples per pixel.

    tol: luminance-relative standard-error target (0.01 = stop a pixel
    when its mean is within ~1% of its brightness at 1 sigma). tol = 0
    never stops early — every pixel renders all cfg.spp samples (the
    uniform image, wave-summed).
    wave: samples per wave; 0 = auto (cfg.spp / 8, at least 8).

    Uses the Pallas megakernel when cfg.use_pallas, else the jnp regen
    wavefront."""
    if wave <= 0:
        wave = max(8, cfg.spp // 8)
    wave = min(wave, cfg.spp)
    n_pix = cfg.width * cfg.height

    n = np.zeros(n_pix, np.uint32)           # samples rendered
    sum_rgb = np.zeros((n_pix, 3), np.float64)
    k = np.zeros(n_pix, np.int32)            # waves rendered
    wmean = np.zeros(n_pix, np.float64)      # Welford mean of wave lumas
    wm2 = np.zeros(n_pix, np.float64)        # Welford M2 of wave lumas
    active = np.ones(n_pix, bool)
    extends = probes = 0.0
    waves = 0

    if cfg.use_pallas:
        from ..ops.megakernel import render_pallas_budgets, trace_totals

        def run_wave(s_start, s_stop):
            L, per_block = render_pallas_budgets(
                scene, cam, cfg, cfg.seed, s_start, s_stop
            )
            return L, trace_totals(per_block)
    else:
        def run_wave(s_start, s_stop):
            return _wave_jnp_jit(
                scene, cam, cfg, jnp.uint32(cfg.seed),
                jnp.asarray(s_start), jnp.asarray(s_stop),
            )

    while active.any():
        budget = np.minimum(cfg.spp - n[active], wave).astype(np.uint32)
        s_start = n.copy()
        s_stop = n.copy()
        s_stop[active] = s_stop[active] + budget
        L, tr = run_wave(s_start, s_stop)
        L = np.asarray(L, np.float64)
        tr = np.asarray(tr)
        extends += float(tr[0])
        probes += float(tr[1])
        waves += 1

        nw = (s_stop - s_start).astype(np.float64)
        sum_rgb[active] += L[active]
        n = s_stop
        # Welford over wave-mean lumas (only full-size waves enter the
        # variance estimate; the final short wave would bias it).
        full = active & (nw == wave)
        luma = (L[full] @ _LUMA) / wave
        k_f = k[full] + 1
        d = luma - wmean[full]
        wmean[full] += d / k_f
        wm2[full] += d * (luma - wmean[full])
        k[full] = k_f

        capped = n >= cfg.spp
        if tol > 0.0:
            with np.errstate(divide="ignore", invalid="ignore"):
                var_w = np.where(k > 1, wm2 / np.maximum(k - 1, 1), np.inf)
                stderr = np.sqrt(var_w / np.maximum(k, 1))
            mean_luma = (sum_rgb @ _LUMA) / np.maximum(n, 1)
            done = (k >= 2) & (stderr <= tol * (mean_luma + 0.02))
        else:
            done = np.zeros(n_pix, bool)
        active = ~(done | capped)
        if log is not None:
            print(
                f"[adaptive] wave {waves}: active {int(active.sum())}"
                f"/{n_pix}, mean spp {float(n.mean()):.1f}",
                file=log,
            )

    mean = sum_rgb / np.maximum(n, 1)[:, None]
    img = np.clip(mean, 0.0, 1.0).astype(np.float32)  # contract C3 clamp
    return AdaptiveResult(
        image=img.reshape(cfg.height, cfg.width, 3),
        spp_map=n.astype(np.int32).reshape(cfg.height, cfg.width),
        traces=(extends, probes),
        waves=waves,
        total_samples=int(n.sum()),
        uniform_samples=n_pix * cfg.spp,
    )
