"""Edge-aware a-trous wavelet denoiser for Monte-Carlo renders.

A vectorized reconstruction filter in the style of Dammertz et al. 2010
("Edge-Avoiding A-Trous Wavelet Transform for Fast Global Illumination
Filtering") with SVGF-flavored edge-stopping weights (Schied et al. 2017),
guided by the first-hit feature buffers of ``utils/aov.py``:

- the beauty image is DEMODULATED by first-hit albedo (texture detail is
  noise-free in the AOV, so only the illumination signal is filtered and the
  albedo edge never blurs);
- each of ``iterations`` passes convolves with a 5x5 B3-spline kernel dilated
  by 2^i (a-trous: constant 25-tap cost per pass, kernel support doubles each
  pass), every tap weighted by normal / depth / albedo / luminance edge stops;
- depth uses a screen-space depth-gradient scale so slanted walls (large
  depth deltas along the surface) are not mistaken for silhouettes;
- the luminance stop is variance-adaptive (SVGF): its width scales with a
  3x3 spatial estimate of the local luminance noise, recomputed each pass,
  so unconverged spiky regions smooth hard while converged detail is kept.

Everything is elementwise/shift jnp — XLA fuses each pass into a handful of
loops; there are no gathers and no data-dependent shapes. The reference
has no denoiser (its answer to noise is more spp, smallpt.cpp:508); this is
framework surface for the quality-per-second regime an accelerator's
throughput opens up (hundreds of spp land in <1 s, a filtered 32-spp render lands in
milliseconds at a quality a raw render needs ~8x the samples for: at 96x72
a filtered 4-spp Cornell render has lower MSE vs a 256-spp target than a raw
32-spp render — measured in tests/test_denoise.py and PERF.md).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# 1D B3-spline coefficients; the 5x5 kernel is the outer product.
_B3 = (1.0 / 16.0, 1.0 / 4.0, 3.0 / 8.0, 1.0 / 4.0, 1.0 / 16.0)

# Rec.709 luma weights on linear radiance.
_LUMA = (0.2126, 0.7152, 0.0722)


def _luminance(img):
    return (
        _LUMA[0] * img[..., 0] + _LUMA[1] * img[..., 1] + _LUMA[2] * img[..., 2]
    )


def _shift2d(img, dy: int, dx: int):
    """Shift img by (dy, dx) with edge-replicate padding.

    Works for (h, w) and (h, w, c). Out-of-bounds taps read the nearest
    edge pixel; the edge stops (feature deltas are zero against a
    replicated pixel only if the features match) keep this from smearing.
    """
    h, w = img.shape[0], img.shape[1]
    ys = jnp.clip(jnp.arange(h) + dy, 0, h - 1)
    xs = jnp.clip(jnp.arange(w) + dx, 0, w - 1)
    return img[ys][:, xs]


def _box3(x):
    """3x3 box mean with edge-replicate padding (for variance estimates)."""
    acc = jnp.zeros_like(x)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            acc = acc + _shift2d(x, dy, dx)
    return acc / 9.0


@partial(jax.jit, static_argnames=("iterations",))
def _atrous(illum, normal, depth, albedo, iterations: int,
            sigma_l, sigma_n, sigma_z, sigma_a):
    # Screen-space |gradient| of depth (forward differences, replicated
    # edge): scales the depth stop so in-plane depth change along a slanted
    # surface is tolerated while true silhouette steps are not.
    dzdx = jnp.abs(_shift2d(depth, 0, 1) - depth)
    dzdy = jnp.abs(_shift2d(depth, 1, 0) - depth)
    zgrad = jnp.maximum(dzdx, dzdy)

    lum_a = _luminance(albedo)
    # The normal stop compares DIRECTIONS; the mean-normal magnitude (which
    # dips below 1 wherever samples disagree) would otherwise zero the
    # whole neighborhood under the ^sigma_n exponent. The geometric edges
    # the magnitude encodes are already stopped by depth + direction.
    n_unit = normal / jnp.maximum(
        jnp.linalg.norm(normal, axis=-1, keepdims=True), 1e-6
    )

    def one_pass(illum, step: int):
        acc = jnp.zeros_like(illum)
        wsum = jnp.zeros(illum.shape[:2], illum.dtype)
        lum_c = _luminance(illum)
        # SVGF-style variance-adaptive luminance stop: the stop width
        # scales with the LOCAL noise level (3x3 spatial variance of the
        # current luminance), so spiky unconverged regions smooth hard
        # while converged detail keeps a tight stop. Recomputed per pass —
        # as the image converges the stop tightens itself.
        sd = jnp.sqrt(jnp.maximum(_box3(lum_c * lum_c)
                                  - _box3(lum_c) ** 2, 0.0))
        denom = sigma_l * sd + 1e-3
        for j, hy in enumerate(_B3):
            for i, hx in enumerate(_B3):
                dy, dx = (j - 2) * step, (i - 2) * step
                h_k = hy * hx
                q_illum = _shift2d(illum, dy, dx)
                # Edge stops (all in [0, 1]).
                ndot = jnp.sum(n_unit * _shift2d(n_unit, dy, dx), axis=-1)
                w_n = jnp.maximum(ndot, 0.0) ** sigma_n
                dz = jnp.abs(_shift2d(depth, dy, dx) - depth)
                tap_len = float(max(abs(dy), abs(dx), 1))
                w_z = jnp.exp(-dz / (sigma_z * zgrad * tap_len + 1e-2))
                da = jnp.abs(_shift2d(lum_a, dy, dx) - lum_a)
                w_a = jnp.exp(-(da * da) / (sigma_a * sigma_a))
                dl = jnp.abs(_shift2d(lum_c, dy, dx) - lum_c)
                w_l = jnp.exp(-dl / denom)
                w = h_k * w_n * w_z * w_a * w_l
                acc = acc + q_illum * w[..., None]
                wsum = wsum + w
        return acc / jnp.maximum(wsum, 1e-8)[..., None]

    for it in range(iterations):
        illum = one_pass(illum, 1 << it)
    return illum


def denoise(color, aovs, *, iterations: int = 3, sigma_l: float = 4.0,
            sigma_n: float = 64.0, sigma_z: float = 2.0,
            sigma_a: float = 0.15):
    """Filter a LINEAR radiance image using first-hit feature buffers.

    color: (h, w, 3) linear radiance (pre-tonemap — filter before gamma).
    aovs: dict from ``utils.aov.render_aovs`` (albedo / normal / depth).
    iterations: a-trous passes; support is (4 * 2^iterations + 1) pixels.
    sigma_l: luminance stop in units of the LOCAL luminance noise std
        (3x3 spatial estimate, recomputed per pass); bigger = smoother.
    sigma_n: normal stop exponent (bigger = stricter at curved geometry).
    sigma_z: depth stop in units of the local screen-space depth gradient.
    sigma_a: albedo-luma stop (separates materials the demodulation can't,
        e.g. equal-luma different-hue walls are separated by the normal/depth
        stops anyway; this one guards textured-albedo edges).

    Returns the filtered (h, w, 3) linear image.
    """
    color = jnp.asarray(color)
    albedo = aovs["albedo"]
    # Demodulate where the albedo is meaningful; lights / misses (albedo ~ 0)
    # pass through unscaled so emission is preserved exactly.
    safe = jnp.where(albedo > 1e-3, albedo, 1.0)
    illum = color / safe
    out = _atrous(
        illum,
        aovs["normal"],
        aovs["depth"],
        albedo,
        iterations,
        jnp.float32(sigma_l),
        jnp.float32(sigma_n),
        jnp.float32(sigma_z),
        jnp.float32(sigma_a),
    )
    return out * safe
