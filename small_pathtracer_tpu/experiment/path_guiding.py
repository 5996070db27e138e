"""Voxel path guiding — the reference's RL state-space idea, made real.

The reference's Q-learning side quest (SURVEY.md section 0 program (2);
/root/reference/src/smallpt.cpp:383-406,424-442) builds a voxel-quantized
state dictionary but never feeds it back into rendering — at HEAD it only
false-colors the image. This module completes the idea the reference was
reaching for: learn a per-voxel "bright direction" from a cheap training
pass, then importance-sample scattering toward it through a DEFENSIVE
MIXTURE, which keeps the estimator unbiased:

    pass 1 (train): plain cosine render; every emission pickup deposits its
        luminance-weighted incoming direction into the voxel of the LAST
        DIFFUSE vertex it left (specular/refractive chain vertices pass
        credit through — the lobe learns "toward the mirror/glass that
        leads to light") — a (V, 3) moment table (one scatter-add per
        bounce).
    pass 2 (guide): at each diffuse bounce in voxel v with a confident
        lobe mu_v, sample   beta * power-cosine(k)-around-mu_v  +
        (1-beta) * cosine-around-n   and weight by the true mixture pdf:

            w = (cos_n / pi) / (beta * pdf_lobe + (1 - beta) * cos_n / pi)
            pdf_lobe = (k+1)/(2 pi) * max(cos_mu, 0)^k

        (the baseline cosine estimator has w == 1; voxels without a lobe
        fall back to it exactly). Any beta < 1 keeps every direction with
        cos_n > 0 reachable, so the estimator stays unbiased for ANY lobe
        and ANY sharpness k — the guide only shapes variance.

Materials: SPEC mirrors and REFR dielectrics scatter exactly as in the
wavefront integrator (wavefront._spec_scatter/_refr_scatter — C16
semantics); guiding applies only at DIFF vertices, so the estimator stays
unbiased on mixed-material scenes.

Estimators:
    estimator="cosine" (default): guided continuation only.
    estimator="nee": textbook next-event estimation (one shadow ray per
        diffuse vertex, next light-emission pickup suppressed — the same
        unbiased split as wavefront's nee_textbook) with the GUIDED mixture
        as the continuation sampler. Guiding then accelerates exactly the
        indirect transport NEE leaves behind.

Voxels follow the reference's 10-unit quantization over its grid-scan
bounds (x in [0,100), y in [-1,85), z in [-1,171), smallpt.cpp:386-388).
This is the jnp estimator (scan schedule, fixed depth); it has no kernel
form (ROADMAP: a guided kernel that fetches lobes by voxel id).

Measured (tests/test_path_guiding.py): on a small-light Cornell variant,
guided MSE is well below cosine MSE at equal spp while the high-spp means
agree (unbiasedness).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..camera.pinhole import CameraParams, primary_rays_cfg
from ..config import RenderConfig
from ..core import rng, vecmath as vm
from ..geometry.intersect import shade_info, trace
from ..integrator import sampling
from ..integrator.wavefront import _refr_scatter, _spec_scatter
from ..scene.types import DIFF, REFR, SPEC, Scene, object_arrays

# Reference grid-scan bounds (smallpt.cpp:386-388), 10-unit voxels.
_LO = np.array([0.0, -1.0, -1.0], np.float32)
_HI = np.array([100.0, 85.0, 171.0], np.float32)
_NVOX = tuple(int(v) for v in np.ceil((_HI - _LO) / 10.0))  # (10, 9, 18)
N_VOXELS = _NVOX[0] * _NVOX[1] * _NVOX[2]


def voxel_id(x) -> jnp.ndarray:
    """(N,3) points -> (N,) flat voxel ids (clamped into the grid)."""
    ix = jnp.clip(
        jnp.floor((x - _LO[None]) / 10.0).astype(jnp.int32),
        0, jnp.asarray(_NVOX, jnp.int32) - 1,
    )
    return (ix[:, 0] * _NVOX[1] + ix[:, 1]) * _NVOX[2] + ix[:, 2]


def _require_single_light(scene: Scene, what: str) -> None:
    if scene.lights is not None:
        raise NotImplementedError(
            f"{what} with estimator='nee' supports single-light scenes "
            "only (the guiding demo has no light-list selection); use the "
            "wavefront/megakernel renderers for multi-emitter scenes"
        )


def _reject_glossy(scene: Scene, what: str) -> None:
    from ..scene.types import scene_has_glos

    if scene_has_glos(scene):
        raise NotImplementedError(
            f"{what} does not support GLOS (glossy) primitives: the guided "
            "mixture reweights against the cosine continuation pdf; render "
            "glossy scenes unguided (cosine / nee_textbook / mis)"
        )


def _spawn_all(cam: CameraParams, cfg: RenderConfig, seed):
    w, h, spp = cfg.width, cfg.height, cfg.spp
    uniform = rng.make_uniform_fn(cfg.rng_backend)
    pix = jnp.arange(w * h, dtype=jnp.uint32)
    s = jnp.arange(spp, dtype=jnp.uint32)
    path_id = (pix[:, None] * jnp.uint32(spp) + s[None, :]).reshape(-1)
    px = jnp.broadcast_to(
        (pix[:, None] % jnp.uint32(w)).astype(jnp.int32), (w * h, spp)
    ).reshape(-1)
    py = jnp.broadcast_to(
        (pix[:, None] // jnp.uint32(w)).astype(jnp.int32), (w * h, spp)
    ).reshape(-1)
    o, d = primary_rays_cfg(cam, cfg, px, py, path_id, seed, uniform)
    return o, d, path_id


def _rr(cfg: RenderConfig, depth, u_rr, albedo, alive):
    """C10 Russian roulette: (survive-masked alive, 1/p throughput scale)."""
    p_max = jnp.max(albedo, axis=-1)
    rr_active = (depth > cfg.rr_start_depth) | (p_max <= 0.0)
    survive = jnp.where(rr_active, u_rr < p_max, True)
    p_pos = p_max > 0.0
    inv_p = jnp.where(
        rr_active & p_pos, 1.0 / jnp.where(p_pos, p_max, 1.0), 1.0
    )
    return alive & survive, inv_p


def _material_mix(sh, d_in, u_coin, guided_dir, guided_w):
    """Select per-material scatter: guided mixture at DIFF vertices, C16
    mirror/dielectric elsewhere (wavefront._spec_scatter/_refr_scatter)."""
    spec_dir, spec_w = _spec_scatter(sh, d_in)
    refr_dir, refr_w = _refr_scatter(sh, d_in, u_coin)
    is_spec = (sh.refl == SPEC)[:, None]
    is_refr = (sh.refl == REFR)[:, None]
    new_d = jnp.where(
        is_spec, spec_dir, jnp.where(is_refr, refr_dir, guided_dir)
    )
    w = jnp.where(
        sh.refl == SPEC, spec_w, jnp.where(sh.refl == REFR, refr_w, guided_w)
    )
    return new_d, w


def train_guide(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                n_bounces: int, seed) -> jnp.ndarray:
    """Cosine-sampled training pass; returns the (V, 3) direction-moment
    table: sum over emission pickups of (pickup luminance) * (direction
    that left the path's LAST DIFFUSE vertex), deposited at that vertex's
    voxel. Specular/refractive chains between the diffuse vertex and the
    emitter pass credit through unchanged, so the learned lobe points at
    whatever leads to light — emitter, mirror, or glass."""
    _reject_glossy(scene, "train_guide")
    return _train_guide(scene, cam, cfg, n_bounces, seed)


@partial(jax.jit, static_argnums=(2, 3))
def _train_guide(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                 n_bounces: int, seed) -> jnp.ndarray:
    uniform = rng.make_uniform_fn(cfg.rng_backend)
    o, d, path_id = _spawn_all(cam, cfg, seed)
    n = o.shape[0]
    T = jnp.ones((n, 3), jnp.float32)
    alive = jnp.ones((n,), jnp.bool_)
    moments = jnp.zeros((N_VOXELS, 3), jnp.float32)
    # Ring of the last K_CREDIT diffuse vertices a path left (position +
    # outgoing direction). Depositing pickup credit at EVERY ring entry —
    # not just the last diffuse vertex — teaches MULTI-BOUNCE transport:
    # with last-vertex-only credit, a voxel two diffuse bounces from the
    # emitter never learns anything (round-4 finding on cornell_alcove:
    # the floor's lobes stayed empty because the light is only reachable
    # floor -> slot -> lit cavity wall -> emitter).
    K_CREDIT = 3
    diff_x = [o for _ in range(K_CREDIT)]
    diff_d = [d for _ in range(K_CREDIT)]
    diff_valid = [jnp.zeros((n,), jnp.bool_) for _ in range(K_CREDIT)]

    for b in range(n_bounces):
        depth = jnp.full((n,), b + 1, jnp.int32)
        hit = trace(scene, o, d)
        sh = shade_info(scene, o, d, hit)
        pick = jnp.sum(T * sh.emission, axis=-1) * alive
        for kk in range(K_CREDIT):
            # Older ring slots get geometrically less credit: a direction
            # two diffuse bounces before the pickup is weaker evidence of
            # "where the light is" than the last one, and equal credit
            # measurably blurs the lobes on easy scenes (round-4 box
            # regression while bootstrapping the alcove presets).
            dep = pick * diff_valid[kk] * np.float32(0.5 ** kk)
            moments = moments.at[voxel_id(diff_x[kk])].add(
                diff_d[kk] * dep[:, None]
            )

        ctr = depth.astype(jnp.uint32) * jnp.uint32(rng.DRAWS_PER_BOUNCE)
        u_rr = uniform(seed, path_id, ctr + jnp.uint32(rng.P_RR))
        u1 = uniform(seed, path_id, ctr + jnp.uint32(rng.P_SCATTER_U))
        u2 = uniform(seed, path_id, ctr + jnp.uint32(rng.P_SCATTER_V))
        u_refr = uniform(seed, path_id, ctr + jnp.uint32(rng.P_REFR_COIN))
        alive, inv_p = _rr(cfg, depth, u_rr, sh.albedo, alive)
        cos_dir = sampling.sample_cosine(sh.n, u1, u2)
        cos_w = jnp.ones((n,), jnp.float32)
        new_d, w = _material_mix(sh, d, u_refr, cos_dir, cos_w)
        T = T * sh.albedo * (inv_p * w)[:, None]
        is_diff = sh.refl == DIFF
        shift = (alive & is_diff)[:, None]
        shift1 = alive & is_diff
        # Ring shift: slot 0 = most recent diffuse vertex.
        for kk in range(K_CREDIT - 1, 0, -1):
            diff_x[kk] = jnp.where(shift, diff_x[kk - 1], diff_x[kk])
            diff_d[kk] = jnp.where(shift, diff_d[kk - 1], diff_d[kk])
            diff_valid[kk] = jnp.where(
                shift1, diff_valid[kk - 1], diff_valid[kk]
            )
        diff_x[0] = jnp.where(shift, sh.x, diff_x[0])
        diff_d[0] = jnp.where(shift, new_d, diff_d[0])
        diff_valid[0] = alive & (diff_valid[0] | is_diff)
        o = jnp.where(alive[:, None], sh.x, o)
        d = jnp.where(alive[:, None], new_d, d)
    return moments


def sample_power_cosine(mu, u1, u2, k: float):
    """Sample a cos^k lobe around unit axis mu (k=1 is the cosine lobe).

    theta: cos(theta) = u2^(1/(k+1)); pdf = (k+1)/(2 pi) * cos^k."""
    uax, vax = vm.onb_from_w(mu)
    sr1, cr1 = vm.sincos_2pi(u1)
    wz = u2 ** (1.0 / (k + 1.0))
    sin_t = jnp.sqrt(jnp.maximum(1.0 - wz * wz, 0.0))
    d = (
        uax * (cr1 * sin_t)[:, None]
        + vax * (sr1 * sin_t)[:, None]
        + mu * wz[:, None]
    )
    return vm.norm(d)


def guide_lobes(moments, min_weight: float = 1e-3):
    """(V, 3) moments -> (mu (V,3) unit lobes, use (V,) bool)."""
    norm = jnp.linalg.norm(moments, axis=-1, keepdims=True)
    use = norm[:, 0] > min_weight
    mu = moments / jnp.maximum(norm, 1e-12)
    return mu, use


def _guided_diffuse(sh, mu_tab, use_tab, u1, u2, u_coin, beta: float,
                    k: float):
    """Guided-mixture continuation at a (nominally diffuse) vertex.

    Returns (dir (N,3), weight (N,), ok (N,) — lanes whose sample carries
    nonzero BRDF; weight is the cosine-pdf-over-mixture-pdf ratio, exactly
    1 wherever the voxel has no lobe)."""
    inv_pi = 1.0 / jnp.pi
    vid = voxel_id(sh.x)
    mu = mu_tab[vid]                       # (N, 3)
    guided = use_tab[vid] & (sh.refl == DIFF)
    beta_eff = jnp.where(guided, beta, 0.0)

    # Mixture components: sharp power-cosine lobe around the voxel
    # direction mu, cosine lobe around the shading normal n.
    d_lobe = sample_power_cosine(mu, u1, u2, k)
    d_cos = sampling.sample_cosine(sh.n, u1, u2)
    take_lobe = u_coin < beta_eff
    new_d = jnp.where(take_lobe[:, None], d_lobe, d_cos)
    cos_n = jnp.sum(new_d * sh.n, axis=-1)
    cos_mu = jnp.sum(new_d * mu, axis=-1)
    pdf_lobe = (
        (k + 1.0) / (2.0 * jnp.pi)
        * vm.pow_const(jnp.maximum(cos_mu, 0.0), k)
    )
    pdf_cos = jnp.maximum(cos_n, 0.0) * inv_pi
    pdf_mix = beta_eff * pdf_lobe + (1.0 - beta_eff) * pdf_cos
    # Lobe samples below the surface (cos_n <= 0) carry zero BRDF:
    # weight 0 (they die, but unbiasedly — the cosine component keeps
    # the full hemisphere covered).
    ok = (pdf_mix > 1e-9) & (cos_n > 0.0)
    w = jnp.where(
        ok,
        (jnp.maximum(cos_n, 0.0) * inv_pi)
        / jnp.where(ok, pdf_mix, 1.0),
        0.0,
    )
    return new_d, w, ok


def render_guided(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                  seed, guide, n_bounces: int, beta: float = 0.5,
                  k: float = 8.0, estimator: str = "cosine"):
    """Guided render: mixture-sampled scattering with exact pdf
    reweighting. guide = (mu, use) from guide_lobes; beta = lobe
    probability in guided voxels; k = lobe sharpness (power-cosine
    exponent). SPEC/REFR vertices scatter per C16 (unguided).

    estimator: "cosine" — guided continuation only; "nee" — textbook
    shadow-ray NEE at each diffuse vertex + guided continuation (the
    next emission pickup is suppressed; unbiased split, matching
    wavefront's nee_textbook).

    Returns the unclamped linear (h, w, 3) mean image."""
    if estimator not in ("cosine", "nee"):
        raise ValueError(f"unknown guided estimator {estimator!r}")
    if estimator == "nee":
        _require_single_light(scene, "render_guided")
    _reject_glossy(scene, "render_guided")
    return _render_guided(
        scene, cam, cfg, seed, guide, n_bounces, beta, k, estimator
    )


@partial(jax.jit, static_argnums=(2, 5, 6, 7, 8))
def _render_guided(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                   seed, guide, n_bounces: int, beta: float,
                   k: float, estimator: str):
    mu_tab, use_tab = guide
    uniform = rng.make_uniform_fn(cfg.rng_backend)
    o, d, path_id = _spawn_all(cam, cfg, seed)
    n = o.shape[0]
    T = jnp.ones((n, 3), jnp.float32)
    L = jnp.zeros((n, 3), jnp.float32)
    alive = jnp.ones((n,), jnp.bool_)
    no_emit = jnp.zeros((n,), jnp.bool_)
    nee = estimator == "nee"
    if nee:
        light = scene.light
        _, emission_all, _ = object_arrays(scene)
        e_light = emission_all[jnp.asarray(light.light_obj_id, jnp.int32)]

    for b in range(n_bounces):
        depth = jnp.full((n,), b + 1, jnp.int32)
        hit = trace(scene, o, d)
        sh = shade_info(scene, o, d, hit)
        emit = alive[:, None].astype(jnp.float32) * T * sh.emission
        if nee:
            # Suppress the light pickup the previous bounce's shadow ray
            # already estimated (wavefront._bounce_core textbook logic).
            is_light_hit = hit.hit & (
                hit.obj_id == jnp.asarray(light.light_obj_id, jnp.int32)
            )
            emit = emit * (~(no_emit & is_light_hit))[:, None]
        L = L + emit

        ctr = depth.astype(jnp.uint32) * jnp.uint32(rng.DRAWS_PER_BOUNCE)
        u_rr = uniform(seed, path_id, ctr + jnp.uint32(rng.P_RR))
        u1 = uniform(seed, path_id, ctr + jnp.uint32(rng.P_SCATTER_U))
        u2 = uniform(seed, path_id, ctr + jnp.uint32(rng.P_SCATTER_V))
        u_coin = uniform(seed, path_id, ctr + jnp.uint32(rng.P_MIX_COIN))
        u_refr = uniform(seed, path_id, ctr + jnp.uint32(rng.P_REFR_COIN))

        # RR gates only the CONTINUATION (wavefront._bounce_core textbook
        # semantics): the direct shadow-ray term below fires for pre-RR
        # live lanes with pre-1/p throughput, so no compensation is owed.
        alive_post, inv_p = _rr(cfg, depth, u_rr, sh.albedo, alive)

        if nee:
            # Textbook direct term at live diffuse vertices (one shadow
            # ray; same nee_weight formula as C13 — sampling.nee_weight).
            u_lu = uniform(seed, path_id, ctr + jnp.uint32(rng.P_LIGHT_U))
            u_lv = uniform(seed, path_id, ctr + jnp.uint32(rng.P_LIGHT_V))
            lp = sampling.sample_light_point(light, u_lu, u_lv)
            d_l = vm.norm(lp - sh.x)
            probe = trace(scene, sh.x, d_l)
            success = probe.hit & (
                probe.obj_id == jnp.asarray(light.light_obj_id, jnp.int32)
            )
            t_safe = jnp.where(success, probe.t, 1.0)
            w_d = sampling.nee_weight(light, d_l, sh.n, t_safe)
            diff_live = alive & (sh.refl == DIFF)
            gate = (diff_live & success).astype(jnp.float32)
            L = L + (gate * w_d)[:, None] * T * sh.albedo * e_light
            no_emit = alive_post & (sh.refl == DIFF)

        g_dir, g_w, g_ok = _guided_diffuse(
            sh, mu_tab, use_tab, u1, u2, u_coin, beta, k
        )
        new_d, w = _material_mix(sh, d, u_refr, g_dir, g_w)
        # g_ok gates only diffuse lanes (specular branches always carry).
        ok = jnp.where(sh.refl == DIFF, g_ok, True)
        T = T * sh.albedo * (inv_p * w)[:, None]
        alive = alive_post & ok
        o = jnp.where(alive[:, None], sh.x, o)
        d = jnp.where(alive[:, None], new_d, d)
        no_emit = no_emit & alive if nee else no_emit

    return (
        L.reshape(cfg.height * cfg.width, cfg.spp, 3)
        .mean(axis=1)
        .reshape(cfg.height, cfg.width, 3)
    )
