"""Wavefront path integrator.

The reference's recursive ``radiance()`` (/root/reference/src/smallpt.cpp:
419-496; call stack SURVEY.md section 3.2) becomes an iterative loop over a
live-masked SoA of paths:

    state = {o, d, throughput, L, alive, depth}
    per bounce: trace -> shade -> RR -> (estimator-specific scatter) -> write

Semantics reproduced exactly (SURVEY.md section 0.1):
- C10 Russian roulette: starts after depth 5 (or immediately when the max
  albedo component p == 0); survivor throughput scaled by 1/p; no depth cap.
- C13 NEE-as-continuation: at each diffuse bounce the light sample *becomes*
  the bounce direction when its nearest hit is the light object; otherwise
  fall back to cosine scattering with weight 1. Includes the reference's
  oversized light area (1296) and the 81.6-vs-81.5 plane mismatch (both live
  in the scene's LightSampler params, scene/presets.py).
- C14: contribution = sum over bounces of throughput * emission, throughput
  updated as T *= f * (PDF_inverse * BRDF).
- C15 escaped rays: shade stale object id 0 at x=(0,0,0) and keep bouncing.
- C16 (stretch): SPEC mirror and REFR dielectric branches, following the
  commented reference / original-smallpt formulas (smallpt.cpp:481-495), with
  the splitting branch replaced by always-Russian-roulette (unbiased,
  wavefront-friendly).

Randomness: counter RNG, draw = f(seed, path_id, (depth+1)*8 + purpose), so
images are bitwise independent of sharding and wavefront scheduling
(core/rng.py).
"""

from __future__ import annotations

import math
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

from ..camera.pinhole import CameraParams, primary_rays_cfg
from ..config import RenderConfig
from ..core import film, ld, rng, vecmath as vm
from ..geometry.intersect import Hit, shade_info, trace
from ..scene.types import (
    DIFF, GLOS, LIGHT_SPHERE, REFR, SPEC, Scene, SphereLight, object_arrays,
    scene_has_glos, scene_has_sphere_light,
)
from . import sampling


class PathState(NamedTuple):
    o: jnp.ndarray        # (N,3) ray origin
    d: jnp.ndarray        # (N,3) ray direction (normalized)
    T: jnp.ndarray        # (N,3) throughput
    L: jnp.ndarray        # (N,3) accumulated radiance
    alive: jnp.ndarray    # (N,) bool
    depth: jnp.ndarray    # (N,) int32 — the reference's depth counter
    path_id: jnp.ndarray  # (N,) uint32 — global (pixel, sample) identity
    n_traces: jnp.ndarray  # (2,) f32 — [extend, probe] scene-trace counters
    #   (extend = one per live bounce, probe = NEE shadow/continuation
    #   probes; total = sum — the bench metric; extend/paths = the exact
    #   mean path length, fixing the reference's broken C17 stat)
    no_emit: jnp.ndarray  # (N,) bool — skip next emission pickup
    #   (nee_textbook double-count guard; always False otherwise)
    mis_pdf: jnp.ndarray  # (N,) f32 — estimator="mis": the previous
    #   diffuse vertex's BSDF pdf (cos/pi) of this ray's direction; 0 when
    #   the previous vertex did not light-sample (primary/specular) —
    #   drives the balance-heuristic pickup weight. Always 0 otherwise.


def init_paths(o, d, path_id) -> PathState:
    n = o.shape[0]
    return PathState(
        o=o,
        d=d,
        T=jnp.ones((n, 3), o.dtype),
        L=jnp.zeros((n, 3), o.dtype),
        alive=jnp.ones((n,), jnp.bool_),
        depth=jnp.zeros((n,), jnp.int32),
        path_id=path_id,
        n_traces=jnp.zeros((2,), jnp.float32),
        no_emit=jnp.zeros((n,), jnp.bool_),
        mis_pdf=jnp.zeros((n,), jnp.float32),
    )


GLOS_ESTIMATORS = ("cosine", "nee_textbook", "mis")


def check_glos_estimator(scene: Scene, cfg: RenderConfig) -> None:
    """Reject GLOS scenes under the reference-parity estimators.

    The C13 continuation family (``nee``/``mixture``) hard-codes the
    diffuse cos/pi BRDF into its replace-the-bounce weight
    (smallpt.cpp:471-472), and the ``uniform`` pair reproduces the
    committed as-is weights (C12) — neither has glossy semantics. GLOS is
    served by BSDF sampling (``cosine``), textbook NEE, and ``mis``."""
    if cfg.estimator not in GLOS_ESTIMATORS and scene_has_glos(scene):
        raise ValueError(
            f"estimator {cfg.estimator!r} is a reference-parity estimator "
            f"with no glossy (GLOS) semantics; use one of "
            f"{GLOS_ESTIMATORS} for scenes with glossy primitives"
        )


def _select_light(scene: Scene, cfg: RenderConfig, u):
    """Per-lane NEE light: the single C13 sampler, or — when the scene
    carries a light list — the light chosen by the P_LIGHT_SEL draw.

    Returns (light, q_sel, kind): a (possibly lane-batched) LightSampler /
    SphereLight, the per-lane selection probability ((N,) — divide the NEE
    weight by it; None for single-light scenes), and the per-lane geometry
    kind ((N,) int32 for a kind-carrying list; None for parallelogram-only
    lists and single lights — a single SphereLight is identified by its
    type)."""
    if scene.lights is None:
        if (
            isinstance(scene.light, SphereLight)
            and cfg.light_sample_mode == "glibc_overflow"
        ):
            raise ValueError(
                "light_sample_mode='glibc_overflow' reproduces the "
                "reference's rect-sampler int32-overflow quirk (C13a) and "
                "has no sphere-light analogue; use "
                "light_sample_mode='intended' for SphereLight scenes"
            )
        return scene.light, None, None
    if cfg.light_sample_mode == "glibc_overflow":
        raise ValueError(
            "light_sample_mode='glibc_overflow' reproduces the reference's "
            "single-light int32-overflow quirk (C13a) and has no "
            "multi-emitter analogue; use light_sample_mode='intended' for "
            "scenes with a light list"
        )
    _, emission_all, _ = object_arrays(scene)
    probs = sampling.light_select_probs(
        scene.lights, emission_all, cfg.light_select
    )
    idx = sampling.sample_light_index(probs, u[rng.P_LIGHT_SEL])
    return (
        sampling.gather_light(scene.lights, idx),
        probs[idx],
        sampling.gather_light_kind(scene.lights, idx),
    )


def _nee_sample(light, kind, probe_o, nl, u, glibc: bool):
    """Unified NEE direction + weight for a (possibly lane-batched) light.

    Returns (d_l (N,3), w_nee_of_t, sphere_mask) where
    w_nee_of_t(t_safe) -> (N,) is the C13-style PDF_inverse * BRDF weight —
    parallelograms need the traced distance (|A cos_l|/t^2), sphere cones
    do not (2*pi*(1-cos_max)), so the weight is closed over everything but
    t — and sphere_mask ((N,) bool or None) marks lanes whose sampled
    light is a sphere. Callers MUST front-side gate those lanes:
    success &= d_l . nl > 0. The cone is built from the light's position
    alone, so near-tangent geometry (original smallpt: the whole ceiling
    grazes the rad-600 sky light) can aim it BEHIND the shading surface;
    the probe escapes through open space and the two-sided |cos| weight
    would count light transmitted through an opaque wall (measured: ~6x
    blowup on smallpt_original_true). Parallelogram lanes keep the
    reference's two-sided semantics (C13 parity).

    kind: None = all parallelogram (unless light IS a SphereLight);
    (N,) int32 = per-lane mixed-kind list (LIGHT_RECT / LIGHT_SPHERE)."""
    u1, u2 = u[rng.P_LIGHT_U], u[rng.P_LIGHT_V]
    if isinstance(light, SphereLight):
        d_l = sampling.sample_sphere_dir(
            light.center, light.radius, probe_o, u1, u2
        )

        def w_fn(t_safe):
            return sampling.sphere_nee_weight(
                light.center, light.radius, probe_o, d_l, nl
            )

        return d_l, w_fn, jnp.ones(nl.shape[:-1], jnp.bool_)
    if kind is None:
        if glibc:
            lp = sampling.sample_light_point_glibc(light, u1, u2)
        else:
            lp = sampling.sample_light_point(light, u1, u2)
        d_l = vm.norm(lp - probe_o)

        def w_fn(t_safe):
            return sampling.nee_weight(light, d_l, nl, t_safe)

        return d_l, w_fn, None
    # Mixed-kind list: compute both samplers on every lane, select by kind.
    # K is tiny and lists are rare — the double work is a handful of
    # elementwise ops; the select keeps the wavefront branch-free.
    lp = sampling.sample_light_point(light, u1, u2)
    d_rect = vm.norm(lp - probe_o)
    s_center, s_radius = sampling.list_entry_sphere_params(light)
    d_sph = sampling.sample_sphere_dir(s_center, s_radius, probe_o, u1, u2)
    is_sph = kind == LIGHT_SPHERE
    d_l = jnp.where(is_sph[:, None], d_sph, d_rect)

    def w_fn(t_safe):
        w_rect = sampling.nee_weight(light, d_l, nl, t_safe)
        w_sph = sampling.sphere_nee_weight(
            s_center, s_radius, probe_o, d_l, nl
        )
        return jnp.where(is_sph, w_sph, w_rect)

    return d_l, w_fn, is_sph


def _diff_scatter(scene: Scene, cfg: RenderConfig, sh, hit_x, u):
    """Diffuse-bounce direction + path weight for the configured estimator.

    u: dict of per-purpose uniforms. Returns (new_dir (N,3), weight (N,),
    probe_count (N,) f32 — scene traces spent on NEE probes, origin (N,3) —
    the next bounce's ray origin: sh.x, except for light-list NEE-success
    lanes which continue from the SHADOW_EPS-lifted probe origin so the
    emission-pickup trace robustly clears a near-coplanar origin surface
    (sampling.SHADOW_EPS), suppress (N,) bool — fallback lanes whose next
    sphere-light pickup must be suppressed; consumed by _bounce_core only
    when the scene has a sphere light, all-False otherwise)."""
    nl = sh.n
    cos_dir = sampling.sample_cosine(nl, u[rng.P_SCATTER_U], u[rng.P_SCATTER_V])
    no_sup = jnp.zeros(nl.shape[:-1], jnp.bool_)
    if cfg.estimator in ("cosine", "nee_textbook", "mis"):
        # nee_textbook/mis: continuation is plain cosine; the direct
        # (shadow-ray) term is added in _bounce_core.
        return cos_dir, jnp.ones(nl.shape[:-1], nl.dtype), jnp.zeros(nl.shape[:-1], jnp.float32), hit_x, no_sup
    if cfg.estimator in ("uniform", "uniform_corrected"):
        uni_dir = sampling.sample_uniform(nl, u[rng.P_SCATTER_U], u[rng.P_SCATTER_V])
        if cfg.estimator == "uniform":
            # As committed (C12): weight f reused with no 2*cos correction.
            w = jnp.ones(nl.shape[:-1], nl.dtype)
        else:
            w = 2.0 * jnp.maximum(vm.dot(uni_dir, nl), 0.0)
        return uni_dir, w, jnp.zeros(nl.shape[:-1], jnp.float32), hit_x, no_sup

    # NEE-as-continuation (C13), optionally mixed with cosine ("mixture").
    # Multi-emitter scenes (scene.lights set) first draw a light index k
    # with probability q_k and divide the NEE weight by q_k — unbiased for
    # the sum of direct light over the list (scene/types.LightList).
    # Sphere lights (scene/types.SphereLight or LIGHT_SPHERE list rows)
    # swap the area sampler for the uniform cone (sampling.sphere_cone).
    light, q_sel, kind = _select_light(scene, cfg, u)
    # Light-list probes fire from a SHADOW_EPS-lifted origin (see
    # sampling.SHADOW_EPS: list samplers target the true light plane, so
    # near-coplanar origins otherwise falsely self-occlude on f32
    # rounding); the single-light path keeps the reference's exact probe
    # geometry.
    probe_o = hit_x if q_sel is None else hit_x + sampling.SHADOW_EPS * nl
    d_l, w_fn, sphere_mask = _nee_sample(
        light, kind, probe_o, nl, u,
        glibc=cfg.light_sample_mode == "glibc_overflow",
    )
    probe = trace(scene, probe_o, d_l)
    success = probe.hit & (probe.obj_id == light.light_obj_id)
    if sphere_mask is not None:
        # Front-side gate for sphere-sampled lanes (_nee_sample docstring).
        success = success & (~sphere_mask | (vm.dot(d_l, nl) > 0.0))
    # Sanitize t before the 1/t^2 weight: a miss t = 1e20 overflows f32 in
    # t*t (=> inf => NaN cotangents through the where in reverse mode).
    t_safe = jnp.where(success, probe.t, 1.0)
    w_nee = w_fn(t_safe)
    if q_sel is not None:
        w_nee = w_nee / q_sel
    nee_dir = jnp.where(success[:, None], d_l, cos_dir)
    nee_w = jnp.where(success, w_nee, 1.0)
    # NEE-success lanes continue from the probe origin (== hit_x on the
    # single-light path) so the light-emission pickup retraces the probe.
    nee_o = jnp.where(success[:, None], probe_o, hit_x)
    # Sphere-light continuation is the BIAS-FREE C13 variant: EVERY
    # light-sampling diffuse lane that FAILED the probe falls back to
    # cosine (weight 1, like the reference) but suppresses SPHERE-kind
    # lights' emission pickup at its next hit (_bounce_core's
    # is_slight_hit tests sphere rows only) — sphere-direct is fully
    # estimated by the cone draws (1/q_k-weighted), so any BSDF-path
    # pickup of it double counts. The reference's fallback-with-pickup
    # structure is a ~+2% quirk for the small Cornell rect (kept
    # verbatim for parity: rect pickups are never suppressed) but a ~3x
    # blowup for a wide, mostly-occluded sphere cone, and a measured
    # ~+12% on a mixed rect+sphere list when only sphere-SAMPLED lanes
    # suppressed (tests/test_sphere_light.py::TestMixedList). Only
    # active when the scene has a sphere light (scene_has_sphere_light
    # gates no_emit in _bounce_core).
    suppress = ~success
    if cfg.estimator == "mixture":
        take = u[rng.P_MIX_COIN] < cfg.mixture_q
        new_dir = jnp.where(take[:, None], nee_dir, cos_dir)
        w = jnp.where(take, nee_w, 1.0)
        probes = take.astype(jnp.float32)
        origin = jnp.where(take[:, None], nee_o, hit_x)
        suppress = suppress & take
    else:
        new_dir, w = nee_dir, nee_w
        probes = jnp.ones(nl.shape[:-1], jnp.float32)
        origin = nee_o
    return new_dir, w, probes, origin, suppress


def _spec_scatter(sh, d_in):
    """Ideal mirror (C16, smallpt.cpp:482-483)."""
    return vm.reflect(d_in, sh.n_geom), jnp.ones(d_in.shape[:-1], d_in.dtype)


def _glos_scatter(sh, d_in, u1, u2):
    """Modified-Phong glossy lobe (GLOS — an extension; the reference's
    Refl_t stops at REFR, smallpt.cpp:72-74). Samples the power-cosine
    lobe around the mirror of the ORIENTED normal (two-sided surfaces
    reflect about the side being shaded, like _spec uses n_geom for the
    full-sphere mirror — for the one-sided lobe nl is the right axis).

    Returns (dir, weight, mirror): weight = (n+2)/(n+1) * max(dir . nl, 0)
    — the f*cos/pdf ratio with the cos^n factors cancelled
    (sampling.phong_weight); 0 when the lobe sample fell below the surface
    (the lane is absorbed/killed by the caller)."""
    mirror = vm.reflect(d_in, sh.n)
    d = sampling.sample_phong(mirror, u1, u2, sh.gloss)
    w = sampling.phong_weight(d, mirror, sh.n, sh.gloss)
    return d, w, mirror


def _refr_scatter(sh, d_in, u_coin):
    """Ideal dielectric (C16, smallpt.cpp:485-495), always-RR variant.

    nc=1 (air), nt=1.5 (glass); Schlick Fresnel; total internal reflection
    falls back to the mirror ray with weight 1. The reference's depth<=2
    splitting (tracing BOTH rays) is replaced by Russian roulette at every
    depth with P = .25 + .5*Re — an unbiased, fixed-shape choice."""
    n, nl = sh.n_geom, sh.n
    refl_dir = vm.reflect(d_in, n)
    into = vm.dot(n, nl) > 0.0
    nc, nt = 1.0, 1.5
    nnt = jnp.where(into, nc / nt, nt / nc)
    ddn = vm.dot(d_in, nl)
    cos2t = 1.0 - nnt * nnt * (1.0 - ddn * ddn)
    tir = cos2t < 0.0
    # Double-where: keep sqrt away from 0 for the AD path (TIR lanes select
    # the mirror ray anyway).
    sq = jnp.sqrt(jnp.where(cos2t > 0.0, cos2t, 1.0)) * (cos2t > 0.0)
    sign = jnp.where(into, 1.0, -1.0)
    tdir = vm.norm(
        d_in * nnt[:, None] - n * (sign * (ddn * nnt + sq))[:, None]
    )
    a, b = nt - nc, nt + nc
    r0 = (a * a) / (b * b)
    c = 1.0 - jnp.where(into, -ddn, vm.dot(tdir, n))
    re = r0 + (1.0 - r0) * c**5
    tr = 1.0 - re
    p = 0.25 + 0.5 * re
    pick_refl = (u_coin < p) | tir
    w = jnp.where(tir, 1.0, jnp.where(pick_refl, re / p, tr / (1.0 - p)))
    new_dir = jnp.where(pick_refl[:, None], refl_dir, tdir)
    return new_dir, w


class BounceOut(NamedTuple):
    """Result of one radiance()-body evaluation over the wavefront."""

    emit: jnp.ndarray      # (N,3) T*emission contribution (masked by alive)
    x: jnp.ndarray         # (N,3) hit point (next origin)
    new_dir: jnp.ndarray   # (N,3) next direction
    T: jnp.ndarray         # (N,3) next throughput
    alive: jnp.ndarray     # (N,) alive & survived RR
    traces_inc: jnp.ndarray  # (2,) f32 [extend, probe] traces this bounce
    logp_inc: jnp.ndarray  # (N,) log-prob of this bounce's RR decision
    #   (score-function/REINFORCE term for d E[L] / d albedo through the
    #   discrete survival decision — grad/score.py; 0 when p in {0, >=1})
    no_emit_next: jnp.ndarray  # (N,) bool — suppress emission next bounce
    #   (nee_textbook only; False elsewhere)
    mis_pdf_next: jnp.ndarray  # (N,) f32 — next bounce's balance-heuristic
    #   pdf carry (estimator="mis" only; 0 elsewhere)


def _bounce_core(scene: Scene, cfg: RenderConfig, seed, o, d, T, alive,
                 depth, path_id, no_emit=None, mis_pdf=None) -> BounceOut:
    """The radiance() body (smallpt.cpp:419-496) over a wavefront.

    ``depth`` is the reference's post-increment value (++depth,
    smallpt.cpp:448) for this frame. ``no_emit`` marks lanes whose previous
    bounce already estimated the light via a shadow ray (nee_textbook) —
    their light-emission pickup this bounce is suppressed to avoid double
    counting. ``mis_pdf`` is estimator="mis"'s float analogue: the BSDF
    pdf (cos/pi, solid angle) the previous diffuse vertex assigned to this
    ray — the light pickup is weighted by the balance heuristic
    p_bsdf / (p_bsdf + p_light) instead of being suppressed."""
    uniform = ld.make_uniform_cfg(cfg, rng.make_uniform_fn(cfg.rng_backend))
    textbook = cfg.estimator == "nee_textbook"
    mis = cfg.estimator == "mis"
    # Sphere-light C13 variant: fallback lanes suppress the sampled
    # light's next pickup (see _diff_scatter; scene_has_sphere_light).
    nee_sphere = cfg.estimator in ("nee", "mixture") and scene_has_sphere_light(scene)

    hit = trace(scene, o, d)
    sh = shade_info(scene, o, d, hit)

    alive_f = alive.astype(T.dtype)[:, None]
    # Emission pickup: `return hit.e + ...` contributes T*e once per bounce
    # (the terminal RR return of e is this same term — see SURVEY C10/C13).
    emit = alive_f * T * sh.emission
    if mis and mis_pdf is not None:
        # Balance-heuristic weight on BSDF-sampled light hits: the same
        # light could have been reached by the previous vertex's shadow
        # ray, whose solid-angle density there is
        # p_light = t^2 / (A * |cos(theta_l)|). Veach's w_bsdf =
        # p_bsdf / (p_bsdf + p_light); with p_bsdf = 0 (primary ray,
        # specular previous vertex, or non-light hit) the pickup is full.
        # Light lists: the shadow-ray strategy picks light k with
        # probability q_k, so the combined density at a direction hitting
        # light k is q_k * t^2/(A_k |cos_k|) — gather (q, A, n) of the HIT
        # light by id match (unlisted emitters keep w = 1: no shadow ray
        # ever samples them).
        if scene.lights is not None:
            _, emission_all_m, _ = object_arrays(scene)
            q_all = sampling.light_select_probs(
                scene.lights, emission_all_m, cfg.light_select
            )
            areas_m, normals_m = sampling.light_area_normal(scene.lights)
            match = hit.obj_id[:, None] == scene.lights.obj_id[None, :]
            is_light_hit = hit.hit & jnp.any(match, axis=1)
            k_idx = jnp.argmax(match, axis=1)
            area_l = areas_m[k_idx]
            n_l = normals_m[k_idx]
            q_hit = q_all[k_idx]
            cos_l = jnp.abs(vm.dot(d, n_l))
            p_light = q_hit * (hit.t * hit.t) / (
                area_l * jnp.maximum(cos_l, 1e-6)
            )
            if scene.lights.kind is not None:
                # Sphere rows: the shadow strategy's density at a
                # direction that reached light k from this ray's ORIGIN
                # (the previous vertex) is q_k / (2 pi (1 - cos_max(o))).
                ctr_k = scene.lights.corner[k_idx]
                rad_k = scene.lights.edge_u[k_idx, 0]
                _, _, pdf_inv_k = sampling.sphere_cone(ctr_k, rad_k, o)
                p_light = jnp.where(
                    scene.lights.kind[k_idx] == LIGHT_SPHERE,
                    q_hit / jnp.maximum(pdf_inv_k, 1e-12),
                    p_light,
                )
        elif isinstance(scene.light, SphereLight):
            is_light_hit = hit.hit & (
                hit.obj_id == jnp.asarray(scene.light.light_obj_id,
                                          jnp.int32)
            )
            _, _, pdf_inv_o = sampling.sphere_cone(
                scene.light.center, scene.light.radius, o
            )
            p_light = 1.0 / jnp.maximum(pdf_inv_o, 1e-12)
        else:
            area_l, n_l = sampling.light_area_normal(scene.light)
            is_light_hit = hit.hit & (
                hit.obj_id == jnp.asarray(scene.light.light_obj_id,
                                          jnp.int32)
            )
            cos_l = jnp.abs(vm.dot(d, n_l))
            p_light = (hit.t * hit.t) / (
                area_l * jnp.maximum(cos_l, 1e-6)
            )
        w_bsdf = mis_pdf / (mis_pdf + p_light)
        emit = emit * jnp.where(
            is_light_hit & (mis_pdf > 0.0), w_bsdf, 1.0
        )[:, None]
    if nee_sphere and no_emit is not None:
        # Sphere-light continuation: lanes flagged by _diff_scatter
        # (cone-sampled a sphere light, probe failed, fell back to cosine)
        # suppress that light family's pickup this bounce — the bias-free
        # C13 variant (docstring there).
        if scene.lights is not None and scene.lights.kind is not None:
            sph_rows = scene.lights.kind == LIGHT_SPHERE
            is_slight_hit = hit.hit & jnp.any(
                (hit.obj_id[:, None] == scene.lights.obj_id[None, :])
                & sph_rows[None, :],
                axis=1,
            )
        else:
            is_slight_hit = hit.hit & (
                hit.obj_id == jnp.asarray(scene.light.light_obj_id, jnp.int32)
            )
        emit = emit * (~(no_emit & is_slight_hit)).astype(T.dtype)[:, None]
    if textbook and no_emit is not None:
        # Suppress ONLY emission the previous bounce's shadow ray already
        # estimated: the single sampled light — or, with a light LIST, any
        # listed light (the 1/q_k-weighted one-light estimate is unbiased
        # for the whole list's direct term). Unlisted emitters must still
        # be picked up or their light would be lost.
        if scene.lights is not None:
            is_light_hit = hit.hit & jnp.any(
                hit.obj_id[:, None] == scene.lights.obj_id[None, :], axis=1
            )
        else:
            is_light_hit = hit.hit & (
                hit.obj_id == jnp.asarray(scene.light.light_obj_id, jnp.int32)
            )
        emit = emit * (~(no_emit & is_light_hit)).astype(T.dtype)[:, None]

    # Per-purpose uniforms for this bounce.
    ctr_base = depth.astype(jnp.uint32) * jnp.uint32(rng.DRAWS_PER_BOUNCE)
    u = {
        p: uniform(seed, path_id, ctr_base + jnp.uint32(p), purpose=p)
        for p in (
            rng.P_RR,
            rng.P_LIGHT_U,
            rng.P_LIGHT_V,
            rng.P_SCATTER_U,
            rng.P_SCATTER_V,
            rng.P_MIX_COIN,
            rng.P_REFR_COIN,
            rng.P_LIGHT_SEL,
        )
    }

    # Russian roulette (C10, smallpt.cpp:447-454).
    p_max = jnp.max(sh.albedo, axis=-1)
    rr_active = (depth > cfg.rr_start_depth) | (p_max <= 0.0)
    survive = jnp.where(rr_active, u[rng.P_RR] < p_max, True)
    # Double-where reciprocal: p_max == 0 lanes die (survive == False) so the
    # value is irrelevant, but d(1/p)/dp = -1/p^2 would overflow to inf and
    # NaN the reverse pass if computed at p ~ 0.
    p_pos = p_max > 0.0
    inv_p = jnp.where(
        rr_active & p_pos, 1.0 / jnp.where(p_pos, p_max, 1.0), 1.0
    )
    f = sh.albedo * inv_p[:, None]
    alive_out = alive & survive

    # Score-function term: log P(observed RR decision). Only stochastic when
    # 0 < p_max < 1 and RR is active; double-where keeps log away from 0.
    stoch = alive & rr_active & (p_max > 0.0) & (p_max < 1.0)
    p_safe = jnp.where(stoch, jnp.clip(p_max, 1e-6, 1.0 - 1e-6), 0.5)
    logp_inc = jnp.where(
        stoch,
        jnp.where(survive, jnp.log(p_safe), jnp.log1p(-p_safe)),
        0.0,
    )

    # Material scatter: branch-free select over material type (vtable-free,
    # SURVEY row 4).
    diff_dir, diff_w, probes, diff_o, diff_sup = _diff_scatter(
        scene, cfg, sh, sh.x, u
    )
    spec_dir, spec_w = _spec_scatter(sh, d)
    refr_dir, refr_w = _refr_scatter(sh, d, u[rng.P_REFR_COIN])
    glos_dir, glos_w, glos_mirror = _glos_scatter(
        sh, d, u[rng.P_SCATTER_U], u[rng.P_SCATTER_V]
    )
    is_spec = (sh.refl == SPEC)[:, None]
    is_refr = (sh.refl == REFR)[:, None]
    is_glos = sh.refl == GLOS
    new_dir = jnp.where(is_spec, spec_dir, jnp.where(is_refr, refr_dir, diff_dir))
    new_dir = jnp.where(is_glos[:, None], glos_dir, new_dir)
    w = jnp.where(
        sh.refl == SPEC, spec_w, jnp.where(sh.refl == REFR, refr_w, diff_w)
    )
    w = jnp.where(is_glos, glos_w, w)
    # Below-horizon lobe samples carry zero BRDF: the lane is absorbed
    # (killed; its respawn/regeneration is the schedule's business). No-op
    # for scenes without GLOS primitives (is_glos all-False).
    alive_out = alive_out & ~(is_glos & (glos_w <= 0.0))
    # Next-bounce origin: sh.x, except light-list NEE-success diffuse lanes
    # (lifted probe origin — _diff_scatter docstring). Bitwise sh.x on the
    # single-light path.
    x_next = jnp.where(is_spec | is_refr, sh.x, diff_o)

    T_out = T * f * w[:, None]

    no_emit_next = jnp.zeros_like(alive)
    if nee_sphere:
        no_emit_next = alive_out & (sh.refl == DIFF) & diff_sup
    mis_pdf_next = jnp.zeros(alive.shape, T.dtype)
    if textbook or mis:
        # Unbiased next-event estimation (SURVEY hard part #2's
        # "nee_textbook"): at every live diffuse vertex, one shadow ray to a
        # uniform light-plane point; contribution
        #   T * albedo * e_light * [A cos(theta_l) cos(theta) / (pi t^2)]
        # (the same weight formula as C13 — sampling.nee_weight), and the
        # NEXT bounce's light-emission pickup is suppressed so the BSDF
        # path doesn't count the light twice. RR only gates continuation.
        # Always the intended full-area sampler, regardless of
        # cfg.light_sample_mode: nee_weight assumes the uniform-over-area
        # pdf, and the glibc corner patch (C13a) is a reference-parity
        # quirk with no textbook analogue (config.py docs; the megakernel
        # matches this). Multi-emitter scenes pick light k ~ q and divide
        # by q_k (see _select_light).
        light, q_sel, kind = _select_light(scene, cfg, u)
        # Light-list probes fire from the lifted origin (sampling.
        # SHADOW_EPS); the continuation (cosine) still leaves from sh.x.
        probe2_o = sh.x if q_sel is None else sh.x + sampling.SHADOW_EPS * sh.n
        # Textbook/mis ALWAYS use the intended full-area/cone sampler
        # (nee_weight assumes the uniform pdf; the glibc corner patch is a
        # reference-parity continuation quirk).
        d_l, w_fn, sphere_mask2 = _nee_sample(
            light, kind, probe2_o, sh.n, u, glibc=False
        )
        probe2 = trace(scene, probe2_o, d_l)
        success = probe2.hit & (probe2.obj_id == light.light_obj_id)
        if sphere_mask2 is not None:
            # Front-side gate for sphere-sampled lanes (_nee_sample).
            success = success & (
                ~sphere_mask2 | (vm.dot(d_l, sh.n) > 0.0)
            )
        t_safe = jnp.where(success, probe2.t, 1.0)
        w_d = w_fn(t_safe)
        if q_sel is not None:
            w_d = w_d / q_sel
        # Geometry factor (inverse solid-angle density of the light
        # sampler at d_l): parallelogram |A cos_l|/t^2, sphere cone
        # 2*pi*(1-cos_max). Feeds the GLOS swap and (inverted) the mis
        # balance weight.
        sphere_single = isinstance(light, SphereLight)
        if sphere_single:
            _, _, w_geo = sampling.sphere_cone(
                light.center, light.radius, probe2_o
            )
        else:
            area_l2, n_l2 = sampling.light_area_normal(light)
            w_geo = jnp.abs(area_l2 * vm.dot(d_l, n_l2)) / (t_safe * t_safe)
            if kind is not None:
                s_ctr, s_rad = sampling.list_entry_sphere_params(light)
                _, _, pdf_inv_s = sampling.sphere_cone(
                    s_ctr, s_rad, probe2_o
                )
                w_geo = jnp.where(
                    kind == LIGHT_SPHERE, pdf_inv_s, w_geo
                )
        # GLOS lanes swap the diffuse BRDF factor |cos|/pi inside
        # nee_weight for the modified-Phong lobe evaluated at the
        # shadow-ray direction: w = w_geo * (f_glos/rho) * cos.
        # No-op for scenes without GLOS (is_glos all-False keeps the
        # diffuse w_d bit-identical through the select).
        w_d_glos = (
            w_geo
            * sampling.phong_brdf_over_albedo(d_l, glos_mirror, sh.gloss)
            * jnp.maximum(vm.dot(d_l, sh.n), 0.0)
        )
        if q_sel is not None:
            w_d_glos = w_d_glos / q_sel
        w_d = jnp.where(is_glos, w_d_glos, w_d)
        if mis:
            # Balance heuristic on the light-sampled term: the SAME
            # direction could have come from the cosine continuation,
            # p_bsdf = max(d_l . n, 0) / pi; p_light = 1/w_geo is
            # exactly the density the NEE weight inverts (t^2/(A |cos_l|)
            # for parallelograms, 1/(2 pi (1-cos_max)) for sphere cones).
            # w_light = p_light / (p_light + p_bsdf); the complementary
            # w_bsdf is applied at pickup (top of this function), so every
            # light path is counted with total weight 1 — unbiased, and
            # each strategy dominates where its density is higher
            # (Veach 97). Light lists: the strategy's density includes the
            # selection probability q_k of the sampled light (matches the
            # pickup). Expression trees per kind match the megakernel
            # bit-for-bit (the rect form keeps its historical cos clamp).
            if sphere_single:
                p_light_s = 1.0 / jnp.maximum(w_geo, 1e-12)
            else:
                cos_l_s = jnp.abs(vm.dot(d_l, n_l2))
                p_light_s = (t_safe * t_safe) / (
                    area_l2 * jnp.maximum(cos_l_s, 1e-6)
                )
                if kind is not None:
                    p_light_s = jnp.where(
                        kind == LIGHT_SPHERE,
                        1.0 / jnp.maximum(w_geo, 1e-12),
                        p_light_s,
                    )
            if q_sel is not None:
                p_light_s = p_light_s * q_sel
            p_bsdf_s = jnp.maximum(vm.dot(d_l, sh.n), 0.0) * (
                1.0 / math.pi
            )
            # GLOS lanes: the continuation strategy is the Phong lobe, so
            # the competing density at the shadow-ray direction is its pdf.
            p_bsdf_s = jnp.where(
                is_glos,
                sampling.phong_pdf(d_l, glos_mirror, sh.gloss),
                p_bsdf_s,
            )
            w_d = w_d * (p_light_s / (p_light_s + p_bsdf_s))
        _, emission_all, _ = object_arrays(scene)
        e_light = emission_all[jnp.asarray(light.light_obj_id, jnp.int32)]
        nee_live = alive & ((sh.refl == DIFF) | is_glos)
        gate = (nee_live & success).astype(T.dtype)
        emit = emit + (gate * w_d)[:, None] * T * sh.albedo * e_light
        probes = nee_live.astype(jnp.float32)
        if textbook:
            no_emit_next = alive_out & ((sh.refl == DIFF) | is_glos)
        else:
            # mis: carry the continuation's BSDF pdf to the next pickup
            # (cos/pi for diffuse lanes, the Phong-lobe pdf for GLOS).
            pdf_cont = jnp.maximum(vm.dot(new_dir, sh.n), 0.0) * (
                1.0 / math.pi
            )
            pdf_cont = jnp.where(
                is_glos,
                sampling.phong_pdf(new_dir, glos_mirror, sh.gloss),
                pdf_cont,
            )
            mis_pdf_next = jnp.where(
                alive_out & ((sh.refl == DIFF) | is_glos), pdf_cont, 0.0
            )

    # Trace accounting: 1 extend per alive lane at frame start + NEE probes
    # (reference-style: lanes that survived RR and are DIFF; textbook/mis:
    # one shadow ray per live diffuse lane).
    probe_alive = (
        jnp.ones_like(alive) if (textbook or mis)
        else (alive_out & (sh.refl == DIFF))
    )
    traces_inc = jnp.stack([
        jnp.sum(alive.astype(jnp.float32)),
        jnp.sum(probes * probe_alive.astype(jnp.float32)),
    ])

    return BounceOut(
        emit=emit, x=x_next, new_dir=new_dir, T=T_out, alive=alive_out,
        traces_inc=traces_inc, logp_inc=logp_inc,
        no_emit_next=no_emit_next, mis_pdf_next=mis_pdf_next,
    )


def bounce_step(scene: Scene, cfg: RenderConfig, seed, state: PathState) -> PathState:
    """One wavefront bounce: trace + shade + RR + scatter (radiance() body)."""
    depth = state.depth + 1  # the reference's ++depth (smallpt.cpp:448)
    out = _bounce_core(
        scene, cfg, seed, state.o, state.d, state.T, state.alive, depth,
        state.path_id, state.no_emit, state.mis_pdf,
    )
    # Masked write-back: dead lanes keep their state frozen.
    live = out.alive[:, None]
    return PathState(
        o=jnp.where(live, out.x, state.o),
        d=jnp.where(live, out.new_dir, state.d),
        T=jnp.where(live, out.T, state.T),
        L=state.L + out.emit,
        alive=out.alive,
        depth=jnp.where(state.alive, depth, state.depth),
        path_id=state.path_id,
        n_traces=state.n_traces + out.traces_inc,
        no_emit=out.no_emit_next,
        mis_pdf=out.mis_pdf_next,
    )


def path_trace(scene: Scene, cfg: RenderConfig, seed, o, d, path_id):
    """Run paths to termination. Returns (L (N,3), n_traces (2,) [extend,
    probe])."""
    state0 = init_paths(o, d, path_id)

    def cond(state):
        return jnp.any(state.alive) & (jnp.max(state.depth) < cfg.max_bounces)

    def body(state):
        return bounce_step(scene, cfg, seed, state)

    out = jax.lax.while_loop(cond, body, state0)
    return out.L, out.n_traces


def path_trace_fixed(scene: Scene, cfg: RenderConfig, seed, o, d, path_id,
                     n_bounces: int, want_logp: bool = False):
    """Differentiable variant: fixed-length lax.scan (reverse-mode safe).

    Truncates the RR tail at ``n_bounces``; with RR survival <= max albedo
    the truncated energy decays geometrically (SURVEY section 6: <0.1% of
    bounces beyond depth ~30).

    want_logp: also return the per-path log-probability of the RR decision
    sequence (the score-function term, grad/score.py). Returns
    (L, n_traces[, logp])."""
    state0 = init_paths(o, d, path_id)
    logp0 = jnp.zeros(o.shape[:1], o.dtype)

    # Rematerialize each bounce under AD: without the checkpoint, the
    # scan transpose stores every bounce's full linearization, and the
    # resulting giant program intermittently crashed the XLA CPU
    # compiler (round-3 VERDICT weak #2 — aborts/segfaults observed in
    # different test files across sessions). Recomputing the bounce in
    # the backward pass trades ~2x bounce FLOPs under jax.grad for an
    # O(bounces)-times smaller linearized program; primal values and
    # gradients are unchanged (recomputation reproduces the same
    # floats).
    def _bounce_ck(o_, d_, T_, alive_, depth_, pid_, ne_, mp_):
        return _bounce_core(
            scene, cfg, seed, o_, d_, T_, alive_, depth_, pid_, ne_, mp_
        )

    _bounce_ck = jax.checkpoint(_bounce_ck)

    def body(carry, _):
        state, logp = carry
        depth = state.depth + 1
        out = _bounce_ck(
            state.o, state.d, state.T, state.alive, depth,
            state.path_id, state.no_emit, state.mis_pdf,
        )
        live = out.alive[:, None]
        new_state = PathState(
            o=jnp.where(live, out.x, state.o),
            d=jnp.where(live, out.new_dir, state.d),
            T=jnp.where(live, out.T, state.T),
            L=state.L + out.emit,
            alive=out.alive,
            depth=jnp.where(state.alive, depth, state.depth),
            path_id=state.path_id,
            n_traces=state.n_traces + out.traces_inc,
            no_emit=out.no_emit_next,
            mis_pdf=out.mis_pdf_next,
        )
        return (new_state, logp + out.logp_inc), None

    (out, logp), _ = jax.lax.scan(body, (state0, logp0), None, length=n_bounces)
    if want_logp:
        return out.L, out.n_traces, logp
    return out.L, out.n_traces


class RegenState(NamedTuple):
    o: jnp.ndarray        # (N,3)
    d: jnp.ndarray        # (N,3)
    T: jnp.ndarray        # (N,3)
    L: jnp.ndarray        # (N,3) per-LANE radiance accumulator (pixel-bound)
    alive: jnp.ndarray    # (N,)
    depth: jnp.ndarray    # (N,) int32 current-path depth
    s: jnp.ndarray        # (N,) uint32 current sample index (within lane)
    path_id: jnp.ndarray  # (N,) uint32
    n_traces: jnp.ndarray  # (2,) f32 [extend, probe]
    no_emit: jnp.ndarray  # (N,) bool (nee_textbook double-count guard)
    mis_pdf: jnp.ndarray  # (N,) f32 (estimator="mis" balance carry)


def _spawn(cam: CameraParams, cfg: RenderConfig, seed, px, py, pid_base,
           s_idx):
    """Primary ray + path id for sample ``s_idx`` of the lane's pixel.

    px/py/pid_base (= pixel * spp) are loop-invariant lane constants,
    precomputed OUTSIDE the while loop: integer div/mod is expensive and
    XLA does not reliably hoist it out of while bodies.

    Camera-jitter counters 0/1 (and lens counters 2/3 when cfg.aperture > 0)
    never collide with bounce draws (those start at DRAWS_PER_BOUNCE
    because depth >= 1)."""
    uniform = ld.make_uniform_cfg(cfg, rng.make_uniform_fn(cfg.rng_backend))
    path_id = pid_base + s_idx
    o, d = primary_rays_cfg(cam, cfg, px, py, path_id, seed, uniform)
    return o, d, path_id


def path_trace_regen(scene: Scene, cfg: RenderConfig, seed,
                     cam: CameraParams, pix, s_start, s_stop):
    """Regenerating wavefront: lane i is bound to pixel ``pix[i]`` and walks
    its samples [s_start[i], s_stop[i]) sequentially, respawning a fresh
    primary ray the moment the current path dies.

    This is the occupancy fix for the RR tail (SURVEY.md section 7 "Hard
    parts" #1): the fixed-slot loop runs until the LAST path of the whole
    wave dies (<10% mean occupancy); lane-bound regeneration amortizes the
    tail across a lane's whole sample budget. Because every RNG draw is a
    pure function of (seed, path_id, counter), per-sample radiance is
    bit-identical to the fixed-slot path — only the accumulation order
    differs. The pixel binding means dead-lane output needs NO scatter: the
    lane accumulator IS a pixel partial sum.

    pix, s_start, s_stop: (N,) uint32 per-lane work assignment (several
    lanes may share a pixel with disjoint sample ranges — "groups").

    Returns (per-lane radiance sum over its samples (N,3), traces (2,))."""
    n = pix.shape[0]
    px = (pix % jnp.uint32(cfg.width)).astype(jnp.int32)
    py = (pix // jnp.uint32(cfg.width)).astype(jnp.int32)
    pid_base = pix * jnp.uint32(cfg.spp)
    s_start = s_start.astype(jnp.uint32)
    s_stop = s_stop.astype(jnp.uint32)

    o0, d0, pid0 = _spawn(cam, cfg, seed, px, py, pid_base, s_start)
    state0 = RegenState(
        o=o0,
        d=d0,
        T=jnp.ones((n, 3), o0.dtype),
        L=jnp.zeros((n, 3), o0.dtype),
        alive=s_start < s_stop,
        depth=jnp.zeros((n,), jnp.int32),
        s=s_start,
        path_id=pid0,
        n_traces=jnp.zeros((2,), jnp.float32),
        no_emit=jnp.zeros((n,), jnp.bool_),
        mis_pdf=jnp.zeros((n,), jnp.float32),
    )

    def cond(st):
        return jnp.any(st.alive)

    def body(st):
        depth = st.depth + 1
        out = _bounce_core(
            scene, cfg, seed, st.o, st.d, st.T, st.alive, depth, st.path_id,
            st.no_emit, st.mis_pdf,
        )
        # Per-path max_bounces truncation — identical to the scan schedule's
        # whole-wave cap (in scan, every alive lane's depth equals the
        # iteration index, so capping per path is the same truncation).
        alive_after = out.alive & (depth < cfg.max_bounces)
        died = st.alive & ~alive_after
        s_next = st.s + died.astype(jnp.uint32)
        respawn = died & (s_next < s_stop)
        o_sp, d_sp, pid_sp = _spawn(cam, cfg, seed, px, py, pid_base, s_next)
        rs = respawn[:, None]
        live = alive_after[:, None]
        return RegenState(
            o=jnp.where(rs, o_sp, jnp.where(live, out.x, st.o)),
            d=jnp.where(rs, d_sp, jnp.where(live, out.new_dir, st.d)),
            T=jnp.where(rs, 1.0, jnp.where(live, out.T, st.T)),
            L=st.L + out.emit,
            alive=alive_after | respawn,
            depth=jnp.where(respawn, 0, jnp.where(st.alive, depth, st.depth)),
            s=jnp.where(died, s_next, st.s),
            path_id=jnp.where(respawn, pid_sp, st.path_id),
            n_traces=st.n_traces + out.traces_inc,
            # Respawned lanes start fresh (their primary hit DOES pick up
            # emission); surviving lanes carry the textbook/mis guards.
            no_emit=out.no_emit_next & ~respawn,
            mis_pdf=jnp.where(respawn, 0.0, out.mis_pdf_next),
        )

    out = jax.lax.while_loop(cond, body, state0)
    return out.L, out.n_traces


def lane_groups(n_pix: int, n_s: int, target_lanes: int,
                override: int = 0) -> int:
    """Lanes per pixel for a regenerating wavefront over (n_pix pixels x
    n_s samples): the largest g <= target_lanes/n_pix that divides n_s
    (every lane gets an equal sample range). ``override`` forces g.

    This is THE policy — used by the jnp regen renderer, the sharded local
    bodies, the checkpoint spans, and the Pallas megakernel (which passes a
    smaller target: long per-lane budgets amortize the tile tail better,
    see PERF.md 'Tuning results')."""
    g = override or max(1, target_lanes // max(1, n_pix))
    g = min(g, n_s)
    while n_s % g:
        g -= 1
    return g


def regen_groups(cfg: RenderConfig) -> int:
    """Lanes per pixel for the jnp regenerating wavefront (target 2^21)."""
    return lane_groups(
        cfg.width * cfg.height, cfg.spp, 1 << 21, cfg.regen_groups
    )


@partial(jax.jit, static_argnums=(2,))
def render_regen(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed):
    """Single-pass regenerating render: ``groups`` lanes per pixel, each
    walking spp/groups samples. Returns ((h, w, 3) radiance sum over spp,
    traces (2,) [extend, probe])."""
    n_pix = cfg.width * cfg.height
    g = regen_groups(cfg)
    per = cfg.spp // g
    pix = jnp.repeat(jnp.arange(n_pix, dtype=jnp.uint32), g)
    s_start = jnp.tile(
        jnp.arange(g, dtype=jnp.uint32) * jnp.uint32(per), n_pix
    )
    s_stop = s_start + jnp.uint32(per)
    L, n_traces = path_trace_regen(
        scene, cfg, seed, cam, pix, s_start, s_stop
    )
    img = L.reshape(n_pix, g, 3).sum(axis=1)
    return img.reshape(cfg.height, cfg.width, 3), n_traces


def _chunk_paths(cam: CameraParams, cfg: RenderConfig, seed, s0, n_s):
    """Primary rays + path ids for samples [s0, s0+n_s) of every pixel.

    Layout is pixel-major / sample-minor so per-pixel reduction is a reshape
    (no scatter). path_id = (y*width + x) * spp + s."""
    w, h, spp = cfg.width, cfg.height, cfg.spp
    uniform = ld.make_uniform_cfg(cfg, rng.make_uniform_fn(cfg.rng_backend))
    pix = jnp.arange(w * h, dtype=jnp.uint32)
    s = s0 + jnp.arange(n_s, dtype=jnp.uint32)
    path_id = (pix[:, None] * jnp.uint32(spp) + s[None, :]).reshape(-1)
    px = (pix[:, None] % jnp.uint32(w)).astype(jnp.int32)
    py = (pix[:, None] // jnp.uint32(w)).astype(jnp.int32)
    px = jnp.broadcast_to(px, (w * h, n_s)).reshape(-1)
    py = jnp.broadcast_to(py, (w * h, n_s)).reshape(-1)
    o, d = primary_rays_cfg(cam, cfg, px, py, path_id, seed, uniform)
    return o, d, path_id


@partial(jax.jit, static_argnums=(2, 4))
def render_chunk(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
                 n_s: int, s0):
    """Sum of per-sample radiance over sample indices [s0, s0+n_s) for every
    pixel. Returns ((h, w, 3) radiance sum, n_traces (2,))."""
    o, d, path_id = _chunk_paths(cam, cfg, seed, s0, n_s)
    L, n_traces = path_trace(scene, cfg, seed, o, d, path_id)
    img = L.reshape(cfg.height * cfg.width, n_s, 3).sum(axis=1)
    return img.reshape(cfg.height, cfg.width, 3), n_traces


def render_counts(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    """Full render returning the split trace counters.

    cfg.wavefront selects the schedule:

    - "regen" (default): lane-per-pixel regenerating wavefront, single pass;
    - "scan": fixed-slot wavefront, chunked over spp on the host.

    Both produce per-sample-identical radiance (counter RNG); they differ
    only in accumulation order. Returns (linear image (h, w, 3) in [0,1] —
    contract C3 clamp applied — and (extend, probe) trace counts as floats;
    extend/paths is the exact mean path length, the fixed C17 stat)."""
    check_glos_estimator(scene, cfg)
    if cfg.use_pallas:
        from ..ops.megakernel import render_pallas, trace_totals

        img, per_block = render_pallas(scene, cam, cfg, cfg.seed)
        n_tr = trace_totals(per_block)
        return film.finalize(img / cfg.spp), (
            float(n_tr[0]), float(n_tr[1])
        )
    if cfg.wavefront == "regen":
        img, n_tr = render_regen(scene, cam, cfg, jnp.uint32(cfg.seed))
        return film.finalize(img / cfg.spp), (
            float(n_tr[0]), float(n_tr[1])
        )
    chunk = cfg.resolved_spp_chunk()
    acc = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    extends = probes = 0.0
    s0 = 0
    while s0 < cfg.spp:
        n_s = min(chunk, cfg.spp - s0)
        img, n_tr = render_chunk(
            scene, cam, cfg, cfg.seed, n_s, jnp.uint32(s0)
        )
        acc = acc + img
        extends += float(n_tr[0])
        probes += float(n_tr[1])
        s0 += n_s
    return film.finalize(acc / cfg.spp), (extends, probes)


def render(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    """Full render (see render_counts). Returns (linear image (h, w, 3) in
    [0,1], total scene-trace count — the bench metric)."""
    img, (extends, probes) = render_counts(scene, cam, cfg)
    return img, extends + probes
