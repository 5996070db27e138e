"""Differentiable Pallas megakernel: kernel-speed inverse rendering.

The reference's entire ``radiance()`` chain (/root/reference/src/
smallpt.cpp:419-496) gets an adjoint here, so a fit step need not run
jax.grad through the jnp lax.scan wavefront (whose tape lives in device
memory); the kernel replays the path instead.

Two kernels, both compiled ONCE per (geometry, config) — materials are
RUNTIME inputs (global-memory tables), so a fit loop does NOT recompile
per step:

1. forward: ``megakernel.build_kernel(mat_refs=True)`` — the standard
   megakernel reading albedo/emission from (K, 3) runtime tables instead of
   baked immediates; bit-identical renders at equal materials.
2. adjoint (this module): replays every (pixel, sample) path TWICE with
   the identical counter-RNG stream:
     pass A — recompute the per-sample radiance L (3 registers);
     pass B — replay again maintaining prefix throughput T_j and the
       emission partial sum A_j; the suffix factor needed by the product
       chain's VJP is recovered without any stored tape via
           T_j * S_{j+1} = (L - A_{j+1}) / f_j
       (f_j = albedo * inv_p * weight is this bounce's throughput factor;
       when a path dies, L - A_{j+1} is exactly 0 and the guarded divide
       returns 0). Per-object cotangents accumulate in per-lane carries
       (mask-select on the winning object id — no scatter), summed per
       block into one output row per block; XLA sums the rows.

What the adjoint computes (pathwise, matching the jnp lax.scan adjoint
``grad/adjoint.py`` exactly — FD/AD-validated in
tests/test_megakernel_grad.py):
  d/d albedo[o, ch]:  direct throughput term + the Russian-roulette
      1/p term through p = max-albedo (cotangent tie-split over equal
      channels, matching jnp.max's VJP);
  d/d emission[o, ch]: prefix-weighted pickup terms.
Geometry/camera/RNG-discreteness cotangents are NOT computed here (same
scope as the pathwise jnp adjoint; use grad/soft.py and grad/score.py for
silhouette and RR-decision terms).

Estimators: all six (nee / cosine / uniform / uniform_corrected / mixture /
nee_textbook — the textbook shadow-ray direct term contributes its own
albedo and light-emission cotangents, and the double-count pickup
suppression is replayed bit-exactly), all materials (DIFF/SPEC/REFR), and
multi-emitter light lists (scene.lights): the per-lane selection draw is
replayed, the NEE weight carries 1/q_k with q stop-gradient'ed exactly as
sampling.light_select_probs specifies, and the textbook direct term routes
its emission cotangent to the per-lane SAMPLED light's row.

Known pathology (nee_textbook, any adjoint — jnp included): the gradient
w.r.t. the LIGHT's own albedo is dominated by knife-edge 1/t^2 shadow-ray
events at the C13 81.5-vs-81.6 plane mismatch; its value varies by O(1)
factors under float-rounding-level program changes (tests/
test_megakernel_grad.py discussion). A zero-albedo emitter's albedo is not
a meaningful training target; all other rows are stable and validated.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..core import rng
from ..core import vecmath as vm
from ..integrator.sampling import SHADOW_EPS
from ..scene.types import Scene
from . import route
from .megakernel import (
    _light_list_consts,
    _light_select_cdf,
    _runtime_materials,
    _probe_unrolled,
    _scene_consts,
    _trace_unrolled,
    _u32c,
    _uniform_for,
    build_kernel,
    frame_lanes,
    lane_layout,
    lane_spec,
    launch_forward,
    make_spawn,
    pad_lanes,
)


def pack_materials(scene: Scene):
    """Scene materials as (K, 3) f32 tables in global object order
    (rects, quads, spheres — the order of scene.types.object_arrays)."""
    alb = jnp.concatenate([
        jnp.asarray(scene.rects.albedo, jnp.float32).reshape(-1, 3),
        jnp.asarray(scene.quads.albedo, jnp.float32).reshape(-1, 3),
        jnp.asarray(scene.spheres.albedo, jnp.float32).reshape(-1, 3),
    ])
    emi = jnp.concatenate([
        jnp.asarray(scene.rects.emission, jnp.float32).reshape(-1, 3),
        jnp.asarray(scene.quads.emission, jnp.float32).reshape(-1, 3),
        jnp.asarray(scene.spheres.emission, jnp.float32).reshape(-1, 3),
    ])
    return alb, emi


def unpack_materials(scene: Scene, alb, emi) -> Scene:
    """Inverse of pack_materials: materials tables back into the scene."""
    R = scene.rects.k.shape[0]
    Q = scene.quads.corner.shape[0]
    return scene._replace(
        rects=scene.rects._replace(albedo=alb[:R], emission=emi[:R]),
        quads=scene.quads._replace(
            albedo=alb[R:R + Q], emission=emi[R:R + Q]
        ),
        spheres=scene.spheres._replace(
            albedo=alb[R + Q:], emission=emi[R + Q:]
        ),
    )


def material_grads_to_scene(scene: Scene, galb, gemi):
    """(K,3) material cotangents -> a scene-shaped pytree of gradients
    (zeros for every non-material leaf)."""
    zero = jax.tree.map(jnp.zeros_like, scene)
    return unpack_materials(zero, galb, gemi)


def build_grad_kernel(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    """The adjoint kernel body (see module docstring)."""
    rects, quads, spheres, light, lightlist = _scene_consts(scene)
    n_obj = len(rects) + len(quads) + len(spheres)
    if lightlist is not None and any(
        L.get("kind", 0) == 1 for L in lightlist
    ):
        raise NotImplementedError(
            "the material-adjoint kernel's light-list path is "
            "parallelogram-only; LIGHT_SPHERE rows run on the jnp adjoint "
            "(jax.grad through integrator/wavefront.path_trace_fixed) — "
            "documented waiver, COVERAGE.md"
        )
    if light.get("kind") == "sphere":
        raise NotImplementedError(
            "the material-adjoint kernel supports parallelogram lights "
            "only; sphere-light (SphereLight) gradients run on the jnp "
            "adjoint (jax.grad through integrator/wavefront."
            "path_trace_fixed — fully differentiable, tests/"
            "test_sphere_light.py) — documented waiver, COVERAGE.md"
        )
    all_objs = rects + quads + spheres
    light_id = light["light_obj_id"]
    uni = _uniform_for(cfg.rng_backend)
    est = cfg.estimator
    textbook = est == "nee_textbook"
    mis_est = est == "mis"
    has_glos = any(o["refl"] == 3 for o in all_objs)
    if has_glos and est not in ("cosine", "nee_textbook", "mis"):
        raise ValueError(
            f"estimator {est!r} has no glossy (GLOS) semantics; use "
            "cosine / nee_textbook / mis (same rule as the forward "
            "kernel, ops/megakernel.build_kernel)"
        )
    glibc = cfg.light_sample_mode == "glibc_overflow"
    # Multi-emitter light list: same per-lane selection replay as the
    # forward kernel. q is stop_gradient'ed in the jnp estimator
    # (sampling.light_select_probs), so the adjoint treats the selection
    # weights as constants — no cotangent flows through q, matching
    # jax.grad through the lax.scan wavefront exactly (even in "power"
    # mode, where q is computed at runtime from the emission table).
    multi = lightlist is not None
    if multi and glibc:
        raise ValueError(
            "light_sample_mode='glibc_overflow' reproduces the reference's "
            "single-light int32-overflow quirk (C13a) and has no "
            "multi-emitter analogue; use light_sample_mode='intended' for "
            "scenes with a light list"
        )
    if multi:
        ml = _light_list_consts(lightlist)
        light_ids_all = tuple(m["id"] for m in ml)
        K_L = len(ml)
    has_spec = any(o["refl"] == 1 for o in rects + quads + spheres)
    has_refr = any(o["refl"] == 2 for o in rects + quads + spheres)

    spawn, origin = make_spawn(cam, cfg)

    lc = tuple(np.float32(v) for v in light["corner"])
    leu = tuple(np.float32(v) for v in light["edge_u"])
    lev = tuple(np.float32(v) for v in light["edge_v"])
    cxn = (
        leu[1] * lev[2] - leu[2] * lev[1],
        leu[2] * lev[0] - leu[0] * lev[2],
        leu[0] * lev[1] - leu[1] * lev[0],
    )
    area = float(math.sqrt(cxn[0] ** 2 + cxn[1] ** 2 + cxn[2] ** 2))
    ln = tuple(np.float32(v / area) for v in cxn)
    area = np.float32(area)
    leu_mag = float(math.sqrt(sum(v * v for v in leu)))
    lev_mag = float(math.sqrt(sum(v * v for v in lev)))
    leu_hat = tuple(np.float32(v / leu_mag) for v in leu)
    lev_hat = tuple(np.float32(v / lev_mag) for v in lev)

    rr_depth = np.int32(cfg.rr_start_depth)
    max_bounces = np.int32(cfg.max_bounces)
    mix_q = np.float32(cfg.mixture_q)
    DPB = _u32c(rng.DRAWS_PER_BOUNCE)

    def glibc_offset(u):
        r = (u * np.float32(2147483648.0)).astype(jnp.uint32)
        wrapped = (r * np.uint32(36)).view(jnp.int32).astype(jnp.float32)
        return wrapped * np.float32(1.0 / 2147483647.0)

    n_acc = 2 * n_obj * 3

    def kernel(seed_ref, alb_ref, emi_ref, px_ref, py_ref, pid_ref,
               sstart_ref, sstop_ref, gr_ref, gg_ref, gb_ref, gout_ref):
        R, Q = len(rects), len(quads)
        rects_k = _runtime_materials(rects, alb_ref, emi_ref, 0)
        quads_k = _runtime_materials(quads, alb_ref, emi_ref, R)
        spheres_k = _runtime_materials(spheres, alb_ref, emi_ref, R + Q)
        if multi:
            # Selection q/cdf/e from the RUNTIME emission table, exactly as
            # the forward mat_refs kernel computes them (values only — see
            # the stop-gradient note in build_grad_kernel).
            _q_l, _cdf_l, _e_lights = _light_select_cdf(
                ml, all_objs, cfg.light_select, emi_ref
            )

        seed = seed_ref[0]
        px = px_ref[...]
        py = py_ref[...]
        pid_base = pid_ref[...]
        s_stop = sstop_ref[...]
        s0 = sstart_ref[...]
        g_ct = (gr_ref[...], gg_ref[...], gb_ref[...])

        pid0 = pid_base + s0
        zero = jnp.zeros_like(px)
        one = jnp.ones_like(px)
        izero = jnp.zeros_like(px, dtype=jnp.int32)

        # Lanes start PENDING (alive == 2) and take their first primary
        # ray from the in-body spawn: a spawn evaluated outside the while
        # loop can differ by an ulp (XLA contraction context), which
        # would make pass B's replay of each lane's FIRST sample trace a
        # slightly different primary ray than pass A's — enough to flip
        # a discrete path event and corrupt the tail recovery (observed
        # in the geometry kernel, ops/megakernel_geom.py; one canonical
        # spawn site makes pass A == pass B by construction).
        carry0 = (
            zero, zero, zero,
            zero, zero, zero,
            one, one, one,              # T (prefix throughput)
            zero, zero, zero,           # acc (emission partial / pass-A L)
            zero, zero, zero,           # LA (pass-A radiance of the sample)
            izero,                      # phase: 0 = pass A, 1 = pass B
            jnp.where(s0 < s_stop, np.int32(2), np.int32(0)),  # alive
            izero,                      # depth
            s0,                         # sample idx
            pid0,                       # path id
            izero,                      # no_emit (nee_textbook guard)
        )
        if mis_est:
            # + the balance-heuristic pdf carry (previous diffuse
            # vertex's cos/pi of this ray), replayed exactly like the
            # forward kernel's mpdf plane.
            carry0 = carry0 + (zero,)
        n_state = len(carry0)
        # Per-lane cotangent accumulators, one plane per (object, channel)
        # of albedo then emission: [alb(o, ch) for o, ch] + [emi(o, ch)].
        carry0 = carry0 + (zero,) * n_acc

        def cond(c):
            return jnp.max(c[16]) > 0

        def body(c):
            gacc = list(c[n_state:])
            c = c[:n_state]
            if mis_est:
                (ox, oy, oz, dx, dy, dz, tr_, tg, tb, ar, ag, ab,
                 lar, lag, lab, ph, alive_i, depth, s, pid, ne, mpdf) = c
            else:
                (ox, oy, oz, dx, dy, dz, tr_, tg, tb, ar, ag, ab,
                 lar, lag, lab, ph, alive_i, depth, s, pid, ne) = c
                mpdf = None
            alive = alive_i == 1
            pending = alive_i == 2
            depth = jnp.where(alive, depth + 1, depth)

            h = _trace_unrolled(
                rects_k, quads_k, spheres_k,
                light_ids_all if multi else light_id, ox, oy, oz,
                dx, dy, dz, want_shading=True, want_obj=True,
                want_glos=has_glos,
            )
            alive_f = jnp.where(alive, np.float32(1.0), np.float32(0.0))

            # Emission pickup with the PRE-update throughput (C14); this is
            # both pass A's L accumulation and pass B's partial sum A_j+1.
            # nee_textbook: lanes whose previous bounce shadow-sampled the
            # light skip the SAMPLED light's pickup (double-count guard,
            # mirrors build_kernel's alive_i bit 1).
            if textbook:
                suppress = (ne > 0) & h["is_light"]
                emit_f = jnp.where(alive & ~suppress, np.float32(1.0),
                                   np.float32(0.0))
            elif mis_est:
                # Balance heuristic on BSDF-sampled light hits (replay of
                # the forward kernel's mis pickup block).
                if multi:
                    q_h = _q_l[0]
                    a_h = ml[0]["area"]
                    n_h = list(ml[0]["n"])
                    for k in range(1, K_L):
                        is_k = h["obj"] == np.int32(ml[k]["id"])
                        q_h = jnp.where(is_k, _q_l[k], q_h)
                        a_h = jnp.where(is_k, ml[k]["area"], a_h)
                        for c_ in range(3):
                            n_h[c_] = jnp.where(is_k, ml[k]["n"][c_],
                                                n_h[c_])
                    cos_lh = jnp.abs(
                        dx * n_h[0] + dy * n_h[1] + dz * n_h[2]
                    )
                    p_l_h = q_h * (h["t"] * h["t"]) / (
                        a_h * jnp.maximum(cos_lh, np.float32(1e-6))
                    )
                else:
                    cos_lh = jnp.abs(
                        dx * ln[0] + dy * ln[1] + dz * ln[2]
                    )
                    p_l_h = (h["t"] * h["t"]) / (
                        area * jnp.maximum(cos_lh, np.float32(1e-6))
                    )
                w_b = mpdf / (mpdf + p_l_h)
                emit_f = alive_f * jnp.where(
                    h["is_light"] & (mpdf > 0.0), w_b, np.float32(1.0)
                )
            else:
                emit_f = alive_f
            ar_n = ar + emit_f * tr_ * h["emi"][0]
            ag_n = ag + emit_f * tg * h["emi"][1]
            ab_n = ab + emit_f * tb * h["emi"][2]

            hitm = h["hit"]
            hx = jnp.where(hitm, ox + h["t"] * dx, 0.0)
            hy = jnp.where(hitm, oy + h["t"] * dy, 0.0)
            hz = jnp.where(hitm, oz + h["t"] * dz, 0.0)
            nx, ny, nz = h["nrm"]

            ctr = depth.astype(jnp.uint32) * DPB
            u_rr = uni(seed, pid, ctr + _u32c(rng.P_RR))

            p_max = jnp.maximum(
                h["alb"][0], jnp.maximum(h["alb"][1], h["alb"][2])
            )
            rr_active = (depth > rr_depth) | (p_max <= 0.0)
            survive = ~rr_active | (u_rr < p_max)
            p_pos = p_max > 0.0
            inv_p = jnp.where(
                rr_active & p_pos,
                np.float32(1.0) / jnp.where(p_pos, p_max, 1.0),
                1.0,
            )
            alive_next = alive & survive

            # Scatter frame + cosine/uniform direction (identical math to
            # the forward kernel — bit-equal replay).
            u1 = uni(seed, pid, ctr + _u32c(rng.P_SCATTER_U))
            u2 = uni(seed, pid, ctr + _u32c(rng.P_SCATTER_V))
            pick = jnp.abs(nx) > np.float32(0.1)
            uxr = jnp.where(pick, nz, 0.0)
            uyr = jnp.where(pick, 0.0, -nz)
            uzr = jnp.where(pick, -nx, ny)
            inv_ul = jax.lax.rsqrt(uxr * uxr + uyr * uyr + uzr * uzr)
            ux, uy, uz = uxr * inv_ul, uyr * inv_ul, uzr * inv_ul
            vx = ny * uz - nz * uy
            vy = nz * ux - nx * uz
            vz = nx * uy - ny * ux
            sr1, cr1 = vm.sincos_2pi(u1)  # must match megakernel.py bit-for-bit
            if est in ("uniform", "uniform_corrected"):
                sin_t = jnp.sqrt(u2 * (np.float32(2.0) - u2))
                wz = np.float32(1.0) - u2
            else:
                sin_t = jnp.sqrt(u2)
                wz = jnp.sqrt(np.float32(1.0) - u2)
            sxr = ux * (cr1 * sin_t) + vx * (sr1 * sin_t) + nx * wz
            syr = uy * (cr1 * sin_t) + vy * (sr1 * sin_t) + ny * wz
            szr = uz * (cr1 * sin_t) + vz * (sr1 * sin_t) + nz * wz
            inv_sl = jax.lax.rsqrt(sxr * sxr + syr * syr + szr * szr)
            scx, scy, scz = sxr * inv_sl, syr * inv_sl, szr * inv_sl

            if has_glos:
                # GLOS modified-Phong lobe replay (forward kernel's
                # has_glos scatter block, bit-identical expressions).
                gl = h["glos"]
                glm = h["is_glos"]
                nd_o = nx * dx + ny * dy + nz * dz
                gmx = dx - nx * (np.float32(2.0) * nd_o)
                gmy = dy - ny * (np.float32(2.0) * nd_o)
                gmz = dz - nz * (np.float32(2.0) * nd_o)
                cos_ga = u2 ** (np.float32(1.0) / (gl + np.float32(1.0)))
                sin_ga = jnp.sqrt(
                    jnp.maximum(np.float32(1.0) - cos_ga * cos_ga, 0.0)
                )
                pickg = jnp.abs(gmx) > np.float32(0.1)
                guxr = jnp.where(pickg, gmz, 0.0)
                guyr = jnp.where(pickg, 0.0, -gmz)
                guzr = jnp.where(pickg, -gmx, gmy)
                inv_gul = jax.lax.rsqrt(
                    guxr * guxr + guyr * guyr + guzr * guzr
                )
                gux, guy, guz = (guxr * inv_gul, guyr * inv_gul,
                                 guzr * inv_gul)
                gvx = gmy * guz - gmz * guy
                gvy = gmz * gux - gmx * guz
                gvz = gmx * guy - gmy * gux
                glxr = (gux * (cr1 * sin_ga) + gvx * (sr1 * sin_ga)
                        + gmx * cos_ga)
                glyr = (guy * (cr1 * sin_ga) + gvy * (sr1 * sin_ga)
                        + gmy * cos_ga)
                glzr = (guz * (cr1 * sin_ga) + gvz * (sr1 * sin_ga)
                        + gmz * cos_ga)
                inv_gll = jax.lax.rsqrt(
                    glxr * glxr + glyr * glyr + glzr * glzr
                )
                glx, gly, glz = (glxr * inv_gll, glyr * inv_gll,
                                 glzr * inv_gll)
                gw = ((gl + np.float32(2.0)) / (gl + np.float32(1.0))) * (
                    jnp.maximum(glx * nx + gly * ny + glz * nz, 0.0)
                )

                def _pow_safe_k(base, n_exp):
                    pos = base > 0.0
                    safe = jnp.where(pos, base, 1.0)
                    return jnp.where(pos, safe**n_exp, 0.0)

            if est in ("nee", "mixture", "nee_textbook", "mis"):
                lu = uni(seed, pid, ctr + _u32c(rng.P_LIGHT_U))
                lv = uni(seed, pid, ctr + _u32c(rng.P_LIGHT_V))
                if multi:
                    # Bit-exact replay of the forward kernel's per-lane
                    # light selection (ops/megakernel.build_kernel):
                    # inverse-CDF draw + chained K-way select.
                    usel = uni(seed, pid, ctr + _u32c(rng.P_LIGHT_SEL))
                    lidx = jnp.zeros_like(depth)
                    for k in range(K_L - 1):
                        lidx = lidx + jnp.where(
                            usel >= _cdf_l[k], np.int32(1), np.int32(0)
                        )

                    def _sel_f(vals):
                        acc = zero + vals[0]
                        for k in range(1, K_L):
                            acc = jnp.where(
                                lidx == np.int32(k), vals[k], acc
                            )
                        return acc

                    lcx = _sel_f([m["c"][0] for m in ml])
                    lcy = _sel_f([m["c"][1] for m in ml])
                    lcz = _sel_f([m["c"][2] for m in ml])
                    leux = _sel_f([m["eu"][0] for m in ml])
                    leuy = _sel_f([m["eu"][1] for m in ml])
                    leuz = _sel_f([m["eu"][2] for m in ml])
                    levx = _sel_f([m["ev"][0] for m in ml])
                    levy = _sel_f([m["ev"][1] for m in ml])
                    levz = _sel_f([m["ev"][2] for m in ml])
                    ln_use = tuple(
                        _sel_f([m["n"][c] for m in ml]) for c in range(3)
                    )
                    area_use = _sel_f([m["area"] for m in ml])
                    q_sel = _sel_f(_q_l)
                    sel_id = jnp.full_like(depth, np.int32(ml[0]["id"]))
                    for k in range(1, K_L):
                        sel_id = jnp.where(
                            lidx == np.int32(k),
                            np.int32(ml[k]["id"]), sel_id,
                        )
                    lpx = lcx + lu * leux + lv * levx
                    lpy = lcy + lu * leuy + lv * levy
                    lpz = lcz + lu * leuz + lv * levz
                else:
                    # textbook ALWAYS samples the full light (config.py).
                    ln_use, area_use = ln, area
                    if glibc and not textbook:
                        off_u = glibc_offset(lu)
                        off_v = glibc_offset(lv)
                        lpx = lc[0] + off_u * leu_hat[0] + off_v * lev_hat[0]
                        lpy = lc[1] + off_u * leu_hat[1] + off_v * lev_hat[1]
                        lpz = lc[2] + off_u * leu_hat[2] + off_v * lev_hat[2]
                    else:
                        lpx = lc[0] + lu * leu[0] + lv * lev[0]
                        lpy = lc[1] + lu * leu[1] + lv * lev[1]
                        lpz = lc[2] + lu * leu[2] + lv * lev[2]
                if multi:
                    # SHADOW_EPS-lifted probe origin (forward-kernel NEE
                    # block rationale — list samplers target the true
                    # light plane).
                    eps_sh = np.float32(SHADOW_EPS)
                    pox = hx + eps_sh * nx
                    poy = hy + eps_sh * ny
                    poz = hz + eps_sh * nz
                else:
                    pox, poy, poz = hx, hy, hz
                wx_, wy_, wz_ = lpx - pox, lpy - poy, lpz - poz
                inv_wl = jax.lax.rsqrt(wx_ * wx_ + wy_ * wy_ + wz_ * wz_)
                ldx, ldy, ldz = wx_ * inv_wl, wy_ * inv_wl, wz_ * inv_wl
                if multi:
                    probe = _trace_unrolled(
                        rects_k, quads_k, spheres_k, light_ids_all,
                        pox, poy, poz, ldx, ldy, ldz,
                        want_shading=False, want_obj=True,
                    )
                    success = probe["hit"] & (probe["obj"] == sel_id)
                    t_probe = probe["t"]
                else:
                    # Any-occluder probe — bit-exact to the forward
                    # kernel's (megakernel.py NEE block).
                    t_probe, success = _probe_unrolled(
                        rects_k, quads_k, spheres_k, light_id,
                        pox, poy, poz, ldx, ldy, ldz,
                    )
                t_safe = jnp.where(success, t_probe, 1.0)
                cos_l = jnp.abs(
                    ldx * ln_use[0] + ldy * ln_use[1] + ldz * ln_use[2]
                )
                cos_s = jnp.abs(ldx * nx + ldy * ny + ldz * nz)
                w_nee = (
                    jnp.abs(area_use * cos_l) / (t_safe * t_safe)
                ) * (cos_s * np.float32(1.0 / math.pi))
                if multi:
                    w_nee = w_nee / q_sel
                if has_glos:
                    # GLOS lanes: Phong lobe at the shadow direction
                    # (forward kernel's w_d_glos select).
                    w_geo_k = jnp.abs(area_use * cos_l) / (t_safe * t_safe)
                    brdf_g = (gl + np.float32(2.0)) * np.float32(
                        1.0 / (2.0 * math.pi)
                    ) * _pow_safe_k(
                        ldx * gmx + ldy * gmy + ldz * gmz, gl
                    )
                    w_d_g = w_geo_k * brdf_g * jnp.maximum(
                        ldx * nx + ldy * ny + ldz * nz, 0.0
                    )
                    if multi:
                        w_d_g = w_d_g / q_sel
                    w_nee = jnp.where(glm, w_d_g, w_nee)
                if mis_est:
                    # Balance weight at the sampled direction (replay).
                    p_l_s = (t_safe * t_safe) / (
                        area_use * jnp.maximum(cos_l, np.float32(1e-6))
                    )
                    if multi:
                        p_l_s = p_l_s * q_sel
                    dot_sn = ldx * nx + ldy * ny + ldz * nz
                    p_b_s = jnp.maximum(dot_sn, 0.0) * np.float32(
                        1.0 / math.pi
                    )
                    if has_glos:
                        p_b_g = (gl + np.float32(1.0)) * np.float32(
                            1.0 / (2.0 * math.pi)
                        ) * _pow_safe_k(
                            ldx * gmx + ldy * gmy + ldz * gmz, gl
                        )
                        p_b_s = jnp.where(glm, p_b_g, p_b_s)
                    w_nee = w_nee * (p_l_s / (p_l_s + p_b_s))
                if textbook or mis_est:
                    # Unbiased shadow-ray direct term with the PRE-update
                    # throughput; continuation is plain cosine (wgt = 1).
                    # Mirrors build_kernel's textbook block exactly.
                    is_diff_tb = ~(h["is_spec"] | h["is_refr"])
                    if multi:
                        e_l_use = tuple(
                            _sel_f([_e_lights[k][c] for k in range(K_L)])
                            for c in range(3)
                        )
                    else:
                        e_l_use = tuple(
                            emi_ref[light_id, c] for c in range(3)
                        )
                    gate = jnp.where(
                        alive & is_diff_tb & success, w_nee,
                        np.float32(0.0),
                    )
                    dir_r = gate * tr_ * h["alb"][0] * e_l_use[0]
                    dir_g = gate * tg * h["alb"][1] * e_l_use[1]
                    dir_b = gate * tb * h["alb"][2] * e_l_use[2]
                    ar_n = ar_n + dir_r
                    ag_n = ag_n + dir_g
                    ab_n = ab_n + dir_b
                    ndx, ndy, ndz = scx, scy, scz
                    wgt = one
                else:
                    gate = None
                    ndx = jnp.where(success, ldx, scx)
                    ndy = jnp.where(success, ldy, scy)
                    ndz = jnp.where(success, ldz, scz)
                    wgt = jnp.where(success, w_nee, 1.0)
                    if multi:
                        # NEE-success lanes continue from the lifted probe
                        # origin (forward kernel's cont_off).
                        cont_off = success
                if est == "mixture":
                    um = uni(seed, pid, ctr + _u32c(rng.P_MIX_COIN))
                    take = um < mix_q
                    ndx = jnp.where(take, ndx, scx)
                    ndy = jnp.where(take, ndy, scy)
                    ndz = jnp.where(take, ndz, scz)
                    wgt = jnp.where(take, wgt, 1.0)
                    if multi:
                        cont_off = cont_off & take
            else:
                ndx, ndy, ndz = scx, scy, scz
                if est == "uniform_corrected":
                    wgt = np.float32(2.0) * jnp.maximum(
                        ndx * nx + ndy * ny + ndz * nz, 0.0
                    )
                else:
                    wgt = one

            if has_spec or has_refr:
                ngx, ngy, ngz = h["ngm"]
                nd_ = ngx * dx + ngy * dy + ngz * dz
                rfx = dx - ngx * (np.float32(2.0) * nd_)
                rfy = dy - ngy * (np.float32(2.0) * nd_)
                rfz = dz - ngz * (np.float32(2.0) * nd_)
                if has_spec:
                    sp = h["is_spec"]
                    ndx = jnp.where(sp, rfx, ndx)
                    ndy = jnp.where(sp, rfy, ndy)
                    ndz = jnp.where(sp, rfz, ndz)
                    wgt = jnp.where(sp, 1.0, wgt)
                if has_refr:
                    rf = h["is_refr"]
                    into = (ngx * nx + ngy * ny + ngz * nz) > 0.0
                    nnt = jnp.where(
                        into, np.float32(1.0 / 1.5), np.float32(1.5)
                    )
                    ddn = dx * nx + dy * ny + dz * nz
                    cos2t = np.float32(1.0) - nnt * nnt * (
                        np.float32(1.0) - ddn * ddn
                    )
                    tir = cos2t < 0.0
                    sq = jnp.sqrt(
                        jnp.where(cos2t > 0.0, cos2t, 1.0)
                    ) * jnp.where(
                        cos2t > 0.0, np.float32(1.0), np.float32(0.0)
                    )
                    sgn_in = jnp.where(into, np.float32(1.0), np.float32(-1.0))
                    scale = sgn_in * (ddn * nnt + sq)
                    tdx = dx * nnt - ngx * scale
                    tdy = dy * nnt - ngy * scale
                    tdz = dz * nnt - ngz * scale
                    inv_tl = jax.lax.rsqrt(tdx * tdx + tdy * tdy + tdz * tdz)
                    tdx, tdy, tdz = tdx * inv_tl, tdy * inv_tl, tdz * inv_tl
                    r0 = np.float32(0.04)
                    cth = np.float32(1.0) - jnp.where(
                        into, -ddn, tdx * ngx + tdy * ngy + tdz * ngz
                    )
                    re = r0 + (np.float32(1.0) - r0) * cth * cth * cth * cth * cth
                    trn = np.float32(1.0) - re
                    prr = np.float32(0.25) + np.float32(0.5) * re
                    u_refr = uni(seed, pid, ctr + _u32c(rng.P_REFR_COIN))
                    pick_refl = (u_refr < prr) | tir
                    w_refr = jnp.where(
                        tir, np.float32(1.0),
                        jnp.where(pick_refl, re / prr,
                                  trn / (np.float32(1.0) - prr)),
                    )
                    ndx = jnp.where(rf, jnp.where(pick_refl, rfx, tdx), ndx)
                    ndy = jnp.where(rf, jnp.where(pick_refl, rfy, tdy), ndy)
                    ndz = jnp.where(rf, jnp.where(pick_refl, rfz, tdz), ndz)
                    wgt = jnp.where(rf, w_refr, wgt)

            if has_glos:
                # GLOS override: Phong continuation; below-horizon samples
                # are absorbed (the lane dies), mirroring the forward.
                ndx = jnp.where(glm, glx, ndx)
                ndy = jnp.where(glm, gly, ndy)
                ndz = jnp.where(glm, glz, ndz)
                wgt = jnp.where(glm, gw, wgt)
                alive_next = alive_next & ~(glm & (gw <= 0.0))

            f_scale = inv_p * wgt
            f_ch = (
                h["alb"][0] * f_scale,
                h["alb"][1] * f_scale,
                h["alb"][2] * f_scale,
            )
            tr_n = tr_ * f_ch[0]
            tg_n = tg * f_ch[1]
            tb_n = tb * f_ch[2]

            # ---------------- pass-B gradient accumulation ----------------
            isB = (ph > 0) & alive
            isB_f = jnp.where(isB, np.float32(1.0), np.float32(0.0))
            T_ch = (tr_, tg, tb)
            A_n = (ar_n, ag_n, ab_n)
            LA = (lar, lag, lab)
            # T_j * S_{j+1} per channel, via the guarded tail divide.
            TS = []
            for chn in range(3):
                tail = LA[chn] - A_n[chn]
                fc = f_ch[chn]
                safe = fc != 0.0
                TS.append(
                    jnp.where(safe, tail, 0.0)
                    / jnp.where(safe, fc, 1.0)
                )
            # Albedo cotangent coefficients (shared across objects):
            #  direct term: g*TS*inv_p*wgt on the hit channel;
            #  RR 1/p term: -(inv_p^2)*sum_ch g*TS*c*wgt on the max-albedo
            #  channel(s), tie-split (matches jnp.max's VJP).
            val_alb = [g_ct[chn] * TS[chn] * f_scale for chn in range(3)]
            rr_f = jnp.where(rr_active & p_pos, np.float32(1.0),
                             np.float32(0.0))
            s_am = (
                g_ct[0] * TS[0] * h["alb"][0]
                + g_ct[1] * TS[1] * h["alb"][1]
                + g_ct[2] * TS[2] * h["alb"][2]
            ) * wgt * (-(inv_p * inv_p)) * rr_f
            eqs = [
                jnp.where(h["alb"][chn] == p_max, np.float32(1.0),
                          np.float32(0.0))
                for chn in range(3)
            ]
            n_eq = eqs[0] + eqs[1] + eqs[2]
            inv_neq = np.float32(1.0) / jnp.where(n_eq > 0.0, n_eq, 1.0)
            am_w = [e * inv_neq for e in eqs]
            val_alb_tot = [
                val_alb[chn] + am_w[chn] * s_am for chn in range(3)
            ]
            if textbook or mis_est:
                # Direct-term cotangents: b_dir = gate*T*c*e_light, so
                # d/dc picks up gate*T*e_light on the hit object and
                # d/de_light picks up gate*T*c on the (per-lane sampled)
                # LIGHT's emission row. For mis, gate already carries the
                # balance weight (a materials-constant — p_l, p_b, and q
                # are all geometry/selection quantities; q is
                # stop-gradient'ed per sampling.light_select_probs).
                val_alb_tot = [
                    val_alb_tot[chn]
                    + g_ct[chn] * gate * T_ch[chn] * e_l_use[chn]
                    for chn in range(3)
                ]
            # Emission cotangent: the pickup this bounce used T_j (gated by
            # the textbook double-count suppression via emit_f).
            val_emi = [
                g_ct[chn] * T_ch[chn] * emit_f for chn in range(3)
            ]

            hobj = h["obj"]
            for o in range(n_obj):
                m = jnp.where(hobj == np.int32(o), isB_f, np.float32(0.0))
                for chn in range(3):
                    ia = o * 3 + chn
                    gacc[ia] = gacc[ia] + m * val_alb_tot[chn]
                    ie = n_obj * 3 + ia
                    gacc[ie] = gacc[ie] + m * val_emi[chn]
            if (textbook or mis_est) and multi:
                # Route the direct-term emission cotangent to the per-lane
                # SAMPLED light's row (gate is zero off-success, so the
                # lidx mask only picks the routing).
                for k in range(K_L):
                    mk = jnp.where(
                        lidx == np.int32(k), isB_f, np.float32(0.0)
                    )
                    for chn in range(3):
                        ie_l = n_obj * 3 + light_ids_all[k] * 3 + chn
                        gacc[ie_l] = gacc[ie_l] + (
                            mk * g_ct[chn] * gate * T_ch[chn]
                            * h["alb"][chn]
                        )
            elif textbook or mis_est:
                for chn in range(3):
                    ie_l = n_obj * 3 + light_id * 3 + chn
                    gacc[ie_l] = gacc[ie_l] + (
                        isB_f * g_ct[chn] * gate * T_ch[chn] * h["alb"][chn]
                    )
            # --------------------------------------------------------------

            alive_next = alive_next & (depth < max_bounces)
            died = alive & ~alive_next
            phB = ph > 0
            to_b = died & ~phB          # pass A done -> replay as pass B
            adv = died & phB            # pass B done -> next sample
            s_next = s + jnp.where(adv, np.uint32(1), np.uint32(0))
            respawn_a = adv & (s_next < s_stop)
            reborn = to_b | respawn_a | pending
            pid_sel = jnp.where(to_b | pending, pid, pid_base + s_next)
            o_sp, d_sp = spawn(seed, px, py, pid_sel)

            live = alive_next
            if multi and est in ("nee", "mixture"):
                # Continuation origin override for light-list NEE-success
                # diffuse lanes (lifted probe origin — forward kernel's
                # off_m block).
                off_m = cont_off & ~(h["is_spec"] | h["is_refr"])
                hx = jnp.where(off_m, pox, hx)
                hy = jnp.where(off_m, poy, hy)
                hz = jnp.where(off_m, poz, hz)
            ox = jnp.where(reborn, o_sp[0], jnp.where(live, hx, ox))
            oy = jnp.where(reborn, o_sp[1], jnp.where(live, hy, oy))
            oz = jnp.where(reborn, o_sp[2], jnp.where(live, hz, oz))
            dx = jnp.where(reborn, d_sp[0], jnp.where(live, ndx, dx))
            dy = jnp.where(reborn, d_sp[1], jnp.where(live, ndy, dy))
            dz = jnp.where(reborn, d_sp[2], jnp.where(live, ndz, dz))
            tr_ = jnp.where(reborn, 1.0, jnp.where(live, tr_n, tr_))
            tg = jnp.where(reborn, 1.0, jnp.where(live, tg_n, tg))
            tb = jnp.where(reborn, 1.0, jnp.where(live, tb_n, tb))
            lar = jnp.where(to_b, ar_n, lar)
            lag = jnp.where(to_b, ag_n, lag)
            lab = jnp.where(to_b, ab_n, lab)
            ar = jnp.where(reborn, 0.0, ar_n)
            ag = jnp.where(reborn, 0.0, ag_n)
            ab = jnp.where(reborn, 0.0, ab_n)
            ph = jnp.where(to_b, np.int32(1),
                           jnp.where(respawn_a, np.int32(0), ph))
            depth = jnp.where(reborn, 0, depth)
            s = s_next
            pid = jnp.where(reborn, pid_sel, pid)
            alive_i = jnp.where(
                alive_next | reborn, np.int32(1), np.int32(0)
            )
            if textbook:
                # Next bounce suppresses the sampled light's pickup for
                # continuing diffuse lanes; reborn lanes start fresh.
                ne = jnp.where(
                    alive_next & is_diff_tb & ~reborn, np.int32(1),
                    np.int32(0),
                )
            else:
                ne = jnp.zeros_like(ne)
            if mis_est:
                # Balance carry for the next pickup (forward kernel's
                # mpdf block): cosine (or Phong) continuation pdf for
                # surviving diffuse lanes, 0 for spec/refr and reborn.
                is_diff_m = ~(h["is_spec"] | h["is_refr"])
                cos_c = ndx * nx + ndy * ny + ndz * nz
                pdf_cont = jnp.maximum(cos_c, 0.0) * np.float32(
                    1.0 / math.pi
                )
                if has_glos:
                    pdf_cont = jnp.where(
                        glm,
                        (gl + np.float32(1.0))
                        * np.float32(1.0 / (2.0 * math.pi))
                        * _pow_safe_k(
                            ndx * gmx + ndy * gmy + ndz * gmz, gl
                        ),
                        pdf_cont,
                    )
                mpdf = jnp.where(
                    alive_next & is_diff_m & ~reborn,
                    pdf_cont,
                    np.float32(0.0),
                )
                return (ox, oy, oz, dx, dy, dz, tr_, tg, tb, ar, ag, ab,
                        lar, lag, lab, ph, alive_i, depth, s, pid, ne,
                        mpdf, *gacc)
            return (ox, oy, oz, dx, dy, dz, tr_, tg, tb, ar, ag, ab,
                    lar, lag, lab, ph, alive_i, depth, s, pid, ne, *gacc)

        out = jax.lax.while_loop(cond, body, carry0)

        # This block's cotangent sums, one row per block: blocks run in
        # parallel, and XLA sums the rows after the launch.
        for k in range(n_acc):
            gout_ref[0, k] = jnp.sum(out[n_state + k])

    return kernel, n_obj


# ---------------------------------------------------------------------------
# Host wrappers (cached per geometry/config like megakernel.render_pallas).
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def _geom_key(scene: Scene, cam: CameraParams, cfg: RenderConfig, tag: str):
    h = hashlib.sha256()
    # Geometry + light(s) only — materials are runtime inputs. scene.lights
    # leaves are all geometry (corner/edges/obj_id), so the whole list goes
    # into the key (distinct light lists over identical geometry compile
    # distinct kernels — selection CDF structure and probe lift differ).
    h.update(b"L" if scene.lights is not None else b"-")
    for leaf in jax.tree.leaves((
        scene.rects.axis, scene.rects.k, scene.rects.lo, scene.rects.hi,
        scene.rects.refl, scene.quads.corner, scene.quads.edge_u,
        scene.quads.edge_v, scene.quads.refl, scene.spheres.center,
        scene.spheres.radius, scene.spheres.refl, scene.light, cam,
        scene.lights,
    )):
        h.update(np.asarray(leaf).tobytes())
    return (tag, h.hexdigest(), cfg, route.platform(), route.block_lanes())


def launch_vjp(kernel, n_obj: int, n_blocks: int, seed, albedo, emission,
               lanes, g_lanes):
    """One adjoint-kernel launch over padded lanes with per-lane image
    cotangents g_lanes (3 planes). Returns (d albedo (K, 3), d emission
    (K, 3)): the per-block cotangent rows, summed by XLA."""
    n_acc = 2 * n_obj * 3
    rows = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[pl.BlockSpec()] * 3 + [lane_spec()] * 8,
        out_specs=pl.BlockSpec((1, n_acc), lambda i: (i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_blocks, n_acc), jnp.float32),
        name="spt_material_vjp",
        **route.pallas_call_kwargs(),
    )(jnp.asarray(seed, jnp.uint32).reshape(1), albedo, emission, *lanes,
      *g_lanes)
    tot = rows.sum(axis=0)
    return tot[:n_obj * 3].reshape(n_obj, 3), tot[n_obj * 3:].reshape(n_obj, 3)


def render_pallas_mat(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                      albedo, emission, seed):
    """Forward megakernel with RUNTIME materials: renders scene geometry
    with the given (K, 3) albedo/emission tables (pack_materials order).
    Bit-identical to render_pallas at equal materials; compiled once per
    geometry/config, so material-optimization loops do not recompile.

    Returns ((h, w, 3) radiance SUM over spp, per-block trace rows as
    render_pallas)."""
    key = _geom_key(scene, cam, cfg, "fwd_mat")
    fn = _CACHE.get(key)
    if fn is None:
        fn = _CACHE[key] = _build_fwd_mat(scene, cam, cfg)
    img, per_block = fn(
        jnp.asarray(albedo, jnp.float32), jnp.asarray(emission, jnp.float32),
        jnp.asarray(seed, jnp.uint32),
    )
    return img, per_block


def _build_fwd_mat(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    kernel = build_kernel(scene, cam, cfg, mat_refs=True)
    n_pix = cfg.width * cfg.height
    g, per, n_lanes, n_blocks = lane_layout(n_pix, cfg.spp, cfg.regen_groups)

    @jax.jit
    def run(albedo, emission, seed):
        _, lanes = frame_lanes(cfg, n_pix, g, per, n_blocks)
        L, traces = launch_forward(kernel, n_blocks, seed,
                                   (albedo, emission), lanes)
        img = L[:n_lanes].reshape(n_pix, g, 3).sum(axis=1)
        return img.reshape(cfg.height, cfg.width, 3), traces

    return run


def render_pallas_vjp(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                      albedo, emission, seed, g_img):
    """Adjoint megakernel: cotangents of sum_px( g_img . I_sum ) where
    I_sum is render_pallas_mat's radiance SUM over spp.

    Returns (d/d albedo (K, 3), d/d emission (K, 3)) — pathwise, matching
    jax.grad through the jnp lax.scan wavefront (see module docstring)."""
    key = _geom_key(scene, cam, cfg, "vjp")
    fn = _CACHE.get(key)
    if fn is None:
        fn = _CACHE[key] = _build_vjp(scene, cam, cfg)
    return fn(
        jnp.asarray(albedo, jnp.float32), jnp.asarray(emission, jnp.float32),
        jnp.asarray(seed, jnp.uint32), jnp.asarray(g_img, jnp.float32),
    )


def _build_vjp(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    kernel, n_obj = build_grad_kernel(scene, cam, cfg)
    n_pix = cfg.width * cfg.height
    g, per, _, n_blocks = lane_layout(n_pix, cfg.spp, cfg.regen_groups)

    @jax.jit
    def run(albedo, emission, seed, g_img):
        pix, lanes = frame_lanes(cfg, n_pix, g, per, n_blocks)
        # Lane cotangent = its pixel's.
        g_lane = g_img.reshape(-1, 3)[pix]
        return launch_vjp(
            kernel, n_obj, n_blocks, seed, albedo, emission, lanes,
            [pad_lanes(g_lane[:, c], n_blocks) for c in range(3)],
        )

    return run


def material_train_step_sharded(scene: Scene, cam: CameraParams,
                                cfg: RenderConfig, mesh, target):
    """Sharded material-fit step: ONE shard_map in which every device (a)
    renders its (pixel-block x sample-range) lanes through the
    runtime-material forward kernel, (b) psums the partial image over the
    sample axis, (c) derives its local loss cotangent from its own pixel
    rows of ``target``, and (d) runs the adjoint kernel on the same
    lanes, psum-reducing the (K, 3) material cotangents over the whole
    mesh — the multi-device form of loss_and_material_grads, so
    ``fit --pallas`` scales like the forward renderer.

    Returns step(albedo, emission, seed) -> (loss, galb, gemi); compiled
    once per (geometry, cfg, mesh)."""
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import AXIS_PIXEL, AXIS_SAMPLE

    n_sp = mesh.shape[AXIS_PIXEL]
    n_dp = mesh.shape[AXIS_SAMPLE]
    n_pix = cfg.width * cfg.height
    spp = cfg.spp
    if n_pix % n_sp or spp % n_dp:
        raise ValueError(f"{n_pix=} % {n_sp=} or {spp=} % {n_dp=} != 0")
    n_pix_loc = n_pix // n_sp
    n_s_loc = spp // n_dp
    g, per, n_lanes, n_blocks = lane_layout(n_pix_loc, n_s_loc,
                                            cfg.regen_groups)

    fwd_kernel = build_kernel(scene, cam, cfg, mat_refs=True)
    grad_kernel, n_obj = build_grad_kernel(scene, cam, cfg)
    target = jnp.asarray(target, jnp.float32).reshape(n_pix, 3)
    inv_n = np.float32(2.0 / (n_pix * 3 * spp))

    def local(albedo, emission, seed, tgt_loc):
        pix0 = (jax.lax.axis_index(AXIS_PIXEL) * n_pix_loc).astype(
            jnp.uint32
        )
        samp0 = (
            jax.lax.axis_index(AXIS_SAMPLE) * n_s_loc
        ).astype(jnp.uint32)
        _, lanes = frame_lanes(cfg, n_pix_loc, g, per, n_blocks, pix0, samp0)
        L, _ = launch_forward(fwd_kernel, n_blocks, seed,
                              (albedo, emission), lanes)
        img_loc = L[:n_lanes].reshape(n_pix_loc, g, 3).sum(axis=1)
        img_loc = jax.lax.psum(img_loc, AXIS_SAMPLE)  # sum over spp
        diff = img_loc / np.float32(spp) - tgt_loc
        loss_loc = jnp.sum(diff * diff) / np.float32(n_pix * 3)
        # loss_loc is already REPLICATED along the sample axis (diff is
        # built from the sample-psum'd image), so only the pixel axis
        # needs summing — a both-axes psum / n_dp would double-count, and
        # the previous AXIS_PIXEL-psum / n_dp UNDER-counted by n_dp on
        # sample-sharded meshes (caught by the n_dp=2 equality tests).
        loss = jax.lax.psum(loss_loc, AXIS_PIXEL)
        # d loss / d img_sum rows for THIS device's pixels.
        g_lane = (diff * inv_n)[
            jnp.repeat(jnp.arange(n_pix_loc, dtype=jnp.int32), g)
        ]
        galb, gemi = launch_vjp(
            grad_kernel, n_obj, n_blocks, seed, albedo, emission, lanes,
            [pad_lanes(g_lane[:, c], n_blocks) for c in range(3)],
        )
        galb = jax.lax.psum(galb, (AXIS_PIXEL, AXIS_SAMPLE))
        gemi = jax.lax.psum(gemi, (AXIS_PIXEL, AXIS_SAMPLE))
        return loss, galb, gemi

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(AXIS_PIXEL)),
        out_specs=(P(), P(), P()), check_vma=False,
    )

    @jax.jit
    def step(albedo, emission, seed):
        return sharded(
            jnp.asarray(albedo, jnp.float32),
            jnp.asarray(emission, jnp.float32),
            jnp.asarray(seed, jnp.uint32), target,
        )

    return step


def loss_and_material_grads(scene: Scene, cam: CameraParams,
                            cfg: RenderConfig, seed, target):
    """One kernel-path training evaluation: MSE of the linear mean image vs
    ``target`` (h, w, 3), with albedo/emission gradients from the adjoint
    kernel. Returns (loss, galb (K,3), gemi (K,3))."""
    alb, emi = pack_materials(scene)
    img_sum, _ = render_pallas_mat(scene, cam, cfg, alb, emi, seed)
    spp = cfg.spp
    img = img_sum / spp
    target = jnp.asarray(target, jnp.float32)
    diff = img - target
    loss = jnp.mean(diff * diff)
    # d loss / d img_sum = 2*diff / (h*w*3) / spp.
    g_img = diff * (2.0 / (diff.size * spp))
    galb, gemi = render_pallas_vjp(scene, cam, cfg, alb, emi, seed, g_img)
    return loss, galb, gemi


def fit_pallas(scene: Scene, cam: CameraParams, cfg: RenderConfig, target,
               steps: int = 20, lr: float = 1.0,
               train_fields: tuple[str, ...] = ("emission", "albedo"),
               seed: int = 0, log=None,
               checkpoint: str | None = None, checkpoint_every: int = 0):
    """Kernel-path inverse rendering: SGD on the material tables through
    the forward+adjoint megakernels. Both kernels compile once (materials
    are runtime inputs); each step costs ~3x a forward render (1 forward +
    the two-pass adjoint replay).

    checkpoint: optional training-state directory (utils/train_checkpoint)
    — resumed if present, saved every ``checkpoint_every`` steps (0 = only
    at the end). Resuming reproduces the uninterrupted run exactly (each
    step's randomness is the fixed per-step counter seed).

    Returns (optimized scene, list of per-step losses)."""
    alb, emi = pack_materials(scene)
    start = 0
    tag = ""
    if checkpoint:
        from ..utils.train_checkpoint import (
            load_train_state,
            save_train_state,
            train_tag,
        )

        tag = train_tag(cfg, f"fit_pallas|{lr}|{sorted(train_fields)}",
                        scene=scene, cam=cam, target=target)
        st = load_train_state(checkpoint, {"alb": alb, "emi": emi}, tag=tag)
        if st is not None:
            start, params, _ = st
            alb, emi = params["alb"], params["emi"]
    losses = []
    for i in range(start, steps):
        s = unpack_materials(scene, alb, emi)
        loss, galb, gemi = loss_and_material_grads(
            s, cam, cfg, jnp.uint32(seed), target
        )
        if "albedo" in train_fields:
            alb = alb - lr * galb
        if "emission" in train_fields:
            emi = emi - lr * gemi
        losses.append(float(loss))
        if log is not None:
            print(f"step {i}: loss {float(loss):.6f}", file=log)
        if checkpoint and (
            i == steps - 1
            or (checkpoint_every and (i + 1) % checkpoint_every == 0)
        ):
            save_train_state(checkpoint, i + 1,
                             {"alb": alb, "emi": emi}, tag=tag)
    return unpack_materials(scene, alb, emi), losses
