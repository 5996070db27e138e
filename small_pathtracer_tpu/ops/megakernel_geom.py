"""Geometry-differentiable Pallas megakernel: sphere center/radius (and
materials) at kernel speed, over the RUNTIME sphere table.

The material adjoint kernel
(ops/megakernel_grad.py) differentiates materials only, so sphere
center/radius fits paid 2P+1 CRN finite-difference renders per step
(grad/fd.py). This kernel computes the full pathwise INTERIOR cotangent
of the radiance estimate w.r.t. every table sphere's (center, radius,
albedo, emission) and every unrolled object's (albedo, emission) in ONE
kernel launch — the reference analogue is the whole ``radiance()`` chain
(/root/reference/src/smallpt.cpp:419-496) with the sphere geometry at
:223-254. Silhouette/occlusion (boundary) terms are discrete in the
path measure and are NOT computed here; compose with the jnp edge
samplers (grad/edge.py) exactly as geometry_loss_and_grad does.

Design (reverse-mode over the bounce chain, O(D^2) replay, no tape):

The per-sample radiance is produced by the chain
    state_j = (o_j, d_j, T_j, A_j),
    A_{j+1} = A_j + T_j * e_{k_j}            (+ textbook direct term)
    T_{j+1} = T_j * c_{k_j} * inv_p_j * w_j
    o_{j+1} = x_j = o_j + t_j d_j,   d_{j+1} = dir_j(x_j, n_j, xi)
with t_j, n_j, w_j depending on geometry theta. Holding the path's
discrete structure fixed (winner ids, RR coins, NEE success, mixture
take, refl/refr picks — the pathwise/interior view), the adjoint needs
only lambda = (dL/d o_j, dL/d d_j) per bounce:

 * T's adjoint never needs carrying: the product structure gives
   dL/dw_j = sum_ch g_ch (L_ch - A_{j+1,ch}) / w_j via the same guarded
   tail-divide the material kernel uses (megakernel_grad.py docstring).
 * Each lane runs a per-sample state machine: pass A replays the path
   once to latch (L, D); then for j = D..1 it replays bounces 1..j-1 and
   runs bounce j as a VJP bounce — ``jax.vjp`` of a winner-conditioned
   differentiable bounce step (diff_step below) pulled back with
   (lambda_o, lambda_d, sigma_w, sigma_tb), yielding the new lambda and
   the winner sphere's (center, radius) cotangents. Replay costs
   sum_j j = D(D+1)/2 extra bounces per sample; the NEE-continuation
   estimators' mean path length is ~2.5 (SURVEY.md section 6), so a full
   gradient costs a small constant times one forward render — versus
   2P+1 FULL renders for FD (grad/fd.py), independent of P.
 * diff_step re-expresses the PRIMAL bounce's continuous quantities
   (winner t, normal, NEE direction/weight, scatter/reflect/refract
   direction) as functions of (o, d, center, radius) with every discrete
   choice closed over as a detached constant, then ``jax.vjp`` pulls the
   cotangents back — no hand-derived Jacobians. Analytic equivalence,
   not bit-equality, is what the VJP needs (it is evaluated at the
   primal point; float-level formula differences only perturb the
   linearization by ulps).
 * Material cotangents reuse the material kernel's analytic pass-B
   formulas (direct term, RR 1/p tie-split, emission pickups, textbook
   direct term) — each bounce is VJP'd exactly once per sample, so the
   coverage is identical. Sphere materials route to the winner's table
   row by a per-row masked add into per-lane accumulators; every block
   sums its lanes into one output row, and XLA sums the rows.

Everything trainable is a RUNTIME input (the packed sphere table +
unrolled material tables of build_kernel(sphere_tab=True)), so a fit
loop never recompiles — the property that makes kernel-speed geometry
fitting practical (grad/fd.py got it from the same table).

Scope (hard-validated in build_geom_grad_kernel): sphere_tab scenes
(all spheres in the table, light an unrolled rect/quad, single light),
estimators nee / mixture / nee_textbook / cosine / uniform /
uniform_corrected / mis (the balance weights add two adjoint flows: the
pickup weight w_b(t, d, mpdf) rides diff_step as an extra in/out pair,
and a lambda_mpdf carry register routes its cotangent one bounce BACK
onto the previous bounce's continuation-pdf output), DIFF/SPEC/REFR
materials, multi-emitter light lists (scene.lights: the per-lane
selection draw is replayed, NEE weights carry 1/q_k, the per-hit pickup
density folds q, the SHADOW_EPS-lifted probe origin rides the
differentiable normal, and the direct-term emission cotangent routes to
the per-lane SAMPLED light's row), GLOS glossy materials on unrolled
rects/quads (modified-Phong lobe with the reflected axis differentiable
via the incoming direction; phong NEE weights, mis balance pdfs and
continuation pdfs replayed; GLOS spheres cannot ride the table — same
constraint as the forward kernel), hash RNG (the samplers' documented
behavior: gradient paths sample their own forward with the hash RNG —
config.py ``sampler``).
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..core import rng
from ..core import vecmath as vm
from ..scene.types import Scene
from ..integrator.sampling import SHADOW_EPS
from . import route
from .megakernel import (
    TAB_STRIDE,
    _FlatRows,
    _geom_hash_structure,
    _light_list_consts,
    _light_select_cdf,
    _probe_unrolled,
    _runtime_materials,
    _scene_consts,
    _sphere_tables,
    _trace_unrolled,
    _u32c,
    _uniform_for,
    frame_lanes,
    lane_layout,
    lane_spec,
    make_spawn,
    pad_lanes,
)

# Per-sphere gradient columns in the accumulators / flat output:
# [cx, cy, cz, r, alb_r, alb_g, alb_b, emi_r, emi_g, emi_b]. Every lane
# carries U*6 + S*G_COLS accumulators, so registers bound the sphere
# count this kernel serves well (PERF.md).
G_COLS = 10

# Largest sphere table the kernel accepts: its per-lane carries and
# per-bounce masked adds grow with S. On an H100 it beat jax.grad of
# grad/adjoint.render_linear at every count measured, up to this one
# (2.0x, 47 s cold compile; PERF.md, "Geometry adjoint and sphere
# count"); larger tables were not measured. Larger scenes fit through the
# jnp adjoint or fit --fd-sphere.
GEOM_MAX_SPHERES = 128

SUPPORTED_ESTIMATORS = (
    "nee", "mixture", "nee_textbook", "cosine", "uniform",
    "uniform_corrected", "mis",
)


def build_geom_grad_kernel(scene: Scene, cam: CameraParams,
                           cfg: RenderConfig):
    """The geometry+materials adjoint kernel body (module docstring)."""
    rects, quads, spheres, light, lightlist = _scene_consts(scene)
    if lightlist is not None and any(
        L.get("kind", 0) == 1 for L in lightlist
    ):
        raise NotImplementedError(
            "the geometry-adjoint kernel's light-list path is "
            "parallelogram-only; LIGHT_SPHERE rows run on the jnp adjoint "
            "(jax.grad through integrator/wavefront.path_trace_fixed) — "
            "documented waiver, COVERAGE.md"
        )
    if light.get("kind") == "sphere":
        raise NotImplementedError(
            "the geometry-adjoint kernel supports parallelogram lights "
            "only; sphere-light (SphereLight) scenes use the jnp adjoint "
            "(jax.grad through integrator/wavefront.path_trace_fixed) — "
            "documented waiver, COVERAGE.md"
        )
    est = cfg.estimator
    if est not in SUPPORTED_ESTIMATORS:
        raise ValueError(
            f"the geometry adjoint kernel implements {SUPPORTED_ESTIMATORS}"
            f"; got estimator={est!r}"
        )
    multi = lightlist is not None  # multi-emitter list (scene.lights)
    if any(o["refl"] == 3 for o in spheres):
        raise ValueError(
            "the geometry adjoint kernel cannot place GLOS spheres in "
            "the table (same constraint as the forward sphere-table "
            "kernel); use the jnp adjoint (grad/adjoint.py)"
        )
    has_glos = any(o["refl"] == 3 for o in rects + quads)
    if has_glos and est not in ("cosine", "nee_textbook", "mis"):
        raise ValueError(
            f"estimator {est!r} has no glossy (GLOS) semantics; use "
            "cosine, nee_textbook, or mis (integrator contract)"
        )
    S = len(spheres)
    if S == 0:
        raise ValueError("no spheres to differentiate; use the material "
                         "adjoint kernel (ops/megakernel_grad.py)")
    if S > GEOM_MAX_SPHERES:
        raise ValueError(
            f"the geometry adjoint kernel takes at most {GEOM_MAX_SPHERES} "
            f"spheres (got {S}); fit larger scenes with the jnp adjoint "
            "(drop --pallas) or fit --fd-sphere"
        )
    base = len(rects) + len(quads)
    if base == 0:
        raise ValueError("sphere-table mode needs at least one unrolled "
                         "rect/quad (C15 miss default)")
    light_id = light["light_obj_id"]
    if light_id >= base:
        raise ValueError("the light must be an unrolled rect/quad")
    if multi:
        # Multi-emitter light lists (scene.lights): the per-lane selection
        # draw is replayed exactly as megakernel_grad does; every emitter
        # must be an unrolled rect/quad (table spheres cannot emit in
        # sphere-table mode — build_kernel enforces the same).
        ml = _light_list_consts(lightlist)
        K_L = len(ml)
        light_ids_all = tuple(m["id"] for m in ml)
        for m in ml:
            if int(m["id"]) >= base:
                raise ValueError(
                    "geometry adjoint: every light-list emitter must be "
                    "an unrolled rect/quad, not a table sphere"
                )
    has_spec = any(o["refl"] == 1 for o in rects + quads + spheres)
    has_refr = any(o["refl"] == 2 for o in rects + quads + spheres)
    # Spheres ride the runtime table; only rects/quads stay unrolled.
    unrolled = rects + quads
    U = base
    spheres_unrolled: list = []

    uni = _uniform_for(cfg.rng_backend)
    textbook = est == "nee_textbook"
    mis_est = est == "mis"
    glibc = cfg.light_sample_mode == "glibc_overflow"
    nee_like = est in ("nee", "mixture", "nee_textbook", "mis")

    spawn, _origin = make_spawn(cam, cfg)

    # Light-plane constants (C13): corner, edges, unit normal, area.
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

    # Per-unrolled-object plane geometry for the winner-conditioned
    # differentiable t: a point on the plane + the (unoriented) unit
    # normal. Rects: point = k * e_axis, normal = e_axis; quads: corner +
    # normalized edge cross product.
    plane_pts = []
    plane_ns = []
    for r in rects:
        a = r["axis"]
        pt = [0.0, 0.0, 0.0]
        pt[a] = float(r["k"])
        nv = [0.0, 0.0, 0.0]
        nv[a] = 1.0
        plane_pts.append(tuple(np.float32(v) for v in pt))
        plane_ns.append(tuple(np.float32(v) for v in nv))
    for qd in quads:
        eu, ev = qd["edge_u"], qd["edge_v"]
        nq = (
            eu[1] * ev[2] - eu[2] * ev[1],
            eu[2] * ev[0] - eu[0] * ev[2],
            eu[0] * ev[1] - eu[1] * ev[0],
        )
        nl = math.sqrt(sum(v * v for v in nq))
        plane_pts.append(tuple(np.float32(v) for v in qd["corner"]))
        plane_ns.append(tuple(np.float32(v / nl) for v in nq))

    rr_depth = np.int32(cfg.rr_start_depth)
    max_bounces = np.int32(cfg.max_bounces)
    mix_q = np.float32(cfg.mixture_q)
    DPB = _u32c(rng.DRAWS_PER_BOUNCE)
    NPLANES = U * 6 + S * G_COLS

    def glibc_offset(u):
        r = (u * np.float32(2147483648.0)).astype(jnp.uint32)
        wrapped = (r * np.uint32(36)).view(jnp.int32).astype(jnp.float32)
        return wrapped * np.float32(1.0 / 2147483647.0)

    def kernel(seed_ref, bk_ref, alb_ref_raw, emi_ref_raw, tab_ref,
               px_ref, py_ref, pid_ref, sstart_ref, sstop_ref,
               gr_ref, gg_ref, gb_ref,
               ir_ref, ig_ref, ib_ref, gout_ref):
        alb_ref = _FlatRows(alb_ref_raw, 3)
        emi_ref = _FlatRows(emi_ref_raw, 3)
        rects_k = _runtime_materials(rects, alb_ref, emi_ref, 0)
        quads_k = _runtime_materials(quads, alb_ref, emi_ref, len(rects))
        tab = (tab_ref, S, base)
        e_light_k = tuple(emi_ref[light_id, c] for c in range(3))
        if multi:
            # Selection q/cdf/e from the RUNTIME emission table, exactly
            # as the forward mat_refs kernel computes them (values only;
            # q is stop-gradient'ed per sampling.light_select_probs).
            _q_l, _cdf_l, _e_lights = _light_select_cdf(
                ml, unrolled, cfg.light_select, emi_ref
            )

        seed = seed_ref[0]
        do_bk = bk_ref[0] > 0
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

        # Lanes start in a PENDING state (alive_i == 2) and receive their
        # first primary ray from the SAME in-body spawn expression the
        # respawn path uses. A spawn evaluated outside the while loop can
        # differ from the in-body one by an ulp (different XLA
        # contraction/folding context); the backward pass replays paths
        # by re-spawning, and a 1-ulp primary-ray difference is enough to
        # flip a sphere self-hit (SPHERE_EPS) and diverge the replay from
        # pass A entirely (observed: a t=1.6e-4 self-hit where pass A hit
        # the light). Routing EVERY spawn through one expression makes
        # replay bit-exact by construction.
        carry0 = (
            zero, zero, zero,                               # 0-2 o
            zero, zero, zero,                               # 3-5 d
            one, one, one,                                  # 6-8 T
            zero, zero, zero,                               # 9-11 A
            zero, zero, zero,                               # 12-14 L (latched)
            zero, zero, zero,                               # 15-17 lambda_o
            zero, zero, zero,                               # 18-20 lambda_d
            izero,                                          # 21 phase
            izero,                                          # 22 jtgt
            jnp.where(s0 < s_stop, np.int32(2), np.int32(0)),  # 23 alive
            izero,                                          # 24 depth
            s0,                                             # 25 sample
            pid0,                                           # 26 pid
            izero,                                          # 27 ne (textbook)
            zero, zero, zero,                               # 28-30 image sum
            zero,                                           # 31 mpdf (mis)
            zero,                                           # 32 lambda_mpdf
        )
        n_state = len(carry0)
        # Per-lane cotangent accumulators: unrolled object o at o*6 +
        # [alb rgb, emi rgb], table row i at U*6 + i*G_COLS + column.
        carry0 = carry0 + (zero,) * NPLANES

        def cond(c):
            return jnp.max(c[23]) > 0

        def body(c):
            gacc = list(c[n_state:])
            c = c[:n_state]
            (ox, oy, oz, dx, dy, dz, tr_, tg, tb, ar, ag, ab,
             lar, lag, lab, lox, loy, loz, lqx, lqy, lqz,
             ph, jtgt, alive_i, depth, s, pid, ne,
             imr, img_, imb, mpdf, lmp) = c
            alive = alive_i == 1
            pending = alive_i == 2
            depth = jnp.where(alive, depth + 1, depth)

            # ---------------- primal bounce (bit-exact replay) -----------
            h = _trace_unrolled(
                rects_k, quads_k, spheres_unrolled,
                light_ids_all if multi else light_id,
                ox, oy, oz, dx, dy, dz,
                want_shading=True, want_obj=True, sphere_tab=tab,
                want_geom=True, want_glos=has_glos,
            )
            alive_f = jnp.where(alive, np.float32(1.0), np.float32(0.0))
            if textbook:
                suppress = (ne > 0) & h["is_light"]
                emit_f = jnp.where(alive & ~suppress, np.float32(1.0),
                                   np.float32(0.0))
            elif mis_est:
                # Balance heuristic on BSDF-sampled light hits (replay of
                # the forward kernel's mis pickup).
                if multi:
                    # Per-hit-light selection density: q_k * t^2/(A_k cos)
                    # for whichever list emitter the ray struck.
                    q_h = zero + _q_l[0]
                    a_h = zero + ml[0]["area"]
                    n_h = [zero + ml[0]["n"][c] for c in range(3)]
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
                pick_gate = h["is_light"] & (mpdf > 0.0)
                emit_f = alive_f * jnp.where(pick_gate, w_b,
                                             np.float32(1.0))
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
            sr1, cr1 = vm.sincos_2pi(u1)
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

            def _pow_safe_k(base_, n_exp):
                pos_ = base_ > 0.0
                safe_ = jnp.where(pos_, base_, 1.0)
                return jnp.where(pos_, safe_**n_exp, 0.0)

            if nee_like:
                lu = uni(seed, pid, ctr + _u32c(rng.P_LIGHT_U))
                lv = uni(seed, pid, ctr + _u32c(rng.P_LIGHT_V))
                if multi:
                    # Bit-exact replay of the forward kernel's per-lane
                    # light selection: inverse-CDF draw + chained K-way
                    # select (megakernel_grad's multi block verbatim).
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
                    # SHADOW_EPS-lifted probe origin (forward kernel's NEE
                    # block — list samplers target the true light plane).
                    eps_sh = np.float32(SHADOW_EPS)
                    pox = hx + eps_sh * nx
                    poy = hy + eps_sh * ny
                    poz = hz + eps_sh * nz
                else:
                    # Single-light probe fires from the exact hit point
                    # (the forward kernel's non-multi branch).
                    pox, poy, poz = hx, hy, hz
                wx_, wy_, wz_ = lpx - pox, lpy - poy, lpz - poz
                inv_wl = jax.lax.rsqrt(wx_ * wx_ + wy_ * wy_ + wz_ * wz_)
                ldx, ldy, ldz = wx_ * inv_wl, wy_ * inv_wl, wz_ * inv_wl
                if multi:
                    probe = _trace_unrolled(
                        rects_k, quads_k, spheres_unrolled, light_ids_all,
                        pox, poy, poz, ldx, ldy, ldz,
                        want_shading=False, want_obj=True, sphere_tab=tab,
                    )
                    success = probe["hit"] & (probe["obj"] == sel_id)
                    t_probe = probe["t"]
                else:
                    t_probe, success = _probe_unrolled(
                        rects_k, quads_k, spheres_unrolled, light_id,
                        hx, hy, hz, ldx, ldy, ldz, sphere_tab=tab,
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
                    # Light-strategy balance weight at the sampled
                    # direction (forward kernel's mis block); under lists
                    # the selection probability folds into the density.
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
                if multi and (textbook or mis_est):
                    e_l_use = tuple(
                        _sel_f([_e_lights[k][c] for k in range(K_L)])
                        for c in range(3)
                    )
                else:
                    e_l_use = e_light_k
                if textbook or mis_est:
                    is_diff_tb = ~(h["is_spec"] | h["is_refr"])
                    gate = jnp.where(
                        alive & is_diff_tb & success, w_nee,
                        np.float32(0.0),
                    )
                    ar_n = ar_n + gate * tr_ * h["alb"][0] * e_l_use[0]
                    ag_n = ag_n + gate * tg * h["alb"][1] * e_l_use[1]
                    ab_n = ab_n + gate * tb * h["alb"][2] * e_l_use[2]
                    ndx, ndy, ndz = scx, scy, scz
                    wgt = one
                    take = None
                else:
                    gate = None
                    is_diff_tb = None
                    ndx = jnp.where(success, ldx, scx)
                    ndy = jnp.where(success, ldy, scy)
                    ndz = jnp.where(success, ldz, scz)
                    wgt = jnp.where(success, w_nee, 1.0)
                    take = None
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
                if multi and est in ("nee", "mixture"):
                    # Continuation-origin override mask for diffuse
                    # NEE-success lanes (used by diff_step's output origin
                    # and the transition block alike).
                    off_m = cont_off & ~(h["is_spec"] | h["is_refr"])
            else:
                success = None
                take = None
                gate = None
                is_diff_tb = None
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
                    sgn_in = jnp.where(into, np.float32(1.0),
                                       np.float32(-1.0))
                    scale = sgn_in * (ddn * nnt + sq)
                    tdx = dx * nnt - ngx * scale
                    tdy = dy * nnt - ngy * scale
                    tdz = dz * nnt - ngz * scale
                    inv_tl = jax.lax.rsqrt(
                        tdx * tdx + tdy * tdy + tdz * tdz
                    )
                    tdx, tdy, tdz = tdx * inv_tl, tdy * inv_tl, tdz * inv_tl
                    r0 = np.float32(0.04)
                    cth = np.float32(1.0) - jnp.where(
                        into, -ddn, tdx * ngx + tdy * ngy + tdz * ngz
                    )
                    re = r0 + (np.float32(1.0) - r0) * (
                        cth * cth * cth * cth * cth
                    )
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
            alive_next = alive_next & (depth < max_bounces)

            # ---------------- VJP bounce ---------------------------------
            is_vjp = (ph > 0) & (depth == jtgt) & alive
            is_vjp_f = jnp.where(is_vjp, np.float32(1.0), np.float32(0.0))
            T_ch = (tr_, tg, tb)
            A_n = (ar_n, ag_n, ab_n)
            LA = (lar, lag, lab)
            TS = []
            for chn in range(3):
                tail = LA[chn] - A_n[chn]
                fc = f_ch[chn]
                safe = fc != 0.0
                TS.append(
                    jnp.where(safe, tail, 0.0)
                    / jnp.where(safe, fc, 1.0)
                )
            # Cotangent of the continuation weight w (product chain):
            # dL/dw = sum_ch g TS c inv_p.
            sigma_w = (
                g_ct[0] * TS[0] * h["alb"][0]
                + g_ct[1] * TS[1] * h["alb"][1]
                + g_ct[2] * TS[2] * h["alb"][2]
            ) * inv_p
            sigma_w = jnp.where(is_vjp, sigma_w, 0.0)
            if textbook or mis_est:
                # Cotangent of the direct term's weight: the add was
                # gate * T * c * e_light per channel (gate carries the
                # balance factor for mis — it lives inside diff_step's
                # w_tb output, so the same sigma applies).
                gate_mask = alive & is_diff_tb & success
                sigma_tb = jnp.where(
                    is_vjp & gate_mask,
                    g_ct[0] * tr_ * h["alb"][0] * e_l_use[0]
                    + g_ct[1] * tg * h["alb"][1] * e_l_use[1]
                    + g_ct[2] * tb * h["alb"][2] * e_l_use[2],
                    0.0,
                )
            else:
                sigma_tb = zero
            if mis_est:
                # Cotangent of the pickup weight w_b (the balance factor
                # on BSDF-sampled light hits): pickup_ch = w_b*T_ch*e_ch
                # for gated lanes.
                sigma_pk = jnp.where(
                    is_vjp & alive & pick_gate,
                    g_ct[0] * tr_ * h["emi"][0]
                    + g_ct[1] * tg * h["emi"][1]
                    + g_ct[2] * tb * h["emi"][2],
                    0.0,
                )
                lmp_in = jnp.where(is_vjp, lmp, 0.0)
            else:
                sigma_pk = zero
                lmp_in = zero

            # Winner-conditioned detached data for diff_step.
            win = h["obj"]
            is_tab_w = hitm & (win >= np.int32(base))
            # Planar winner constants (chained select over the unrolled
            # objects; miss lanes keep object 0's plane — their cotangent
            # contributions are masked by hitm anyway).
            ppx = zero + plane_pts[0][0]
            ppy = zero + plane_pts[0][1]
            ppz = zero + plane_pts[0][2]
            pnx = zero + plane_ns[0][0]
            pny = zero + plane_ns[0][1]
            pnz = zero + plane_ns[0][2]
            for o in range(1, U):
                m_o = win == np.int32(o)
                ppx = jnp.where(m_o, plane_pts[o][0], ppx)
                ppy = jnp.where(m_o, plane_pts[o][1], ppy)
                ppz = jnp.where(m_o, plane_pts[o][2], ppz)
                pnx = jnp.where(m_o, plane_ns[o][0], pnx)
                pny = jnp.where(m_o, plane_ns[o][1], pny)
                pnz = jnp.where(m_o, plane_ns[o][2], pnz)
            wcx, wcy, wcz = h["wc"]
            wr = h["wr"]
            m_near = h["wnear"] > 0
            # Detached sphere-normal orientation sign (C9 flip).
            dot_g = ((hx - wcx) * dx + (hy - wcy) * dy + (hz - wcz) * dz)
            s_n = jnp.where(dot_g < 0.0, np.float32(1.0), np.float32(-1.0))
            # Detached planar normals (constants of the linearization).
            n_cx, n_cy, n_cz = nx, ny, nz
            ng_cx, ng_cy, ng_cz = (h["ngm"] if (has_spec or has_refr)
                                   else (nx, ny, nz))
            if has_spec or has_refr:
                sp_m = h["is_spec"]
            if has_refr:
                rf_m = h["is_refr"]

            def diff_step(o1, o2, o3, d1, d2, d3, c1, c2, c3, rr_, mp_):
                """The bounce's continuous map (o, d, center, radius,
                mpdf) -> (o', d', w_cont, w_tb, w_pick, pdf_cont) with
                all discrete choices closed over as detached constants.
                Evaluated at the primal point; only its VJP is used.
                mp_ (the mis balance carry) is an INPUT whose cotangent
                the state machine routes one bounce BACK (lambda_mpdf),
                where it lands on the pdf_cont output — the one
                cross-bounce dependency the (o, d) lambda pair does not
                cover."""
                # Winner t.
                dn_p = d1 * pnx + d2 * pny + d3 * pnz
                ok_p = jnp.abs(dn_p) > np.float32(1e-20)
                t_p = (
                    (ppx - o1) * pnx + (ppy - o2) * pny + (ppz - o3) * pnz
                ) / jnp.where(ok_p, dn_p, 1.0)
                op1, op2, op3 = c1 - o1, c2 - o2, c3 - o3
                bq = op1 * d1 + op2 * d2 + op3 * d3
                # Recentered / rejection-form quadratic — MUST replay
                # megakernel._table_sphere_hit's expression tree bit-for-bit
                # (pass-A/pass-B replay exactness).
                m1_ = bq * d1 - op1
                m2_ = bq * d2 - op2
                m3_ = bq * d3 - op3
                mm2 = m1_ * m1_ + m2_ * m2_ + m3_ * m3_
                mm2_pos = mm2 > 0.0
                mlen = jnp.where(
                    mm2_pos, jnp.sqrt(jnp.where(mm2_pos, mm2, 1.0)), 0.0
                )
                det = (rr_ - mlen) * (rr_ + mlen)
                det_ok = is_tab_w & (det > 0.0)
                sdet = jnp.sqrt(jnp.where(det_ok, det, 1.0))
                t_s = jnp.where(m_near, bq - sdet, bq + sdet)
                t_w = jnp.where(is_tab_w, t_s, t_p)
                x1 = jnp.where(hitm, o1 + t_w * d1, 0.0)
                x2 = jnp.where(hitm, o2 + t_w * d2, 0.0)
                x3 = jnp.where(hitm, o3 + t_w * d3, 0.0)
                # Winner normal (differentiable only for sphere winners).
                g1, g2, g3 = x1 - c1, x2 - c2, x3 - c3
                gl2 = g1 * g1 + g2 * g2 + g3 * g3
                sph_ok = is_tab_w & hitm
                invl = jax.lax.rsqrt(jnp.where(sph_ok, gl2, 1.0))
                nsx = g1 * invl * s_n
                nsy = g2 * invl * s_n
                nsz = g3 * invl * s_n
                nx_ = jnp.where(sph_ok, nsx, n_cx)
                ny_ = jnp.where(sph_ok, nsy, n_cy)
                nz_ = jnp.where(sph_ok, nsz, n_cz)
                # Scatter frame (pick detached).
                fxr = jnp.where(pick, nz_, 0.0)
                fyr = jnp.where(pick, 0.0, -nz_)
                fzr = jnp.where(pick, -nx_, ny_)
                fl2 = fxr * fxr + fyr * fyr + fzr * fzr
                inv_fl = jax.lax.rsqrt(jnp.where(fl2 > 0.0, fl2, 1.0))
                fux, fuy, fuz = fxr * inv_fl, fyr * inv_fl, fzr * inv_fl
                fvx = ny_ * fuz - nz_ * fuy
                fvy = nz_ * fux - nx_ * fuz
                fvz = nx_ * fuy - ny_ * fux
                ssx = fux * (cr1 * sin_t) + fvx * (sr1 * sin_t) + nx_ * wz
                ssy = fuy * (cr1 * sin_t) + fvy * (sr1 * sin_t) + ny_ * wz
                ssz = fuz * (cr1 * sin_t) + fvz * (sr1 * sin_t) + nz_ * wz
                sl2 = ssx * ssx + ssy * ssy + ssz * ssz
                inv_sl_ = jax.lax.rsqrt(jnp.where(sl2 > 0.0, sl2, 1.0))
                sdx, sdy, sdz = ssx * inv_sl_, ssy * inv_sl_, ssz * inv_sl_
                if has_glos:
                    # Differentiable Phong lobe: the reflected axis rides
                    # d (GLOS winners are planar, so nx_ is a detached
                    # constant there); the draws (cr1/sr1/sin_ga/cos_ga)
                    # and frame pick are detached primal closures.
                    nd_g = nx_ * d1 + ny_ * d2 + nz_ * d3
                    gm1 = d1 - nx_ * (np.float32(2.0) * nd_g)
                    gm2 = d2 - ny_ * (np.float32(2.0) * nd_g)
                    gm3 = d3 - nz_ * (np.float32(2.0) * nd_g)
                    guxr_ = jnp.where(pickg, gm3, 0.0)
                    guyr_ = jnp.where(pickg, 0.0, -gm3)
                    guzr_ = jnp.where(pickg, -gm1, gm2)
                    gul2 = guxr_ * guxr_ + guyr_ * guyr_ + guzr_ * guzr_
                    inv_gul_ = jax.lax.rsqrt(
                        jnp.where(gul2 > 0.0, gul2, 1.0)
                    )
                    gux_ = guxr_ * inv_gul_
                    guy_ = guyr_ * inv_gul_
                    guz_ = guzr_ * inv_gul_
                    gvx_ = gm2 * guz_ - gm3 * guy_
                    gvy_ = gm3 * gux_ - gm1 * guz_
                    gvz_ = gm1 * guy_ - gm2 * gux_
                    gle1r = (gux_ * (cr1 * sin_ga) + gvx_ * (sr1 * sin_ga)
                             + gm1 * cos_ga)
                    gle2r = (guy_ * (cr1 * sin_ga) + gvy_ * (sr1 * sin_ga)
                             + gm2 * cos_ga)
                    gle3r = (guz_ * (cr1 * sin_ga) + gvz_ * (sr1 * sin_ga)
                             + gm3 * cos_ga)
                    gll2 = gle1r * gle1r + gle2r * gle2r + gle3r * gle3r
                    inv_gll_ = jax.lax.rsqrt(
                        jnp.where(gll2 > 0.0, gll2, 1.0)
                    )
                    gle1 = gle1r * inv_gll_
                    gle2 = gle2r * inv_gll_
                    gle3 = gle3r * inv_gll_
                    gw_ = (
                        (gl + np.float32(2.0)) / (gl + np.float32(1.0))
                    ) * jnp.maximum(
                        gle1 * nx_ + gle2 * ny_ + gle3 * nz_, 0.0
                    )
                w_tb = zero
                if nee_like:
                    if multi:
                        # Lifted probe origin rides the DIFFERENTIABLE
                        # normal; per-lane selected light plane (detached
                        # selection, differentiable distances).
                        px1 = x1 + eps_sh * nx_
                        px2 = x2 + eps_sh * ny_
                        px3 = x3 + eps_sh * nz_
                        lc_d = (lcx, lcy, lcz)
                        ln_d, area_d = ln_use, area_use
                    else:
                        px1, px2, px3 = x1, x2, x3
                        lc_d, ln_d, area_d = lc, ln, area
                    w1_, w2_, w3_ = lpx - px1, lpy - px2, lpz - px3
                    wl2 = w1_ * w1_ + w2_ * w2_ + w3_ * w3_
                    iwl = jax.lax.rsqrt(jnp.where(wl2 > 0.0, wl2, 1.0))
                    l1, l2, l3 = w1_ * iwl, w2_ * iwl, w3_ * iwl
                    ddl = l1 * ln_d[0] + l2 * ln_d[1] + l3 * ln_d[2]
                    succ_m = success
                    ddl_s = jnp.where(
                        succ_m & (jnp.abs(ddl) > 0.0), ddl, 1.0
                    )
                    tpr = (
                        (lc_d[0] - px1) * ln_d[0]
                        + (lc_d[1] - px2) * ln_d[1]
                        + (lc_d[2] - px3) * ln_d[2]
                    ) / ddl_s
                    tpr = jnp.where(succ_m, tpr, 1.0)
                    cls = jnp.abs(ddl)
                    css = jnp.abs(l1 * nx_ + l2 * ny_ + l3 * nz_)
                    wn = (
                        jnp.abs(area_d * cls) / (tpr * tpr)
                    ) * (css * np.float32(1.0 / math.pi))
                    if multi:
                        wn = wn / q_sel
                    if has_glos:
                        w_geo_d = jnp.abs(area_d * cls) / (tpr * tpr)
                        brdf_gd = (gl + np.float32(2.0)) * np.float32(
                            1.0 / (2.0 * math.pi)
                        ) * _pow_safe_k(
                            l1 * gm1 + l2 * gm2 + l3 * gm3, gl
                        )
                        w_d_gd = w_geo_d * brdf_gd * jnp.maximum(
                            l1 * nx_ + l2 * ny_ + l3 * nz_, 0.0
                        )
                        if multi:
                            w_d_gd = w_d_gd / q_sel
                        wn = jnp.where(glm, w_d_gd, wn)
                    if mis_est:
                        p_l_d = (tpr * tpr) / (
                            area_d * jnp.maximum(cls, np.float32(1e-6))
                        )
                        if multi:
                            p_l_d = p_l_d * q_sel
                        p_b_d = jnp.maximum(
                            l1 * nx_ + l2 * ny_ + l3 * nz_, 0.0
                        ) * np.float32(1.0 / math.pi)
                        if has_glos:
                            p_b_gd = (gl + np.float32(1.0)) * np.float32(
                                1.0 / (2.0 * math.pi)
                            ) * _pow_safe_k(
                                l1 * gm1 + l2 * gm2 + l3 * gm3, gl
                            )
                            p_b_d = jnp.where(glm, p_b_gd, p_b_d)
                        wn = wn * (p_l_d / (p_l_d + p_b_d))
                    if textbook or mis_est:
                        w_tb = wn
                        e1, e2, e3 = sdx, sdy, sdz
                        w_c = one + zero
                    else:
                        e1 = jnp.where(succ_m, l1, sdx)
                        e2 = jnp.where(succ_m, l2, sdy)
                        e3 = jnp.where(succ_m, l3, sdz)
                        w_c = jnp.where(succ_m, wn, 1.0)
                    if est == "mixture":
                        e1 = jnp.where(take, e1, sdx)
                        e2 = jnp.where(take, e2, sdy)
                        e3 = jnp.where(take, e3, sdz)
                        w_c = jnp.where(take, w_c, 1.0)
                else:
                    e1, e2, e3 = sdx, sdy, sdz
                    if est == "uniform_corrected":
                        w_c = np.float32(2.0) * jnp.maximum(
                            e1 * nx_ + e2 * ny_ + e3 * nz_, 0.0
                        )
                    else:
                        w_c = one + zero
                if has_spec or has_refr:
                    # Differentiable geometric normal for sphere winners.
                    ngx_ = jnp.where(sph_ok, g1 * invl, ng_cx)
                    ngy_ = jnp.where(sph_ok, g2 * invl, ng_cy)
                    ngz_ = jnp.where(sph_ok, g3 * invl, ng_cz)
                    ndd = ngx_ * d1 + ngy_ * d2 + ngz_ * d3
                    rx = d1 - ngx_ * (np.float32(2.0) * ndd)
                    ry = d2 - ngy_ * (np.float32(2.0) * ndd)
                    rz = d3 - ngz_ * (np.float32(2.0) * ndd)
                    if has_spec:
                        e1 = jnp.where(sp_m, rx, e1)
                        e2 = jnp.where(sp_m, ry, e2)
                        e3 = jnp.where(sp_m, rz, e3)
                        w_c = jnp.where(sp_m, 1.0, w_c)
                    if has_refr:
                        nnt_ = jnp.where(into, np.float32(1.0 / 1.5),
                                         np.float32(1.5))
                        ddn_ = d1 * nx_ + d2 * ny_ + d3 * nz_
                        c2t = np.float32(1.0) - nnt_ * nnt_ * (
                            np.float32(1.0) - ddn_ * ddn_
                        )
                        c2_ok = ~tir & rf_m
                        sq_ = jnp.sqrt(jnp.where(c2_ok & (c2t > 0.0),
                                                 c2t, 1.0))
                        sq_ = jnp.where(c2_ok, sq_, 0.0)
                        sgn_ = jnp.where(into, np.float32(1.0),
                                         np.float32(-1.0))
                        scl = sgn_ * (ddn_ * nnt_ + sq_)
                        tx = d1 * nnt_ - ngx_ * scl
                        ty = d2 * nnt_ - ngy_ * scl
                        tz = d3 * nnt_ - ngz_ * scl
                        tl2 = tx * tx + ty * ty + tz * tz
                        itl = jax.lax.rsqrt(jnp.where(tl2 > 0.0, tl2, 1.0))
                        tx, ty, tz = tx * itl, ty * itl, tz * itl
                        r0_ = np.float32(0.04)
                        cth_ = np.float32(1.0) - jnp.where(
                            into, -ddn_, tx * ngx_ + ty * ngy_ + tz * ngz_
                        )
                        re_ = r0_ + (np.float32(1.0) - r0_) * (
                            cth_ * cth_ * cth_ * cth_ * cth_
                        )
                        trn_ = np.float32(1.0) - re_
                        prr_ = np.float32(0.25) + np.float32(0.5) * re_
                        wr_ = jnp.where(
                            tir, np.float32(1.0),
                            jnp.where(pick_refl, re_ / prr_,
                                      trn_ / (np.float32(1.0) - prr_)),
                        )
                        e1 = jnp.where(rf_m,
                                       jnp.where(pick_refl, rx, tx), e1)
                        e2 = jnp.where(rf_m,
                                       jnp.where(pick_refl, ry, ty), e2)
                        e3 = jnp.where(rf_m,
                                       jnp.where(pick_refl, rz, tz), e3)
                        w_c = jnp.where(rf_m, wr_, w_c)
                if has_glos:
                    # GLOS continuation override (mirrors the primal).
                    e1 = jnp.where(glm, gle1, e1)
                    e2 = jnp.where(glm, gle2, e2)
                    e3 = jnp.where(glm, gle3, e3)
                    w_c = jnp.where(glm, gw_, w_c)
                if mis_est:
                    # Pickup balance weight at THIS hit (w_b): flows via
                    # t_w and d; mp_ is its other input.
                    if multi:
                        cos_lh_d = jnp.abs(
                            d1 * n_h[0] + d2 * n_h[1] + d3 * n_h[2]
                        )
                        p_lh_d = q_h * (t_w * t_w) / (
                            a_h * jnp.maximum(cos_lh_d, np.float32(1e-6))
                        )
                    else:
                        cos_lh_d = jnp.abs(
                            d1 * ln[0] + d2 * ln[1] + d3 * ln[2]
                        )
                        p_lh_d = (t_w * t_w) / (
                            area * jnp.maximum(cos_lh_d, np.float32(1e-6))
                        )
                    w_pk = mp_ / (mp_ + p_lh_d)
                    w_pk = jnp.where(pick_gate, w_pk, 1.0)
                    # Continuation pdf the NEXT bounce's pickup uses.
                    pdfc_c = jnp.maximum(
                        e1 * nx_ + e2 * ny_ + e3 * nz_, 0.0
                    ) * np.float32(1.0 / math.pi)
                    if has_glos:
                        pdfc_c = jnp.where(
                            glm,
                            (gl + np.float32(1.0))
                            * np.float32(1.0 / (2.0 * math.pi))
                            * _pow_safe_k(
                                e1 * gm1 + e2 * gm2 + e3 * gm3, gl
                            ),
                            pdfc_c,
                        )
                    pdfc = jnp.where(is_diff_tb, pdfc_c, 0.0)
                else:
                    w_pk = one + zero
                    pdfc = zero
                if multi and est in ("nee", "mixture"):
                    # NEE-success diffuse lanes continue from the lifted
                    # probe origin (matches the primal transition's off_m
                    # override; the lift is differentiable via nx_).
                    x1 = jnp.where(off_m, px1, x1)
                    x2 = jnp.where(off_m, px2, x2)
                    x3 = jnp.where(off_m, px3, x3)
                return (x1, x2, x3, e1, e2, e3, w_c, w_tb, w_pk, pdfc)

            _, vjp_fn = jax.vjp(
                diff_step, ox, oy, oz, dx, dy, dz, wcx, wcy, wcz, wr,
                mpdf,
            )
            cot = (
                jnp.where(is_vjp, lox, 0.0),
                jnp.where(is_vjp, loy, 0.0),
                jnp.where(is_vjp, loz, 0.0),
                jnp.where(is_vjp, lqx, 0.0),
                jnp.where(is_vjp, lqy, 0.0),
                jnp.where(is_vjp, lqz, 0.0),
                sigma_w,
                sigma_tb,
                sigma_pk,
                lmp_in,
            )
            (g_o1, g_o2, g_o3, g_d1, g_d2, g_d3,
             g_c1, g_c2, g_c3, g_rr, g_mp) = vjp_fn(cot)

            # ------------- material cotangents (megakernel_grad pass B) --
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
                # Direct-term albedo pickup (gate carries the balance
                # weight for mis; per-lane selected emission under lists).
                val_alb_tot = [
                    val_alb_tot[chn]
                    + g_ct[chn] * gate * T_ch[chn] * e_l_use[chn]
                    for chn in range(3)
                ]
            val_emi = [
                g_ct[chn] * T_ch[chn] * emit_f for chn in range(3)
            ]

            # Unrolled-object materials: static masked accumulate.
            for o in range(U):
                m = jnp.where((win == np.int32(o)) & hitm, is_vjp_f,
                              np.float32(0.0))
                for chn in range(3):
                    ia = o * 6 + chn
                    gacc[ia] = gacc[ia] + m * val_alb_tot[chn]
                    gacc[ia + 3] = gacc[ia + 3] + m * val_emi[chn]
            if (textbook or mis_est) and multi:
                # Route the direct-term emission cotangent to the per-lane
                # SAMPLED light's row (gate is zero off-success, so the
                # lidx mask only picks the routing).
                for k in range(K_L):
                    mk = jnp.where(
                        lidx == np.int32(k), is_vjp_f, np.float32(0.0)
                    )
                    for chn in range(3):
                        ie_l = light_ids_all[k] * 6 + 3 + chn
                        gacc[ie_l] = gacc[ie_l] + (
                            mk * g_ct[chn] * gate * T_ch[chn]
                            * h["alb"][chn]
                        )
            elif textbook or mis_est:
                # Direct-term light-emission cotangent (light is unrolled).
                for chn in range(3):
                    ie_l = light_id * 6 + 3 + chn
                    gacc[ie_l] = gacc[ie_l] + (
                        is_vjp_f * g_ct[chn] * gate * T_ch[chn]
                        * h["alb"][chn]
                    )

            # Table-sphere rows: geometry + materials, masked per row.
            row = win - np.int32(base)
            geo_mask = jnp.where(is_vjp & is_tab_w, np.float32(1.0),
                                 np.float32(0.0))
            svals = [
                geo_mask * g_c1, geo_mask * g_c2, geo_mask * g_c3,
                geo_mask * g_rr,
                geo_mask * val_alb_tot[0], geo_mask * val_alb_tot[1],
                geo_mask * val_alb_tot[2],
                geo_mask * val_emi[0], geo_mask * val_emi[1],
                geo_mask * val_emi[2],
            ]
            for i in range(S):
                m_i = jnp.where(row == np.int32(i), np.float32(1.0),
                                np.float32(0.0))
                for k in range(G_COLS):
                    idx = U * 6 + i * G_COLS + k
                    gacc[idx] = gacc[idx] + m_i * svals[k]

            # ---------------- per-lane state machine ---------------------
            died = alive & ~alive_next
            # Pass-A completion: with the backward disabled (bk == 0 —
            # the image-only call of the two-call fit step) a finished
            # sample advances straight to the next one.
            passa_done = (ph == 0) & died
            to_backward = passa_done & do_bk
            skip_done = passa_done & ~do_bk
            # The lane's per-sample radiance joins the image SUM exactly
            # once, at pass-A death (same accumulation event either way).
            pa_f = jnp.where(passa_done, np.float32(1.0), np.float32(0.0))
            imr = imr + pa_f * ar_n
            img_ = img_ + pa_f * ag_n
            imb = imb + pa_f * ab_n
            jtgt_next = jnp.where(is_vjp, jtgt - 1, jtgt)
            vjp_more = is_vjp & (jtgt_next > 0)
            vjp_done = (is_vjp & (jtgt_next <= 0)) | skip_done
            s_next = s + jnp.where(vjp_done, np.uint32(1), np.uint32(0))
            budget = s_next < s_stop
            respawn_a = vjp_done & budget
            reborn = to_backward | vjp_more | respawn_a | pending
            pid_sel = jnp.where(respawn_a, pid_base + s_next, pid)
            # NOTE on replay exactness: all spawns (first sample AND
            # respawns AND backward-replay restarts) route through THIS
            # one call site — a spawn evaluated outside the while loop
            # can differ by an ulp (different XLA contraction/folding
            # context), which is enough to flip a sphere self-hit
            # (SPHERE_EPS) and diverge the backward replay from pass A
            # (observed; hence the pending-spawn lane state in carry0).
            o_sp, d_sp = spawn(seed, px, py, pid_sel)

            if multi and est in ("nee", "mixture"):
                # Continuation origin override for light-list NEE-success
                # diffuse lanes (lifted probe origin — forward kernel's
                # off_m block; diff_step's output origin applies the same
                # lift so the replayed adjoint chain matches).
                hx = jnp.where(off_m, pox, hx)
                hy = jnp.where(off_m, poy, hy)
                hz = jnp.where(off_m, poz, hz)
            isA = ph == 0
            cont = (isA & alive_next) | (~isA & alive & ~is_vjp)
            ox = jnp.where(reborn, o_sp[0] + zero,
                           jnp.where(cont, hx, ox))
            oy = jnp.where(reborn, o_sp[1] + zero,
                           jnp.where(cont, hy, oy))
            oz = jnp.where(reborn, o_sp[2] + zero,
                           jnp.where(cont, hz, oz))
            dx = jnp.where(reborn, d_sp[0], jnp.where(cont, ndx, dx))
            dy = jnp.where(reborn, d_sp[1], jnp.where(cont, ndy, dy))
            dz = jnp.where(reborn, d_sp[2], jnp.where(cont, ndz, dz))
            tr_ = jnp.where(reborn, 1.0, jnp.where(cont, tr_n, tr_))
            tg = jnp.where(reborn, 1.0, jnp.where(cont, tg_n, tg))
            tb = jnp.where(reborn, 1.0, jnp.where(cont, tb_n, tb))
            ar = jnp.where(reborn, 0.0, ar_n)
            ag = jnp.where(reborn, 0.0, ag_n)
            ab = jnp.where(reborn, 0.0, ab_n)
            lar = jnp.where(to_backward, ar_n, lar)
            lag = jnp.where(to_backward, ag_n, lag)
            lab = jnp.where(to_backward, ab_n, lab)
            lox = jnp.where(to_backward, 0.0,
                            jnp.where(is_vjp, g_o1, lox))
            loy = jnp.where(to_backward, 0.0,
                            jnp.where(is_vjp, g_o2, loy))
            loz = jnp.where(to_backward, 0.0,
                            jnp.where(is_vjp, g_o3, loz))
            lqx = jnp.where(to_backward, 0.0,
                            jnp.where(is_vjp, g_d1, lqx))
            lqy = jnp.where(to_backward, 0.0,
                            jnp.where(is_vjp, g_d2, lqy))
            lqz = jnp.where(to_backward, 0.0,
                            jnp.where(is_vjp, g_d3, lqz))
            ph = jnp.where(to_backward, np.int32(1),
                           jnp.where(respawn_a, np.int32(0), ph))
            jtgt = jnp.where(to_backward, depth, jtgt_next)
            depth = jnp.where(reborn, 0, depth)
            s = s_next
            pid = jnp.where(reborn, pid_sel, pid)
            alive_i = jnp.where(cont | reborn, np.int32(1), np.int32(0))
            if textbook:
                ne = jnp.where(
                    cont & is_diff_tb, np.int32(1), np.int32(0)
                )
            else:
                ne = jnp.zeros_like(ne)
            if mis_est:
                # Balance carry replay (forward kernel's mpdf block):
                # cosine pdf of the chosen continuation for surviving
                # diffuse lanes; 0 for spec/refr and reborn.
                cos_c = ndx * nx + ndy * ny + ndz * nz
                pdf_cont_p = jnp.maximum(cos_c, 0.0) * np.float32(
                    1.0 / math.pi
                )
                if has_glos:
                    pdf_cont_p = jnp.where(
                        glm,
                        (gl + np.float32(1.0))
                        * np.float32(1.0 / (2.0 * math.pi))
                        * _pow_safe_k(
                            ndx * gmx + ndy * gmy + ndz * gmz, gl
                        ),
                        pdf_cont_p,
                    )
                mpdf = jnp.where(
                    cont & is_diff_tb, pdf_cont_p, np.float32(0.0)
                )
                lmp = jnp.where(to_backward, 0.0,
                                jnp.where(is_vjp, g_mp, lmp))
            return (ox, oy, oz, dx, dy, dz, tr_, tg, tb, ar, ag, ab,
                    lar, lag, lab, lox, loy, loz, lqx, lqy, lqz,
                    ph, jtgt, alive_i, depth, s, pid, ne,
                    imr, img_, imb, mpdf, lmp, *gacc)

        out = jax.lax.while_loop(cond, body, carry0)
        ir_ref[...] = out[28]
        ig_ref[...] = out[29]
        ib_ref[...] = out[30]
        # This block's cotangent sums, one row per block: blocks run in
        # parallel, and XLA sums the rows after the launch.
        for k in range(NPLANES):
            gout_ref[0, k] = jnp.sum(out[n_state + k])

    return kernel, U, S


# ---------------------------------------------------------------------------
# Host wrappers.
# ---------------------------------------------------------------------------

_CACHE: dict = {}


def launch_geom(kernel, U: int, S: int, n_blocks: int, seed, bk, alb, emi,
                packed, lanes, g_lanes):
    """One geometry-adjoint launch over padded lanes. Returns (per-lane
    radiance (n, 3), gtab (S*TAB_STRIDE,), galb (U*3,), gemi (U*3,)): the
    per-block cotangent rows, summed by XLA and unpacked into the flat
    table layouts of _sphere_tables."""
    n = n_blocks * route.block_lanes()
    n_planes = U * 6 + S * G_COLS
    plane = jax.ShapeDtypeStruct((n,), jnp.float32)
    ir, ig, ib, rows = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[pl.BlockSpec()] * 5 + [lane_spec()] * 8,
        out_specs=[lane_spec()] * 3 + [
            pl.BlockSpec((1, n_planes), lambda i: (i, 0))
        ],
        out_shape=[plane] * 3 + [
            jax.ShapeDtypeStruct((n_blocks, n_planes), jnp.float32)
        ],
        name="spt_geometry_vjp",
        **route.pallas_call_kwargs(),
    )(jnp.asarray(seed, jnp.uint32).reshape(1),
      jnp.asarray(bk, jnp.int32).reshape(1), alb, emi, packed, *lanes,
      *g_lanes)
    tot = rows.sum(axis=0)
    u = tot[:U * 6].reshape(U, 2, 3)
    gtab = jnp.pad(tot[U * 6:].reshape(S, G_COLS),
                   ((0, 0), (0, TAB_STRIDE - G_COLS))).reshape(-1)
    return (jnp.stack([ir, ig, ib], axis=-1), gtab,
            u[:, 0].reshape(-1), u[:, 1].reshape(-1))


def geom_run(scene: Scene, cam: CameraParams, cfg: RenderConfig,
             seed, g_img=None):
    """One launch of the geometry-adjoint kernel.

    With ``g_img=None``: image-only call (the backward state machine is
    skipped via a runtime flag — pass A only, ~1 forward render of work).
    With ``g_img`` (h, w, 3): full adjoint call.

    Returns (img_sum (h, w, 3) — the radiance SUM over spp of the
    kernel's OWN paths, gtab (S*TAB_STRIDE,), galb (K*3,), gemi (K*3,)).
    The image is produced by the same program in both calls, so a fit
    step's loss and gradient see the IDENTICAL path set (CRN): compute
    the image first, derive the loss cotangent, call again with it.

    Gradient layout: gtab is the gradient of the PACKED sphere table
    (slots 0-9 per row: cx, cy, cz, r, albedo rgb, emission rgb; pad
    slots zero); galb/gemi cover the unrolled objects (flat (K*3,),
    _sphere_tables layout). Pathwise interior only; compose boundary
    terms with grad/edge.py."""
    key = (_geom_hash_structure(scene, cam), cfg, route.platform(),
           route.block_lanes(), "geom_vjp")
    fn = _CACHE.get(key)
    if fn is None:
        fn = _CACHE[key] = _build_geom_run(scene, cam, cfg)
    alb, emi, packed = _sphere_tables(scene)
    if g_img is None:
        bk = jnp.int32(0)
        g_img = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    else:
        bk = jnp.int32(1)
        g_img = jnp.asarray(g_img, jnp.float32)
    return fn(alb, emi, packed, jnp.asarray(seed, jnp.uint32), bk, g_img)


def geom_vjp(scene: Scene, cam: CameraParams, cfg: RenderConfig,
             seed, g_img):
    """Adjoint-only convenience wrapper: (gtab, galb, gemi)."""
    _, gtab, galb, gemi = geom_run(scene, cam, cfg, seed, g_img)
    return gtab, galb, gemi


def _build_geom_run(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    n_pix = cfg.width * cfg.height
    g, per, n_lanes, n_blocks = lane_layout(n_pix, cfg.spp,
                                            cfg.regen_groups)
    kernel, U, S = build_geom_grad_kernel(scene, cam, cfg)

    @jax.jit
    def run(alb, emi, packed, seed, bk, g_img):
        pix, lanes = frame_lanes(cfg, n_pix, g, per, n_blocks)
        g_lane = g_img.reshape(n_pix, 3)[pix]
        L, gtab, galb, gemi = launch_geom(
            kernel, U, S, n_blocks, seed, bk, alb, emi, packed, lanes,
            [pad_lanes(g_lane[:, c], n_blocks) for c in range(3)],
        )
        img = L[:n_lanes].reshape(n_pix, g, 3).sum(axis=1).reshape(
            cfg.height, cfg.width, 3
        )
        return img, gtab, galb, gemi

    return run


def grads_to_scene(scene: Scene, gtab, galb, gemi) -> Scene:
    """Flat kernel outputs -> a scene-shaped pytree of gradients (zeros
    for every untouched leaf). Sphere albedo/emission come from the
    packed-table rows (the kernel routes table-winner materials there);
    unrolled albedo/emission from the flat tables."""
    R = int(np.asarray(scene.rects.k).shape[0])
    Q = int(np.asarray(scene.quads.corner).shape[0])
    S = int(np.asarray(scene.spheres.radius).shape[0])
    U = R + Q
    gt = jnp.asarray(gtab).reshape(S, TAB_STRIDE)
    ga = jnp.asarray(galb).reshape(U, 3)
    ge = jnp.asarray(gemi).reshape(U, 3)
    zero = jax.tree.map(jnp.zeros_like, scene)
    return zero._replace(
        rects=zero.rects._replace(albedo=ga[:R], emission=ge[:R]),
        quads=zero.quads._replace(albedo=ga[R:], emission=ge[R:]),
        spheres=zero.spheres._replace(
            center=gt[:, 0:3],
            radius=gt[:, 3],
            albedo=gt[:, 4:7],
            emission=gt[:, 7:10],
        ),
    )


def loss_and_geom_grads(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                        seed, target,
                        edge_sphere: int | None = None,
                        edge_n_phi: int = 256):
    """One kernel-path geometry-training evaluation: MSE of the linear
    mean image vs ``target`` (h, w, 3), with pathwise interior gradients
    for every table sphere's (center, radius, albedo, emission) and
    every unrolled object's materials.

    Two launches of the SAME compiled program (image-only, then full
    adjoint) so the loss and its gradient come from the identical path
    set — the CRN property the trust-region fitter relies on.

    edge_sphere: when set, the full geometry gradient for that sphere —
    the kernel's interior term PLUS the jnp edge-sampled BOUNDARY terms
    (grad/edge.py: primary silhouette + the estimator's secondary term,
    same auto rules as geometry_loss_and_grad). The interior adjoint
    cannot see silhouette motion (it is a measure-zero discontinuity in
    the path integrand), so geometry FITS need the composition; material
    gradients have no boundary term.

    Returns (loss, scene-shaped gradient pytree)."""
    seed = jnp.uint32(seed)
    img_sum, _, _, _ = geom_run(scene, cam, cfg, seed, None)
    spp = cfg.spp
    img = img_sum / spp
    target = jnp.asarray(target, jnp.float32)
    diff = img - target
    loss = jnp.mean(diff * diff)
    g_img = diff * (2.0 / (diff.size * spp))
    _, gtab, galb, gemi = geom_run(scene, cam, cfg, seed, g_img)
    gsc = grads_to_scene(scene, gtab, galb, gemi)
    if edge_sphere is not None:
        gsc = _compose_edge_terms(scene, cam, cfg, diff, int(seed),
                                  int(edge_sphere), gsc, edge_n_phi)
    return loss, gsc


def _compose_edge_terms(scene, cam, cfg, diff, seed, si, gsc,
                        edge_n_phi=256):
    """Add the jnp edge-sampled BOUNDARY terms for sphere ``si`` onto the
    interior gradient pytree (the kernel's pathwise adjoint cannot see
    silhouette motion). Shared by the single-device and sharded fitters;
    ``diff`` is the (h, w, 3) mean-image residual."""
    from ..grad.edge import (
        edge_grad,
        indirect_edge_grad,
        shadow_edge_grad,
    )

    # edge_grad's cotangent convention is d loss / d MEAN image.
    g_mean = diff * (2.0 / diff.size)
    nb = min(int(cfg.max_bounces), 8)
    dc_e, dr_e = edge_grad(scene, cam, cfg, g_mean, si,
                           seed=seed + 1, n_phi=edge_n_phi,
                           n_bounces=nb)
    if cfg.estimator == "nee_textbook":
        dc_s, dr_s = shadow_edge_grad(scene, cam, cfg, g_mean, si,
                                      seed=seed + 1)
        dc_e = dc_e + dc_s
        dr_e = dr_e + dr_s
    elif cfg.estimator in ("cosine", "uniform", "uniform_corrected"):
        dc_i, dr_i = indirect_edge_grad(scene, cam, cfg, g_mean, si,
                                        seed=seed + 1,
                                        n_bounces=nb)
        dc_e = dc_e + dc_i
        dr_e = dr_e + dr_i
    return gsc._replace(spheres=gsc.spheres._replace(
        center=gsc.spheres.center.at[si].add(dc_e),
        radius=gsc.spheres.radius.at[si].add(dr_e),
    ))


def geom_train_step_sharded(scene: Scene, cam: CameraParams,
                            cfg: RenderConfig, mesh, target):
    """Sharded GEOMETRY-fit step: one shard_map in which every
    device (a) runs the geometry-adjoint program image-only (bk=0) on its
    (pixel-block x sample-range) lanes, (b) psums the partial image over
    the sample axis, (c) derives its local loss cotangent from its own
    pixel rows of ``target``, and (d) replays the SAME lanes with the
    backward enabled (bk=1), psum-reducing (gtab, galb, gemi) over the
    whole mesh — the multi-device form of loss_and_geom_grads, so
    whole-table geometry fits scale like the forward renderer. Both
    launches run the SAME compiled program on the SAME lane set, so the
    per-device loss and gradient keep the two-call CRN property.

    Returns step(alb, emi, packed, seed) -> (loss, img_sum (h, w, 3),
    gtab, galb, gemi); compiled once per (geometry structure, cfg,
    mesh). img_sum is the radiance SUM over spp (geom_run's convention
    — the fitter's edge-term composition needs it); the flat gradient
    outputs feed grads_to_scene exactly like the single-device wrappers.
    (Mirrors megakernel_grad.material_train_step_sharded.)"""
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

    kernel, U, S = build_geom_grad_kernel(scene, cam, cfg)
    target_flat = jnp.asarray(target, jnp.float32).reshape(n_pix, 3)
    inv_n = np.float32(2.0 / (n_pix * 3 * spp))

    def local(alb, emi, packed, seed, tgt_loc):
        pix0 = (jax.lax.axis_index(AXIS_PIXEL) * n_pix_loc).astype(
            jnp.uint32
        )
        samp0 = (
            jax.lax.axis_index(AXIS_SAMPLE) * n_s_loc
        ).astype(jnp.uint32)
        _, lanes = frame_lanes(cfg, n_pix_loc, g, per, n_blocks, pix0, samp0)
        zg = pad_lanes(jnp.zeros((n_lanes,), jnp.float32), n_blocks)
        L, _, _, _ = launch_geom(kernel, U, S, n_blocks, seed, 0, alb, emi,
                                 packed, lanes, (zg, zg, zg))
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
        _, gtab, galb, gemi = launch_geom(
            kernel, U, S, n_blocks, seed, 1, alb, emi, packed, lanes,
            [pad_lanes(g_lane[:, c], n_blocks) for c in range(3)],
        )
        gtab = jax.lax.psum(gtab, (AXIS_PIXEL, AXIS_SAMPLE))
        galb = jax.lax.psum(galb, (AXIS_PIXEL, AXIS_SAMPLE))
        gemi = jax.lax.psum(gemi, (AXIS_PIXEL, AXIS_SAMPLE))
        return loss, img_loc, gtab, galb, gemi

    sharded = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(AXIS_PIXEL)),
        out_specs=(P(), P(AXIS_PIXEL), P(), P(), P()), check_vma=False,
    )

    @jax.jit
    def step(alb, emi, packed, seed):
        loss, img_flat, gtab, galb, gemi = sharded(
            jnp.asarray(alb, jnp.float32),
            jnp.asarray(emi, jnp.float32),
            jnp.asarray(packed, jnp.float32),
            jnp.asarray(seed, jnp.uint32), target_flat,
        )
        img = img_flat.reshape(cfg.height, cfg.width, 3)
        return loss, img, gtab, galb, gemi

    return step


def fit_pallas_geom(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                    target, sphere_idx: int | None = None,
                    fields=("center", "radius"), steps: int = 10,
                    lr: float = 1.0, seed: int = 0,
                    log=None, mesh=None):
    """Chip-speed sphere-geometry inverse rendering through the adjoint
    kernel: same normalized-step trust-region descent as grad/fd.fit_fd
    (direction from the gradient, step length capped and backtracked on
    the deterministic CRN loss), but ONE adjoint launch per step instead
    of FD's 2P+1 renders — and the cost is independent of the number of
    trained parameters, so whole-table fits (sphere_idx=None) cost the
    same as single-sphere ones.

    Direction = the kernel's pathwise interior cotangent + the
    edge-sampled boundary term (loss_and_geom_grads edge_sphere) when a
    single sphere's geometry is fitted. Note the acceptance test runs on
    the fixed-seed CRN loss (essential at low spp: the target is itself
    a render, and only common random numbers cancel its noise) while the
    edge term estimates the EXPECTED boundary flow — near the CRN
    landscape's own minimum the two disagree and steps get rejected;
    that is the stall point, same identifiability ceiling as fit_fd at
    equal resolution (tests/test_fd.py docstring).

    mesh: a jax.sharding.Mesh routes every step through
    geom_train_step_sharded (one shard_map, gradients psum'd) —
    the loss stays the deterministic single-device CRN value, so the
    trust-region acceptance is unchanged; the edge composition runs on
    the assembled mean image exactly as the single-device path does.

    Returns (best scene, [losses]); losses[-1] describes the returned
    iterate."""
    import sys

    if mesh is not None:
        from .megakernel import _sphere_tables

        step_fn = geom_train_step_sharded(scene, cam, cfg, mesh, target)
        target_arr = jnp.asarray(target, jnp.float32)

    cap0_geo = float(lr)
    cap0_mat = min(float(lr), 0.1)
    cap_geo, cap_mat = cap0_geo, cap0_mat
    losses = []
    s = scene
    best_loss, best_s = float("inf"), scene
    geom_fields = {"center", "radius"} & set(fields)
    edge_si = sphere_idx if (geom_fields and sphere_idx is not None) \
        else None
    for i in range(steps):
        if mesh is None:
            loss, gsc = loss_and_geom_grads(
                s, cam, cfg, jnp.uint32(seed), target,
                edge_sphere=edge_si,
            )
        else:
            alb_t, emi_t, packed_t = _sphere_tables(s)
            loss, img_sum, gtab, galb, gemi = step_fn(
                alb_t, emi_t, packed_t, seed
            )
            gsc = grads_to_scene(s, gtab, galb, gemi)
            if edge_si is not None:
                diff = img_sum / np.float32(cfg.spp) - target_arr
                gsc = _compose_edge_terms(s, cam, cfg, diff, int(seed),
                                          int(edge_si), gsc)
        loss = float(loss)
        if loss > best_loss:
            s = best_s
            cap_geo *= 0.5
            cap_mat *= 0.5
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
        gs = gsc.spheres

        def msel(arr):
            """Mask the gradient to the trained sphere (or all)."""
            if sphere_idx is None:
                return arr
            m = jnp.zeros(arr.shape[0], bool).at[sphere_idx].set(True)
            return jnp.where(
                m.reshape((-1,) + (1,) * (arr.ndim - 1)), arr, 0.0
            )

        def step(grad, cap):
            n = float(jnp.linalg.norm(grad))
            if n < 1e-30:
                return jnp.zeros_like(grad)
            return jnp.asarray(-cap * grad / n, jnp.float32)

        if "center" in fields:
            sp = sp._replace(center=sp.center + step(msel(gs.center),
                                                     cap_geo))
        if "radius" in fields:
            sp = sp._replace(radius=jnp.maximum(
                sp.radius + step(msel(gs.radius), cap_geo), 1e-3))
        if "albedo" in fields:
            sp = sp._replace(albedo=jnp.clip(
                sp.albedo + step(msel(gs.albedo), cap_mat), 0.0, 1.0))
        if "emission" in fields:
            sp = sp._replace(emission=jnp.maximum(
                sp.emission + step(msel(gs.emission), cap_mat), 0.0))
        s = s._replace(spheres=sp)
        if log is not None:
            idx = sphere_idx if sphere_idx is not None else 0
            cc = [round(float(v), 3) for v in s.spheres.center[idx]]
            print(
                f"step {i}: loss {loss:.6f} center {cc} "
                f"radius {float(s.spheres.radius[idx]):.3f}",
                file=log or sys.stderr,
            )
    return best_s, losses
