"""Pallas megakernel: the fused regenerating path tracer.

This is the speed-of-light design for the hot loop (SURVEY.md section 7,
steps 6): one kernel fuses EVERYTHING the reference's ``radiance()``
(/root/reference/src/smallpt.cpp:419-496) does per bounce — nearest-hit over
all primitives (:323-335), oriented normals + material fetch (:118-124),
Russian roulette (:447-454), NEE light sampling (:363-369,457-479), cosine/
uniform scattering (:337-361) — plus lane regeneration (camera respawn,
contract C4/C5), so path state lives in registers across the entire
bounce loop and device memory is touched only for per-lane work
assignment (in), runtime tables (scalar loads) and the radiance
accumulator (out). On the GPU it runs on the Triton route, one lane per
thread; on the CPU, in the Pallas interpreter (ops/route.py).

Design choices (vs the jnp wavefront in integrator/wavefront.py, which
defines the semantics):

- Scene, camera, and config are BAKED into the kernel as compile-time
  constants: the scene is 17 primitives (a few hundred floats) — immediate
  operands beat any memory system. Changing the scene recompiles (~seconds);
  the differentiable/jnp path handles scene optimization.
- The object loop is UNROLLED in Python at trace time. The nearest-hit
  select carries material constants and normals along with t, so there is
  no gather at all (the jnp path gathers albedo[obj_id]).
- Per-axis rect intersection reads exactly the components it needs (the
  axis is a Python constant per object) — no (N, R) intermediate, no
  OTHER_AXES indexing.
- RNG is the same murmur3-style counter hash as core/rng.py (bit-identical
  draws), so kernel renders match the jnp wavefront per-sample.
- Lane regeneration identical to path_trace_regen: lanes bound to a pixel
  and a sample range, respawn on death, no scatter (the lane accumulator is
  a pixel partial sum).

Coverage: all primitive families (axis rects, general quads, spheres), all
materials (DIFF, SPEC mirror, REFR dielectric — C16 always-RR variant), all
estimators (nee / cosine / uniform / uniform_corrected / mixture /
nee_textbook), light modes intended / glibc_overflow (C13a).
"""

from __future__ import annotations

import math

import numpy as np

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..core import ld, rng
from ..core import vecmath as vm
from ..scene.types import Scene, SphereLight
from ..geometry.intersect import (
    MISS_T, SELF_HIT_EPS, SPHERE_EPS, SPHERE_EPS_REL,
)
from ..integrator.sampling import SHADOW_EPS
from . import route

import os as _os


def _fold_enabled() -> bool:
    """NEE continuation fold on/off (A/B knob; output is bit-identical
    either way — see build_kernel). Read per build and part of the render
    cache keys, so flipping it mid-process rebuilds rather than aliasing."""
    return _os.environ.get("SPT_NO_NEE_FOLD") != "1"


def _u32c(x: int) -> np.uint32:
    return np.uint32(x & 0xFFFFFFFF)


def _hash_u32(seed_u32, path_id, ctr):
    """murmur3_x86_32 over (path_id, ctr) — mirrors core/rng.hash_u32.

    numpy scalar uint32 multiplies wrap (as murmur requires) but emit
    overflow RuntimeWarnings at trace time; silence them."""
    np_err = np.seterr(over="ignore")
    try:
        return _hash_u32_inner(seed_u32, path_id, ctr)
    finally:
        np.seterr(**np_err)


def _hash_u32_inner(seed_u32, path_id, ctr):
    h = seed_u32
    for block in (path_id, ctr):
        k = block * _u32c(0xCC9E2D51)
        k = (k << np.uint32(15)) | (k >> np.uint32(17))
        k = k * _u32c(0x1B873593)
        h = h ^ k
        h = (h << np.uint32(13)) | (h >> np.uint32(19))
        h = h * np.uint32(5) + _u32c(0xE6546B64)
    h = h ^ np.uint32(8)
    h = h ^ (h >> np.uint32(16))
    h = h * _u32c(0x85EBCA6B)
    h = h ^ (h >> np.uint32(13))
    h = h * _u32c(0xC2B2AE35)
    h = h ^ (h >> np.uint32(16))
    return h


def _uniform(seed_u32, path_id, ctr):
    bits = _hash_u32(seed_u32, path_id, ctr)
    # bits>>8 < 2^24, so the i32 view is exact (the u32->f32 detour is kept
    # for bit-parity with core/rng.py; ROADMAP lists it for removal).
    q = (bits >> np.uint32(8)).view(jnp.int32)
    return q.astype(jnp.float32) * np.float32(1.0 / (1 << 24))


def _uniform_packed(seed_u32, path_id, ctr):
    """rng_backend="mix_packed": one hash serves counters (2k, 2k+1) via
    its low/high 16 bits (bit-parity with core/rng.uniform_mix_packed).
    Saves ~40% of RNG ALU on NEE bounces (5 draws -> 3 hashes)."""
    if isinstance(ctr, (int, np.integer)):
        bits = _hash_u32(seed_u32, path_id, np.uint32(int(ctr) >> 1))
        half = (
            (bits >> np.uint32(16)) if (int(ctr) & 1)
            else (bits & np.uint32(0xFFFF))
        )
    else:
        bits = _hash_u32(seed_u32, path_id, ctr >> np.uint32(1))
        half = jnp.where(
            (ctr & np.uint32(1)) != 0,
            bits >> np.uint32(16), bits & np.uint32(0xFFFF),
        )
    q = half.view(jnp.int32)  # values < 2^16: exact through the i32 view
    return q.astype(jnp.float32) * np.float32(1.0 / (1 << 16))


def _uniform_for(backend: str):
    if backend == "mix":
        return _uniform
    if backend == "mix_packed":
        return _uniform_packed
    raise NotImplementedError(
        f"pallas megakernel implements rng_backend 'mix' and 'mix_packed' "
        f"(got {backend!r}); use the jnp wavefront for other backends"
    )


def _scene_consts(scene: Scene):
    """Scene as nested Python float tuples (compile-time constants).

    Returns (rects, quads, spheres, light, lightlist): lightlist is None for
    single-light scenes, else a list of per-emitter dicts mirroring
    scene/types.LightList (multi-emitter NEE, kernel-side)."""
    rects = []
    r = scene.rects
    for i in range(int(np.asarray(r.k).shape[0])):
        rects.append(dict(
            axis=int(np.asarray(r.axis)[i]),
            k=float(np.asarray(r.k)[i]),
            lo=tuple(float(v) for v in np.asarray(r.lo)[i]),
            hi=tuple(float(v) for v in np.asarray(r.hi)[i]),
            albedo=tuple(float(v) for v in np.asarray(r.albedo)[i]),
            emission=tuple(float(v) for v in np.asarray(r.emission)[i]),
            refl=int(np.asarray(r.refl)[i]),
            gloss=float(np.asarray(r.gloss)[i]),
        ))
    quads = []
    q = scene.quads
    for i in range(int(np.asarray(q.corner).shape[0])):
        quads.append(dict(
            corner=tuple(float(v) for v in np.asarray(q.corner)[i]),
            edge_u=tuple(float(v) for v in np.asarray(q.edge_u)[i]),
            edge_v=tuple(float(v) for v in np.asarray(q.edge_v)[i]),
            albedo=tuple(float(v) for v in np.asarray(q.albedo)[i]),
            emission=tuple(float(v) for v in np.asarray(q.emission)[i]),
            refl=int(np.asarray(q.refl)[i]),
            gloss=float(np.asarray(q.gloss)[i]),
        ))
    spheres = []
    s = scene.spheres
    for i in range(int(np.asarray(s.radius).shape[0])):
        spheres.append(dict(
            center=tuple(float(v) for v in np.asarray(s.center)[i]),
            radius=float(np.asarray(s.radius)[i]),
            albedo=tuple(float(v) for v in np.asarray(s.albedo)[i]),
            emission=tuple(float(v) for v in np.asarray(s.emission)[i]),
            refl=int(np.asarray(s.refl)[i]),
            gloss=float(np.asarray(s.gloss)[i]),
        ))
    if isinstance(scene.light, SphereLight):
        # Spherical emitter (cone-sampled NEE — scene/types.SphereLight).
        light = dict(
            kind="sphere",
            center=tuple(float(v) for v in np.asarray(scene.light.center)),
            radius=float(np.asarray(scene.light.radius)),
            light_obj_id=int(np.asarray(scene.light.light_obj_id)),
        )
    else:
        light = dict(
            kind="rect",
            corner=tuple(float(v) for v in np.asarray(scene.light.corner)),
            edge_u=tuple(float(v) for v in np.asarray(scene.light.edge_u)),
            edge_v=tuple(float(v) for v in np.asarray(scene.light.edge_v)),
            light_obj_id=int(np.asarray(scene.light.light_obj_id)),
        )
    lightlist = None
    if scene.lights is not None:
        ll = scene.lights
        kinds = (
            np.asarray(ll.kind).reshape(-1) if ll.kind is not None
            else np.zeros(int(np.asarray(ll.obj_id).shape[0]), np.int32)
        )
        lightlist = [
            dict(
                corner=tuple(float(v) for v in np.asarray(ll.corner)[i]),
                edge_u=tuple(float(v) for v in np.asarray(ll.edge_u)[i]),
                edge_v=tuple(float(v) for v in np.asarray(ll.edge_v)[i]),
                obj_id=int(np.asarray(ll.obj_id)[i]),
                # LIGHT_RECT / LIGHT_SPHERE (sphere rows pack center in
                # corner and radius in edge_u[0] — scene/types.LightList).
                kind=int(kinds[i]),
            )
            for i in range(int(np.asarray(ll.obj_id).shape[0]))
        ]
    return rects, quads, spheres, light, lightlist


def _light_list_consts(lightlist):
    """Per-emitter kernel constants for a _scene_consts light list.

    Strict float32 throughout: the jnp path computes area/normal on-device
    from the gathered f32 edges (sampling.light_area_normal), so the baked
    constants must round the same way for bit-parity. Shared by the forward
    (build_kernel) and adjoint (megakernel_grad.build_grad_kernel) kernels."""
    ml = []
    for L in lightlist:
        eu_f = tuple(np.float32(v) for v in L["edge_u"])
        ev_f = tuple(np.float32(v) for v in L["edge_v"])
        if L.get("kind", 0) == 1:
            # LIGHT_SPHERE row: corner = center, edge_u[0] = radius.
            # Power-heuristic area = 4*pi*r^2, computed with the SAME f32
            # rounding as sampling.light_select_probs
            # (((4*pi) * r) * r); the normal is a placeholder (cone
            # sampling never uses it — kernel selects by kind).
            r_f = eu_f[0]
            ar_s = np.float32(
                np.float32(4.0 * math.pi) * r_f * r_f
            )
            ml.append(dict(
                c=tuple(np.float32(v) for v in L["corner"]),
                eu=eu_f, ev=ev_f,
                area=ar_s,
                n=(np.float32(0), np.float32(1), np.float32(0)),
                id=L["obj_id"],
                kind=1,
                radius=r_f,
            ))
            continue
        cx_ = (
            eu_f[1] * ev_f[2] - eu_f[2] * ev_f[1],
            eu_f[2] * ev_f[0] - eu_f[0] * ev_f[2],
            eu_f[0] * ev_f[1] - eu_f[1] * ev_f[0],
        )
        ar = np.sqrt(cx_[0] * cx_[0] + cx_[1] * cx_[1] + cx_[2] * cx_[2])
        ml.append(dict(
            c=tuple(np.float32(v) for v in L["corner"]),
            eu=eu_f, ev=ev_f,
            area=np.float32(ar),
            n=tuple(np.float32(v / ar) for v in cx_),
            id=L["obj_id"],
            kind=0,
            radius=np.float32(0.0),
        ))
    return ml


def _iter_hits(rects, quads, spheres, ox, oy, oz, dx, dy, dz,
               want_shading: bool):
    """Yield (obj_id, t_i, valid, n_raw, ng_raw, obj) for every primitive —
    the per-object intersection math shared by the nearest-hit scan
    (_trace_unrolled) and the any-occluder shadow probe (_probe_unrolled),
    kept in ONE place so both consume identical expression trees (the
    bit-parity contract)."""
    o = (ox, oy, oz)
    d = (dx, dy, dz)
    # One reciprocal per axis shared by every rect (bit-parity with the jnp
    # intersect_rects reciprocal-multiply).
    d_ok = tuple(c != 0.0 for c in d)
    inv = tuple(
        np.float32(1.0) / jnp.where(ok, c, 1.0) for ok, c in zip(d_ok, d)
    )

    obj_id = 0
    for r in rects:
        a = r["axis"]
        b, c = [(1, 2), (0, 2), (0, 1)][a]
        t_i = (np.float32(r["k"]) - o[a]) * inv[a]
        p0 = o[b] + t_i * d[b]
        p1 = o[c] + t_i * d[c]
        valid = (
            (p0 >= np.float32(r["lo"][0])) & (p0 <= np.float32(r["hi"][0]))
            & (p1 >= np.float32(r["lo"][1])) & (p1 <= np.float32(r["hi"][1]))
            & (t_i > np.float32(SELF_HIT_EPS)) & d_ok[a]
        )
        if want_shading:
            # Oriented normal (C9): axis unit vector flipped against d.
            sign = jnp.where(d[a] < 0.0, np.float32(1.0), np.float32(-1.0))
            n_raw = [sign if i == a else jnp.zeros_like(ox) for i in range(3)]
            ng_raw = [
                jnp.full_like(ox, 1.0) if i == a else jnp.zeros_like(ox)
                for i in range(3)
            ]
        else:
            n_raw = ng_raw = None
        yield obj_id, t_i, valid, n_raw, ng_raw, r
        obj_id += 1

    for qd in quads:
        # General parallelogram: plane hit via the (constant) normal, then
        # a 2x2 Gram solve with precomputed constants.
        qc = qd["corner"]
        eu, ev = qd["edge_u"], qd["edge_v"]
        nqx = eu[1] * ev[2] - eu[2] * ev[1]
        nqy = eu[2] * ev[0] - eu[0] * ev[2]
        nqz = eu[0] * ev[1] - eu[1] * ev[0]
        denom = dx * np.float32(nqx) + dy * np.float32(nqy) + dz * np.float32(nqz)
        ok = denom != 0.0
        denom_safe = jnp.where(ok, denom, 1.0)
        num = (
            (np.float32(qc[0]) - ox) * np.float32(nqx)
            + (np.float32(qc[1]) - oy) * np.float32(nqy)
            + (np.float32(qc[2]) - oz) * np.float32(nqz)
        )
        t_i = num / denom_safe
        px_ = ox + t_i * dx - np.float32(qc[0])
        py_ = oy + t_i * dy - np.float32(qc[1])
        pz_ = oz + t_i * dz - np.float32(qc[2])
        uu = sum(v * v for v in eu)
        vv = sum(v * v for v in ev)
        uv = sum(a * b for a, b in zip(eu, ev))
        gdet = uu * vv - uv * uv
        pu = px_ * np.float32(eu[0]) + py_ * np.float32(eu[1]) + pz_ * np.float32(eu[2])
        pv = px_ * np.float32(ev[0]) + py_ * np.float32(ev[1]) + pz_ * np.float32(ev[2])
        a_ = (pu * np.float32(vv) - pv * np.float32(uv)) * np.float32(1.0 / gdet)
        b_ = (pv * np.float32(uu) - pu * np.float32(uv)) * np.float32(1.0 / gdet)
        valid = (
            ok & (a_ >= 0.0) & (a_ <= 1.0) & (b_ >= 0.0) & (b_ <= 1.0)
            & (t_i > np.float32(SELF_HIT_EPS))
        )
        if want_shading:
            inv_nl = 1.0 / math.sqrt(nqx * nqx + nqy * nqy + nqz * nqz)
            ng_raw = [
                jnp.full_like(ox, nqx * inv_nl),
                jnp.full_like(ox, nqy * inv_nl),
                jnp.full_like(ox, nqz * inv_nl),
            ]
            dotn = (
                dx * np.float32(nqx * inv_nl)
                + dy * np.float32(nqy * inv_nl)
                + dz * np.float32(nqz * inv_nl)
            )
            sgnq = jnp.where(dotn < 0.0, np.float32(1.0), np.float32(-1.0))
            n_raw = [g * sgnq for g in ng_raw]
        else:
            n_raw = ng_raw = None
        yield obj_id, t_i, valid, n_raw, ng_raw, qd
        obj_id += 1

    for sph in spheres:
        # Recentered / rejection-form quadratic — the SAME expression tree
        # as geometry/intersect.intersect_spheres (robust for radius-1e5
        # giant spheres in f32; see that docstring).
        cx, cy, cz = (np.float32(v) for v in sph["center"])
        opx, opy, opz = cx - ox, cy - oy, cz - oz
        bq = opx * dx + opy * dy + opz * dz
        mx_ = bq * dx - opx
        my_ = bq * dy - opy
        mz_ = bq * dz - opz
        m2 = mx_ * mx_ + my_ * my_ + mz_ * mz_
        m2_pos = m2 > 0.0
        mlen = jnp.where(m2_pos, jnp.sqrt(jnp.where(m2_pos, m2, 1.0)), 0.0)
        radc = np.float32(sph["radius"])
        det = (radc - mlen) * (radc + mlen)
        det_pos = det > 0.0
        sdet = jnp.sqrt(jnp.where(det_pos, det, 1.0))
        t_near = bq - sdet
        t_far = bq + sdet
        # Radius-scaled eps floor (intersect.SPHERE_EPS_REL): compile-time
        # constant here; must mirror the jnp path's maximum() rounding.
        eps_s = np.maximum(
            np.float32(SPHERE_EPS),
            np.float32(SPHERE_EPS_REL) * radc,
        )
        t_i = jnp.where(t_near > eps_s, t_near, t_far)
        valid = det_pos & (t_i > eps_s)
        if want_shading:
            hx, hy, hz = ox + t_i * dx, oy + t_i * dy, oz + t_i * dz
            gx, gy, gz = hx - cx, hy - cy, hz - cz
            inv_len = jax.lax.rsqrt(gx * gx + gy * gy + gz * gz)
            # Orient against the ray (C9).
            dot = gx * dx + gy * dy + gz * dz
            sgn = jnp.where(dot < 0.0, inv_len, -inv_len)
            n_raw = [gx * sgn, gy * sgn, gz * sgn]
            ng_raw = [gx * inv_len, gy * inv_len, gz * inv_len]
        else:
            n_raw = ng_raw = None
        yield obj_id, t_i, valid, n_raw, ng_raw, sph
        obj_id += 1


class _FlatRows:
    """Row-indexing shim over a FLAT 1-D runtime table: ref2d[i, c] ->
    flat[i*stride + c]. The kernels read runtime tables with scalar loads
    at computed offsets, so every table ships flat."""

    def __init__(self, ref, stride: int):
        self.ref = ref
        self.stride = stride

    def __getitem__(self, key):
        i, c = key
        return self.ref[i * self.stride + c]


# Packed sphere-table row layout (flat f32, stride 16 for 64-byte row
# alignment): [cx, cy, cz, radius, alb_r, alb_g, alb_b, emi_r, emi_g,
# emi_b, refl, pad x5]. One row per sphere: the loop computes ONE base
# index (i*16) and reads everything at constant offsets.
TAB_STRIDE = 16


def _table_scan(S: int, body, carry):
    """carry = body(i, carry) for i in range(S) (the sphere-table scan)."""
    return jax.lax.fori_loop(np.int32(0), np.int32(S), body, carry)


def _table_sphere_hit(tab_ref, i, ox, oy, oz, dx, dy, dz):
    """One table sphere's (t_i, valid) — the SAME expression tree as the
    unrolled sphere branch of _iter_hits (smallpt.cpp:229-239 semantics),
    with the per-object constants read from the packed flat table at
    a traced row index. Returns the center and the row base (the caller
    reads materials from it; the winner's normal is reconstructed after
    the scan)."""
    b = i * TAB_STRIDE
    cx, cy, cz = tab_ref[b], tab_ref[b + 1], tab_ref[b + 2]
    rad = tab_ref[b + 3]
    opx, opy, opz = cx - ox, cy - oy, cz - oz
    bq = opx * dx + opy * dy + opz * dz
    # Recentered / rejection-form quadratic (matches _iter_hits and
    # geometry/intersect.intersect_spheres — robust at giant radii).
    mx_ = bq * dx - opx
    my_ = bq * dy - opy
    mz_ = bq * dz - opz
    m2 = mx_ * mx_ + my_ * my_ + mz_ * mz_
    m2_pos = m2 > 0.0
    mlen = jnp.where(m2_pos, jnp.sqrt(jnp.where(m2_pos, m2, 1.0)), 0.0)
    det = (rad - mlen) * (rad + mlen)
    det_pos = det > 0.0
    sdet = jnp.sqrt(jnp.where(det_pos, det, 1.0))
    t_near = bq - sdet
    t_far = bq + sdet
    # Radius-scaled eps floor (runtime radius => runtime maximum; see
    # geometry/intersect.SPHERE_EPS_REL).
    eps_s = jnp.maximum(
        np.float32(SPHERE_EPS), np.float32(SPHERE_EPS_REL) * rad
    )
    near = t_near > eps_s
    t_i = jnp.where(near, t_near, t_far)
    valid = det_pos & (t_i > eps_s)
    return t_i, valid, (cx, cy, cz), b, near


def _probe_unrolled(rects, quads, spheres, light_id: int,
                    ox, oy, oz, dx, dy, dz, sphere_tab=None):
    """Any-occluder shadow probe: (t_light, success).

    Bit-exact to ``h = _trace_unrolled(...); h["hit"] & h["is_light"]``
    for a single STATIC light id, by unwinding the nearest-select chain:
    the light wins the scan iff no earlier object has t <= t_light and no
    later object has t < t_light (the running-min recursion reduces to
    exactly these ordered-strictness compares). Each non-light object then
    costs one compare + one AND/OR instead of the chain's two in-register
    selects, and the winner's id/t bookkeeping disappears."""
    hits = list(_iter_hits(rects, quads, spheres, ox, oy, oz, dx, dy, dz,
                           want_shading=False))
    t_l = valid_l = None
    for obj_id, t_i, valid, _, _, _ in hits:
        if obj_id == light_id:
            t_l, valid_l = t_i, valid
    occ = None
    for obj_id, t_i, valid, _, _, _ in hits:
        if obj_id == light_id:
            continue
        closer = (t_i <= t_l) if obj_id < light_id else (t_i < t_l)
        blk = valid & closer
        occ = blk if occ is None else (occ | blk)
    success = valid_l if occ is None else (valid_l & ~occ)
    if sphere_tab is not None:
        # Looped table spheres sit AFTER every unrolled id, so they block
        # with the strict compare (t_i < t_l), exactly like an unrolled
        # sphere at the same position in the scan order.
        tab_ref, S, _ = sphere_tab

        def body(i, occ_i):
            t_i, valid, _, _, _ = _table_sphere_hit(
                tab_ref, i, ox, oy, oz, dx, dy, dz
            )
            blk = valid & (t_i < t_l)
            return occ_i | jnp.where(blk, np.int32(1), np.int32(0))

        occ_t = _table_scan(S, body, jnp.zeros_like(ox, dtype=jnp.int32))
        success = success & (occ_t == 0)
    return t_l, success


def _trace_unrolled(rects, quads, spheres, light_id, ox, oy, oz, dx, dy, dz,
                    want_shading: bool, want_obj: bool = False,
                    sphere_tab=None, want_glos: bool = False,
                    want_geom: bool = False):
    """Unrolled nearest-hit over all primitives.

    Returns dict with t, hit, is_light and (if want_shading) the winning
    object's material/normal, all selected in-register during the scan
    (C8/C9/C15 semantics; miss defaults = object 0's shading at t=MISS_T).
    want_obj adds the winning global object id as an i32 plane (stale 0 on
    miss, C15) — the adjoint kernel's scatter mask
    (ops/megakernel_grad.py).

    light_id: a single global object id, or a tuple of ids (multi-emitter
    scenes) — is_light then marks a hit on ANY listed light (the textbook
    double-count guard over a light list, integrator/wavefront.py
    _bounce_core).

    want_geom (sphere_tab shading scans only): additionally return the
    winning TABLE sphere's differentiable geometry — "wc" center (3),
    "wr" radius, "wnear" near-root choice (i32 1/0) — for the geometry
    adjoint kernel (ops/megakernel_geom.py), which re-expresses the
    winner's t/normal as functions of (center, radius) and pulls
    cotangents back through them. Values are only meaningful where the
    winner is a table sphere (obj >= base_id)."""
    light_ids = (
        (light_id,) if isinstance(light_id, (int, np.integer))
        else tuple(light_id)
    )
    d = (dx, dy, dz)

    t_best = jnp.full_like(ox, MISS_T)
    is_light = jnp.zeros_like(ox, dtype=jnp.bool_)
    obj_best = jnp.zeros_like(ox, dtype=jnp.int32) if want_obj else None
    if want_shading:
        # C15 miss defaults: stale object id 0, shaded at (0,0,0). The
        # default normal must be object 0's oriented normal (a zero normal
        # would NaN the scatter frame on escaped rays).
        o0 = rects[0] if rects else spheres[0]
        alb = [jnp.full_like(ox, o0["albedo"][c]) for c in range(3)]
        emi = [jnp.full_like(ox, o0["emission"][c]) for c in range(3)]
        if rects:
            a0 = rects[0]["axis"]
            sign0 = jnp.where(d[a0] < 0.0, np.float32(1.0), np.float32(-1.0))
            nrm = [sign0 if i == a0 else jnp.zeros_like(ox) for i in range(3)]
            ngm = [
                jnp.full_like(ox, 1.0) if i == a0 else jnp.zeros_like(ox)
                for i in range(3)
            ]
        else:
            nrm = [jnp.ones_like(ox), jnp.zeros_like(ox), jnp.zeros_like(ox)]
            ngm = [jnp.ones_like(ox), jnp.zeros_like(ox), jnp.zeros_like(ox)]
        is_spec = jnp.zeros_like(ox, dtype=jnp.bool_)
        is_refr = jnp.zeros_like(ox, dtype=jnp.bool_)
        if want_glos:
            # GLOS extension: the winner's glossy flag + Phong exponent
            # plane (C15 miss default = object 0's material, like alb/emi).
            if o0["refl"] == 3:
                is_glos = jnp.ones_like(ox, dtype=jnp.bool_)
            else:
                is_glos = jnp.zeros_like(ox, dtype=jnp.bool_)
            glos = jnp.full_like(ox, np.float32(o0.get("gloss", 0.0)))

    def consider(obj_id, t_i, valid, n_raw, ng_raw, obj):
        nonlocal t_best, is_light, alb, emi, nrm, ngm, is_spec, is_refr
        nonlocal obj_best, is_glos, glos
        win = valid & (t_i < t_best)
        t_best = jnp.where(win, t_i, t_best)
        if want_obj:
            obj_best = jnp.where(win, np.int32(obj_id), obj_best)
        # Logical update, not jnp.where-over-bools.
        if obj_id in light_ids:
            is_light = is_light | win
        else:
            is_light = is_light & ~win
        if want_shading:
            for c in range(3):
                alb[c] = jnp.where(win, obj["albedo"][c], alb[c])
                emi[c] = jnp.where(win, obj["emission"][c], emi[c])
                nrm[c] = jnp.where(win, n_raw[c], nrm[c])
                ngm[c] = jnp.where(win, ng_raw[c], ngm[c])
            is_spec = (is_spec | win) if obj["refl"] == 1 else (is_spec & ~win)
            is_refr = (is_refr | win) if obj["refl"] == 2 else (is_refr & ~win)
            if want_glos:
                if obj["refl"] == 3:
                    is_glos = is_glos | win
                    glos = jnp.where(win, np.float32(obj["gloss"]), glos)
                else:
                    is_glos = is_glos & ~win

    for obj_id, t_i, valid, n_raw, ng_raw, obj in _iter_hits(
        rects, quads, spheres, ox, oy, oz, dx, dy, dz, want_shading
    ):
        consider(obj_id, t_i, valid, n_raw, ng_raw, obj)

    if sphere_tab is not None:
        # Looped sphere table (scalable-scene mode, build_kernel
        # sphere_tab=True): geometry/materials are RUNTIME tables and
        # the scan is a fori_loop — O(1) compiled code size at any sphere
        # count, no recompile when sphere positions/radii/materials change.
        # Expression trees and scan order (table spheres after every
        # unrolled id, strict <) match unrolling the same spheres last;
        # equality is statistical, not bitwise (FMA contraction differs
        # for constants vs loop scalars — see build_kernel docstring).
        # Table spheres are never the light.
        tab_ref, S, base_id = sphere_tab
        i32z = jnp.zeros_like(ox, dtype=jnp.int32)

        def as_i32(b):
            return jnp.where(b, np.int32(1), np.int32(0))

        if want_shading:
            carry = (
                t_best, i32z,
                alb[0], alb[1], alb[2], emi[0], emi[1], emi[2],
                jnp.zeros_like(ox), jnp.zeros_like(ox), jnp.zeros_like(ox),
                as_i32(is_spec), as_i32(is_refr),
                obj_best if want_obj else i32z,
            )
            if want_geom:
                carry = carry + (jnp.ones_like(ox), i32z)  # radius, near

            def body(i, c):
                if want_geom:
                    (t_b, won, a0, a1, a2, e0, e1, e2, cbx, cby, cbz,
                     msp, mrf, ob, rb, nrb) = c
                else:
                    (t_b, won, a0, a1, a2, e0, e1, e2, cbx, cby, cbz,
                     msp, mrf, ob) = c
                t_i, valid, (cx, cy, cz), b, near_i = _table_sphere_hit(
                    tab_ref, i, ox, oy, oz, dx, dy, dz
                )
                win = valid & (t_i < t_b)
                r_i = tab_ref[b + 10]
                out = (
                    jnp.where(win, t_i, t_b),
                    jnp.where(win, np.int32(1), won),
                    jnp.where(win, tab_ref[b + 4], a0),
                    jnp.where(win, tab_ref[b + 5], a1),
                    jnp.where(win, tab_ref[b + 6], a2),
                    jnp.where(win, tab_ref[b + 7], e0),
                    jnp.where(win, tab_ref[b + 8], e1),
                    jnp.where(win, tab_ref[b + 9], e2),
                    jnp.where(win, cx, cbx),
                    jnp.where(win, cy, cby),
                    jnp.where(win, cz, cbz),
                    jnp.where(win, jnp.where(r_i == np.float32(1.0),
                                             np.int32(1), np.int32(0)), msp),
                    jnp.where(win, jnp.where(r_i == np.float32(2.0),
                                             np.int32(1), np.int32(0)), mrf),
                    jnp.where(win, (base_id + i).astype(jnp.int32), ob),
                )
                if want_geom:
                    out = out + (
                        jnp.where(win, tab_ref[b + 3], rb),
                        jnp.where(win, jnp.where(near_i, np.int32(1),
                                                 np.int32(0)), nrb),
                    )
                return out

            scanned = _table_scan(S, body, carry)
            if want_geom:
                (t_best, won_i, a0, a1, a2, e0, e1, e2, cbx, cby, cbz,
                 msp, mrf, ob, rad_b, near_b) = scanned
            else:
                (t_best, won_i, a0, a1, a2, e0, e1, e2, cbx, cby, cbz,
                 msp, mrf, ob) = scanned
            won = won_i > 0
            alb = [a0, a1, a2]
            emi = [e0, e1, e2]
            is_spec = msp > 0
            is_refr = mrf > 0
            is_light = is_light & ~won
            if want_glos:
                # Table spheres are never GLOS (build_kernel rejects that
                # combination), so a table win simply clears the flag.
                is_glos = is_glos & ~won
            if want_obj:
                obj_best = ob
            # Winner's normal, reconstructed from (t_best, center) with the
            # SAME expressions the unrolled sphere branch uses per object —
            # bit-identical for the winning sphere; merged on `won`.
            hx = ox + t_best * dx
            hy = oy + t_best * dy
            hz = oz + t_best * dz
            gx, gy, gz = hx - cbx, hy - cby, hz - cbz
            inv_len = jax.lax.rsqrt(gx * gx + gy * gy + gz * gz)
            dot = gx * dx + gy * dy + gz * dz
            sgn = jnp.where(dot < 0.0, inv_len, -inv_len)
            for c, g_c in enumerate((gx, gy, gz)):
                nrm[c] = jnp.where(won, g_c * sgn, nrm[c])
                ngm[c] = jnp.where(won, g_c * inv_len, ngm[c])
        else:
            carry = (t_best, i32z, obj_best if want_obj else i32z)

            def body(i, c):
                t_b, won, ob = c
                t_i, valid, _, _, _ = _table_sphere_hit(
                    tab_ref, i, ox, oy, oz, dx, dy, dz
                )
                win = valid & (t_i < t_b)
                return (
                    jnp.where(win, t_i, t_b),
                    jnp.where(win, np.int32(1), won),
                    jnp.where(win, (base_id + i).astype(jnp.int32), ob),
                )

            t_best, won_i, ob = _table_scan(S, body, carry)
            is_light = is_light & ~(won_i > 0)
            if want_obj:
                obj_best = ob

    out = dict(t=t_best, hit=t_best < np.float32(MISS_T), is_light=is_light)
    if want_obj:
        out["obj"] = obj_best
    if want_shading:
        out.update(alb=alb, emi=emi, nrm=nrm, ngm=ngm, is_spec=is_spec,
                   is_refr=is_refr)
        if want_glos:
            out.update(is_glos=is_glos, glos=glos)
        if want_geom:
            if sphere_tab is None:
                raise ValueError("want_geom requires sphere_tab")
            out.update(wc=(cbx, cby, cbz), wr=rad_b, wnear=near_b)
    return out


def make_spawn(cam: CameraParams, cfg: RenderConfig):
    """(spawn closure, origin consts) — primary-ray generation (C4/C5 plus
    the optional tent filter / thin lens, camera.pinhole semantics), shared
    bit-for-bit by the forward kernel and the adjoint kernel
    (ops/megakernel_grad.py replays paths by regenerating the same rays).

    spawn returns (o, d) triples: o is the compile-time origin constant
    tuple for the pinhole (cfg.aperture == 0 — call sites broadcast scalars
    for free), or per-lane lens-origin arrays for thin-lens DoF."""
    width = np.float32(cfg.width)
    height = np.float32(cfg.height)
    origin = tuple(np.float32(v) for v in np.asarray(cam.origin))
    lower_left = tuple(np.float32(v) for v in np.asarray(cam.lower_left))
    horizontal = tuple(np.float32(v) for v in np.asarray(cam.horizontal))
    vertical = tuple(np.float32(v) for v in np.asarray(cam.vertical))
    uni = ld.make_uniform_cfg(cfg, _uniform_for(cfg.rng_backend))
    tent = cfg.pixel_filter == "tent"
    aperture = np.float32(cfg.aperture)
    focus = np.float32(cfg.focus_dist)
    if cfg.aperture > 0.0:
        hn = np.asarray(cam.horizontal, np.float64)
        vn = np.asarray(cam.vertical, np.float64)
        u_hat = tuple(np.float32(v) for v in hn / np.linalg.norm(hn))
        v_hat = tuple(np.float32(v) for v in vn / np.linalg.norm(vn))

    def _tent(xi):
        # camera.pinhole.filter_jitter "tent", with the same jnp ops.
        r = np.float32(2.0) * xi
        return jnp.where(
            r < np.float32(1.0),
            jnp.sqrt(r) - np.float32(1.0),
            np.float32(1.0) - jnp.sqrt(jnp.maximum(np.float32(2.0) - r,
                                                   np.float32(0.0))),
        )

    def spawn(seed, px, py, path_id):
        ju = uni(seed, path_id, np.uint32(0), purpose=ld.CAM_U)
        jv = uni(seed, path_id, np.uint32(1), purpose=ld.CAM_V)
        if tent:
            ju = np.float32(0.5) + _tent(ju)
            jv = np.float32(0.5) + _tent(jv)
        s = (px - np.float32(0.5) + ju) / width
        t = ((height - py - np.float32(1.0)) - np.float32(0.5) + jv) / height
        dxyz = [
            lower_left[c] + s * horizontal[c] + t * vertical[c] - origin[c]
            for c in range(3)
        ]
        if cfg.aperture > 0.0:
            lu = uni(seed, path_id, np.uint32(2), purpose=ld.LENS_U)
            lv = uni(seed, path_id, np.uint32(3), purpose=ld.LENS_V)
            r = aperture * jnp.sqrt(lu)
            sin_p, cos_p = vm.sincos_2pi(lv)
            rc, rs = r * cos_p, r * sin_p
            oxyz = [
                origin[c] + u_hat[c] * rc + v_hat[c] * rs for c in range(3)
            ]
            dxyz = [
                origin[c] + dxyz[c] * focus - oxyz[c] for c in range(3)
            ]
        else:
            oxyz = origin
        inv_len = jax.lax.rsqrt(
            dxyz[0] ** 2 + dxyz[1] ** 2 + dxyz[2] ** 2
        )
        return oxyz, [v * inv_len for v in dxyz]

    return spawn, origin


def _runtime_materials(objs: list[dict], alb_ref, emi_ref, base: int):
    """Replace baked albedo/emission constants with scalar table loads —
    used by the differentiable kernels so a fit loop updates materials
    WITHOUT recompiling (geometry stays baked)."""
    out = []
    for i, o in enumerate(objs):
        o = dict(o)
        o["albedo"] = tuple(alb_ref[base + i, c] for c in range(3))
        o["emission"] = tuple(emi_ref[base + i, c] for c in range(3))
        out.append(o)
    return out


def _light_select_cdf(ml, all_objs, mode, emi_ref=None):
    """Light-list selection probabilities q_k, inverse-CDF thresholds cdf_k
    and per-light emissions — the kernel-side mirror of
    sampling.light_select_probs, computed in strict float32 so the baked
    constants bit-match the jnp path's device values.

    emi_ref=None: all values are np.float32 compile-time constants.
    emi_ref given (runtime material table, build_kernel(mat_refs=True)):
    traced scalars read from the table — selection follows fitted emissions
    like the jnp path's object_arrays(scene) does."""
    k = len(ml)

    def _emi(i):
        if emi_ref is None:
            return tuple(np.float32(v) for v in all_objs[i]["emission"])
        return tuple(emi_ref[i, c] for c in range(3))

    e_lights = [_emi(m["id"]) for m in ml]
    if mode == "uniform":
        q = [np.float32(1.0 / k)] * k
    elif mode == "power":
        w = []
        for m, e in zip(ml, e_lights):
            lum = (
                e[0] * np.float32(0.2126)
                + e[1] * np.float32(0.7152)
                + e[2] * np.float32(0.0722)
            )
            w.append(m["area"] * lum)
        total = w[0]
        for x in w[1:]:
            total = total + x
        if emi_ref is None:
            q = (
                [np.float32(x / total) for x in w] if total > 0
                else [np.float32(1.0 / k)] * k
            )
        else:
            pos = total > 0.0
            t_safe = jnp.where(pos, total, np.float32(1.0))
            q = [
                jnp.where(pos, x / t_safe, np.float32(1.0 / k)) for x in w
            ]
    else:
        raise ValueError(f"unknown light_select mode {mode!r}")
    cdf = []
    acc = np.float32(0.0)
    for x in q:
        acc = acc + x
        cdf.append(acc)
    return q, cdf, e_lights


def _cone_sample_kernel(cx, cy, cz, rad2, px_, py_, pz_, lu, lv):
    """Kernel form of sampling.sphere_cone + sample_sphere_dir — the SAME
    expression tree component-for-component (axis onb via the vm.onb_from_w
    construction, polynomial sincos, rsqrt normalize) so renders bit-match
    the jnp wavefront. Inputs may be np.float32 constants (single light)
    or per-lane planes (kind-selected list rows). Returns
    (dx, dy, dz, pdf_inv)."""
    wcx = cx - px_
    wcy = cy - py_
    wcz = cz - pz_
    sd2 = wcx * wcx + wcy * wcy + wcz * wcz
    sd2_pos = sd2 > 0.0
    sd2_safe = jnp.where(sd2_pos, sd2, 1.0)
    inv_sd = jax.lax.rsqrt(sd2_safe)
    whx = jnp.where(sd2_pos, wcx * inv_sd, np.float32(0.0))
    why = jnp.where(sd2_pos, wcy * inv_sd, np.float32(0.0))
    whz = jnp.where(sd2_pos, wcz * inv_sd, np.float32(1.0))
    ssin2 = rad2 / sd2_safe
    s_out = sd2_pos & (ssin2 < 1.0)
    cos_max = jnp.where(
        s_out,
        jnp.sqrt(jnp.where(s_out, np.float32(1.0) - ssin2, 1.0)),
        np.float32(-1.0),
    )
    pdf_inv = np.float32(2.0 * math.pi) * (np.float32(1.0) - cos_max)
    cos_tc = np.float32(1.0) - lv * (np.float32(1.0) - cos_max)
    sin_tc = jnp.sqrt(
        jnp.maximum(np.float32(1.0) - cos_tc * cos_tc, 0.0)
    )
    pickc = jnp.abs(whx) > np.float32(0.1)
    cuxr = jnp.where(pickc, whz, 0.0)
    cuyr = jnp.where(pickc, 0.0, -whz)
    cuzr = jnp.where(pickc, -whx, why)
    inv_cul = jax.lax.rsqrt(cuxr * cuxr + cuyr * cuyr + cuzr * cuzr)
    cux, cuy, cuz = cuxr * inv_cul, cuyr * inv_cul, cuzr * inv_cul
    cvx = why * cuz - whz * cuy
    cvy = whz * cux - whx * cuz
    cvz = whx * cuy - why * cux
    sr1c, cr1c = vm.sincos_2pi(lu)
    slxr = cux * (cr1c * sin_tc) + cvx * (sr1c * sin_tc) + whx * cos_tc
    slyr = cuy * (cr1c * sin_tc) + cvy * (sr1c * sin_tc) + why * cos_tc
    slzr = cuz * (cr1c * sin_tc) + cvz * (sr1c * sin_tc) + whz * cos_tc
    inv_sll = jax.lax.rsqrt(slxr * slxr + slyr * slyr + slzr * slzr)
    return slxr * inv_sll, slyr * inv_sll, slzr * inv_sll, pdf_inv


def build_kernel(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                 mat_refs: bool = False, sphere_tab: bool = False):
    """Returns the Pallas kernel body closed over scene/cam/cfg constants.

    One lane traces one path at a time; the block's lanes are 1-D arrays
    and the whole path state lives in registers as while-loop carries.
    Kernel refs, in order: seed (1,) u32; [alb, emi material tables];
    [packed sphere table]; the five lane planes (px, py, path-id base,
    s_start, s_stop); the three radiance outputs; the block's (1, 2) i32
    [extend, probe] trace counts.

    mat_refs=True: the kernel takes two extra refs (alb_ref, emi_ref —
    (K, 3) runtime material tables, global object order) after the seed
    and reads materials from them with scalar loads instead of baking
    them as immediates; the RNG/trace/shade structure is otherwise
    identical, so renders are bit-identical to the baked kernel at equal
    materials.

    sphere_tab=True (scalable-scene mode, implies mat_refs): the scene's
    spheres are NOT unrolled — the kernel takes one further ref after the
    material tables, a flat (S*TAB_STRIDE,) f32 table of packed
    per-sphere rows [cx, cy, cz, radius, albedo rgb, emission rgb, refl]
    (_sphere_tables), and scans it with a fori_loop inside every
    nearest-hit/probe. Compiled code size is O(unrolled objects)
    instead of O(total objects), and sphere geometry/material changes
    re-run WITHOUT recompiling. Scan order (all table spheres after every
    unrolled object) and expression trees match unrolling the same spheres
    last; the estimator is IDENTICAL, but renders are only statistically
    equal to the unrolled kernel: the compiler contracts the sphere
    discriminant differently for baked constants vs loop-carried scalars
    (FMA), and near-cancelling grazing hits amplify that to ~30 ulps of t
    — the same divergence class as the documented jnp-vs-kernel FMA gap
    (tests/test_megakernel.py sphere-scene tolerances). Rects, quads, and
    the light stay compile-time (the light must not be a table sphere)."""
    rects, quads, spheres, light, lightlist = _scene_consts(scene)
    # sphere_tab: spec/refr code inclusion still keys on the ACTUAL scene
    # (refl is part of the build cache key — it is not a training target),
    # but the per-sphere constants never reach the trace: the table loop
    # reads them from the table at run time.
    has_spec_all = any(o["refl"] == 1 for o in rects + quads + spheres)
    has_refr_all = any(o["refl"] == 2 for o in rects + quads + spheres)
    has_glos_all = any(o["refl"] == 3 for o in rects + quads + spheres)
    if has_glos_all:
        # GLOS (modified-Phong) extension — integrator/wavefront.py
        # check_glos_estimator defines which estimators have glossy
        # semantics.
        if cfg.estimator not in ("cosine", "nee_textbook", "mis"):
            raise ValueError(
                f"estimator {cfg.estimator!r} has no glossy (GLOS) "
                "semantics; use cosine / nee_textbook / mis"
            )
    if sphere_tab and any(o["refl"] == 3 for o in spheres):
        raise ValueError(
            "sphere_tab=True does not support GLOS table spheres (the "
            "packed row carries no exponent); keep glossy spheres in an "
            "unrolled scene or use the jnp wavefront"
        )
    S_tab = len(spheres)
    base_tab = len(rects) + len(quads)
    if sphere_tab:
        if not mat_refs:
            raise ValueError(
                "sphere_tab=True requires mat_refs=True (table-sphere "
                "materials are rows of the runtime material tables)"
            )
        if not (rects or quads):
            raise ValueError(
                "sphere_tab=True needs at least one unrolled object "
                "(the C15 miss default shades object 0)"
            )
        if int(np.asarray(scene.light.light_obj_id)) >= base_tab:
            raise ValueError(
                "sphere_tab=True requires the light to be an unrolled "
                "rect/quad, not a table sphere"
            )
        if scene.lights is not None and any(
            int(i) >= base_tab
            for i in np.asarray(scene.lights.obj_id).reshape(-1)
        ):
            raise ValueError(
                "sphere_tab=True requires every light-list emitter to be "
                "an unrolled rect/quad, not a table sphere (the table scan "
                "strips spheres from the selection CDF's object list)"
            )
        spheres = []
    has_spec = has_spec_all
    has_refr = has_refr_all
    has_glos = has_glos_all
    light_id = light["light_obj_id"]
    uni = _uniform_for(cfg.rng_backend)
    est = cfg.estimator
    textbook = est == "nee_textbook"
    mis_est = est == "mis"
    # The light object's emission (for the textbook direct term).
    all_objs = rects + quads + spheres
    e_light = tuple(
        np.float32(v) for v in all_objs[light_id]["emission"]
    ) if all_objs else (np.float32(0),) * 3
    glibc = cfg.light_sample_mode == "glibc_overflow"
    uni = ld.make_uniform_cfg(cfg, uni)

    # Multi-emitter light list (scene.lights): per-light compile-time
    # constants + a per-lane inverse-CDF selection draw in the kernel body
    # (the chained-select form of sampling.gather_light — no dynamic
    # gather). Semantics match integrator/wavefront.py
    # _select_light exactly: light k with probability q_k, NEE weight / q_k.
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
        # Mixed-kind lists (LIGHT_SPHERE rows): per-lane kind select in
        # the NEE block below mirrors integrator/wavefront._nee_sample.
        multi_sphere = any(m["kind"] == 1 for m in ml)
    else:
        multi_sphere = False

    # NEE continuation fold (the PERF.md "probe/extend factorization"
    # headroom item). For the C13 continuation estimators, a SUCCESSFUL
    # probe proves the continuation ray's nearest hit is the sampled light
    # (same origin, same direction, same pure intersection expressions as
    # the next extend trace), and a zero-albedo light kills the path
    # deterministically at that hit (p_max == 0 => RR never survives,
    # smallpt.cpp:447-454) right after picking up e_light. That whole next
    # bounce is therefore resolved analytically at the success bounce:
    # accumulate tr_n * e_light, count the extend trace the unfolded loop
    # would perform, die/respawn one iteration early. Image, per-sample
    # radiance, and both trace counters are BIT-IDENTICAL to the unfolded
    # loop (test_megakernel.py::test_nee_fold_bit_identical); only the
    # while-loop iteration count drops (~1.5x at the north-star config).
    # Requires baked materials (mat_refs carries runtime albedo, so the
    # zero-albedo proof is unavailable at trace time).
    fold = (
        est in ("nee", "mixture")
        and not mat_refs
        and bool(all_objs)
        and all(
            max(all_objs[i]["albedo"]) == 0.0
            for i in (light_ids_all if multi else (light_id,))
        )
        and _fold_enabled()
    )

    spawn, origin = make_spawn(cam, cfg)

    # Single-light cone path: scene.light is a SphereLight and no list
    # overrides it. (List scenes route per-lane kind selects instead.)
    sphere_light = light.get("kind") == "sphere" and not multi
    if light.get("kind") == "sphere":
        # Cone-sampled spherical emitter (scene/types.SphereLight;
        # integrator/sampling.sphere_cone defines the semantics — this is
        # its bit-parity kernel form). Constraints mirror the jnp path:
        if glibc:
            raise ValueError(
                "light_sample_mode='glibc_overflow' reproduces the "
                "reference's rect-sampler int32-overflow quirk (C13a) and "
                "has no sphere-light analogue; use "
                "light_sample_mode='intended' for SphereLight scenes"
            )
        if sphere_tab:
            raise ValueError(
                "sphere_tab=True cannot host a SphereLight (the emitter "
                "must be an unrolled sphere so the probe can target it); "
                "sphere-light scenes auto-disable table mode "
                "(_table_compatible)"
            )
        slc = tuple(np.float32(v) for v in light["center"])
        slr = np.float32(light["radius"])
        slr2 = np.float32(slr * slr)
        # Placeholders so the (untraced) rect code paths stay defined.
        lc = leu = lev = (np.float32(0),) * 3
        ln = (np.float32(0), np.float32(1), np.float32(0))
        area = np.float32(1.0)
        leu_hat = lev_hat = (np.float32(0),) * 3
    else:
        lc = tuple(np.float32(v) for v in light["corner"])
        leu = tuple(np.float32(v) for v in light["edge_u"])
        lev = tuple(np.float32(v) for v in light["edge_v"])
        # area & unit normal of the sample parallelogram (C13: 1296, (0,1,0)).
        cxn = (
            leu[1] * lev[2] - leu[2] * lev[1],
            leu[2] * lev[0] - leu[0] * lev[2],
            leu[0] * lev[1] - leu[1] * lev[0],
        )
        area = float(math.sqrt(cxn[0] ** 2 + cxn[1] ** 2 + cxn[2] ** 2))
        ln = tuple(np.float32(v / area) for v in cxn)
        area = np.float32(area)
        # glibc mode: unit edge dirs (offsets are absolute units, C13a).
        leu_mag = float(math.sqrt(sum(v * v for v in leu)))
        lev_mag = float(math.sqrt(sum(v * v for v in lev)))
        leu_hat = tuple(np.float32(v / leu_mag) for v in leu)
        lev_hat = tuple(np.float32(v / lev_mag) for v in lev)
    # Sphere-light C13 variant flag: fallback lanes suppress sphere
    # lights' next pickup (integrator/wavefront._diff_scatter docstring —
    # the reference's fallback-with-pickup double count blows up on wide
    # occluded cones). Uses the textbook alive_i bit-2 encoding. Active
    # for the single SphereLight AND for lists carrying sphere rows.
    nee_sphere = (sphere_light or multi_sphere) and est in ("nee", "mixture")

    spp_u32 = _u32c(cfg.spp)
    rr_depth = np.int32(cfg.rr_start_depth)
    max_bounces = np.int32(cfg.max_bounces)
    mix_q = np.float32(cfg.mixture_q)
    DPB = _u32c(rng.DRAWS_PER_BOUNCE)

    def glibc_offset(u):
        r = (u * np.float32(2147483648.0)).astype(jnp.uint32)
        wrapped = (r * np.uint32(36)).view(jnp.int32).astype(jnp.float32)
        return wrapped * np.float32(1.0 / 2147483647.0)

    def kernel(seed_ref, *refs):
        if mat_refs:
            alb_ref, emi_ref = refs[0], refs[1]
            refs = refs[2:]
            if sphere_tab:
                # Table mode ships the material tables FLAT (see _FlatRows).
                alb_ref = _FlatRows(alb_ref, 3)
                emi_ref = _FlatRows(emi_ref, 3)
            R, Q = len(rects), len(quads)
            rects_k = _runtime_materials(rects, alb_ref, emi_ref, 0)
            quads_k = _runtime_materials(quads, alb_ref, emi_ref, R)
            spheres_k = _runtime_materials(spheres, alb_ref, emi_ref, R + Q)
            e_light_k = tuple(emi_ref[light_id, c] for c in range(3))
        else:
            rects_k, quads_k, spheres_k = rects, quads, spheres
            e_light_k = e_light
        if sphere_tab:
            # Packed per-sphere rows (TAB_STRIDE f32 each) — geometry AND
            # materials; the scan never touches the (K*3) material tables.
            tab = (refs[0], S_tab, base_tab)
            refs = refs[1:]
        else:
            tab = None
        if multi:
            _q_l, _cdf_l, _e_lights = _light_select_cdf(
                ml, all_objs, cfg.light_select,
                emi_ref if mat_refs else None,
            )
        (px_ref, py_ref, pid_ref, sstart_ref, sstop_ref,
         lr_ref, lg_ref, lb_ref, traces_ref) = refs
        seed = seed_ref[0]
        px = px_ref[...]
        py = py_ref[...]
        pid_base = pid_ref[...]
        s_stop = sstop_ref[...]
        s0 = sstart_ref[...]

        pid0 = pid_base + s0
        o0, d0 = spawn(seed, px, py, pid0)
        zero = jnp.zeros_like(px)
        one = jnp.ones_like(px)
        izero = jnp.zeros_like(px, dtype=jnp.int32)

        carry0 = (
            # o0 entries are scalars (pinhole) or per-lane arrays (lens).
            o0[0] + zero, o0[1] + zero, o0[2] + zero,
            d0[0], d0[1], d0[2],
            one, one, one,              # throughput
            zero, zero, zero,           # L accumulator
            # alive as i32 0/1 (bit 1 = the textbook/sphere-light
            # suppress-next-pickup flag, see below).
            jnp.where(s0 < s_stop, np.int32(1), np.int32(0)),
            izero,                      # depth
            s0,                         # sample idx
            pid0,                       # path id
            izero,                      # extend traces of this lane
            izero,                      # probe traces of this lane
        )
        if mis_est:
            # estimator="mis": + the balance-heuristic pdf carry (the
            # previous diffuse vertex's cos/pi of this ray's direction).
            carry0 = carry0 + (jnp.zeros_like(px),)

        def cond(c):
            return jnp.max(c[12]) > 0

        def body(c):
            if mis_est:
                (ox, oy, oz, dx, dy, dz, tr_, tg, tb, Lr, Lg, Lb, alive_i,
                 depth, s, pid, nex, npr, mpdf) = c
            else:
                (ox, oy, oz, dx, dy, dz, tr_, tg, tb, Lr, Lg, Lb, alive_i,
                 depth, s, pid, nex, npr) = c
                mpdf = None
            alive = alive_i > 0
            depth = jnp.where(alive, depth + 1, depth)

            h = _trace_unrolled(
                rects_k, quads_k, spheres_k,
                light_ids_all if multi else light_id,
                ox, oy, oz, dx, dy, dz,
                want_shading=True, sphere_tab=tab,
                want_obj=((mis_est or nee_sphere) and multi),
                want_glos=has_glos,
            )
            alive_f = jnp.where(alive, np.float32(1.0), np.float32(0.0))
            # Emission pickup (C10/C13/C14). nee_textbook lanes whose
            # previous bounce shadow-sampled the light carry the no_emit
            # bit (alive_i == 3) and skip this pickup (double-count guard).
            if textbook or nee_sphere:
                # Suppress only the SAMPLED light's emission (h.is_light
                # marks lanes whose nearest hit is the light object).
                # nee_sphere: the sphere-light C13 variant's fallback
                # lanes carry the same bit (set at the bottom of the body);
                # on mixed lists only SPHERE-kind rows are suppressed
                # (rect rows keep C13 fallback-with-pickup parity —
                # mirrors _bounce_core's is_slight_hit).
                if nee_sphere and multi:
                    is_sl_h = jnp.zeros_like(alive)
                    for m in ml:
                        if m["kind"] == 1:
                            is_sl_h = is_sl_h | (
                                h["obj"] == np.int32(m["id"])
                            )
                    is_sl_h = is_sl_h & h["hit"]
                else:
                    is_sl_h = h["is_light"]
                suppress = (alive_i > np.int32(1)) & is_sl_h
                emit_f = jnp.where(
                    alive & ~suppress, np.float32(1.0), np.float32(0.0)
                )
            elif mis_est:
                # Balance heuristic on BSDF-sampled light hits (mirrors
                # _bounce_core's mis pickup): p_light = q * t^2/(A |cos_l|)
                # at the CURRENT hit, w_bsdf = mpdf/(mpdf + p_light); full
                # pickup when the previous vertex did not light-sample
                # (mpdf == 0: primary, specular, or respawned lane). Light
                # lists: (q, A, n) of the HIT light by chained id select.
                if multi:
                    q_h = _q_l[0]
                    a_h = ml[0]["area"]
                    n_h = list(ml[0]["n"])
                    for k in range(1, K_L):
                        is_k = h["obj"] == np.int32(ml[k]["id"])
                        q_h = jnp.where(is_k, _q_l[k], q_h)
                        a_h = jnp.where(is_k, ml[k]["area"], a_h)
                        for c in range(3):
                            n_h[c] = jnp.where(is_k, ml[k]["n"][c], n_h[c])
                    cos_lh = jnp.abs(
                        dx * n_h[0] + dy * n_h[1] + dz * n_h[2]
                    )
                    p_l_h = q_h * (h["t"] * h["t"]) / (
                        a_h * jnp.maximum(cos_lh, np.float32(1e-6))
                    )
                    if multi_sphere:
                        # Matched-light center/radius/kind chain, then the
                        # cone density from this ray's ORIGIN — mirrors
                        # _bounce_core's kind-select pickup exactly.
                        chx = jnp.full_like(ox, ml[0]["c"][0])
                        chy = jnp.full_like(ox, ml[0]["c"][1])
                        chz = jnp.full_like(ox, ml[0]["c"][2])
                        rh = jnp.full_like(ox, ml[0]["radius"])
                        kh = jnp.full_like(
                            alive_i, np.int32(ml[0]["kind"])
                        )
                        for k in range(1, K_L):
                            is_k = h["obj"] == np.int32(ml[k]["id"])
                            chx = jnp.where(is_k, ml[k]["c"][0], chx)
                            chy = jnp.where(is_k, ml[k]["c"][1], chy)
                            chz = jnp.where(is_k, ml[k]["c"][2], chz)
                            rh = jnp.where(is_k, ml[k]["radius"], rh)
                            kh = jnp.where(
                                is_k, np.int32(ml[k]["kind"]), kh
                            )
                        hwx = chx - ox
                        hwy = chy - oy
                        hwz = chz - oz
                        hd2 = hwx * hwx + hwy * hwy + hwz * hwz
                        hd2_pos = hd2 > 0.0
                        hd2_safe = jnp.where(hd2_pos, hd2, 1.0)
                        hsin2 = (rh * rh) / hd2_safe
                        h_out = hd2_pos & (hsin2 < 1.0)
                        hcos_max = jnp.where(
                            h_out,
                            jnp.sqrt(jnp.where(
                                h_out, np.float32(1.0) - hsin2, 1.0
                            )),
                            np.float32(-1.0),
                        )
                        h_pdf_inv = np.float32(2.0 * math.pi) * (
                            np.float32(1.0) - hcos_max
                        )
                        p_l_h = jnp.where(
                            kh == np.int32(1),
                            q_h / jnp.maximum(
                                h_pdf_inv, np.float32(1e-12)
                            ),
                            p_l_h,
                        )
                elif sphere_light:
                    # Cone density from this ray's ORIGIN (the previous
                    # vertex) — mirrors _bounce_core's sphere pickup:
                    # p = 1 / (2 pi (1 - cos_max(o))).
                    pwx = slc[0] - ox
                    pwy = slc[1] - oy
                    pwz = slc[2] - oz
                    pd2 = pwx * pwx + pwy * pwy + pwz * pwz
                    pd2_pos = pd2 > 0.0
                    pd2_safe = jnp.where(pd2_pos, pd2, 1.0)
                    psin2 = slr2 / pd2_safe
                    p_out = pd2_pos & (psin2 < 1.0)
                    pcos_max = jnp.where(
                        p_out,
                        jnp.sqrt(
                            jnp.where(p_out, np.float32(1.0) - psin2, 1.0)
                        ),
                        np.float32(-1.0),
                    )
                    p_pdf_inv = np.float32(2.0 * math.pi) * (
                        np.float32(1.0) - pcos_max
                    )
                    p_l_h = np.float32(1.0) / jnp.maximum(
                        p_pdf_inv, np.float32(1e-12)
                    )
                else:
                    cos_lh = jnp.abs(dx * ln[0] + dy * ln[1] + dz * ln[2])
                    p_l_h = (h["t"] * h["t"]) / (
                        area * jnp.maximum(cos_lh, np.float32(1e-6))
                    )
                w_b = mpdf / (mpdf + p_l_h)
                emit_f = alive_f * jnp.where(
                    h["is_light"] & (mpdf > 0.0), w_b, np.float32(1.0)
                )
            else:
                emit_f = alive_f
            Lr = Lr + emit_f * tr_ * h["emi"][0]
            Lg = Lg + emit_f * tg * h["emi"][1]
            Lb = Lb + emit_f * tb * h["emi"][2]

            # Hit point; (0,0,0) on miss (C15).
            hitm = h["hit"]
            hx = jnp.where(hitm, ox + h["t"] * dx, 0.0)
            hy = jnp.where(hitm, oy + h["t"] * dy, 0.0)
            hz = jnp.where(hitm, oz + h["t"] * dz, 0.0)
            nx, ny, nz = h["nrm"]

            ctr = depth.astype(jnp.uint32) * DPB
            u_rr = uni(seed, pid, ctr + _u32c(rng.P_RR))

            # Russian roulette (C10).
            p_max = jnp.maximum(h["alb"][0], jnp.maximum(h["alb"][1], h["alb"][2]))
            rr_active = (depth > rr_depth) | (p_max <= 0.0)
            survive = ~rr_active | (u_rr < p_max)
            inv_p = jnp.where(
                rr_active & (p_max > 0.0),
                np.float32(1.0) / jnp.where(p_max > 0.0, p_max, 1.0),
                1.0,
            )
            alive_next = alive & survive

            # Cosine-weighted scatter frame (C11): w = nl, u/v per onb_from_w.
            u1 = uni(seed, pid, ctr + _u32c(rng.P_SCATTER_U),
                     purpose=rng.P_SCATTER_U)
            u2 = uni(seed, pid, ctr + _u32c(rng.P_SCATTER_V),
                     purpose=rng.P_SCATTER_V)
            pick = jnp.abs(nx) > np.float32(0.1)
            # a = pick ? (0,1,0) : (1,0,0); u = normalize(cross(a, w)):
            # cross((0,1,0), w) = (wz, 0, -wx); cross((1,0,0), w) = (0, -wz, wy).
            uxr = jnp.where(pick, nz, 0.0)
            uyr = jnp.where(pick, 0.0, -nz)
            uzr = jnp.where(pick, -nx, ny)
            inv_ul = jax.lax.rsqrt(uxr * uxr + uyr * uyr + uzr * uzr)
            ux, uy, uz = uxr * inv_ul, uyr * inv_ul, uzr * inv_ul
            vx = ny * uz - nz * uy
            vy = nz * ux - nx * uz
            vz = nx * uy - ny * ux
            # Polynomial sincos (vm.sincos_2pi — shared with every jnp
            # path so the schedules stay bit-identical).
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
                # GLOS modified-Phong lobe around the ORIENTED-normal
                # mirror (integrator/wavefront._glos_scatter +
                # sampling.sample_phong define the semantics; same u1/u2
                # draws as the cosine sample, same onb/normalize
                # expression trees for bit-parity).
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
                gux, guy, guz = guxr * inv_gul, guyr * inv_gul, guzr * inv_gul
                gvx = gmy * guz - gmz * guy
                gvy = gmz * gux - gmx * guz
                gvz = gmx * guy - gmy * gux
                glxr = gux * (cr1 * sin_ga) + gvx * (sr1 * sin_ga) + gmx * cos_ga
                glyr = guy * (cr1 * sin_ga) + gvy * (sr1 * sin_ga) + gmy * cos_ga
                glzr = guz * (cr1 * sin_ga) + gvz * (sr1 * sin_ga) + gmz * cos_ga
                inv_gll = jax.lax.rsqrt(
                    glxr * glxr + glyr * glyr + glzr * glzr
                )
                glx, gly, glz = glxr * inv_gll, glyr * inv_gll, glzr * inv_gll
                # Path weight (n+2)/(n+1) * max(d . nl, 0)
                # (sampling.phong_weight); 0 = below-horizon absorption.
                gw = ((gl + np.float32(2.0)) / (gl + np.float32(1.0))) * (
                    jnp.maximum(glx * nx + gly * ny + glz * nz, 0.0)
                )

                def _pow_safe_k(base, n_exp):
                    # sampling._pow_safe: AD/NaN-safe max(base,0)^n.
                    pos = base > 0.0
                    safe = jnp.where(pos, base, 1.0)
                    return jnp.where(pos, safe**n_exp, 0.0)

            if est in ("nee", "mixture", "nee_textbook", "mis"):
                # Light-plane sample + visibility probe. nee/mixture: C13
                # continuation semantics; nee_textbook/mis: unbiased
                # shadow-ray direct term (integrator/wavefront._bounce_core;
                # mis weights both strategies by the balance heuristic).
                lu = uni(seed, pid, ctr + _u32c(rng.P_LIGHT_U),
                         purpose=rng.P_LIGHT_U)
                lv = uni(seed, pid, ctr + _u32c(rng.P_LIGHT_V),
                         purpose=rng.P_LIGHT_V)
                if multi:
                    # Per-lane light selection (inverse CDF over q_k,
                    # sampling.sample_light_index) then a chained K-way
                    # select of that light's constants — the in-register
                    # form of sampling.gather_light.
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
                    if multi_sphere:
                        # Mixed-kind list: per-lane sphere mask + radius
                        # (sphere rows pack center in corner and radius
                        # in edge_u[0] — so lcx/lcy/lcz and leux already
                        # carry the cone parameters through the same
                        # selects; mirrors _nee_sample's kind handling).
                        is_sph_l = jnp.zeros_like(alive)
                        for k in range(K_L):
                            if ml[k]["kind"] == 1:
                                is_sph_l = is_sph_l | (
                                    lidx == np.int32(k)
                                )
                        rad_l = _sel_f([m["radius"] for m in ml])
                elif sphere_light:
                    # Cone sample toward the sphere light
                    # (_cone_sample_kernel = the bit-parity form of
                    # sampling.sphere_cone + sample_sphere_dir).
                    ln_use, area_use = ln, area  # unused placeholders
                    sldx, sldy, sldz, pdf_inv_sl = _cone_sample_kernel(
                        slc[0], slc[1], slc[2], slr2, hx, hy, hz, lu, lv
                    )
                    lpx = lpy = lpz = None  # direction computed directly
                else:
                    # nee_textbook ALWAYS samples the full light uniformly
                    # (its nee_weight assumes the uniform-over-area pdf, and
                    # the jnp path's textbook shadow ray uses
                    # sample_light_point unconditionally — integrator/
                    # wavefront.py _bounce_core); the glibc_overflow
                    # corner-patch mode (C13a) only applies to the
                    # reference-parity continuation estimators.
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
                    # Light-list probes fire from a SHADOW_EPS-lifted
                    # origin (integrator/sampling.SHADOW_EPS: list samplers
                    # target the true light plane, so near-coplanar origins
                    # otherwise falsely self-occlude on f32 rounding); the
                    # single-light path keeps the reference's exact probe
                    # geometry. Mirrors _diff_scatter exactly.
                    eps_sh = np.float32(SHADOW_EPS)
                    pox = hx + eps_sh * nx
                    poy = hy + eps_sh * ny
                    poz = hz + eps_sh * nz
                else:
                    pox, poy, poz = hx, hy, hz
                if sphere_light:
                    ldx, ldy, ldz = sldx, sldy, sldz
                else:
                    wx_, wy_, wz_ = lpx - pox, lpy - poy, lpz - poz
                    inv_wl = jax.lax.rsqrt(wx_ * wx_ + wy_ * wy_ + wz_ * wz_)
                    ldx, ldy, ldz = wx_ * inv_wl, wy_ * inv_wl, wz_ * inv_wl
                    if multi and multi_sphere:
                        csx, csy, csz, pdf_inv_ml = _cone_sample_kernel(
                            lcx, lcy, lcz, rad_l * rad_l,
                            pox, poy, poz, lu, lv,
                        )
                        ldx = jnp.where(is_sph_l, csx, ldx)
                        ldy = jnp.where(is_sph_l, csy, ldy)
                        ldz = jnp.where(is_sph_l, csz, ldz)
                if multi:
                    # Success = the probe's nearest hit IS the lane's
                    # sampled light (per-lane id compare; is_light can't
                    # express per-lane targets, and the any-occluder
                    # probe's ordered-strictness compares would need a
                    # per-lane select — keep the nearest-hit chain).
                    probe = _trace_unrolled(
                        rects_k, quads_k, spheres_k, light_ids_all,
                        pox, poy, poz, ldx, ldy, ldz,
                        want_shading=False, want_obj=True, sphere_tab=tab,
                    )
                    success = probe["hit"] & (probe["obj"] == sel_id)
                    t_probe = probe["t"]
                else:
                    # Single static light: any-occluder probe (bit-exact
                    # to the chain, fewer in-register selects).
                    t_probe, success = _probe_unrolled(
                        rects_k, quads_k, spheres_k, light_id,
                        pox, poy, poz, ldx, ldy, ldz, sphere_tab=tab,
                    )
                if sphere_light:
                    # Front-side gate (integrator/wavefront._nee_sample:
                    # the cone can aim behind a tangent surface and the
                    # probe escapes through open space).
                    success = success & (
                        (ldx * nx + ldy * ny + ldz * nz) > 0.0
                    )
                elif multi and multi_sphere:
                    success = success & (
                        ~is_sph_l
                        | ((ldx * nx + ldy * ny + ldz * nz) > 0.0)
                    )
                t_safe = jnp.where(success, t_probe, 1.0)
                if sphere_light:
                    # sampling.sphere_nee_weight: pdf_inv * |d.nl| / pi.
                    w_nee = pdf_inv_sl * jnp.abs(
                        ldx * nx + ldy * ny + ldz * nz
                    ) * np.float32(1.0 / math.pi)
                else:
                    cos_l = jnp.abs(
                        ldx * ln_use[0] + ldy * ln_use[1] + ldz * ln_use[2]
                    )
                    cos_s = jnp.abs(ldx * nx + ldy * ny + ldz * nz)
                    w_nee = (
                        jnp.abs(area_use * cos_l) / (t_safe * t_safe)
                    ) * (cos_s * np.float32(1.0 / math.pi))
                    if multi and multi_sphere:
                        w_sph_ml = pdf_inv_ml * jnp.abs(
                            ldx * nx + ldy * ny + ldz * nz
                        ) * np.float32(1.0 / math.pi)
                        w_nee = jnp.where(is_sph_l, w_sph_ml, w_nee)
                if multi:
                    # Unbiased for the SUM over the list: importance weight
                    # 1/q_k (integrator/wavefront._diff_scatter).
                    w_nee = w_nee / q_sel
                if has_glos:
                    # GLOS lanes swap the diffuse |cos|/pi factor for the
                    # Phong lobe at the shadow-ray direction (mirrors
                    # _bounce_core's w_d_glos select exactly).
                    if sphere_light:
                        w_geo_k = pdf_inv_sl
                    else:
                        w_geo_k = jnp.abs(area_use * cos_l) / (t_safe * t_safe)
                        if multi and multi_sphere:
                            w_geo_k = jnp.where(
                                is_sph_l, pdf_inv_ml, w_geo_k
                            )
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
                    # w_light = p_light/(p_light + p_bsdf) at the SAMPLED
                    # direction (complement of the pickup's w_bsdf);
                    # light lists fold in the selection probability q_k.
                    # Sphere light: p = 1/pdf_inv (the cone density —
                    # mirrors _bounce_core's sphere_single branch).
                    if sphere_light:
                        p_l_s = np.float32(1.0) / jnp.maximum(
                            pdf_inv_sl, np.float32(1e-12)
                        )
                    else:
                        p_l_s = (t_safe * t_safe) / (
                            area_use * jnp.maximum(cos_l, np.float32(1e-6))
                        )
                        if multi and multi_sphere:
                            p_l_s = jnp.where(
                                is_sph_l,
                                np.float32(1.0) / jnp.maximum(
                                    pdf_inv_ml, np.float32(1e-12)
                                ),
                                p_l_s,
                            )
                    if multi:
                        p_l_s = p_l_s * q_sel
                    dot_sn = ldx * nx + ldy * ny + ldz * nz
                    p_b_s = jnp.maximum(dot_sn, 0.0) * np.float32(
                        1.0 / math.pi
                    )
                    if has_glos:
                        # GLOS: the competing continuation density is the
                        # Phong-lobe pdf (sampling.phong_pdf).
                        p_b_g = (gl + np.float32(1.0)) * np.float32(
                            1.0 / (2.0 * math.pi)
                        ) * _pow_safe_k(
                            ldx * gmx + ldy * gmy + ldz * gmz, gl
                        )
                        p_b_s = jnp.where(glm, p_b_g, p_b_s)
                    w_nee = w_nee * (p_l_s / (p_l_s + p_b_s))
                if textbook or mis_est:
                    # Direct term with the PRE-update throughput; cosine
                    # continuation; one shadow ray per live diffuse lane
                    # (matches _bounce_core exactly). Multi-emitter: the
                    # SAMPLED light's emission (chained select over the
                    # list, like e_light = emission_all[light_obj_id]).
                    if multi:
                        e_l_use = tuple(
                            _sel_f([_e_lights[k][c] for k in range(K_L)])
                            for c in range(3)
                        )
                    else:
                        e_l_use = e_light_k
                    is_diff = ~(h["is_spec"] | h["is_refr"])
                    gate = jnp.where(
                        alive & is_diff & success, w_nee, np.float32(0.0)
                    )
                    Lr = Lr + gate * tr_ * h["alb"][0] * e_l_use[0]
                    Lg = Lg + gate * tg * h["alb"][1] * e_l_use[1]
                    Lb = Lb + gate * tb * h["alb"][2] * e_l_use[2]
                    ndx, ndy, ndz = scx, scy, scz
                    wgt = one
                    probes = jnp.where(
                        alive & is_diff, np.float32(1.0), np.float32(0.0)
                    )
                else:
                    ndx = jnp.where(success, ldx, scx)
                    ndy = jnp.where(success, ldy, scy)
                    ndz = jnp.where(success, ldz, scz)
                    wgt = jnp.where(success, w_nee, 1.0)
                    probes = one
                    if multi:
                        # NEE-success lanes continue from the lifted probe
                        # origin so the emission pickup retraces the probe
                        # (_diff_scatter's nee_o). Spec/refr lanes are
                        # excluded below (their scatter overrides this).
                        cont_off = success
                if est == "mixture":
                    um = uni(seed, pid, ctr + _u32c(rng.P_MIX_COIN))
                    take = um < mix_q
                    ndx = jnp.where(take, ndx, scx)
                    ndy = jnp.where(take, ndy, scy)
                    ndz = jnp.where(take, ndz, scz)
                    wgt = jnp.where(take, wgt, 1.0)
                    probes = jnp.where(take, np.float32(1.0), np.float32(0.0))
                    if multi:
                        cont_off = cont_off & take
            else:
                if est == "uniform_corrected":
                    ndx, ndy, ndz = scx, scy, scz
                    wgt = np.float32(2.0) * jnp.maximum(
                        ndx * nx + ndy * ny + ndz * nz, 0.0
                    )
                else:
                    ndx, ndy, ndz = scx, scy, scz
                    wgt = one
                probes = zero

            if has_spec or has_refr:
                # SPEC mirror + REFR dielectric (C16, always-RR variant of
                # the commented smallpt branches — integrator/wavefront.py
                # _spec_scatter/_refr_scatter define the semantics).
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
                    probes = probes * jnp.where(sp, np.float32(0.0), np.float32(1.0))
                if has_refr:
                    rf = h["is_refr"]
                    into = (ngx * nx + ngy * ny + ngz * nz) > 0.0
                    nnt = jnp.where(into, np.float32(1.0 / 1.5), np.float32(1.5))
                    ddn = dx * nx + dy * ny + dz * nz
                    cos2t = np.float32(1.0) - nnt * nnt * (np.float32(1.0) - ddn * ddn)
                    tir = cos2t < 0.0
                    sq = jnp.sqrt(jnp.where(cos2t > 0.0, cos2t, 1.0)) * jnp.where(
                        cos2t > 0.0, np.float32(1.0), np.float32(0.0)
                    )
                    sgn_in = jnp.where(into, np.float32(1.0), np.float32(-1.0))
                    scale = sgn_in * (ddn * nnt + sq)
                    tdx = dx * nnt - ngx * scale
                    tdy = dy * nnt - ngy * scale
                    tdz = dz * nnt - ngz * scale
                    inv_tl = jax.lax.rsqrt(tdx * tdx + tdy * tdy + tdz * tdz)
                    tdx, tdy, tdz = tdx * inv_tl, tdy * inv_tl, tdz * inv_tl
                    r0 = np.float32(0.04)  # ((1.5-1)/(1.5+1))^2
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
                        jnp.where(pick_refl, re / prr, trn / (np.float32(1.0) - prr)),
                    )
                    ndx = jnp.where(rf, jnp.where(pick_refl, rfx, tdx), ndx)
                    ndy = jnp.where(rf, jnp.where(pick_refl, rfy, tdy), ndy)
                    ndz = jnp.where(rf, jnp.where(pick_refl, rfz, tdz), ndz)
                    wgt = jnp.where(rf, w_refr, wgt)
                    probes = probes * jnp.where(rf, np.float32(0.0), np.float32(1.0))

            if has_glos:
                # GLOS override: Phong-lobe continuation; below-horizon
                # samples (gw == 0) are absorbed — the lane dies and
                # regenerates (mirrors _bounce_core's alive_out kill).
                ndx = jnp.where(glm, glx, ndx)
                ndy = jnp.where(glm, gly, ndy)
                ndz = jnp.where(glm, glz, ndz)
                wgt = jnp.where(glm, gw, wgt)
                alive_next = alive_next & ~(glm & (gw <= 0.0))

            f_scale = inv_p * wgt
            tr_n = tr_ * h["alb"][0] * f_scale
            tg_n = tg * h["alb"][1] * f_scale
            tb_n = tb * h["alb"][2] * f_scale

            nex = nex + jnp.where(alive, np.int32(1), np.int32(0))
            fired = probes > 0.0
            if not (textbook or mis_est):
                # Shadow rays of the C13 estimators count only on lanes
                # that continue; textbook/mis shadow rays fire for every
                # live diffuse lane regardless of the RR outcome (probes
                # already carries that mask).
                fired = fired & alive_next
            npr = npr + jnp.where(fired, np.int32(1), np.int32(0))

            # Per-path max_bounces truncation (identical to the scan/regen
            # jnp schedules — see path_trace_regen).
            alive_next = alive_next & (depth < max_bounces)

            if fold:
                # NEE continuation fold (see build_kernel): the next bounce
                # of a successful-probe diffuse lane is fully determined —
                # nearest hit = the sampled light at t_probe, emission
                # pickup = tr_n * e_light, deterministic RR death (zero
                # albedo). Resolve it now, bit-identically: the pickup
                # reproduces the next iteration's
                # `emit_f * tr_ * h["emi"]` float-for-float (emit_f == 1,
                # tr_ == tr_n, h["emi"] == the light's baked emission), the
                # extend counter counts the folded trace, and the per-lane
                # Lr add sequence is unchanged (elementwise accumulators).
                sc = alive_next & success & ~(h["is_spec"] | h["is_refr"])
                if est == "mixture":
                    sc = sc & take
                scf = jnp.where(sc, np.float32(1.0), np.float32(0.0))
                if multi:
                    e_fold = tuple(
                        _sel_f([_e_lights[k][c] for k in range(K_L)])
                        for c in range(3)
                    )
                else:
                    e_fold = e_light_k
                Lr = Lr + scf * tr_n * e_fold[0]
                Lg = Lg + scf * tg_n * e_fold[1]
                Lb = Lb + scf * tb_n * e_fold[2]
                nex = nex + jnp.where(sc, np.int32(1), np.int32(0))
                alive_next = alive_next & ~sc

            # Regeneration: dead lanes with budget left respawn (C4 jitter).
            died = alive & ~alive_next
            s_next = s + jnp.where(died, np.uint32(1), np.uint32(0))
            respawn = died & (s_next < s_stop)
            pid_sp = pid_base + s_next
            o_sp, d_sp = spawn(seed, px, py, pid_sp)

            live = alive_next
            if multi and est in ("nee", "mixture"):
                # Continuation origin override for light-list NEE-success
                # diffuse lanes (lifted probe origin — see the NEE block).
                off_m = cont_off & ~(h["is_spec"] | h["is_refr"])
                hx = jnp.where(off_m, pox, hx)
                hy = jnp.where(off_m, poy, hy)
                hz = jnp.where(off_m, poz, hz)
            ox = jnp.where(respawn, o_sp[0], jnp.where(live, hx, ox))
            oy = jnp.where(respawn, o_sp[1], jnp.where(live, hy, oy))
            oz = jnp.where(respawn, o_sp[2], jnp.where(live, hz, oz))
            dx = jnp.where(respawn, d_sp[0], jnp.where(live, ndx, dx))
            dy = jnp.where(respawn, d_sp[1], jnp.where(live, ndy, dy))
            dz = jnp.where(respawn, d_sp[2], jnp.where(live, ndz, dz))
            tr_ = jnp.where(respawn, 1.0, jnp.where(live, tr_n, tr_))
            tg = jnp.where(respawn, 1.0, jnp.where(live, tg_n, tg))
            tb = jnp.where(respawn, 1.0, jnp.where(live, tb_n, tb))
            depth = jnp.where(respawn, 0, depth)
            s = jnp.where(died, s_next, s)
            pid = jnp.where(respawn, pid_sp, pid)
            alive_i = jnp.where(
                alive_next | respawn, np.int32(1), np.int32(0)
            )
            if textbook:
                # Bit 1 = suppress next emission pickup (fresh respawns DO
                # pick up their primary-hit emission).
                is_diff_tb = ~(h["is_spec"] | h["is_refr"])
                alive_i = alive_i + jnp.where(
                    alive_next & is_diff_tb & ~respawn,
                    np.int32(2), np.int32(0),
                )
            if nee_sphere:
                # Sphere-light C13 variant: only FALLBACK lanes (cone
                # probe failed, cosine continuation) suppress the light's
                # next pickup — success lanes keep C13-continuation
                # semantics (integrator/wavefront._diff_scatter).
                is_diff_sl = ~(h["is_spec"] | h["is_refr"])
                fb_sl = ~success
                if est == "mixture":
                    fb_sl = fb_sl & take
                alive_i = alive_i + jnp.where(
                    alive_next & is_diff_sl & fb_sl & ~respawn,
                    np.int32(2), np.int32(0),
                )
            if mis_est:
                # Next pickup's balance carry: the cosine continuation's
                # pdf (cos/pi) for surviving diffuse lanes; 0 for
                # spec/refr (delta — full pickup) and fresh respawns.
                is_diff_m = ~(h["is_spec"] | h["is_refr"])
                cos_c = ndx * nx + ndy * ny + ndz * nz
                pdf_cont = jnp.maximum(cos_c, 0.0) * np.float32(1.0 / math.pi)
                if has_glos:
                    # GLOS: the continuation is the Phong lobe — carry its
                    # pdf at the sampled direction (sampling.phong_pdf).
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
                    alive_next & is_diff_m & ~respawn,
                    pdf_cont,
                    np.float32(0.0),
                )
                return (ox, oy, oz, dx, dy, dz, tr_, tg, tb, Lr, Lg, Lb,
                        alive_i, depth, s, pid, nex, npr, mpdf)

            return (ox, oy, oz, dx, dy, dz, tr_, tg, tb, Lr, Lg, Lb, alive_i,
                    depth, s, pid, nex, npr)

        out = jax.lax.while_loop(cond, body, carry0)
        lr_ref[...] = out[9]
        lg_ref[...] = out[10]
        lb_ref[...] = out[11]
        # This block's [extend, probe] trace counts: blocks run in
        # parallel, so each writes its own row and the host sums the rows
        # (trace_totals).
        traces_ref[0, 0] = jnp.sum(out[16])
        traces_ref[0, 1] = jnp.sum(out[17])

    return kernel


_CACHE: dict = {}


def _geom_hash(scene: Scene, cam: CameraParams) -> str:
    import hashlib

    h = hashlib.sha256()
    for leaf in jax.tree.leaves((scene, cam)):
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()


def _table_compatible(scene: Scene) -> bool:
    """True iff the scene satisfies build_kernel's sphere_tab constraints:
    no GLOS table spheres, at least one unrolled rect/quad, and no light
    (primary or list entry) living in the table."""
    base_tab = (int(np.asarray(scene.rects.k).shape[0])
                + int(np.asarray(scene.quads.corner).shape[0]))
    if base_tab == 0:
        return False
    if any(int(r) == 3 for r in np.asarray(scene.spheres.refl).reshape(-1)):
        return False
    if int(np.asarray(scene.light.light_obj_id)) >= base_tab:
        return False
    if scene.lights is not None and any(
        int(i) >= base_tab
        for i in np.asarray(scene.lights.obj_id).reshape(-1)
    ):
        return False
    return True


def _use_sphere_table(scene: Scene, cfg: RenderConfig) -> bool:
    """Resolve cfg.sphere_table ("auto"/"on"/"off") for this scene.

    Auto mode only turns the table on when the scene also satisfies the
    build constraints (_table_compatible) — a big scene with a GLOS
    sphere, a sphere light, or no unrolled object renders via the
    unrolled path instead of hard-erroring (ADVICE r3); explicit "on"
    keeps the hard error so the caller learns why the table can't build."""
    S = int(np.asarray(scene.spheres.radius).shape[0])
    mode = getattr(cfg, "sphere_table", "auto")
    if mode == "on":
        return S > 0
    if mode == "off":
        return False
    if mode != "auto":
        raise ValueError(f"sphere_table must be auto/on/off, got {mode!r}")
    from ..config import SPHERE_TABLE_AUTO_MIN

    return S >= SPHERE_TABLE_AUTO_MIN and _table_compatible(scene)


def _geom_hash_structure(scene: Scene, cam: CameraParams) -> str:
    """Build-cache key for the sphere-table kernel: everything the compiled
    code DEPENDS on (rect/quad geometry, light geometry, refl codes, object
    counts, camera) — excluding what rides in at run time (all materials;
    sphere centers/radii), so geometry/material edits reuse the
    executable."""
    import hashlib

    h = hashlib.sha256()
    r, q, s = scene.rects, scene.quads, scene.spheres
    static_leaves = (
        r.axis, r.k, r.lo, r.hi, r.refl, r.gloss,
        q.corner, q.edge_u, q.edge_v, q.refl, q.gloss,
        s.refl,
        scene.light,
        scene.lights if scene.lights is not None else (),
        cam,
    )
    for leaf in jax.tree.leaves(static_leaves):
        h.update(np.asarray(leaf).tobytes())
    h.update(str(int(np.asarray(s.radius).shape[0])).encode())
    return h.hexdigest()


def _sphere_tables(scene: Scene):
    """Runtime inputs for the table kernel, all FLAT 1-D (see _FlatRows):
    (alb (K*3,) f32, emi (K*3,) f32 for the
    unrolled objects' runtime materials, packed (S*TAB_STRIDE,) f32
    per-sphere rows [cx,cy,cz,r, alb rgb, emi rgb, refl, pad])."""
    from ..scene.types import object_arrays

    alb, emi, _ = object_arrays(scene)
    s = scene.spheres
    S = int(np.asarray(s.radius).shape[0])
    packed = jnp.concatenate(
        [
            jnp.asarray(s.center, jnp.float32),
            jnp.asarray(s.radius, jnp.float32)[:, None],
            jnp.asarray(s.albedo, jnp.float32),
            jnp.asarray(s.emission, jnp.float32),
            jnp.asarray(s.refl, jnp.float32)[:, None],
            jnp.zeros((S, TAB_STRIDE - 11), jnp.float32),
        ],
        axis=1,
    )
    return (
        jnp.asarray(alb, jnp.float32).reshape(-1),
        jnp.asarray(emi, jnp.float32).reshape(-1),
        packed.reshape(-1),
    )


# ---------------------------------------------------------------------------
# Launch: lane layout, the forward pallas_call, trace totals.
# ---------------------------------------------------------------------------

# Lanes a launch aims for (lane_groups splits a pixel's samples over
# several lanes only below it): about one lane per thread an H100 keeps
# resident (132 SMs x 2048 threads = 2^18.04). The sweep in PERF.md found
# no value best at every frame size, so it stays at this count.
LANE_TARGET = 1 << 18


def lane_layout(n_pix: int, n_s: int, groups: int = 0):
    """(g lanes per pixel, per-lane sample count, live lanes, blocks)."""
    from ..integrator.wavefront import lane_groups

    g = lane_groups(n_pix, n_s, LANE_TARGET, groups)
    n_lanes = n_pix * g
    return g, n_s // g, n_lanes, -(-n_lanes // route.block_lanes())


def pad_lanes(x, n_blocks: int):
    """A per-lane plane zero-padded to whole blocks."""
    return jnp.pad(x, (0, n_blocks * route.block_lanes() - x.shape[0]))


def lane_planes(cfg: RenderConfig, pix, s_start, s_stop, n_blocks: int):
    """The five per-lane input planes (px, py, path-id base, s_start,
    s_stop), padded to whole blocks. Padding lanes get s_start == s_stop ==
    0 and are born dead."""
    px = (pix % jnp.uint32(cfg.width)).astype(jnp.float32)
    py = (pix // jnp.uint32(cfg.width)).astype(jnp.float32)
    return tuple(pad_lanes(x, n_blocks) for x in (
        px, py, pix * jnp.uint32(cfg.spp),
        s_start.astype(jnp.uint32), s_stop.astype(jnp.uint32),
    ))


def frame_lanes(cfg: RenderConfig, n_pix: int, g: int, per: int,
                n_blocks: int, pix0=0, samp0=0):
    """Lanes for pixels [pix0, pix0 + n_pix), g lanes per pixel, each over
    ``per`` consecutive samples from samp0 (pix0/samp0 may be traced).
    Returns (pixel of each live lane, the five padded lane planes)."""
    pix = pix0 + jnp.repeat(jnp.arange(n_pix, dtype=jnp.uint32), g)
    s_start = samp0 + jnp.tile(
        jnp.arange(g, dtype=jnp.uint32) * jnp.uint32(per), n_pix
    )
    return pix, lane_planes(cfg, pix, s_start, s_start + jnp.uint32(per),
                            n_blocks)


def lane_spec():
    """BlockSpec of a per-lane plane: block i owns lanes [i*B, (i+1)*B)."""
    return pl.BlockSpec((route.block_lanes(),), lambda i: (i,))


def launch_forward(kernel, n_blocks: int, seed, tables, lanes):
    """One forward-kernel launch. The seed and runtime tables are whole
    arrays every block reads (global memory on the GPU, scalar loads).
    Returns (per-lane radiance (n, 3) over the padded lanes, per-block
    (n_blocks, 2) i32 [extend, probe] trace counts)."""
    n = n_blocks * route.block_lanes()
    plane = jax.ShapeDtypeStruct((n,), jnp.float32)
    lr, lg, lb, traces = pl.pallas_call(
        kernel,
        grid=(n_blocks,),
        in_specs=[pl.BlockSpec()] * (1 + len(tables)) + [lane_spec()] * 5,
        out_specs=[lane_spec()] * 3 + [
            pl.BlockSpec((1, 2), lambda i: (i, 0))
        ],
        out_shape=[plane] * 3 + [
            jax.ShapeDtypeStruct((n_blocks, 2), jnp.int32)
        ],
        name="spt_forward",
        **route.pallas_call_kwargs(),
    )(jnp.asarray(seed, jnp.uint32).reshape(1), *tables, *lanes)
    return jnp.stack([lr, lg, lb], axis=-1), traces


def trace_totals(per_block) -> np.ndarray:
    """Exact [extend, probe] totals (int64, on the host) from the per-block
    (n_blocks, 2) i32 trace rows the kernel launchers return (a (2,) pair
    passes through). A block's count fits i32; the north-star frame's
    total (~1.5e9) is near the i32 limit and far beyond f32's exact range,
    so the rows are summed here, by callers that report trace counts, and
    not on the device."""
    return np.asarray(per_block, np.int64).reshape(-1, 2).sum(axis=0)


def _cache_key(*parts):
    return parts + (route.platform(), route.block_lanes(), _fold_enabled())


def _scene_inputs(scene: Scene, cam: CameraParams, cfg: RenderConfig):
    """(use the sphere table?, build-cache hash, runtime tables)."""
    use_tab = _use_sphere_table(scene, cfg)
    if use_tab:
        return True, _geom_hash_structure(scene, cam), _sphere_tables(scene)
    return False, _geom_hash(scene, cam), ()


def render_pallas(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed):
    """Full render via the Pallas megakernel.

    Scene/camera/config are compile-time constants of the kernel; the jitted
    executable is cached by their values (changing the scene recompiles —
    use the differentiable kernel pair in ops/megakernel_grad.py or the jnp
    wavefront for scene optimization loops).

    Returns ((h, w, 3) radiance SUM over spp, per-block (n_blocks, 2) i32
    [extend, probe] trace rows; trace_totals sums them). Divide by spp and
    clamp (film.finalize) for the final image."""
    return render_pallas_span(scene, cam, cfg, seed, 0, cfg.spp)


def render_pallas_span(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                       seed, s0, n_s: int):
    """Megakernel render of sample indices [s0, s0+n_s) for every pixel —
    the checkpoint-span unit (utils/checkpoint.py). s0 is a TRACED input
    (it only shifts the per-lane s_start/s_stop planes), so a checkpoint
    loop compiles once per span size.

    Returns ((h, w, 3) radiance SUM over the span, per-block trace rows)."""
    use_tab, ghash, tables = _scene_inputs(scene, cam, cfg)
    key = _cache_key(ghash, use_tab, cfg, int(n_s), "span")
    run = _CACHE.get(key)
    if run is None:
        run = _CACHE[key] = _build_render(scene, cam, cfg, int(n_s), use_tab)
    img, per_block = run(jnp.asarray(seed, jnp.uint32),
                         jnp.asarray(s0, jnp.uint32), *tables)
    return img, per_block


def _build_render(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                  n_s: int, use_tab: bool):
    n_pix = cfg.width * cfg.height
    g, per, n_lanes, n_blocks = lane_layout(n_pix, n_s, cfg.regen_groups)
    kernel = build_kernel(scene, cam, cfg, mat_refs=use_tab,
                          sphere_tab=use_tab)

    @jax.jit
    def run(seed, s0, *tables):
        _, lanes = frame_lanes(cfg, n_pix, g, per, n_blocks, samp0=s0)
        L, traces = launch_forward(kernel, n_blocks, seed, tables, lanes)
        img = L[:n_lanes].reshape(n_pix, g, 3).sum(axis=1)
        return img.reshape(cfg.height, cfg.width, 3), traces

    return run


def render_pallas_budgets(scene: Scene, cam: CameraParams,
                          cfg: RenderConfig, seed, s_start, s_stop):
    """Megakernel render with PER-PIXEL sample budgets: pixel i renders
    sample indices [s_start[i], s_stop[i]) — the adaptive-sampling wave
    unit (utils/adaptive.py). One lane per pixel; pixels with
    s_start == s_stop are born dead and cost only their lane slot.

    s_start/s_stop are TRACED (n_pix,) uint32 inputs (the compiled
    executable is reused across waves); cfg.spp remains the path-id
    packing stride, so per-sample radiance is bit-identical to every
    other schedule at equal (pixel, sample).

    Returns ((n_pix, 3) radiance SUM over each pixel's span, per-block
    trace rows)."""
    use_tab, ghash, tables = _scene_inputs(scene, cam, cfg)
    key = _cache_key(ghash, use_tab, cfg, "budgets")
    run = _CACHE.get(key)
    if run is None:
        run = _CACHE[key] = _build_render_budgets(scene, cam, cfg, use_tab)
    L, per_block = run(
        jnp.asarray(seed, jnp.uint32),
        jnp.asarray(s_start, jnp.uint32),
        jnp.asarray(s_stop, jnp.uint32),
        *tables,
    )
    return L, per_block


def _build_render_budgets(scene: Scene, cam: CameraParams,
                          cfg: RenderConfig, use_tab: bool):
    n_pix = cfg.width * cfg.height
    n_blocks = -(-n_pix // route.block_lanes())
    kernel = build_kernel(scene, cam, cfg, mat_refs=use_tab,
                          sphere_tab=use_tab)

    @jax.jit
    def run(seed, s_start, s_stop, *tables):
        pix = jnp.arange(n_pix, dtype=jnp.uint32)
        lanes = lane_planes(cfg, pix, s_start, s_stop, n_blocks)
        L, traces = launch_forward(kernel, n_blocks, seed, tables, lanes)
        return L[:n_pix], traces

    return run


def render_pallas_sharded(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                          mesh, seed, s0=0, n_s: int | None = None):
    """Megakernel + device mesh: each device runs the SAME compiled kernel
    over its (pixel-block x sample-range) lanes inside shard_map; per-pixel
    sums reduce over the dp axis with one psum. Composes the fastest
    single-device path with the parallel/ scaling design.

    s0/n_s render the sample span [s0, s0+n_s) only (checkpoint spans;
    n_s defaults to cfg.spp). Compiled executables are cached per
    (geometry, cfg, mesh, n_s) — s0 is traced.

    Returns ((h*w, 3) radiance sum sharded over sp, the per-block trace
    rows of every device)."""
    n_s = cfg.spp if n_s is None else int(n_s)
    use_tab, ghash, tables = _scene_inputs(scene, cam, cfg)
    key = _cache_key(ghash, use_tab, cfg, mesh, n_s, "sharded")
    run = _CACHE.get(key)
    if run is None:
        run = _CACHE[key] = _build_render_sharded(scene, cam, cfg, mesh, n_s,
                                                  use_tab)
    img, per_block = run(jnp.asarray(seed, jnp.uint32),
                         jnp.asarray(s0, jnp.uint32), *tables)
    return img, per_block


def _build_render_sharded(scene: Scene, cam: CameraParams,
                          cfg: RenderConfig, mesh, n_s: int, use_tab: bool):
    from jax.sharding import PartitionSpec as P

    from ..parallel.mesh import AXIS_PIXEL, AXIS_SAMPLE

    n_sp = mesh.shape[AXIS_PIXEL]
    n_dp = mesh.shape[AXIS_SAMPLE]
    n_pix = cfg.width * cfg.height
    if n_pix % n_sp or n_s % n_dp:
        raise ValueError(f"{n_pix=} % {n_sp=} or {n_s=} % {n_dp=} != 0")
    n_pix_loc = n_pix // n_sp
    n_s_loc = n_s // n_dp
    g, per, n_lanes, n_blocks = lane_layout(n_pix_loc, n_s_loc,
                                            cfg.regen_groups)
    kernel = build_kernel(scene, cam, cfg, mat_refs=use_tab,
                          sphere_tab=use_tab)

    def local(seed, s0, *tables):
        pix0 = (jax.lax.axis_index(AXIS_PIXEL) * n_pix_loc).astype(jnp.uint32)
        samp0 = s0 + (
            jax.lax.axis_index(AXIS_SAMPLE) * n_s_loc
        ).astype(jnp.uint32)
        _, lanes = frame_lanes(cfg, n_pix_loc, g, per, n_blocks, pix0, samp0)
        L, traces = launch_forward(kernel, n_blocks, seed, tables, lanes)
        img_loc = L[:n_lanes].reshape(n_pix_loc, g, 3).sum(axis=1)
        return jax.lax.psum(img_loc, AXIS_SAMPLE), traces

    return jax.jit(
        jax.shard_map(
            local, mesh=mesh,
            # Scene tables (if any) are tiny and replicated on every device.
            in_specs=(P(), P()) + ((P(),) * 3 if use_tab else ()),
            # Per-block trace rows of every device, concatenated.
            out_specs=(P(AXIS_PIXEL), P((AXIS_PIXEL, AXIS_SAMPLE))),
            check_vma=False,
        )
    )
