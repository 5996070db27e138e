"""Scene representation: struct-of-arrays pytrees, one block per primitive type.

Array-native replacement for the reference's ``Hitable*`` vtable array
(/root/reference/src/smallpt.cpp:82-90, 287-311): no virtual dispatch — each
primitive family is a batched array block and intersection is branch-free
vectorized math with a select over the object axis.

Global object ids: rects first (0..R-1), then spheres (R..R+S-1). This keeps
the reference's scene indexing (the light is ``rect[6]``, contract C13) intact
for the Cornell presets.

All numeric leaves are differentiable scene parameters (albedo, emission,
plane offsets, bounds, sphere centers/radii, light geometry) — the pytree IS
the parameter vector for the adjoint pass (``grad/``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np

import jax.numpy as jnp

# Material / reflection types, matching the reference enum Refl_t
# (smallpt.cpp:72-74). GLOS is an EXTENSION beyond the reference's three
# codes: a modified-Phong glossy lobe (energy-conserving power-cosine around
# the mirror direction, exponent = the primitive's ``gloss`` field) — the
# material family the Veach MIS test scene needs (scene/presets.veach_mis).
DIFF = 0
SPEC = 1
REFR = 2
GLOS = 3


class Rects(NamedTuple):
    """Axis-aligned rectangles (the reference's Rectangle_xz/xy/yz,
    smallpt.cpp:92-221), unified into one block parameterized by normal axis.

    axis: (R,) int32 — index of the normal axis (0=x => yz-rect, 1=y => xz,
        2=z => xy).
    k: (R,) — plane offset along the normal axis.
    lo, hi: (R, 2) — bounds on the two in-plane axes, in ascending axis order
        (yz-rect: (y, z); xz-rect: (x, z); xy-rect: (x, y)), matching the
        constructor argument order in the reference.
    albedo, emission: (R, 3).
    refl: (R,) int32 in {DIFF, SPEC, REFR, GLOS}.
    gloss: (R,) Phong exponent (used when refl == GLOS, else ignored).
    """

    axis: jnp.ndarray
    k: jnp.ndarray
    lo: jnp.ndarray
    hi: jnp.ndarray
    albedo: jnp.ndarray
    emission: jnp.ndarray
    refl: jnp.ndarray
    gloss: jnp.ndarray


class Quads(NamedTuple):
    """General (possibly tilted) parallelograms: point = corner + a*edge_u +
    b*edge_v, a,b in [0,1]. Extends the reference's axis-aligned rect family
    to the tilted-plane lights of BASELINE.json config #3. Two-sided, like
    the reference rects (C7). corner/edge_u/edge_v: (Q,3)."""

    corner: jnp.ndarray
    edge_u: jnp.ndarray
    edge_v: jnp.ndarray
    albedo: jnp.ndarray
    emission: jnp.ndarray
    refl: jnp.ndarray
    gloss: jnp.ndarray


class Spheres(NamedTuple):
    """Spheres (smallpt.cpp:223-254). center: (S,3); radius: (S,)."""

    center: jnp.ndarray
    radius: jnp.ndarray
    albedo: jnp.ndarray
    emission: jnp.ndarray
    refl: jnp.ndarray
    gloss: jnp.ndarray


class LightSampler(NamedTuple):
    """Parameters of the explicit-light (NEE) sampler, contract C13.

    The reference hard-codes x in [32, 68], z in [63, 99] (sic: 3 units past
    the light's z2=96), target plane y=81.6 (sic: the ceiling, light sits at
    81.5), and the constant 1296 = 36*36 (smallpt.cpp:363-369, 471).

    We generalize to a parallelogram: point = corner + u*edge_u + v*edge_v,
    with area = |edge_u x edge_v| and normal = normalize(edge_u x edge_v).
    For the Cornell presets this reproduces the reference constants exactly
    (area = 36*36 = 1296, normal = (0,1,0)); it also supports tilted-plane
    lights (BASELINE.json config #3).

    light_obj_id: global object id whose hit counts as "reached the light"
    (the NEE success test ``id == 6``, smallpt.cpp:467).
    """

    corner: jnp.ndarray  # (3,)
    edge_u: jnp.ndarray  # (3,)
    edge_v: jnp.ndarray  # (3,)
    light_obj_id: jnp.ndarray  # () int32


class SphereLight(NamedTuple):
    """Spherical emitter for explicit light sampling (NEE cone sampling).

    The reference family's round ceiling light: original smallpt's rad-600
    sky sphere (the commented heritage at /root/reference/src/smallpt.cpp:
    297-298 and the round light visible in the committed historic renders,
    SURVEY.md section 4.2) — the reference snapshot itself only ever
    explicitly samples its rect light (smallpt.cpp:363-369).

    NEE draws a direction uniformly inside the cone subtended by the sphere
    from the shading point (half-angle asin(r/|c-x|)); the solid-angle
    density is 1/(2*pi*(1-cos_theta_max)), so the C13-style weight is
    PDF_inverse = 2*pi*(1-cos_theta_max) with BRDF = |d.nl|/pi — the exact
    sphere-light analogue of the parallelogram sampler's
    |area*cos_l|/t^2 (sampling.sample_sphere_dir / sphere_cone).

    center: (3,); radius: (); light_obj_id: () int32 global object id
    (success test = the probe's nearest hit is this object)."""

    center: jnp.ndarray
    radius: jnp.ndarray
    light_obj_id: jnp.ndarray


# Light-geometry kind codes for LightList.kind.
LIGHT_RECT = 0    # parallelogram: corner + u*edge_u + v*edge_v
LIGHT_SPHERE = 1  # sphere: center = corner, radius = edge_u[0]


class LightList(NamedTuple):
    """Batched emitters for multi-light NEE (K lights).

    The reference supports exactly ONE explicit light (the NEE success test
    is ``id == 6``, smallpt.cpp:467). This generalizes the C13 sampler to a
    light LIST: a discrete light-selection draw picks light k with
    probability q_k (uniform or emission*area power weighted,
    sampling.light_select_probs), the chosen light is point-sampled exactly
    like the single-light case, and the NEE weight is divided by q_k —
    unbiased for the SUM of direct illumination over all listed lights.

    corner/edge_u/edge_v: (K, 3); obj_id: (K,) int32 global object ids.

    kind (optional, (K,) int32): per-light geometry. LIGHT_RECT (default
    when None) = parallelogram; LIGHT_SPHERE = spherical emitter stored as
    corner = center, edge_u = (radius, 0, 0), edge_v = 0 (cone-sampled,
    see SphereLight). Mixed lists run on the jnp estimators AND the forward
    megakernel (adjoint kernels waive them);
    sampling.make_sphere_list_entry builds the packed row."""

    corner: jnp.ndarray
    edge_u: jnp.ndarray
    edge_v: jnp.ndarray
    obj_id: jnp.ndarray
    kind: jnp.ndarray | None = None


class Scene(NamedTuple):
    """Global object ids: rects (0..R-1), quads (R..R+Q-1), spheres
    (R+Q..R+Q+S-1).

    ``light``: the single explicit-light sampler — a parallelogram
    (LightSampler, contract C13) or a spherical emitter (SphereLight,
    cone-sampled).

    ``lights`` (optional): multi-emitter light list. When None (all
    reference-parity presets), the NEE estimators use the single ``light``
    sampler; when set, they sample over the list (``light`` then only marks
    the primary light for single-light-only consumers)."""

    rects: Rects
    quads: Quads
    spheres: Spheres
    light: LightSampler | SphereLight
    lights: LightList | None = None


def make_scene(
    rects: list[tuple],
    spheres: list[tuple],
    light: LightSampler,
    quads: list[tuple] = (),
    dtype=jnp.float32,
    lights: LightList | None = None,
) -> Scene:
    """Build a Scene from python lists.

    rects: list of (axis, k, (lo0, lo1), (hi0, hi1), albedo3, emission3, refl)
    spheres: list of (center3, radius, albedo3, emission3, refl)
    quads: list of (corner3, edge_u3, edge_v3, albedo3, emission3, refl)

    Each tuple may carry one OPTIONAL trailing element: the Phong exponent
    ``gloss`` for refl == GLOS primitives (defaults to 0 — ignored for the
    reference's three material codes).
    """

    def _gloss(items, n_base):
        return jnp.asarray(
            [float(x[n_base]) if len(x) > n_base else 0.0 for x in items],
            dtype=dtype,
        )
    if rects:
        r = Rects(
            axis=jnp.asarray([x[0] for x in rects], dtype=jnp.int32),
            k=jnp.asarray([x[1] for x in rects], dtype=dtype),
            lo=jnp.asarray([x[2] for x in rects], dtype=dtype),
            hi=jnp.asarray([x[3] for x in rects], dtype=dtype),
            albedo=jnp.asarray([x[4] for x in rects], dtype=dtype),
            emission=jnp.asarray([x[5] for x in rects], dtype=dtype),
            refl=jnp.asarray([x[6] for x in rects], dtype=jnp.int32),
            gloss=_gloss(rects, 7),
        )
    else:
        r = Rects(
            axis=jnp.zeros((0,), jnp.int32),
            k=jnp.zeros((0,), dtype),
            lo=jnp.zeros((0, 2), dtype),
            hi=jnp.zeros((0, 2), dtype),
            albedo=jnp.zeros((0, 3), dtype),
            emission=jnp.zeros((0, 3), dtype),
            refl=jnp.zeros((0,), jnp.int32),
            gloss=jnp.zeros((0,), dtype),
        )
    if quads:
        q = Quads(
            corner=jnp.asarray([x[0] for x in quads], dtype=dtype),
            edge_u=jnp.asarray([x[1] for x in quads], dtype=dtype),
            edge_v=jnp.asarray([x[2] for x in quads], dtype=dtype),
            albedo=jnp.asarray([x[3] for x in quads], dtype=dtype),
            emission=jnp.asarray([x[4] for x in quads], dtype=dtype),
            refl=jnp.asarray([x[5] for x in quads], dtype=jnp.int32),
            gloss=_gloss(quads, 6),
        )
    else:
        q = Quads(
            corner=jnp.zeros((0, 3), dtype),
            edge_u=jnp.zeros((0, 3), dtype),
            edge_v=jnp.zeros((0, 3), dtype),
            albedo=jnp.zeros((0, 3), dtype),
            emission=jnp.zeros((0, 3), dtype),
            refl=jnp.zeros((0,), jnp.int32),
            gloss=jnp.zeros((0,), dtype),
        )
    if spheres:
        s = Spheres(
            center=jnp.asarray([x[0] for x in spheres], dtype=dtype),
            radius=jnp.asarray([x[1] for x in spheres], dtype=dtype),
            albedo=jnp.asarray([x[2] for x in spheres], dtype=dtype),
            emission=jnp.asarray([x[3] for x in spheres], dtype=dtype),
            refl=jnp.asarray([x[4] for x in spheres], dtype=jnp.int32),
            gloss=_gloss(spheres, 5),
        )
    else:
        s = Spheres(
            center=jnp.zeros((0, 3), dtype),
            radius=jnp.zeros((0,), dtype),
            albedo=jnp.zeros((0, 3), dtype),
            emission=jnp.zeros((0, 3), dtype),
            refl=jnp.zeros((0,), jnp.int32),
            gloss=jnp.zeros((0,), dtype),
        )
    return Scene(rects=r, quads=q, spheres=s, light=light, lights=lights)


def num_objects(scene: Scene) -> int:
    return (
        scene.rects.k.shape[0]
        + scene.quads.corner.shape[0]
        + scene.spheres.radius.shape[0]
    )


def object_arrays(scene: Scene):
    """Concatenated per-object (albedo, emission, refl) in global-id order."""
    albedo = jnp.concatenate(
        [scene.rects.albedo, scene.quads.albedo, scene.spheres.albedo], axis=0
    )
    emission = jnp.concatenate(
        [scene.rects.emission, scene.quads.emission, scene.spheres.emission],
        axis=0,
    )
    refl = jnp.concatenate(
        [scene.rects.refl, scene.quads.refl, scene.spheres.refl], axis=0
    )
    return albedo, emission, refl


def gloss_arrays(scene: Scene) -> jnp.ndarray:
    """Concatenated per-object Phong exponent in global-id order (the GLOS
    extension's per-object parameter; 0 for non-glossy objects)."""
    return jnp.concatenate(
        [scene.rects.gloss, scene.quads.gloss, scene.spheres.gloss], axis=0
    )


def scene_has_sphere_light(scene: Scene) -> bool:
    """STRUCTURAL check (trace-safe — never reads array values, so it can
    run inside jit with a traced scene): does the scene's explicit-light
    set carry sphere-light machinery (single SphereLight, or a LightList
    with a kind field — set only by mixed-kind scene builders)? Gates the
    sphere-light variant of the C13-continuation estimators (see
    integrator/wavefront._diff_scatter): sphere cones are typically wide
    and heavily occluded, so the reference's fallback-with-pickup structure
    would double-count direct light catastrophically — fallback lanes
    suppress sphere-kind lights' pickup instead (unbiased). A kind-carrying
    list with zero sphere rows makes the suppression a provable no-op
    (is_slight_hit is all-False), so the structural test is semantically
    exact."""
    if isinstance(scene.light, SphereLight):
        return True
    return scene.lights is not None and scene.lights.kind is not None


def scene_has_glos(scene: Scene) -> bool:
    """Host-side: does the scene contain any GLOS primitive? Used by entry
    points to gate the glossy scatter path (and to reject the
    reference-parity estimators, which have no glossy semantics)."""
    for refl in (scene.rects.refl, scene.quads.refl, scene.spheres.refl):
        if np.any(np.asarray(refl) == GLOS):
            return True
    return False


# In-plane axis pairs for each normal axis, ascending order. For normal axis
# a, OTHER_AXES[a] are the two bounded axes (matches the reference's
# constructor orders, smallpt.cpp:92-221).
OTHER_AXES = np.array([[1, 2], [0, 2], [0, 1]], dtype=np.int32)
