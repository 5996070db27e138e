"""RL state-space visualization — the reference's Q-learning side quest.

Rebuilds program (2) of the reference (SURVEY.md section 0): a
voxel-quantized state dictionary built by ray casting
(/root/reference/src/smallpt.cpp:383-406) and the ``radiance()`` hijack that
renders a false-color state map with red bands at voxel-grid crossings
(:424-442) — the ``show_*.ppm`` images committed in the reference repo.

Reference semantics kept:
- state key (``add_key``, :126-129 and per-orientation variants): hit point
  quantized per the hit object's orientation — in-plane axes ``ceil(v/10)``,
  the plane axis kept as ``v/10`` (so each wall plane is its own state
  layer); spheres quantize all three axes with ceil.
- red band (:433-437): point within ±1 of a voxel center line
  ``key*10 - 5`` on at least two axes.
- grid scan (:386-392): rays from LOOKFROM through the integer grid
  x in [0,100), y in [-1,85), z in [-1,171) - 1.48M probes; unique keys are
  the state count (977 measured for the reference box scene).

Deviations from the reference (documented): colors come from the deterministic
counter hash instead of C ``rand()`` (the reference's colors change every
run — C6), and the state "dictionary" is virtual — any key's color is a
pure function, so there is nothing to store or look up on device.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..camera.pinhole import LOOKFROM, CameraParams, primary_rays
from ..core import rng, vecmath as vm
from ..geometry.intersect import shade_info, trace
from ..scene.types import Scene


def state_key(scene: Scene, obj_id, x):
    """Per-orientation voxel key (3 floats), following add_key.

    x: (N,3) hit points; obj_id: (N,) global ids. Rects keep their plane
    axis un-ceiled (x[axis]/10); all other axes ceil(v/10)."""
    R = scene.rects.k.shape[0]
    ceil_key = jnp.ceil(x / 10.0)
    raw_key = x / 10.0
    if R > 0:
        rect_id = jnp.clip(obj_id, 0, R - 1)
        axis = scene.rects.axis[rect_id]  # (N,)
        is_plane_axis = jnp.arange(3)[None, :] == axis[:, None]
    else:
        is_plane_axis = jnp.zeros((x.shape[0], 3), jnp.bool_)
    is_sphere = (obj_id >= R)[:, None]
    return jnp.where(is_plane_axis & ~is_sphere, raw_key, ceil_key)


def state_color(key):
    """Deterministic false color per state (replaces add_value's
    rand()-scaled colors, :131-134): key-seeded hash in [0,1)^3, scaled by
    the same (k0/10, k1, k2/10) pattern then clamped."""
    ki = (key * 16.0).astype(jnp.int32).astype(jnp.uint32)
    h = rng.hash_u32(jnp.uint32(0xA11CE), ki[..., 0] * jnp.uint32(73856093)
                     ^ ki[..., 1] * jnp.uint32(19349663), ki[..., 2])
    u0 = (h >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24))
    h2 = rng.hash_u32(jnp.uint32(0xB0B), h, jnp.uint32(1))
    u1 = (h2 >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24))
    h3 = rng.hash_u32(jnp.uint32(0xC0C), h, jnp.uint32(2))
    u2 = (h3 >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / (1 << 24))
    c = jnp.stack(
        [jnp.abs(key[..., 0]) / 10.0 * u0, jnp.abs(key[..., 1]) * u1,
         jnp.abs(key[..., 2]) / 10.0 * u2],
        axis=-1,
    )
    return jnp.clip(c, 0.0, 1.0)


def _red_band(key, x):
    """Voxel-center band test (:433-437): within ±1 of key*10-5 on >=2 axes."""
    center = key * 10.0 - 5.0
    near = jnp.abs(x - center) < 1.0
    nx, ny, nz = near[..., 0], near[..., 1], near[..., 2]
    return (nx & ny) | (nx & nz) | (ny & nz)


def create_state_space(scene: Scene, chunk: int = 262144) -> int:
    """Count distinct states over the reference's integer probe grid
    (:386-401). Returns the state count (reference box scene: 977)."""
    xs = np.arange(0, 100, dtype=np.float32)
    ys = np.arange(-1, 85, dtype=np.float32)
    zs = np.arange(-1, 171, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, ys, zs, indexing="ij"), axis=-1).reshape(-1, 3)
    lookfrom = np.asarray(LOOKFROM, np.float32)

    @jax.jit
    def keys_for(pts):
        o = jnp.broadcast_to(jnp.asarray(lookfrom), pts.shape)
        d = vm.norm(pts - o)
        hit = trace(scene, o, d)
        sh = shade_info(scene, o, d, hit)
        return state_key(scene, hit.obj_id, sh.x)

    seen = set()
    for i in range(0, grid.shape[0], chunk):
        k = np.asarray(keys_for(jnp.asarray(grid[i : i + chunk])))
        k = np.round(k * 16.0).astype(np.int64)  # exact-ish dedup grid
        seen.update(map(tuple, k))
    return len(seen)


def render_state_viz(scene: Scene, cam: CameraParams, width: int,
                     height: int):
    """The HEAD-mode render (:424-442 hijack): one centered primary ray per
    pixel; red at voxel-grid crossings, else the state's false color.
    Returns (h, w, 3) float image in [0,1] and the red-pixel count
    (the reference's COUNTER RED diagnostic, :544)."""
    pix = jnp.arange(width * height, dtype=jnp.uint32)
    px = (pix % jnp.uint32(width)).astype(jnp.int32)
    py = (pix // jnp.uint32(width)).astype(jnp.int32)
    half = jnp.full(pix.shape, 0.5, jnp.float32)
    o, d = primary_rays(cam, width, height, px, py, half, half)
    hit = trace(scene, o, d)
    sh = shade_info(scene, o, d, hit)
    key = state_key(scene, hit.obj_id, sh.x)
    red = _red_band(key, sh.x)
    color = jnp.where(
        red[:, None],
        jnp.asarray([1.0, 0.0, 0.0], jnp.float32),
        state_color(key),
    )
    img = color.reshape(height, width, 3)
    return img, int(jnp.sum(red))
