"""Adjoint (inverse-rendering) pass: reverse-mode gradients of the render.

The reference has no gradients at all — this subsystem is specified by
BASELINE.json ("pixel-gradients w.r.t. sphere center/albedo/emission,
pod-sharded spp"), not by reference code.

Design:
- the forward render for AD is the *fixed-length* wavefront
  (``path_trace_fixed``, a ``lax.scan``) so reverse-mode has a static
  program; the RR tail beyond ``n_bounces`` decays geometrically (measured
  <0.1% of bounces beyond depth ~30, SURVEY.md section 6);
- the differentiable image is the UNCLAMPED linear per-pixel mean (the C3
  clamp would zero gradients of saturated pixels);
- gradients w.r.t. *material/emission/light* parameters are exact
  reparameterized derivatives (radiance is smooth in them along fixed paths);
  gradients w.r.t. *geometry* (sphere centers/radii, plane offsets, camera)
  flow through the hit-distance/normal/shading chain but omit the
  visibility-discontinuity (silhouette-edge) term — the FD tests pin
  down which parameters are exact (tests/test_grad.py). For geometry use
  grad/soft.py (silhouette + soft-shadow terms); for camera TRANSLATION
  (entirely edge-advection-dominated) use the screen-space warp estimator
  in grad/warp.py;
- multi-device: gradients are taken THROUGH shard_map (JAX transposes the
  sample-axis psum automatically), so scene-parameter gradients arrive
  all-reduced with zero extra code.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..camera.pinhole import CameraParams, primary_rays_cfg
from ..config import RenderConfig
from ..core import rng
from ..integrator.wavefront import path_trace_fixed
from ..parallel.mesh import AXIS_PIXEL, AXIS_SAMPLE
from ..scene.types import Scene

# Default fixed bounce count for AD: covers >99.9% of RR-surviving depth mass
# (measured depth histogram, SURVEY.md section 6).
DEFAULT_AD_BOUNCES = 32


def render_linear(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                  seed, n_bounces: int = DEFAULT_AD_BOUNCES) -> jnp.ndarray:
    """Differentiable render: unclamped linear mean image (h, w, 3).

    Single pass over all spp (no host chunk loop — keep it one traced
    computation so jax.grad sees a single program). Prefer modest
    width/height/spp for AD configs; the forward-only path (render) handles
    large renders."""
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
    L, _ = path_trace_fixed(scene, cfg, seed, o, d, path_id, n_bounces)
    return L.reshape(h * w, spp, 3).mean(axis=1).reshape(h, w, 3)


def mse_loss(img: jnp.ndarray, target: jnp.ndarray) -> jnp.ndarray:
    return jnp.mean((img - target) ** 2)


@partial(jax.jit, static_argnums=(2, 5))
def loss_and_grads(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                   seed, target, n_bounces: int = DEFAULT_AD_BOUNCES):
    """(loss, (d loss/d scene, d loss/d cam)) — single device."""

    def loss_fn(scene_, cam_):
        img = render_linear(scene_, cam_, cfg, seed, n_bounces)
        return mse_loss(img, target)

    return jax.value_and_grad(loss_fn, argnums=(0, 1), allow_int=True)(
        scene, cam
    )


# ---------------------------------------------------------------------------
# Sharded adjoint: grad THROUGH shard_map.
# ---------------------------------------------------------------------------

def _local_linear(scene, cam, seed, *, cfg: RenderConfig, n_pix_loc: int,
                  n_s_loc: int, n_bounces: int):
    """Per-device differentiable partial image (mean over the FULL spp, with
    only the local sample block contributing; psum over dp completes it)."""
    w, spp = cfg.width, cfg.spp
    pix0 = jax.lax.axis_index(AXIS_PIXEL) * n_pix_loc
    samp0 = jax.lax.axis_index(AXIS_SAMPLE) * n_s_loc
    pix = pix0.astype(jnp.uint32) + jnp.arange(n_pix_loc, dtype=jnp.uint32)
    s = samp0.astype(jnp.uint32) + jnp.arange(n_s_loc, dtype=jnp.uint32)
    path_id = (pix[:, None] * jnp.uint32(spp) + s[None, :]).reshape(-1)
    px = jnp.broadcast_to(
        (pix[:, None] % jnp.uint32(w)).astype(jnp.int32), (n_pix_loc, n_s_loc)
    ).reshape(-1)
    py = jnp.broadcast_to(
        (pix[:, None] // jnp.uint32(w)).astype(jnp.int32), (n_pix_loc, n_s_loc)
    ).reshape(-1)
    uniform = rng.make_uniform_fn(cfg.rng_backend)
    o, d = primary_rays_cfg(cam, cfg, px, py, path_id, seed, uniform)
    L, _ = path_trace_fixed(scene, cfg, seed, o, d, path_id, n_bounces)
    img_loc = L.reshape(n_pix_loc, n_s_loc, 3).sum(axis=1) / spp
    return jax.lax.psum(img_loc, AXIS_SAMPLE)


def render_linear_sharded(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                          seed, mesh, n_bounces: int = DEFAULT_AD_BOUNCES):
    """Differentiable sharded render: (h*w, 3) unclamped linear image,
    sharded over sp. jax.grad through this transposes the psum into the
    scene-gradient all-reduce."""
    n_sp = mesh.shape[AXIS_PIXEL]
    n_dp = mesh.shape[AXIS_SAMPLE]
    n_pix = cfg.width * cfg.height
    assert n_pix % n_sp == 0 and cfg.spp % n_dp == 0, (n_pix, cfg.spp, mesh)
    body = partial(
        _local_linear,
        cfg=cfg,
        n_pix_loc=n_pix // n_sp,
        n_s_loc=cfg.spp // n_dp,
        n_bounces=n_bounces,
    )
    return jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P()),
        out_specs=P(AXIS_PIXEL),
        check_vma=False,
    )(scene, cam, seed)


def make_sharded_train_step(cfg: RenderConfig, mesh, target,
                            n_bounces: int = DEFAULT_AD_BOUNCES,
                            lr: float = 1e-2,
                            train_fields: tuple[str, ...] = ("emission", "albedo"),
                            train_cam: bool = False,
                            optimizer: str = "sgd"):
    """Jitted full training step over the mesh: sharded differentiable
    render -> MSE vs target -> scene/camera grads (all-reduced via psum
    transpose) -> optimizer update. This is the driver's multi-device dry-run
    path (__graft_entry__.dryrun_multichip).

    train_fields: which scene leaf names receive updates. Default is the
    smooth material parameters; geometry/camera gradients are computed but
    frozen by default because their reparameterized derivatives omit the
    visibility-discontinuity term (module docstring) and at low spp they
    destabilize optimization.

    optimizer: "sgd" (stateless; step signature (scene, cam, seed)) or
    "adam" (optax; use make_sharded_train_step_with_state instead)."""
    if optimizer != "sgd":
        raise ValueError(
            "use make_sharded_train_step_with_state for stateful optimizers"
        )
    target_flat = jnp.asarray(target, jnp.float32).reshape(-1, 3)

    def loss_fn(scene, cam, seed):
        img = render_linear_sharded(scene, cam, cfg, seed, mesh, n_bounces)
        return mse_loss(img, target_flat)

    import jax.tree_util as jtu

    def _update(path, p, g):
        name = next(
            (k.name for k in reversed(path) if isinstance(k, jtu.GetAttrKey)),
            "",
        )
        if not jnp.issubdtype(p.dtype, jnp.floating) or name not in train_fields:
            return p
        return (p - lr * g).astype(p.dtype)

    @jax.jit
    def train_step(scene, cam, seed):
        loss, (g_scene, g_cam) = jax.value_and_grad(
            loss_fn, argnums=(0, 1), allow_int=True
        )(scene, cam, seed)
        new_scene = jtu.tree_map_with_path(_update, scene, g_scene)
        new_cam = (
            jax.tree.map(lambda p, g: p - lr * g, cam, g_cam)
            if train_cam else cam
        )
        return loss, new_scene, new_cam

    return train_step


def make_sharded_train_step_with_state(
        cfg: RenderConfig, mesh, target,
        n_bounces: int = DEFAULT_AD_BOUNCES,
        lr: float = 1e-2,
        train_fields: tuple[str, ...] = ("emission", "albedo"),
        optimizer: str = "adam"):
    """Optax-based sharded training step (stateful optimizers).

    Returns (init_fn, step_fn): opt_state = init_fn(scene);
    loss, scene, opt_state = step_fn(scene, cam, seed, opt_state).
    Masked so only ``train_fields`` float leaves are updated."""
    import jax.tree_util as jtu

    import optax

    target_flat = jnp.asarray(target, jnp.float32).reshape(-1, 3)

    def loss_fn(scene, cam, seed):
        img = render_linear_sharded(scene, cam, cfg, seed, mesh, n_bounces)
        return mse_loss(img, target_flat)

    def _trainable(path, p):
        name = next(
            (k.name for k in reversed(path) if isinstance(k, jtu.GetAttrKey)),
            "",
        )
        return (
            hasattr(p, "dtype")
            and jnp.issubdtype(p.dtype, jnp.floating)
            and name in train_fields
        )

    base = {
        "adam": optax.adam(lr),
        "sgd": optax.sgd(lr),
        "rmsprop": optax.rmsprop(lr),
    }[optimizer]
    # NB: optax.masked alone is WRONG here — it passes the RAW gradient
    # through as the update for mask-False leaves, i.e. unscaled gradient
    # ASCENT on the frozen parameters. multi_transform routes frozen leaves
    # to set_to_zero instead.
    tx = optax.multi_transform(
        {"train": base, "freeze": optax.set_to_zero()},
        param_labels=lambda scene: jtu.tree_map_with_path(
            lambda path, p: "train" if _trainable(path, p) else "freeze",
            scene,
        ),
    )

    def init_fn(scene):
        return tx.init(scene)

    @jax.jit
    def step_fn(scene, cam, seed, opt_state):
        loss, g_scene = jax.value_and_grad(loss_fn, allow_int=True)(
            scene, cam, seed
        )
        # float0 grads (int leaves) are not optax-safe; zero them as f32.
        g_scene = jax.tree.map(
            lambda p, g: g if jnp.issubdtype(p.dtype, jnp.floating)
            else jnp.zeros_like(p),
            scene, g_scene,
        )
        updates, opt_state = tx.update(g_scene, opt_state, scene)
        new_scene = optax.apply_updates(scene, updates)
        # Keep integer leaves exact (apply_updates may touch dtypes).
        new_scene = jax.tree.map(
            lambda p, q: q if jnp.issubdtype(p.dtype, jnp.floating) else p,
            scene, new_scene,
        )
        return loss, new_scene, opt_state

    return init_fn, step_fn
