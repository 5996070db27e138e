"""Distributed rendering: shard_map over a (sp=pixels, dp=samples) mesh.

Scaling design (SURVEY.md sections 2.2/5.7/7): the (pixel, sample) grid is
the only parallel axis a path tracer has; we shard it over the mesh and let
XLA place the collectives (NCCL on GPUs):

- ray generation happens *inside* the shard (SPMD): each device derives its
  global pixel/sample block from ``jax.lax.axis_index`` — no host-side
  scatter, no global array materialization;
- the bounce loop is entirely local (no communication — paths never migrate);
- per-pixel radiance partial sums reduce over the sample axis with one
  ``psum`` per chunk (the only forward-pass collective);
- because the RNG is a pure function of (seed, path_id, counter)
  (core/rng.py), the rendered image is invariant to mesh shape: per-sample
  radiance is bit-identical to the single-device path, and only the
  summation order differs (float-associativity-level differences).

The reference has no distributed analogue (SURVEY C18: the one OpenMP pragma
is commented out); this module is specified by BASELINE.json's scaling
targets instead.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from ..camera.pinhole import CameraParams, primary_rays_cfg
from ..config import RenderConfig
from ..core import film
from ..integrator.wavefront import lane_groups, path_trace, path_trace_regen
from ..scene.types import Scene
from .mesh import AXIS_PIXEL, AXIS_SAMPLE


def _local_render(scene, cam, seed, s0, *, cfg: RenderConfig, n_pix_loc: int,
                  n_s_loc: int):
    """Per-device shard body: generate this device's (pixel, sample) block,
    trace it, and reduce the sample axis.

    cfg.wavefront selects the schedule (regen = lane-per-pixel
    regeneration, scan = fixed slots) — both bit-identical per sample.

    Returns (local image block (n_pix_loc, 3) after psum over dp, global
    trace count (psum over the whole mesh))."""
    w, spp = cfg.width, cfg.spp
    pix0 = jax.lax.axis_index(AXIS_PIXEL) * n_pix_loc
    samp0 = s0 + jax.lax.axis_index(AXIS_SAMPLE) * n_s_loc
    pix = pix0.astype(jnp.uint32) + jnp.arange(n_pix_loc, dtype=jnp.uint32)

    if cfg.wavefront == "regen":
        # Lanes bound to (pixel, this device's sample range); groups split
        # the range further when the local pixel block is small.
        g = lane_groups(n_pix_loc, n_s_loc, 1 << 21, cfg.regen_groups)
        per = n_s_loc // g
        lane_pix = jnp.repeat(pix, g)
        s_start = samp0.astype(jnp.uint32) + jnp.tile(
            jnp.arange(g, dtype=jnp.uint32) * jnp.uint32(per), n_pix_loc
        )
        L, n_traces = path_trace_regen(
            scene, cfg, seed, cam, lane_pix, s_start,
            s_start + jnp.uint32(per),
        )
        img_loc = L.reshape(n_pix_loc, g, 3).sum(axis=1)
    else:
        s = samp0.astype(jnp.uint32) + jnp.arange(n_s_loc, dtype=jnp.uint32)
        path_id = (pix[:, None] * jnp.uint32(spp) + s[None, :]).reshape(-1)
        px = jnp.broadcast_to(
            (pix[:, None] % jnp.uint32(w)).astype(jnp.int32),
            (n_pix_loc, n_s_loc),
        ).reshape(-1)
        py = jnp.broadcast_to(
            (pix[:, None] // jnp.uint32(w)).astype(jnp.int32),
            (n_pix_loc, n_s_loc),
        ).reshape(-1)

        from ..core import ld, rng

        uniform = ld.make_uniform_cfg(
            cfg, rng.make_uniform_fn(cfg.rng_backend)
        )
        o, d = primary_rays_cfg(cam, cfg, px, py, path_id, seed, uniform)

        L, n_traces = path_trace(scene, cfg, seed, o, d, path_id)
        img_loc = L.reshape(n_pix_loc, n_s_loc, 3).sum(axis=1)

    img_loc = jax.lax.psum(img_loc, AXIS_SAMPLE)
    n_traces = jax.lax.psum(n_traces, (AXIS_PIXEL, AXIS_SAMPLE))
    return img_loc, n_traces


@partial(jax.jit, static_argnums=(2, 4, 5))
def render_chunk_sharded(scene: Scene, cam: CameraParams, cfg: RenderConfig,
                         seed, n_s: int, mesh, s0):
    """Sharded radiance sum over sample indices [s0, s0+n_s) of every pixel.

    Returns ((h*w, 3) radiance sum — sharded over sp — and total traces)."""
    n_sp = mesh.shape[AXIS_PIXEL]
    n_dp = mesh.shape[AXIS_SAMPLE]
    n_pix = cfg.width * cfg.height
    if n_pix % n_sp:
        raise ValueError(f"pixels ({n_pix}) not divisible by sp={n_sp}")
    if n_s % n_dp:
        raise ValueError(f"chunk spp ({n_s}) not divisible by dp={n_dp}")

    body = partial(
        _local_render,
        cfg=cfg,
        n_pix_loc=n_pix // n_sp,
        n_s_loc=n_s // n_dp,
    )
    img, n_traces = jax.shard_map(
        body,
        mesh=mesh,
        in_specs=(P(), P(), P(), P()),
        out_specs=(P(AXIS_PIXEL), P()),
        # The wavefront while_loop carry mixes device-invariant constants
        # (T=1, L=0) with axis_index-derived state; skip the
        # varying-manual-axes check rather than pvary-ing every leaf.
        check_vma=False,
    )(scene, cam, seed, s0)
    return img, n_traces


def spp_chunk_for_mesh(cfg: RenderConfig, mesh) -> int:
    """Per-pass sample count: the config's chunk policy, made divisible by
    the dp axis (the wavefront budget is per-mesh, so scale by device count)."""
    n_dp = mesh.shape[AXIS_SAMPLE]
    n_dev = n_dp * mesh.shape[AXIS_PIXEL]
    budget = max(1, (n_dev << 22) // max(1, cfg.width * cfg.height))
    chunk = cfg.spp_chunk or budget
    chunk = min(chunk, cfg.spp)
    chunk = max(n_dp, (chunk // n_dp) * n_dp)
    return chunk


def render_sharded(scene: Scene, cam: CameraParams, cfg: RenderConfig, mesh):
    """Full distributed render. Requires spp divisible by the dp axis size.

    Returns (linear (h, w, 3) image in [0,1], total scene-trace count)."""
    n_dp = mesh.shape[AXIS_SAMPLE]
    if cfg.spp % n_dp:
        raise ValueError(f"spp ({cfg.spp}) not divisible by dp={n_dp}")
    chunk = spp_chunk_for_mesh(cfg, mesh)
    acc = None
    traces = 0.0
    s0 = 0
    while s0 < cfg.spp:
        n_s = min(chunk, cfg.spp - s0)
        img, n_tr = render_chunk_sharded(
            scene, cam, cfg, jnp.uint32(cfg.seed), n_s, mesh, jnp.uint32(s0)
        )
        acc = img if acc is None else acc + img
        traces += float(n_tr.sum())
        s0 += n_s
    img = film.finalize((acc / cfg.spp).reshape(cfg.height, cfg.width, 3))
    if jax.process_count() > 1:
        # Multi-host: the accumulator spans non-addressable devices; gather
        # a host-local replica so callers can np.asarray / encode it
        # (exercised by tests/test_distributed.py's 2-process run).
        from jax.experimental import multihost_utils

        img = multihost_utils.process_allgather(img, tiled=True)
    return img, traces
