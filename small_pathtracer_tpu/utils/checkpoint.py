"""Render-state checkpoint / resume.

The reference keeps the whole image in a heap array until the final write
(/root/reference/src/smallpt.cpp:510,548-551) — a crash loses everything.
Here the complete render state is tiny and exact (SURVEY.md section 5,
"Checkpoint / resume"): because samples are i.i.d. and the RNG is a pure
function of (seed, path_id, counter), the state is just

    (accumulation buffer, spp completed, trace count, config fingerprint)

and resuming = continuing the sample loop at spp_done. Bit-identical to an
uninterrupted render up to float addition order.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile

import numpy as np

import jax.numpy as jnp

from ..camera.pinhole import CameraParams
from ..config import RenderConfig
from ..core import film
from ..integrator.wavefront import lane_groups, path_trace_regen
from ..scene.types import Scene
from functools import partial

import jax


def _fingerprint(scene: Scene, cam: CameraParams, cfg: RenderConfig) -> str:
    h = hashlib.sha256()
    h.update(json.dumps(dataclasses.asdict(cfg), sort_keys=True).encode())
    for leaf in jax.tree.leaves((scene, cam)):
        h.update(np.asarray(leaf).tobytes())
    return h.hexdigest()[:32]


def save_state(path: str, acc: np.ndarray, spp_done: int, traces: float,
               fingerprint: str) -> None:
    """Atomic save (write temp + rename) of the render state."""
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".ckpt.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(
                f,
                acc=np.asarray(acc),
                spp_done=np.int64(spp_done),
                traces=np.float64(traces),
                fingerprint=np.bytes_(fingerprint.encode()),
            )
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_state(path: str, fingerprint: str):
    """Returns (acc, spp_done, traces) or None if absent/mismatched."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        if z["fingerprint"].item().decode() != fingerprint:
            return None
        return np.asarray(z["acc"]), int(z["spp_done"]), float(z["traces"])


@partial(jax.jit, static_argnums=(2, 5))
def _render_span(scene: Scene, cam: CameraParams, cfg: RenderConfig, seed,
                 s0, n_s: int):
    """Radiance sum over samples [s0, s0+n_s) of every pixel (regen
    wavefront). s0 is TRACED (a span start changes every chunk — making it
    static would recompile the wavefront per checkpoint interval).
    Returns ((h*w, 3), traces)."""
    n_pix = cfg.width * cfg.height
    g = lane_groups(n_pix, n_s, 1 << 21)
    per = n_s // g
    pix = jnp.repeat(jnp.arange(n_pix, dtype=jnp.uint32), g)
    s_start = jnp.uint32(s0) + jnp.tile(
        jnp.arange(g, dtype=jnp.uint32) * jnp.uint32(per), n_pix
    )
    L, traces = path_trace_regen(
        scene, cfg, seed, cam, pix, s_start, s_start + jnp.uint32(per)
    )
    return L.reshape(n_pix, g, 3).sum(axis=1), traces


def render_with_checkpoints(scene: Scene, cam: CameraParams,
                            cfg: RenderConfig, ckpt_path: str,
                            every_spp: int = 0, mesh=None,
                            preview_path: str = ""):
    """Chunked render that saves resumable state every ``every_spp`` samples
    (0 = only at completion) and resumes from ``ckpt_path`` if present.

    Composes with every render path: mesh (sharded span renders, psum over
    the sample axis, single-host save of the gathered accumulator) and
    cfg.use_pallas (megakernel spans — the kernel's per-lane s_start/s_stop
    work assignment IS a span; s0 is a traced input so the loop compiles
    once per span size). Because per-sample radiance is a pure function of
    (seed, path_id, counter), a resumed render equals an uninterrupted one
    up to float accumulation order on every path.

    With ``preview_path`` set, the tonemapped running mean (acc / spp_done —
    an unbiased estimate of the final image at every chunk) is written there
    after each span: the "intermediate dumps every K spp" observability the
    reference lacks (SURVEY.md section 5, Metrics row; the reference holds
    the image in memory until the one final write, smallpt.cpp:548-551).
    ``ckpt_path`` may be "" for a progressive render with no resume state.

    Returns (finalized (h, w, 3) image, total traces)."""
    fp = _fingerprint(scene, cam, cfg)
    st = load_state(ckpt_path, fp) if ckpt_path else None
    if st is not None:
        acc, spp_done, traces = st
    else:
        acc = np.zeros((cfg.width * cfg.height, 3), np.float32)
        spp_done, traces = 0, 0.0

    step = every_spp if every_spp > 0 else cfg.spp
    if mesh is not None:
        # Spans must stay divisible by the sample-parallel axis.
        from ..parallel.mesh import AXIS_SAMPLE

        n_dp = mesh.shape[AXIS_SAMPLE]
        if cfg.spp % n_dp:
            raise ValueError(f"spp ({cfg.spp}) not divisible by dp={n_dp}")
        step = max(n_dp, (step // n_dp) * n_dp)
    seed = jnp.uint32(cfg.seed)
    while spp_done < cfg.spp:
        n_s = min(step, cfg.spp - spp_done)
        if cfg.use_pallas and mesh is not None:
            from ..ops.megakernel import render_pallas_sharded, trace_totals

            L, tr = render_pallas_sharded(
                scene, cam, cfg, mesh, seed, s0=spp_done, n_s=n_s
            )
            tr = trace_totals(tr)
        elif cfg.use_pallas:
            from ..ops.megakernel import render_pallas_span, trace_totals

            L, tr = render_pallas_span(
                scene, cam, cfg, seed, jnp.uint32(spp_done), n_s
            )
            tr = trace_totals(tr)
        elif mesh is not None:
            from ..parallel.sharded import render_chunk_sharded

            L, tr = render_chunk_sharded(
                scene, cam, cfg, seed, n_s, mesh, jnp.uint32(spp_done)
            )
        else:
            L, tr = _render_span(
                scene, cam, cfg, seed, jnp.uint32(spp_done), n_s
            )
        if mesh is not None and jax.process_count() > 1:
            # Multi-host: span images are sharded over non-addressable
            # devices; gather a host-local replica before the numpy
            # accumulate/save (same fix as parallel.sharded.render_sharded).
            from jax.experimental import multihost_utils

            L = multihost_utils.process_allgather(L, tiled=True)
        acc = acc + np.asarray(L).reshape(-1, 3)
        traces += float(tr.sum())
        spp_done += n_s
        if ckpt_path:
            save_state(ckpt_path, acc, spp_done, traces, fp)
        if preview_path and (jax.process_index() == 0):
            _write_preview(preview_path, acc, spp_done, cfg)

    img = (acc / cfg.spp).reshape(cfg.height, cfg.width, 3)
    return film.finalize(jnp.asarray(img)), traces


def _write_preview(path: str, acc: np.ndarray, spp_done: int,
                   cfg: RenderConfig) -> None:
    """Atomic write of the tonemapped running-mean image (PPM or, via
    core.imageio, PNG). Partial means are unbiased — each preview is the
    final image at spp_done samples, so previews visibly converge."""
    img = jnp.asarray(
        (acc / float(spp_done)).reshape(cfg.height, cfg.width, 3)
    )
    u8 = np.asarray(film.tonemap_u8(film.finalize(img)))
    d = os.path.dirname(os.path.abspath(path)) or "."
    # Atomic replace: a watcher polling the preview never sees a torn file.
    ext = os.path.splitext(path)[1]
    fd, tmp = tempfile.mkstemp(dir=d, suffix=ext + ".tmp")
    os.close(fd)
    try:
        if ext == ".ppm":
            film.write_ppm(tmp, u8)
        else:
            from ..core.imageio import write_image

            write_image(tmp, u8, ext)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
