"""Device mesh construction for distributed rendering.

The reference has no parallelism at all (its OpenMP row pragma is commented
out, /root/reference/src/smallpt.cpp:526 — SURVEY.md C18). The workload's two
parallel axes are the image (pixels) and samples-per-pixel; we map them onto a
2-D logical mesh:

    axis "sp" — shards pixels (the "sequence/spatial-parallel" analogue),
    axis "dp" — shards samples per pixel (the data-parallel analogue).

Per-pixel radiance partial sums reduce over "dp" with one ``psum``; scene
parameters are tiny (17 objects) and stay replicated, so scene-gradient
all-reduce is a single small ``psum`` over the whole mesh.
"""

from __future__ import annotations

import math

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

AXIS_PIXEL = "sp"
AXIS_SAMPLE = "dp"


def make_mesh(
    devices=None,
    mesh_shape: tuple[int, int] | None = None,
) -> Mesh:
    """Build a (sp, dp) mesh over ``devices`` (default: all local devices).

    mesh_shape: (n_sp, n_dp); default factors the device count as evenly as
    possible, favoring the pixel axis (pixel sharding needs no collective in
    the forward pass).
    """
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if mesh_shape is None:
        n_dp = 1
        for cand in range(int(math.isqrt(n)), 0, -1):
            if n % cand == 0:
                n_dp = cand
                break
        mesh_shape = (n // n_dp, n_dp)
    assert mesh_shape[0] * mesh_shape[1] == n, (mesh_shape, n)
    dev_grid = np.asarray(devices).reshape(mesh_shape)
    return Mesh(dev_grid, (AXIS_PIXEL, AXIS_SAMPLE))


def grid_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for (pixel, sample, ...) path-state arrays."""
    return NamedSharding(mesh, P(AXIS_PIXEL, AXIS_SAMPLE))


def image_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for a flattened-pixel image: pixels split over sp, replicated
    over dp."""
    return NamedSharding(mesh, P(AXIS_PIXEL))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
