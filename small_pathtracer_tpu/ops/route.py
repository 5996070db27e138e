"""Where the package's Pallas kernels run, chosen from the JAX backend.

Every ``pl.pallas_call`` in ``ops/`` takes its route from
``pallas_call_kwargs``:

- ``gpu``: the Triton route (``backend="triton"``), compiled for the card.
  The route is always named: the default Pallas route on a GPU is Mosaic
  GPU, which these kernels do not target.
- ``cpu``: the Pallas interpreter. This is the only way a Pallas kernel
  runs on the CPU backend, and what the CPU test suite exercises.
- any other platform: an error. Nothing falls back silently.

The kernels are SIMT lane programs: one path per lane, the whole path
state in registers as ``while_loop`` carries, one lane per thread. A
block is ``block_lanes()`` lanes. Its while loop runs until its slowest
lane finishes, so the block size bounds the tail; the GPU constants are
the result of a sweep on an H100 (PERF.md, "Block-size sweep").
"""

from __future__ import annotations

import jax

# H100 (Triton route): lanes per block and warps per block, one lane per
# thread. The block-size sweep in PERF.md: a block's while loop runs until
# its slowest lane finishes, and the smallest block (one warp) has the
# shortest tail — 32 lanes x 1 warp beat 128 x 4 by 13% and 512 x 4 by 2x
# at the north-star frame.
GPU_BLOCK_LANES = 32
GPU_NUM_WARPS = 1

# CPU (interpreter): the interpreter runs grid steps one after another, so
# wide blocks keep the number of interpreted steps small. Per-lane results
# do not depend on the block size.
CPU_BLOCK_LANES = 4096


def platform() -> str:
    """The JAX backend the kernels run on ("gpu", "cpu", ...)."""
    return jax.default_backend()


def block_lanes(plat: str | None = None) -> int:
    plat = plat or platform()
    if plat == "gpu":
        return GPU_BLOCK_LANES
    if plat == "cpu":
        return CPU_BLOCK_LANES
    raise RuntimeError(_unsupported(plat))


def pallas_call_kwargs(plat: str | None = None) -> dict:
    """The route arguments of ``pl.pallas_call`` for this backend."""
    plat = plat or platform()
    if plat == "gpu":
        from jax.experimental.pallas import triton as pl_triton

        return dict(
            backend="triton",
            compiler_params=pl_triton.CompilerParams(
                num_warps=GPU_NUM_WARPS, num_stages=1
            ),
        )
    if plat == "cpu":
        return dict(interpret=True)
    raise RuntimeError(_unsupported(plat))


def _unsupported(plat: str) -> str:
    return (
        f"the Pallas kernels run on a GPU (Triton) or, interpreted, on the "
        f"CPU; backend {plat!r} has no route. Use the jnp renderer (drop "
        f"--pallas) on this backend."
    )
