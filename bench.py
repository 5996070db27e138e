"""Benchmark: Mrays/s on the Cornell box (the BASELINE.md north-star metric).

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}. The
metric string names the device: JAX's device_kind and device count, and
the card's name and power limit from nvidia-smi.

Baseline: the C++ reference measured at 2.5 Mrays/s on one CPU core
(BASELINE.md, "Ray throughput"); "rays" = scene-level nearest-hit queries
(extend rays + NEE probe rays), the same event the reference counts at
/root/reference/src/smallpt.cpp:323-335.

Config: the north-star frame, Cornell box 1024x768x512spp, estimator nee,
through the forward megakernel (ops/megakernel.py). One process on one
GPU; with no GPU it exits non-zero and prints no number. Times are taken
around ``block_until_ready``; the first render (compilation) is reported
as set-up, then the best of two renders.

    python bench.py
"""

from __future__ import annotations

import json
import sys
import time

BASELINE_MRAYS = 2.5  # C++ reference, single core (BASELINE.md)
WIDTH, HEIGHT, SPP = 1024, 768, 512


def run_bench() -> dict:
    import jax

    from small_pathtracer_tpu import RenderConfig, get_scene, make_camera
    from small_pathtracer_tpu.ops.megakernel import render_pallas, trace_totals
    from small_pathtracer_tpu.utils.compile_cache import enable_compile_cache
    from small_pathtracer_tpu.utils.device_info import describe, require_gpu

    devices = require_gpu()
    enable_compile_cache()
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=SPP, estimator="nee",
                       use_pallas=True)
    scene = get_scene("cornell_box")
    cam = make_camera(aspect=WIDTH / HEIGHT)

    def once(seed):
        # One frame timed around block_until_ready: (seconds, traces).
        t0 = time.perf_counter()
        _, per_block = jax.block_until_ready(
            render_pallas(scene, cam, cfg, seed))
        dt = time.perf_counter() - t0
        return dt, float(trace_totals(per_block).sum())

    dt, _ = once(7)
    print(f"[bench] compile+first render {dt:.2f}s", file=sys.stderr,
          flush=True)
    best_dt, traces = None, 0.0
    for seed in (1, 2):
        dt, traces = once(seed)
        print(f"[bench] seed {seed}: {dt:.4f}s", file=sys.stderr, flush=True)
        best_dt = dt if best_dt is None else min(best_dt, dt)
    mrays = traces / best_dt / 1e6
    return {
        "metric": (
            f"Mrays/s (Cornell box {WIDTH}x{HEIGHT}x{SPP}spp, NEE, kernel, "
            f"{describe(devices)})"
        ),
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 2),
    }


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv:
        raise SystemExit("usage: python bench.py (it takes no arguments)")
    print(json.dumps(run_bench()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
