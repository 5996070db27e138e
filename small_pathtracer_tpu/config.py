"""Render configuration.

Every compile-time (un)comment knob in the reference becomes a flag here
(SURVEY.md section 5, "Config / flag system"): resolution/spp
(smallpt.cpp:507-508), estimator choice (:339-360, :464), scene preset
(:287-311), RR start depth (:448).
"""

from __future__ import annotations

import dataclasses

ESTIMATORS = (
    "cosine",      # C11 (active in the reference)
    "uniform",     # C12, as committed: no 2*cos(theta) correction (biased; parity)
    "uniform_corrected",  # C12 with the textbook 2*cos(theta) weight (unbiased)
    "nee",         # C13: NEE-as-continuation, exact reference weights
    "mixture",     # C13 historic q<0.5 variant ("halflighthalfimportance")
    # Textbook (unbiased) next-event estimation: shadow ray + cosine
    # continuation with emission double-count suppression — the
    # "correctness over parity" NEE recommended by SURVEY section 7 hard
    # part #2. Not in the reference.
    "nee_textbook",
    # Multiple importance sampling (Veach 97 balance heuristic): the
    # nee_textbook pair of strategies — light sampling and BSDF-sampled
    # light hits — each weighted by p_own/(p_light + p_bsdf) instead of
    # the all-or-nothing double-count suppression. Strictly lower-variance
    # wherever either strategy's density dominates (e.g. vertices NEAR the
    # light, where the shadow ray's 1/t^2 weight explodes but the cosine
    # continuation finds the light reliably). Light lists supported: the
    # strategy density folds in the selection probability q_k.
    "mis",
)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    width: int = 512
    height: int = 512
    spp: int = 16               # smallpt.cpp:508
    estimator: str = "nee"      # the HEAD integrator (C13)
    mixture_q: float = 0.5      # NEE probability for estimator="mixture"
    # Light-sample mode: "intended" = full-range sampling (the author's
    # MinGW behavior and the committed renders); "glibc_overflow" =
    # bit-faithful reproduction of the int32 overflow a glibc build of the
    # reference exhibits (see sampling._glibc_overflow_offset). Applies to
    # the reference-parity continuation estimators (nee/mixture) only;
    # estimator="nee_textbook" ALWAYS samples the full light uniformly
    # (its shadow-ray weight assumes the uniform-over-area pdf, and there
    # is no reference behavior to reproduce for it).
    light_sample_mode: str = "intended"
    # Multi-emitter light-list selection (scenes with scene.lights set):
    # "power" = q_k proportional to area*luminance (power heuristic);
    # "uniform" = q_k = 1/K. Ignored for single-light scenes.
    light_select: str = "power"
    rr_start_depth: int = 5     # RR kicks in after this depth (C10, :448)
    max_bounces: int = 256      # safety cap; RR terminates a.s. (tail ~88 measured)
    spp_chunk: int = 0          # paths per device pass; 0 = auto
    regen_groups: int = 0       # lanes per pixel for wavefront="regen"; 0 = auto
    seed: int = 0
    rng_backend: str = "mix"    # "mix" | "threefry"
    # Sample-sequence generator for the variance-dominant dimensions
    # (pixel jitter, lens disk, per-bounce light point + scatter angles):
    # "random" = independent counter-hash uniforms (the reference's
    # behavior, contract C6); "sobol" = per-pixel Owen-scrambled (0,2)-
    # sequences (core/ld.py — lower MSE at equal spp, unbiased; identical
    # across schedules/sharding just like "random"). RR/mixture/selection
    # coins always stay on the hash RNG. Forward-render feature: the
    # gradient paths (fit/adjoint) sample their own forward with the hash
    # RNG regardless — unbiasedness does not depend on the primal
    # render's sampler.
    sampler: str = "random"
    use_pallas: bool = False    # fused Pallas bounce kernel (ops/)
    # Wavefront schedule: "regen" = lane-per-pixel regeneration (fast path;
    # amortizes the RR tail); "scan" = fixed slots, chunked over spp (the
    # semantics-defining reference implementation; also the AD path).
    wavefront: str = "regen"
    # Pixel reconstruction filter: "box" = the reference's uniform jitter
    # (contract C4); "tent" = original smallpt's 2-pixel triangle filter
    # (see camera.pinhole.filter_jitter). Shared by every schedule.
    pixel_filter: str = "box"
    # Thin-lens depth of field (original-smallpt-family extension; the
    # reference camera is a pure pinhole — aperture 0 reproduces it
    # bit-for-bit). aperture = lens radius in scene units; focus_dist =
    # distance from the camera origin to the focal plane along the view
    # axis (the reference's lookfrom->lookat distance is 163).
    aperture: float = 0.0
    focus_dist: float = 163.0
    # Megakernel sphere-table mode (ops/megakernel.build_kernel
    # sphere_tab): "auto" = loop the spheres through a runtime table
    # when the scene has >= SPHERE_TABLE_AUTO_MIN of them (compiled code
    # size stays O(unrolled objects); sphere geometry/material changes
    # never recompile), "on"/"off" force it. Same estimator either way,
    # statistically identical renders (grazing-hit t can differ by ulps —
    # FMA contraction, see build_kernel).
    sphere_table: str = "auto"

    def __post_init__(self):
        if self.estimator not in ESTIMATORS:
            raise ValueError(
                f"unknown estimator {self.estimator!r}; one of {ESTIMATORS}"
            )
        if self.sphere_table not in ("auto", "on", "off"):
            raise ValueError(
                f"sphere_table must be auto/on/off, got {self.sphere_table!r}"
            )
        if self.sampler not in ("random", "sobol"):
            raise ValueError(
                f"unknown sampler {self.sampler!r}; random or sobol"
            )
        if self.pixel_filter not in ("box", "tent"):
            raise ValueError(
                f"unknown pixel_filter {self.pixel_filter!r}; box or tent"
            )
        if self.aperture < 0.0 or self.focus_dist <= 0.0:
            raise ValueError(
                "aperture must be >= 0 and focus_dist > 0 "
                f"(got {self.aperture}, {self.focus_dist})"
            )

    def resolved_spp_chunk(self) -> int:
        if self.spp_chunk:
            return min(self.spp_chunk, self.spp)
        # Keep the wavefront around <= 2^22 paths per pass.
        budget = max(1, (1 << 22) // max(1, self.width * self.height))
        return max(1, min(self.spp, budget))


# sphere_table="auto" switches the megakernel to the looped sphere table at
# this many spheres (below it, full unrolling compiles fast; the crossover
# has not been measured on the GPU yet — PERF.md open questions).
SPHERE_TABLE_AUTO_MIN = 48
