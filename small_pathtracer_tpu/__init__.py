"""small_pathtracer_tpu — a differentiable path tracer (JAX; Pallas on the GPU).

Brand-new JAX/XLA/Pallas framework with the capabilities of
maurock/small-pathtracer (a smallpt-derived C++ CPU renderer); see SURVEY.md
for the structural analysis of the reference and the behavioral contract
(C1-C18) this package reproduces.
"""

__version__ = "0.1.0"

from .config import ESTIMATORS, RenderConfig
from .camera.pinhole import CameraParams, make_camera
from .scene.presets import get_scene
from .scene.types import Scene
from .integrator.wavefront import render, render_counts
from .models import MODELS, RenderModel, get_model

__all__ = [
    "ESTIMATORS",
    "MODELS",
    "RenderConfig",
    "RenderModel",
    "CameraParams",
    "make_camera",
    "get_model",
    "get_scene",
    "Scene",
    "render",
    "render_counts",
]
