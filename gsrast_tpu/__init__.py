"""gsrast_tpu — a differentiable 3D Gaussian splatting framework.

Built from scratch in JAX/Pallas with the capabilities of the GSRast reference
viewer (surveyed in SURVEY.md) plus the differentiable training and multi-host
parts the reference lacks.
"""

from .camera import Camera, auto_frame, look_at, perspective
from .config import RenderConfig
from .render.api import render
from .scene.gaussians import GaussianScene, random_scene
from .scene.ply import load_ply, save_ply

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "GaussianScene",
    "RenderConfig",
    "auto_frame",
    "load_ply",
    "look_at",
    "perspective",
    "random_scene",
    "render",
    "save_ply",
]
