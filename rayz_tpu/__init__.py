"""rayz_tpu — a differentiable path tracer in JAX/XLA/Pallas for the GPU.

A framework with the capability set of the Zig CPU ray tracer
``jlucier/rayz`` (see SURVEY.md): flat SoA scenes, dense elementwise
intersection, masked material dispatch, a fixed-depth scan integrator
differentiable in reverse mode, pixel sharding over device meshes, and a
fused Pallas (Triton) path-trace kernel for the forward pass.
"""

from .models import (
    Camera,
    Scene,
    SceneBuilder,
    generate_rays,
    make_camera,
)
from .models import scenes
from .ops import (RenderConfig, render, render_fast, render_jit, render_pallas,
                  render_pallas_sharded, trace_rays)
from .io import read_ppm, to_u8, write_png, write_ppm

__version__ = "0.1.0"

__all__ = [
    "Camera",
    "Scene",
    "SceneBuilder",
    "make_camera",
    "generate_rays",
    "scenes",
    "RenderConfig",
    "render",
    "render_jit",
    "render_fast",
    "render_pallas",
    "render_pallas_sharded",
    "trace_rays",
    "to_u8",
    "write_ppm",
    "write_png",
    "read_ppm",
]
