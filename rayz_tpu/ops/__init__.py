from .integrator import RenderConfig, render, render_jit, trace_rays
from .intersect import HitRecord, aabb_hit, intersect, intersect_spheres, intersect_triangles
from .shade import scatter, schlick_reflectance, sky_color, texture_value
from .megakernel import (render_pallas, render_pallas_sharded, scene_tables,
                         supports_scene)
from .engine import pick_engine, render_fast

__all__ = [
    "RenderConfig",
    "render",
    "render_jit",
    "render_pallas",
    "render_pallas_sharded",
    "render_fast",
    "pick_engine",
    "scene_tables",
    "supports_scene",
    "trace_rays",
    "HitRecord",
    "intersect",
    "intersect_spheres",
    "intersect_triangles",
    "aabb_hit",
    "scatter",
    "sky_color",
    "texture_value",
    "schlick_reflectance",
]
