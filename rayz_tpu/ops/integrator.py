"""Path-tracing integrator: fixed-depth scan over bounces + render loop.

TPU-native replacement for the reference's recursive ``bounceRay`` and the
row/col/sample triple loop (/root/reference/src/renderer.zig:72-126). The
recursion is tail-like with pure multiplicative accumulation, so it becomes a
``lax.scan`` over bounce depth with per-ray state (origin, direction, time,
throughput, radiance, active mask) — SURVEY.md §7 design delta #2. Reverse-mode
AD through the scan yields the backward bounce sweep.

Semantics parity with bounceRay (renderer.zig:103-126):
  - depth exhausted -> black (rays still active after max_depth contribute 0)
  - absorbed (metal below horizon) -> black (throughput zeroed, ray dies)
  - miss -> sky color weighted by accumulated throughput, ray dies
  - scatter -> throughput *= attenuation; new origin = hit point; time kept
The reference's t_min is 1e-10 in f64 (renderer.zig:107); in f32 that invites
shadow acne, so the default here is 1e-3 (RTIOW's own choice) — configurable.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp

from ..models.camera import Camera, generate_rays
from ..models.scene import Scene
from .intersect import intersect
from .shade import scatter, sky_color

__all__ = ["RenderConfig", "trace_rays", "render", "render_jit"]


class RenderConfig(NamedTuple):
    """Static render settings (hashable: safe as a jit static arg).

    Defaults mirror the reference Tracer fields (renderer.zig:23-24:
    max_bounces=50, samples_per_px=10).
    """

    spp: int = 10
    max_depth: int = 50
    t_min: float = 1e-3
    # Rays processed per inner chunk; None = all pixels at once. Chunking
    # bounds the [chunk, N_primitives] intermediates' memory footprint.
    chunk_size: Optional[int] = None
    jitter: bool = True
    # Rematerialize each bounce in the backward pass (SURVEY.md §7 "backward
    # memory"): without it, reverse-mode AD stores every bounce's per-ray
    # intermediates for every sample pass at once — O(spp * depth * R)
    # device memory. With it, residuals are only the O(R) per-bounce ray
    # state and the backward sweep recomputes each bounce, including its
    # dense nearest-hit search. No effect on forward-only renders.
    remat: bool = True


def trace_rays(scene: Scene, origin, direction, time, key, *, max_depth: int,
               t_min: float, remat: bool = True) -> jnp.ndarray:
    """Trace a batch of rays to radiance [R, 3]; batched bounceRay."""
    dt = origin.dtype
    shape = time.shape
    # Derive the carry inits arithmetically from the inputs (rather than fresh
    # constants) so they inherit the inputs' varying-manual-axes state under
    # shard_map — a constant init vs. a varying body output is a scan error.
    zero3 = origin - origin
    throughput = zero3 + jnp.ones((*shape, 3), dtype=dt)
    radiance = zero3
    active = (time - time) == 0.0

    def step(state, bounce_key):
        o, d, tm, thr, rad, act = state
        hit = intersect(scene, o, d, tm, t_min)

        # Miss -> sky, weighted by throughput; ray dies (renderer.zig:124-125).
        miss_now = act & ~hit.hit
        rad = rad + jnp.where(miss_now[..., None], thr * sky_color(d), 0.0)

        new_dir, att, scattered = scatter(bounce_key, scene, d, tm, hit)
        cont = act & hit.hit & scattered
        thr = jnp.where(cont[..., None], thr * att, thr)
        o = jnp.where(cont[..., None], hit.point, o)
        d = jnp.where(cont[..., None], new_dir, d)
        # time is inherited by scattered rays (material.zig:93,:122,:156)
        return (o, d, tm, thr, rad, cont), None

    keys = jax.random.split(key, max_depth)
    body = jax.checkpoint(step) if remat else step
    (_, _, _, _, radiance, _), _ = jax.lax.scan(
        body, (origin, direction, time, throughput, radiance, active), keys
    )
    return radiance


def _pixel_grid(camera: Camera):
    """Flat pixel coordinate arrays [H*W] in the reference's layout: x = column
    i, y = row j, index j*W + i (renderer.zig:80-96, image.zig:26)."""
    xs = jnp.arange(camera.width, dtype=jnp.int32)
    ys = jnp.arange(camera.height, dtype=jnp.int32)
    gx, gy = jnp.meshgrid(xs, ys)  # [H, W]
    return gx.reshape(-1), gy.reshape(-1)


def render(scene: Scene, camera: Camera, key, config: RenderConfig = RenderConfig()) -> jnp.ndarray:
    """Full render to a [H, W, 3] linear-RGB image; batched Tracer.render
    (renderer.zig:72-101): for each sample, generate camera rays, trace, and
    average over samples_per_px."""
    h, w = camera.height, camera.width
    px, py = _pixel_grid(camera)
    n_px = h * w

    chunk = config.chunk_size or n_px
    if chunk > n_px:
        chunk = n_px
    n_chunks = -(-n_px // chunk)
    pad = n_chunks * chunk - n_px
    if pad:
        px = jnp.concatenate([px, jnp.zeros((pad,), px.dtype)])
        py = jnp.concatenate([py, jnp.zeros((pad,), py.dtype)])
    px_c = px.reshape(n_chunks, chunk)
    py_c = py.reshape(n_chunks, chunk)

    def trace_chunk(args):
        x, y, ckey = args
        k_cam, k_trace = jax.random.split(ckey)
        o, d, tm = generate_rays(camera, x, y, k_cam if config.jitter else None)
        return trace_rays(
            scene, o, d, tm, k_trace,
            max_depth=config.max_depth, t_min=config.t_min,
            remat=config.remat,
        )

    if config.remat:
        # Checkpoint each (sample pass, chunk): the spp scan and chunk map
        # otherwise store every pass's per-bounce carries — O(spp * depth * R)
        # device memory. With this, a pass's residual is just its inputs, and its trace
        # is recomputed transiently during the backward sweep.
        trace_chunk = jax.checkpoint(trace_chunk)

    def sample_pass(acc, pass_key):
        ckeys = jax.random.split(pass_key, n_chunks)
        if n_chunks == 1:
            rad = trace_chunk((px_c[0], py_c[0], ckeys[0]))[None]
        else:
            rad = jax.lax.map(trace_chunk, (px_c, py_c, ckeys))
        return acc + rad.reshape(-1)[: n_px * 3], None

    acc0 = jnp.zeros((n_px * 3,), dtype=camera.dtype)
    img, _ = jax.lax.scan(sample_pass, acc0, jax.random.split(key, config.spp))
    return (img / config.spp).reshape(h, w, 3)


@partial(jax.jit, static_argnames=("config",))
def render_jit(scene: Scene, camera: Camera, key, config: RenderConfig) -> jnp.ndarray:
    return render(scene, camera, key, config)
