"""Device-mesh sharding of rendering and gradient computation.

The reference renders with a serial triple loop on one CPU core
(/root/reference/src/renderer.zig:80-97) and has no parallelism of any kind
(SURVEY.md §2). The scaling axis here is rays/pixels: the flat pixel
array is sharded over a device mesh with ``shard_map``, the scene SoA is
replicated, each device traces its pixel shard independently (embarrassingly
parallel — zero collectives in the forward render), and gradients of scene
parameters are ``psum``-reduced across the mesh for data-parallel inverse
rendering. Multi-host: the same code path with ``jax.distributed.initialize``
(see rayz_tpu.parallel.multihost).
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

try:  # JAX >= 0.6 exposes shard_map at top level
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover - older JAX
    from jax.experimental.shard_map import shard_map as _shard_map

from ..models.camera import Camera, generate_rays
from ..models.scene import Scene
from ..ops.integrator import RenderConfig, trace_rays
from ..ops.integrator import _pixel_grid

__all__ = ["make_mesh", "render_sharded", "render_sharded_jit", "AXIS"]

AXIS = "devices"


def make_mesh(devices: Optional[Sequence] = None, axis_name: str = AXIS) -> Mesh:
    """1-D mesh over all (or the given) devices.

    Rendering is embarrassingly parallel over pixels, so a flat axis is the
    right shape: the forward render has no collectives and the fit one
    gradient psum per step, and the GPUs of a host reach each other all to
    all over NVLink, so a 2-D (host, device) factorization adds nothing for
    this workload.
    """
    import numpy as np

    devs = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devs, axis_names=(axis_name,))


def _render_shard(scene: Scene, camera: Camera, key, px, py, config: RenderConfig,
                  axis_name: str):
    """Per-device body: render the local pixel shard. px/py are the LOCAL
    chunks ([P/D] each); key is replicated and folded with the device index so
    shards draw independent streams."""
    idx = jax.lax.axis_index(axis_name)
    key = jax.random.fold_in(key, idx)

    # Scan carries must be device-varying for shard_map's vma tracking: with
    # jitter off (or zero defocus) ray origins/times are replicated constants,
    # as is the radiance accumulator init, but the scan bodies rewrite them
    # from shard-local hits. pcast rejects already-varying args, so check the
    # aval first.
    def _vary(a):
        if axis_name in getattr(jax.typeof(a), "vma", frozenset()):
            return a
        return jax.lax.pcast(a, (axis_name,), to="varying")

    def sample_pass(acc, pass_key):
        k_cam, k_trace = jax.random.split(pass_key)
        o, d, tm = generate_rays(camera, px, py, k_cam if config.jitter else None)
        o, d, tm = _vary(o), _vary(d), _vary(tm)
        rad = trace_rays(scene, o, d, tm, k_trace,
                         max_depth=config.max_depth, t_min=config.t_min)
        return acc + rad, None

    acc0 = _vary(jnp.zeros((px.shape[0], 3), dtype=camera.dtype))
    acc, _ = jax.lax.scan(sample_pass, acc0, jax.random.split(key, config.spp))
    return acc / config.spp


def render_sharded(scene: Scene, camera: Camera, key, config: RenderConfig,
                   mesh: Mesh) -> jnp.ndarray:
    """Render with pixels sharded over ``mesh``; returns [H, W, 3].

    The image is padded up to a multiple of the mesh size, split into
    per-device shards, traced independently, and reassembled (the analogue of
    per-host tile ownership + host-0 gather in SURVEY.md §2's plan — under jit
    the gather is XLA's output layout, not an explicit collective).
    """
    axis_name = mesh.axis_names[0]
    n_dev = mesh.size
    h, w = camera.height, camera.width
    px, py = _pixel_grid(camera)
    n_px = h * w
    shard = -(-n_px // n_dev)
    pad = shard * n_dev - n_px
    if pad:
        px = jnp.concatenate([px, jnp.zeros((pad,), px.dtype)])
        py = jnp.concatenate([py, jnp.zeros((pad,), py.dtype)])

    fn = _shard_map(
        partial(_render_shard, config=config, axis_name=axis_name),
        mesh=mesh,
        in_specs=(P(), P(), P(), P(axis_name), P(axis_name)),
        out_specs=P(axis_name),
    )
    img = fn(scene, camera, key, px, py)
    return img[:n_px].reshape(h, w, 3)


@partial(jax.jit, static_argnames=("config", "mesh"))
def render_sharded_jit(scene: Scene, camera: Camera, key, config: RenderConfig,
                       mesh: Mesh) -> jnp.ndarray:
    return render_sharded(scene, camera, key, config, mesh)
