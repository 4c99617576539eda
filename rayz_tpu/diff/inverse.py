"""Inverse rendering: recover scene parameters by gradient descent on pixels.

The reference is forward-only; differentiability is this framework's headline
extension (BASELINE.json north star + config 5: recover albedo and sphere
positions of a 100-sphere scene via Adam on pixel L2). The renderer's scan
integrator is reverse-mode differentiable end to end: gradients flow through
hit distances (the quadratic roots are smooth in center/radius), hit points,
scatter attenuation (textures/albedo), and the sky; discrete events (hit/miss
boundaries, checker parity, Schlick coin flips, metal absorption) contribute
zero gradient almost everywhere — correct a.e., noisy exactly at silhouettes
(SURVEY.md §7 "hard parts", documented acceptance).

GEOMETRY-GRADIENT CAVEAT: the reference-default HEMISPHERE diffuse scatter
(material.zig:81-84) has direction ``s * sign(s . n)`` — piecewise constant
in the surface normal — so in scenes lit only by the sky through hemisphere-
diffuse bounces, gradients to sphere centers/radii/triangle vertices are zero
almost everywhere and positions CANNOT be recovered by gradient descent.
Build inverse-rendering scenes with ``add_diffuse(method=DIFFUSE_UNIT_SPHERE)``
(``n + s``, smooth in the normal) or metal/dielectric materials; see
``rayz_tpu.scenes.sphere_grid`` (the config-5 scene) and
tests/test_grad.py::test_hemisphere_diffuse_geometry_grad_is_zero_ae.

Data-parallel training: pixels sharded over the mesh, scene/params replicated,
per-device partial losses/grads ``psum``-reduced — the psum is XLA-scheduled to
overlap with the backward sweep.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import optax
from jax.sharding import Mesh, PartitionSpec as P

try:
    from jax import shard_map as _shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map as _shard_map

from ..models.camera import Camera
from ..models.scene import Scene
from ..ops.integrator import RenderConfig, render, _pixel_grid
from ..parallel.mesh import _render_shard

__all__ = [
    "DEFAULT_TRAINABLE",
    "extract_params",
    "inject_params",
    "pixel_loss",
    "make_train_step",
    "fit",
]

# Differentiable scene leaves (SURVEY.md §7 delta #1): geometry, albedo,
# roughness, IOR. NOTE: SceneBuilder.add_dielectric dedups equal-IOR
# dielectrics by default, so shared dielectrics train as ONE mat_ior entry;
# build with add_dielectric(..., share=False) to fit them independently.
DEFAULT_TRAINABLE = (
    "sphere_center",
    "sphere_radius",
    "tri_v0",
    "tri_v1",
    "tri_v2",
    "tex_color",
    "mat_fuzz",
    "mat_ior",
)


def extract_params(scene: Scene, fields: Sequence[str] = DEFAULT_TRAINABLE) -> Dict[str, jnp.ndarray]:
    return {f: getattr(scene, f) for f in fields}


def inject_params(scene: Scene, params: Dict[str, jnp.ndarray]) -> Scene:
    return scene.replace(**params)


#: Gradient engines. "dense" differentiates through the XLA scan integrator.
GRAD_ENGINES = ("dense",)


def _check_engine(engine: str) -> None:
    if engine not in GRAD_ENGINES:
        raise ValueError(f"unknown gradient engine {engine!r}; expected one "
                         f"of {GRAD_ENGINES}")


def pixel_loss(params, scene: Scene, camera: Camera, key, target,
               config: RenderConfig, engine: str = "dense"):
    """Mean squared pixel error of a fresh stochastic render vs target.

    ``engine="dense"`` differentiates through the full scan integrator (any
    scene). Its backward is O(R) per bounce in the nearest-hit search
    (``intersect._winner_t``) plus a recomputed forward sweep under remat.
    """
    _check_engine(engine)
    img = render(inject_params(scene, params), camera, key, config)
    return jnp.mean((img - target.reshape(img.shape)) ** 2)


def make_train_step(optimizer: optax.GradientTransformation, config: RenderConfig,
                    mesh: Optional[Mesh] = None, engine: str = "dense"):
    """Build a jitted Adam/SGD step: (params, opt_state, scene, camera, key,
    target) -> (params, opt_state, loss).

    With a mesh, pixels+target are sharded across devices, each device
    renders + backprops its shard, and the parameter gradient is psum-reduced
    (replicated params, data-parallel pixels); per-device RNG streams come
    from folding the step key with the device index.
    """
    _check_engine(engine)
    if mesh is None:

        @jax.jit
        def step(params, opt_state, scene, camera, key, target):
            loss, grads = jax.value_and_grad(pixel_loss)(
                params, scene, camera, key, target, config, engine)
            updates, opt_state = optimizer.update(grads, opt_state, params)
            params = optax.apply_updates(params, updates)
            return params, opt_state, loss

        return step

    axis = mesh.axis_names[0]

    def _loss_grad_shard(params, scene, camera, key, px, py, tgt, weight):
        def local_loss(p):
            img = _render_shard(inject_params(scene, p), camera, key, px, py,
                                config, axis)
            return jnp.sum(weight[:, None] * (img - tgt) ** 2)

        l, g = jax.value_and_grad(local_loss)(params)
        # params are replicated (mesh-invariant) and the loss is per-shard,
        # so the implicit pvary between them transposes to a psum: ``g`` is
        # already the mesh-wide gradient. A second psum would scale it by
        # the device count.
        return jax.lax.psum(l, axis), g

    sharded_lg = _shard_map(
        _loss_grad_shard,
        mesh=mesh,
        in_specs=(P(), P(), P(), P(), P(axis), P(axis), P(axis), P(axis)),
        out_specs=(P(), P()),
    )

    @jax.jit
    def step(params, opt_state, scene, camera, key, target):
        h, w = camera.height, camera.width
        px, py = _pixel_grid(camera)
        tgt = target.reshape(h * w, 3)
        n_px = h * w
        n_dev = mesh.size
        shard = -(-n_px // n_dev)
        pad = shard * n_dev - n_px
        weight = jnp.ones((n_px,), dtype=tgt.dtype)
        if pad:
            px = jnp.concatenate([px, jnp.zeros((pad,), px.dtype)])
            py = jnp.concatenate([py, jnp.zeros((pad,), py.dtype)])
            tgt = jnp.concatenate([tgt, jnp.zeros((pad, 3), tgt.dtype)])
            # padding pixels render real values but must not contribute loss
            # or gradient — weight them to zero.
            weight = jnp.concatenate([weight, jnp.zeros((pad,), weight.dtype)])
        loss_sum, grads = sharded_lg(params, scene, camera, key, px, py, tgt,
                                     weight)
        # per-shard losses are SUMS (psum-reducible); normalize loss AND
        # grads to the MEAN so step sizes match the single-device pixel_loss
        # exactly (same lr semantics on and off the mesh).
        denom = n_px * 3
        loss = loss_sum / denom
        grads = jax.tree_util.tree_map(lambda g: g / denom, grads)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step


def fit(scene: Scene, camera: Camera, target, *, config: RenderConfig,
        steps: int = 200, learning_rate: float = 1e-2,
        fields: Sequence[str] = DEFAULT_TRAINABLE,
        mesh: Optional[Mesh] = None, key=None,
        callback=None, engine: str = "dense",
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 50) -> Tuple[Scene, list]:
    """Run Adam on pixel L2 against ``target``; returns (fitted scene,
    loss history). ``engine`` as in :func:`pixel_loss`, on both the
    single-device and the mesh path.

    With ``checkpoint_dir``, the trainable params + optimizer state + RNG key
    are saved (:mod:`rayz_tpu.diff.checkpoint`) every ``checkpoint_every``
    steps and at the end; if the directory already holds a checkpoint, the
    fit RESUMES from its ``latest_step`` and reproduces the exact trajectory
    an uninterrupted run would have taken (the step key is part of the
    checkpoint). ``steps`` counts total steps including resumed ones; the
    returned history covers only the steps run by this call.
    """
    if key is None:
        key = jax.random.PRNGKey(0)
    params = extract_params(scene, fields)
    optimizer = optax.adam(learning_rate)
    opt_state = optimizer.init(params)
    start = 0
    if checkpoint_dir is not None:
        from . import checkpoint as ckpt

        if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
            # serialize-friendly raw key data (same stream under split)
            key = jax.random.key_data(key)
        last = ckpt.latest_step(checkpoint_dir)
        if last is not None:
            template = {"params": params, "opt_state": opt_state,
                        "key": key, "step": 0}
            st = ckpt.restore_checkpoint(checkpoint_dir, template, last)
            params = st["params"]
            opt_state = st["opt_state"]
            key = jnp.asarray(st["key"])
            start = int(st["step"])
    step_fn = make_train_step(optimizer, config, mesh, engine=engine)
    history = []
    for i in range(start, steps):
        key, sub = jax.random.split(key)
        params, opt_state, loss = step_fn(params, opt_state, scene, camera,
                                          sub, target)
        history.append(float(loss))
        if callback is not None:
            callback(i, float(loss), params)
        if checkpoint_dir is not None and (
                (i + 1) % checkpoint_every == 0 or i + 1 == steps):
            ckpt.save_checkpoint(checkpoint_dir, i + 1, {
                "params": params, "opt_state": opt_state,
                "key": key, "step": i + 1})
    return inject_params(scene, params), history
