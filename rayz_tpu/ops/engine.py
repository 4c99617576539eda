"""Render-engine dispatch: the fused GPU kernel or the XLA integrator.

* ``"pallas"`` — :func:`rayz_tpu.ops.megakernel.render_pallas`: the fused
  path-trace kernel (Pallas on Triton), compiled for the GPU; forward only.
* ``"xla"`` — :func:`rayz_tpu.ops.integrator.render`: the reference oracle
  (it also renders nested checker textures) and the reverse-mode
  differentiable path.
* ``"auto"`` — ``"pallas"`` on the GPU for every scene the kernel supports,
  ``"xla"`` otherwise.
"""

from __future__ import annotations

import jax

from .integrator import RenderConfig, render_jit
from .megakernel import is_prng_key, render_pallas, supports_scene

__all__ = ["render_fast", "pick_engine", "ENGINES"]

ENGINES = ("pallas", "xla")


def pick_engine(scene, engine: str = "auto") -> str:
    """Resolve an engine name; ``"auto"`` -> ``"pallas"`` or ``"xla"``."""
    if engine == "auto":
        on_gpu = jax.default_backend() == "gpu"
        return "pallas" if on_gpu and supports_scene(scene) else "xla"
    if engine not in ENGINES:
        raise ValueError(f"unknown engine {engine!r}; expected 'auto' or one "
                         f"of {ENGINES}")
    return engine


def render_fast(scene, camera, key, config: RenderConfig = RenderConfig(),
                engine: str = "auto", **pallas_kw):
    """Render with the fastest applicable engine (forward only).

    Equivalent in distribution to :func:`rayz_tpu.render`; use that (the XLA
    path) when gradients are needed. ``pallas_kw`` goes to
    :func:`rayz_tpu.ops.megakernel.render_pallas`.
    """
    if pick_engine(scene, engine) == "pallas":
        return render_pallas(scene, camera, key, config, **pallas_kw)
    if not is_prng_key(key):
        key = jax.random.PRNGKey(key)  # accept plain integer seeds too
    return render_jit(scene, camera, key, config)
