"""Batched 3-vector math on ``[..., 3]`` arrays.

TPU-native replacement for the reference's scalar ``V3`` struct
(/root/reference/src/vec.zig:4-157). Instead of a struct of three floats with
method-per-op, vectors are the trailing axis of ordinary jnp arrays so every op
is batched and fuses into surrounding XLA computations. Rays are represented as
separate ``origin``/``dir``/``time`` arrays rather than a Ray struct
(vec.zig:159-167); ``ray_at`` is the batched equivalent of ``Ray.at``.
"""

from __future__ import annotations

import jax.numpy as jnp

__all__ = [
    "dot",
    "norm",
    "norm2",
    "normalize",
    "cross",
    "reflect",
    "refract",
    "safe_sqrt",
    "ray_at",
    "near_zero",
    "NEAR_ZERO_TOL",
]

# Tolerance of V3.nearZero (vec.zig:107-110).
NEAR_ZERO_TOL = 1e-8


def dot(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Dot product over the trailing axis of 3-vectors (vec.zig:95-97).
    Shape [...]. Written as x + y + z, not a reduction, so every program
    (sharded or not, any batch shape) sums in the same order."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def norm2(a: jnp.ndarray) -> jnp.ndarray:
    """Squared magnitude over the trailing axis."""
    return dot(a, a)


def norm(a: jnp.ndarray) -> jnp.ndarray:
    """Magnitude (vec.zig:71-73)."""
    return jnp.sqrt(norm2(a))


def normalize(a: jnp.ndarray, eps: float = 0.0) -> jnp.ndarray:
    """Unit vector (vec.zig:75-77).

    ``eps`` guards the zero-vector case for use inside grad-traced code; with
    the default 0 it matches the reference exactly (0/0 -> nan, as in Zig).
    """
    n = norm(a)[..., None]
    if eps:
        n = jnp.maximum(n, eps)
    return a / n


def cross(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """Cross product over the trailing axis (vec.zig:99-105)."""
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return jnp.stack(
        [ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], axis=-1
    )


def reflect(d: jnp.ndarray, n: jnp.ndarray) -> jnp.ndarray:
    """Mirror reflection of ``d`` about unit normal ``n``.

    Matches material.zig:185-187: operates on the (possibly non-unit) incoming
    direction.
    """
    return d - 2.0 * dot(d, n)[..., None] * n


def refract(unit_dir: jnp.ndarray, n: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Snell refraction of a *unit* direction about unit normal ``n``.

    Matches material.zig:189-194 term for term: perpendicular component scaled
    by eta, parallel component from the remaining magnitude.
    """
    eta = jnp.asarray(eta)[..., None] if jnp.ndim(eta) else eta
    cos_theta = dot(-unit_dir, n)[..., None]
    perp = (unit_dir + cos_theta * n) * eta
    # Clamp for numerical safety at grazing/TIR boundary (caller must not rely
    # on refract output when total internal reflection applies), through a
    # NaN-safe sqrt: sqrt'(0) is inf, and inf times the zero cotangent of
    # the unused branch would put NaN into the gradient.
    par = -safe_sqrt(1.0 - norm2(perp))[..., None] * n
    return perp + par


def safe_sqrt(x: jnp.ndarray) -> jnp.ndarray:
    """sqrt(max(x, 0)) whose gradient is 0, not inf or NaN, where x <= 0."""
    pos = x > 0.0
    return jnp.where(pos, jnp.sqrt(jnp.where(pos, x, 1.0)), 0.0)


def ray_at(origin: jnp.ndarray, direction: jnp.ndarray, t: jnp.ndarray) -> jnp.ndarray:
    """Point along ray: origin + t * dir (vec.zig:164-166)."""
    return origin + t[..., None] * direction


def near_zero(a: jnp.ndarray, tol: float = NEAR_ZERO_TOL) -> jnp.ndarray:
    """All components within tolerance (vec.zig:107-110). Shape [...] bool."""
    return jnp.all(jnp.abs(a) <= tol, axis=-1)
