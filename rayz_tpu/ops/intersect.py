"""Batched ray/primitive intersection.

Replaces the reference's per-ray recursive BVH traversal with vtable dispatch
(/root/reference/src/hit.zig:181-216, geom.zig:38-66). Every ray tests every
primitive as one dense elementwise [R, N] sweep (offsets ``c - o`` per
component, then dot products) that XLA fuses with the min-reduction for the
nearest hit, so no [R, N] array reaches device memory. Hit attributes
(point/normal/material) are computed only for the winning primitive via
[R]-sized gathers, and the hit distance's gradient comes from the winner's
root recomputed from gathered parameters (``_winner_t``).

The nearest-hit semantics match the reference exactly: the BVH's
shrinking-tmax traversal (hit.zig:197-214) computes the same argmin over
primitives that the dense reduction computes here.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..models.scene import Scene
from ..utils import vec

__all__ = ["HitRecord", "intersect", "intersect_spheres",
           "intersect_triangles", "aabb_hit", "aabb_enclose",
           "aabb_longest_axis", "sphere_aabb"]

# Primitive kind codes in HitRecord.kind
PRIM_SPHERE = 0
PRIM_TRIANGLE = 1


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class HitRecord:
    """SoA equivalent of the reference Hit (hit.zig:16-42), batched over rays.

    ``normal`` is already flipped to oppose the ray (front-face convention of
    Hit.init, hit.zig:31-34); ``front_face`` records which side was hit.
    """

    t: jnp.ndarray  # [R]
    point: jnp.ndarray  # [R, 3]
    normal: jnp.ndarray  # [R, 3] unit, opposing the ray
    front_face: jnp.ndarray  # [R] bool
    material: jnp.ndarray  # [R] int32
    hit: jnp.ndarray  # [R] bool


def _sphere_t(ocx, ocy, ocz, dx, dy, dz, a, r2, t_min, t_max):
    """Nearest root in [t_min, t_max] of |o + t d - c|^2 = r^2, +inf on a
    miss, from the offset ``oc = c - o`` per component; broadcasts, so it
    serves the dense [R, N] sweep and the per-ray winner alike.

    Quadratic with the half-b optimization, matching Sphere.hitInner
    (geom.zig:38-66): ``half_b = d.(c - o)``, roots (half_b -+ sqrt(disc))/a,
    the second root only if the first is out of range; only disc < 0 misses
    (geom.zig:49-50)."""
    half_b = dx * ocx + dy * ocy + dz * ocz
    c_term = ocx * ocx + ocy * ocy + ocz * ocz - r2
    disc = half_b * half_b - a * c_term
    inv_a = 1.0 / a
    rt = vec.safe_sqrt(disc)  # sqrt'(0+) is inf: keep NaN out of the AD
    t1 = (half_b - rt) * inv_a
    t2 = (half_b + rt) * inv_a
    t1_ok = (t1 >= t_min) & (t1 <= t_max)
    t2_ok = (t2 >= t_min) & (t2 <= t_max)
    t = jnp.where(t1_ok, t1, jnp.where(t2_ok, t2, jnp.inf))
    return jnp.where(disc >= 0.0, t, jnp.inf)


def _winner_t(t_all, t_winner):
    """Nearest-hit distance from the dense sweep ``t_all`` [R, P], with the
    gradient of ``t_winner`` [R] (the winner's root recomputed from gathered
    parameters). The value is exactly the sweep's minimum; the derivative is
    the winner's, which is what differentiating the minimum gives. So the
    backward pass is O(R): it never touches the [R, P] sweep."""
    sg = jax.lax.stop_gradient
    t_near = sg(jnp.min(t_all, axis=1))
    ok = jnp.isfinite(t_near) & jnp.isfinite(t_winner)
    delta = jnp.where(ok, t_winner, 0.0)
    return t_near + (delta - sg(delta))


def intersect_spheres(scene: Scene, origin, direction, time, t_min, t_max):
    """Nearest sphere hit per ray, as one elementwise [R, N] sweep that XLA
    fuses with its min-reduction. Moving centers: center(t) = center0 +
    t * velocity (geom.zig:40 via Ray-stored centers).

    Returns (t [R], idx [R] int32) with t = +inf on miss.
    """
    sg = jax.lax.stop_gradient
    o, d, tm = sg(origin), sg(direction), sg(time)
    c, vel, r = sg(scene.sphere_center), sg(scene.sphere_velocity), \
        sg(scene.sphere_radius)

    def offset(k):  # (c - o)_k as [R, N]
        ck = c[None, :, k]
        if scene.has_motion:
            ck = ck + tm[:, None] * vel[None, :, k]
        return ck - o[:, k:k + 1]

    t_all = _sphere_t(offset(0), offset(1), offset(2), d[:, 0:1], d[:, 1:2],
                      d[:, 2:3], vec.norm2(d)[:, None], (r * r)[None, :], t_min,
                      t_max)
    t_all = jnp.where(scene.sphere_valid[None, :], t_all, jnp.inf)
    idx = jnp.argmin(t_all, axis=1).astype(jnp.int32)

    cw = scene.sphere_center[idx]
    if scene.has_motion:
        cw = cw + time[:, None] * scene.sphere_velocity[idx]
    oc = cw - origin
    rw = scene.sphere_radius[idx]
    t_w = _sphere_t(oc[:, 0], oc[:, 1], oc[:, 2], direction[:, 0],
                    direction[:, 1], direction[:, 2],
                    vec.norm2(direction), rw * rw, t_min, t_max)
    return _winner_t(t_all, t_w), idx


def _triangle_frame(scene: Scene):
    """Per-triangle plane normal and dual basis of the edge frame, so that
    the barycentrics of a point p are u = g1.(p - v0), v = g2.(p - v0). All
    [M]-sized; cheap and kept in-graph so gradients flow to the vertices."""
    e1 = scene.tri_v1 - scene.tri_v0  # [M,3]
    e2 = scene.tri_v2 - scene.tri_v0
    n = vec.cross(e1, e2)  # [M,3] unnormalized plane normal
    d11 = vec.dot(e1, e1)
    d12 = vec.dot(e1, e2)
    d22 = vec.dot(e2, e2)
    den = d11 * d22 - d12 * d12
    inv_den = jnp.where(den != 0.0, 1.0 / jnp.where(den != 0.0, den, 1.0), 0.0)
    g1 = (e1 * d22[:, None] - e2 * d12[:, None]) * inv_den[:, None]  # [M,3]
    g2 = (e2 * d11[:, None] - e1 * d12[:, None]) * inv_den[:, None]
    return n, g1, g2


def _triangle_t(w, n, g1, g2, d, t_min, t_max):
    """Nearest (double-sided) hit distance of rays with directions ``d`` on
    triangles with plane normals ``n``, dual bases ``g1``/``g2`` and offsets
    ``w = v0 - o``, each a tuple of three broadcastable components; +inf on
    a miss. Plane first, then the barycentrics of the hit point."""
    n_dot_d = d[0] * n[0] + d[1] * n[1] + d[2] * n[2]
    parallel = n_dot_d == 0.0
    t = (n[0] * w[0] + n[1] * w[1] + n[2] * w[2]) / jnp.where(
        parallel, 1.0, n_dot_d)
    h = [t * d[k] - w[k] for k in range(3)]  # p - v0
    u = g1[0] * h[0] + g1[1] * h[1] + g1[2] * h[2]
    v = g2[0] * h[0] + g2[1] * h[1] + g2[2] * h[2]
    ok = ((~parallel) & (t >= t_min) & (t <= t_max) & (u >= 0.0)
          & (v >= 0.0) & (u + v <= 1.0))
    return jnp.where(ok, t, jnp.inf)


def intersect_triangles(scene: Scene, origin, direction, time, t_min, t_max):
    """Nearest (double-sided) triangle hit per ray, as one elementwise
    [R, M] sweep. Equivalent to Moller-Trumbore for non-degenerate
    triangles. Capability beyond the spheres-only reference (BASELINE
    config 4).

    Returns (t [R], idx [R] int32) with t = +inf on miss.
    """
    del time  # triangles are static
    sg = jax.lax.stop_gradient
    o, d = sg(origin), sg(direction)
    n, g1, g2 = (sg(x) for x in _triangle_frame(scene))
    v0 = sg(scene.tri_v0)

    def rows(x):
        return tuple(x[None, :, k] for k in range(3))

    w = tuple(v0[None, :, k] - o[:, k:k + 1] for k in range(3))
    t_all = _triangle_t(w, rows(n), rows(g1), rows(g2),
                        tuple(d[:, k:k + 1] for k in range(3)), t_min, t_max)
    t_all = jnp.where(scene.tri_valid[None, :], t_all, jnp.inf)
    idx = jnp.argmin(t_all, axis=1).astype(jnp.int32)

    nw, g1w, g2w = (x[idx] for x in _triangle_frame(scene))
    ww = scene.tri_v0[idx] - origin

    def cols(x):
        return tuple(x[:, k] for k in range(3))

    t_w = _triangle_t(cols(ww), cols(nw), cols(g1w), cols(g2w),
                      cols(direction), t_min, t_max)
    return _winner_t(t_all, t_w), idx


def intersect(scene: Scene, origin, direction, time, t_min, t_max=jnp.inf) -> HitRecord:
    """Nearest hit over all primitives; batched bvh.findHit + Hit.init
    (renderer.zig:107, hit.zig:16-42)."""
    t_s, i_s = intersect_spheres(scene, origin, direction, time, t_min, t_max)
    if scene.n_triangles > 0:
        t_t, i_t = intersect_triangles(scene, origin, direction, time, t_min, t_max)
        sphere_wins = t_s <= t_t
        t = jnp.where(sphere_wins, t_s, t_t)
    else:
        sphere_wins = jnp.ones(t_s.shape, dtype=bool)
        t = t_s

    hit = jnp.isfinite(t)
    t_safe = jnp.where(hit, t, 0.0)
    point = vec.ray_at(origin, direction, t_safe)

    # Sphere outward normal: unit(point - center(time)) (geom.zig:64 — unit of
    # the offset, not offset/radius, so inverted "bubble" spheres with negative
    # radius still get outward normals).
    cen = scene.sphere_center[i_s] + (
        time[:, None] * scene.sphere_velocity[i_s] if scene.has_motion else 0.0
    )
    n_sphere = vec.normalize(point - cen, eps=1e-20)
    mat_sphere = scene.sphere_material[i_s]

    if scene.n_triangles > 0:
        n_raw, _, _ = _triangle_frame(scene)
        n_tri = vec.normalize(n_raw[i_t], eps=1e-20)
        mat_tri = scene.tri_material[i_t]
        normal = jnp.where(sphere_wins[:, None], n_sphere, n_tri)
        material = jnp.where(sphere_wins, mat_sphere, mat_tri)
    else:
        normal = n_sphere
        material = mat_sphere

    # Front-face flip (Hit.init, hit.zig:31-34): normal opposes the ray.
    front_face = vec.dot(normal, direction) < 0.0
    normal = jnp.where(front_face[:, None], normal, -normal)

    return HitRecord(
        t=t,
        point=point,
        normal=normal,
        front_face=front_face,
        material=material.astype(jnp.int32),
        hit=hit,
    )


def aabb_hit(low, high, origin, direction, t_min, t_max):
    """Batched slab test, matching AABB.hit (hit.zig:70-98): per-axis interval
    intersection seeded with [t_min, t_max]; hit iff t1 > t0 (strict). Division
    by zero direction components follows IEEE (vdiv semantics, vec.zig:126-132).

    Shapes broadcast: low/high [..., 3] against origin/direction [..., 3].
    Kept, with the helpers below, for a BVH traversal (see ROADMAP.md).
    """
    t0s = (low - origin) / direction
    t1s = (high - origin) / direction
    lo = jnp.minimum(t0s, t1s)
    hi = jnp.maximum(t0s, t1s)
    t0 = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    t1 = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return t1 > t0


def aabb_enclose(low_a, high_a, low_b, high_b):
    """Union of two AABBs — AABB.enclose (hit.zig:55-60) in batched array
    form."""
    return jnp.minimum(low_a, low_b), jnp.maximum(high_a, high_b)


def aabb_longest_axis(low, high):
    """Index of the widest axis — AABB.longestAxis via V3.amax
    (hit.zig:62-64, vec.zig:150-157); the reference BVH median-splits on
    it (hit.zig:130-159)."""
    return jnp.argmax(high - low, axis=-1).astype(jnp.int32)


def sphere_aabb(center0, velocity, radius):
    """AABB of a (possibly moving) sphere over t in [0, 1] — the box of the
    t=0 and t=1 boxes, Sphere.boundingBox (geom.zig:24-31)."""
    r = radius[..., None]
    lo0, hi0 = center0 - r, center0 + r
    c1 = center0 + velocity
    return aabb_enclose(lo0, hi0, c1 - r, c1 + r)
