"""Intersection tests: sphere quadratic vs analytic expectations, AABB slab
goldens from the reference (/root/reference/src/hit.zig:247-279), moving
spheres, triangles, and nearest-hit selection."""

import jax.numpy as jnp
import numpy as np
import pytest

from rayz_tpu import SceneBuilder
from rayz_tpu.ops import intersect, intersect_spheres, aabb_hit


def build_single_sphere(center=(0, 0, -2), radius=1.0, velocity=None):
    b = SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    b.add_sphere(center, radius, m, velocity=velocity)
    return b.build(dtype=jnp.float64)


def rays(os, ds, times=None):
    o = jnp.asarray(os, dtype=jnp.float64)
    d = jnp.asarray(ds, dtype=jnp.float64)
    t = jnp.zeros(o.shape[0], dtype=jnp.float64) if times is None else jnp.asarray(times, dtype=jnp.float64)
    return o, d, t


def test_sphere_hit_t_values():
    scene = build_single_sphere()
    o, d, tm = rays([[0, 0, 0], [0, 0, 0], [0, 0, 0]],
                    [[0, 0, -1], [0, 0, 1], [0, 1, 0]])
    t, idx = intersect_spheres(scene, o, d, tm, 1e-10, jnp.inf)
    t = np.asarray(t)
    assert t[0] == 1.0  # front face at z=-1
    assert not np.isfinite(t[1])  # pointing away
    assert not np.isfinite(t[2])  # miss


def test_sphere_inside_second_root():
    # origin inside the sphere: t1 < t_min, so t2 is taken (geom.zig:57-59)
    scene = build_single_sphere(center=(0, 0, 0), radius=1.0)
    o, d, tm = rays([[0, 0, 0]], [[0, 0, -1]])
    t, _ = intersect_spheres(scene, o, d, tm, 1e-10, jnp.inf)
    assert float(t[0]) == 1.0


def test_sphere_tmax_window():
    scene = build_single_sphere()
    o, d, tm = rays([[0, 0, 0]], [[0, 0, -1]])
    t, _ = intersect_spheres(scene, o, d, tm, 1e-10, 0.5)
    assert not np.isfinite(float(t[0]))
    # window covering only the far root picks the far root
    t, _ = intersect_spheres(scene, o, d, tm, 2.0, 10.0)
    assert float(t[0]) == 3.0


def test_moving_sphere():
    # center moves +y by 1 over t in [0,1] (geom.zig:40)
    scene = build_single_sphere(center=(0, 0, -2), velocity=(0, 1, 0))
    o, d, tm = rays([[0, 0, 0], [0, 0, 0]], [[0, 0, -1], [0, 1, -2]],
                    times=[0.0, 1.0])
    rec = intersect(scene, o, d, tm, 1e-10)
    assert bool(rec.hit[0])
    # at time=1 the center is at (0,1,-2); the ray towards (0,1,-2) hits
    assert bool(rec.hit[1])
    p = np.asarray(rec.point[1])
    assert abs(np.linalg.norm(p - np.array([0, 1, -2])) - 1.0) < 1e-9


def test_normal_front_back():
    scene = build_single_sphere(center=(0, 0, -2), radius=1.0)
    # outside hit: normal opposes ray, front_face True (hit.zig:31-34)
    o, d, tm = rays([[0, 0, 0]], [[0, 0, -1]])
    rec = intersect(scene, o, d, tm, 1e-10)
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [0, 0, 1], atol=1e-12)
    assert bool(rec.front_face[0])
    # inside hit: normal flipped inward, front_face False
    o, d, tm = rays([[0, 0, -2]], [[0, 0, -1]])
    rec = intersect(scene, o, d, tm, 1e-10)
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [0, 0, 1], atol=1e-12)
    assert not bool(rec.front_face[0])


def test_nearest_hit_two_spheres():
    b = SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -5), 1.0, m)
    b.add_sphere((0, 0, -2), 0.5, m)
    scene = b.build(dtype=jnp.float64)
    o, d, tm = rays([[0, 0, 0]], [[0, 0, -1]])
    rec = intersect(scene, o, d, tm, 1e-10)
    assert float(rec.t[0]) == 1.5  # nearer small sphere wins


def test_padding_spheres_never_hit():
    b = SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -2), 1.0, m)
    scene = b.build(dtype=jnp.float64, pad_multiple=64)
    assert scene.sphere_radius.shape[0] == 64
    # rays through the padding origin (0,0,0) must not hit padding
    o, d, tm = rays([[5, 5, 5]], [[-1, -1, -1]])
    rec = intersect(scene, o, d, tm, 1e-10)
    assert not bool(rec.hit[0])


def test_aabb_golden():
    # hit.zig:252-269 "bbox hit"
    low = jnp.asarray([0.0, 0, 0])
    high = jnp.asarray([1.0, 1, 1])
    o = jnp.asarray([[-1.0, -1, -1]] * 3)
    d = jnp.asarray([[1.0, 1, 1], [-1, -1, -1], [0.5, 0.5, 0.5]])
    out = np.asarray(aabb_hit(low, high, o, d, 0.0, 10.0))
    assert out.tolist() == [True, False, True]
    # hit.zig:271-279 "bbox hit 2": real-scene regression ray
    low2 = jnp.asarray([-1000.0, -2000, -1000])
    high2 = jnp.asarray([1000.0, 2, 1000])
    o2 = jnp.asarray([[13.0, 2, 3]])
    d2 = jnp.asarray([[-9.6, -1.5, -2.3]])
    assert bool(aabb_hit(low2, high2, o2, d2, 0.0, 10.0)[0])
    # hit.zig:237-247 "enclose bbox": union of {(-1..1)} and {(0..2)}
    from rayz_tpu.ops.intersect import aabb_enclose, aabb_longest_axis, sphere_aabb
    enc_low, enc_high = aabb_enclose(
        jnp.asarray([-1.0, -1, -1]), jnp.asarray([1.0, 1, 1]),
        jnp.asarray([0.0, 0, 0]), jnp.asarray([2.0, 2, 2]))
    np.testing.assert_array_equal(np.asarray(enc_low), [-1, -1, -1])
    np.testing.assert_array_equal(np.asarray(enc_high), [2, 2, 2])
    # longestAxis via amax (hit.zig:62-64)
    assert int(aabb_longest_axis(jnp.asarray([0.0, 0, 0]),
                                 jnp.asarray([1.0, 3, 2]))) == 1
    # geom.zig:69-84 "sphere bbox": stationary r=1 at origin; moving by ones
    lo, hi = sphere_aabb(jnp.zeros((1, 3)), jnp.zeros((1, 3)), jnp.ones((1,)))
    np.testing.assert_allclose(np.asarray(lo[0]), [-1, -1, -1])
    np.testing.assert_allclose(np.asarray(hi[0]), [1, 1, 1])
    lo, hi = sphere_aabb(jnp.zeros((1, 3)), jnp.ones((1, 3)), jnp.ones((1,)))
    np.testing.assert_allclose(np.asarray(lo[0]), [-1, -1, -1])
    np.testing.assert_allclose(np.asarray(hi[0]), [2, 2, 2])


def test_triangle_hit():
    b = SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    b.add_triangle((0, 0, -2), (1, 0, -2), (0, 1, -2), m)
    scene = b.build(dtype=jnp.float64)
    o, d, tm = rays(
        [[0.2, 0.2, 0], [0.9, 0.9, 0], [-0.1, 0.2, 0], [0.2, 0.2, 0]],
        [[0, 0, -1], [0, 0, -1], [0, 0, -1], [0, 0, 1]],
    )
    rec = intersect(scene, o, d, tm, 1e-10)
    hits = np.asarray(rec.hit)
    assert hits.tolist() == [True, False, False, False]
    assert float(rec.t[0]) == 2.0
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [0, 0, 1], atol=1e-12)
    assert bool(rec.front_face[0])


def test_triangle_double_sided():
    b = SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    b.add_triangle((0, 0, -2), (1, 0, -2), (0, 1, -2), m)
    scene = b.build(dtype=jnp.float64)
    # from behind: still hits, normal flipped to oppose the ray
    o, d, tm = rays([[0.2, 0.2, -4]], [[0, 0, 1]])
    rec = intersect(scene, o, d, tm, 1e-10)
    assert bool(rec.hit[0])
    np.testing.assert_allclose(np.asarray(rec.normal[0]), [0, 0, -1], atol=1e-12)


def test_sphere_vs_triangle_nearest():
    b = SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    b.add_sphere((0, 0, -5), 1.0, m)
    b.add_triangle((-1, -1, -2), (3, -1, -2), (-1, 3, -2), m)
    scene = b.build(dtype=jnp.float64)
    o, d, tm = rays([[0, 0, 0]], [[0, 0, -1]])
    rec = intersect(scene, o, d, tm, 1e-10)
    assert float(rec.t[0]) == 2.0  # triangle in front of sphere


def _dense_min_reference(scene, o, d, tm, kind):
    """Nearest-hit distance as a plain differentiable minimum over the full
    [R, P] table of roots (the formulation whose backward is O(R*P))."""
    import jax

    from rayz_tpu.ops.intersect import _sphere_t, _triangle_frame, _triangle_t

    if kind == "triangles":
        n, g1, g2 = _triangle_frame(scene)
        rows = lambda x: tuple(x[None, :, k] for k in range(3))
        w = tuple(scene.tri_v0[None, :, k] - o[:, k:k + 1] for k in range(3))
        t = _triangle_t(w, rows(n), rows(g1), rows(g2),
                        tuple(d[:, k:k + 1] for k in range(3)), 1e-6, jnp.inf)
        t = jnp.where(scene.tri_valid[None, :], t, jnp.inf)
    else:
        c = scene.sphere_center[None]
        if scene.has_motion:
            c = c + tm[:, None, None] * scene.sphere_velocity[None]
        oc = c - o[:, None, :]
        r = scene.sphere_radius
        t = _sphere_t(oc[..., 0], oc[..., 1], oc[..., 2], d[:, 0:1],
                      d[:, 1:2], d[:, 2:3], jnp.sum(d * d, -1)[:, None],
                      (r * r)[None, :], 1e-6, jnp.inf)
        t = jnp.where(scene.sphere_valid[None, :], t, jnp.inf)
    t = jnp.min(t, axis=1)
    return jnp.where(jnp.isfinite(t), t, 0.0)


@pytest.mark.parametrize("kind", ["spheres", "moving_spheres", "triangles"])
def test_winner_gradient_equals_dense_min_gradient(kind):
    """intersect_* take the hit distance's value from the dense sweep and
    its gradient from the winner's recomputed root; both must equal the
    value and gradient of a plain differentiable minimum, for the rays
    and for every primitive parameter."""
    import jax

    from rayz_tpu.ops.intersect import intersect_triangles

    rng = np.random.default_rng(0)
    b = SceneBuilder()
    m = b.add_diffuse(color=(0.5, 0.5, 0.5))
    for _ in range(5):
        c = rng.uniform(-1.5, 1.5, 3) + np.array([0, 0, -4])
        if kind == "triangles":
            b.add_triangle(c, c + rng.uniform(-1, 1, 3) + [1.5, 0, 0],
                           c + rng.uniform(-1, 1, 3) + [0, 1.5, 0], m)
        else:
            vel = rng.uniform(-0.5, 0.5, 3) if kind == "moving_spheres" else None
            b.add_sphere(c, rng.uniform(0.4, 0.9), m, velocity=vel)
    scene = b.build(dtype=jnp.float64)
    o = jnp.asarray(rng.uniform(-0.3, 0.3, (64, 3)))
    d = jnp.asarray(rng.uniform(-0.4, 0.4, (64, 3)) + [0, 0, -1])
    tm = jnp.asarray(rng.uniform(0, 1, 64))
    fn = intersect_triangles if kind == "triangles" else intersect_spheres
    fields = (("tri_v0", "tri_v1", "tri_v2") if kind == "triangles"
              else ("sphere_center", "sphere_radius", "sphere_velocity"))

    def ours(p, o, d):
        t, _ = fn(scene.replace(**p), o, d, tm, 1e-6, jnp.inf)
        return jnp.sum(jnp.where(jnp.isfinite(t), t, 0.0) ** 2)

    def ref(p, o, d):
        return jnp.sum(_dense_min_reference(scene.replace(**p), o, d, tm,
                                            kind) ** 2)

    params = {f: getattr(scene, f) for f in fields}
    v1, g1 = jax.value_and_grad(ours, argnums=(0, 1, 2))(params, o, d)
    v2, g2 = jax.value_and_grad(ref, argnums=(0, 1, 2))(params, o, d)
    assert float(v1) > 0  # some rays hit
    np.testing.assert_allclose(float(v1), float(v2), rtol=1e-12)
    for a, b_ in zip(jax.tree_util.tree_leaves(g1),
                     jax.tree_util.tree_leaves(g2)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b_), rtol=1e-9,
                                   atol=1e-12)
