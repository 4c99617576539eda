"""Shading tests: sky formula golden (including the reference's non-standard
form), texture dispatch, Schlick, and scatter behavior/distributions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rayz_tpu import SceneBuilder
from rayz_tpu.models.scene import (
    DIFFUSE_HEMISPHERE,
    DIFFUSE_UNIT_SPHERE,
    DIFFUSE_UNIT_SPHERE_SURFACE,
)
from rayz_tpu.ops import intersect, scatter, schlick_reflectance, sky_color, texture_value
from rayz_tpu.utils import vec


def test_sky_formula_reference_exact():
    """renderer.zig:124-125: color = t * ((1-t)*white + blue), NOT the
    standard lerp. Straight up (+y): t=1 -> exactly (0.5, 0.7, 1.0);
    straight down: t=0 -> black; horizontal: t=0.5 -> (0.75, 0.85, 1.0)*0.5."""
    up = jnp.asarray([[0.0, 2.0, 0.0]])  # non-unit on purpose
    down = jnp.asarray([[0.0, -3.0, 0.0]])
    flat = jnp.asarray([[1.0, 0.0, 0.0]])
    np.testing.assert_allclose(np.asarray(sky_color(up))[0], [0.5, 0.7, 1.0], atol=1e-12)
    np.testing.assert_allclose(np.asarray(sky_color(down))[0], [0.0, 0.0, 0.0], atol=1e-12)
    np.testing.assert_allclose(
        np.asarray(sky_color(flat))[0], [0.5 * 1.0, 0.5 * 1.2, 0.5 * 1.5], atol=1e-12
    )


def test_schlick_golden():
    # material.zig:179-183; normal incidence with eta=1.5: r0 = 0.04
    r = float(schlick_reflectance(jnp.float64(1.0), jnp.float64(1.5)))
    assert r == pytest.approx(((1 - 1.5) / (1 + 1.5)) ** 2)
    # grazing incidence -> 1
    r = float(schlick_reflectance(jnp.float64(0.0), jnp.float64(1.5)))
    assert r == pytest.approx(1.0)


def test_solid_and_checker_texture():
    b = SceneBuilder()
    even = b.add_solid_texture((0.2, 0.3, 0.1))
    odd = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.32, even, odd)
    m = b.add_diffuse(texture=checker)
    b.add_sphere((0, 0, 0), 1.0, m)
    scene = b.build(dtype=jnp.float64)

    # material.zig:33-37: parity of floor(p/s) per axis
    pts = jnp.asarray(
        [
            [0.1, 0.1, 0.1],  # cells (0,0,0) -> even
            [0.4, 0.1, 0.1],  # cells (1,0,0) -> odd
            [-0.1, 0.1, 0.1],  # cells (-1,0,0) -> odd (floor of negative)
            [0.4, 0.4, 0.1],  # cells (1,1,0) -> even
        ],
        dtype=jnp.float64,
    )
    tex = jnp.full((4,), checker, dtype=jnp.int32)
    out = np.asarray(texture_value(scene, tex, pts))
    np.testing.assert_allclose(out[0], [0.2, 0.3, 0.1])
    np.testing.assert_allclose(out[1], [0.9, 0.9, 0.9])
    np.testing.assert_allclose(out[2], [0.9, 0.9, 0.9])
    np.testing.assert_allclose(out[3], [0.2, 0.3, 0.1])

    # solid texture returns its color anywhere
    tex_s = jnp.full((4,), even, dtype=jnp.int32)
    np.testing.assert_allclose(
        np.asarray(texture_value(scene, tex_s, pts)),
        np.broadcast_to([0.2, 0.3, 0.1], (4, 3)),
    )


def _hit_scene(mat_builder):
    """Single unit sphere at origin; rays from +z hitting the north pole-ish."""
    b = SceneBuilder()
    m = mat_builder(b)
    b.add_sphere((0, 0, 0), 1.0, m)
    scene = b.build(dtype=jnp.float64)
    n = 5000
    o = jnp.tile(jnp.asarray([[0.0, 0.0, 3.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    tm = jnp.zeros(n, dtype=jnp.float64)
    rec = intersect(scene, o, d, tm, 1e-9)
    assert bool(rec.hit.all())
    return scene, d, tm, rec


def test_diffuse_scatter_hemisphere_distribution():
    scene, d, tm, rec = _hit_scene(lambda b: b.add_diffuse(color=(0.5, 0.6, 0.7)))
    new_d, att, scat = scatter(jax.random.PRNGKey(0), scene, d, tm, rec)
    assert bool(scat.all())  # diffuse always scatters (material.zig:75-101)
    np.testing.assert_allclose(
        np.asarray(att), np.broadcast_to([0.5, 0.6, 0.7], att.shape)
    )
    # HEMISPHERE: direction is a point in the unit half-ball about the normal
    nd = np.asarray(new_d)
    normal = np.asarray(rec.normal)
    dots = (nd * normal).sum(axis=1)
    assert (dots > 0).all()
    assert np.linalg.norm(nd, axis=1).max() <= 1.0 + 1e-9
    # interior points (not surface): some samples well inside the ball
    assert np.linalg.norm(nd, axis=1).min() < 0.5


def test_diffuse_scatter_methods_differ():
    for method, check in [
        (DIFFUSE_UNIT_SPHERE, lambda nd, n: True),
        (DIFFUSE_UNIT_SPHERE_SURFACE, lambda nd, n: True),
    ]:
        scene, d, tm, rec = _hit_scene(
            lambda b: b.add_diffuse(color=(0.5, 0.5, 0.5), method=method)
        )
        new_d, _, _ = scatter(jax.random.PRNGKey(1), scene, d, tm, rec)
        nd = np.asarray(new_d)
        normal = np.asarray(rec.normal)
        # dir = normal + sample: |dir - normal| <= 1 (ball) or == 1 (surface)
        r = np.linalg.norm(nd - normal, axis=1)
        if method == DIFFUSE_UNIT_SPHERE_SURFACE:
            np.testing.assert_allclose(r, 1.0, atol=1e-9)
        else:
            assert r.max() <= 1.0 + 1e-9


def test_metal_scatter_mirror_and_fuzz():
    # fuzz=0: exact unit mirror reflection (material.zig:107-115)
    scene, d, tm, rec = _hit_scene(lambda b: b.add_metallic(color=(0.7, 0.6, 0.5)))
    new_d, att, scat = scatter(jax.random.PRNGKey(2), scene, d, tm, rec)
    assert bool(scat.all())
    nd = np.asarray(new_d)
    # incoming (0,0,-1) on normal (0,0,1): reflect -> (0,0,1) unit
    np.testing.assert_allclose(nd, np.broadcast_to([0, 0, 1.0], nd.shape), atol=1e-12)
    np.testing.assert_allclose(np.asarray(att), np.broadcast_to([0.7, 0.6, 0.5], nd.shape))

    # fuzz=1 at grazing incidence: fuzzed directions dip below the surface ->
    # absorbed (material.zig:116-117). At normal incidence absorption is
    # impossible (refl.n = 1 + u.n > 0), so graze the sphere's edge.
    b = rt_scene = None
    from rayz_tpu import SceneBuilder as SB
    b = SB()
    m = b.add_metallic(color=(0.7, 0.6, 0.5), fuzz=1.0)
    b.add_sphere((0, 0, 0), 1.0, m)
    scene = b.build(dtype=jnp.float64)
    n = 5000
    o = jnp.tile(jnp.asarray([[0.9, 0.0, 3.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 0.0, -1.0]]), (n, 1))
    tm = jnp.zeros(n, dtype=jnp.float64)
    rec = intersect(scene, o, d, tm, 1e-9)
    assert bool(rec.hit.all())
    _, _, scat = scatter(jax.random.PRNGKey(3), scene, d, tm, rec)
    frac = float(jnp.mean(scat.astype(jnp.float64)))
    # refl.n = cos(2*theta_i-ish) ~ 0.44 here; absorb fraction ~(1-0.44)/2
    assert 0.5 < frac < 0.95


def test_dielectric_straight_through_and_tir():
    # normal incidence, eta any: refracts straight through (when coin says so)
    scene, d, tm, rec = _hit_scene(lambda b: b.add_dielectric(1.5))
    new_d, att, scat = scatter(jax.random.PRNGKey(4), scene, d, tm, rec)
    assert bool(scat.all())
    np.testing.assert_allclose(np.asarray(att), np.ones_like(np.asarray(att)))
    nd = np.asarray(new_d)
    # at normal incidence, refraction keeps direction (0,0,-1); reflection flips
    through = np.allclose(nd, [0, 0, -1], atol=1e-9)
    flipped = np.allclose(nd, [0, 0, 1], atol=1e-9)
    per_ray_through = np.all(np.isclose(nd, [0, 0, -1]), axis=1)
    frac_through = per_ray_through.mean()
    # Schlick at normal incidence, eta=1/1.5 -> r0 = 0.04: ~96% refract
    assert 0.92 < frac_through < 0.995

    # TIR: ray inside glass (back face) at grazing angle must reflect
    b = SceneBuilder()
    m = b.add_dielectric(1.5)
    b.add_sphere((0, 0, 0), 1.0, m)
    scene = b.build(dtype=jnp.float64)
    n = 100
    # ray from just inside the surface, nearly tangent: at the exit point the
    # incidence sine is ~0.99 > 1/1.5, so TIR is guaranteed for every ray
    o = jnp.tile(jnp.asarray([[0.99, 0.0, 0.0]]), (n, 1))
    d = jnp.tile(jnp.asarray([[0.0, 1.0, 0.0]]), (n, 1))
    tmz = jnp.zeros(n, dtype=jnp.float64)
    rec = intersect(scene, o, d, tmz, 1e-9)
    assert bool(rec.hit.all()) and not bool(rec.front_face.any())
    new_d, _, _ = scatter(jax.random.PRNGKey(5), scene, d, tmz, rec)
    # eta=1.5 (back face), sin(theta) large -> TIR -> every ray reflects back
    # inside. rec.normal is flipped to oppose the incoming ray (hit.zig:33) so
    # it points INTO the sphere here; a reflection satisfies
    # dot(refl, n) = -dot(d, n) > 0, i.e. the ray leaves along the inward
    # normal side — it stays in the glass.
    inward = (vec.dot(new_d, rec.normal) > 0).all()
    assert bool(inward)
    # and it is the exact mirror reflection of the (non-unit-safe) formula
    refl = np.asarray(d - 2.0 * vec.dot(d, rec.normal)[..., None] * rec.normal)
    np.testing.assert_allclose(np.asarray(new_d), refl, atol=1e-12)


def test_degenerate_scatter_absorbed(monkeypatch):
    """A zero scatter direction must be treated as absorbed, not traced.

    jax.random.uniform's fixed-point grid returns exactly 0 with probability
    2^-23, making the unit-ball radius draw zero; at large coordinates
    (cornell_box scale) target = point + offset then rounds back to point in
    f32 and the diffuse direction is exactly (0,0,0). Untraced, the next
    bounce misses everything and sky_color normalizes a zero vector -> NaN
    pixels (observed at 128x128x256spp before the guard). Force the
    degenerate draw and require finite (black) output through the full
    integrator. The path-trace kernel carries the same guard."""
    from rayz_tpu.ops import integrator, shade

    monkeypatch.setattr(
        shade.sampling, "random_in_hemisphere",
        lambda key, shape, dtype, normal: jnp.zeros((*shape, 3), dtype))

    b = SceneBuilder()
    wall = b.add_diffuse(color=(0.7, 0.7, 0.7))
    b.add_sphere((555.0, 555.0, 555.0), 100.0, wall)
    scene = b.build()
    # rays that hit the wall sphere head-on from cornell-scale coordinates
    o = jnp.tile(jnp.asarray([[278.0, 278.0, -800.0]], jnp.float32), (4, 1))
    d = vec.normalize(jnp.asarray([[555.0, 555.0, 555.0]], jnp.float32) - o)
    tmz = jnp.zeros(4, dtype=jnp.float32)
    rad = integrator.trace_rays(scene, o, d, tmz, jax.random.PRNGKey(0),
                                max_depth=4, t_min=1e-3)
    rad = np.asarray(rad)
    assert np.isfinite(rad).all()
    # the forced-degenerate diffuse bounce absorbs: contributes black
    np.testing.assert_allclose(rad, 0.0, atol=1e-12)
