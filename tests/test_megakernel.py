"""Path-trace kernel tests.

On the CPU the kernel runs in the Pallas interpreter (``interpret=True``):
deterministic scenes (jitter off, no scatter randomness) are compared EXACTLY
with the XLA integrator oracle, stochastic scenes statistically (the kernel's
counter-based PRNG is another stream than ``jax.random``). Tests marked
``gpu`` compile the kernel for the card and run through ``chip_smoke.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rayz_tpu as rt
from rayz_tpu.models.scene import (
    DIFFUSE_HEMISPHERE,
    DIFFUSE_UNIT_SPHERE,
    DIFFUSE_UNIT_SPHERE_SURFACE,
    MAT_DIELECTRIC,
    MAT_DIFFUSE,
    MAT_METALLIC,
    SceneBuilder,
)
from rayz_tpu.ops.megakernel import (hash_uniform, pixel_stream, render_pallas,
                                     scene_tables, supports_scene)

from parity import statistical_parity


def _render_both(scene, camera, config, interpret=True):
    img_p = np.asarray(render_pallas(scene, camera, 0, config,
                                     interpret=interpret))
    img_x = np.asarray(rt.render(scene.replace(), camera,
                                 jax.random.PRNGKey(0), config))
    return img_p, img_x


def test_scene_tables_layout():
    b = SceneBuilder()
    even = b.add_solid_texture((0.2, 0.3, 0.1))
    odd = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.32, even, odd)
    ground = b.add_diffuse(texture=checker)
    glass = b.add_dielectric(1.5)
    metal = b.add_metallic(color=(0.7, 0.6, 0.5), fuzz=1.25)
    b.add_sphere((0, -1000, 0), 1000.0, ground)
    b.add_sphere((0, 1, 0), 1.0, glass, velocity=(0.0, 0.25, 0.0))
    b.add_sphere((4, 1, 0), 1.0, metal)
    scene = b.build(dtype=jnp.float32)
    tab = np.asarray(scene_tables(scene))

    assert tab.shape == (17, scene.sphere_radius.shape[0])
    # sphere 0: diffuse + checker
    assert np.allclose(tab[0:3, 0], (0, -1000, 0))
    assert np.isclose(tab[3, 0], 1000.0 ** 2)  # r^2
    assert tab[7, 0] == MAT_DIFFUSE and tab[8, 0] == DIFFUSE_HEMISPHERE
    assert np.isclose(tab[10, 0], 0.32)  # checker scale in ior-or-scale row
    assert np.allclose(tab[11:14, 0], (0.2, 0.3, 0.1))  # even rgb
    assert np.allclose(tab[14:17, 0], (0.9, 0.9, 0.9))  # odd rgb
    # sphere 1: dielectric, moving
    assert tab[7, 1] == MAT_DIELECTRIC
    assert np.isclose(tab[10, 1], 1.5)  # ior in ior-or-scale row
    assert np.isclose(tab[5, 1], 0.25)  # velocity y
    # sphere 2: metal, fuzz clamped to 1 (material.zig:111)
    assert tab[7, 2] == MAT_METALLIC and tab[9, 2] == 1.0
    # padding never hits
    assert tab[3, scene.n_spheres] < -1e30


def test_tri_tables_layout():
    from rayz_tpu.ops.megakernel import tri_tables

    b = SceneBuilder()
    metal = b.add_metallic(color=(0.8, 0.85, 0.88), fuzz=0.05)
    b.add_triangle((0, 0, 0), (1, 0, 0), (0, 1, 0), metal)
    scene = b.build(dtype=jnp.float32)
    tab = np.asarray(tri_tables(scene))
    assert tab.shape == (22, scene.tri_material.shape[0])
    # plane normal of the xy unit triangle is +z with |n| = |e1 x e2| = 1
    assert np.allclose(tab[0:3, 0], (0.0, 0.0, 1.0))
    assert np.allclose(tab[3:6, 0], 0.0)  # v0
    # dual basis: g1.e1 = 1, g1.e2 = 0 -> g1 = (1,0,0); g2 = (0,1,0)
    assert np.allclose(tab[6:9, 0], (1.0, 0.0, 0.0))
    assert np.allclose(tab[9:12, 0], (0.0, 1.0, 0.0))
    # padding column: v0 is NaN, so its hit test can never pass
    assert np.isnan(tab[3:6, scene.n_triangles]).all()
    # material rows
    assert tab[12, 0] == MAT_METALLIC
    assert np.isclose(tab[14, 0], 0.05)


def test_supports_scene():
    scene, _ = rt.scenes.two_sphere(width=8, height=8)
    assert supports_scene(scene)
    scene_t, _ = rt.scenes.cornell_box(width=8, height=8, tessellation=1)
    assert supports_scene(scene_t)  # triangles run in-kernel too
    empty = SceneBuilder().build()
    assert not supports_scene(empty.replace(n_spheres=0))


def test_depth1_hit_black_miss_sky():
    """Deterministic single-bounce render: hit pixels are black (depth
    exhausted -> black, renderer.zig:104-105), miss pixels are the sky
    gradient — exact match against the XLA integrator."""
    scene, camera = rt.scenes.two_sphere(width=32, height=24)
    config = rt.RenderConfig(spp=1, max_depth=1, t_min=1e-3, jitter=False)
    img_p, img_x = _render_both(scene, camera, config)
    assert np.isfinite(img_p).all()
    np.testing.assert_allclose(img_p, img_x, atol=2e-5)
    assert img_p.max() > 0.5  # sky visible
    assert (img_p.reshape(-1, 3).min(axis=1) == 0).any()  # hit pixels black


def _mirror_scene():
    b = SceneBuilder()
    ground = b.add_metallic(color=(0.8, 0.8, 0.9), fuzz=0.0)
    ball = b.add_metallic(color=(0.9, 0.6, 0.3), fuzz=0.0)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, -1.2), 0.5, ball)
    return b.build(dtype=jnp.float32)


def _checker_scene():
    b = SceneBuilder()
    dark = b.add_solid_texture((0.1, 0.1, 0.1))
    lite = b.add_solid_texture((0.9, 0.9, 0.9))
    check = b.add_checker_texture(0.7, dark, lite)
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 b.add_metallic(texture=check, fuzz=0.0))
    return b.build(dtype=jnp.float32)


def _motion_scene():
    b = SceneBuilder()
    ground = b.add_metallic(color=(0.5, 0.5, 0.5), fuzz=0.0)
    ball = b.add_metallic(color=(0.9, 0.2, 0.2), fuzz=0.0)
    b.add_sphere((0.0, -100.5, -1.0), 100.0, ground)
    b.add_sphere((0.0, 0.0, -1.2), 0.5, ball, velocity=(0.0, 0.4, 0.0))
    scene = b.build(dtype=jnp.float32)
    assert scene.has_motion
    return scene


def _triangle_scene():
    b = SceneBuilder()
    mirror = b.add_metallic(color=(0.9, 0.8, 0.7), fuzz=0.0)
    b.add_quad((-2.0, -0.5, -3.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0), mirror)
    scene = b.build(dtype=jnp.float32)
    assert scene.n_spheres == 0 and scene.n_triangles == 2
    return scene


def _mixed_scene():
    b = SceneBuilder()
    mirror = b.add_metallic(color=(0.8, 0.8, 0.9), fuzz=0.0)
    ball = b.add_metallic(color=(0.9, 0.6, 0.3), fuzz=0.0)
    b.add_quad((-3.0, -0.5, -4.0), (6.0, 0.0, 0.0), (0.0, 0.0, 6.0), mirror)
    b.add_sphere((0.0, 0.0, -1.2), 0.5, ball)
    b.add_sphere((0.9, 0.1, -1.8), 0.4, mirror)
    return b.build(dtype=jnp.float32)


# Deterministic scenes: fuzz-0 metals consume no randomness, so with jitter
# off (time 0) every path is a fixed function of the scene.
DETERMINISTIC = {
    "sphere_mirror": (_mirror_scene, dict(look_from=(0, 0.4, 1),
                                          look_at=(0, 0, -1), vfov=60.0), 4),
    "checker": (_checker_scene, dict(look_from=(0, 0.5, 1),
                                     look_at=(0, -0.5, -1), vfov=70.0), 3),
    "motion_t0": (_motion_scene, dict(look_from=(0, 0.2, 1),
                                      look_at=(0, 0, -1), vfov=60.0), 2),
    "triangle_mirror": (_triangle_scene, dict(look_from=(0, 0.4, 1),
                                              look_at=(0, -0.5, -1),
                                              vfov=60.0), 3),
    "mixed": (_mixed_scene, dict(look_from=(0, 0.5, 1), look_at=(0, 0, -1),
                                 vfov=70.0), 4),
}


def _deterministic_case(name, width=32, height=24):
    make, cam_kw, depth = DETERMINISTIC[name]
    camera = rt.make_camera(width=width, height=height, focus_dist=1.0,
                            defocus_angle=0.0, **cam_kw)
    return make(), camera, rt.RenderConfig(spp=1, max_depth=depth,
                                           t_min=1e-3, jitter=False)


@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_parity(name):
    """Exact (float-order) parity with the XLA oracle: spheres, a checker,
    a moving sphere at t = 0, triangles, and both in one scene (including a
    sphere occluding a triangle and vice versa)."""
    scene, camera, config = _deterministic_case(name)
    img_p, img_x = _render_both(scene, camera, config)
    assert np.isfinite(img_p).all()
    np.testing.assert_allclose(img_p, img_x, atol=1e-4)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(DETERMINISTIC))
def test_deterministic_parity_compiled(gpu, name):
    """The same parity with the kernel compiled for the GPU, at 512x384.
    At this resolution a handful of rays graze a silhouette or a checker
    edge closely enough for float order to pick the other side, so a
    thousandth of the channel values may differ; everywhere else the two
    engines agree to 1e-3."""
    scene, camera, config = _deterministic_case(name, 512, 384)
    img_p, img_x = _render_both(scene, camera, config, interpret=False)
    assert np.isfinite(img_p).all()
    off = np.abs(img_p - img_x) > 1e-3
    assert off.mean() < 1e-3, off.mean()


def test_full_table_decode_deep_parity():
    """Deep (depth 4) deterministic scene with two distinct checker
    textures: every bounce gathers the winner's checker scale and even/odd
    colors from the tables (fuzz-0 metal between two checkered surfaces:
    multi-bounce, multi-checker, winner switching every bounce)."""
    b = SceneBuilder()
    e1 = b.add_solid_texture((0.2, 0.3, 0.1))
    o1 = b.add_solid_texture((0.9, 0.9, 0.9))
    c1 = b.add_checker_texture(0.4, e1, o1)
    e2 = b.add_solid_texture((0.7, 0.2, 0.2))
    o2 = b.add_solid_texture((0.1, 0.1, 0.6))
    c2 = b.add_checker_texture(0.9, e2, o2)
    ground = b.add_metallic(texture=c1, fuzz=0.0)
    wall = b.add_metallic(texture=c2, fuzz=0.0)
    mirror = b.add_metallic(color=(0.85, 0.85, 0.95), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, ground)
    b.add_sphere((0, 100.8, -2), 100.0, wall)
    b.add_sphere((0, 0.1, -2.2), 0.6, mirror)
    b.add_sphere((-1.1, 0.0, -2.0), 0.45, mirror)
    scene = b.build(dtype=jnp.float32)
    camera = rt.make_camera(width=24, height=24, vfov=60.0, focus_dist=1.0,
                            defocus_angle=0.0, look_from=(0, 0.2, 0.6),
                            look_at=(0, 0, -2))
    config = rt.RenderConfig(spp=1, max_depth=4, t_min=1e-3, jitter=False)
    img_p, img_x = _render_both(scene, camera, config)
    assert np.isfinite(img_p).all()
    np.testing.assert_allclose(img_p, img_x, atol=1e-4)
    # the render must actually see both checker patterns (odd+even of both)
    assert img_x.std() > 0.05


def test_multi_ior_depth1_matches_xla():
    """Two distinct IORs and a metal at depth 1 (hit -> black): the
    per-primitive IOR row is decoded per winner."""
    b = rt.SceneBuilder()
    b.add_sphere((0, 0, -2), 0.5, b.add_dielectric(1.5))
    b.add_sphere((1.2, 0, -2), 0.5, b.add_dielectric(2.4))
    b.add_sphere((-1.2, 0, -2), 0.5, b.add_metallic(color=(0.8, 0.7, 0.6)))
    scene = b.build()
    cam = rt.make_camera(width=24, height=24, vfov=60.0, focus_dist=1.0,
                         look_from=(0, 0, 0), look_at=(0, 0, -1))
    config = rt.RenderConfig(spp=1, max_depth=1, jitter=False)
    img_p, img_x = _render_both(scene, cam, config)
    np.testing.assert_allclose(img_p, img_x, atol=1e-4)


def _diffuse_scene(method):
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 b.add_diffuse(color=(0.8, 0.8, 0.0), method=method))
    b.add_sphere((0.0, 0.0, -1.2), 0.5,
                 b.add_diffuse(color=(0.1, 0.2, 0.5), method=method))
    return b.build(dtype=jnp.float32), dict(look_from=(0, 0, 0),
                                            look_at=(0, 0, -1), vfov=90.0)


def _fuzzy_metal_scene():
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 b.add_diffuse(color=(0.8, 0.8, 0.0)))
    b.add_sphere((0.0, 0.0, -1.2), 0.5,
                 b.add_metallic(color=(0.8, 0.6, 0.2), fuzz=0.4))
    return b.build(dtype=jnp.float32), dict(look_from=(0, 0, 0),
                                            look_at=(0, 0, -1), vfov=90.0)


def _glass_scene():
    scene, _ = rt.scenes.three_sphere(width=8, height=8)
    return scene, dict(look_from=(0, 0, 0), look_at=(0, 0, -1), vfov=90.0)


def _motion_blur_scene():
    b = SceneBuilder()
    b.add_sphere((0.0, -100.5, -1.0), 100.0,
                 b.add_diffuse(color=(0.5, 0.5, 0.5)))
    b.add_sphere((0.0, 0.0, -1.2), 0.5,
                 b.add_diffuse(color=(0.9, 0.2, 0.2)),
                 velocity=(0.0, 0.5, 0.0))
    return b.build(dtype=jnp.float32), dict(look_from=(0, 0, 0),
                                            look_at=(0, 0, -1), vfov=90.0)


def _checker_diffuse_triangles():
    b = SceneBuilder()
    e = b.add_solid_texture((0.2, 0.3, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    floor = b.add_diffuse(texture=b.add_checker_texture(0.3, e, o))
    b.add_quad((-2.0, -0.5, -3.0), (4.0, 0.0, 0.0), (0.0, 0.0, 4.0), floor)
    b.add_sphere((0.0, 0.0, -1.2), 0.5, b.add_diffuse(color=(0.7, 0.3, 0.2)))
    return b.build(dtype=jnp.float32), dict(look_from=(0, 0.3, 0.5),
                                            look_at=(0, 0, -1), vfov=80.0)


STOCHASTIC = {
    "diffuse_unit_sphere": lambda: _diffuse_scene(DIFFUSE_UNIT_SPHERE),
    "diffuse_surface": lambda: _diffuse_scene(DIFFUSE_UNIT_SPHERE_SURFACE),
    "diffuse_hemisphere": lambda: _diffuse_scene(DIFFUSE_HEMISPHERE),
    "fuzzy_metal": _fuzzy_metal_scene,
    "dielectric": _glass_scene,
    "motion_blur": _motion_blur_scene,
    "checker_triangles": _checker_diffuse_triangles,
}


@pytest.mark.parametrize("name", sorted(STOCHASTIC))
def test_statistical_parity(name):
    """Kernel vs XLA oracle in distribution: whole-image channel means
    within 1.5% and 8x8 block means within 5 standard errors (per-pixel
    spread from two XLA seeds; tests/parity.py). Jitter and a defocus disk
    are on, so the camera sampling is checked too."""
    scene, cam_kw = STOCHASTIC[name]()
    camera = rt.make_camera(width=32, height=32, focus_dist=1.0,
                            defocus_angle=2.0, **cam_kw)
    config = rt.RenderConfig(spp=32, max_depth=6)
    img_p = np.asarray(render_pallas(scene, camera, 3, config,
                                     interpret=True))
    img_a = np.asarray(rt.render(scene, camera, jax.random.PRNGKey(1), config))
    img_b = np.asarray(rt.render(scene, camera, jax.random.PRNGKey(2), config))
    res = statistical_parity(img_p, img_a, img_b, block=8, mean_rtol=0.015)
    assert res["ok"], res


@pytest.mark.parametrize("seed", [0, 1, 123456789])
def test_hash_uniform_is_uniform(seed):
    """Chi-square over 64 bins of 2^18 draws (one per pixel and counter) and
    the first two moments of U[0, 1)."""
    pix = jnp.arange(4096, dtype=jnp.int32)
    ctr = jnp.arange(64, dtype=jnp.int32)
    u = np.asarray(hash_uniform(pixel_stream(seed, pix)[:, None],
                                ctr[None, :])).ravel()
    assert u.min() >= 0.0 and u.max() < 1.0
    counts = np.bincount((u * 64).astype(int), minlength=64)
    expected = u.size / 64
    chi2 = float(((counts - expected) ** 2 / expected).sum())
    assert chi2 < 130.0, chi2  # 63 dof: p ~ 1e-6
    assert abs(u.mean() - 0.5) < 5 * np.sqrt(1 / 12 / u.size)
    assert abs(u.var() - 1 / 12) < 1e-3


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("axis", ["pixel", "counter"])
def test_hash_neighbours_uncorrelated(seed, axis):
    """Draws of neighbouring pixels (same counter) and of consecutive
    counters (next draw or bounce of the same pixel) are uncorrelated, and
    their joint distribution fills a 16x16 grid evenly."""
    pix = jnp.arange(1 << 16, dtype=jnp.int32)
    stream = pixel_stream(seed, pix)
    if axis == "pixel":
        u = np.asarray(hash_uniform(stream, jnp.full_like(pix, 5)))
        a, b = u[:-1], u[1:]
    else:
        a = np.asarray(hash_uniform(stream, jnp.full_like(pix, 40)))
        b = np.asarray(hash_uniform(stream, jnp.full_like(pix, 41)))
    r = np.corrcoef(a, b)[0, 1]
    assert abs(r) < 4.0 / np.sqrt(a.size), r
    joint = np.bincount((a * 16).astype(int) * 16 + (b * 16).astype(int),
                        minlength=256)
    expected = a.size / 256
    chi2 = float(((joint - expected) ** 2 / expected).sum())
    assert chi2 < 360.0, chi2  # 255 dof: p ~ 1e-5


def test_hash_streams_differ_by_seed():
    pix = jnp.arange(1024, dtype=jnp.int32)
    ctr = jnp.zeros_like(pix)
    a = np.asarray(hash_uniform(pixel_stream(0, pix), ctr))
    b = np.asarray(hash_uniform(pixel_stream(1, pix), ctr))
    assert (a != b).mean() > 0.99
    assert abs(np.corrcoef(a, b)[0, 1]) < 0.15


@pytest.mark.parametrize("width,height", [(17, 9), (33, 5), (1, 1)])
def test_odd_image_sizes_pad_to_blocks(width, height):
    """Pixel counts that are not a multiple of the block: the padding slots
    trace nothing and the image keeps its shape and values."""
    scene = _mirror_scene()
    camera = rt.make_camera(width=width, height=height, vfov=60.0,
                            focus_dist=1.0, look_from=(0, 0.4, 1),
                            look_at=(0, 0, -1))
    config = rt.RenderConfig(spp=1, max_depth=3, jitter=False)
    img_p, img_x = _render_both(scene, camera, config)
    assert img_p.shape == (height, width, 3)
    np.testing.assert_allclose(img_p, img_x, atol=1e-4)


@pytest.mark.parametrize("block", [64, 128, 256])
def test_block_size_does_not_change_the_image(block):
    """Each pixel's samples depend only on (seed, pixel, sample, bounce,
    draw), so any block size renders the same bits."""
    scene, camera = rt.scenes.three_sphere(width=24, height=12)
    config = rt.RenderConfig(spp=2, max_depth=4)
    ref = np.asarray(render_pallas(scene, camera, 5, config, interpret=True))
    img = np.asarray(render_pallas(scene, camera, 5, config, block=block,
                                   interpret=True))
    np.testing.assert_array_equal(img, ref)


@pytest.mark.parametrize("block", [0, 96, 100])
def test_block_must_be_power_of_two(block):
    scene, camera = rt.scenes.two_sphere(width=8, height=8)
    with pytest.raises(ValueError, match="power of two"):
        render_pallas(scene, camera, 0, rt.RenderConfig(spp=1, max_depth=1),
                      block=block, interpret=True)


def test_compiled_kernel_off_gpu_raises():
    """interpret=False on the CPU raises instead of interpreting: the kernel
    never switches to the interpreter on its own."""
    from rayz_tpu.ops.megakernel import render_pallas_sharded
    from rayz_tpu.parallel import make_mesh

    scene, camera = rt.scenes.two_sphere(width=8, height=8)
    cfg = rt.RenderConfig(spp=1, max_depth=1)
    with pytest.raises(RuntimeError, match="GPU"):
        render_pallas(scene, camera, 0, cfg)
    with pytest.raises(RuntimeError, match="GPU"):
        render_pallas_sharded(scene, camera, 0, cfg, make_mesh())
    with pytest.raises(RuntimeError, match="GPU"):
        rt.render_fast(scene, camera, 0, cfg, engine="pallas")


def test_engine_dispatch():
    from rayz_tpu.ops.engine import pick_engine
    sph, _ = rt.scenes.two_sphere(width=8, height=8)
    tri, _ = rt.scenes.cornell_box(width=8, height=8, tessellation=1)
    # off the GPU auto resolves to xla; explicit names pass through
    assert pick_engine(sph, "auto") == "xla"
    assert pick_engine(tri, "auto") == "xla"
    assert pick_engine(sph, "xla") == "xla"
    assert pick_engine(sph, "pallas") == "pallas"
    with pytest.raises(ValueError):
        pick_engine(sph, "cuda")


def test_engine_dispatch_auto_on_gpu(monkeypatch):
    """On the GPU auto picks the kernel for every supported scene and the
    XLA integrator for nested checkers."""
    from rayz_tpu.ops import engine

    monkeypatch.setattr(engine.jax, "default_backend", lambda: "gpu")
    sph, _ = rt.scenes.two_sphere(width=8, height=8)
    tri, _ = rt.scenes.cornell_box(width=8, height=8, tessellation=1)
    assert engine.pick_engine(sph, "auto") == "pallas"
    assert engine.pick_engine(tri, "auto") == "pallas"
    assert engine.pick_engine(_nested_checker_scene(), "auto") == "xla"


@pytest.mark.parametrize("name", ["wavefront", "recorded", "recorded-pp"])
def test_removed_engine_names_raise(name):
    from rayz_tpu.diff import make_train_step, pixel_loss
    from rayz_tpu.ops.engine import pick_engine
    import optax

    scene, camera = rt.scenes.two_sphere(width=4, height=4)
    cfg = rt.RenderConfig(spp=1, max_depth=1)
    with pytest.raises(ValueError):
        pick_engine(scene, name)
    with pytest.raises(ValueError):
        rt.render_fast(scene, camera, 0, cfg, engine=name)
    with pytest.raises(ValueError):
        make_train_step(optax.sgd(1e-2), cfg, engine=name)
    with pytest.raises(ValueError):
        pixel_loss({}, scene, camera, jax.random.PRNGKey(0),
                   jnp.zeros((4, 4, 3)), cfg, name)


def test_render_fast_xla_fallback_matches_render():
    scene, camera = rt.scenes.two_sphere(width=16, height=16)
    config = rt.RenderConfig(spp=2, max_depth=3, t_min=1e-3)
    a = np.asarray(rt.render_fast(scene, camera, 7, config, engine="xla"))
    b = np.asarray(rt.render(scene, camera, jax.random.PRNGKey(7), config))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_sharded_matches_single_device():
    """8-virtual-device shard_map of the kernel is bit-exact vs one device:
    per-pixel work is identical; only the pixel->device assignment changes."""
    from rayz_tpu.ops.megakernel import render_pallas_sharded
    from rayz_tpu.parallel import make_mesh

    scene = _mirror_scene()
    camera = rt.make_camera(width=48, height=32, vfov=60.0, focus_dist=1.0,
                            defocus_angle=0.0, look_from=(0, 0.4, 1),
                            look_at=(0, 0, -1))
    config = rt.RenderConfig(spp=1, max_depth=4, t_min=1e-3, jitter=False)
    mesh = make_mesh(jax.devices())
    assert mesh.size == 8
    img_s = np.asarray(render_pallas_sharded(scene, camera, 0, config, mesh,
                                             interpret=True))
    img_1 = np.asarray(render_pallas(scene, camera, 0, config,
                                     interpret=True))
    np.testing.assert_array_equal(img_s, img_1)


def _nested_checker_scene():
    b = SceneBuilder()
    e = b.add_solid_texture((0.1, 0.1, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    inner = b.add_checker_texture(0.3, e, o)
    outer = b.add_checker_texture(1.1, inner, o)  # checker inside checker
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(texture=outer))
    return b.build()


def test_nested_checker_rejected_not_degraded():
    """A checker nested inside a checker renders correctly only on the XLA
    engine (4-level chase, shade.py); the kernel resolves one level and
    must REJECT such scenes — clear error on explicit request, XLA on
    auto — instead of silently shading differently."""
    from rayz_tpu.ops.engine import pick_engine

    nested = _nested_checker_scene()
    assert nested.deep_checker
    assert not supports_scene(nested)
    assert pick_engine(nested, "auto") == "xla"
    cam = rt.make_camera(width=8, height=8, vfov=60.0, focus_dist=1.0,
                         look_from=(0, 0.5, 1), look_at=(0, 0, -1))
    cfg = rt.RenderConfig(spp=1, max_depth=2, jitter=False)
    with pytest.raises(ValueError, match="checker"):
        render_pallas(nested, cam, 0, cfg, interpret=True)
    # the XLA path renders it fine
    img = np.asarray(rt.render(nested, cam, jax.random.PRNGKey(0), cfg))
    assert np.isfinite(img).all()

    # one-level checker scenes stay on the kernel
    b2 = SceneBuilder()
    e2 = b2.add_solid_texture((0.1, 0.1, 0.1))
    o2 = b2.add_solid_texture((0.9, 0.9, 0.9))
    flat = b2.add_checker_texture(0.5, e2, o2)
    b2.add_sphere((0, -100.5, -1), 100.0, b2.add_diffuse(texture=flat))
    assert not b2.build().deep_checker
