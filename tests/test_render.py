"""End-to-end render tests: deterministic sky golden, statistical parity of the
JAX renderer against the independent NumPy float64 oracle (tests/oracle.py),
image IO roundtrips, and chunking equivalence."""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rayz_tpu as rt
from rayz_tpu.ops.shade import sky_color

from oracle import OracleCamera, render_oracle


def test_sky_only_render_deterministic():
    """Empty scene, jitter off, 1 spp: every pixel must be exactly the sky
    color of its deterministic camera ray."""
    b = rt.SceneBuilder()
    scene = b.build(dtype=jnp.float64)  # no primitives (padding only)
    cam = rt.make_camera(width=32, height=18, vfov=90.0, focus_dist=1.0,
                         look_from=(0, 0, 0), look_at=(0, 0, -1),
                         dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=1, max_depth=4, jitter=False)
    img = rt.render(scene, cam, jax.random.PRNGKey(0), cfg)
    xs = jnp.arange(32)
    ys = jnp.arange(18)
    gx, gy = jnp.meshgrid(xs, ys)
    _, d, _ = rt.generate_rays(cam, gx, gy, key=None)
    expected = sky_color(d)
    np.testing.assert_allclose(np.asarray(img), np.asarray(expected), atol=1e-12)


def test_render_matches_oracle_two_sphere():
    """Statistical parity: JAX renderer vs the independent NumPy oracle on the
    two-sphere scene. Both estimates converge to the same integral; compare
    block means within Monte-Carlo tolerance."""
    W = H = 48
    spp = 96
    scene, cam = rt.scenes.two_sphere(width=W, height=H, dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=spp, max_depth=8, t_min=1e-3)
    img = np.asarray(rt.render_jit(scene, cam, jax.random.PRNGKey(7), cfg))

    ocam = OracleCamera(width=W, height=H, vfov=90.0, focus_dist=1.0,
                        defocus_angle=0.0, look_from=(0, 0, 0),
                        look_at=(0, 0, -1))
    oimg = render_oracle(scene, ocam, spp=spp, max_depth=8, t_min=1e-3, seed=3)

    # global means very tight
    assert np.abs(img.mean(axis=(0, 1)) - oimg.mean(axis=(0, 1))).max() < 0.01
    # 8x8 block means within Monte-Carlo noise
    bi = img.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    bo = oimg.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    assert np.abs(bi - bo).max() < 0.035


def test_render_matches_oracle_materials_mix():
    """Parity on a scene exercising metal + dielectric + motion blur +
    checker."""
    W = H = 40
    spp = 128
    b = rt.SceneBuilder()
    even = b.add_solid_texture((0.2, 0.3, 0.1))
    odd = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.5, even, odd)
    ground = b.add_diffuse(texture=checker)
    metal = b.add_metallic(color=(0.8, 0.8, 0.9), fuzz=0.2)
    glass = b.add_dielectric(1.5)
    diff = b.add_diffuse(color=(0.7, 0.3, 0.3))
    b.add_sphere((0, -100.5, -1), 100.0, ground)
    b.add_sphere((-1.05, 0, -1.2), 0.5, metal)
    b.add_sphere((0, 0, -1.2), 0.5, glass)
    b.add_sphere((1.05, 0, -1.2), 0.5, diff, velocity=(0, 0.3, 0))
    scene = b.build(dtype=jnp.float64)
    cam = rt.make_camera(width=W, height=H, vfov=60.0, focus_dist=1.0,
                         look_from=(0, 0.4, 1.2), look_at=(0, 0, -1.2),
                         dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=spp, max_depth=12, t_min=1e-3)
    img = np.asarray(rt.render_jit(scene, cam, jax.random.PRNGKey(11), cfg))

    ocam = OracleCamera(width=W, height=H, vfov=60.0, focus_dist=1.0,
                        defocus_angle=0.0, look_from=(0, 0.4, 1.2),
                        look_at=(0, 0, -1.2))
    oimg = render_oracle(scene, ocam, spp=spp, max_depth=12, t_min=1e-3, seed=5)

    assert np.abs(img.mean(axis=(0, 1)) - oimg.mean(axis=(0, 1))).max() < 0.015
    bi = img.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    bo = oimg.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    assert np.abs(bi - bo).max() < 0.05


def test_render_matches_oracle_six_deep_checker():
    """Exact checker-nesting semantics: a
    6-deep nested checker — beyond the old 4-level unroll — must render
    identically to the oracle's unbounded recursive chase on the XLA
    engine. Scene.tex_depth (static, computed by the builder) sizes the
    chase exactly; diffuse-only paths make texture color the dominant
    signal."""
    W = H = 32
    b = rt.SceneBuilder()
    cur = b.add_solid_texture((0.9, 0.1, 0.1))
    other = b.add_solid_texture((0.1, 0.1, 0.9))
    # scales shrink by 2x per level -> every level's parity matters
    for lvl in range(5):
        cur = b.add_checker_texture(1.6 / (2 ** lvl), cur, other)
    b.add_sphere((0, -100.5, -2), 100.0, b.add_diffuse(texture=cur))
    b.add_sphere((0, 0, -2), 0.5, b.add_diffuse(texture=cur))
    scene = b.build(dtype=jnp.float64)
    assert scene.tex_depth == 6 and scene.deep_checker
    cfg = rt.RenderConfig(spp=64, max_depth=4, t_min=1e-3)
    cam = rt.make_camera(width=W, height=H, vfov=55.0, focus_dist=1.0,
                         look_from=(0, 0, 0), look_at=(0, 0, -1),
                         dtype=jnp.float64)
    img = np.asarray(rt.render_jit(scene, cam, jax.random.PRNGKey(7), cfg))

    ocam = OracleCamera(width=W, height=H, vfov=55.0, focus_dist=1.0,
                        defocus_angle=0.0, look_from=(0, 0, 0),
                        look_at=(0, 0, -1))
    oimg = render_oracle(scene, ocam, spp=64, max_depth=4, t_min=1e-3,
                         seed=3)
    assert np.abs(img.mean(axis=(0, 1)) - oimg.mean(axis=(0, 1))).max() < 0.015
    bi = img.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    bo = oimg.reshape(H // 8, 8, W // 8, 8, 3).mean(axis=(1, 3))
    assert np.abs(bi - bo).max() < 0.05


def test_chunked_render_equivalent():
    """Chunking is an implementation detail: same key -> same image."""
    scene, cam = rt.scenes.two_sphere(width=32, height=24, dtype=jnp.float64)
    key = jax.random.PRNGKey(0)
    full = rt.render(scene, cam, key, rt.RenderConfig(spp=2, max_depth=4))
    # NB: chunking changes per-chunk key derivation, so compare statistics
    # only loosely... but with chunk covering everything it must be identical.
    same = rt.render(scene, cam, key, rt.RenderConfig(spp=2, max_depth=4, chunk_size=32 * 24))
    np.testing.assert_allclose(np.asarray(full), np.asarray(same), atol=1e-12)
    # uneven chunking still renders every pixel sanely
    chunked = rt.render(scene, cam, key, rt.RenderConfig(spp=16, max_depth=4, chunk_size=100))
    base = rt.render(scene, cam, key, rt.RenderConfig(spp=16, max_depth=4))
    assert np.abs(np.asarray(chunked).mean() - np.asarray(base).mean()) < 0.02


def test_f32_close_to_f64():
    """The production f32 path must track the f64 path (guards against
    precision regressions like low-precision matmuls)."""
    spp = 64
    s64, c64 = rt.scenes.two_sphere(width=32, height=32, dtype=jnp.float64)
    s32, c32 = rt.scenes.two_sphere(width=32, height=32, dtype=jnp.float32)
    cfg = rt.RenderConfig(spp=spp, max_depth=8)
    key = jax.random.PRNGKey(2)
    i64 = np.asarray(rt.render(s64, c64, key, cfg))
    i32 = np.asarray(rt.render(s32, c32, key, cfg))
    assert np.abs(i64.mean(axis=(0, 1)) - i32.mean(axis=(0, 1))).max() < 0.01


def test_ppm_roundtrip_and_format():
    img = np.array([[[0.0, 0.25, 1.0], [1.5, -0.2, 0.5]]])  # 1x2
    buf = io.BytesIO()
    rt.write_ppm(img, buf)
    text = buf.getvalue().decode()
    lines = text.strip().split("\n")
    # header P3 / dims / 255 (image.zig:31)
    assert lines[0] == "P3"
    assert lines[1] == "2 1"
    assert lines[2] == "255"
    # gamma 2 + clamp + truncate (image.zig:33-37): sqrt(0.25)=0.5 -> 127
    assert lines[3] == "0 127 255"
    assert lines[4] == "255 0 180"  # sqrt(1.5) clamps to 1; -0.2 -> 0; sqrt(.5)*255=180.3
    buf.seek(0)
    back = rt.read_ppm(buf)
    assert back.shape == (1, 2, 3)
    assert back[0, 0, 1] == 127


def test_png_writes_valid_signature(tmp_path):
    img = np.random.default_rng(0).random((8, 8, 3))
    p = tmp_path / "out.png"
    rt.write_png(img, str(p))
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    assert b"IHDR" in data and b"IDAT" in data and b"IEND" in data
