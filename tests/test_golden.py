"""Deterministic golden image: both engines locked to one committed PPM.

The deterministic camera path (jitter off, t = 0) is seed-free when the scene
consumes no scatter randomness (fuzz-0 metals only — diffuse and dielectric
draw randoms even with jitter off, and the kernel's PRNG stream differs from
``jax.random``). This locks the full geometry/shading/texture pipeline of
every engine to the byte level (image.zig:29-41 output semantics): any future
kernel change that drifts the deterministic semantics of ANY engine fails
here against a committed artifact, not just against a sibling engine.

Regenerate (only for an intentional semantic change):
    python tests/test_golden.py   # rewrites tests/golden_deterministic.ppm
"""

import io
import os

import jax
import jax.numpy as jnp
import numpy as np

import rayz_tpu as rt
from rayz_tpu.io.image import read_ppm, write_ppm

GOLDEN = os.path.join(os.path.dirname(__file__), "golden_deterministic.ppm")


def _scene():
    b = rt.SceneBuilder()
    e = b.add_solid_texture((0.2, 0.3, 0.1))
    o = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.5, e, o)
    b.add_sphere((0, -100.5, -2), 100.0,
                 b.add_metallic(texture=checker, fuzz=0.0))
    b.add_sphere((0, 0, -2), 0.5, b.add_metallic(color=(0.9, 0.6, 0.3),
                                                 fuzz=0.0))
    b.add_sphere((-1.1, 0, -2.4), 0.45, b.add_metallic(color=(0.6, 0.8, 0.9),
                                                       fuzz=0.0))
    b.add_triangle((0.6, -0.2, -1.6), (1.4, -0.2, -1.9), (1.0, 0.7, -1.8),
                   b.add_metallic(color=(0.8, 0.8, 0.8), fuzz=0.0))
    scene = b.build(dtype=jnp.float32)
    cam = rt.make_camera(width=96, height=64, vfov=55.0, focus_dist=1.0,
                         defocus_angle=0.0, look_from=(0, 0.2, 0.6),
                         look_at=(0, 0, -2), dtype=jnp.float32)
    return scene, cam


CFG = rt.RenderConfig(spp=1, max_depth=8, jitter=False)


def _engines(interpret=True):
    """(name, image) for each engine; ``interpret=False`` compiles the
    kernel for the GPU (chip_smoke.py)."""
    from rayz_tpu.ops.megakernel import render_pallas

    scene, cam = _scene()
    key = jax.random.PRNGKey(0)
    yield "xla", np.asarray(rt.render(scene, cam, key, CFG))
    yield "pallas", np.asarray(render_pallas(scene, cam, 0, CFG,
                                             interpret=interpret))


def _ppm_bytes(img) -> bytes:
    buf = io.BytesIO()
    write_ppm(img, buf)
    return buf.getvalue()


def check_golden(engines):
    """Byte-level lock with a quantization allowance: engines legitimately
    differ in float association order (e.g. the kernel compares roots in
    q = t*|d|^2 space), so a pixel sitting exactly on a u8 gamma step can
    round either way — allow ±1 step on <0.5% of channel values, exact
    everywhere else. Real semantic drift moves many pixels by many steps."""
    golden = read_ppm(GOLDEN).astype(np.int32)
    assert golden.shape == (64, 96, 3)
    for name, img in engines:
        u8 = read_ppm(io.BytesIO(_ppm_bytes(img))).astype(np.int32)
        diff = np.abs(u8 - golden)
        assert diff.max() <= 1, (
            f"engine {name!r} drifted from the committed golden: "
            f"max step {diff.max()}")
        frac = (diff > 0).mean()
        assert frac < 0.005, (
            f"engine {name!r}: {frac:.2%} of channel values off the golden")


def test_all_engines_match_committed_golden():
    check_golden(_engines())


if __name__ == "__main__":
    scene, cam = _scene()
    img = np.asarray(rt.render(scene, cam, jax.random.PRNGKey(0), CFG))
    with open(GOLDEN, "wb") as f:
        f.write(_ppm_bytes(img))
    print(f"wrote {GOLDEN}")
