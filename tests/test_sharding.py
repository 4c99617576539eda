"""Multi-device sharding tests on the 8-device virtual CPU mesh (conftest),
the analogue of a fake distributed backend (SURVEY.md §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax

import rayz_tpu as rt
from rayz_tpu.diff import extract_params, make_train_step
from rayz_tpu.parallel import make_mesh, render_sharded, render_sharded_jit


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_sharded_render_matches_unsharded_statistically():
    scene, cam = rt.scenes.two_sphere(width=24, height=24, dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=32, max_depth=5)
    mesh = make_mesh()
    key = jax.random.PRNGKey(0)
    sharded = np.asarray(render_sharded_jit(scene, cam, key, cfg, mesh))
    local = np.asarray(rt.render(scene, cam, key, cfg))
    assert sharded.shape == local.shape == (24, 24, 3)
    # different RNG streams -> statistical agreement only
    assert np.abs(sharded.mean(axis=(0, 1)) - local.mean(axis=(0, 1))).max() < 0.02


def test_sharded_render_deterministic():
    scene, cam = rt.scenes.two_sphere(width=16, height=16, dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=2, max_depth=3)
    mesh = make_mesh()
    key = jax.random.PRNGKey(3)
    a = np.asarray(render_sharded_jit(scene, cam, key, cfg, mesh))
    b = np.asarray(render_sharded_jit(scene, cam, key, cfg, mesh))
    np.testing.assert_array_equal(a, b)


def test_sharded_render_nondivisible_pixels():
    # 18x10 = 180 pixels, not divisible by 8: padding path
    scene, cam = rt.scenes.two_sphere(width=18, height=10, dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=2, max_depth=3)
    mesh = make_mesh()
    img = np.asarray(render_sharded(scene, cam, jax.random.PRNGKey(1), cfg, mesh))
    assert img.shape == (10, 18, 3)
    assert np.isfinite(img).all()


def test_sharded_train_step_psum_grads():
    """Sharded train step must agree with the single-device step on loss and
    make progress; gradients are psum-reduced across the mesh."""
    scene, cam = rt.scenes.two_sphere(width=16, height=16, dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=2, max_depth=3)
    target = rt.render(scene, cam, jax.random.PRNGKey(7), cfg)
    params = extract_params(scene, ("tex_color",))
    opt = optax.adam(1e-2)

    mesh = make_mesh()
    step_sharded = make_train_step(opt, cfg, mesh)
    state = opt.init(params)
    p1, s1, loss_sharded = step_sharded(params, state, scene, cam,
                                        jax.random.PRNGKey(0), target)
    assert bool(jnp.isfinite(loss_sharded))
    # a couple of steps reduce the loss on average
    p, s = p1, s1
    losses = [float(loss_sharded)]
    for i in range(3):
        p, s, l = step_sharded(p, s, scene, cam, jax.random.PRNGKey(i + 1), target)
        losses.append(float(l))
    assert min(losses) <= losses[0]


def _mirror_scene(dtype):
    b = rt.SceneBuilder()
    m = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.0)
    b.add_sphere((0, -100.5, -2), 100.0, m)
    b.add_sphere((0, 0, -2), 0.5, m)
    return b.build(dtype=dtype)


def test_sharded_dense_step_matches_single_device():
    """Mesh train step with the dense engine on a zero-randomness scene
    (fuzz-0 metal, jitter off): the radiance is key-independent, so the
    sharded psum'd gradients must EQUAL the single-device gradients."""
    scene = _mirror_scene(jnp.float64)
    cam = rt.make_camera(width=16, height=16, vfov=55.0, focus_dist=1.0,
                         look_from=(0, 0, 0), look_at=(0, 0, -1),
                         dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=1, max_depth=4, jitter=False)
    target = jnp.zeros((16, 16, 3), dtype=jnp.float64)
    params = extract_params(scene, ("sphere_center", "tex_color"))
    opt = optax.sgd(1e-2)

    from rayz_tpu.diff import pixel_loss
    loss_1, grads_1 = jax.value_and_grad(pixel_loss)(
        params, scene, cam, jax.random.PRNGKey(0), target, cfg, "dense")

    step = make_train_step(opt, cfg, make_mesh(), engine="dense")
    state = opt.init(params)
    p1, _, loss_8 = step(params, state, scene, cam, jax.random.PRNGKey(0),
                         target)
    np.testing.assert_allclose(float(loss_8), float(loss_1), rtol=1e-12)
    expected = optax.apply_updates(
        params, opt.update(grads_1, opt.init(params), params)[0])
    for k in params:
        np.testing.assert_allclose(np.asarray(p1[k]), np.asarray(expected[k]),
                                   rtol=1e-10, atol=1e-12)


def test_sharded_dense_step_padded_pixels_match_single_device():
    """18x10 = 180 pixels over 8 devices: the padding pixels render but are
    weighted out, so loss and gradients still equal the single device's."""
    scene = _mirror_scene(jnp.float64)
    cam = rt.make_camera(width=18, height=10, vfov=55.0, focus_dist=1.0,
                         look_from=(0, 0, 0), look_at=(0, 0, -1),
                         dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=1, max_depth=3, jitter=False)
    target = jnp.full((10, 18, 3), 0.25, dtype=jnp.float64)
    params = extract_params(scene, ("tex_color",))
    opt = optax.sgd(1e-1)
    p1, _, l1 = make_train_step(opt, cfg)(
        params, opt.init(params), scene, cam, jax.random.PRNGKey(2), target)
    pm, _, lm = make_train_step(opt, cfg, make_mesh())(
        params, opt.init(params), scene, cam, jax.random.PRNGKey(2), target)
    np.testing.assert_allclose(float(lm), float(l1), rtol=1e-12)
    np.testing.assert_allclose(np.asarray(pm["tex_color"]),
                               np.asarray(p1["tex_color"]), rtol=1e-10)


def test_dryrun_multichip_entrypoint():
    import sys, pathlib
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import __graft_entry__ as ge

    ge.dryrun_multichip(8)


def test_sharded_kernel_matches_single_device_stochastic():
    """The kernel's PRNG counter holds the GLOBAL pixel index, so the
    8-device sharded render (interpret mode) equals the one-device render
    even with jitter, diffuse and glass drawing random numbers."""
    from rayz_tpu.ops.megakernel import render_pallas, render_pallas_sharded

    scene, cam = rt.scenes.three_sphere(width=20, height=12)
    cfg = rt.RenderConfig(spp=3, max_depth=4)
    a = np.asarray(render_pallas_sharded(scene, cam, 11, cfg, make_mesh(),
                                         interpret=True))
    b = np.asarray(render_pallas(scene, cam, 11, cfg, interpret=True))
    np.testing.assert_array_equal(a, b)
    assert a.std() > 0.01
