"""Differentiability tests: reverse-mode gradients of the pixel loss vs
central finite differences (BASELINE north star: "grad-checked backward").

Common-random-numbers: with a fixed PRNG key the rendered image is a
deterministic function of scene parameters, so finite differences are
well-defined. Albedo gradients are exactly smooth (attenuation products);
geometry gradients (center/radius) are smooth a.e. — FD probes avoid
silhouette crossings by using small steps in float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import rayz_tpu as rt
from rayz_tpu.diff import extract_params, fit, inject_params, pixel_loss


def _setup(dtype=jnp.float64, method=None):
    """``method=None`` uses the reference-default HEMISPHERE diffuse. NOTE:
    hemisphere scatter is ``s * sign(s . n)`` — piecewise constant in the
    normal — so under sky-only lighting GEOMETRY gradients are zero a.e.;
    geometry grad tests pass ``method=DIFFUSE_UNIT_SPHERE`` (``n + s``,
    smooth in the normal) to have a nonzero gradient to check."""
    from rayz_tpu.models.scene import DIFFUSE_HEMISPHERE

    if method is None:
        method = DIFFUSE_HEMISPHERE
    b = rt.SceneBuilder()
    ground = b.add_diffuse(color=(0.5, 0.5, 0.5), method=method)
    ball = b.add_diffuse(color=(0.7, 0.3, 0.2), method=method)
    b.add_sphere((0, -100.5, -1), 100.0, ground)
    b.add_sphere((0, 0, -1.2), 0.5, ball)
    scene = b.build(dtype=dtype)
    cam = rt.make_camera(width=24, height=24, vfov=60.0, focus_dist=1.0,
                         look_from=(0, 0, 0), look_at=(0, 0, -1), dtype=dtype)
    cfg = rt.RenderConfig(spp=2, max_depth=4)
    key = jax.random.PRNGKey(5)
    target = rt.render(scene, cam, jax.random.PRNGKey(99), cfg)
    return scene, cam, cfg, key, target


def _fd_grad(f, params, field, index, eps):
    p_plus = dict(params)
    p_minus = dict(params)
    flat = params[field].reshape(-1)
    delta = jnp.zeros_like(flat).at[index].set(eps).reshape(params[field].shape)
    p_plus[field] = params[field] + delta
    p_minus[field] = params[field] - delta
    return (f(p_plus) - f(p_minus)) / (2 * eps)


def test_albedo_grad_matches_fd():
    scene, cam, cfg, key, target = _setup()
    params = extract_params(scene, ("tex_color",))
    f = lambda p: pixel_loss(p, scene, cam, key, target, cfg)
    g = jax.grad(f)(params)["tex_color"].reshape(-1)
    for idx in [0, 1, 2, 3, 4, 5]:  # both textures, all channels
        fd = float(_fd_grad(f, params, "tex_color", idx, 1e-5))
        ad = float(g[idx])
        assert abs(ad - fd) <= 1e-6 + 1e-4 * abs(fd), (idx, ad, fd)


def test_center_and_radius_grad_match_fd():
    from rayz_tpu.models.scene import DIFFUSE_UNIT_SPHERE

    scene, cam, cfg, key, target = _setup(method=DIFFUSE_UNIT_SPHERE)
    params = extract_params(scene, ("sphere_center", "sphere_radius"))
    f = lambda p: pixel_loss(p, scene, cam, key, target, cfg)
    grads = jax.grad(f)(params)
    # geometry gradients must be NONZERO (with UNIT_SPHERE scatter the
    # estimator depends smoothly on the normal; a zero here would make the
    # FD comparison vacuous)
    assert float(jnp.abs(grads["sphere_center"]).sum()) > 0
    assert float(jnp.abs(grads["sphere_radius"]).sum()) > 0
    # ball center z component (index: sphere 1, axis 2 -> flat 5)
    fd = float(_fd_grad(f, params, "sphere_center", 5, 1e-6))
    ad = float(grads["sphere_center"].reshape(-1)[5])
    assert abs(ad - fd) <= 1e-5 + 5e-3 * abs(fd), (ad, fd)
    # ball radius (index 1)
    fd = float(_fd_grad(f, params, "sphere_radius", 1, 1e-6))
    ad = float(grads["sphere_radius"].reshape(-1)[1])
    assert abs(ad - fd) <= 1e-5 + 5e-3 * abs(fd), (ad, fd)


def test_hemisphere_diffuse_geometry_grad_is_zero_ae():
    """Documents an estimator property: with the reference-default HEMISPHERE
    scatter (direction s * sign(s.n), material.zig:81-84) the radiance is
    piecewise constant in sphere geometry under sky-only lighting, so AD
    geometry gradients are exactly zero a.e. (inverse rendering of geometry
    needs UNIT_SPHERE diffuse, metal, or dielectric paths)."""
    scene, cam, cfg, key, target = _setup()
    params = extract_params(scene, ("sphere_center", "sphere_radius"))
    g = jax.grad(pixel_loss)(params, scene, cam, key, target, cfg)
    assert float(jnp.abs(g["sphere_center"]).sum()) == 0.0
    assert float(jnp.abs(g["sphere_radius"]).sum()) == 0.0


def test_gradients_finite_on_full_material_mix():
    """No NaN/Inf gradients through metal/dielectric/checker/motion paths."""
    b = rt.SceneBuilder()
    even = b.add_solid_texture((0.2, 0.3, 0.1))
    odd = b.add_solid_texture((0.9, 0.9, 0.9))
    checker = b.add_checker_texture(0.5, even, odd)
    b.add_sphere((0, -100.5, -1), 100.0, b.add_diffuse(texture=checker))
    b.add_sphere((-1, 0, -1.2), 0.5, b.add_metallic(color=(0.8, 0.8, 0.9), fuzz=0.3))
    b.add_sphere((0, 0, -1.2), 0.5, b.add_dielectric(1.5))
    b.add_sphere((1, 0, -1.2), 0.5, b.add_diffuse(color=(0.7, 0.3, 0.3)),
                 velocity=(0, 0.3, 0))
    scene = b.build(dtype=jnp.float64)
    cam = rt.make_camera(width=16, height=16, vfov=60.0, focus_dist=1.0,
                         look_from=(0, 0.3, 1), look_at=(0, 0, -1.2),
                         dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=2, max_depth=5)
    target = jnp.zeros((16, 16, 3), dtype=jnp.float64)
    params = extract_params(scene)
    g = jax.grad(pixel_loss)(params, scene, cam, jax.random.PRNGKey(0), target, cfg)
    for name, leaf in g.items():
        assert bool(jnp.isfinite(leaf).all()), name
    # attenuation gradients must actually be nonzero
    assert float(jnp.abs(g["tex_color"]).sum()) > 0


def test_fit_recovers_albedo():
    """Adam on pixel L2 recovers a perturbed albedo (config 5 in miniature)."""
    scene, cam, cfg, key, _ = _setup()
    target = rt.render(scene, cam, jax.random.PRNGKey(42), cfg)
    # perturb the ball albedo and fit only tex_color
    wrong = scene.replace(tex_color=scene.tex_color.at[1].set(
        jnp.asarray([0.2, 0.8, 0.9], dtype=jnp.float64)))
    fitted, history = fit(
        wrong, cam, target, config=cfg, steps=60, learning_rate=5e-2,
        fields=("tex_color",), key=jax.random.PRNGKey(1),
    )
    assert history[-1] < history[0] * 0.2
    err = np.abs(np.asarray(fitted.tex_color[1]) - np.array([0.7, 0.3, 0.2]))
    assert err.max() < 0.1, (np.asarray(fitted.tex_color[1]), history[-5:])


def _fd_scene():
    """Every trainable kind visible in 16x16 pixels: smooth-normal diffuse
    ground, fuzzy metal ball, glass ball, a moving diffuse ball and a fuzzy
    metal triangle. Returns (scene, camera, {name: material index})."""
    from rayz_tpu.models.scene import DIFFUSE_UNIT_SPHERE

    b = rt.SceneBuilder()
    ground = b.add_diffuse(color=(0.5, 0.6, 0.5), method=DIFFUSE_UNIT_SPHERE)
    metal = b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.3)
    glass = b.add_dielectric(1.5)
    mover = b.add_diffuse(color=(0.7, 0.3, 0.2), method=DIFFUSE_UNIT_SPHERE)
    tri = b.add_metallic(color=(0.6, 0.8, 0.9), fuzz=0.1)
    b.add_sphere((0, -100.5, -1.5), 100.0, ground)
    b.add_sphere((-0.6, 0.0, -1.5), 0.45, metal)
    b.add_sphere((0.5, 0.0, -1.4), 0.4, glass)
    b.add_sphere((0.0, 0.55, -2.0), 0.3, mover, velocity=(0.0, 0.2, 0.0))
    b.add_triangle((-1.2, -0.4, -2.2), (1.2, -0.4, -2.4), (0.0, 1.2, -2.6),
                   tri)
    scene = b.build(dtype=jnp.float64)
    cam = rt.make_camera(width=16, height=16, vfov=70.0, focus_dist=1.0,
                         look_from=(0, 0.1, 0), look_at=(0, 0, -1.5),
                         dtype=jnp.float64)
    return scene, cam, dict(metal=metal, glass=glass, tri=tri)


# (field, flat index or material name, scaled to a flat index below)
FD_CASES = {
    "tex_color": ("tex_color", ("tex", "metal", 0)),
    "mat_fuzz": ("mat_fuzz", ("mat", "metal")),
    "mat_ior": ("mat_ior", ("mat", "glass")),
    "sphere_center": ("sphere_center", ("flat", 1 * 3 + 2)),
    "sphere_radius": ("sphere_radius", ("flat", 2)),
    "sphere_velocity": ("sphere_velocity", ("flat", 3 * 3 + 1)),
    "tri_v0": ("tri_v0", ("flat", 0)),
    "tri_v2": ("tri_v2", ("flat", 1)),
}


@pytest.mark.parametrize("case", sorted(FD_CASES))
def test_dense_grad_matches_fd(case):
    """Reverse-mode gradient of the dense engine vs central differences in
    float64, one parameter of each trainable kind (common random numbers:
    the key is fixed, so the loss is a deterministic function)."""
    scene, cam, mats = _fd_scene()
    field, where = FD_CASES[case]
    if where[0] == "flat":
        index = where[1]
    elif where[0] == "mat":
        index = mats[where[1]]
    else:
        tex = int(scene.mat_texture[mats[where[1]]])
        index = tex * 3 + where[2]
    cfg = rt.RenderConfig(spp=2, max_depth=4)
    target = jnp.zeros((16, 16, 3), jnp.float64)
    key = jax.random.PRNGKey(11)
    params = extract_params(scene, (field,))
    f = lambda p: pixel_loss(p, scene, cam, key, target, cfg)
    ad = float(jax.grad(f)(params)[field].reshape(-1)[index])
    fd = float(_fd_grad(f, params, field, index, 1e-6))
    assert abs(ad) > 1e-7, (case, ad)  # a zero would make the check vacuous
    assert abs(ad - fd) <= 1e-6 + 5e-3 * abs(fd), (case, ad, fd)


@pytest.mark.gpu
def test_dense_grad_matches_fd_float32(gpu):
    """On the card, in float32: albedo gradients of the dense engine vs
    central differences with step 1e-2. With the key fixed the loss is a
    polynomial in the albedos (products of attenuations along each path),
    so the step's truncation error is O(1e-4) relative and float32 rounding
    of the loss O(1e-5); the tolerance is 1e-2 relative to the largest
    component. (Geometry and fuzz move rays across silhouettes and the
    metal absorption test, so their float32 differences at a step this
    large are not a derivative; the float64 tests check them.)"""
    from rayz_tpu.models.scene import DIFFUSE_UNIT_SPHERE

    b = rt.SceneBuilder()
    b.add_sphere((0, -100.5, -1.5), 100.0,
                 b.add_diffuse(color=(0.5, 0.6, 0.5),
                               method=DIFFUSE_UNIT_SPHERE))
    b.add_sphere((-0.5, 0.0, -1.5), 0.45,
                 b.add_metallic(color=(0.8, 0.7, 0.6), fuzz=0.3))
    b.add_sphere((0.5, 0.0, -1.5), 0.45,
                 b.add_diffuse(color=(0.3, 0.4, 0.8)))
    scene = b.build(dtype=jnp.float32)
    cam = rt.make_camera(width=64, height=64, vfov=70.0, focus_dist=1.0,
                         look_from=(0, 0.1, 0), look_at=(0, 0, -1.5))
    cfg = rt.RenderConfig(spp=4, max_depth=4)
    target = jnp.full((64, 64, 3), 0.3, jnp.float32)
    key = jax.random.PRNGKey(3)
    params = extract_params(scene, ("tex_color",))
    f = jax.jit(lambda p: pixel_loss(p, scene, cam, key, target, cfg))
    grads = jax.grad(f)(params)
    for field in params:
        ad = np.asarray(grads[field]).reshape(-1)
        fd = np.array([float(_fd_grad(f, params, field, i, 1e-2))
                       for i in range(ad.size)])
        err = np.abs(ad - fd).max()
        print(f"float32 {field}: max |AD - FD| = {err:.3g}, max |FD| = "
              f"{np.abs(fd).max():.3g}")
        assert np.abs(fd).max() > 0
        assert err <= 1e-2 * np.abs(fd).max(), (field, ad, fd)


def test_gradients_finite_on_flagship_scene():
    """Every default trainable gradient is finite on the flagship scene
    (glass at total internal reflection and normal incidence, motion,
    checker): the square roots of the refraction branch are NaN-safe."""
    scene, cam = rt.scenes.random_bouncing(width=32, height=16)
    cfg = rt.RenderConfig(spp=2, max_depth=4)
    target = rt.render(scene, cam, jax.random.PRNGKey(0), cfg)
    g = jax.grad(pixel_loss)(extract_params(scene), scene, cam,
                             jax.random.PRNGKey(1), target, cfg)
    for name, leaf in g.items():
        assert bool(jnp.isfinite(leaf).all()), name
    assert float(jnp.abs(g["mat_ior"]).sum()) > 0
