"""BASELINE config 5 at scale: inverse rendering of a 100-sphere scene via
Adam on pixel L2 (recover albedo AND sphere positions), with the dense
gradient engine and .npz checkpoint/resume wired into fit().

The reference has no inverse rendering or checkpointing (SURVEY.md §5); this
is the framework's headline extension (BASELINE.json north star + config 5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax

import rayz_tpu as rt
from rayz_tpu.diff import fit
from rayz_tpu.diff.checkpoint import latest_step


def test_config5_recovery_100_spheres(tmp_path):
    """Perturb every sphere's in-image position (xz; depth along the view
    axis is ~unobservable from one view) and every albedo, then recover both
    with Adam + engine='dense'. Checkpoints are written mid-fit."""
    scene, cam = rt.scenes.sphere_grid(100, width=48, dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=8, max_depth=3)
    target = rt.render(scene, cam, jax.random.PRNGKey(7),
                       rt.RenderConfig(spp=16, max_depth=3))

    rng = np.random.default_rng(1)
    d_center = jnp.asarray(rng.normal(0, 0.06, scene.sphere_center.shape))
    d_center = d_center.at[:, 1].set(0.0) * scene.sphere_valid[:, None]
    d_alb = jnp.asarray(rng.normal(0, 0.15, scene.tex_color.shape))
    wrong = scene.replace(
        sphere_center=scene.sphere_center + d_center,
        tex_color=jnp.clip(scene.tex_color + d_alb, 0.02, 0.98),
    )
    valid = np.asarray(scene.sphere_valid)
    err_c0 = np.abs(np.asarray(d_center))[valid][:, [0, 2]]
    err_a0 = np.abs(np.asarray(wrong.tex_color - scene.tex_color))

    steps = 300
    ckpt_dir = str(tmp_path / "ckpt")
    fitted, hist = fit(
        wrong, cam, target, config=cfg, steps=steps,
        learning_rate=optax.cosine_decay_schedule(2e-2, steps),
        fields=("sphere_center", "tex_color"), key=jax.random.PRNGKey(2),
        engine="dense", checkpoint_dir=ckpt_dir, checkpoint_every=150,
    )
    assert latest_step(ckpt_dir) == steps  # mid-fit saves + final save

    err_c = np.abs(np.asarray(fitted.sphere_center - scene.sphere_center))[
        valid][:, [0, 2]]
    err_a = np.abs(np.asarray(fitted.tex_color - scene.tex_color))
    assert hist[-1] < hist[0] * 0.5, (hist[0], hist[-1])
    # positions: mean xz error at least halved, worst sphere at least 2x
    # better (measured 0.042 -> 0.016 mean, 0.186 -> 0.088 max)
    assert err_c.mean() < 0.55 * err_c0.mean(), (err_c.mean(), err_c0.mean())
    assert err_c.max() < 0.60 * err_c0.max(), (err_c.max(), err_c0.max())
    # albedo: recovered to < 0.12 worst-channel (initial worst 0.46)
    assert err_a.max() < 0.12, err_a.max()
    assert err_a.mean() < 0.35 * err_a0.mean(), (err_a.mean(), err_a0.mean())


def test_fit_checkpoint_resume_same_trajectory(tmp_path):
    """An interrupted fit resumed from its checkpoint must reproduce
    the exact params an uninterrupted run produces (optimizer state AND the
    step RNG key are checkpointed)."""
    scene, cam = rt.scenes.two_sphere(width=12, height=12, dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=1, max_depth=3)
    target = rt.render(scene, cam, jax.random.PRNGKey(42), cfg)
    wrong = scene.replace(tex_color=scene.tex_color.at[1].set(
        jnp.asarray([0.2, 0.8, 0.9], dtype=jnp.float64)))
    kw = dict(config=cfg, learning_rate=5e-2, fields=("tex_color",),
              key=jax.random.PRNGKey(1))

    ref, hist_ref = fit(wrong, cam, target, steps=6, **kw)

    ckpt_dir = str(tmp_path / "resume")
    mid, hist_a = fit(wrong, cam, target, steps=3, checkpoint_dir=ckpt_dir,
                      checkpoint_every=3, **kw)
    assert latest_step(ckpt_dir) == 3
    res, hist_b = fit(wrong, cam, target, steps=6, checkpoint_dir=ckpt_dir,
                      checkpoint_every=3, **kw)
    assert len(hist_b) == 3  # only the remaining steps ran
    np.testing.assert_array_equal(np.asarray(res.tex_color),
                                  np.asarray(ref.tex_color))
    np.testing.assert_allclose(hist_a + hist_b, hist_ref, rtol=0, atol=0)


def test_fit_resume_noop_when_complete(tmp_path):
    scene, cam = rt.scenes.two_sphere(width=8, height=8, dtype=jnp.float64)
    cfg = rt.RenderConfig(spp=1, max_depth=2)
    target = rt.render(scene, cam, jax.random.PRNGKey(0), cfg)
    ckpt_dir = str(tmp_path / "done")
    kw = dict(config=cfg, learning_rate=1e-2, fields=("tex_color",),
              key=jax.random.PRNGKey(1), checkpoint_dir=ckpt_dir,
              checkpoint_every=2)
    a, _ = fit(scene, cam, target, steps=4, **kw)
    b, hist = fit(scene, cam, target, steps=4, **kw)
    assert hist == []  # already complete: restores and runs nothing
    np.testing.assert_array_equal(np.asarray(a.tex_color),
                                  np.asarray(b.tex_color))
