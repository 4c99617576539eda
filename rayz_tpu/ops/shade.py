"""Texture evaluation, material scattering, and sky shading.

TPU-native replacement for the reference's tagged-union dispatch
(/root/reference/src/material.zig). Branchy per-ray dispatch becomes
compute-all-branches + masked select on integer kind codes (SURVEY.md §7
design delta #4); rejection-sampled directions become reparameterized samples
(utils.sampling). Every numeric formula below matches the reference term for
term, including its quirks — see the inline notes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..models.scene import (
    DIFFUSE_HEMISPHERE,
    DIFFUSE_UNIT_SPHERE,
    DIFFUSE_UNIT_SPHERE_SURFACE,
    MAT_DIELECTRIC,
    MAT_METALLIC,
    TEX_SOLID,
    Scene,
)
from ..utils import sampling, vec
from .intersect import HitRecord

__all__ = ["texture_value", "scatter", "sky_color", "schlick_reflectance"]

# Fallback chase depth for directly constructed Scenes (tex_depth == 0,
# unknown). Builder scenes carry their exact static nest depth.
MAX_TEXTURE_DEPTH = 4


def texture_value(scene: Scene, tex_idx: jnp.ndarray, point: jnp.ndarray) -> jnp.ndarray:
    """Batched Texture.value (material.zig:41-51).

    Solid returns its color (material.zig:19-25). Checker selects the even/odd
    child by the parity of floor(p.x/s)+floor(p.y/s)+floor(p.z/s)
    (material.zig:27-39). Child handles are chased for the scene's STATIC
    ``tex_depth`` levels — the builder computes the exact maximum nest depth,
    so this matches the reference's unbounded recursion for any expressible
    scene (each level resolves in a fixed-count unrolled step, keeping the
    whole evaluation reverse-differentiable, unlike a while_loop).
    """
    levels = scene.tex_depth if scene.tex_depth > 0 else MAX_TEXTURE_DEPTH
    cur = tex_idx
    done = jnp.zeros(tex_idx.shape, dtype=bool)
    out = jnp.zeros((*tex_idx.shape, 3), dtype=point.dtype)
    for _ in range(levels):
        kind = scene.tex_kind[cur]
        is_solid = kind == TEX_SOLID
        take = is_solid & ~done
        out = jnp.where(take[..., None], scene.tex_color[cur], out)
        done = done | is_solid
        # checker child selection (material.zig:33-37); Zig @mod == jnp floor
        # mod, so parity handles negative cells identically.
        scale = scene.tex_scale[cur][..., None]
        cells = jnp.floor(point / scale).astype(jnp.int32)
        even = (cells[..., 0] + cells[..., 1] + cells[..., 2]) % 2 == 0
        child = jnp.where(even, scene.tex_even[cur], scene.tex_odd[cur])
        cur = jnp.where(done, cur, child)
    # Unresolved only for a directly constructed Scene whose nest exceeds
    # the fallback depth: use the node's own color (builder scenes always
    # resolve — levels is their exact maximum depth).
    return jnp.where(done[..., None], out, scene.tex_color[cur])


def schlick_reflectance(cos_theta: jnp.ndarray, eta: jnp.ndarray) -> jnp.ndarray:
    """Schlick approximation (material.zig:179-183)."""
    r0 = (1.0 - eta) / (1.0 + eta)
    r0 = r0 * r0
    one_minus = 1.0 - cos_theta
    return r0 + (1.0 - r0) * one_minus ** 5


def sky_color(direction: jnp.ndarray) -> jnp.ndarray:
    """Miss shading (renderer.zig:124-125).

    NOTE the reference's exact (non-standard) formula: with
    t = 0.5*(unit(dir).y + 1), the color is ``t * ((1-t)*white + blue)`` —
    the trailing ``.mul(t)`` applies to the whole sum, NOT blue alone, so this
    is not the usual lerp. Reproduced bit-for-bit for parity.
    """
    dt = direction.dtype
    t = 0.5 * (vec.normalize(direction)[..., 1] + 1.0)
    t = t[..., None]
    white = jnp.ones((3,), dtype=dt)
    blue = jnp.asarray([0.5, 0.7, 1.0], dtype=dt)
    return (white * (1.0 - t) + blue) * t


def scatter(key, scene: Scene, direction, time, hit: HitRecord):
    """Batched Material.scatter (material.zig:162-177).

    Computes all three material branches for every ray and selects by the
    material kind code. Returns (new_dir [R,3], attenuation [R,3],
    scattered [R] bool). The scattered ray's origin is hit.point and its time
    is inherited (material.zig:93, :122, :156) — both handled by the caller.
    ``direction`` is the incoming ray direction (not normalized).
    """
    del time
    dt = direction.dtype
    shape = hit.t.shape
    kind = scene.mat_kind[hit.material]
    tex = scene.mat_texture[hit.material]
    fuzz = scene.mat_fuzz[hit.material]
    ior = scene.mat_ior[hit.material]
    method = scene.mat_method[hit.material]

    k_sph, k_unit, k_hemi, k_fuzz, k_coin = jax.random.split(key, 5)
    normal = hit.normal
    point = hit.point

    # ---- Diffuse (material.zig:75-101) ----
    s_sphere = sampling.random_in_unit_sphere(k_sph, shape, dt)
    s_unit = sampling.random_unit_vector(k_unit, shape, dt)
    s_hemi = sampling.random_in_hemisphere(k_hemi, shape, dt, normal)
    offset = jnp.where(
        (method == DIFFUSE_UNIT_SPHERE)[..., None],
        normal + s_sphere,
        jnp.where(
            (method == DIFFUSE_UNIT_SPHERE_SURFACE)[..., None],
            normal + s_unit,
            s_hemi,  # HEMISPHERE default
        ),
    )
    target = point + offset
    # Reference quirk (material.zig:85-86): the near-zero check is on the
    # target POINT (not the direction); a near-origin target snaps to the bare
    # normal, making the scatter direction normal - point.
    target = jnp.where(vec.near_zero(target)[..., None], normal, target)
    dir_diffuse = target - point
    albedo = texture_value(scene, tex, point)

    # ---- Metallic (material.zig:107-131) ----
    refl = vec.normalize(vec.reflect(direction, normal), eps=1e-20)
    # fuzz is clamped to <= 1 (material.zig:111); adding 0*unit when fuzz == 0
    # reproduces the reference's fuzz > 0 gate exactly.
    s_fuzz = sampling.random_unit_vector(k_fuzz, shape, dt)
    dir_metal = refl + jnp.minimum(fuzz, 1.0)[..., None] * s_fuzz
    # absorb if not scattered above the surface (material.zig:116-117)
    metal_ok = vec.dot(dir_metal, normal) > 0.0

    # ---- Dielectric (material.zig:136-159) ----
    eta = jnp.where(hit.front_face, 1.0 / ior, ior)
    unit_dir = vec.normalize(direction)
    cos_theta = vec.dot(-unit_dir, normal)
    sin_theta = vec.safe_sqrt(1.0 - cos_theta * cos_theta)
    cannot_refract = eta * sin_theta > 1.0
    coin = jax.random.uniform(k_coin, shape, dtype=dt)
    do_reflect = cannot_refract | (schlick_reflectance(cos_theta, eta) > coin)
    # NOTE: the reference reflects the NON-unit incoming dir
    # (material.zig:146 uses reflect(ray, hit) on ray.dir) but refracts the
    # unit dir — reproduced as-is.
    refl_d = vec.reflect(direction, normal)
    refr_d = vec.refract(unit_dir, normal, eta)
    dir_diel = jnp.where(do_reflect[..., None], refl_d, refr_d)

    # ---- Select by material kind (material.zig:167-176) ----
    is_metal = kind == MAT_METALLIC
    is_diel = kind == MAT_DIELECTRIC
    new_dir = jnp.where(
        is_diel[..., None],
        dir_diel,
        jnp.where(is_metal[..., None], dir_metal, dir_diffuse),
    )
    ones = jnp.ones((*shape, 3), dtype=dt)
    attenuation = jnp.where(is_diel[..., None], ones, albedo)
    # Degenerate scatter guard (same as the Pallas engines): a zero scatter
    # direction — e.g. a unit-ball radius draw of exactly 0 (probability
    # 2^-23 per draw under jax.random.uniform's fixed-point grid) whose
    # offset is then absorbed by f32 rounding of target = point + offset at
    # large |point| — would miss everything next bounce and send 0/0 through
    # sky_color. The reference's near-zero guard is on the target POINT
    # (material.zig:85-86) and never fires at large coordinates; treat the
    # degenerate direction as absorbed instead (black, measure-zero event).
    nd2 = vec.norm2(new_dir)
    scattered = jnp.where(is_metal, metal_ok, jnp.ones(shape, dtype=bool))
    # Threshold scales with dtype (ADVICE r2): 1e-20 matches the f32 Pallas
    # engines; f64 scenes with micro-scale geometry (|d|^2 ~ 1e-18 for 1e-9
    # features) get a far smaller cutoff so legitimate tiny directions are
    # never misclassified as degenerate.
    tiny = 1e-20 if nd2.dtype == jnp.float32 else 1e-300
    scattered = scattered & (nd2 > tiny)
    return new_dir, attenuation, scattered
