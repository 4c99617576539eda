"""Fused path-trace kernel for the GPU (Pallas, Triton route).

The whole path trace (camera sample, nearest hit, scatter, accumulate) runs
in one kernel, in place of the reference's row/col/sample loop and recursive
``bounceRay`` (/root/reference/src/renderer.zig:72-126). The XLA integrator
(:mod:`rayz_tpu.ops.integrator`) runs every bounce for every ray and writes
per-bounce ray state to device memory; this kernel keeps ray state in
registers and reads the scene tables through L1/L2.

Design
------
* **Grid**: one program per block of ``block`` pixel slots (a power of two,
  one slot per thread, one warp by default); each program runs all ``spp``
  samples of its pixels.
* **Persistent respawn**: when a slot's path ends (miss, absorbed, or out of
  depth) it adds its radiance and starts its next camera sample at once; the
  block's ``while_loop`` ends when every slot has spent its samples. Most
  paths end after 2-3 bounces while ``max_depth`` is 32-50, so a slot does not
  idle on a finished path while it still has samples to trace.
* **Intersection**: a ``fori_loop`` over the primitives of an SoA table in
  global memory. Each step loads one primitive's scalars, tests every ray of
  the block and carries only the running best ``(q, index)``. After the loop
  one gathered load per attribute fetches the winner's geometry, material and
  texture.
* **PRNG**: a counter-based hash of (seed, pixel, sample, bounce, draw)
  computed in the kernel (:func:`hash_uniform`). Its stream differs from
  ``jax.random``, so parity with the XLA oracle is exact (up to float order)
  on deterministic scenes and statistical otherwise. The counter holds the
  global pixel index, so a sharded render equals the one-device render.

Scope: spheres and/or triangles with solid or one-level checker textures
(every scene the reference can express, plus triangles). Nested checkers are
rejected (:func:`supports_scene`); the XLA integrator renders them. The kernel
is forward only: gradients run through the XLA integrator.
"""

from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt
from jax.sharding import PartitionSpec as P

from ..models.camera import Camera
from ..models.scene import MAT_DIELECTRIC, MAT_METALLIC, TEX_SOLID, Scene
from .intersect import _triangle_frame

__all__ = ["render_pallas", "render_pallas_sharded", "supports_scene",
           "scene_tables", "tri_tables", "is_prng_key", "pixel_stream",
           "hash_uniform", "BLOCK"]

# Sphere table rows (columns = spheres): center at t=0, radius^2 (-BIG on
# padding columns, so they never hit), velocity, then the material rows.
_CX, _CY, _CZ, _R2, _VX, _VY, _VZ = range(7)
_SM = 7
# Triangle table rows (columns = triangles): plane normal n = e1 x e2, v0
# (NaN on padding columns), the dual basis g1/g2 of the edge frame (the
# barycentrics are u = g1.(p - v0), v = g2.(p - v0)), then the material rows.
_NX, _NY, _NZ, _V0X, _V0Y, _V0Z = range(6)
_G1X, _G1Y, _G1Z, _G2X, _G2Y, _G2Z = range(6, 12)
_TM = 12
# The _NMAT material rows that follow _SM / _TM, in order: kind, diffuse
# method, clamped fuzz, IOR for dielectrics or checker scale otherwise (a
# dielectric has no texture, material.zig:155), the checker's even rgb and
# odd rgb (both the solid color for solid textures).
_NMAT = 10

_BIG = 3.0e38  # +inf stand-in for the running best q
_TWO_PI = 2.0 * math.pi
_GOLDEN = 0x9E3779B9
_NDRAW = 5  # uniform draws per (sample, bounce): spawn uses 5, scatter 4

#: Pixel slots per program, one per thread (so ``block // 32`` warps). A
#: program's loop runs until its slowest slot has spent its samples, so the
#: fewer slots share a program, the shorter that tail; on an H100 32-slot
#: programs were the fastest of 32..256 on the flagship and within 5% of the
#: fastest on the Cornell box (PERF.md).
BLOCK = 32


def is_prng_key(key) -> bool:
    """True for new-style typed keys AND legacy uint32[..., 2] raw keys."""
    if not hasattr(key, "dtype"):
        return False
    if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        return True
    return (jnp.issubdtype(key.dtype, jnp.unsignedinteger)
            and getattr(key, "ndim", 0) >= 1 and key.shape[-1] == 2)


def _seed(key) -> jnp.ndarray:
    if is_prng_key(key):
        return jax.random.randint(key, (), 0, jnp.iinfo(jnp.int32).max)
    return jnp.asarray(key, jnp.int32)


def supports_scene(scene: Scene) -> bool:
    """Any non-empty sphere/triangle scene WITHOUT nested checker textures.
    The kernel resolves one level of checker (:func:`_material_rows`) while
    the reference recurses through the texture pool (material.zig:37-38), so
    a deeper nest would render differently here; such scenes go to the XLA
    engine instead (Scene.deep_checker, set by SceneBuilder)."""
    return ((scene.n_spheres > 0 or scene.n_triangles > 0)
            and not scene.deep_checker)


def _material_rows(scene: Scene, mat: jnp.ndarray):
    """The _NMAT material rows for primitives with material indices ``mat``;
    checker children are resolved one level through the texture pool
    (material.zig:41-51). Fuzz is clamped to 1 as in material.zig:111."""
    f32 = jnp.float32
    kind = scene.mat_kind[mat].astype(f32)
    tex = scene.mat_texture[mat]
    solid = scene.tex_kind[tex] == TEX_SOLID
    base = scene.tex_color[tex].astype(f32)
    ev = jnp.where(solid[:, None], base,
                   scene.tex_color[scene.tex_even[tex]].astype(f32))
    od = jnp.where(solid[:, None], base,
                   scene.tex_color[scene.tex_odd[tex]].astype(f32))
    scale = jnp.where(solid, 1.0, scene.tex_scale[tex].astype(f32))
    ios = jnp.where(kind == float(MAT_DIELECTRIC),
                    scene.mat_ior[mat].astype(f32), scale)
    return [kind, scene.mat_method[mat].astype(f32),
            jnp.minimum(scene.mat_fuzz[mat].astype(f32), 1.0), ios,
            ev[:, 0], ev[:, 1], ev[:, 2], od[:, 0], od[:, 1], od[:, 2]]


def scene_tables(scene: Scene) -> jnp.ndarray:
    """The [_SM + _NMAT, N] f32 sphere table the kernel reads."""
    f32 = jnp.float32
    c = scene.sphere_center.astype(f32)
    v = scene.sphere_velocity.astype(f32)
    r = scene.sphere_radius.astype(f32)
    r2 = jnp.where(scene.sphere_valid, r * r, -_BIG)
    return jnp.stack([c[:, 0], c[:, 1], c[:, 2], r2,
                      v[:, 0], v[:, 1], v[:, 2],
                      *_material_rows(scene, scene.sphere_material)])


def tri_tables(scene: Scene) -> jnp.ndarray:
    """The [_TM + _NMAT, M] f32 triangle table the kernel reads."""
    f32 = jnp.float32
    n, g1, g2 = (x.astype(f32) for x in _triangle_frame(scene))
    v0 = jnp.where(scene.tri_valid[:, None], scene.tri_v0.astype(f32),
                   jnp.nan)
    return jnp.stack([n[:, 0], n[:, 1], n[:, 2],
                      v0[:, 0], v0[:, 1], v0[:, 2],
                      g1[:, 0], g1[:, 1], g1[:, 2],
                      g2[:, 0], g2[:, 1], g2[:, 2],
                      *_material_rows(scene, scene.tri_material)])


def _camera_vector(camera: Camera) -> jnp.ndarray:
    """[18] f32: look_from, px_du, px_dv, px_origin, defocus_u, defocus_v."""
    f32 = jnp.float32
    return jnp.concatenate([
        camera.look_from.astype(f32), camera.px_du.astype(f32),
        camera.px_dv.astype(f32), camera.px_origin.astype(f32),
        camera.defocus_u.astype(f32), camera.defocus_v.astype(f32),
    ])


def _mix32(x):
    """lowbias32 finaliser: a bijection on uint32 in which every input bit
    flips each output bit with probability close to 1/2."""
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x7FEB352D)
    x = x ^ (x >> 15)
    x = x * jnp.uint32(0x846CA68B)
    return x ^ (x >> 16)


def pixel_stream(seed, pix):
    """uint32 key of pixel ``pix``'s random stream under ``seed``."""
    s = _mix32(jnp.asarray(seed).astype(jnp.uint32))
    return _mix32((pix.astype(jnp.uint32) * jnp.uint32(_GOLDEN)) ^ s)


def hash_uniform(stream, ctr):
    """Draw number ``ctr`` of ``stream`` as a float32 in [0, 1), 24 bits."""
    h = _mix32(_mix32(stream ^ (ctr.astype(jnp.uint32) * jnp.uint32(_GOLDEN))))
    return (h >> 8).astype(jnp.int32).astype(jnp.float32) * (1.0 / 16777216.0)


def _div(x, y):
    """x / y to within an ulp in the compiled kernel too: Triton lowers
    ``/`` to the approximate ``div.full.f32`` (2 ulp). One correction step
    with the residual restores the rounding the XLA oracle gets; a hit point
    a few ulp off its surface changes how often the next ray re-hits it."""
    q = x / y
    return q + (x - q * y) / y


def _sqrt(x):
    """sqrt(x) refined by one Newton step, for the same reason as _div
    (sqrt(0) = 0 is kept: a tangent hit must not turn into 0/0)."""
    y = jnp.sqrt(x)
    return jnp.where(y > 0.0, y + _div(x - y * y, 2.0 * y), y)


def _sphere_q(ocx, ocy, ocz, r2, dx, dy, dz, a, tmin_a, sqrt=jnp.sqrt):
    """q = t*|d|^2 of the nearest root at or beyond t_min (Sphere.hitInner,
    geom.zig:38-66) from the offset oc = c - o; NaN on a miss (disc < 0),
    so every compare with it is false."""
    hb = dx * ocx + dy * ocy + dz * ocz
    rt = sqrt(hb * hb - a * (ocx * ocx + ocy * ocy + ocz * ocz - r2))
    q1 = hb - rt
    return jnp.where(q1 >= tmin_a, q1, hb + rt)


def _kernel(cam_ref, meta_ref, *refs, block: int, width: int, n_px: int,
            n_sph: int, n_tri: int, spp: int, max_depth: int, t_min: float,
            jitter: bool, has_motion: bool):
    """One program: ``block`` persistent pixel slots, all their samples."""
    refs = list(refs)
    sph = refs.pop(0) if n_sph else None
    tri = refs.pop(0) if n_tri else None
    r_out, g_out, b_out = refs
    f32, i32 = jnp.float32, jnp.int32

    pix = (meta_ref[1] + pl.program_id(0) * block
           + jax.lax.broadcasted_iota(i32, (block,), 0))
    stream = pixel_stream(meta_ref[0], pix)
    pxf = (pix % width).astype(f32)
    pyf = (pix // width).astype(f32)
    (lfx, lfy, lfz, dux, duy, duz, dvx, dvy, dvz,
     pox, poy, poz, deux, deuy, deuz, devx, devy, devz) = [
        cam_ref[i] for i in range(18)]
    zf = jnp.zeros((block,), f32)
    zi = jnp.zeros((block,), i32)

    def draw(sample, bounce, k):
        return hash_uniform(stream,
                            (sample * (max_depth + 1) + bounce) * _NDRAW + k)

    def alive(st):
        return jnp.max(jnp.maximum(st[14], st[15])) > 0

    def body(st):
        (ox, oy, oz, dx, dy, dz, tau, thx, thy, thz,
         ar, ag, ab, depth, samples, active) = st

        # ---- respawn finished slots with their next camera sample ----
        # (Camera.getRay, camera.zig:59-77: +-0.5 pixel jitter, defocus-disk
        # origin, time in [0,1); bounce slot max_depth is the spawn's.)
        spawn = (active == 0) & (samples > 0)
        if jitter:
            sample = spp - samples
            x = pxf + draw(sample, max_depth, 0) - 0.5
            y = pyf + draw(sample, max_depth, 1) - 0.5
            rr = jnp.sqrt(draw(sample, max_depth, 2))
            th = _TWO_PI * draw(sample, max_depth, 3)
            ca, sa = rr * jnp.cos(th), rr * jnp.sin(th)
            nox = lfx + ca * deux + sa * devx
            noy = lfy + ca * deuy + sa * devy
            noz = lfz + ca * deuz + sa * devz
            ntau = draw(sample, max_depth, 4)
        else:
            x, y = pxf, pyf
            nox, noy, noz = zf + lfx, zf + lfy, zf + lfz
            ntau = zf
        ox = jnp.where(spawn, nox, ox)
        oy = jnp.where(spawn, noy, oy)
        oz = jnp.where(spawn, noz, oz)
        dx = jnp.where(spawn, x * dux + y * dvx + pox - nox, dx)
        dy = jnp.where(spawn, x * duy + y * dvy + poy - noy, dy)
        dz = jnp.where(spawn, x * duz + y * dvz + poz - noz, dz)
        tau = jnp.where(spawn, ntau, tau)
        thx = jnp.where(spawn, 1.0, thx)
        thy = jnp.where(spawn, 1.0, thy)
        thz = jnp.where(spawn, 1.0, thz)
        depth = jnp.where(spawn, max_depth, depth)
        samples = samples - spawn.astype(i32)
        live = (active > 0) | spawn

        # ---- nearest hit: roots compared in q = t*|d|^2 space ----
        a = dx * dx + dy * dy + dz * dz
        tmin_a = t_min * a
        qb = zf + _BIG
        if n_sph:
            def sphere_step(j, carry):
                # Sphere.hitInner (geom.zig:38-66) with the BVH's shrinking
                # t_max (hit.zig:197-214). disc < 0 gives NaN roots, and every
                # compare with NaN is false, so misses reject themselves.
                qb, bi = carry
                cx, cy, cz = sph[_CX, j], sph[_CY, j], sph[_CZ, j]
                if has_motion:
                    cx = cx + tau * sph[_VX, j]
                    cy = cy + tau * sph[_VY, j]
                    cz = cz + tau * sph[_VZ, j]
                qv = _sphere_q(cx - ox, cy - oy, cz - oz, sph[_R2, j],
                               dx, dy, dz, a, tmin_a)
                better = (qv >= tmin_a) & (qv < qb)
                return jnp.where(better, qv, qb), jnp.where(better, j, bi)

            qb, bi = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_sph),
                                       sphere_step, (qb, zi))
        if n_tri:
            def tri_step(j, carry):
                # Plane, then barycentrics of the hit point; double-sided.
                # Parallel rays (n.d == 0) and padding (v0 = NaN) give NaN
                # or inf and fail the compares.
                qb, ti, wt = carry
                nx, ny, nz = tri[_NX, j], tri[_NY, j], tri[_NZ, j]
                wx, wy, wz = tri[_V0X, j] - ox, tri[_V0Y, j] - oy, \
                    tri[_V0Z, j] - oz
                tt = (nx * wx + ny * wy + nz * wz) / (dx * nx + dy * ny
                                                      + dz * nz)
                hx, hy, hz = tt * dx - wx, tt * dy - wy, tt * dz - wz
                u = tri[_G1X, j] * hx + tri[_G1Y, j] * hy + tri[_G1Z, j] * hz
                v = tri[_G2X, j] * hx + tri[_G2Y, j] * hy + tri[_G2Z, j] * hz
                qv = tt * a
                better = ((qv >= tmin_a) & (qv < qb) & (u >= 0.0)
                          & (v >= 0.0) & (u + v <= 1.0))
                return (jnp.where(better, qv, qb), jnp.where(better, j, ti),
                        jnp.where(better, 1, wt))

            qb, ti, wt = jax.lax.fori_loop(jnp.int32(0), jnp.int32(n_tri),
                                           tri_step, (qb, zi, zi))

        # ---- gather the winner (Hit.init, hit.zig:16-42); its distance is
        # recomputed with the XLA oracle's formula and rounding ----
        hit = qb < _BIG
        if n_sph:
            cx, cy, cz = sph[_CX, bi], sph[_CY, bi], sph[_CZ, bi]
            if has_motion:
                cx = cx + tau * sph[_VX, bi]
                cy = cy + tau * sph[_VY, bi]
                cz = cz + tau * sph[_VZ, bi]
            s_t = _sphere_q(cx - ox, cy - oy, cz - oz, sph[_R2, bi], dx, dy,
                            dz, a, tmin_a, sqrt=_sqrt) * _div(1.0, a)
            s_m = [sph[_SM + k, bi] for k in range(_NMAT)]
        if n_tri:
            t_n = (tri[_NX, ti], tri[_NY, ti], tri[_NZ, ti])
            t_t = _div(t_n[0] * (tri[_V0X, ti] - ox)
                       + t_n[1] * (tri[_V0Y, ti] - oy)
                       + t_n[2] * (tri[_V0Z, ti] - oz),
                       dx * t_n[0] + dy * t_n[1] + dz * t_n[2])
            t_m = [tri[_TM + k, ti] for k in range(_NMAT)]
        if n_sph and n_tri:
            is_tri = wt > 0
            t = jnp.where(is_tri, t_t, s_t)
            mat = [jnp.where(is_tri, tv, sv) for tv, sv in zip(t_m, s_m)]
        elif n_sph:
            t, mat = s_t, s_m
        else:
            t, mat = t_t, t_m
        t = jnp.where(hit, t, 0.0)
        hx, hy, hz = ox + t * dx, oy + t * dy, oz + t * dz
        if n_sph:
            # outward normal: unit(p - c) (geom.zig:64)
            s_n = (hx - cx, hy - cy, hz - cz)
        if n_sph and n_tri:
            nx, ny, nz = (jnp.where(is_tri, tv, sv) for tv, sv in zip(t_n, s_n))
        elif n_sph:
            nx, ny, nz = s_n
        else:
            nx, ny, nz = t_n
        kind, method, fuzz, ios, evr, evg, evb, odr, odg, odb = mat
        ninv = jax.lax.rsqrt(jnp.maximum(nx * nx + ny * ny + nz * nz, 1e-30))
        nx, ny, nz = nx * ninv, ny * ninv, nz * ninv
        front = nx * dx + ny * dy + nz * dz < 0.0
        sgn = jnp.where(front, 1.0, -1.0)
        nx, ny, nz = nx * sgn, ny * sgn, nz * sgn

        # ---- texture (CheckerTexture, material.zig:27-39) ----
        is_d = kind == float(MAT_DIELECTRIC)
        is_m = kind == float(MAT_METALLIC)
        scale = jnp.where(is_d, 1.0, ios)
        par = (jnp.floor(hx / scale) + jnp.floor(hy / scale)
               + jnp.floor(hz / scale))
        even = par - 2.0 * jnp.floor(par * 0.5) < 0.5
        alr = jnp.where(even, evr, odr)
        alg = jnp.where(even, evg, odg)
        alb = jnp.where(even, evb, odb)

        # ---- diffuse (material.zig:75-101) ----
        sample = spp - 1 - samples
        bounce = max_depth - depth
        uz = 2.0 * draw(sample, bounce, 0) - 1.0
        phi = _TWO_PI * draw(sample, bounce, 1)
        ur = jnp.sqrt(jnp.maximum(1.0 - uz * uz, 0.0))
        ux, uy = ur * jnp.cos(phi), ur * jnp.sin(phi)
        cb = jnp.cbrt(draw(sample, bounce, 2))
        sx, sy, sz = ux * cb, uy * cb, uz * cb  # uniform in the unit ball
        flip = jnp.where(sx * nx + sy * ny + sz * nz > 0.0, 1.0, -1.0)
        m0 = method == 0.0  # DIFFUSE_UNIT_SPHERE
        m1 = method == 1.0  # DIFFUSE_UNIT_SPHERE_SURFACE
        offx = jnp.where(m0, nx + sx, jnp.where(m1, nx + ux, sx * flip))
        offy = jnp.where(m0, ny + sy, jnp.where(m1, ny + uy, sy * flip))
        offz = jnp.where(m0, nz + sz, jnp.where(m1, nz + uz, sz * flip))
        # reference quirk (material.zig:85-86): the near-zero check is on the
        # target POINT; a near-origin target snaps to the bare normal.
        tgx, tgy, tgz = hx + offx, hy + offy, hz + offz
        snap = ((jnp.abs(tgx) <= 1e-8) & (jnp.abs(tgy) <= 1e-8)
                & (jnp.abs(tgz) <= 1e-8))
        difx = jnp.where(snap, nx, tgx) - hx
        dify = jnp.where(snap, ny, tgy) - hy
        difz = jnp.where(snap, nz, tgz) - hz

        # ---- metallic (material.zig:107-131); the fuzz sample is the
        # diffuse unit vector: a hit evaluates one material only ----
        two_ndd = 2.0 * (dx * nx + dy * ny + dz * nz)
        rfx, rfy, rfz = dx - two_ndd * nx, dy - two_ndd * ny, dz - two_ndd * nz
        rinv = jax.lax.rsqrt(jnp.maximum(rfx * rfx + rfy * rfy + rfz * rfz,
                                         1e-30))
        mex = rfx * rinv + fuzz * ux
        mey = rfy * rinv + fuzz * uy
        mez = rfz * rinv + fuzz * uz
        metal_ok = mex * nx + mey * ny + mez * nz > 0.0

        # ---- dielectric (material.zig:136-159) ----
        eta = jnp.where(front, 1.0 / ios, ios)
        dinv = jax.lax.rsqrt(a)
        udx, udy, udz = dx * dinv, dy * dinv, dz * dinv
        cos_t = -(udx * nx + udy * ny + udz * nz)
        sin_t = jnp.sqrt(jnp.maximum(1.0 - cos_t * cos_t, 0.0))
        r0 = (1.0 - eta) / (1.0 + eta)
        r0 = r0 * r0
        om = 1.0 - cos_t
        om2 = om * om
        refl_p = r0 + (1.0 - r0) * om2 * om2 * om
        do_refl = (eta * sin_t > 1.0) | (refl_p > draw(sample, bounce, 3))
        ppx = (udx + cos_t * nx) * eta
        ppy = (udy + cos_t * ny) * eta
        ppz = (udz + cos_t * nz) * eta
        parm = -jnp.sqrt(jnp.maximum(
            1.0 - (ppx * ppx + ppy * ppy + ppz * ppz), 0.0))
        # reflect uses the NON-unit incoming dir, refract the unit dir
        # (material.zig:146,152) -- reproduced as-is.
        dlx = jnp.where(do_refl, rfx, ppx + parm * nx)
        dly = jnp.where(do_refl, rfy, ppy + parm * ny)
        dlz = jnp.where(do_refl, rfz, ppz + parm * nz)

        # ---- select by material kind (material.zig:167-176) ----
        ndx = jnp.where(is_d, dlx, jnp.where(is_m, mex, difx))
        ndy = jnp.where(is_d, dly, jnp.where(is_m, mey, dify))
        ndz = jnp.where(is_d, dlz, jnp.where(is_m, mez, difz))
        # a degenerate (zero) scatter direction is absorbed, as in shade.py
        nd2 = ndx * ndx + ndy * ndy + ndz * ndz
        scattered = ((~is_m) | metal_ok) & (nd2 > 1e-20)

        # ---- miss -> sky weighted by throughput (renderer.zig:124-125):
        # the reference's (white*(1-t) + blue) * t ----
        sky_t = 0.5 * (dy * dinv + 1.0)
        miss = live & ~hit
        ar = ar + jnp.where(miss, thx * (1.5 - sky_t) * sky_t, 0.0)
        ag = ag + jnp.where(miss, thy * (1.7 - sky_t) * sky_t, 0.0)
        ab = ab + jnp.where(miss, thz * (2.0 - sky_t) * sky_t, 0.0)

        # ---- continue or die (bounceRay, renderer.zig:103-126) ----
        cont = live & hit & scattered
        thx = jnp.where(cont & ~is_d, thx * alr, thx)
        thy = jnp.where(cont & ~is_d, thy * alg, thy)
        thz = jnp.where(cont & ~is_d, thz * alb, thz)
        ox = jnp.where(cont, hx, ox)
        oy = jnp.where(cont, hy, oy)
        oz = jnp.where(cont, hz, oz)
        dx = jnp.where(cont, ndx, dx)
        dy = jnp.where(cont, ndy, dy)
        dz = jnp.where(cont, ndz, dz)
        depth = depth - cont.astype(i32)
        # depth exhausted -> black (renderer.zig:104-105)
        active = (cont & (depth > 0)).astype(i32)
        return (ox, oy, oz, dx, dy, dz, tau, thx, thy, thz,
                ar, ag, ab, depth, samples, active)

    state = (zf, zf, zf, zf, zf, zf + 1.0, zf, zf, zf, zf, zf, zf, zf,
             zi, jnp.where(pix < n_px, spp, 0).astype(i32), zi)
    final = jax.lax.while_loop(alive, body, state)
    r_out[...] = final[10]
    g_out[...] = final[11]
    b_out[...] = final[12]


def _trace_pixels(scene: Scene, camera: Camera, seed, pix_offset,
                  n_local: int, *, spp: int, max_depth: int, t_min: float,
                  jitter: bool, block: int, interpret: bool):
    """Radiance sums [n_local, 3] over ``spp`` samples of the ``n_local``
    consecutive pixels from global index ``pix_offset`` (one device's
    share under shard_map)."""
    n_blocks = -(-n_local // block)
    n_sph = int(scene.sphere_radius.shape[0]) if scene.n_spheres > 0 else 0
    n_tri = int(scene.tri_material.shape[0]) if scene.n_triangles > 0 else 0
    meta = jnp.stack([jnp.asarray(seed, jnp.int32).reshape(()),
                      jnp.asarray(pix_offset, jnp.int32).reshape(())])
    inputs = [_camera_vector(camera), meta]
    if n_sph:
        inputs.append(scene_tables(scene))
    if n_tri:
        inputs.append(tri_tables(scene))
    kern = functools.partial(
        _kernel, block=block, width=camera.width,
        n_px=camera.width * camera.height, n_sph=n_sph, n_tri=n_tri,
        spp=spp, max_depth=max_depth, t_min=t_min, jitter=jitter,
        has_motion=scene.has_motion)
    out = jax.ShapeDtypeStruct((n_blocks * block,), jnp.float32)
    spec = pl.BlockSpec((block,), lambda i: (i,))
    r, g, b = pl.pallas_call(
        kern,
        out_shape=(out, out, out),
        grid=(n_blocks,),
        in_specs=[pl.no_block_spec] * len(inputs),
        out_specs=(spec, spec, spec),
        backend="triton",
        compiler_params=plt.CompilerParams(num_warps=max(1, block // 32),
                                           num_stages=1),
        interpret=interpret,
        name="rayz_pathtrace",
    )(*inputs)
    return jnp.stack([r, g, b], axis=-1)[:n_local]


_STATIC = ("spp", "max_depth", "t_min", "jitter", "block", "interpret")


@functools.partial(jax.jit, static_argnames=_STATIC)
def _render_impl(scene, camera, seed, *, spp, max_depth, t_min, jitter,
                 block, interpret):
    h, w = camera.height, camera.width
    flat = _trace_pixels(scene, camera, seed, 0, h * w, spp=spp,
                         max_depth=max_depth, t_min=t_min, jitter=jitter,
                         block=block, interpret=interpret)
    return (flat.reshape(h, w, 3) / float(spp)).astype(camera.dtype)


def _check_args(scene: Scene, block: int, interpret: bool) -> None:
    if not supports_scene(scene):
        if scene.deep_checker:
            raise ValueError(
                "the path-trace kernel resolves only ONE level of checker "
                "nesting; this scene nests checkers inside checkers: render "
                "it with engine='xla' (rayz_tpu.render)")
        raise ValueError("the path-trace kernel needs a non-empty scene "
                         "(spheres and/or triangles)")
    if block < 1 or block & (block - 1):
        raise ValueError(f"block must be a power of two, got {block}")
    if not interpret and jax.default_backend() != "gpu":
        raise RuntimeError(
            "the path-trace kernel is compiled for the GPU, and the default "
            f"backend is {jax.default_backend()!r}; pass interpret=True to "
            "run it in the Pallas interpreter, or use engine='xla'")


def render_pallas(scene: Scene, camera: Camera, key, config, *,
                  block: int = BLOCK, interpret: bool = False) -> jnp.ndarray:
    """Render through the fused kernel; drop-in for
    :func:`rayz_tpu.ops.integrator.render` on supported scenes.

    ``key`` may be a PRNG key (folded to a seed) or an integer seed. The
    kernel runs compiled on the GPU; ``interpret=True`` runs it in the
    Pallas interpreter (tests on the CPU), and there is no other fallback.
    """
    _check_args(scene, block, interpret)
    return _render_impl(scene, camera, _seed(key), spp=config.spp,
                        max_depth=config.max_depth, t_min=config.t_min,
                        jitter=config.jitter, block=block,
                        interpret=interpret)


@functools.partial(jax.jit, static_argnames=_STATIC + ("mesh",))
def _render_sharded_impl(scene, camera, seed, *, mesh, spp, max_depth, t_min,
                         jitter, block, interpret):
    axis = mesh.axis_names[0]
    h, w = camera.height, camera.width
    n_px = h * w
    shard_px = -(-n_px // mesh.size)

    def body(scene, camera, seed):
        return _trace_pixels(
            scene, camera, seed, jax.lax.axis_index(axis) * shard_px,
            shard_px, spp=spp, max_depth=max_depth, t_min=t_min,
            jitter=jitter, block=block, interpret=interpret)

    # check_vma=False: pallas_call outputs carry no varying-manual-axes
    # type, and the body has no collectives to check.
    flat = jax.shard_map(body, mesh=mesh, in_specs=(P(), P(), P()),
                         out_specs=P(axis), check_vma=False)(
        scene, camera, seed)
    return (flat[:n_px].reshape(h, w, 3) / float(spp)).astype(camera.dtype)


def render_pallas_sharded(scene: Scene, camera: Camera, key, config, mesh, *,
                          block: int = BLOCK,
                          interpret: bool = False) -> jnp.ndarray:
    """Kernel render with pixels split over a 1-D device mesh.

    Each device traces a contiguous run of the flat pixel array with its own
    kernel launch; the image is assembled by XLA's sharded output layout, so
    the forward render has no collectives. The PRNG counter holds the global
    pixel index, so the result equals :func:`render_pallas` on one device.
    """
    _check_args(scene, block, interpret)
    return _render_sharded_impl(
        scene, camera, _seed(key), mesh=mesh, spp=config.spp,
        max_depth=config.max_depth, t_min=config.t_min, jitter=config.jitter,
        block=block, interpret=interpret)
