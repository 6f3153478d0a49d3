"""Batched ray-sphere intersection over a SoA sphere group.

Replicates the reference's half-b quadratic with (t1, t2) roots and the
t1-else-t2 in-range rule (src/hittable/geometry/sphere.rs:83-109), motion-blur
center offset (sphere.rs:50-52), and spherical uv (sphere.rs:64-71) — as a
dense (rays x spheres) test with a min-t argmin reduction, chunked over the
sphere axis so the pairwise intermediates stay bounded in memory.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raysnail_tpu.geometry import hit as hitlib
from raysnail_tpu.geometry.hit import BIG, Hit
from raysnail_tpu.prelude.sampling import PI
from raysnail_tpu.prelude.vec import Vec3


class SphereGroup(NamedTuple):
    center: Vec3        # (S,)
    radius: jax.Array   # (S,)
    speed: Vec3         # (S,) motion-blur velocity
    mat_id: jax.Array   # (S,) int32
    active: jax.Array   # (S,) bool — False for padding rows


def pair_t(group: SphereGroup, origin: Vec3, direction: Vec3, time, t_min, t_max,
           moving: bool):
    """Surface-hit t for every (ray, sphere) pair.

    origin/direction components are (N, 1); group components are (S,) treated
    as (1, S); result is (N, S). Directions must be unit (a == 1)."""
    cx, cy, cz = group.center.x, group.center.y, group.center.z
    if moving:
        cx = cx + group.speed.x * time
        cy = cy + group.speed.y * time
        cz = cz + group.speed.z * time
    lx = origin.x - cx
    ly = origin.y - cy
    lz = origin.z - cz
    half_b = direction.x * lx + direction.y * ly + direction.z * lz
    c = lx * lx + ly * ly + lz * lz - group.radius * group.radius
    delta = half_b * half_b - c
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    t1 = -half_b - sq
    t2 = -half_b + sq
    ok = (delta > 0.0) & group.active
    in1 = ok & (t_min < t1) & (t1 < t_max)
    in2 = ok & (t_min < t2) & (t2 < t_max)
    return jnp.where(in1, t1, jnp.where(in2, t2, BIG))


def intersect(group: SphereGroup, ray, t_min, t_max, *, moving: bool = False,
              chunk: int = 512, need_uv: bool = True) -> Hit:
    """Closest sphere hit per ray: a dense (rays x spheres) sweep, chunked
    over spheres when the group is larger than `chunk`. Group arrays must
    then be padded to a multiple of `chunk` (scene compile guarantees
    this)."""
    n = jnp.shape(ray.direction.x)[0]
    s = group.radius.shape[0]
    o = ray.origin.map(lambda a: a[:, None])
    d = ray.direction.map(lambda a: a[:, None])
    time = ray.time[:, None]

    if s <= chunk:
        t = pair_t(group, o, d, time, t_min, t_max, moving)
        idx = jnp.argmin(t, axis=1)
        t_best = jnp.min(t, axis=1)
    else:
        n_chunks = s // chunk
        chunked = jax.tree_util.tree_map(
            lambda a: a.reshape((n_chunks, chunk) + a.shape[1:]), group)

        def body(carry, g):
            t_best, idx_best, base = carry
            t = pair_t(g, o, d, time, t_min, t_max, moving)
            ti = jnp.min(t, axis=1)
            ii = jnp.argmin(t, axis=1) + base
            take = ti < t_best
            return (
                jnp.where(take, ti, t_best),
                jnp.where(take, ii, idx_best),
                base + chunk,
            ), None

        init = (jnp.full((n,), BIG, t_min.dtype if hasattr(t_min, "dtype") else jnp.float32),
                jnp.zeros((n,), jnp.int32), jnp.asarray(0, jnp.int32))
        (t_best, idx, _), _ = jax.lax.scan(body, init, chunked)

    valid = t_best < BIG
    onehot = hitlib.onehot_of(idx, group.radius.shape[0])
    center = hitlib.select_table_vec(onehot, group.center)
    if moving:
        speed = hitlib.select_table_vec(onehot, group.speed)
        center = center + speed * ray.time
    radius = hitlib.select_table(onehot, group.radius)
    mat_id = hitlib.select_table(onehot, group.mat_id)

    p = ray.origin + ray.direction * t_best
    geom_n = (p - center) * (1.0 / jnp.where(valid, radius, 1.0))
    if need_uv:  # atan2/asin are pricey; only image textures read sphere uv
        u, v = sphere_uv(p - center)
    else:
        u = jnp.zeros_like(t_best)
        v = u
    return hitlib.finalize(ray.direction, t_best, geom_n, u, v, mat_id, valid)


def sphere_uv(offset: Vec3):
    """Spherical uv of a point relative to the center (sphere.rs:64-71)."""
    p = offset.unit()
    phi = jnp.arctan2(-p.z, p.x)
    theta = jnp.arcsin(jnp.clip(p.y, -1.0, 1.0))
    return phi / (2.0 * PI) + 0.5, theta / PI + 0.5


def interval(center, radius, ray, t_min, t_max):
    """CSG support: (t1, t2, valid) interval of a single sphere per ray,
    following sphere.rs:83-109 (t1 in range -> (t1,t2); t2 in range ->
    (t2,t2); else miss). center is a Vec3 of scalars, radius a scalar."""
    l = ray.origin - center
    half_b = ray.direction.dot(l)
    c = l.length_squared() - radius * radius
    delta = half_b * half_b - c
    sq = jnp.sqrt(jnp.maximum(delta, 0.0))
    t1 = -half_b - sq
    t2 = -half_b + sq
    ok = delta > 0.0
    in1 = ok & (t_min < t1) & (t1 < t_max)
    in2 = ok & (t_min < t2) & (t2 < t_max)
    tt1 = jnp.where(in1, t1, t2)
    tt2 = t2
    valid = in1 | in2
    return tt1, tt2, valid


def contains(center, radius, p: Vec3):
    """sphere.rs:111-116."""
    return (center - p).length_squared() < radius * radius


def normal_at(center, radius, p: Vec3) -> Vec3:
    return (p - center) * (1.0 / radius)
