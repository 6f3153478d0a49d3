"""Batched hit records and combination.

The reference's HitRecord (src/hittable/hit.rs:11-52) carries point, normal
(flipped against the ray), material, entry/exit t1/t2, uv, and an `outside`
flag. Here a Hit is a batch of such records in SoA form; `t` is the surface
hit distance with misses encoded as BIG (static shapes — no Option<...>).
Exit distances (t2) are internal to the CSG/media modules and do not appear
in the global record.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raysnail_tpu.prelude.vec import Vec3

# Miss sentinel: large but finite so arithmetic never produces NaN.
BIG = 1e30


class Hit(NamedTuple):
    t: jax.Array        # distance along ray to surface hit; BIG if miss
    valid: jax.Array    # bool
    normal: Vec3        # unit geometric normal, flipped to face the ray
    u: jax.Array
    v: jax.Array
    mat_id: jax.Array   # int32 index into the material table; -1 = world default
    outside: jax.Array  # True if the geometric normal faced the ray (hit.rs:36-40)


def miss(shape, dtype=jnp.float32) -> Hit:
    return Hit(
        t=jnp.full(shape, BIG, dtype),
        valid=jnp.zeros(shape, bool),
        normal=Vec3.full((0.0, 0.0, 1.0), shape, dtype),
        u=jnp.zeros(shape, dtype),
        v=jnp.zeros(shape, dtype),
        mat_id=jnp.full(shape, -1, jnp.int32),
        outside=jnp.ones(shape, bool),
    )


def finalize(ray_dir: Vec3, t, geom_normal: Vec3, u, v, mat_id, valid) -> Hit:
    """Build a Hit from a raw intersection: flip the geometric normal against
    the ray and set the outside flag (hit.rs:32-52)."""
    outside = ray_dir.dot(geom_normal) < 0.0
    normal = Vec3.where(outside, geom_normal, -geom_normal)
    t = jnp.where(valid, t, BIG)
    return Hit(
        t=t,
        valid=valid,
        normal=normal,
        u=u,
        v=v,
        mat_id=jnp.asarray(mat_id, jnp.int32),
        outside=outside,
    )


def combine_hits(a: Hit, b: Hit) -> Hit:
    """Keep the nearer of two candidate hits (misses have t=BIG)."""
    take_b = b.t < a.t
    return Hit(
        t=jnp.where(take_b, b.t, a.t),
        valid=jnp.where(take_b, b.valid, a.valid),
        normal=Vec3.where(take_b, b.normal, a.normal),
        u=jnp.where(take_b, b.u, a.u),
        v=jnp.where(take_b, b.v, a.v),
        mat_id=jnp.where(take_b, b.mat_id, a.mat_id),
        outside=jnp.where(take_b, b.outside, a.outside),
    )


def gather(hit_or_vec, idx):
    """Index every leaf of a Hit/Vec3/array pytree along axis 0."""
    return jax.tree_util.tree_map(lambda leaf: leaf[idx], hit_or_vec)


def take_table(table, idx):
    """Per-ray fetch from a small per-row table (materials, textures):
    (n,) table, (N,) indices -> (N,). A plain gather forward; the gradient
    of a float table is a one-hot reduction over rays, not the gather's
    scatter-add, whose f32 accumulation order on a GPU is not fixed (two
    runs of a train step differed by 1e-6, and its sum strayed ~1e-4 from
    the one-hot reduction's, measured at 800x500@64spp)."""
    if jnp.issubdtype(table.dtype, jnp.floating):
        return _take_float(table, idx)
    return table[idx]


@jax.custom_vjp
def _take_float(table, idx):
    return table[idx]


def _take_float_fwd(table, idx):
    return table[idx], (table, idx)


def _take_float_bwd(res, ct):
    table, idx = res
    onehot = onehot_of(idx.reshape(-1), table.shape[0])
    d_table = jnp.sum(jnp.where(onehot, ct.reshape(-1, 1), 0.0), axis=0)
    return d_table.astype(table.dtype), None


_take_float.defvjp(_take_float_fwd, _take_float_bwd)


# -- one-hot winner selection ----------------------------------------------
# The post-argmin attribute fetch over a small primitive axis as a one-hot
# select: a masked sum fused into the argmin pass instead of a dynamic
# gather. Whether it beats a plain gather on the GPU is not measured yet.

def onehot_of(idx, n: int):
    """(N,) winner indices -> (N, n) boolean one-hot."""
    return jnp.arange(n, dtype=jnp.int32)[None, :] == idx[:, None].astype(jnp.int32)


def select_row(onehot, a2d):
    """Winner's value from per-(ray, prim) data (N, n)."""
    return jnp.sum(jnp.where(onehot, a2d, jnp.zeros((), a2d.dtype)), axis=1)


def select_row_bool(onehot, a2d):
    return jnp.any(onehot & a2d, axis=1)


def select_table(onehot, table):
    """Winner's value from a per-prim table (n,) -> (N,)."""
    return select_row(onehot, jnp.broadcast_to(table[None, :], onehot.shape))


def select_table_vec(onehot, v: Vec3) -> Vec3:
    return Vec3(select_table(onehot, v.x), select_table(onehot, v.y),
                select_table(onehot, v.z))
