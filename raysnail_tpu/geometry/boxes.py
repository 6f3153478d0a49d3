"""Axis-aligned and oriented box intersection (slab tests).

The reference builds a Box from 6 AARects and collects face hits
(src/hittable/geometry/box.rs:48-149). Here it is the
branch-free slab test, which yields the same (t_near, t_far) interval, face
normal and uv in O(1) without a face list. Oriented boxes (SDL `rotate` on a
box) carry a per-box world->object affine; the slab test runs in object space
where the box is axis-aligned (replaces transform/tf_facade.rs — with correct
inverse-transpose normals, unlike the reference's untransformed-normal quirk
at tf_facade.rs:49-53).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raysnail_tpu.geometry import hit as hitlib
from raysnail_tpu.geometry.hit import BIG, Hit
from raysnail_tpu.prelude.vec import Vec3


class BoxGroup(NamedTuple):
    p_min: Vec3         # (B,)
    p_max: Vec3         # (B,)
    mat_id: jax.Array   # (B,) int32
    active: jax.Array   # (B,) bool
    # Optional orientation (None => all axis-aligned). inv_* rows map world ->
    # object: p_obj = inv_rot @ p + inv_off;  nrm_* rows = (inv_rot)^T maps
    # object normals -> world.
    inv_rows: tuple | None = None  # (row0: Vec3, row1: Vec3, row2: Vec3) each (B,)
    inv_off: Vec3 | None = None    # (B,)


def _apply_rows(rows, off, v: Vec3, translate: bool) -> Vec3:
    r0, r1, r2 = rows
    out = Vec3(r0.dot(v), r1.dot(v), r2.dot(v))
    if translate:
        out = out + off
    return out


def _apply_rows_t(rows, v: Vec3) -> Vec3:
    """Multiply by the transpose of the 3x3 given as rows (normal transform)."""
    r0, r1, r2 = rows
    return Vec3(
        r0.x * v.x + r1.x * v.y + r2.x * v.z,
        r0.y * v.x + r1.y * v.y + r2.y * v.z,
        r0.z * v.x + r1.z * v.y + r2.z * v.z,
    )


def slab(p_min: Vec3, p_max: Vec3, o: Vec3, d: Vec3):
    """Slab test -> (t_near, t_far, axis_near, axis_far). Axes identify the
    face (0=x,1=y,2=z) attaining the near/far bound."""
    inv = d.map(lambda c: 1.0 / jnp.where(jnp.abs(c) < 1e-12, jnp.where(c < 0, -1e-12, 1e-12), c))
    ta = (p_min - o) * inv
    tb = (p_max - o) * inv
    lo = Vec3(jnp.minimum(ta.x, tb.x), jnp.minimum(ta.y, tb.y), jnp.minimum(ta.z, tb.z))
    hi = Vec3(jnp.maximum(ta.x, tb.x), jnp.maximum(ta.y, tb.y), jnp.maximum(ta.z, tb.z))
    t_near = lo.max_component()
    t_far = hi.min_component()
    axis_near = jnp.where(lo.x >= lo.y, jnp.where(lo.x >= lo.z, 0, 2), jnp.where(lo.y >= lo.z, 1, 2))
    axis_far = jnp.where(hi.x <= hi.y, jnp.where(hi.x <= hi.z, 0, 2), jnp.where(hi.y <= hi.z, 1, 2))
    return t_near, t_far, axis_near, axis_far


def _axis_normal(axis, sign) -> Vec3:
    return Vec3(
        jnp.where(axis == 0, sign, 0.0),
        jnp.where(axis == 1, sign, 0.0),
        jnp.where(axis == 2, sign, 0.0),
    )


def _select_axis(x, y, z, axis):
    """Component of a vector by per-lane axis index — elementwise selects
    over the three components."""
    return jnp.where(axis == 0, x, jnp.where(axis == 1, y, z))


def intersect(group: BoxGroup, ray, t_min, t_max, chunk: int = 256) -> Hit:
    """Closest box hit per ray: surface t is t_near if in range else t_far
    (ray started inside — box.rs:131-134), with the face's outward normal and
    face uv. A dense (rays x boxes) slab sweep with a min-t argmin: XLA fuses
    it into one compare-and-min pass, which serves book2's 400-box ground
    (scene.rs:341-358) as well as small groups."""
    o = ray.origin.map(lambda a: a[:, None])
    d = ray.direction.map(lambda a: a[:, None])
    oriented = group.inv_rows is not None
    if oriented:
        rows = tuple(r.map(lambda a: a[None, :]) for r in group.inv_rows)
        off = group.inv_off.map(lambda a: a[None, :])
        o = _apply_rows(rows, off, o, translate=True)
        d = _apply_rows(rows, off, d, translate=False)

    pmin = group.p_min.map(lambda a: a[None, :])
    pmax = group.p_max.map(lambda a: a[None, :])
    t_near, t_far, axis_near, axis_far = slab(pmin, pmax, o, d)

    hit_slab = (t_near < t_far) & group.active[None, :]
    near_in = hit_slab & (t_min < t_near) & (t_near < t_max)
    far_in = hit_slab & (t_min < t_far) & (t_far < t_max)
    t = jnp.where(near_in, t_near, jnp.where(far_in, t_far, BIG))

    idx = jnp.argmin(t, axis=1)
    onehot = hitlib.onehot_of(idx, t.shape[1])
    t_best = jnp.min(t, axis=1)
    valid = t_best < BIG

    near_sel = hitlib.select_row_bool(onehot, near_in)
    axis = hitlib.select_row(onehot, jnp.where(near_in, axis_near, axis_far))

    d_sel = ray.direction
    o_sel = ray.origin
    if oriented:
        rows_sel = tuple(hitlib.select_table_vec(onehot, r) for r in group.inv_rows)
        off_sel = hitlib.select_table_vec(onehot, group.inv_off)
        d_obj = _apply_rows(rows_sel, off_sel, d_sel, translate=False)
        o_obj = _apply_rows(rows_sel, off_sel, o_sel, translate=True)
    else:
        d_obj, o_obj = d_sel, o_sel

    d_axis = _select_axis(d_obj.x, d_obj.y, d_obj.z, axis)
    # outward normal of the entry face opposes d; of the exit face follows d
    sign = jnp.where(near_sel, -jnp.sign(d_axis), jnp.sign(d_axis))
    n_obj = _axis_normal(axis, sign)
    if oriented:
        geom_n = _apply_rows_t(rows_sel, n_obj).unit()
    else:
        geom_n = n_obj

    # face uv: fractional coords of the object-space hit in the two free axes
    p_obj = o_obj + d_obj * t_best
    pmin_sel = hitlib.select_table_vec(onehot, group.p_min)
    pmax_sel = hitlib.select_table_vec(onehot, group.p_max)
    rel = (p_obj - pmin_sel) / (pmax_sel - pmin_sel).map(lambda c: jnp.where(jnp.abs(c) < 1e-12, 1.0, c))
    a0 = (axis + 1) % 3
    a1 = (axis + 2) % 3
    u = _select_axis(rel.x, rel.y, rel.z, a0)
    v = _select_axis(rel.x, rel.y, rel.z, a1)

    mat_id = hitlib.select_table(onehot, group.mat_id)
    return hitlib.finalize(ray.direction, t_best, geom_n, u, v, mat_id, valid)


# -- CSG / media support (single box, scalar params broadcast over rays) ----

def interval(p_min: Vec3, p_max: Vec3, ray, t_min, t_max, inv_rows=None, inv_off=None):
    """(t1, t2, valid, axis, near_sel, d_obj) interval of one box per ray,
    following box.rs:125-149: (t_near, t_far) if entering, (t_far, MAX) when
    the ray starts inside."""
    o, d = ray.origin, ray.direction
    if inv_rows is not None:
        o = _apply_rows(inv_rows, inv_off, o, translate=True)
        d = _apply_rows(inv_rows, inv_off, d, translate=False)
    t_near, t_far, axis_near, axis_far = slab(p_min, p_max, o, d)
    hit_slab = t_near < t_far
    near_in = hit_slab & (t_min < t_near) & (t_near < t_max)
    far_in = hit_slab & (t_min < t_far) & (t_far < t_max)
    t1 = jnp.where(near_in, t_near, t_far)
    t2 = jnp.where(near_in, t_far, BIG)
    valid = near_in | far_in
    axis = jnp.where(near_in, axis_near, axis_far)
    return t1, t2, valid, axis, near_in, d, o


def normal_of(axis, near_sel, d_obj: Vec3, inv_rows=None) -> Vec3:
    d_axis = _select_axis(d_obj.x, d_obj.y, d_obj.z, axis)
    sign = jnp.where(near_sel, -jnp.sign(d_axis), jnp.sign(d_axis))
    n = _axis_normal(axis, sign)
    if inv_rows is not None:
        n = _apply_rows_t(inv_rows, n).unit()
    return n


def contains(p_min: Vec3, p_max: Vec3, p: Vec3, inv_rows=None, inv_off=None):
    """box.rs:151-156 (inclusive bounds)."""
    if inv_rows is not None:
        p = _apply_rows(inv_rows, inv_off, p, translate=True)
    return (
        (p.x >= p_min.x) & (p.x <= p_max.x)
        & (p.y >= p_min.y) & (p.y <= p_max.y)
        & (p.z >= p_min.z) & (p.z <= p_max.z)
    )
