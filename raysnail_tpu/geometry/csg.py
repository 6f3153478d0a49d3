"""Constructive solid geometry: vectorized interval logic over static trees.

The reference's Intersection/Difference (src/hittable/csg/) hit both children,
sort by entry t, and use `contains(point)` probes to pick the visible surface.
Scene compile lowers each CSG object (with its transform pushed down to the
leaves) into a static Python tree of leaf nodes; hit/contains evaluation
unrolls the tree at trace time, so the device code is straight-line selects —
no recursion, no vtables.

Leaf kinds match what the reference SDL grammar can put inside CSG: spheres,
boxes (possibly oriented), and quadrics (transforms baked into coefficients).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raysnail_tpu.geometry import boxes, quadrics, spheres
from raysnail_tpu.geometry.hit import BIG, Hit
from raysnail_tpu.prelude.vec import Vec3


class CsgHit(NamedTuple):
    """A child hit inside CSG evaluation: the reference's full HitRecord
    including the exit distance t2 (hit.rs:16-17)."""
    t1: jax.Array
    t2: jax.Array
    valid: jax.Array
    normal: Vec3       # flipped against the ray (like HitRecord)
    u: jax.Array
    v: jax.Array
    mat_id: jax.Array
    outside: jax.Array

    def to_hit(self) -> Hit:
        t = jnp.where(self.valid, self.t1, BIG)
        return Hit(t=t, valid=self.valid, normal=self.normal, u=self.u,
                   v=self.v, mat_id=self.mat_id, outside=self.outside)

    @staticmethod
    def select(mask, a: "CsgHit", b: "CsgHit") -> "CsgHit":
        return jax.tree_util.tree_map(
            lambda x, y: Vec3.where(mask, x, y) if isinstance(x, Vec3) else jnp.where(mask, x, y),
            a, b, is_leaf=lambda x: isinstance(x, Vec3),
        )


# -- leaves ----------------------------------------------------------------

class SphereLeaf(NamedTuple):
    center: Vec3       # scalars
    radius: jax.Array
    mat_id: int        # static; -1 = inherit

    def hit(self, ray, t_min, t_max) -> CsgHit:
        t1, t2, valid = spheres.interval(self.center, self.radius, ray, t_min, t_max)
        p = ray.origin + ray.direction * t1
        geom_n = spheres.normal_at(self.center, self.radius, p)
        outside = ray.direction.dot(geom_n) < 0.0
        n = Vec3.where(outside, geom_n, -geom_n)
        u, v = spheres.sphere_uv(p - self.center)
        mid = jnp.full(jnp.shape(t1), self.mat_id, jnp.int32)
        return CsgHit(t1, t2, valid, n, u, v, mid, outside)

    def contains(self, p: Vec3):
        return spheres.contains(self.center, self.radius, p)

    def normal_at(self, p: Vec3) -> Vec3:
        return spheres.normal_at(self.center, self.radius, p)


class BoxLeaf(NamedTuple):
    p_min: Vec3
    p_max: Vec3
    inv_rows: tuple | None   # orientation (None = axis-aligned)
    inv_off: Vec3 | None
    mat_id: int

    def hit(self, ray, t_min, t_max) -> CsgHit:
        t1, t2, valid, axis, near_sel, d_obj, o_obj = boxes.interval(
            self.p_min, self.p_max, ray, t_min, t_max, self.inv_rows, self.inv_off
        )
        n = boxes.normal_of(axis, near_sel, d_obj, self.inv_rows)
        # slab normals already face the ray; outside = entered from outside
        p_obj = o_obj + d_obj * t1
        span = (self.p_max - self.p_min).map(lambda c: jnp.where(jnp.abs(c) < 1e-12, 1.0, c))
        rel = (p_obj - self.p_min) / span
        a0 = (axis + 1) % 3
        a1 = (axis + 2) % 3
        u = boxes._select_axis(rel.x, rel.y, rel.z, a0)
        v = boxes._select_axis(rel.x, rel.y, rel.z, a1)
        mid = jnp.full(jnp.shape(t1), self.mat_id, jnp.int32)
        return CsgHit(t1, t2, valid, n, u, v, mid, near_sel)

    def contains(self, p: Vec3):
        return boxes.contains(self.p_min, self.p_max, p, self.inv_rows, self.inv_off)

    def normal_at(self, p: Vec3) -> Vec3:
        # Box::normal is a fixed +y (box.rs:117-119) — replicated for the
        # difference-exit synthetic hit.
        shape = jnp.shape(p.x)
        return Vec3.full((0.0, 1.0, 0.0), shape, p.dtype)


class RectLeaf(NamedTuple):
    """Axis-aligned (optionally oriented) rect as a CSG child. Matches the
    reference's AARect under CSG exactly: the hit carries t2 = f64::MAX
    (rect.rs:118), contains() is always false (rect.rs:122-125), and
    normal() is the fixed plane-axis unit vector (rect.rs:84-88)."""
    k_axis: int        # static 0=YZ 1=XZ 2=XY
    k: jax.Array       # scalars
    a0: jax.Array
    a1: jax.Array
    b0: jax.Array
    b1: jax.Array
    inv_rows: tuple | None
    inv_off: Vec3 | None
    mat_id: int

    def hit(self, ray, t_min, t_max) -> CsgHit:
        o, d = ray.origin, ray.direction
        if self.inv_rows is not None:
            from raysnail_tpu.geometry.boxes import _apply_rows
            o = _apply_rows(self.inv_rows, self.inv_off, o, translate=True)
            d = _apply_rows(self.inv_rows, self.inv_off, d, translate=False)
        ax = self.k_axis
        comps = lambda v: (v.x, v.y, v.z)
        ok_, oa, ob = (comps(o)[ax], comps(o)[(1, 0, 0)[ax]], comps(o)[(2, 2, 1)[ax]])
        dk_, da, db = (comps(d)[ax], comps(d)[(1, 0, 0)[ax]], comps(d)[(2, 2, 1)[ax]])
        dk_ = jnp.where(jnp.abs(dk_) < 1e-12,
                        jnp.where(dk_ < 0, -1e-12, 1e-12), dk_)
        t1 = (self.k - ok_) / dk_
        pa = oa + t1 * da
        pb = ob + t1 * db
        valid = ((t_min < t1) & (t1 < t_max)
                 & (pa >= self.a0) & (pa <= self.a1)
                 & (pb >= self.b0) & (pb <= self.b1))
        n = self.normal_at(ray.origin)  # fixed axis normal
        outside = d.dot(n) < 0.0
        n = Vec3.where(outside, n, -n)
        u = (pa - self.a0) / (self.a1 - self.a0)
        v = (pb - self.b0) / (self.b1 - self.b0)
        mid = jnp.full(jnp.shape(t1), self.mat_id, jnp.int32)
        return CsgHit(jnp.where(valid, t1, BIG),
                      jnp.full(jnp.shape(t1), BIG), valid, n, u, v, mid, outside)

    def contains(self, p: Vec3):
        return jnp.zeros(jnp.shape(p.x), bool)  # rect.rs:122-125

    def normal_at(self, p: Vec3) -> Vec3:
        shape = jnp.shape(p.x)
        n = Vec3.full(((1.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                       (0.0, 0.0, 1.0))[self.k_axis], shape, p.dtype)
        if self.inv_rows is not None:
            from raysnail_tpu.geometry.boxes import _apply_rows_t
            n = _apply_rows_t(self.inv_rows, n).unit()
        return n


class MeshLeaf(NamedTuple):
    """Triangle mesh as a CSG child (the reference composes any
    Arc<dyn Hittable>, intersection.rs:19-23). Triangle hits carry
    t2 = f64::MAX (triangle_mesh.rs:119-126) and contains() is always false
    (triangle_mesh.rs:133-136), so inside CSG a mesh behaves as a thin
    shell — replicated exactly. normal_at (only reached as the minus child
    of a Difference) is where the reference PANICS (hit.rs:82-87
    unimplemented!); we return +y like Box::normal instead of crashing."""
    group: object      # triangles.TriangleGroup
    mat_id: int
    brute: bool        # static: dense sweep vs BVH walk

    def hit(self, ray, t_min, t_max) -> CsgHit:
        from raysnail_tpu.geometry import triangles
        if self.brute:
            h = triangles.intersect_brute(self.group, ray, t_min, t_max)
        else:
            h = triangles.intersect(self.group, ray, t_min, t_max)
        return CsgHit(t1=h.t, t2=jnp.full(jnp.shape(h.t), BIG), valid=h.valid,
                      normal=h.normal, u=h.u, v=h.v, mat_id=h.mat_id,
                      outside=h.outside)

    def contains(self, p: Vec3):
        return jnp.zeros(jnp.shape(p.x), bool)  # triangle_mesh.rs:133-136

    def normal_at(self, p: Vec3) -> Vec3:
        shape = jnp.shape(p.x)
        return Vec3.full((0.0, 1.0, 0.0), shape, p.dtype)


class QuadricLeaf(NamedTuple):
    coeffs: quadrics.Coeffs
    mat_id: int

    def hit(self, ray, t_min, t_max) -> CsgHit:
        t1, t2, valid = quadrics.interval(self.coeffs, ray, t_min, t_max)
        p = ray.origin + ray.direction * t1
        geom_n = quadrics.normal_at(self.coeffs, p)
        outside = ray.direction.dot(geom_n) < 0.0
        n = Vec3.where(outside, geom_n, -geom_n)
        z = jnp.zeros_like(t1)
        mid = jnp.full(jnp.shape(t1), self.mat_id, jnp.int32)
        return CsgHit(t1, t2, valid, n, z, z, mid, outside)

    def contains(self, p: Vec3):
        return quadrics.contains(self.coeffs, p)

    def normal_at(self, p: Vec3) -> Vec3:
        return quadrics.normal_at(self.coeffs, p)


# -- internal nodes --------------------------------------------------------

class IntersectionNode(NamedTuple):
    left: object
    right: object
    mat_id: int   # override applied when the child hit has mat_id < 0

    def hit(self, ray, t_min, t_max) -> CsgHit:
        """intersection.rs:58-96."""
        h1 = self.left.hit(ray, t_min, t_max)
        h2 = self.right.hit(ray, t_min, t_max)
        both = h1.valid & h2.valid
        first_is_1 = h1.t1 < h2.t1
        near = CsgHit.select(first_is_1, h1, h2)
        far = CsgHit.select(first_is_1, h2, h1)

        p_near = ray.origin + ray.direction * near.t1
        p_far = ray.origin + ray.direction * far.t1
        # contains() of the farther OBJECT at the nearer point, and vice versa
        c_other_at_near = jnp.where(
            first_is_1, self.right.contains(p_near), self.left.contains(p_near)
        )
        c_near_at_far = jnp.where(
            first_is_1, self.left.contains(p_far), self.right.contains(p_far)
        )
        use_near = both & c_other_at_near
        use_far = both & (~c_other_at_near) & c_near_at_far

        out = CsgHit.select(use_near, near, far)
        out = out._replace(valid=use_near | use_far)
        return _override_material(out, self.mat_id)

    def contains(self, p: Vec3):
        return self.left.contains(p) & self.right.contains(p)

    def normal_at(self, p: Vec3) -> Vec3:
        return self.left.normal_at(p)


class DifferenceNode(NamedTuple):
    plus: object
    minus: object
    mat_id: int
    minus_mat_id: int  # material() of the minus child for the synthetic hit

    def hit(self, ray, t_min, t_max) -> CsgHit:
        """difference.rs:57-106."""
        hp = self.plus.hit(ray, t_min, t_max)
        hm = self.minus.hit(ray, t_min, t_max)

        p_plus = ray.origin + ray.direction * hp.t1
        plus_first = hp.t1 < hm.t1

        only_plus = hp.valid & (~hm.valid)
        case_b = hp.valid & hm.valid & plus_first & (~self.minus.contains(p_plus))
        case_c = hp.valid & hm.valid & (~plus_first) & (hm.t2 < hp.t1)
        case_d = (
            hp.valid & hm.valid & (~plus_first)
            & (hm.t2 >= hp.t1) & (hm.t2 < hp.t2)
        )

        use_plus = only_plus | case_b | case_c

        # synthetic exit-of-minus hit (difference.rs:85-105): normal is the
        # NEGATED minus.normal(p), uv = (0,0), outside = true, material = minus's
        t_syn = hm.t2
        p_syn = ray.origin + ray.direction * t_syn
        n_syn = -self.minus.normal_at(p_syn)
        z = jnp.zeros_like(t_syn)
        syn = CsgHit(
            t1=t_syn, t2=hp.t2, valid=case_d, normal=n_syn, u=z, v=z,
            mat_id=jnp.full(jnp.shape(t_syn), self.minus_mat_id, jnp.int32),
            outside=jnp.ones(jnp.shape(t_syn), bool),
        )
        out = CsgHit.select(use_plus, hp, syn)
        out = out._replace(valid=use_plus | case_d)
        return _override_material(out, self.mat_id)

    def contains(self, p: Vec3):
        return self.plus.contains(p) & (~self.minus.contains(p))

    def normal_at(self, p: Vec3) -> Vec3:
        return self.plus.normal_at(p)


def _override_material(h: CsgHit, mat_id) -> CsgHit:
    """HitRecord::set_material_if_none (hit.rs:69-77). mat_id may be a static
    int or a traced scalar (structure-deduped trees trace one program for
    many material bindings)."""
    if isinstance(mat_id, int) and mat_id < 0:
        return h
    mid = jnp.asarray(mat_id, jnp.int32)
    return h._replace(
        mat_id=jnp.where((h.mat_id < 0) & (mid >= 0), mid, h.mat_id))


def intersect_trees(trees, ray, t_min, t_max) -> Hit:
    """Closest hit over a tuple of CSG trees.

    Trees with identical pytree STRUCTURE (same node/leaf shapes — e.g. the
    four quadric-cap intersections of quadric.sdl, or declares.sdl's 7-blade
    #while fan) are stacked parameter-wise and evaluated by ONE traced
    program under lax.map, so program size stays O(distinct structures)
    instead of O(trees) — remote XLA compiles cost tens of seconds each."""
    from raysnail_tpu.geometry.hit import combine_hits, miss

    best = miss(jnp.shape(ray.direction.x), ray.direction.dtype)

    def _has_static_leaf(tree):
        """Rect/Mesh leaves carry static Python fields (k_axis, brute) that
        must not be stacked into traced arrays — such trees trace solo."""
        if isinstance(tree, (RectLeaf, MeshLeaf)):
            return True
        if isinstance(tree, (IntersectionNode,)):
            return _has_static_leaf(tree.left) or _has_static_leaf(tree.right)
        if isinstance(tree, DifferenceNode):
            return _has_static_leaf(tree.plus) or _has_static_leaf(tree.minus)
        return False

    groups: dict = {}
    solo = 0
    for tree in trees:
        if _has_static_leaf(tree):
            groups[("solo", solo)] = [tree]
            solo += 1
        else:
            groups.setdefault(jax.tree_util.tree_structure(tree), []).append(tree)

    for group in groups.values():
        if len(group) == 1:
            best = combine_hits(best, group[0].hit(ray, t_min, t_max).to_hit())
            continue
        stacked = jax.tree_util.tree_map(
            lambda *xs: jnp.stack([jnp.asarray(x) for x in xs]), *group)
        # vmap, NOT lax.map: one traced program per structure AND vectorized
        # execution — lax.map lowers to a sequential scan; the (K, N)
        # batched form keeps dense-sweep throughput
        hits = jax.vmap(lambda tr: tr.hit(ray, t_min, t_max).to_hit())(stacked)
        # reduce over the K axis with static slices + selects (K is small),
        # fused elementwise, instead of argmin + take_along_axis
        for k in range(len(group)):
            hk = jax.tree_util.tree_map(
                lambda a, k=k: a.map(lambda c: c[k]) if isinstance(a, Vec3) else a[k],
                hits, is_leaf=lambda x: isinstance(x, Vec3))
            best = combine_hits(best, hk)
    return best
