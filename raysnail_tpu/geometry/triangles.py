"""Triangle meshes: SoA storage + stackless lockstep BVH traversal.

Triangle test replicates the reference's Cramer's-rule barycentric solve with
precomputed edge coefficients (src/hittable/geometry/triangle_mesh.rs:41-60,
85-131): beta in [0,1), gamma in (0,1), beta+gamma < 1, smooth normal =
barycentric blend of vertex normals used AS GIVEN (HitRecord::with_normal
sets outside=true without ray-facing flip), uv = (0,0).

Traversal (`intersect`, the plain reference): all rays advance in lockstep
through the skip-link BVH (accel/bvh.py) inside one lax.while_loop; a leaf
visit tests a fixed LEAF_SIZE block of triangles via gathers. No recursion,
no stacks, static shapes — the replacement for bvh.rs:173-192.
`intersect_kernel` walks the same tree one ray per lane in a Pallas kernel
(ops/mesh_kernel.py), the route meshes take on a GPU.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raysnail_tpu.accel.bvh import LEAF_SIZE
from raysnail_tpu.geometry import hit as hitlib
from raysnail_tpu.geometry.hit import BIG, Hit
from raysnail_tpu.prelude.vec import Vec3


class TriangleGroup(NamedTuple):
    # per-triangle data, already reordered into BVH leaf order and padded
    # (degenerate entries have mat_id == -2)
    p0: Vec3            # (F,)
    edge_a: Vec3        # p0 - p1 (the reference's a,b,c)
    edge_d: Vec3        # p0 - p2 (the reference's d,e,f)
    n0: Vec3            # vertex normals
    n1: Vec3
    n2: Vec3
    mat_id: jax.Array   # (F,) int32; -2 for padding
    # flat BVH
    bb_min: Vec3        # (M,)
    bb_max: Vec3        # (M,)
    first: jax.Array    # (M,) int32
    count: jax.Array    # (M,) int32 (0 interior, LEAF_SIZE leaf)
    miss: jax.Array     # (M,) int32


def _tri_hit(g: TriangleGroup, tri_idx, o: Vec3, d: Vec3, t_min, t_max):
    """Batched Cramer's-rule solve for gathered triangle indices
    (triangle_mesh.rs:85-131). Returns (t, beta, gamma, valid)."""
    p0 = hitlib.gather(g.p0, tri_idx)
    A = hitlib.gather(g.edge_a, tri_idx)
    D = hitlib.gather(g.edge_d, tri_idx)

    j = p0.x - o.x
    k = p0.y - o.y
    l = p0.z - o.z

    eihf = D.y * d.z - d.y * D.z
    gfdi = d.x * D.z - D.x * d.z
    dheg = D.x * d.y - D.y * d.x
    denom = A.x * eihf + A.y * gfdi + A.z * dheg
    denom = jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
    beta = (j * eihf + k * gfdi + l * dheg) / denom

    akjb = A.x * k - j * A.y
    jcal = j * A.z - A.x * l
    blkc = A.y * l - k * A.z
    gamma = (d.z * akjb + d.y * jcal + d.x * blkc) / denom
    t = -(D.z * akjb + D.y * jcal + D.x * blkc) / denom

    valid = (
        (beta >= 0.0) & (beta < 1.0)
        & (gamma > 0.0) & (beta + gamma < 1.0)
        & (t >= t_min) & (t <= t_max)
        & (hitlib.gather(g.mat_id, tri_idx) != -2)
    )
    return t, beta, gamma, valid


def intersect_brute(group: TriangleGroup, ray, t_min, t_max,
                    chunk: int = 256) -> Hit:
    """Dense chunked triangle sweep — no BVH, no gathers: a (rays x chunk)
    broadcast test with per-chunk triangle data (the same pattern as the
    sphere group). Scene compile picks this path for small/medium meshes
    (BRUTE_FORCE_MAX) on the XLA route and keeps the BVH walk for large
    ones."""
    n = jnp.shape(ray.direction.x)[0]
    f = group.mat_id.shape[0]
    o = ray.origin.map(lambda a: a[:, None])
    d = ray.direction.map(lambda a: a[:, None])

    n_chunks = -(-f // chunk)
    pad = n_chunks * chunk - f

    def padded(a):
        return jnp.pad(a, (0, pad)) if pad else a

    p0 = group.p0.map(padded)
    A = group.edge_a.map(padded)
    D = group.edge_d.map(padded)
    mat = jnp.pad(group.mat_id, (0, pad), constant_values=-2) if pad else group.mat_id

    def reshaped(v):
        return v.map(lambda a: a.reshape(n_chunks, chunk))

    p0c, Ac, Dc = reshaped(p0), reshaped(A), reshaped(D)
    matc = mat.reshape(n_chunks, chunk)

    def body(carry, xs):
        bt, btri, bb, bg, base = carry
        p0_, A_, D_, m_ = xs
        p0r = p0_.map(lambda a: a[None, :])
        Ar = A_.map(lambda a: a[None, :])
        Dr = D_.map(lambda a: a[None, :])

        j = p0r.x - o.x
        k = p0r.y - o.y
        l = p0r.z - o.z
        eihf = Dr.y * d.z - d.y * Dr.z
        gfdi = d.x * Dr.z - Dr.x * d.z
        dheg = Dr.x * d.y - Dr.y * d.x
        denom = Ar.x * eihf + Ar.y * gfdi + Ar.z * dheg
        denom = jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
        beta = (j * eihf + k * gfdi + l * dheg) / denom
        akjb = Ar.x * k - j * Ar.y
        jcal = j * Ar.z - Ar.x * l
        blkc = Ar.y * l - k * Ar.z
        gamma = (d.z * akjb + d.y * jcal + d.x * blkc) / denom
        t = -(Dr.z * akjb + Dr.y * jcal + Dr.x * blkc) / denom
        ok = (
            (beta >= 0.0) & (beta < 1.0) & (gamma > 0.0) & (beta + gamma < 1.0)
            & (t >= t_min) & (t <= t_max) & (m_[None, :] != -2)
        )
        t = jnp.where(ok, t, BIG)
        tc = jnp.min(t, axis=1)
        onehot = hitlib.onehot_of(jnp.argmin(t, axis=1), chunk)
        take = tc < bt
        bt = jnp.where(take, tc, bt)
        btri = jnp.where(take, hitlib.select_row(
            onehot, jnp.broadcast_to(jnp.arange(chunk, dtype=jnp.int32)[None, :], t.shape)
        ) + base, btri)
        bb = jnp.where(take, hitlib.select_row(onehot, beta), bb)
        bg = jnp.where(take, hitlib.select_row(onehot, gamma), bg)
        return (bt, btri, bb, bg, base + chunk), None

    init = (
        jnp.full(n, BIG, d.x.dtype),
        jnp.zeros(n, jnp.int32),
        jnp.zeros(n, d.x.dtype),
        jnp.zeros(n, d.x.dtype),
        jnp.asarray(0, jnp.int32),
    )
    (best_t, best_tri, beta, gamma, _), _ = jax.lax.scan(
        body, init, (p0c, Ac, Dc, matc)
    )
    return _finish(group, ray, best_t, best_tri, beta, gamma)


def _finish(group: TriangleGroup, ray, best_t, best_tri, beta, gamma) -> Hit:
    valid = best_t < BIG
    n0 = hitlib.gather(group.n0, best_tri)
    n1 = hitlib.gather(group.n1, best_tri)
    n2 = hitlib.gather(group.n2, best_tri)
    normal = (n0 * (1.0 - beta - gamma) + n1 * beta + n2 * gamma).unit()
    mat_id = group.mat_id[best_tri]
    z = jnp.zeros_like(best_t)
    t = jnp.where(valid, best_t, BIG)
    # with_normal semantics: normal as given, outside = true
    return Hit(
        t=t, valid=valid, normal=normal, u=z, v=z,
        mat_id=jnp.where(valid, mat_id, -1).astype(jnp.int32),
        outside=jnp.ones_like(valid),
    )


def intersect(group: TriangleGroup, ray, t_min, t_max,
              max_iters: int = 4096) -> Hit:
    """Closest triangle hit per ray through the lockstep XLA BVH walk."""
    return _finish(group, ray, *walk(group, ray, t_min, t_max, max_iters))


def walk(group: TriangleGroup, ray, t_min, t_max, max_iters: int = 4096):
    """The lockstep skip-link walk: every ray advances one node per
    iteration until all are done or `max_iters` is reached (a walk cut
    short misses hits; pass max_iters >= the node count for an exact
    reference). -> (best_t, best_tri, beta, gamma), best_t = BIG on a
    miss."""
    o, d = ray.origin, ray.direction
    n = jnp.shape(d.x)[0]
    n_nodes = group.first.shape[0]
    END = n_nodes

    inv_d = d.map(lambda c: 1.0 / jnp.where(jnp.abs(c) < 1e-12,
                                            jnp.where(c < 0, -1e-12, 1e-12), c))

    def box_hit(node, best_t):
        lo = hitlib.gather(group.bb_min, node)
        hi = hitlib.gather(group.bb_max, node)
        ta = (lo - o) * inv_d
        tb = (hi - o) * inv_d
        t_near = Vec3(jnp.minimum(ta.x, tb.x), jnp.minimum(ta.y, tb.y),
                      jnp.minimum(ta.z, tb.z)).max_component()
        t_far = Vec3(jnp.maximum(ta.x, tb.x), jnp.maximum(ta.y, tb.y),
                     jnp.maximum(ta.z, tb.z)).min_component()
        return (t_near <= t_far) & (t_far >= t_min) & (t_near < best_t)

    def body(state):
        node, best_t, best_tri, best_b, best_g, it = state
        live = node < END
        node_c = jnp.minimum(node, END - 1)

        hit_box = box_hit(node_c, best_t) & live
        cnt = group.count[node_c]
        is_leaf = cnt > 0
        do_leaf = hit_box & is_leaf

        first = group.first[node_c]
        bt, btri, bb, bg = best_t, best_tri, best_b, best_g
        for s in range(LEAF_SIZE):
            tri = first + s
            t, beta, gamma, ok = _tri_hit(group, tri, o, d, t_min, t_max)
            take = do_leaf & ok & (t < bt)
            bt = jnp.where(take, t, bt)
            btri = jnp.where(take, tri, btri)
            bb = jnp.where(take, beta, bb)
            bg = jnp.where(take, gamma, bg)

        descend = hit_box & (~is_leaf)
        nxt = jnp.where(descend, node_c + 1, group.miss[node_c])
        node = jnp.where(live, nxt, node)
        return node, bt, btri, bb, bg, it + 1

    def cond(state):
        node, _, _, _, _, it = state
        return jnp.any(node < END) & (it < max_iters)

    init = (
        jnp.zeros(n, jnp.int32),
        jnp.full(n, BIG, d.x.dtype),
        jnp.zeros(n, jnp.int32),
        jnp.zeros(n, d.x.dtype),
        jnp.zeros(n, d.x.dtype),
        jnp.asarray(0, jnp.int32),
    )
    _, best_t, best_tri, beta, gamma, _ = jax.lax.while_loop(cond, body, init)
    return best_t, best_tri, beta, gamma


def intersect_kernel(group: TriangleGroup, ray, t_min, t_max,
                     active=None, t_cap=None, interpret: bool = False) -> Hit:
    """The BVH walk on the Pallas kernel (ops/mesh_kernel.py), one ray per
    lane; `_finish` builds the hit record in XLA.

    `active` is the integrator's alive mask: dead lanes do not walk and
    report a miss. `t_cap` is the best hit distance already found in cheaper
    primitive groups — traversal never admits a node beyond it. Inputs are
    detached: geometry gradients are out of scope, and no tangent may reach
    the kernel."""
    from raysnail_tpu.ops import mesh_kernel

    n = jnp.shape(ray.direction.x)[0]
    cap = (jnp.full(n, BIG, jnp.float32) if t_cap is None
           else jnp.asarray(t_cap, jnp.float32))
    if active is not None:
        cap = jnp.where(active, cap, -1.0)
    sg = jax.lax.stop_gradient
    best_t, best_tri, beta, gamma = mesh_kernel.traverse(
        sg(group), sg(ray.origin), sg(ray.direction), sg(cap),
        t_min=float(t_min), t_max=float(t_max), interpret=interpret)
    return _finish(group, ray, best_t, best_tri, beta, gamma)
