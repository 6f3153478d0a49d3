"""Pallas (Triton route) kernel: per-ray skip-link BVH walk over a triangle
mesh, for NVIDIA GPUs.

One lane per ray, BLOCK rays per program. Each lane walks the same skip-link
tree as the plain reference `geometry.triangles.intersect` (accel/bvh.py
layout: interior node i descends to i + 1, every node skips to miss[i]) on
its own, gathering node bounds, leaf ranges and triangle edges from the
group's SoA arrays. The block's loop runs while any of its lanes is still
walking, so a divergent ray holds up its own block only, not the whole batch
as the lockstep XLA walk does.

Admission follows the reference's slab test, with the per-ray cap `t_cap`
(the best hit found in cheaper primitive groups) tightening it, and
`t_cap <= 0` marking a dead lane that reports a miss. The kernel returns the
winner (t, triangle index, beta, gamma); `triangles._finish` builds the hit
record in XLA.

Replaces the reference's recursive traversal (src/hittable/collection/
bvh.rs:173-192) and triangle test (triangle_mesh.rs:85-131).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raysnail_tpu.accel.bvh import LEAF_SIZE
from raysnail_tpu.geometry.hit import BIG

BLOCK = 128      # rays per program: one lane each
NUM_WARPS = 4


def _kernel(ox, oy, oz, dx, dy, dz, cap,
            bminx, bminy, bminz, bmaxx, bmaxy, bmaxz, first, count, miss,
            p0x, p0y, p0z, ax, ay, az, ddx, ddy, ddz, mat,
            t_out, tri_out, b_out, g_out, *, n_nodes: int, t_min: float,
            t_max: float):
    o_x, o_y, o_z = ox[...], oy[...], oz[...]
    d_x, d_y, d_z = dx[...], dy[...], dz[...]
    t_cap = cap[...]
    inv = lambda d: 1.0 / jnp.where(jnp.abs(d) < 1e-12,
                                    jnp.where(d < 0, -1e-12, 1e-12), d)
    i_x, i_y, i_z = inv(d_x), inv(d_y), inv(d_z)
    end = jnp.int32(n_nodes)

    def gather(ref, idx, mask, other=0.0):
        return plgpu.load(ref.at[idx], mask=mask, other=other)

    def body(st):
        node, bt, btri, bb, bg = st
        live = node < end
        nc = jnp.minimum(node, end - 1)

        # slab test (triangles.intersect's box_hit), admission capped by
        # the best hit so far and by the cheaper groups' best (t_cap)
        ta_x = (gather(bminx, nc, live) - o_x) * i_x
        tb_x = (gather(bmaxx, nc, live) - o_x) * i_x
        ta_y = (gather(bminy, nc, live) - o_y) * i_y
        tb_y = (gather(bmaxy, nc, live) - o_y) * i_y
        ta_z = (gather(bminz, nc, live) - o_z) * i_z
        tb_z = (gather(bmaxz, nc, live) - o_z) * i_z
        t_near = jnp.maximum(jnp.maximum(jnp.minimum(ta_x, tb_x),
                                         jnp.minimum(ta_y, tb_y)),
                             jnp.minimum(ta_z, tb_z))
        t_far = jnp.minimum(jnp.minimum(jnp.maximum(ta_x, tb_x),
                                        jnp.maximum(ta_y, tb_y)),
                            jnp.maximum(ta_z, tb_z))
        hit_box = (live & (t_near <= t_far) & (t_far >= t_min)
                   & (t_near < jnp.minimum(bt, t_cap)))
        cnt = gather(count, nc, live, 0)
        is_leaf = cnt > 0
        do_leaf = hit_box & is_leaf
        base = gather(first, nc, do_leaf, 0)

        # Cramer's-rule solve for each slot of the leaf (triangles._tri_hit)
        for s in range(LEAF_SIZE):
            tri = base + s
            j = gather(p0x, tri, do_leaf) - o_x
            k = gather(p0y, tri, do_leaf) - o_y
            l = gather(p0z, tri, do_leaf) - o_z
            a_x = gather(ax, tri, do_leaf)
            a_y = gather(ay, tri, do_leaf)
            a_z = gather(az, tri, do_leaf)
            e_x = gather(ddx, tri, do_leaf)
            e_y = gather(ddy, tri, do_leaf)
            e_z = gather(ddz, tri, do_leaf)
            m = gather(mat, tri, do_leaf, -2)
            eihf = e_y * d_z - d_y * e_z
            gfdi = d_x * e_z - e_x * d_z
            dheg = e_x * d_y - e_y * d_x
            denom = a_x * eihf + a_y * gfdi + a_z * dheg
            denom = jnp.where(jnp.abs(denom) < 1e-20, 1e-20, denom)
            beta = (j * eihf + k * gfdi + l * dheg) / denom
            akjb = a_x * k - j * a_y
            jcal = j * a_z - a_x * l
            blkc = a_y * l - k * a_z
            gamma = (d_z * akjb + d_y * jcal + d_x * blkc) / denom
            t = -(e_z * akjb + e_y * jcal + e_x * blkc) / denom
            take = (do_leaf & (beta >= 0.0) & (beta < 1.0) & (gamma > 0.0)
                    & (beta + gamma < 1.0) & (t >= t_min) & (t <= t_max)
                    & (m != -2) & (t < bt))
            bt = jnp.where(take, t, bt)
            btri = jnp.where(take, tri, btri)
            bb = jnp.where(take, beta, bb)
            bg = jnp.where(take, gamma, bg)

        descend = hit_box & (~is_leaf)
        nxt = jnp.where(descend, nc + 1, gather(miss, nc, live, n_nodes))
        node = jnp.where(live, nxt, node)
        return node, bt, btri, bb, bg

    zeros = jnp.zeros_like(o_x)
    init = (jnp.where(t_cap > 0.0, 0, end).astype(jnp.int32),
            jnp.full_like(o_x, BIG), jnp.zeros(o_x.shape, jnp.int32),
            zeros, zeros)
    _, bt, btri, bb, bg = jax.lax.while_loop(
        lambda st: jnp.min(st[0]) < end, body, init)
    t_out[...] = bt
    tri_out[...] = btri
    b_out[...] = bb
    g_out[...] = bg


@functools.partial(jax.jit, static_argnames=("t_min", "t_max", "interpret"))
def traverse(group, origin, direction, t_cap, *, t_min: float, t_max: float,
             interpret: bool = False):
    """-> (best_t, best_tri, beta, gamma), each (N,); best_t = BIG on a miss.

    group: a triangles.TriangleGroup; origin, direction: Vec3 of (N,) rays;
    t_cap: (N,) admission cap, <= 0 for dead lanes. N is padded here to a
    multiple of BLOCK with dead lanes."""
    n = origin.x.shape[0]
    pad = (-n) % BLOCK
    f32 = lambda a: jnp.asarray(a, jnp.float32)
    p = lambda a, v=0.0: jnp.pad(f32(a), (0, pad), constant_values=v)
    rays = [p(origin.x), p(origin.y), p(origin.z),
            p(direction.x), p(direction.y), p(direction.z), p(t_cap, -1.0)]
    tables = [group.bb_min.x, group.bb_min.y, group.bb_min.z,
              group.bb_max.x, group.bb_max.y, group.bb_max.z,
              group.first, group.count, group.miss,
              group.p0.x, group.p0.y, group.p0.z,
              group.edge_a.x, group.edge_a.y, group.edge_a.z,
              group.edge_d.x, group.edge_d.y, group.edge_d.z, group.mat_id]
    n_pad = n + pad
    ray_spec = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))
    out_shape = [jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                 jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                 jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                 jax.ShapeDtypeStruct((n_pad,), jnp.float32)]
    out = pl.pallas_call(
        functools.partial(_kernel, n_nodes=int(group.first.shape[0]),
                          t_min=float(t_min), t_max=float(t_max)),
        grid=(n_pad // BLOCK,),
        in_specs=[ray_spec] * len(rays) + [whole(a) for a in tables],
        out_specs=[ray_spec] * 4,
        out_shape=out_shape,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS),
        interpret=interpret,
        name="mesh_bvh_walk",
    )(*rays, *tables)
    return tuple(a[:n] for a in out)
