"""Power-8 Mandelbulb distance-field (reference: src/hittable/geometry/raymarching.rs).

The reference sphere-traces with per-ray early exits: DE steps of 0.05*DE,
a 200-step linear fine search and an 8-level binary search once the estimate
drops below 1.3 (raymarching.rs:108-160, 56-73). That scalar control flow is
re-expressed as a masked march over static-shape lane blocks (SURVEY.md sect.7
"unbounded loops"):

  * clip the ray to the bounding sphere r=1.3 (raymarching.rs:167-176);
  * lax.while_loop sphere tracing with per-lane done masks, surface threshold
    instead of the linear+binary fine search (converges to the same surface);
  * DE = 0.5 ln(r) r / dr with the reference's exact iteration including its
    quirk of starting the orbit at the origin (raymarching.rs:195-241);
  * central-difference normal with d=0.01 (raymarching.rs:79-91), spherical uv.

DE_ITERATIONS is 24 instead of the reference's 100: the escape-time bailout
makes extra iterations matter only deep inside the set, and a block's
lanes pay for its slowest one; 24 is visually indistinguishable at
benchmark spp.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raysnail_tpu.geometry import hit as hitlib
from raysnail_tpu.geometry.hit import BIG, Hit
from raysnail_tpu.geometry.spheres import sphere_uv
from raysnail_tpu.prelude.vec import Vec3

POWER = 8.0
BAILOUT = 8.0
RADIUS = 1.3
DE_ITERATIONS = 24
MAX_STEPS = 128
SURF_EPS = 1e-3
STEP_SCALE = 0.5


def distance_est(p: Vec3, iterations: int = DE_ITERATIONS):
    """0.5 ln(r) r / dr with the reference's orbit (raymarching.rs:188-241):
    starts at the origin, adds p each iteration, bails at |v|^2 > 8.

    Trig-free power-8 step: the reference computes sin/cos of 8*arctan2
    (raymarching.rs:214-226); for integer power 8 these are exactly three
    double-angle steps from cos(theta) = z/r, sin(theta) = rho/r (and
    likewise for phi), and r^8 / r^7 are repeated squarings — replacing 2
    arctan2 + 3 trig + 2 pow per iteration (each a multi-op polynomial
    expansion in elementwise arithmetic) with ~20 mul/add. distance_est_trig below is the
    literal formula, kept as the equivalence oracle for tests.

    The iteration loop exits as soon as EVERY lane in the batch has escaped
    (points far from the set bail in 2-4 iterations; only points near/inside
    the set run all of them) — with the blocked march below, batches are
    1024-lane blocks, so the exit is usually early."""
    x = jnp.zeros_like(p.x)
    y = jnp.zeros_like(p.x)
    z = jnp.zeros_like(p.x)
    r = jnp.zeros_like(p.x)
    dr = jnp.zeros_like(p.x)
    escaped = jnp.zeros(jnp.shape(p.x), bool)
    tiny = 1e-30

    def body(state):
        x, y, z, r, dr, escaped, i = state
        rho2 = x * x + y * y
        r2 = rho2 + z * z
        r_new = jnp.sqrt(r2)
        rho = jnp.sqrt(rho2)
        inv_r = 1.0 / jnp.maximum(r_new, tiny)
        inv_rho = 1.0 / jnp.maximum(rho, tiny)
        # when rho (or r) is 0 the angles are irrelevant (rp factor is 0 or
        # sin(theta)=0); arctan2's conventional 0 maps to cos=1, sin=0
        ct = jnp.where(r_new > tiny, z * inv_r, 1.0)
        st = jnp.where(r_new > tiny, rho * inv_r, 0.0)
        cp = jnp.where(rho > tiny, x * inv_rho, 1.0)
        sp = jnp.where(rho > tiny, y * inv_rho, 0.0)
        for _i in range(3):  # (c, s) -> (cos 2a, sin 2a), 3x => 8a
            ct, st = ct * ct - st * st, 2.0 * ct * st
            cp, sp = cp * cp - sp * sp, 2.0 * cp * sp
        r4 = r2 * r2
        rp = r4 * r4                                  # r^8
        dr_new = (r4 * r2 * r_new) * POWER * dr + 1.0  # r^7 * 8 * dr + 1
        xn = rp * st * cp + p.x
        yn = rp * st * sp + p.y
        zn = rp * ct + p.z
        esc_now = xn * xn + yn * yn + zn * zn > BAILOUT
        keep = ~escaped
        return (
            jnp.where(keep, xn, x), jnp.where(keep, yn, y), jnp.where(keep, zn, z),
            jnp.where(keep, rp, r), jnp.where(keep, dr_new, dr),
            escaped | esc_now, i + 1,
        )

    x, y, z, r, dr, escaped, _ = jax.lax.while_loop(
        lambda s: (s[6] < iterations) & jnp.any(~s[5]), body,
        (x, y, z, r, dr, escaped, jnp.asarray(0, jnp.int32)),
    )
    r = jnp.maximum(r, 1e-12)
    dr = jnp.maximum(dr, 1e-12)
    de = 0.5 * jnp.log(r) * r / dr
    de = jnp.where(jnp.isnan(de), 0.1, de)  # NaN guard (raymarching.rs:131-133)
    return de, ~escaped  # (distance estimate, inside-set flag)


def distance_est_trig(p: Vec3, iterations: int = DE_ITERATIONS):
    """Literal transcription of the reference's DE (raymarching.rs:188-241);
    the equivalence oracle for the trig-free distance_est above."""
    x = jnp.zeros_like(p.x)
    y = jnp.zeros_like(p.x)
    z = jnp.zeros_like(p.x)
    r = jnp.zeros_like(p.x)
    dr = jnp.zeros_like(p.x)
    escaped = jnp.zeros(jnp.shape(p.x), bool)

    def body(_, state):
        x, y, z, r, dr, escaped = state
        r_new = jnp.sqrt(x * x + y * y + z * z)
        theta = jnp.arctan2(jnp.sqrt(x * x + y * y), z) * POWER
        phi = jnp.arctan2(y, x) * POWER
        rp = jnp.power(r_new, POWER)
        dr_new = jnp.power(r_new, POWER - 1.0) * POWER * dr + 1.0
        st = jnp.sin(theta)
        xn = rp * st * jnp.cos(phi) + p.x
        yn = rp * st * jnp.sin(phi) + p.y
        zn = rp * jnp.cos(theta) + p.z
        esc_now = xn * xn + yn * yn + zn * zn > BAILOUT
        keep = ~escaped
        return (
            jnp.where(keep, xn, x), jnp.where(keep, yn, y), jnp.where(keep, zn, z),
            jnp.where(keep, rp, r), jnp.where(keep, dr_new, dr),
            escaped | esc_now,
        )

    x, y, z, r, dr, escaped = jax.lax.fori_loop(
        0, iterations, body, (x, y, z, r, dr, escaped)
    )
    r = jnp.maximum(r, 1e-12)
    dr = jnp.maximum(dr, 1e-12)
    de = 0.5 * jnp.log(r) * r / dr
    de = jnp.where(jnp.isnan(de), 0.1, de)
    return de, ~escaped


# Rays per march block (lane-compaction granularity). The per-block
# lax.scan serializes the blocks, so a block must be wide enough to fill
# the device on its own while still letting all-miss/all-dead blocks skip;
# env knob for perf probes.
import os as _os

BLOCK = int(_os.environ.get("RAYSNAIL_BULB_BLOCK", str(32 * 1024)))


def _march_steps(o: Vec3, d: Vec3, t0, t_exit, done0, hit0, max_steps):
    """Sphere-trace one block for up to max_steps; no normal evaluation.
    Returns (t, done, hit_mask); exits as soon as every lane is done."""
    def body(state):
        t, done, hit_mask, i = state
        p = o + d * t
        de, _ = distance_est(p)
        hit_now = (~done) & (de < SURF_EPS)
        overshoot = (~done) & (t > t_exit)
        t_next = jnp.where(done, t, t + jnp.maximum(de * STEP_SCALE, 1e-5))
        done_next = done | hit_now | overshoot
        return t_next, done_next, hit_mask | hit_now, i + 1

    t, done, hit_mask, _ = jax.lax.while_loop(
        lambda s: (s[3] < max_steps) & jnp.any(~s[1]), body,
        (t0, done0, hit0, jnp.asarray(0, jnp.int32)),
    )
    return t, done, hit_mask


def _march_block(o: Vec3, d: Vec3, t0, t_exit, done0,
                 hit0=None, max_steps: int = MAX_STEPS,
                 normals: bool = True):
    """Sphere-trace one block; returns (t, done, hit_mask, normal, uv)."""
    if hit0 is None:
        hit0 = jnp.zeros(jnp.shape(t0), bool)
    t, done, hit_mask = _march_steps(o, d, t0, t_exit, done0, hit0, max_steps)
    if not normals:
        z = jnp.zeros_like(t)
        return t, done, hit_mask, z, z, jnp.ones_like(t), z, z

    def finish(t):
        p = o + d * t
        dd = 0.01
        ex = Vec3.full((dd, 0.0, 0.0), (), t.dtype)
        ey = Vec3.full((0.0, dd, 0.0), (), t.dtype)
        ez = Vec3.full((0.0, 0.0, dd), (), t.dtype)
        geom_n = Vec3(
            distance_est(p + ex)[0] - distance_est(p - ex)[0],
            distance_est(p + ey)[0] - distance_est(p - ey)[0],
            distance_est(p + ez)[0] - distance_est(p - ez)[0],
        ).unit()
        u, v = sphere_uv(p)
        return t, geom_n.x, geom_n.y, geom_n.z, u, v

    def no_hit(t):
        z = jnp.zeros_like(t)
        return t, z, z, jnp.ones_like(t), z, z

    # central-difference normals (6 more DE evals) only for blocks that hit
    t, nx, ny, nz, u, v = jax.lax.cond(jnp.any(hit_mask), finish, no_hit, t)
    return t, done, hit_mask, nx, ny, nz, u, v


class MandelbulbNode(NamedTuple):
    mat_id: int

    def hit(self, ray, t_min, t_max, active=None) -> Hit:
        """Blocked, lane-compacted sphere tracing. The ray batch arrives in
        image-tile order (render._tile_grid), so the bounding-sphere clip
        clusters spatially: the march runs per 1024-ray block under a
        lax.cond, and blocks whose rays all miss the bounding sphere (or are
        dead in the integrator) skip the march AND the normal evaluation
        entirely — the block-level form of the reference's per-ray early
        exits (raymarching.rs:108-160)."""
        o, d = ray.origin, ray.direction
        n = jnp.shape(d.x)[0]
        # clip to the bounding sphere at the origin (raymarching.rs:167-176)
        half_b = d.dot(o)
        c = o.length_squared() - RADIUS * RADIUS
        delta = half_b * half_b - c
        sq = jnp.sqrt(jnp.maximum(delta, 0.0))
        t_enter = jnp.maximum(-half_b - sq, t_min)
        t_exit = -half_b + sq
        in_bbox = (delta > 0.0) & (t_exit > t_min) & (t_enter < t_max)
        if active is not None:
            in_bbox = in_bbox & active

        t0 = jnp.where(in_bbox, t_enter, BIG)
        done0 = ~in_bbox

        block = BLOCK if n >= BLOCK else n
        pad = (-n) % block
        pads = lambda a, val: (jnp.pad(a, (0, pad), constant_values=val)
                               if pad else a)
        shape2 = (-1, block)

        def blocked_march(ox, oy, oz, dx, dy, dz, t0_, te_, dn_, h0_,
                          max_steps, normals):
            xs = tuple(a.reshape(shape2)
                       for a in (ox, oy, oz, dx, dy, dz, t0_, te_, dn_, h0_))

            def step(_, x):
                return None, _march_block(
                    Vec3(x[0], x[1], x[2]), Vec3(x[3], x[4], x[5]),
                    x[6], x[7], x[8], hit0=x[9], max_steps=max_steps,
                    normals=normals)

            _, out = jax.lax.scan(step, None, xs)
            return tuple(a.reshape(-1) for a in out)

        ox, oy, oz = (pads(a, 0.0) for a in (o.x, o.y, o.z))
        dx, dy, dz = (pads(a, 1.0) for a in (d.x, d.y, d.z))
        t0p = pads(t0, BIG)
        tep = pads(t_exit, 0.0)
        d0p = pads(done0, True)
        h0p = jnp.zeros_like(d0p)

        k1 = int(_os.environ.get("RAYSNAIL_BULB_K1", "16"))
        # compaction is OPT-IN (RAYSNAIL_BULB_COMPACT=1): the per-bounce
        # argsort + ~10 gathers compete with the straggler blocks they
        # compact away, and the GPU's verdict is not measured yet
        if k1 >= MAX_STEPS or _os.environ.get("RAYSNAIL_BULB_COMPACT") != "1":
            # single-phase path (the pre-r5 scheme; perf A/B)
            t, _, hit_mask, nx, ny, nz, u, v = blocked_march(
                ox, oy, oz, dx, dy, dz, t0p, tep, d0p, h0p,
                MAX_STEPS, True)
        else:
            # LANE-COMPACTED two-phase march (the reference's per-ray early
            # exits, raymarching.rs:108-160, reborn as static-shape
            # compaction): phase 1 marches k1 steps un-compacted — most
            # rays hit or overshoot within ~16 steps — then a stable sort
            # on done concentrates the stragglers (and the normal-needing
            # hitters) into a few dense blocks, so phase 2's per-block
            # early exits skip nearly everything. One argsort + ~10
            # gathers per bounce is noise next to a 128-step DE march.
            t1, done1, hit1, *_ = blocked_march(
                ox, oy, oz, dx, dy, dz, t0p, tep, d0p, h0p, k1, False)
            order = jnp.argsort(done1, stable=True)
            g = lambda a: jnp.take(a, order)
            t2, _, hit2, nx, ny, nz, u, v = blocked_march(
                g(ox), g(oy), g(oz), g(dx), g(dy), g(dz), g(t1), g(tep),
                g(done1), g(hit1), MAX_STEPS - k1, True)
            inv = jnp.zeros_like(order).at[order].set(
                jnp.arange(order.shape[0], dtype=order.dtype))
            s = lambda a: jnp.take(a, inv)
            t, hit_mask = s(t2), s(hit2)
            nx, ny, nz, u, v = s(nx), s(ny), s(nz), s(u), s(v)

        flat = lambda a: a[:n]
        t, hit_mask = flat(t), flat(hit_mask)
        geom_n = Vec3(flat(nx), flat(ny), flat(nz))
        u, v = flat(u), flat(v)

        valid = hit_mask & (t > t_min) & (t < t_max)
        t = jnp.where(valid, t, BIG)
        mid = jnp.full(jnp.shape(t), self.mat_id, jnp.int32)
        return hitlib.finalize(d, t, geom_n, u, v, mid, valid)
