"""L1 texture table: batched texture evaluation (reference: src/texture/).

Textures live in one SoA table; evaluation computes every *mode present in
the scene* (static knowledge from scene compile) for the whole ray batch and
where-selects by the per-ray texture id. Modes:

  CONSTANT  solid color (color.rs:61-65)
  CHECKER   3-D sign of sin(s x) sin(s y) sin(s z) (checker.rs:22-29)
  IMAGE     nearest-neighbor uv lookup, v flipped, edge clamp (image.rs:36-49)
  PERLIN    lattice noise, Hermitian-cubic smoothing, float or gradient-vector
            lattice, plain / turbulence / marble (noise.rs)
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from raysnail_tpu.prelude.vec import Vec3

CONSTANT = 0
CHECKER = 1
IMAGE = 2
PERLIN = 3
PERLIN_TURB = 4
PERLIN_MARBLE = 5
# pseudo-mode (never a row ttype): present in the scene's static mode set
# when some checker has non-constant children, enabling the second-level
# child-texture evaluation (the reference's Checker<T1, T2> is generic over
# Texture, checker.rs:8-28)
CHECKER_DEEP = 6

PERLIN_POINTS = 256


class TextureTable(NamedTuple):
    ttype: jax.Array      # (T,) int32
    color1: Vec3          # (T,) constant color / checker odd
    color2: Vec3          # (T,) checker even
    scale: jax.Array      # (T,) checker/perlin scale
    image_id: jax.Array   # (T,) int32 index into atlas, -1 if none
    depth: jax.Array      # (T,) int32 turbulence depth
    child1: jax.Array | None = None  # (T,) int32 checker odd-child row, -1
    child2: jax.Array | None = None  # (T,) int32 checker even-child row, -1
    # image atlas (None when the scene has no image textures)
    atlas: jax.Array | None = None       # (I, maxH, maxW, 3) float32
    atlas_wh: jax.Array | None = None    # (I, 2) int32 (width, height)
    # perlin lattice (None when the scene has no perlin textures). The
    # lattice is HASH-based: no float/vec/perm tables — the reference's
    # perm_x[i]^perm_y[j]^perm_z[k] table walk (noise.rs:85-95) is 44
    # per-lane dynamic gathers per evaluation (scripts/ablate_book2.py
    # times the texture's share of the frame). An fmix32 avalanche hash of the lattice point reproduces the same
    # value DISTRIBUTIONS (floats uniform [0,1), gradients uniform on the
    # sphere) in pure elementwise arithmetic. Deviation documented in PARITY.md
    # (the reference's field is thread-rng seeded and unreplayable anyway).
    perlin_id: jax.Array | None = None      # (T,) int32 row into tables, -1
    perlin_seed: jax.Array | None = None    # (P,) uint32 lattice seed
    perlin_is_vec: jax.Array | None = None  # (P,) bool
    perlin_smooth: jax.Array | None = None  # (P,) int32: 0 none/1 linear/2 hermitian


def _checker_sign(table, tid, p: Vec3):
    """True on odd cells: sin(s x) sin(s y) sin(s z) < 0 (checker.rs:22-29)."""
    s = _take(table.scale, tid)
    return jnp.sin(s * p.x) * jnp.sin(s * p.y) * jnp.sin(s * p.z) < 0.0


def _take(a, tid):
    """Per-ray small-table fetch (hit.take_table)."""
    from raysnail_tpu.geometry import hit as hitlib

    return hitlib.take_table(a, tid)


def _gather_color(c: Vec3, tid) -> Vec3:
    return Vec3(_take(c.x, tid), _take(c.y, tid), _take(c.z, tid))


def _image(table, tid, u, v) -> Vec3:
    img_id = jnp.maximum(table.image_id[tid], 0)
    w = table.atlas_wh[img_id, 0]
    h = table.atlas_wh[img_id, 1]
    vv = 1.0 - v
    px = jnp.clip((u * w).astype(jnp.int32), 0, w - 1)
    py = jnp.clip((vv * h).astype(jnp.int32), 0, h - 1)
    rgb = table.atlas[img_id, py, px]  # (N, 3)
    return Vec3(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def _lattice_corner(seed, xi, yi, zi):
    """(fval, gx, gy, gz) for one lattice point from an fmix32 avalanche
    hash — fval uniform [0,1), g uniform on the unit sphere (the same
    distributions _perlin_tables drew from its seeded host RNG; the
    reference draws from its thread rng, noise.rs:41-70 / vec3.rs:91-96).
    Pure register arithmetic: no tables, nothing for XLA to serialize."""
    from raysnail_tpu.prelude.rng import _fmix32

    h = jnp.asarray(xi, jnp.uint32) * jnp.uint32(0x8DA6B343)
    h = h ^ (jnp.asarray(yi, jnp.uint32) * jnp.uint32(0xD8163841))
    h = h ^ (jnp.asarray(zi, jnp.uint32) * jnp.uint32(0xCB1AB31F))
    h = _fmix32(h ^ seed)
    h2 = _fmix32(h ^ jnp.uint32(0x68BC21EB))
    h3 = _fmix32(h2 ^ jnp.uint32(0x02E5BE93))
    to_u = lambda x: (x >> jnp.uint32(8)).astype(jnp.float32) * (1.0 / 16777216.0)
    u1, u2, fval = to_u(h), to_u(h2), to_u(h3)
    # random_unit construction (vec3.rs:91-96): azimuth + uniform z
    a = (2.0 * np.pi) * u1
    z = 2.0 * u2 - 1.0
    rad = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return fval, rad * jnp.cos(a), rad * jnp.sin(a), z


def _perlin_noise(table, pid, p: Vec3):
    """Lattice noise with the reference's three smoothing modes
    (noise.rs:97-137, 156-189), vectorized with the 8 corners unrolled.
    smooth codes: 0=none (nearest lattice point at 4x scale), 1=linear,
    2=hermitian cubic. Lattice values come from _lattice_corner's hash
    (see TextureTable)."""
    smooth = table.perlin_smooth[pid]
    seed = table.perlin_seed[pid]

    i = jnp.floor(p.x).astype(jnp.int32)
    j = jnp.floor(p.y).astype(jnp.int32)
    k = jnp.floor(p.z).astype(jnp.int32)
    u = p.x - i
    v = p.y - j
    w = p.z - k
    hermite = smooth == 2
    uu = jnp.where(hermite, u * u * (3.0 - 2.0 * u), u)
    vv = jnp.where(hermite, v * v * (3.0 - 2.0 * v), v)
    ww = jnp.where(hermite, w * w * (3.0 - 2.0 * w), w)

    is_vec = table.perlin_is_vec[pid]
    total = jnp.zeros_like(u)
    for di in range(2):
        for dj in range(2):
            for dk in range(2):
                fval, gx, gy, gz = _lattice_corner(seed, i + di, j + dj,
                                                   k + dk)
                weight_v = (
                    gx * (u - di) + gy * (v - dj) + gz * (w - dk)
                )
                corner = jnp.where(is_vec, weight_v, fval)
                wgt = (
                    (di * uu + (1 - di) * (1.0 - uu))
                    * (dj * vv + (1 - dj) * (1.0 - vv))
                    * (dk * ww + (1 - dk) * (1.0 - ww))
                )
                total = total + wgt * corner

    # SmoothType::None (noise.rs:99-110): nearest lattice point at 4x scale
    ni = (4.0 * p.x).astype(jnp.int32)
    nj = (4.0 * p.y).astype(jnp.int32)
    nk = (4.0 * p.z).astype(jnp.int32)
    nf, ngx, _, _ = _lattice_corner(seed, ni, nj, nk)
    # Vector branch returns v.x (noise.rs:104-108)
    none_val = jnp.where(table.perlin_is_vec[pid], ngx, nf)
    return jnp.where(smooth == 0, none_val, total)


def _turbulence(table, pid, p: Vec3, max_depth: int, depth):
    """noise.rs:139-153 with a static unroll to the scene's max depth."""
    acc = jnp.zeros_like(p.x)
    weight = jnp.ones_like(p.x)
    q = p
    for d in range(max_depth):
        live = d < depth
        acc = acc + jnp.where(live, weight * _perlin_noise(table, pid, q), 0.0)
        weight = weight * 0.5
        q = q * 2.0
    return jnp.abs(acc)


def _eval_base(table: TextureTable, tid, u, v, p: Vec3, modes: frozenset) -> Vec3:
    """Evaluate every non-checker mode for row `tid` and select by ttype."""
    out = _gather_color(table.color1, tid)  # CONSTANT is the base case
    tt = _take(table.ttype, tid)

    if IMAGE in modes:
        out = Vec3.where(tt == IMAGE, _image(table, tid, u, v), out)
    if modes & {PERLIN, PERLIN_TURB, PERLIN_MARBLE}:
        pid = jnp.maximum(table.perlin_id[tid], 0)
        if PERLIN in modes:
            n = _perlin_noise(table, pid, p * table.scale[tid])
            # vector lattice remaps to [0,1] (noise.rs:193-199)
            n = jnp.where(table.perlin_is_vec[pid], 0.5 * (n + 1.0), n)
            out = Vec3.where(tt == PERLIN, Vec3(n, n, n), out)
        max_depth = 7
        if PERLIN_TURB in modes:
            n = _turbulence(table, pid, p, max_depth, table.depth[tid])
            out = Vec3.where(tt == PERLIN_TURB, Vec3(n, n, n), out)
        if PERLIN_MARBLE in modes:
            n = _turbulence(table, pid, p, max_depth, table.depth[tid])
            m = (jnp.sin(table.scale[tid] * p.z + 10.0 * n) + 1.0) * 0.5
            out = Vec3.where(tt == PERLIN_MARBLE, Vec3(m, m, m), out)
    return out


def evaluate(table: TextureTable, tex_id, u, v, p: Vec3, modes: frozenset) -> Vec3:
    """Color of texture `tex_id` (per-ray int32) at (u, v, p).

    `modes` is the static set of texture types present in the scene; absent
    modes are not computed at all. CHECKER_DEEP in `modes` means some checker
    has non-constant children (possibly other checkers, matching the
    reference's fully generic Checker<T1, T2>, checker.rs:8-28): evaluation
    then DESCENDS the checker tree — each level re-derives the cell sign
    with that row's own scale and follows child1/child2 — for the scene's
    static max nesting depth (the ("checker_depth", d) entry in modes),
    landing on a non-checker row evaluated by the shared base pass."""
    tid = jnp.maximum(tex_id, 0)
    out = _eval_base(table, tid, u, v, p, modes)

    if CHECKER in modes:
        tt = _take(table.ttype, tid)
        if CHECKER_DEEP in modes:
            depth = next(m[1] for m in modes
                         if isinstance(m, tuple) and m[0] == "checker_depth")
            leaf = tid
            for _ in range(max(depth, 1)):
                is_ck = _take(table.ttype, leaf) == CHECKER
                odd = _checker_sign(table, leaf, p)
                c1 = jnp.maximum(_take(table.child1, leaf), 0)
                c2 = jnp.maximum(_take(table.child2, leaf), 0)
                leaf = jnp.where(is_ck, jnp.where(odd, c1, c2), leaf)
            cval = _eval_base(table, leaf, u, v, p, modes)
        else:
            odd = _checker_sign(table, tid, p)
            cval = Vec3.where(odd, _gather_color(table.color1, tid),
                              _gather_color(table.color2, tid))
        out = Vec3.where(tt == CHECKER, cval, out)
    return out
