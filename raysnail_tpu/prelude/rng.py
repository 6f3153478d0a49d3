"""Counter-based RNG for the path tracer.

The reference uses per-thread XorShift RNGs seeded from the OS
(src/prelude/random.rs:116-127), so its renders are not reproducible. Here we
use JAX's counter-based threefry keys derived deterministically from
(pass, tile, bounce, purpose), which makes renders reproducible and
shard-invariant enough for testing, and keeps every draw a pure function —
required for jit/grad and for sharding the ray batch across a device mesh.

Convention: one base key per render pass; every RAY owns a key derived by
folding in its (pixel_id, sample_id), and per-bounce/purpose sub-keys fold in
further tags. Because draws are keyed by ray identity rather than position in
the batch, renders are INVARIANT to batch tiling and mesh sharding — the same
(seed, pixel, sample) always sees the same stream on 1 chip or N.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# purpose tags (folded into keys so draws for different uses are independent)
RAYGEN = 1
LENS = 2
TIME = 3
SCATTER = 4
LIGHT = 5
MEDIUM = 6
MIX = 7
BRANCH = 8


def key(seed: int) -> jax.Array:
    return jax.random.PRNGKey(seed)


def fold(k: jax.Array, *tags: int) -> jax.Array:
    for t in tags:
        k = jax.random.fold_in(k, t)
    return k


def uniform(k: jax.Array, shape=(), dtype=jnp.float32) -> jax.Array:
    """U[0,1) of the given shape."""
    return jax.random.uniform(k, shape, dtype)


def uniforms(k: jax.Array, n: int, shape=(), dtype=jnp.float32):
    """n independent U[0,1) arrays of the given shape (single threefry sweep)."""
    u = jax.random.uniform(k, (n,) + tuple(shape), dtype)
    return tuple(u[i] for i in range(n))


# -- per-ray counter-based keys --------------------------------------------
#
# Two interchangeable backends, dispatched on the key representation:
#   * "threefry": per-ray jax.random keys, shape (N, 2) — crypto-grade,
#     ~10x more arithmetic per draw;
#   * "fast" (default): a (N,) uint32 stream hashed with the murmur3 fmix32
#     avalanche finalizer over golden-ratio-separated counters — the classic
#     GPU-renderer construction; passes the moment/correlation tests and
#     keeps the identical keying semantics (seed, sample, pixel, bounce,
#     purpose, slot), so renders stay shard/tile-invariant.

# 2^32 / golden ratio. A NUMPY scalar, very deliberately: a module-level
# jnp.uint32 is created ON the default device at import and closed over by
# every traced function — at lowering, jax inlines it as an MLIR constant
# via a blocking device fetch.
_PHI = np.uint32(0x9E3779B9)


def _fmix32(x):
    """murmur3 finalizer: full avalanche on uint32."""
    x = jnp.asarray(x, jnp.uint32)
    x = x ^ (x >> 16)
    x = x * jnp.uint32(0x85EBCA6B)
    x = x ^ (x >> 13)
    x = x * jnp.uint32(0xC2B2AE35)
    x = x ^ (x >> 16)
    return x


def per_ray_keys(k: jax.Array, ids) -> jax.Array:
    """Threefry backend: one jax.random key per ray."""
    return jax.vmap(lambda i: jax.random.fold_in(k, i))(jnp.asarray(ids, jnp.uint32))


def fast_streams(k: jax.Array, ids) -> jax.Array:
    """Fast backend: (N,) uint32 streams from a base key + ray identities.
    The base key is digested once with threefry (cheap, per dispatch)."""
    k_arr = jnp.asarray(k)
    seed = k_arr.ravel() if k_arr.dtype == jnp.uint32 else jax.random.key_data(k).ravel()
    base = jnp.asarray(seed[0], jnp.uint32) ^ (jnp.asarray(seed[-1], jnp.uint32) * _PHI)
    return _fmix32(base ^ (jnp.asarray(ids, jnp.uint32) * _PHI))


def fold_all(keys: jax.Array, tag) -> jax.Array:
    """Fold a (possibly traced) integer tag into a batch of per-ray keys."""
    if keys.ndim == 1:  # fast backend
        t = jnp.asarray(tag, jnp.uint32)
        return _fmix32(keys ^ (t * _PHI + jnp.uint32(0x7F4A7C15)))
    return jax.vmap(lambda k: jax.random.fold_in(k, tag))(keys)


def ray_uniforms(keys: jax.Array, n: int, dtype=jnp.float32):
    """n U[0,1) draws per ray -> tuple of n (N,) arrays."""
    if keys.ndim == 1:  # fast backend: one finalize per slot
        out = []
        for i in range(n):
            h = _fmix32(keys + jnp.uint32(i) * jnp.uint32(0x632BE5AB))
            out.append((h >> 8).astype(dtype) * dtype(1.0 / (1 << 24)))
        return tuple(out)
    u = jax.vmap(lambda k: jax.random.uniform(k, (n,), dtype))(keys)
    return tuple(u[:, i] for i in range(n))
