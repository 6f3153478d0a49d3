"""L6 execution engine: the painter equivalent + multi-pass adaptive driver.

The reference's Painter owns pixel iteration, stratified sampling, row-
interleaved threading and streaming (src/painter.rs); its CLI wraps that in a
multi-pass adaptive-oversampling loop (src/bin/raysnail.rs:311-427). Here the
whole frame is a handful of device dispatches: each dispatch renders a chunk
of (pixel, stratification-cell) work with static shapes, and sample chunks
accumulate into an f32 radiance-sum framebuffer.

Adaptive passes: the reference computes a 5x5 noise metric and a redo map,
but its RedoController clones the map BEFORE the pass loop and never sees
updates (raysnail.rs:369-372 vs 405-424) — so the reference re-renders every
pixel each pass. We implement the evidently-intended behavior: later passes
re-render only pixels whose noise exceeds the threshold, with the active
pixel set COMPACTED host-side (padded to a power of two to bound retraces) so
sparse passes really are cheaper — the device-side form of the redo map.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from raysnail_tpu import integrator
from raysnail_tpu import scene as scenelib
from raysnail_tpu.camera import Camera, generate_rays
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.prelude import color as colorlib
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.prelude.vec import Vec3


def sample_sums(scene: scenelib.Scene, cfg: RenderConfig,
                arrays: scenelib.SceneArrays, camera: Camera, key,
                sample_ids, px, py) -> Vec3:
    """Radiance sums over the given stratification cells for the given flat
    pixel coordinates — the traceable core shared by the jitted single-chip
    step and the shard_map'd multi-chip step. Returns a (P,) Vec3.

    sample_ids must be a CONTIGUOUS ascending range (every caller builds it
    with arange): the path-regeneration integrator consumes it as
    [ids[0], ids[0] + len)."""
    w, h = cfg.width, cfg.height
    sqrt_spp = cfg.sqrt_spp
    pixel_ids = (py.astype(jnp.int32) * w + px.astype(jnp.int32))

    backend = cfg.rng
    if backend == "auto":
        # fast everywhere: the fmix32 counter hash is cheaper than threefry
        # and the path-regeneration integrators need it
        backend = "fast"

    if backend == "fast":
        # per-ray streams from (seed, pixel), folding sample/bounce per lane
        # — the per-LANE sample fold is what lets the regeneration integrator
        # advance each lane's sample counter independently
        keys0 = prng.fast_streams(key, pixel_ids)
        if cfg.path_regen != "never":
            sums, _ = integrator.radiance_regen(
                scene, arrays, cfg, camera, px, py, keys0,
                sample_ids[0], int(sample_ids.shape[0]))
            return sums

    def one_sample(sid):
        s_i = (sid % sqrt_spp).astype(cfg.dtype)
        s_j = (sid // sqrt_spp).astype(cfg.dtype)
        if backend == "fast":
            keys = prng.fold_all(keys0, sid)
        else:
            # threefry: per-ray keys from (seed, sample_id, pixel_id)
            keys = prng.per_ray_keys(jax.random.fold_in(key, sid), pixel_ids)
        ray = generate_rays(
            camera, px, py,
            jnp.full_like(px, s_i), jnp.full_like(py, s_j),
            sqrt_spp, w, h, keys,
        )
        return integrator.radiance(scene, arrays, cfg, ray, keys)

    # accumulate IN the scan carry (not lax.map + stack + sum): memory per
    # dispatch is O(P) regardless of how many samples it covers, which is
    # what lets a whole 64-spp frame ride one dispatch
    def accumulate(acc, sid):
        return acc + one_sample(sid), None

    init = Vec3.zeros(jnp.shape(pixel_ids), cfg.dtype)
    sums, _ = jax.lax.scan(accumulate, init, sample_ids)
    return sums


def make_sample_step(scene: scenelib.Scene, cfg: RenderConfig):
    """Jitted single-device render step:
    step(arrays, camera, key, sample_ids, px, py) -> (P,) Vec3 sums."""

    @jax.jit
    def step(arrays: scenelib.SceneArrays, camera: Camera, key, sample_ids, px, py):
        return sample_sums(scene, cfg, arrays, camera, key, sample_ids, px, py)

    return step


def make_frame_step(scene: scenelib.Scene, cfg: RenderConfig):
    """Jitted FULL-FRAME step through the shuffled path-regeneration
    integrator: step(arrays, camera, key) -> (W*H,) Vec3 radiance sums in
    ROW-MAJOR pixel order (all effective spp in one dispatch). Returns None
    when the shuffle path doesn't apply (threefry RNG or regen disabled) —
    callers fall back to the sample-step path."""
    backend = "fast" if cfg.rng == "auto" else cfg.rng
    if backend != "fast" or cfg.path_regen == "never":
        return None
    if scene.mandelbulbs:
        # the distance-field march skips all-miss 32k-lane BLOCKS
        # (geometry/mandelbulb.py) — that needs spatially clustered lanes,
        # which the cross-pixel shuffle destroys.
        # The sample-step path keeps lane = pixel in image-tile order and
        # still runs plain per-pixel regeneration.
        return None

    @jax.jit
    def step(arrays: scenelib.SceneArrays, camera: Camera, key):
        sums, _ = integrator.radiance_regen_shuffle(
            scene, arrays, cfg, camera, key, cfg.effective_samples)
        return sums

    return step


def _full_grid(cfg: RenderConfig):
    py, px = np.meshgrid(np.arange(cfg.height), np.arange(cfg.width), indexing="ij")
    return px.ravel().astype(np.float32), py.ravel().astype(np.float32)


TILE_W, TILE_H = 16, 8  # 16x8 = 128 pixels = one mesh-kernel block


def _tile_key(px, py, width: int):
    """Spatial sort key: 16x8 image tiles in row-major tile order, row-major
    within the tile. 128 consecutive rays = one compact-frustum block for
    the mesh kernel (ops/mesh_kernel.py) instead of a 3-image-row strip."""
    x = np.asarray(px, np.int64)
    y = np.asarray(py, np.int64)
    tiles_x = -(-width // TILE_W)
    return (((y // TILE_H) * tiles_x + x // TILE_W) * TILE_H
            + (y % TILE_H)) * TILE_W + (x % TILE_W)


def _tile_grid(cfg: RenderConfig):
    """-> (px, py, inv): the full pixel list in tile-major order plus the
    inverse permutation back to row-major image order."""
    px, py = _full_grid(cfg)
    order = np.argsort(_tile_key(px, py, cfg.width), kind="stable")
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    return px[order], py[order], inv


def _sample_chunks(cfg: RenderConfig, n_pix: int, multiple_of: int = 1,
                   budget: Optional[int] = None):
    """Chunk size k dividing spp so every dispatch shares one trace.
    `multiple_of` constrains k to multiples of the mesh's sample axis so a
    sharded step always gets evenly-shardable cell batches. `budget`
    overrides cfg.ray_batch (streaming/checkpointing callers cap it so they
    still get progress between dispatches)."""
    spp = cfg.effective_samples
    budget = cfg.ray_batch if budget is None else budget
    k_max = max(1, min(spp, budget // max(n_pix, 1)))
    good = [d for d in range(1, k_max + 1)
            if spp % d == 0 and d % multiple_of == 0]
    return max(good) if good else multiple_of


def render_sums(scene, camera, cfg, seed, px, py, step=None,
                arrays=None, key=None, k_multiple: int = 1) -> Vec3:
    """Radiance SUMS over all effective samples for the given pixel list."""
    spp = cfg.effective_samples
    if k_multiple > 1:
        assert spp % k_multiple == 0, (
            f"effective spp {spp} must divide by the sample-axis size "
            f"{k_multiple} for a sharded step")
    step = step or make_sample_step(scene, cfg)
    arrays = arrays if arrays is not None else scene.arrays
    key = key if key is not None else prng.key(seed)
    px = jnp.asarray(px, cfg.dtype)
    py = jnp.asarray(py, cfg.dtype)

    k = _sample_chunks(cfg, px.shape[0], k_multiple)
    accum = None
    for start in range(0, spp, k):
        ids = jnp.arange(start, start + k, dtype=jnp.int32)
        sums = step(arrays, camera, key, ids, px, py)
        accum = sums if accum is None else accum + sums
    return accum


def render(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
           seed: int = 0, arrays=None) -> np.ndarray:
    """Single-pass full frame -> (H, W, 3) float32 display image."""
    frame = make_frame_step(scene, cfg)
    if frame is not None:
        accum = frame(arrays if arrays is not None else scene.arrays,
                      camera, prng.key(seed))
        img = colorlib.into_color(accum, float(cfg.effective_samples), cfg.gamma)
        return np.asarray(img.to_array()).reshape(cfg.height, cfg.width, 3)
    px, py, inv = _tile_grid(cfg)
    accum = render_sums(scene, camera, cfg, seed, px, py, arrays=arrays)
    img = colorlib.into_color(accum, float(cfg.effective_samples), cfg.gamma)
    return np.asarray(img.to_array())[inv].reshape(cfg.height, cfg.width, 3)


# -- multi-pass adaptive oversampling ---------------------------------------

def calc_noise(img: np.ndarray, compat_bug: bool = False) -> np.ndarray:
    """Per-pixel noise: sum over the 5x5 neighborhood of squared RGB distance
    to the center (raysnail.rs:138-173). Out-of-bounds neighbors count 0.
    compat_bug=True replicates `let x = y` (raysnail.rs:163), which makes the
    window columns track the row index."""
    h, w, _ = img.shape
    noise = np.zeros((h, w), np.float32)
    if not compat_bug:
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                shifted = np.zeros_like(img)
                ys = slice(max(0, dy), h + min(0, dy))
                yd = slice(max(0, -dy), h + min(0, -dy))
                xs = slice(max(0, dx), w + min(0, dx))
                xd = slice(max(0, -dx), w + min(0, -dx))
                shifted[yd, xd] = img[ys, xs]
                # out-of-bounds -> same as center -> zero diff
                mask = np.zeros((h, w, 1), np.float32)
                mask[yd, xd] = 1.0
                diff = (img - shifted) * mask
                noise += np.sum(diff * diff, axis=-1)
    else:
        ys, xs = np.mgrid[0:h, 0:w]
        for dy in range(-2, 3):
            for dx in range(-2, 3):
                yy = ys + dy
                xx = ys + dx  # the reference's x = y bug
                inb = (yy >= 0) & (yy < h) & (xx >= 0) & (xx < w)
                nb = img[np.clip(yy, 0, h - 1), np.clip(xx, 0, w - 1)]
                diff = np.where(inb[..., None], img - nb, 0.0)
                noise += np.sum(diff * diff, axis=-1)
    return noise


def render_passes(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                  seed: int = 0, arrays=None,
                  progress: Optional[Callable] = None,
                  step=None, k_multiple: int = 1,
                  frame_step=None) -> np.ndarray:
    """Multi-pass render with adaptive oversampling (raysnail.rs:379-427):
    pass k re-renders flagged pixels and running-averages display colors
    (old*k + new)/(k+1).

    `step` may be a sharded sample step (parallel.make_padded_sharded_step)
    with `k_multiple` = the mesh's sample-axis size, so adaptive passes run
    on the device mesh too; `frame_step` likewise overrides the full first
    pass (parallel.make_sharded_frame_step keeps it on the REGEN path)."""
    spp = cfg.effective_samples
    frame = frame_step if frame_step is not None else (
        make_frame_step(scene, cfg)
        if step is None and k_multiple == 1 else None)
    step = step or make_sample_step(scene, cfg)
    px_full, py_full = _full_grid(cfg)
    px_t, py_t, inv = _tile_grid(cfg)
    h, w = cfg.height, cfg.width

    if frame is not None:
        # full first pass through the shuffled-regeneration frame step
        # (row-major output); sparse later passes use the sample step
        accum = frame(arrays if arrays is not None else scene.arrays,
                      camera, prng.key(seed))
        img = np.array(
            colorlib.into_color(accum, float(spp), cfg.gamma).to_array()
        ).reshape(h, w, 3)
    else:
        accum = render_sums(scene, camera, cfg, seed, px_t, py_t, step=step,
                            arrays=arrays, k_multiple=k_multiple)
        img = np.array(
            colorlib.into_color(accum, float(spp), cfg.gamma).to_array()
        )[inv].reshape(h, w, 3)
    if progress is not None and progress(spp, spp * cfg.passes, img) is False:
        return img  # cancelled (the Quit the reference never polled)

    for k in range(1, cfg.passes):
        redo = calc_noise(img, cfg.compat_noise_bug) >= cfg.noise_threshold
        n_active = int(redo.sum())
        if n_active == 0:
            break
        idx = np.flatnonzero(redo.ravel())
        # tile-coherent dispatch order for the sparse active set too
        idx = idx[np.argsort(_tile_key(px_full[idx], py_full[idx], w),
                             kind="stable")]
        # pad the active set to one of a FEW fixed buckets (full, full/4,
        # full/16, ...): every distinct shape is a separate XLA program to
        # compile — wasted lanes are far cheaper
        bucket = h * w
        while bucket // 4 >= max(n_active, 1024):
            bucket //= 4
        padded = min(bucket, h * w)
        idx_p = np.pad(idx, (0, padded - n_active), mode="edge")
        px = px_full[idx_p]
        py = py_full[idx_p]

        sums = render_sums(scene, camera, cfg, seed + k, px, py, step=step,
                           arrays=arrays, k_multiple=k_multiple)
        new_img = np.asarray(
            colorlib.into_color(sums, float(spp), cfg.gamma).to_array()
        )[:n_active]
        flat = img.reshape(-1, 3)
        flat[idx] = (flat[idx] * k + new_img) / (k + 1.0)
        img = flat.reshape(h, w, 3)
        if progress is not None and progress(spp * (k + 1), spp * cfg.passes,
                                             img) is False:
            break
    return img
