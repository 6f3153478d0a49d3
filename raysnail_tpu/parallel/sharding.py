"""Sharded render and train steps over a ("tile", "sample") mesh.

Design (idiomatic JAX: shard_map + explicit collectives, which XLA hands to
NCCL over the cards' NVLink):
  * scene arrays / camera / params are REPLICATED (small);
  * the flat pixel list is sharded over "tile";
  * stratification cells are sharded over "sample"; each device renders its
    (pixel-shard x cell-shard) block and partial radiance sums are combined
    with a psum over "sample";
  * the train step computes the global L2 loss (psum over both axes inside
    the differentiated function) and all-reduces parameter gradients with a
    psum over the whole mesh — the renderer's DP gradient sync.

This file is the device-mesh replacement for the reference's entire
threading story (std::thread::scope row interleave + mpsc streaming,
painter.rs:239-302).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

from raysnail_tpu import scene as scenelib
from raysnail_tpu.camera import Camera
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.diff.params import inject_params
from raysnail_tpu.prelude import color as colorlib
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.prelude.vec import Vec3
from raysnail_tpu.render import _tile_grid, sample_sums

from jax import shard_map


def _psum_tree(tree, axis):
    return jax.tree_util.tree_map(lambda a: jax.lax.psum(a, axis), tree)


def make_sharded_sample_step(scene: scenelib.Scene, cfg: RenderConfig, mesh: Mesh):
    """step(arrays, camera, key, sample_ids, px, py) -> (P,) Vec3 full-sample
    sums, with pixels sharded over "tile" and cells over "sample"."""

    @jax.jit
    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P("sample"), P("tile"), P("tile")),
        out_specs=P("tile"),
        check_vma=False,
    )
    def step(arrays, camera, key, sample_ids, px, py):
        local = sample_sums(scene, cfg, arrays, camera, key, sample_ids, px, py)
        return _psum_tree(local, "sample")

    return step


def make_padded_sharded_step(scene: scenelib.Scene, cfg: RenderConfig,
                             mesh: Mesh):
    """A sharded sample step that accepts ANY pixel-list length by padding
    px/py up to a multiple of the tile axis and slicing the result back —
    drop-in for render.make_sample_step, so the adaptive multi-pass driver
    (render.render_passes) runs its sparse redo sets on the device mesh.
    Callers must pass k_multiple = mesh.shape["sample"] to render_passes so
    cell batches shard evenly."""
    inner = make_sharded_sample_step(scene, cfg, mesh)
    n_tile = mesh.shape["tile"]

    def step(arrays, camera, key, sample_ids, px, py):
        n = px.shape[0]
        pad = (-n) % n_tile
        if pad:
            px = jnp.concatenate([px, jnp.zeros(pad, px.dtype)])
            py = jnp.concatenate([py, jnp.zeros(pad, py.dtype)])
        sums = inner(arrays, camera, key, sample_ids, px, py)
        return sums.map(lambda a: a[:n]) if pad else sums

    return step


def make_sharded_frame_step(scene: scenelib.Scene, cfg: RenderConfig,
                            mesh: Mesh):
    """Sharded FULL-FRAME step through the shuffled path-REGENERATION
    integrator: step(arrays, camera, key) -> (W*H,) Vec3 row-major radiance
    sums over all effective spp. The stratification-cell range is split
    evenly over EVERY device in the mesh (both axes flattened): device i
    renders cells [i*k, (i+1)*k) for the whole frame, partial sums combine
    with one psum. Cell draws stay keyed by (seed, pixel, sample, bounce),
    so the result matches the single-device frame step modulo f32 summation
    order. Returns None when the regen shuffle path doesn't apply (mirrors
    render.make_frame_step) or spp doesn't divide by the device count."""
    from raysnail_tpu import integrator

    backend = "fast" if cfg.rng == "auto" else cfg.rng
    if backend != "fast" or cfg.path_regen == "never":
        return None
    axes = tuple(mesh.axis_names)
    n_dev = mesh.size
    spp = cfg.effective_samples
    if spp % n_dev:
        return None
    local_spp = spp // n_dev
    s0s = jnp.arange(n_dev, dtype=jnp.int32) * local_spp

    @jax.jit
    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P(), P(axes)),
        out_specs=P(),
        check_vma=False,
    )
    def step_inner(arrays, camera, key, s0):
        sums, _ = integrator.radiance_regen_shuffle(
            scene, arrays, cfg, camera, key, local_spp, s0=s0[0])
        return _psum_tree(sums, axes)

    def step(arrays, camera, key):
        return step_inner(arrays, camera, key, s0s)

    return step


def render_sharded(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                   mesh: Mesh, seed: int = 0, arrays=None):
    """Full-frame sharded render -> (H, W, 3) float32 display image.
    Pads pixels to a multiple of the tile axis and cells to a multiple of the
    sample axis (extra cells are separate RNG streams folded into the
    average, so padding adds samples rather than bias)."""
    import numpy as np

    arrays = arrays if arrays is not None else scene.arrays
    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    spp = cfg.effective_samples

    step = make_sharded_sample_step(scene, cfg, mesh)
    px, py, inv = _tile_grid(cfg)
    n_pix = px.shape[0]
    pad_pix = (-n_pix) % n_tile
    if pad_pix:
        px = np.concatenate([px, np.zeros(pad_pix, px.dtype)])
        py = np.concatenate([py, np.zeros(pad_pix, py.dtype)])

    # cells padded up to a multiple of the sample axis; total divides evenly
    total_cells = spp + ((-spp) % n_sample)
    ids = jnp.arange(total_cells, dtype=jnp.int32)
    key = prng.key(seed)
    sums = step(arrays, camera, key, ids,
                jnp.asarray(px, cfg.dtype), jnp.asarray(py, cfg.dtype))
    img = colorlib.into_color(sums, float(total_cells), cfg.gamma)
    flat = np.asarray(img.to_array())[:n_pix][inv]
    return flat.reshape(cfg.height, cfg.width, 3)


def make_sharded_train_step(scene: scenelib.Scene, camera: Camera,
                            cfg: RenderConfig, target, mesh: Mesh,
                            optimizer=None):
    """Sharded inverse-rendering step: forward + backward through the bounce
    loop on every device's (tile, sample) block, global L2 loss, gradient
    all-reduce (psum) over the whole mesh, optax update.

    -> (step, opt_state0, params0, static_inputs) where
       step(params, opt_state, key) -> (params, opt_state, loss)."""
    import numpy as np
    import optax

    from raysnail_tpu.diff.params import extract_params

    # gradients flow through the per-sample scan integrator (path_regen's
    # while_loop is not reverse-differentiable)
    cfg = cfg.replace(path_regen="never")

    if optimizer is None:
        optimizer = optax.adam(1e-2)

    n_tile = mesh.shape["tile"]
    n_sample = mesh.shape["sample"]
    spp = cfg.effective_samples
    total_cells = spp + ((-spp) % n_sample)

    px, py, inv = _tile_grid(cfg)
    n_pix = px.shape[0]
    pad_pix = (-n_pix) % n_tile
    if pad_pix:
        px = np.concatenate([px, np.zeros(pad_pix, px.dtype)])
        py = np.concatenate([py, np.zeros(pad_pix, py.dtype)])
    n_padded = px.shape[0]

    # target pixels permuted into the same tile order as the pixel list
    order = np.empty_like(inv)
    order[inv] = np.arange(inv.size)
    tgt = np.zeros((n_padded, 3), np.float32)
    tgt[:n_pix] = np.asarray(target, np.float32).reshape(-1, 3)[order]
    weight = np.zeros(n_padded, np.float32)
    weight[:n_pix] = 1.0

    px_j = jnp.asarray(px, cfg.dtype)
    py_j = jnp.asarray(py, cfg.dtype)
    tgt_j = jnp.asarray(tgt)
    w_j = jnp.asarray(weight)
    ids_j = jnp.arange(total_cells, dtype=jnp.int32)

    params0 = extract_params(scene.arrays)
    opt_state0 = optimizer.init(params0)

    @partial(
        shard_map, mesh=mesh,
        in_specs=(P(), P(), P("sample"), P("tile"), P("tile"), P("tile"), P("tile")),
        out_specs=(P(), P()),
        check_vma=False,
    )
    def loss_and_grads(params, key, ids, px, py, tgt, w):
        # differentiate only this device's radiance sums, never through a
        # collective: the loss is linear in each device's (pixel-shard x
        # cell-shard) sums once the mean image is fixed, so the global
        # gradient is the psum of every device's VJP against dL/d(sums)
        def local_sums(p):
            arrays = inject_params(scene.arrays, p)
            return sample_sums(scene, cfg, arrays, camera, key, ids, px, py)

        sums, vjp = jax.vjp(local_sums, params)
        img = _psum_tree(sums, "sample") * (1.0 / total_cells)
        d = img - Vec3.from_array(tgt)
        # identical global loss on every device
        loss = jax.lax.psum(jnp.sum(0.5 * d.dot(d) * w), "tile") / n_pix
        (grads,) = vjp(d * (w / (n_pix * total_cells)))
        return loss, _psum_tree(grads, ("tile", "sample"))

    @jax.jit
    def step(params, opt_state, key):
        loss, grads = loss_and_grads(params, key, ids_j, px_j, py_j, tgt_j, w_j)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    return step, opt_state0, params0
