"""Inverse-rendering: differentiable loss + optax train step.

Gradient strategy (SURVEY.md sect.7 step 9): all RNG draws are counter-based
and independent of parameters; DISCRETE choices (light-vs-BSDF branch, light
pick, mixed-material resolve, dielectric reflect-vs-refract, hit selection)
are integer/boolean and naturally carry no gradient; CONTINUOUS maps stay
attached, so fuzz/IOR/lobe parameters get reparameterized pathwise gradients
through the sampled directions, and albedo/emitter parameters flow through
throughput weights. Mesh-BVH and Mandelbulb hits run in lax.while_loop
(non-reversible) and are stop_gradient'd — geometry gradients are out of
scope anyway.

The bounce loop is a lax.scan, so reverse-mode checkpoints per bounce.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raysnail_tpu import render as renderlib
from raysnail_tpu import scene as scenelib
from raysnail_tpu.camera import Camera
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.diff.params import SceneParams, extract_params, inject_params
from raysnail_tpu.prelude.vec import Vec3

# rays (cells x pixels) per VJP pass — sized so one chunk's per-bounce
# residuals (~13 floats/ray/bounce even with remat) fit comfortably in HBM
GRAD_RAY_BUDGET = 1 << 21
# (pixel, cell) pairs per length-bucketed VJP batch (see _step): residuals
# are M * depth-class * ~13 floats with remat
BUCKET_BATCH = 1 << 18


def render_image_diff(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                      params: SceneParams, key, sample_ids) -> Vec3:
    """Differentiable mean-radiance image (flat (H*W,) Vec3, linear — no
    gamma) for a chunk of stratification cells."""
    # path_regen's while_loop is not reverse-differentiable: gradients flow
    # through the per-sample scan integrator. Sphere hits stay on the dense
    # XLA sweep, ATTACHED, so fuzz/IOR parameters get reparameterized
    # pathwise gradients through subsequent hit positions; mesh hits are
    # detached on either route.
    cfg = cfg.replace(path_regen="never")
    arrays = inject_params(scene.arrays, params)
    w, h = cfg.width, cfg.height
    py, px = jnp.meshgrid(jnp.arange(h, dtype=cfg.dtype),
                          jnp.arange(w, dtype=cfg.dtype), indexing="ij")
    sums = renderlib.sample_sums(scene, cfg, arrays, camera, key, sample_ids,
                                 px.ravel(), py.ravel())
    n = sample_ids.shape[0]
    return sums * (1.0 / n)


def make_loss_fn(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                 target: jnp.ndarray):
    """L2 image loss vs a target (H, W, 3) LINEAR-radiance image."""
    target_flat = Vec3.from_array(jnp.asarray(target, cfg.dtype).reshape(-1, 3))

    def loss_fn(params: SceneParams, key, sample_ids):
        img = render_image_diff(scene, camera, cfg, params, key, sample_ids)
        d = img - target_flat
        return 0.5 * jnp.mean(d.dot(d))

    return loss_fn


def make_train_step(scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                    target, optimizer=None, one_shot_max: int | None = None,
                    bucket_vjp: bool = False):
    """-> (step, opt_state0, params0). step(params, opt_state, key, ids) ->
    (params, opt_state, loss). Jitted; gradient flows through the full bounce
    loop.

    one_shot_max: one-shot threshold — when len(sample_ids) <= one_shot_max
    the step is a single value_and_grad; otherwise the two-pass scheme runs
    one VJP PER CELL (chunk width 1 — intermediate widths measured ~90x
    slower, see below; the old `accum_chunk` name implied they existed). The
    L2-of-mean loss is not separable across sample chunks, so the two-pass
    scheme keeps gradients exact: (1) a residual-free forward computes the
    mean image and the loss; (2) a lax.scan over cells runs one VJP of each
    cell's image against the fixed cotangent dL/d(mean image) / S and
    accumulates the gradient in the carry. Combined with cfg.remat_bounces
    this bounds fwd+bwd memory by ONE cell's per-bounce carries, so the
    canonical 800x500@64spp config fits one device.

    Per-CELL VJPs, not per-chunk: a VJP through a multi-cell sample scan
    stores that scan's residuals, and the scan over cells keeps the traced
    program one body regardless of spp.
    """
    import optax

    if optimizer is None:
        optimizer = optax.adam(1e-2)
    params0 = extract_params(scene.arrays)
    opt_state0 = optimizer.init(params0)
    target_flat = Vec3.from_array(jnp.asarray(target, cfg.dtype).reshape(-1, 3))
    n_pix = cfg.width * cfg.height

    if one_shot_max is None:
        # backward memory is bounded by one chunk's per-bounce residuals, so
        # the VJP budget stays FIXED (it must not scale with the forward
        # dispatch-batching knob cfg.ray_batch, which is sized for O(pixels)
        # forward dispatches)
        one_shot_max = max(1, GRAD_RAY_BUDGET // (4 * n_pix))

    def cell_sum(params, key, sid):
        """One cell's radiance-sum image — the per-cell VJP target."""
        ids = sid[None]
        img = render_image_diff(scene, camera, cfg, params, key, ids)
        return img  # sums*(1/1) == the cell's radiance

    def fast_mean_image(params, key, ids, contiguous, want_lengths=False):
        """Pass-1 forward: the mean image under the FAST forward policies.
        Pass 1 is stop_gradient'd — it only supplies the loss and the
        cotangent dL/d(mean image) — so it need not run the
        reverse-differentiable scan integrator: it rides the cross-pixel
        SHUFFLE regen integrator (the full-frame fast path; plain per-pixel
        regen's trip count barely concentrates while paying regen
        bookkeeping).
        Keying is (seed, pixel, sample, bounce) in both integrators, so the
        estimate matches the scan forward modulo f32 summation order
        (~1e-6).

        The regen fast path renders cells [ids[0], ids[0] + len(ids)) — it
        requires `ids` to be a contiguous ascending range. `contiguous` is
        checked from the CONCRETE ids at the step() call site;
        non-contiguous batches fall back to sample_sums, which takes the ids
        verbatim."""
        from raysnail_tpu import integrator

        arrays = inject_params(scene.arrays, params)
        backend = "fast" if cfg.rng == "auto" else cfg.rng
        lens = None
        if contiguous and backend == "fast" and cfg.path_regen != "never":
            out = integrator.radiance_regen_shuffle(
                scene, arrays, cfg, camera, key, int(ids.shape[0]), ids[0],
                record_lengths=want_lengths)
            sums = out[0]
            if want_lengths:
                lens = out[2]
        else:
            w, h = cfg.width, cfg.height
            py, px = jnp.meshgrid(jnp.arange(h, dtype=cfg.dtype),
                                  jnp.arange(w, dtype=cfg.dtype),
                                  indexing="ij")
            sums = renderlib.sample_sums(scene, cfg, arrays, camera, key,
                                         ids, px.ravel(), py.ravel())
        return sums * (1.0 / ids.shape[0]), lens

    def batch_dot_cot(params, key0, sid0, idxs, cotb, wts, depth):
        """Sum over a batch of (pixel, cell) pairs of <radiance, cotangent>,
        with the scan integrator TRUNCATED to `depth` bounces — exact for
        every pair whose recorded path length is <= depth (contributions
        past a path's death are identically zero). The scalar output makes
        jax.grad the whole backward."""
        from raysnail_tpu.camera import generate_rays
        from raysnail_tpu.prelude import rng as prng

        w = cfg.width
        sq = cfg.sqrt_spp
        cfgd = cfg.replace(max_depth=depth, path_regen="never")
        arrays = inject_params(scene.arrays, params)
        pix = (idxs % n_pix).astype(jnp.int32)
        sid = sid0 + (idxs // n_pix).astype(jnp.int32)
        pxb = (pix % w).astype(cfg.dtype)
        pyb = (pix // w).astype(cfg.dtype)
        # identical keying to sample_sums: (seed, pixel) stream + sample fold
        keys = prng.fold_all(prng.fast_streams(key0, pix), sid)
        ray = generate_rays(camera, pxb, pyb, (sid % sq).astype(cfg.dtype),
                            (sid // sq).astype(cfg.dtype), sq,
                            cfg.width, cfg.height, keys)
        from raysnail_tpu import integrator
        L = integrator.radiance(scene, arrays, cfgd, ray, keys)
        return jnp.sum((L.x * cotb[0] + L.y * cotb[1] + L.z * cotb[2]) * wts)

    import functools

    @functools.partial(jax.jit, static_argnames=("contiguous", "bucketed"))
    def _step(params, opt_state, key, sample_ids, contiguous=True,
              bucketed=False):
        s = sample_ids.shape[0]
        if one_shot_max >= s:
            loss_fn = make_loss_fn(scene, camera, cfg, target)
            loss, grads = jax.value_and_grad(loss_fn)(params, key, sample_ids)
        else:
            # pass 1: mean image through the FAST forward (regen integrator;
            # no residuals, no gradients) — the scan integrator is only
            # needed inside the VJPs below
            img, lens = fast_mean_image(params, key, sample_ids, contiguous,
                                        want_lengths=bucketed)
            img = jax.lax.stop_gradient(img)
            d = img - target_flat
            loss = 0.5 * jnp.mean(d.dot(d))
            # dL/d(mean image) = d / n_pix (d.dot(d) sums channels, mean is
            # over pixels), then 1/S maps a cell's radiance to the mean image
            cot = d * (1.0 / (n_pix * s))
            zeros = jax.tree_util.tree_map(jnp.zeros_like, params)

            if bucketed and lens is not None:
                # LENGTH-BUCKETED pair VJPs: the per-cell
                # scheme replays every (pixel, cell) at full depth, but scan
                # occupancy decays to ~30% by depth 8 — most paths die after
                # 1-3 bounces. Pass 1 recorded every pair's path length; sort
                # all N*s pairs by it, batch them, and run each batch's VJP
                # with the scan TRUNCATED to the batch's depth class
                # ({1, 2, 4, max_depth}). No safety margin: the scan can
                # flip a borderline branch the regen pass resolved the other
                # way (cross-program float reassociation, ~0.2% of pairs on
                # example.sdl) — but a flipped pair's path SUFFIX is a
                # different path entirely, so its gradient is equally
                # approximate at any truncation depth (the per-cell scheme
                # shares the same inconsistency; FD tests bound it). Work
                # drops from depth*N*s to ~sum(ceil-class(len)) — ~2.5-3x.
                lens_flat = jax.lax.stop_gradient(lens).reshape(-1)
                P = n_pix * s
                order = jnp.argsort(lens_flat)
                sorted_len = jnp.take(lens_flat, order)
                M = min(BUCKET_BATCH, P)
                B = -(-P // M)
                padn = B * M - P
                order_p = jnp.concatenate(
                    [order, jnp.zeros((padn,), order.dtype)])
                wt = jnp.concatenate([jnp.ones((P,), cfg.dtype),
                                      jnp.zeros((padn,), cfg.dtype)])
                ml = jnp.concatenate(
                    [sorted_len, jnp.full((padn,), 1.0, cfg.dtype)])
                depths = sorted({1, min(2, cfg.max_depth),
                                 min(4, cfg.max_depth), cfg.max_depth})
                need = ml.reshape(B, M).max(axis=1)
                cls = jnp.zeros((B,), jnp.int32)
                for i, dd in enumerate(depths[:-1]):
                    cls = jnp.where(need > dd, i + 1, cls)

                def one_batch(g_acc, xs):
                    idxs, clsb, wts = xs
                    pix = (idxs % n_pix).astype(jnp.int32)
                    cotb = (jnp.take(cot.x, pix), jnp.take(cot.y, pix),
                            jnp.take(cot.z, pix))
                    branches = [
                        jax.grad(lambda p, dd=dd: batch_dot_cot(
                            p, key, sample_ids[0], idxs, cotb, wts, dd))
                        for dd in depths
                    ]
                    g = jax.lax.switch(clsb, branches, params)
                    return jax.tree_util.tree_map(jnp.add, g_acc, g), None

                grads, _ = jax.lax.scan(
                    one_batch, zeros,
                    (order_p.reshape(B, M), cls, wt.reshape(B, M)))
            else:
                def accumulate(g_acc, sid):
                    _, vjp = jax.vjp(lambda p: cell_sum(p, key, sid), params)
                    (g,) = vjp(cot)
                    return jax.tree_util.tree_map(jnp.add, g_acc, g), None

                grads, _ = jax.lax.scan(accumulate, zeros, sample_ids)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def step(params, opt_state, key, sample_ids):
        """Contiguity of `sample_ids` is checked here, on the CONCRETE array,
        and routed into the jit as a static flag: the pass-1 regen fast path
        assumes a contiguous ascending cell range. Callers that
        pass already-traced ids (none in-tree) inherit the documented
        contiguous-ids contract."""
        import numpy as np
        try:
            a = np.asarray(sample_ids)
            contiguous = bool(np.array_equal(
                a, (a[0] if a.size else 0) + np.arange(a.shape[0])))
        except Exception:  # traced ids: the contract is contiguity
            contiguous = True
        backend = "fast" if cfg.rng == "auto" else cfg.rng
        import os
        # default OFF: its 25.6M-pair argsort + batch machinery competes
        # with the truncation win, and which one wins on the GPU is not
        # measured yet. RAYSNAIL_BUCKET_VJP=1 or bucket_vjp=True opts in.
        env_on = os.environ.get("RAYSNAIL_BUCKET_VJP") == "1"
        env_off = os.environ.get("RAYSNAIL_BUCKET_VJP") == "0"
        bucketed = ((bucket_vjp or env_on) and not env_off and contiguous
                    and backend == "fast"
                    and cfg.path_regen != "never" and cfg.max_depth > 2)
        return _step(params, opt_state, key, jnp.asarray(sample_ids),
                     contiguous=contiguous, bucketed=bucketed)

    return step, opt_state0, params0
