"""Render sessions: streaming, checkpoint/resume, and throughput counters.

The reference's painter streams rows to the preview UI over an mpsc channel
and its multi-pass loop keeps the full framebuffer + redo map as implicit
"checkpoint" state (SURVEY.md sect.5). Here that state is explicit and
serializable: a RenderState carries (radiance sums, samples done, pass index,
redo mask, seed), so a long render can stop at any chunk boundary and resume
in a new process — the device-side equivalent of the reference's accumulate-and-
continue loop, plus what it lacked: real persistence.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import jax.numpy as jnp
import numpy as np

from raysnail_tpu import render as renderlib
from raysnail_tpu import scene as scenelib
from raysnail_tpu.camera import Camera
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.prelude import color as colorlib
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.prelude.vec import Vec3

log = logging.getLogger("raysnail")


@dataclasses.dataclass
class RenderState:
    """Checkpointable accumulation state."""
    accum: np.ndarray          # (H*W, 3) radiance sums of the current pass
    samples_done: int          # cells accumulated into `accum`
    pass_index: int            # completed passes folded into `image`
    image: Optional[np.ndarray]  # running-average display image of passes
    seed: int

    def save(self, path: str):
        np.savez_compressed(
            path, accum=self.accum, samples_done=self.samples_done,
            pass_index=self.pass_index,
            image=self.image if self.image is not None else np.zeros(0),
            seed=self.seed,
        )

    @staticmethod
    def load(path: str) -> "RenderState":
        z = np.load(path)
        img = z["image"]
        return RenderState(
            accum=z["accum"], samples_done=int(z["samples_done"]),
            pass_index=int(z["pass_index"]),
            image=img if img.size else None, seed=int(z["seed"]),
        )


class RenderSession:
    """Drives a (possibly multi-pass) render chunk by chunk with streaming
    callbacks and optional checkpointing.

    target(done_cells, total_cells, partial_image) plays the role of the
    reference's PainterTarget row stream (painter.rs:23-26); returning False
    from it cancels the render (the PainterController::Quit that the
    reference wired up but never polled, painter.rs:28-32)."""

    def __init__(self, scene: scenelib.Scene, camera: Camera, cfg: RenderConfig,
                 seed: int = 0, checkpoint_path: Optional[str] = None,
                 step=None, k_multiple: int = 1):
        """`step` overrides the jitted single-device sample step — pass a
        sharded step (parallel.make_padded_sharded_step) with k_multiple =
        the mesh's sample-axis size to stream and checkpoint a render
        running on a device mesh."""
        self.scene = scene
        self.camera = camera
        self.cfg = cfg
        self.seed = seed
        self.checkpoint_path = checkpoint_path
        self.step = step if step is not None else renderlib.make_sample_step(scene, cfg)
        self.k_multiple = k_multiple
        self.px, self.py, self._inv = renderlib._tile_grid(cfg)
        self.rays_traced = 0
        self.wall_seconds = 0.0

    # -- single pass with streaming + checkpoints -------------------------
    def render(self, target: Optional[Callable] = None,
               resume: Optional[RenderState] = None) -> np.ndarray:
        cfg = self.cfg
        spp = cfg.effective_samples
        n_pix = cfg.width * cfg.height
        # cap dispatch size so streaming callbacks / checkpoints still fire
        # at a useful cadence even though the plain renderer now batches the
        # whole frame into one dispatch
        k = renderlib._sample_chunks(cfg, n_pix, self.k_multiple,
                                     budget=min(cfg.ray_batch, 1 << 21))

        if resume is not None:
            accum_np = resume.accum
            start_cell = resume.samples_done
            log.info("resuming at %d/%d cells", start_cell, spp)
        else:
            accum_np = np.zeros((n_pix, 3), np.float32)
            start_cell = 0

        key = prng.key(self.seed)
        px = jnp.asarray(self.px, cfg.dtype)
        py = jnp.asarray(self.py, cfg.dtype)
        accum = Vec3.from_array(jnp.asarray(accum_np))

        done = start_cell
        for start in range(start_cell, spp, k):
            t0 = time.time()
            ids = jnp.arange(start, start + k, dtype=jnp.int32)
            sums = self.step(self.scene.arrays, self.camera, key, ids, px, py)
            accum = accum + sums
            done = start + k
            dt = time.time() - t0
            self.rays_traced += n_pix * k
            self.wall_seconds += dt
            log.info("cells %d-%d of %d (%.2f Mrays/s primary)",
                     start, done, spp, n_pix * k / max(dt, 1e-9) / 1e6)

            if target is not None or self.checkpoint_path:
                accum_np = np.asarray(accum.to_array())
            if self.checkpoint_path:
                RenderState(accum_np, done, 0, None, self.seed).save(self.checkpoint_path)
            if target is not None:
                partial = colorlib.into_color(
                    Vec3.from_array(jnp.asarray(accum_np)), float(done), cfg.gamma
                )
                img = np.asarray(partial.to_array())[self._inv].reshape(
                    cfg.height, cfg.width, 3)
                if target(done, spp, img) is False:
                    log.info("render cancelled at %d/%d cells", done, spp)
                    break

        final = colorlib.into_color(accum, float(max(done, 1)), cfg.gamma)
        return np.asarray(final.to_array())[self._inv].reshape(
            cfg.height, cfg.width, 3)

    @property
    def mrays_per_sec(self) -> float:
        return self.rays_traced / max(self.wall_seconds, 1e-9) / 1e6
