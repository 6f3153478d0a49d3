"""Per-bounce live-lane occupancy of a scene (CPU, small frame): the fraction
of bounce-loop work that is masked dead lanes. Alive fractions are scene
statistics, independent of resolution/backend, so a small CPU run answers the
question for the canonical GPU frame."""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp
import numpy as np

from raysnail_tpu import integrator
from raysnail_tpu.camera import generate_rays
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.render import _tile_grid
from raysnail_tpu.sdl import build_scene
from raysnail_tpu.scenes import book1, book2


def stats(name, scene, camera, cfg, seed=7):
    px, py, _ = _tile_grid(cfg)
    px = jnp.asarray(px, cfg.dtype)
    py = jnp.asarray(py, cfg.dtype)
    pixel_ids = (py.astype(jnp.int32) * cfg.width + px.astype(jnp.int32))
    base = jax.random.fold_in(prng.key(seed), 0)
    keys = prng.fast_streams(base, pixel_ids)
    ray = generate_rays(camera, px, py, jnp.zeros_like(px), jnp.zeros_like(py),
                        cfg.sqrt_spp, cfg.width, cfg.height, keys)
    _, counts = jax.jit(
        lambda a, r, k: integrator.radiance_and_alive(scene, a, cfg, r, k)
    )(scene.arrays, ray, keys)
    n = px.shape[0]
    frac = np.asarray(counts) / n
    # lanes entering bounce b = alive after b-1 (bounce 0 enters at 1.0)
    entering = np.concatenate([[1.0], frac[:-1]])
    print(f"{name:16s} entering-alive by bounce:",
          " ".join(f"{f:.3f}" for f in entering),
          f" mean occupancy {entering.mean():.3f}")


if __name__ == "__main__":
    cfg = RenderConfig(width=200, height=125, samples=4, max_depth=8)
    scene, cam = build_scene(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "sdl", "example.sdl"), cfg)
    stats("example.sdl", scene, cam, cfg)

    cfg1 = RenderConfig(width=200, height=112, samples=4, max_depth=8)
    stats("rtow_13_1", book1.balls_scene(7).compile(),
          book1.balls_camera(cfg1.width, cfg1.height), cfg1)

    cfgb = RenderConfig(width=100, height=100, samples=4, max_depth=8)
    stats("book2", book2.all_feature_scene(7).compile(),
          book2.book2_camera(cfgb.width, cfgb.height), cfgb)
