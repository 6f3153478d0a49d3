"""book2 cost attribution: time the full scene vs variants with one feature
group neutralized. 400x400@25spp depth 8 is the bench config; default here is
a quarter frame for iteration speed (pass --full for the bench size)."""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

from raysnail_tpu.utils.cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax.numpy as jnp
import numpy as np

from raysnail_tpu import ir
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.render import _sample_chunks, _tile_grid, make_sample_step
from raysnail_tpu.scene import SceneBuilder
from raysnail_tpu.scenes import book2


def time_scene(name, builder, cfg, reps=3):
    scene = builder.compile() if isinstance(builder, SceneBuilder) else builder
    camera = book2.book2_camera(cfg.width, cfg.height)
    step = make_sample_step(scene, cfg)
    px, py, _ = _tile_grid(cfg)
    px = jnp.asarray(px, cfg.dtype)
    py = jnp.asarray(py, cfg.dtype)
    key = prng.key(7)
    spp = cfg.effective_samples
    k = _sample_chunks(cfg, cfg.width * cfg.height)
    t0 = time.time()
    out = step(scene.arrays, camera, key, jnp.arange(k, dtype=jnp.int32), px, py)
    float(out.x.sum())
    cs = time.time() - t0
    best = 1e9
    for _ in range(reps):
        t0 = time.time()
        accum = None
        for s in range(0, spp, k):
            o = step(scene.arrays, camera, key,
                     jnp.arange(s, s + k, dtype=jnp.int32), px, py)
            accum = o if accum is None else accum + o
        float(accum.x.sum())
        best = min(best, time.time() - t0)
    mr = cfg.width * cfg.height * spp / best / 1e6
    print(f"{name:22s}: {mr:7.2f} Mrays/s  steady={best:6.2f}s compile={cs:5.1f}s",
          flush=True)
    return mr


def variant(no_boxes=False, no_image=False, no_perlin=False, no_media=False,
            no_moving=False, few_boxes=0):
    rng = np.random.default_rng(7)
    b = SceneBuilder()
    ground = ir.Lambertian(ir.Constant((0.48, 0.83, 0.53)))
    w = 100.0
    if not no_boxes:
        n = 0
        for i in range(20):
            for j in range(20):
                x0, z0 = -1000.0 + i * w, -1000.0 + j * w
                y1 = 1.0 + rng.random() * 99.0
                if few_boxes and n >= few_boxes:
                    continue
                b.add(ir.Box((x0, 0.0, z0), (x0 + w, y1, z0 + w), ground))
                n += 1
    b.add(ir.Rect(1, 554.0, 123.0, 423.0, 147.0, 412.0,
                  ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 7.0)),
          light=True)
    b.add(ir.Sphere((400.0, 400.0, 200.0), 50.0,
                    ir.Lambertian(ir.Constant((0.7, 0.3, 0.1))),
                    speed=(0, 0, 0) if no_moving else (30.0, 0.0, 0.0)))
    b.add(ir.Sphere((260.0, 150.0, 45.0), 50.0, book2.WHITE_GLASS))
    b.add(ir.Sphere((0.0, 150.0, 145.0), 50.0,
                    ir.Metal(ir.Constant((0.8, 0.8, 0.9)))))
    b.add(ir.Sphere((360.0, 170.0, 145.0), 70.0, book2.WHITE_GLASS))
    if not no_media:
        b.add(ir.ConstantMedium(ir.Sphere((360.0, 170.0, 145.0), 70.0), 0.2,
                                (0.2, 0.4, 0.9)))
        b.add(ir.ConstantMedium(ir.Sphere((0.0, 0.0, 0.0), 5000.0), 0.0001,
                                (1.0, 1.0, 1.0)))
    b.add(ir.Sphere((400.0, 200.0, 400.0), 100.0,
                    ir.Lambertian(ir.Constant((0.3, 0.4, 0.5)) if no_image
                                  else book2._earth_texture())))
    b.add(ir.Sphere((220.0, 280.0, 300.0), 80.0,
                    ir.Lambertian(ir.Constant((0.6, 0.6, 0.6)) if no_perlin
                                  else ir.Noise(kind="normal", scale=0.1,
                                                vector=True))))
    b.set_background((0.0, 0.0, 0.0))
    return b


def main():
    full = "--full" in sys.argv
    cfg = RenderConfig(width=400 if full else 200, height=400 if full else 200,
                       samples=25 if full else 9, max_depth=8)
    time_scene("full", book2.all_feature_scene(7), cfg)
    time_scene("no-boxes", variant(no_boxes=True), cfg)
    time_scene("boxes=64", variant(few_boxes=64), cfg)
    time_scene("no-image-tex", variant(no_image=True), cfg)
    time_scene("no-perlin", variant(no_perlin=True), cfg)
    time_scene("no-media", variant(no_media=True), cfg)
    time_scene("no-moving", variant(no_moving=True), cfg)


if __name__ == "__main__":
    main()
