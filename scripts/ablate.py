"""Stage ablation on example.sdl: time the full step vs variants with parts
neutralized, to locate the hot stages. Run AFTER bench --all (device free)."""
import os, sys, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
from raysnail_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.render import _full_grid, _sample_chunks, make_sample_step
from raysnail_tpu.sdl import build_scene

def time_cfg(name, cfg, scene, camera, reps=3):
    step = make_sample_step(scene, cfg)
    px, py = _full_grid(cfg)
    px = jnp.asarray(px, cfg.dtype); py = jnp.asarray(py, cfg.dtype)
    key = prng.key(7)
    spp = cfg.effective_samples
    k = _sample_chunks(cfg, cfg.width * cfg.height)
    out = step(scene.arrays, camera, key, jnp.arange(k, dtype=jnp.int32), px, py)
    float(out.x.sum())
    best = 1e9
    for _ in range(reps):
        t0 = time.time()
        accum = None
        for s in range(0, spp, k):
            o = step(scene.arrays, camera, key, jnp.arange(s, s+k, dtype=jnp.int32), px, py)
            accum = o if accum is None else accum + o
        float(accum.x.sum())
        best = min(best, time.time() - t0)
    mr = cfg.width*cfg.height*spp/best/1e6
    print(f"{name:24s}: {mr:7.2f} Mrays/s ({best:.2f}s)", flush=True)
    return mr

base = RenderConfig(width=800, height=500, samples=65, max_depth=8)
scene, camera = build_scene(os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "sdl", "example.sdl"), base)
time_cfg("full depth8", base, scene, camera)
time_cfg("depth4", base.replace(max_depth=4), scene, camera)
time_cfg("depth2", base.replace(max_depth=2), scene, camera)
time_cfg("depth1", base.replace(max_depth=1), scene, camera)
time_cfg("rng=fast", base.replace(rng="fast"), scene, camera)
time_cfg("no-light-branch", base.replace(light_sample_prob=0.0), scene, camera)
