import os, sys, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
from raysnail_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.render import _full_grid, _sample_chunks, make_sample_step
from raysnail_tpu.scenes import book1

for rb in (1 << 17, 1 << 21):
    cfg = RenderConfig(width=400, height=225, samples=16, max_depth=8, ray_batch=rb)
    scene = book1.balls_scene(7).compile()
    cam = book1.balls_camera(cfg.width, cfg.height)
    step = make_sample_step(scene, cfg)
    px, py = _full_grid(cfg)
    px = jnp.asarray(px, cfg.dtype); py = jnp.asarray(py, cfg.dtype)
    key = prng.key(7)
    spp = cfg.effective_samples
    k = _sample_chunks(cfg, px.shape[0])
    t0 = time.time()
    out = step(scene.arrays, cam, key, jnp.arange(k, dtype=jnp.int32), px, py)
    float(out.x.sum())
    print(f"rb=2^{rb.bit_length()-1} k={k} compile+first {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    accum = None
    for s in range(0, spp, k):
        o = step(scene.arrays, cam, key, jnp.arange(s, s+k, dtype=jnp.int32), px, py)
        accum = o if accum is None else accum + o
    float(accum.x.sum())
    dt = time.time()-t0
    print(f"rb=2^{rb.bit_length()-1}: {cfg.width*cfg.height*spp/dt/1e6:.2f} Mrays/s ({dt:.2f}s)", flush=True)
