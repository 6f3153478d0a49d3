import os, sys, time
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
import jax
from raysnail_tpu.utils.cache import enable_compile_cache
enable_compile_cache()
import jax.numpy as jnp
from raysnail_tpu import ir
from raysnail_tpu.camera import build_camera
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.render import _full_grid, make_sample_step
from raysnail_tpu.scene import SceneBuilder

print("building", flush=True)
cfgb = RenderConfig(width=500, height=300, samples=25, max_depth=6)
bb = SceneBuilder()
bb.add(ir.Mandelbulb(material=ir.BlinnPhong(0.3, 60.0, ir.Constant((0.8, 0.75, 0.6)))))
bb.add(ir.Sphere((3, 5, 3), 1.0, ir.DiffuseLight(ir.Constant((1.0, 0.95, 0.9)), 6.0)), light=True)
bb.set_background((0.2, 0.25, 0.35), (0.5, 0.6, 0.8))
scene = bb.compile()
cam = build_camera(look_from=(2.2, 1.4, 2.2), look_at=(0, 0, 0), fov=45,
                   width=cfgb.width, height=cfgb.height)
step = make_sample_step(scene, cfgb)
px, py = _full_grid(cfgb)
px = jnp.asarray(px, cfgb.dtype); py = jnp.asarray(py, cfgb.dtype)
key = prng.key(7)
spp = cfgb.effective_samples
t0 = time.time()
out = step(scene.arrays, cam, key, jnp.arange(1, dtype=jnp.int32), px, py)
float(out.x.sum())
print("compile", time.time()-t0, flush=True)
t0 = time.time()
accum = None
for s in range(spp):
    o = step(scene.arrays, cam, key, jnp.arange(s, s+1, dtype=jnp.int32), px, py)
    accum = o if accum is None else accum + o
float(accum.x.sum())
dt = time.time()-t0
print(f"mandelbulb single-pass: {cfgb.width*cfgb.height*spp/dt/1e6:.3f} Mrays/s ({dt:.2f}s)", flush=True)
