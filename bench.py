"""Benchmark driver: one process drives the card.

Default: the canonical workload (BASELINE.md) — sdl/example.sdl at 800x500,
--samples 65 => 64 effective spp, depth 8 — then a check that the mesh
route this backend takes (integrator.routes) runs and agrees with the XLA
walk, and ONE JSON line on stdout:
{"metric", "value", "unit", "vs_baseline", "device"}. The metric counts
PRIMARY rays (pixels x spp) per steady-state second; every timed call ends
in block_until_ready, and compilation (the first call) is reported apart.

--all additionally measures the other BASELINE.md configs in the same
process and writes them to stderr, one JSON line each.

vs_baseline: the reference publishes no numbers; the baseline is pinned to
an ESTIMATE of the reference's row-threaded f64 CPU tracer: ~0.5 Mrays/s
primary on a 2-vCPU host. Refine when a measured number exists.

Env: RAYSNAIL_BENCH_CPU=1 asks for the CPU backend explicitly (otherwise a
missing GPU is an error); RAYSNAIL_BENCH_SMALL=1 shrinks configs.
"""

from __future__ import annotations

import json
import os
import sys
import time

REF_BASELINE_MRAYS = 0.5  # estimated reference CPU Mrays/s
REPO = os.path.dirname(os.path.abspath(__file__))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def _time_render(scene, camera, cfg, passes: int = 1, reps: int = 3):
    """-> (mrays_primary, first_call_seconds, steady_seconds)."""
    import jax
    import jax.numpy as jnp

    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.render import (_sample_chunks, _tile_grid,
                                     make_frame_step, make_sample_step,
                                     render_passes)

    key = prng.key(7)
    spp = cfg.effective_samples
    frame = make_frame_step(scene, cfg)  # shuffled-regen full-frame step
    if frame is not None:
        run = lambda: frame(scene.arrays, camera, key)
    else:
        step = make_sample_step(scene, cfg)
        px, py, _ = _tile_grid(cfg)
        px = jnp.asarray(px, cfg.dtype)
        py = jnp.asarray(py, cfg.dtype)
        k = _sample_chunks(cfg, cfg.width * cfg.height)

        def run():
            accum = None
            for start in range(0, spp, k):
                ids = jnp.arange(start, start + k, dtype=jnp.int32)
                sums = step(scene.arrays, camera, key, ids, px, py)
                accum = sums if accum is None else accum + sums
            return accum

    t0 = time.perf_counter()
    jax.block_until_ready(run())
    first_s = time.perf_counter() - t0

    primary = cfg.width * cfg.height * spp
    if passes > 1:
        # the full adaptive multi-pass driver (includes host noise calc);
        # later passes re-render only noisy pixels
        t0 = time.perf_counter()
        render_passes(scene, camera, cfg.replace(passes=passes), seed=7)
        dt = time.perf_counter() - t0
        return primary * passes / dt / 1e6, first_s, dt

    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(run())
        best = min(best, time.perf_counter() - t0)
    return primary / best / 1e6, first_s, best


def _time_grad_step(small: bool, canonical: bool = False):
    """Forward+backward Mrays/s: optax train steps on example.sdl.
    canonical=True runs the full 800x500@64spp config (remat'd bounces +
    two-pass gradient accumulation, diff/train.py); otherwise 400x250@16."""
    import jax
    import jax.numpy as jnp

    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.diff import make_train_step
    from raysnail_tpu.sdl import build_scene

    if canonical:
        cfg = RenderConfig(width=160 if small else 800,
                           height=100 if small else 500,
                           samples=9 if small else 65, max_depth=8)
    else:
        cfg = RenderConfig(width=100 if small else 400,
                           height=62 if small else 250,
                           samples=4 if small else 16, max_depth=8)
    scene, camera = build_scene(os.path.join(REPO, "sdl", "example.sdl"), cfg)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    step, opt_state, params = make_train_step(scene, camera, cfg, target)
    ids = jnp.arange(cfg.effective_samples, dtype=jnp.int32)
    key = jax.random.PRNGKey(0)

    t0 = time.perf_counter()
    params, opt_state, loss = jax.block_until_ready(
        step(params, opt_state, key, ids))
    first_s = time.perf_counter() - t0
    reps = 3
    t0 = time.perf_counter()
    for i in range(reps):
        params, opt_state, loss = step(params, opt_state,
                                       jax.random.fold_in(key, i), ids)
    jax.block_until_ready((params, loss))
    dt = time.perf_counter() - t0
    rays = cfg.width * cfg.height * cfg.effective_samples * reps
    return {
        "mrays_fwd_bwd": rays / dt / 1e6,
        "first_s": first_s,
        "steady_s": dt,
        "size": f"{cfg.width}x{cfg.height}@{cfg.effective_samples}spp",
        "loss": float(loss),
    }


def _configs(small: bool):
    from raysnail_tpu import ir
    from raysnail_tpu.camera import build_camera
    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.scene import SceneBuilder
    from raysnail_tpu.scenes import book1, book2, cornell
    from raysnail_tpu.scenes.meshes import knot_camera, knot_scene
    from raysnail_tpu.sdl import build_scene

    def sdl(name, cfg):
        return build_scene(os.path.join(REPO, "sdl", name), cfg)

    # LAZY: each entry is a thunk — scenes are built (and their arrays
    # transferred) only when that config actually runs
    out = {}

    cfg = RenderConfig(width=200 if small else 800, height=125 if small else 500,
                       samples=4 if small else 65, max_depth=8)
    out["example.sdl"] = lambda: (*sdl("example.sdl", cfg), cfg, 1)

    cfg1 = RenderConfig(width=100 if small else 400, height=57 if small else 225,
                        samples=4 if small else 16, max_depth=8)
    out["rtow_13_1"] = lambda: (
        book1.balls_scene(7).compile(),
        book1.balls_camera(cfg1.width, cfg1.height), cfg1, 1,
    )

    cfg2 = RenderConfig(width=200 if small else 800, height=125 if small else 500,
                        samples=4 if small else 65, max_depth=8)
    out["quadric.sdl"] = lambda: (*sdl("quadric.sdl", cfg2), cfg2, 1)
    out["transforms.sdl"] = lambda: (*sdl("transforms.sdl", cfg2), cfg2, 1)

    # book-2 all-features scene: 400 ground boxes, moving sphere, media,
    # image+perlin textures — the worst-case divergence workload
    cfgb2 = RenderConfig(width=100 if small else 400, height=100 if small else 400,
                         samples=4 if small else 25, max_depth=8)
    out["book2"] = lambda: (
        book2.all_feature_scene(7).compile(),
        book2.book2_camera(cfgb2.width, cfgb2.height), cfgb2, 1,
    )

    # cornell box with smoke cartons (subsurface-style media + rect lights)
    cfgc = RenderConfig(width=100 if small else 400, height=100 if small else 400,
                        samples=4 if small else 25, max_depth=8)
    out["cornell-smoke"] = lambda: (
        cornell.cornell_box(carton=True, carton_rotation=True,
                            smoke=True).compile(),
        cornell.cornell_camera(cfgc.width, cfgc.height), cfgc, 1,
    )

    # 200k-triangle torus knot + emissive sphere light: the dragon-class
    # workload the reference drives through its OBJ loader
    # (preview_sdl2.rs:452-525; its dragon.obj is not shipped)
    cfgM = RenderConfig(width=160 if small else 320, height=100 if small else 200,
                        samples=4 if small else 16, max_depth=6)
    out["mesh-200k"] = lambda: (
        knot_scene(*((200, 16) if small else (1600, 64))).compile(),
        knot_camera(cfgM.width, cfgM.height), cfgM, 1)

    # Mandelbulb distance field with adaptive oversampling, passes=4
    cfgb = RenderConfig(width=120 if small else 500, height=72 if small else 300,
                        samples=4 if small else 25, max_depth=6)

    def bulb_entry():
        bb = SceneBuilder()
        bb.add(ir.Mandelbulb(material=ir.BlinnPhong(
            0.3, 60.0, ir.Constant((0.8, 0.75, 0.6)))))
        bb.add(ir.Sphere((3, 5, 3), 1.0, ir.DiffuseLight(
            ir.Constant((1.0, 0.95, 0.9)), 6.0)), light=True)
        bb.set_background((0.2, 0.25, 0.35), (0.5, 0.6, 0.8))
        camb = build_camera(look_from=(2.2, 1.4, 2.2), look_at=(0, 0, 0),
                            fov=45, width=cfgb.width, height=cfgb.height)
        return bb.compile(), camb, cfgb, 2 if small else 4

    out["mandelbulb-passes4"] = bulb_entry

    # the same knot at ~10k triangles
    cfgm = RenderConfig(width=160 if small else 320, height=100 if small else 200,
                        samples=4 if small else 16, max_depth=6)
    out["mesh+arealight"] = lambda: (
        knot_scene(*((100, 16) if small else (200, 24))).compile(),
        knot_camera(cfgm.width, cfgm.height), cfgm, 1)
    return out


def _route_check() -> dict:
    """The mesh route this backend takes must run: on a GPU the compiled
    Pallas kernel, on a CPU the XLA walk. Both are compared with the XLA
    walk on a 4096-ray batch at a small mesh (exact agreement expected)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from raysnail_tpu import integrator
    from raysnail_tpu.camera import Ray
    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.geometry import triangles
    from raysnail_tpu.prelude.vec import Vec3
    from raysnail_tpu.scenes.meshes import knot_scene

    backend = jax.default_backend()
    route = integrator.routes(RenderConfig(), backend)["mesh"]
    group = knot_scene(200, 24).compile().arrays.triangles
    rng = np.random.default_rng(11)
    n = 4096
    o = np.tile(np.array([[0.0, 1.5, 4.0]], np.float32), (n, 1))
    d = rng.uniform(-1.5, 1.5, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = Ray(origin=Vec3.from_array(jnp.asarray(o)),
              direction=Vec3.from_array(jnp.asarray(d)),
              time=jnp.zeros(n, jnp.float32))
    ref = triangles.intersect(group, ray, 1e-3, 3e4,
                              max_iters=int(group.first.shape[0]))
    if route == "kernel":
        got = triangles.intersect_kernel(group, ray, 1e-3, 3e4)
    else:
        got = ref
    agree = float((np.asarray(got.valid) == np.asarray(ref.valid)).mean())
    if agree < 0.9999:
        raise RuntimeError(f"mesh route {route!r} disagrees with the walk "
                           f"on {1 - agree:.4%} of rays")
    return {"backend": backend, "mesh_route": route, "agree": agree,
            "hits": int(np.asarray(got.valid).sum())}


def _run_one(name: str, small: bool) -> dict:
    if name == "example-fwd+bwd":
        return _time_grad_step(small)
    if name == "example-fwd+bwd-800x500":
        return _time_grad_step(small, canonical=True)
    scene, camera, cfg, passes = _configs(small)[name]()
    mrays, first_s, steady_s = _time_render(scene, camera, cfg, passes)
    return {
        "mrays_primary": mrays,
        "first_s": first_s,
        "steady_s": steady_s,
        "size": f"{cfg.width}x{cfg.height}@{cfg.effective_samples}spp",
        "passes": passes,
    }


def main():
    import jax

    from raysnail_tpu.utils.cache import enable_compile_cache

    if os.environ.get("RAYSNAIL_BENCH_CPU") == "1":
        jax.config.update("jax_platforms", "cpu")
    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu" and os.environ.get("RAYSNAIL_BENCH_CPU") != "1":
        raise SystemExit(f"bench: no GPU (JAX sees {jax.devices()}); set "
                         f"RAYSNAIL_BENCH_CPU=1 to bench the CPU")
    device = {"platform": dev.platform, "kind": dev.device_kind,
              "count": len(jax.devices())}
    small = os.environ.get("RAYSNAIL_BENCH_SMALL") == "1"
    log(f"bench: device={device} small={small}")

    names = ["example.sdl"]
    if "--all" in sys.argv:
        names = (list(_configs(small))
                 + ["example-fwd+bwd", "example-fwd+bwd-800x500"])
    results = {}
    for name in names:
        results[name] = _run_one(name, small)
        log(json.dumps({"config": name, **results[name]}))
    log(json.dumps({"route_check": _route_check()}))

    mrays = results["example.sdl"]["mrays_primary"]
    size = results["example.sdl"]["size"]
    print(json.dumps({
        "metric": f"example.sdl {size} fwd primary rays per second per card",
        "value": mrays,
        "unit": "Mrays/s",
        "vs_baseline": mrays / REF_BASELINE_MRAYS,
        "device": device,
    }))


if __name__ == "__main__":
    main()
