"""End-to-end integrator tests: small renders with statistical assertions
(the reference has no tests; golden-by-statistics is our strategy,
SURVEY.md sect.4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raysnail_tpu import ir, render as renderlib
from raysnail_tpu.camera import build_camera
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.scene import SceneBuilder

CFG = RenderConfig(width=64, height=40, samples=9, max_depth=6, ray_batch=1 << 15)


def simple_scene():
    b = SceneBuilder()
    b.add(ir.Sphere((0.0, -100.5, -1.0), 100.0, ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.add(ir.Sphere((0.0, 0.0, -1.0), 0.5, ir.Lambertian(ir.Constant((0.7, 0.3, 0.3)))))
    return b


def cam(cfg=CFG, **kw):
    kw.setdefault("look_from", (0.0, 0.0, 0.0))
    kw.setdefault("look_at", (0.0, 0.0, -1.0))
    kw.setdefault("fov", 60.0)
    return build_camera(width=cfg.width, height=cfg.height, **kw)


def test_render_finite_and_reproducible():
    scene = simple_scene().compile()
    img1 = renderlib.render(scene, cam(), CFG, seed=3)
    img2 = renderlib.render(scene, cam(), CFG, seed=3)
    img3 = renderlib.render(scene, cam(), CFG, seed=4)
    assert np.isfinite(img1).all()
    np.testing.assert_array_equal(img1, img2)
    assert np.abs(img1 - img3).max() > 0  # different seed differs
    assert img1.shape == (CFG.height, CFG.width, 3)


def test_sky_only_matches_background():
    b = SceneBuilder()
    b.add(ir.Sphere((0.0, 0.0, 1000.0), 0.5, ir.Lambertian()))  # behind camera
    scene = b.compile()
    img = renderlib.render(scene, cam(), CFG.replace(gamma=False), seed=0)
    # every pixel is pure background: white->blue on dir.y
    top = img[0].mean(0)     # looking slightly up -> bluer
    bottom = img[-1].mean(0)
    assert top[2] > 0.9
    assert top[0] < bottom[0]  # red increases toward the white end (down)


def test_emissive_sphere_lights_scene():
    b = SceneBuilder()
    b.add(ir.Sphere((0.0, -100.5, -1.0), 100.0, ir.Lambertian(ir.Constant((0.8, 0.8, 0.8)))))
    b.add(ir.Sphere((0.0, 3.0, -1.0), 1.0, ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 5.0)),
          light=True)
    b.set_background((0.0, 0.0, 0.0))
    scene = b.compile()
    img = renderlib.render(scene, cam(), CFG, seed=0)
    assert np.isfinite(img).all()
    assert img.mean() > 0.01  # light reaches the floor


def test_dark_box_is_black():
    b = SceneBuilder()
    b.add(ir.Sphere((0.0, 0.0, -1.0), 0.5, ir.Lambertian(ir.Constant((0.9, 0.9, 0.9)))))
    b.set_background((0.0, 0.0, 0.0))
    scene = b.compile()
    img = renderlib.render(scene, cam(), CFG.replace(gamma=False), seed=0)
    # no lights, black background: sphere reflects only blackness
    assert img.max() < 1e-4


def test_metal_mirror_reflects_sphere():
    b = SceneBuilder()
    # red emissive wall behind camera, mirror ahead
    b.add(ir.Sphere((0.0, 0.0, 5.0), 2.0, ir.DiffuseLight(ir.Constant((1.0, 0.1, 0.1)), 3.0)))
    b.add(ir.Sphere((0.0, 0.0, -2.0), 1.0, ir.Metal(ir.Constant((0.95, 0.95, 0.95)))))
    b.set_background((0.0, 0.0, 0.0))
    scene = b.compile()
    img = renderlib.render(scene, cam(), CFG.replace(gamma=False), seed=0)
    h, w = CFG.height, CFG.width
    center = img[h // 2 - 2 : h // 2 + 2, w // 2 - 2 : w // 2 + 2]
    # mirror center shows the red light behind the camera
    assert center[..., 0].mean() > 10 * center[..., 2].mean()


def test_dielectric_transmits():
    b = SceneBuilder()
    b.add(ir.Sphere((0.0, 0.0, -1.5), 0.7, ir.Dielectric((1.0, 1.0, 1.0), 1.5)))
    # green light straight ahead behind the glass
    b.add(ir.Sphere((0.0, 0.0, -20.0), 5.0, ir.DiffuseLight(ir.Constant((0.1, 1.0, 0.1)), 2.0)))
    b.set_background((0.0, 0.0, 0.0))
    scene = b.compile()
    img = renderlib.render(scene, cam(), CFG.replace(gamma=False), seed=1)
    h, w = CFG.height, CFG.width
    center = img[h // 2 - 2 : h // 2 + 2, w // 2 - 2 : w // 2 + 2]
    assert center[..., 1].mean() > 0.05  # green visible through the glass


def test_depth_zero_black():
    scene = simple_scene().compile()
    img = renderlib.render(scene, cam(), CFG.replace(max_depth=0, gamma=False), seed=0)
    assert img.max() == 0.0


def test_book1_scene_compiles_and_renders():
    from raysnail_tpu.scenes import book1

    cfg = RenderConfig(width=50, height=28, samples=4, max_depth=4, ray_batch=1 << 14)
    scene = book1.balls_scene(7).compile()
    camera = book1.balls_camera(cfg.width, cfg.height)
    img = renderlib.render(scene, camera, cfg, seed=7)
    assert np.isfinite(img).all()
    assert 0.1 < img.mean() < 0.9


def test_regen_chunk_width_is_invariant(monkeypatch):
    """RAYSNAIL_REGEN_C (shuffle chunk width) is a pure perf knob: cells
    accumulate in ascending cell order for any C; XLA fusion differences
    leave only float-reassociation noise (<= ~1e-5 relative on cell sums)."""
    import jax

    from raysnail_tpu.integrator import radiance_regen_shuffle
    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.sdl import build_scene
    import os

    cfg = RenderConfig(width=24, height=16, samples=16, max_depth=4)
    scene, cam = build_scene(
        os.path.join(os.path.dirname(__file__), "..", "sdl", "example.sdl"), cfg)
    key = prng.key(3)

    outs = []
    for c in ("4", "16"):
        monkeypatch.setenv("RAYSNAIL_REGEN_C", c)
        sums, _ = jax.jit(
            lambda arrays: radiance_regen_shuffle(scene, arrays, cfg, cam,
                                                  key, cfg.effective_samples)
        )(scene.arrays)
        outs.append(np.asarray(sums.to_array()))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4)


def test_regen_window_is_invariant():
    """cfg.regen_window (sliding-window cell table) is a pure perf knob:
    the same cells accumulate the same contributions, just retiring into
    the pixel accumulator mid-loop via uniform rolls instead of all at the
    end — only float-reassociation noise may differ. Stalls (a lane > W-1
    cells ahead of the slowest) must change scheduling, not values."""
    import jax

    from raysnail_tpu.integrator import radiance_regen_shuffle
    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.sdl import build_scene
    import os

    cfg0 = RenderConfig(width=24, height=16, samples=16, max_depth=4,
                        regen_chunk_cap=16)
    scene, cam = build_scene(
        os.path.join(os.path.dirname(__file__), "..", "sdl", "example.sdl"),
        cfg0)
    key = prng.key(3)

    outs = []
    for w in (0, 3, 8):  # full table, tight window (stalls), pow2 window
        cfg = cfg0.replace(regen_window=w)
        sums, _ = jax.jit(
            lambda arrays, cfg=cfg: radiance_regen_shuffle(
                scene, arrays, cfg, cam, key, cfg.effective_samples)
        )(scene.arrays)
        outs.append(np.asarray(sums.to_array()))
    np.testing.assert_allclose(outs[0], outs[1], rtol=1e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=1e-4)


def test_regen_shuffle_tiled_packets_invariant():
    """When the mesh kernel is active, the regen shuffle rotates at kernel
    BLOCK granularity with tile-decoded lanes; the estimate must equal the
    scan integrator's (same (pixel, sample) keys) exactly per pixel."""
    import numpy as np

    from raysnail_tpu import ir
    from raysnail_tpu.camera import build_camera
    from raysnail_tpu.render import render
    from raysnail_tpu.scene import SceneBuilder
    from raysnail_tpu.scenes.meshes import uv_sphere

    v, f, n_ = uv_sphere(10, 14, center=(0.0, 0.0, -3.0))
    b = SceneBuilder()
    b.add(ir.Mesh(vertices=v, indices=f, normals=n_,
                  material=ir.Lambertian(ir.Constant((0.6, 0.4, 0.3)))))
    b.add(ir.Sphere((0, -101.0, -3), 100.0,
                    ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.add(ir.Sphere((3, 4, 0), 0.8,
                    ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 5.0)),
          light=True)
    scene = b.compile()
    # 32x16 = 512 lanes = 4 blocks; 16x8 tiles divide -> tile mode active
    cfg = RenderConfig(width=32, height=16, samples=4, max_depth=3,
                       mesh_pallas="force")
    cam = build_camera((0, 0, 1), (0, 0, -3), fov=50,
                       width=cfg.width, height=cfg.height)
    img_regen = render(scene, cam, cfg, seed=4)           # frame step (tiled)
    img_scan = render(scene, cam, cfg.replace(path_regen="never"), seed=4)
    np.testing.assert_allclose(img_regen, img_scan, atol=2e-5)


def test_scattered_rays_start_off_the_surface():
    """A bounce leaves SURFACE_EPS * max(1, |p|) off the surface, on the side
    it leaves by: from a wall at z=555 no bounce ray re-hits the wall just
    past t_min (an f32 self-hit whose outcome turns on the last bits)."""
    from raysnail_tpu import integrator
    from raysnail_tpu import scene as scenelib
    from raysnail_tpu.camera import Ray
    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.prelude.vec import Vec3

    b = SceneBuilder()
    b.add(ir.Rect(2, 555.0, 0.0, 555.0, 0.0, 555.0,
                  ir.Lambertian(ir.Constant((0.7, 0.7, 0.7)))))
    scene = b.compile()
    cfg = RenderConfig(max_depth=2)
    n = 4096
    rng = np.random.default_rng(2)
    o = np.stack([rng.uniform(50, 500, n), rng.uniform(50, 500, n),
                  np.zeros(n)], -1).astype(np.float32)
    d = rng.normal(size=(n, 3)) * [0.2, 0.2, 0.0] + [0.0, 0.0, 1.0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    ray = Ray(origin=Vec3.from_array(jnp.asarray(o)),
              direction=Vec3.from_array(jnp.asarray(d)),
              time=jnp.zeros(n, jnp.float32))
    keys = prng.fast_streams(prng.key(0), jnp.arange(n, dtype=jnp.int32))
    shade = integrator._make_shade(scene, cfg, integrator._pallas_policy(cfg))
    new_o, new_d, _, _, alive = shade(
        scene.arrays, ray, Vec3.ones((n,)), Vec3.zeros((n,)),
        jnp.ones(n, bool), keys)
    alive = np.asarray(alive)
    assert alive.mean() > 0.5                  # most rays hit the wall
    gap = (555.0 - np.asarray(new_o.z))[alive]
    assert (np.asarray(new_d.z)[alive] < 0).all()   # diffuse bounces go back
    assert gap.min() >= 0.99 * integrator.SURFACE_EPS * 555.0, gap.min()
    again = scenelib.intersect(scene, scene.arrays,
                               Ray(new_o, new_d, ray.time), cfg.t_min,
                               cfg.t_max, keys)
    assert not np.asarray(again.valid)[alive].any()
