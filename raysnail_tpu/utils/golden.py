"""Golden regression anchors: fixed-seed CPU renders of representative scenes.

The reference's de-facto test suite is golden-image-by-eyeball (SURVEY.md
sect.4); its own renders cannot be reproduced in this image (no Rust
toolchain), so until that toolchain lands the framework pins ITS OWN
fixed-seed renders as regression anchors: the counter-based RNG
(prelude/rng.py) makes a (scene, seed, size, spp) render deterministic on a
given backend, so any estimator drift — a broken pdf, a sign flip in a
normal, a dropped emitted term — moves the committed statistics far beyond
float-reassociation noise.

Anchors are small CPU renders (seconds each); stats are a block-mean
thumbnail plus global mean/std per channel, stored in tests/golden/golden.npz
(regenerate with scripts/make_golden.py after an INTENDED estimator change
and eyeball the docs/renders output before committing). chip_smoke.py renders
the same anchors on the GPU and holds them to the same tolerances.
"""

from __future__ import annotations

import os

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
GOLDEN_PATH = os.path.join(REPO, "tests", "golden", "golden.npz")

# thumbnail block size: 8x8 pixel means are stable to low-bit float drift but
# sensitive to any real estimator change
BLOCK = 8


def golden_configs():
    """name -> thunk returning (scene, camera, cfg, seed). Lazy so importing
    this module stays cheap."""
    from raysnail_tpu import ir
    from raysnail_tpu.camera import build_camera
    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.scene import SceneBuilder
    from raysnail_tpu.scenes import book1, book2, cornell
    from raysnail_tpu.scenes.meshes import knot_camera, knot_scene
    from raysnail_tpu.sdl import build_scene

    def sdl(name, cfg):
        scene, camera = build_scene(os.path.join(REPO, "sdl", name), cfg)
        return scene, camera, cfg, 7

    out = {}
    cfg_sdl = RenderConfig(width=96, height=64, samples=4, max_depth=8)
    out["example.sdl"] = lambda: sdl("example.sdl", cfg_sdl)
    out["quadric.sdl"] = lambda: sdl("quadric.sdl", cfg_sdl)
    out["csg.sdl"] = lambda: sdl("csg.sdl", cfg_sdl)

    def cornell_entry():
        cfg = RenderConfig(width=96, height=96, samples=9, max_depth=8)
        scene = cornell.cornell_box(carton=True, carton_rotation=True).compile()
        return scene, cornell.cornell_camera(cfg.width, cfg.height), cfg, 7

    out["cornell"] = cornell_entry

    def book1_entry():
        cfg = RenderConfig(width=96, height=54, samples=4, max_depth=8)
        return (book1.balls_scene(7).compile(),
                book1.balls_camera(cfg.width, cfg.height), cfg, 7)

    out["book1"] = book1_entry

    def book2_entry():
        cfg = RenderConfig(width=96, height=54, samples=4, max_depth=6)
        return (book2.all_feature_scene(7).compile(),
                book2.book2_camera(cfg.width, cfg.height), cfg, 7)

    out["book2"] = book2_entry

    def mesh_entry(**kw):
        cfg = RenderConfig(width=96, height=64, samples=4, max_depth=4, **kw)
        return (knot_scene(60, 12).compile(),
                knot_camera(cfg.width, cfg.height), cfg, 7)

    out["mesh"] = mesh_entry

    def bulb_entry():
        cfg = RenderConfig(width=80, height=48, samples=4, max_depth=4)
        b = SceneBuilder()
        b.add(ir.Mandelbulb(material=ir.BlinnPhong(0.3, 60.0,
                                                   ir.Constant((0.8, 0.75, 0.6)))))
        b.add(ir.Sphere((3, 5, 3), 1.0,
                        ir.DiffuseLight(ir.Constant((1.0, 0.95, 0.9)), 6.0)),
              light=True)
        b.set_background((0.2, 0.25, 0.35), (0.5, 0.6, 0.8))
        cam = build_camera(look_from=(2.2, 1.4, 2.2), look_at=(0, 0, 0), fov=45,
                           width=cfg.width, height=cfg.height)
        return b.compile(), cam, cfg, 7

    out["mandelbulb"] = bulb_entry

    def boxfield_entry():
        # a 144-box field on the dense slab sweep (boxes.intersect): slab
        # intervals, the argmin tie-break over shared faces, face uv and
        # entry/exit normals get a radiance-level anchor
        cfg = RenderConfig(width=64, height=40, samples=4, max_depth=4)
        b = SceneBuilder()
        gm = ir.Lambertian(ir.Constant((0.48, 0.83, 0.53)))
        rng = np.random.default_rng(5)
        for i in range(12):
            for j in range(12):
                b.add(ir.Box((-6.0 + i, 0.0, -6.0 + j),
                             (-5.0 + i, 0.1 + 2.0 * rng.random(), -5.0 + j),
                             gm))
        b.add(ir.Sphere((0, 6, 0), 1.0,
                        ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 5.0)),
              light=True)
        cam = build_camera(look_from=(0, 4, 9), look_at=(0, 0, 0), fov=50,
                           width=cfg.width, height=cfg.height)
        return b.compile(), cam, cfg, 7

    out["boxfield"] = boxfield_entry

    # the mesh scene again, forced through the Pallas mesh kernel
    # (ops/mesh_kernel.py; interpret mode on a CPU), so the GPU route and its
    # tile-mode regen shuffle have a radiance anchor of their own
    out["mesh-kernel"] = lambda: mesh_entry(mesh_pallas="force")
    return out


def render_anchor(name: str) -> np.ndarray:
    from raysnail_tpu.render import render

    scene, camera, cfg, seed = golden_configs()[name]()
    return render(scene, camera, cfg, seed=seed)


def anchor_stats(img: np.ndarray) -> dict:
    """Block-mean thumbnail + global stats for one render."""
    h, w, _ = img.shape
    hb, wb = h // BLOCK, w // BLOCK
    thumb = (
        img[: hb * BLOCK, : wb * BLOCK]
        .reshape(hb, BLOCK, wb, BLOCK, 3)
        .mean(axis=(1, 3))
        .astype(np.float32)
    )
    return {
        "thumb": thumb,
        "mean": img.mean(axis=(0, 1)).astype(np.float32),
        "std": img.std(axis=(0, 1)).astype(np.float32),
    }


def load_golden() -> dict:
    """-> {name: stats dict} from the committed archive."""
    data = np.load(GOLDEN_PATH)
    names = sorted({k.split("/")[0] for k in data.files})
    return {
        n: {f: data[f"{n}/{f}"] for f in ("thumb", "mean", "std")}
        for n in names
    }


def check_anchor(name: str, golden: dict, thumb_atol: float = 0.01,
                 mean_atol: float = 0.003) -> dict:
    """Render `name` and compare to its committed stats. Returns the fresh
    stats; raises AssertionError with a diagnostic on drift."""
    img = render_anchor(name)
    fresh = anchor_stats(img)
    ref = golden[name]
    dmean = np.abs(fresh["mean"] - ref["mean"]).max()
    dthumb = np.abs(fresh["thumb"] - ref["thumb"]).max()
    assert fresh["thumb"].shape == ref["thumb"].shape, (
        f"{name}: thumbnail shape changed {fresh['thumb'].shape} vs {ref['thumb'].shape}")
    assert dmean <= mean_atol, (
        f"{name}: global mean drifted by {dmean:.5f} (> {mean_atol}); "
        f"fresh {fresh['mean']} vs golden {ref['mean']}")
    assert dthumb <= thumb_atol, (
        f"{name}: thumbnail drifted by {dthumb:.5f} (> {thumb_atol})")
    return fresh
