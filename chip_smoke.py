"""End-to-end check that the renderer runs on an NVIDIA GPU.

    python chip_smoke.py               # one card: every phase below
    python chip_smoke.py --multichip   # four cards: the sharded phases only

One process drives the card(s). Each phase checks its results against a
reference at a stated tolerance and raises on failure; the last line of
standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
printed only when every phase passed. With no GPU the script exits non-zero
and prints no result. Times and rates on the way are informational, each
printed beside the card's name and power limit.

Phases on one card:
  0 device     every JAX device is a GPU; nvidia-smi name and power limit
  1 canonical  sdl/example.sdl 800x500@65spp depth 8 through cli.main,
               against the scan integrator on the card
  2 golden     every golden anchor at its committed CPU statistics
  3 mesh       the mesh kernel against the XLA walk at 205k triangles, then
               mesh-200k end to end on both routes
  4 book2      book2 400x400@25spp; material/texture table fetches as plain
               gathers against one-hot selects (example.sdl and book2)
  5 gradients  two make_train_step steps at 800x500@64spp; one parameter
               against a finite difference at a small size
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
TMIN, TMAX = 1e-3, 3e4   # RenderConfig's t_min / t_max
# workload sizes (RenderConfig fields); the mesh is torus_knot(1600, 64)
CANON = dict(width=800, height=500, samples=65, max_depth=8)
MESH = dict(width=320, height=200, samples=16, max_depth=6)
KNOT = (1600, 64)
BOOK2 = dict(width=400, height=400, samples=25, max_depth=8)
BOUNCE_SPP = 8           # cells per pixel of the primaries-plus-bounce set


def log(*a):
    print(*a, flush=True)


def card() -> str:
    """'<name>, <power limit>' as nvidia-smi reports the first card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def _timed(fn, reps: int = 2):
    """-> (first-call seconds, best steady seconds, last output); every
    call ends in block_until_ready."""
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn())
        best = min(best, time.perf_counter() - t0)
    return first, best, out


def phase_device(count: int = 1) -> dict:
    import jax

    devs = jax.devices()
    bad = [d for d in devs if d.platform != "gpu"]
    if bad or len(devs) < count:
        raise RuntimeError(f"need {count} GPU(s), JAX sees {devs}")
    return {"card": card(), "kind": devs[0].device_kind, "count": len(devs)}


def _example(cfg):
    from raysnail_tpu.sdl import build_scene

    return build_scene(os.path.join(REPO, "sdl", "example.sdl"), cfg)


def phase_canonical() -> dict:
    """cli.main renders the canonical frame (path regeneration); the same
    frame from the scan integrator on the card must agree (_agree)."""
    import jax
    from PIL import Image

    from raysnail_tpu import cli
    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.prelude import color as colorlib
    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.render import make_frame_step, render, render_passes

    cfg = RenderConfig(**CANON)
    with tempfile.TemporaryDirectory() as tmp:
        out_png = os.path.join(tmp, "out.png")
        rc = cli.main(["--scene", os.path.join(REPO, "sdl", "example.sdl"),
                       "-w", str(cfg.width), "--height", str(cfg.height),
                       "--samples", str(cfg.samples),
                       "--depth", str(cfg.max_depth), "-o", out_png])
        assert rc == 0, rc
        png = np.asarray(Image.open(out_png).convert("RGB"))
    scene, cam = _example(cfg)
    img = render_passes(scene, cam, cfg, seed=0)
    assert img.shape == (cfg.height, cfg.width, 3) and np.isfinite(img).all()
    lsb = np.abs(colorlib.to_u8(img).astype(int) - png.astype(int)).max()
    assert lsb <= 1, f"cli PNG differs from render_passes by {lsb} LSB"

    with jax.default_matmul_precision("highest"):
        scan = render(scene, cam, cfg.replace(path_regen="never"), seed=0)
    vs_scan = _agree(img, scan)

    frame = make_frame_step(scene, cfg)
    first, steady, _ = _timed(lambda: frame(scene.arrays, cam, prng.key(0)))
    rays = cfg.width * cfg.height * cfg.effective_samples
    return {"png_vs_render_lsb": int(lsb), "vs_scan": vs_scan,
            "first_s": first, "steady_s": steady,
            "mrays_per_s": rays / steady / 1e6}


def phase_golden() -> dict:
    """Every golden anchor rendered on the card against its committed CPU
    statistics (utils/golden.py): global mean within the committed 0.003;
    8x8 thumbnail blocks within the committed 0.01, except at most one
    block in fifty, none beyond 0.05. The exception is for single paths
    that branch the other way on the card: an f32 decision that turns on
    the last bits (a distance-estimator threshold at a silhouette) moves
    one 4-spp block by up to ~0.02, while an estimator fault moves most
    blocks."""
    from raysnail_tpu.utils import golden

    ref = golden.load_golden()
    names = sorted(golden.golden_configs())
    assert sorted(ref) == names, (sorted(ref), names)
    out = {}
    for name in names:
        fresh = golden.anchor_stats(golden.render_anchor(name))
        dmean = float(np.abs(fresh["mean"] - ref[name]["mean"]).max())
        block = np.abs(fresh["thumb"] - ref[name]["thumb"]).max(-1)
        n_off = int((block > 0.01).sum())
        out[name] = {"mean": dmean, "thumb_max": float(block.max()),
                     "blocks_off": n_off, "blocks": int(block.size)}
        assert dmean <= 0.003, (name, out[name])
        assert n_off <= block.size // 50 and block.max() <= 0.05, (
            name, out[name])
    return out


def _mesh200k():
    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.scenes.meshes import knot_camera, knot_scene

    cfg = RenderConfig(**MESH)
    return (knot_scene(*KNOT).compile(), knot_camera(cfg.width, cfg.height),
            cfg)


def _mesh_rays(cam, spp: int, hits=None, seed: int = 7):
    """Camera primaries of the mesh frame, spp cells per pixel; with
    `hits` = (t, normal, valid) of those primaries, one diffuse bounce each
    instead (rays that missed go out from 5 units along the primary)."""
    import jax.numpy as jnp

    from raysnail_tpu.camera import Ray, generate_rays
    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.prelude.vec import Vec3

    w, h = MESH["width"], MESH["height"]
    pix = np.arange(w * h)
    px = np.tile(pix % w, spp).astype(np.float32)
    py = np.tile(pix // w, spp).astype(np.float32)
    sid = np.repeat(np.arange(spp), w * h)
    sq = int(np.ceil(np.sqrt(spp)))
    keys = prng.fold_all(prng.fast_streams(prng.key(seed),
                                           jnp.asarray(np.tile(pix, spp))),
                         jnp.asarray(sid, jnp.int32))
    ray = generate_rays(cam, jnp.asarray(px), jnp.asarray(py),
                        jnp.asarray((sid % sq).astype(np.float32)),
                        jnp.asarray((sid // sq).astype(np.float32)),
                        sq, w, h, keys)
    if hits is None:
        return ray
    t, nrm, valid = hits
    o = np.asarray(ray.origin.to_array(), np.float64)
    d = np.asarray(ray.direction.to_array(), np.float64)
    t = np.where(valid, np.asarray(t), 5.0)
    p = o + d * t[:, None]
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(p.shape)
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    nb = np.where(valid[:, None], np.asarray(nrm.to_array()), 0.0) + u
    nb /= np.maximum(np.linalg.norm(nb, axis=1, keepdims=True), 1e-9)
    p = p + 1e-3 * nb
    f32 = lambda a: Vec3.from_array(jnp.asarray(a, jnp.float32))
    return Ray(origin=f32(p), direction=f32(nb), time=ray.time)


def _compare_walks(group, ray) -> dict:
    """Kernel against the full-length XLA walk: hit/miss agrees on >= 99.99%
    of rays; where both hit, t to a relative 1e-4; triangle ids equal
    except on ties (different ids at the same t, relative 1e-4)."""
    import jax

    from raysnail_tpu.geometry import triangles
    from raysnail_tpu.ops import mesh_kernel

    n_nodes = int(group.first.shape[0])
    kern = jax.jit(lambda r: mesh_kernel.traverse(
        group, r.origin, r.direction,
        jax.numpy.full(r.origin.x.shape, 1e30, jax.numpy.float32),
        t_min=TMIN, t_max=TMAX))
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda r: triangles.walk(group, r, TMIN, TMAX,
                                               max_iters=n_nodes))
        k_first, k_s, (tk, ik, _, _) = _timed(lambda: kern(ray))
        r_first, r_s, (tr, ir_, _, _) = _timed(lambda: ref(ray), reps=1)
    tk, ik, tr, ir_ = map(np.asarray, (tk, ik, tr, ir_))
    vk, vr = tk < 1e29, tr < 1e29
    agree = float((vk == vr).mean())
    both = vk & vr
    rel = np.abs(tk[both] - tr[both]) / np.maximum(np.abs(tr[both]), 1e-6)
    id_diff = both & (ik != ir_)
    ties_ok = bool((rel[id_diff[both]] <= 1e-4).all())
    assert agree >= 0.9999, agree
    assert rel.max(initial=0.0) <= 1e-4, rel.max()
    assert ties_ok
    return {"rays": int(tk.size), "hit_frac": float(vr.mean()),
            "agree": agree, "t_rel_max": float(rel.max(initial=0.0)),
            "id_ties": int(id_diff.sum()),
            "kernel_s": k_s, "walk_s": r_s, "kernel_first_s": k_first}


def phase_mesh() -> dict:
    import jax

    from raysnail_tpu.geometry import triangles
    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.render import make_frame_step

    scene, cam, cfg = _mesh200k()
    group = scene.arrays.triangles
    out = {"triangles": int((np.asarray(group.mat_id) != -2).sum()),
           "nodes": int(group.first.shape[0])}
    prim = _mesh_rays(cam, 1)
    out["frame_lanes"] = _compare_walks(group, prim)
    prim8 = _mesh_rays(cam, BOUNCE_SPP)
    h = jax.jit(lambda r: triangles.intersect(
        group, r, TMIN, TMAX, max_iters=out["nodes"]))(prim8)
    bounce = _mesh_rays(cam, BOUNCE_SPP,
                        hits=(h.t, h.normal, np.asarray(h.valid)))
    both = jax.tree_util.tree_map(lambda a, b: jax.numpy.concatenate([a, b]),
                                  prim8, bounce)
    out["primaries_plus_bounce"] = _compare_walks(group, both)

    rays = cfg.width * cfg.height * cfg.effective_samples
    for route in ("auto", "never"):
        c = cfg.replace(mesh_pallas=route)
        frame = make_frame_step(scene, c)
        first, steady, acc = _timed(
            lambda: frame(scene.arrays, cam, prng.key(7)))
        assert np.isfinite(np.asarray(acc.x)).all()
        out[f"render_{route}"] = {"first_s": first, "steady_s": steady,
                                  "mrays_per_s": rays / steady / 1e6}
    return out


def _onehot_take(table, idx):
    from raysnail_tpu.geometry import hit as hitlib

    return hitlib.select_table(hitlib.onehot_of(idx, table.shape[0]), table)


def phase_book2() -> dict:
    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.geometry import hit as hitlib
    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.render import make_frame_step, render
    from raysnail_tpu.scenes import book2

    cfg = RenderConfig(**BOOK2)
    scene = book2.all_feature_scene(7).compile()
    cam = book2.book2_camera(cfg.width, cfg.height)
    t0 = time.perf_counter()
    img = render(scene, cam, cfg, seed=7)
    out = {"render_s": time.perf_counter() - t0}
    assert img.shape == (cfg.height, cfg.width, 3) and np.isfinite(img).all()
    assert 0.05 < float(img.mean()) < 0.95, img.mean()

    canon = RenderConfig(**CANON)
    cases = {"example.sdl": (*_example(canon), canon),
             "book2": (scene, cam, cfg)}
    gather = hitlib.take_table
    for name, (sc, cm, c) in cases.items():
        rays = c.width * c.height * c.effective_samples
        for variant, take in (("gather", gather), ("onehot", _onehot_take)):
            hitlib.take_table = take
            try:
                frame = make_frame_step(sc, c)
                _, steady, _ = _timed(lambda: frame(sc.arrays, cm,
                                                    prng.key(7)))
            finally:
                hitlib.take_table = gather
            out[f"{name}_{variant}"] = {"steady_s": steady,
                                        "mrays_per_s": rays / steady / 1e6}
    return out


def phase_gradients() -> dict:
    """Two train steps on the canonical frame: loss and updated parameters
    finite. Then d(mean image)/d(albedo) against a central finite
    difference (same RNG streams) at 24x16@16spp: relative 2e-2."""
    import jax
    import jax.numpy as jnp

    from raysnail_tpu import ir
    from raysnail_tpu.camera import build_camera
    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.diff import extract_params, make_train_step
    from raysnail_tpu.diff.train import render_image_diff
    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.prelude.vec import Vec3
    from raysnail_tpu.scene import SceneBuilder

    cfg = RenderConfig(**CANON)
    scene, cam = _example(cfg)
    target = jnp.zeros((cfg.height, cfg.width, 3), jnp.float32)
    step, opt_state, params = make_train_step(scene, cam, cfg, target)
    ids = jnp.arange(cfg.effective_samples, dtype=jnp.int32)
    key = jax.random.PRNGKey(0)
    times, losses = [], []
    for i in range(2):
        t0 = time.perf_counter()
        params, opt_state, loss = jax.block_until_ready(
            step(params, opt_state, jax.random.fold_in(key, i), ids))
        times.append(time.perf_counter() - t0)
        losses.append(float(loss))
    assert np.isfinite(losses).all(), losses
    assert all(np.isfinite(np.asarray(a)).all()
               for a in jax.tree_util.tree_leaves(params))

    small = RenderConfig(width=24, height=16, samples=16, max_depth=4)
    b = SceneBuilder()
    b.add(ir.Sphere((0.0, -100.5, -1.0), 100.0,
                    ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.add(ir.Sphere((0.0, 0.0, -1.0), 0.5,
                    ir.Lambertian(ir.Constant((0.6, 0.3, 0.2)))))
    b.add(ir.Sphere((2.0, 2.0, 0.0), 0.7,
                    ir.DiffuseLight(ir.Constant((1.0, 1.0, 1.0)), 4.0)),
          light=True)
    b.set_background((0.1, 0.1, 0.1))
    sc = b.compile()
    cm = build_camera(look_from=(0, 0, 1), look_at=(0, 0, -1), fov=50,
                      width=small.width, height=small.height)
    p0 = extract_params(sc.arrays)
    sids = jnp.arange(small.effective_samples, dtype=jnp.int32)

    def scalar_out(p):
        img = render_image_diff(sc, cm, small, p, prng.key(0), sids)
        return jnp.mean(img.x + img.y + img.z)

    row = int(np.argmin(np.abs(np.asarray(p0.tex_color1.x) - 0.6)))
    with jax.default_matmul_precision("highest"):
        ad = float(jax.grad(scalar_out)(p0).tex_color1.x[row])
        eps = 1e-2
        shift = lambda dlt: p0._replace(tex_color1=Vec3(
            p0.tex_color1.x.at[row].add(dlt), p0.tex_color1.y,
            p0.tex_color1.z))
        fd = float((scalar_out(shift(eps)) - scalar_out(shift(-eps)))
                   / (2 * eps))
    assert abs(ad) > 1e-6 and abs(ad - fd) <= 2e-2 * abs(fd) + 1e-5, (ad, fd)
    return {"losses": losses, "step_s": times, "grad": ad, "fd": fd}


# -- four cards -------------------------------------------------------------

def _agree(img, ref) -> dict:
    """Two renders of one frame with identical (seed, pixel, sample, bounce)
    keys, summed in another order: mean |diff| <= 1e-5 and at most 0.1% of
    pixel channels off by more than 1e-3 (a path whose f32 branch turns on
    the last bits may take the other way)."""
    diff = np.abs(img - ref)
    out = {"mean_abs": float(diff.mean()), "max_abs": float(diff.max()),
           "frac_gt_1e-3": float((diff > 1e-3).mean())}
    assert np.isfinite(img).all(), out
    assert out["mean_abs"] <= 1e-5 and out["frac_gt_1e-3"] <= 1e-3, out
    return out


def phase_sharded_render() -> dict:
    """render_sharded on a 2x2 mesh against the same call on a one-card
    mesh (_agree)."""
    import jax

    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.parallel import make_mesh, render_sharded

    cfg = RenderConfig(**CANON)
    scene, cam = _example(cfg)
    one = make_mesh(1, 1, devices=jax.devices()[:1])
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    t0 = time.perf_counter()
    ref = render_sharded(scene, cam, cfg, one, seed=0)
    t1 = time.perf_counter()
    img = render_sharded(scene, cam, cfg, mesh, seed=0)
    t2 = time.perf_counter()
    return {**_agree(img, ref), "one_card_first_s": t1 - t0,
            "mesh_2x2_first_s": t2 - t1}


def phase_sharded_train() -> dict:
    """One make_sharded_train_step step (2x2 mesh) against make_train_step
    (one card), both with SGD at learning rate 1e3 so the update recovers
    the gradient. Loss and gradients (max and L2 norm of the difference
    over those of the one-card gradient) to a relative 1e-4."""
    import jax
    import jax.numpy as jnp
    import optax

    from raysnail_tpu.config import RenderConfig
    from raysnail_tpu.diff import make_train_step
    from raysnail_tpu.parallel import make_mesh, make_sharded_train_step

    lr = 1e3
    cfg = RenderConfig(**CANON)
    scene, cam = _example(cfg)
    target = jnp.full((cfg.height, cfg.width, 3), 0.25, jnp.float32)
    key = jax.random.PRNGKey(0)
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    sstep, sopt, p0 = make_sharded_train_step(scene, cam, cfg, target, mesh,
                                              optimizer=optax.sgd(lr))
    p_s, _, loss_s = jax.block_until_ready(sstep(p0, sopt, key))
    with jax.default_device(jax.devices()[0]):
        step, opt, q0 = make_train_step(scene, cam, cfg, target,
                                        optimizer=optax.sgd(lr))
        ids = jnp.arange(cfg.effective_samples, dtype=jnp.int32)
        p_1, _, loss_1 = jax.block_until_ready(step(q0, opt, key, ids))
    grads = lambda p: np.concatenate([
        (np.asarray(a, np.float64) - np.asarray(b, np.float64)).ravel() / lr
        for a, b in zip(jax.tree_util.tree_leaves(p0),
                        jax.tree_util.tree_leaves(p))])
    g_s, g_1 = grads(p_s), grads(p_1)
    out = {"loss_sharded": float(loss_s), "loss_one": float(loss_1),
           "rel_loss": abs(float(loss_s) - float(loss_1)) / abs(float(loss_1)),
           "rel_grad_max": float(np.abs(g_s - g_1).max() / np.abs(g_1).max()),
           "rel_grad_l2": float(np.linalg.norm(g_s - g_1)
                                / np.linalg.norm(g_1))}
    log(f"  sharded_train: {json.dumps(out)}")
    assert out["rel_loss"] <= 1e-4, out
    assert out["rel_grad_max"] <= 1e-4 and out["rel_grad_l2"] <= 1e-4, out
    return out


def phase_sharded_mesh() -> dict:
    """mesh-200k through the mesh kernel under shard_map (2x2 mesh) against
    the one-card frame (_agree)."""
    import jax

    from raysnail_tpu.parallel import make_mesh, render_sharded

    scene, cam, cfg = _mesh200k()
    one = make_mesh(1, 1, devices=jax.devices()[:1])
    mesh = make_mesh(2, 2, devices=jax.devices()[:4])
    ref = render_sharded(scene, cam, cfg, one, seed=7)
    img = render_sharded(scene, cam, cfg, mesh, seed=7)
    return _agree(img, ref)


ONE_CARD = (("canonical", phase_canonical), ("golden", phase_golden),
            ("mesh", phase_mesh), ("book2", phase_book2),
            ("gradients", phase_gradients))
FOUR_CARDS = (("sharded_render", phase_sharded_render),
              ("sharded_train", phase_sharded_train),
              ("sharded_mesh", phase_sharded_mesh))


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    multichip = "--multichip" in argv
    import jax

    info = phase_device(4 if multichip else 1)
    log(f"card: {info['card']}")
    log(f"device: {info['kind']} x{info['count']}")

    from raysnail_tpu.utils.cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    for name, phase in (FOUR_CARDS if multichip else ONE_CARD):
        t0 = time.perf_counter()
        res = phase()
        log(f"phase {name}: ok in {time.perf_counter() - t0:.1f} s "
            f"[{info['card']}] {json.dumps(res)}")
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
