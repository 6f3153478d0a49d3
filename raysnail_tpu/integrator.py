"""The wavefront path-tracing integrator.

Replicates the reference's recursive `ray_color` (src/camera.rs:156-255) as an
iterative bounce loop (lax.scan over the depth budget) over a dense ray batch
with masked lanes instead of recursion — rays that die keep flowing with
alive=False (static shapes; divergence costs masked elementwise work, not
control flow).

Estimator (compat path, the default — camera.rs:194-247):
  * emitted term added every bounce (before scattering);
  * skip_pdf materials (metal, dielectric): follow the specular ray,
    throughput *= albedo;
  * otherwise a 50/50 branch:
      - light branch: direction toward a random light, denominator pdf
        HARDCODED to 1/pi (camera.rs:199), shadow origin backed off along the
        incoming ray by shadow_eps (camera.rs:208-212), optional phong
        highlight multiplier (camera.rs:199-206);
      - BSDF branch: sample the material's pdf; numerator == denominator so
        the weight is exactly 1 (camera.rs:216-218, 240-242);
    weight = pdf.value(dir) / pdf_val with the reference's <=0/NaN clamp of
    the denominator to 1e-5 (camera.rs:236-238).
  * miss -> background gradient, ray dies (camera.rs:254).

A physically-correct one-sample MIS estimator is available behind
cfg.proper_mis (weights 0.5*(p_light + p_bsdf) in the denominator with the
true light solid-angle pdf) — OFF by default for reference parity.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raysnail_tpu import lights as lightslib
from raysnail_tpu import materials as matlib
from raysnail_tpu import scene as scenelib
from raysnail_tpu import textures as texlib
from raysnail_tpu.camera import Ray
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.prelude.sampling import PI
from raysnail_tpu.prelude.vec import Vec3

def _slot_layout(kinds: frozenset, has_lights: bool, mix_depth: int = 1):
    """Per-bounce uniform slots, allocated only for the material/light kinds
    the scene actually contains — RNG is a first-order cost, so a pure
    Lambertian scene draws 6 uniforms per bounce instead of 17.
    Nested Mixed materials draw one independent uniform per nesting level
    (mixed_material.rs:41-50 recurses, drawing fresh randomness per level)."""
    idx = {}
    n = 0
    if matlib.MIXED in kinds:
        idx["mix"] = n; n += mix_depth
    if has_lights:
        idx["branch"], idx["pick"], idx["l1"], idx["l2"] = n, n + 1, n + 2, n + 3
        n += 4
    if matlib.DIELECTRIC in kinds:
        idx["refl"] = n; n += 1
    idx["bsdf"] = n
    n += 2  # base cosine / sphere sample
    if (matlib.DIFFUSE_METAL in kinds) or (matlib.BLINN_PHONG in kinds):
        n += 2 * matlib.REJECT_TRIES
    if matlib.BLINN_PHONG in kinds:
        n += 1
    return idx, n


def radiance(scene: scenelib.Scene, arrays: scenelib.SceneArrays,
             cfg: RenderConfig, ray: Ray, keys) -> Vec3:
    """Per-ray radiance estimate after up to cfg.max_depth bounces.
    `keys` is the per-ray key batch (N, ...): every draw folds in the bounce
    index and a purpose tag, so the estimate for a given (pixel, sample) is
    independent of batch tiling and mesh sharding."""
    return radiance_and_alive(scene, arrays, cfg, ray, keys)[0]


# Scattered rays start SURFACE_EPS * max(1, |p|) off the surface (see
# _make_shade); the reference's f64 needs no such offset.
SURFACE_EPS = 1e-5

# Traversal route of each primitive group kind, keyed by the real backend.
# Only triangle meshes have a hand-written kernel (ops/mesh_kernel.py, Pallas
# through Triton), and only on a GPU; box and sphere groups of any size take
# their dense XLA sweeps everywhere.
ROUTES = {
    "gpu": {"mesh": "kernel", "boxes": "dense", "spheres": "dense"},
    "cpu": {"mesh": "xla", "boxes": "dense", "spheres": "dense"},
}


def routes(cfg: RenderConfig, backend: str) -> dict:
    """Group kind -> traversal route on `backend` under cfg.mesh_pallas:
    "kernel" (compiled), "interpret" (the kernel in Pallas interpret mode,
    CPU tests only), "xla" (the XLA walk or dense sweep) or "dense"."""
    if backend not in ROUTES:
        raise ValueError(f"no traversal routes for backend {backend!r}")
    out = dict(ROUTES[backend])
    if cfg.mesh_pallas == "never":
        out["mesh"] = "xla"
    elif cfg.mesh_pallas == "force":
        out["mesh"] = "interpret" if backend == "cpu" else "kernel"
    elif cfg.mesh_pallas != "auto":
        raise ValueError(f"mesh_pallas must be auto|never|force, "
                         f"got {cfg.mesh_pallas!r}")
    return out


def _pallas_policy(cfg: RenderConfig, backend: str | None = None) -> dict:
    """Kernel-routing flags for scenelib.intersect on `backend` (default:
    the backend JAX computes on)."""
    mesh = routes(cfg, backend or jax.default_backend())["mesh"]
    return dict(mesh_kernel=mesh in ("kernel", "interpret"),
                mesh_interpret=mesh == "interpret")


def _make_shade(scene: scenelib.Scene, cfg: RenderConfig, policy: dict):
    """One bounce of the estimator, shared by the scan integrator
    (radiance_and_alive) and the path-regeneration integrator
    (radiance_regen): (arrays, ray, T, L, alive, kb) ->
    (new_o, new_d, T, L, alive). Dead lanes keep their incoming ray state."""
    static = scene.static
    kinds = static.mat_kinds
    slot, n_uniforms = _slot_layout(kinds, static.has_lights, static.mix_depth)

    def shade(arrays, r: Ray, T, L, alive, kb):
        o, d = r.origin, r.direction
        shape = jnp.shape(d.x)
        hit = scenelib.intersect(scene, arrays, r, cfg.t_min, cfg.t_max, kb,
                                 active=alive, **policy)

        # miss -> background, die (camera.rs:254)
        bg = arrays.background.color(d)
        missed = alive & (~hit.valid)
        L = L + Vec3.where(missed, T * bg, Vec3.zeros(shape, T.dtype))

        u = prng.ray_uniforms(prng.fold_all(kb, prng.SCATTER), n_uniforms)

        if matlib.MIXED in kinds:
            mat_id = matlib.resolve(
                arrays.materials, hit.mat_id,
                u[slot["mix"]:slot["mix"] + static.mix_depth],
                depth=static.mix_depth)
        else:
            mat_id = jnp.where(hit.mat_id < 0, 0, hit.mat_id)
        rows = matlib.gather(arrays.materials, mat_id)
        p = o + d * hit.t
        tex_color = texlib.evaluate(
            arrays.textures, rows.tex_id, hit.u, hit.v, p, static.tex_modes
        )

        active = alive & hit.valid
        emit = matlib.emitted(rows, tex_color)
        L = L + Vec3.where(active, T * emit, Vec3.zeros(shape, T.dtype))

        if static.has_absorb:
            # EXTENSION (off unless a Dielectric sets `absorption`): the
            # segment that just ended INSIDE a dielectric (back-face hit,
            # outside=False) attenuates by Beer-Lambert exp(-sigma * t)
            sigma = matlib.gather_absorb(arrays.materials, mat_id)
            interior = active & (~hit.outside) & (rows.mtype == matlib.DIELECTRIC)
            att = (sigma * (-hit.t)).map(jnp.exp)
            T = Vec3.where(interior, T * att, T)

        # -- specular (skip_pdf) path ------------------------------------
        skip = matlib.is_skip_pdf(rows)
        u_refl = u[slot["refl"]] if "refl" in slot else hit.t  # unused if absent
        spec_dir, absorbed = matlib.specular_dir(
            rows, d, hit.normal, hit.outside, u_refl, kinds
        )

        # -- pdf path ------------------------------------------------------
        bsdf_dir = matlib.bsdf_sample(rows, d, hit.normal, u[slot["bsdf"]:], kinds)
        if static.has_lights:
            sampler = lightslib.sample_proper if cfg.proper_mis else lightslib.sample
            light_raw = sampler(
                arrays.lights, p, u[slot["pick"]], u[slot["l1"]], u[slot["l2"]],
                static.light_kinds
            )
            light_dir = light_raw.unit()
            use_light = u[slot["branch"]] < cfg.light_sample_prob
            light_multi = matlib.phong_highlight(light_dir, d, hit.normal, rows)
        else:
            light_dir = bsdf_dir
            use_light = jnp.zeros(shape, bool)
            light_multi = jnp.ones(shape, T.dtype)

        pdf_dir = Vec3.where(use_light, light_dir, bsdf_dir)
        val = matlib.bsdf_pdf_value(rows, d, hit.normal, pdf_dir, kinds,
                                    proper=cfg.proper_mis)

        if cfg.proper_mis and static.has_lights:
            # one-sample MIS: denominator = the true mixture density of the
            # combined sampler, with the real solid-angle light pdf
            p_light = lightslib.pdf_value(arrays.lights, p, pdf_dir, static.light_kinds)
            denom = (
                cfg.light_sample_prob * p_light
                + (1.0 - cfg.light_sample_prob) * val
            )
        else:
            # compat: light branch denominator hardcoded to 1/pi
            denom = jnp.where(use_light, 1.0 / PI, val)
        denom = jnp.where((denom <= 0.0) | jnp.isnan(denom), 1e-5, denom)
        weight = val / denom
        multi = jnp.where(use_light, light_multi, 1.0)

        new_d = Vec3.where(skip, spec_dir, pdf_dir)
        # the light branch starts from the reference's shadow back-off
        # along the incoming ray (camera.rs:208-212), the others from p.
        # Either way the new ray then starts SURFACE_EPS * max(1, |p|) off
        # the surface, on the side it leaves by: in f32 a ray started on
        # the surface can re-hit it just past t_min (grazing rays at scene
        # scales of ~1e3), a self-hit whose outcome turns on the last bits
        # of p.
        start = Vec3.where(use_light & ~skip,
                           o + d * (hit.t - cfg.shadow_eps), p)
        side = jnp.where(new_d.dot(hit.normal) < 0.0, -1.0, 1.0)
        scale = jnp.maximum(1.0, jnp.maximum(jnp.maximum(
            jnp.abs(p.x), jnp.abs(p.y)), jnp.abs(p.z)))
        new_o = start + hit.normal * (side * SURFACE_EPS * scale)
        t_mult = jnp.where(skip, 1.0, weight * multi)
        T = Vec3.where(active, T * tex_color * t_mult, T)

        scatters = rows.mtype != matlib.DIFFUSE_LIGHT
        alive = active & scatters & ~(skip & absorbed)

        o = Vec3.where(alive, new_o, o)
        d = Vec3.where(alive, new_d, d)
        return o, d, T, L, alive

    return shade


def radiance_and_alive(scene: scenelib.Scene, arrays: scenelib.SceneArrays,
                       cfg: RenderConfig, ray: Ray, keys):
    """radiance() plus the per-bounce live-lane counts (max_depth,) int32 —
    the occupancy diagnostic behind scripts/alive_stats.py's dead-lane
    analysis (DCE'd by XLA when the caller ignores it)."""
    shape = jnp.shape(ray.direction.x)
    shade = _make_shade(scene, cfg, _pallas_policy(cfg))

    def bounce(carry, b):
        # NOTE: no per-bounce live-lane compaction ("wavefront sort"): the
        # path-regeneration integrator below solves the same occupancy
        # problem without any data movement.
        o, d, time, T, L, alive = carry
        kb = prng.fold_all(keys, b)
        o, d, T, L, alive = shade(
            arrays, Ray(origin=o, direction=d, time=time), T, L, alive, kb)
        n_alive = jnp.sum(alive, dtype=jnp.int32)
        return (o, d, time, T, L, alive), n_alive

    init = (
        ray.origin, ray.direction, ray.time,
        Vec3.ones(shape, ray.direction.x.dtype),
        Vec3.zeros(shape, ray.direction.x.dtype),
        jnp.ones(shape, bool),
    )
    body = bounce
    if cfg.remat_bounces:
        # reverse-mode stores only the per-bounce carries (o,d,T,L,alive ~13
        # floats/ray) and recomputes the bounce body — an order of magnitude
        # less residual memory, which is what bounds fwd+bwd batch sizes
        body = jax.checkpoint(bounce)
    out_carry, alive_counts = jax.lax.scan(body, init, jnp.arange(cfg.max_depth))
    L = out_carry[4]
    # rays still alive after the budget contribute nothing (camera.rs:161-163)
    return L, alive_counts


def radiance_regen(scene: scenelib.Scene, arrays: scenelib.SceneArrays,
                   cfg: RenderConfig, camera, px, py, keys0, s0, n_samples: int):
    """Path-REGENERATION integrator: radiance SUMS over stratification cells
    [s0, s0 + n_samples) for each pixel lane.

    The scan integrator's bounce loop runs at ~27-35% live-lane occupancy
    (scripts/alive_stats.py): most paths die after 1-2 bounces but the
    remaining depth budget still executes as masked elementwise work, and
    every sample restarts the full-width loop. Here each lane owns ONE pixel and,
    the moment its path dies, starts the pixel's next sample in place —
    one lax.while_loop whose trip count is the worst lane's TOTAL path
    length over its samples instead of max_depth * spp. No sorts, no
    gathers, no scatters: the classic wavefront-tracer design mapped onto
    XLA static shapes. Draws are keyed by (seed, pixel, sample, bounce)
    exactly like the scan path, so both integrators compute the identical
    estimate (modulo summation order).

    Forward-only (while_loop does not reverse-differentiate — the scan path
    stays the gradient surface) and fast-RNG only (per-lane sample folds are
    one fmix32 round; threefry folds would dominate the body).

    Returns (L_sums, n_iterations)."""
    from raysnail_tpu.camera import generate_rays

    shape = jnp.shape(px)
    dtype = cfg.dtype
    sqrt_spp = cfg.sqrt_spp
    if cfg.max_depth <= 0:  # depth 0 renders black (camera.rs:161-163)
        return Vec3.zeros(shape, dtype), jnp.asarray(0, jnp.int32)
    shade = _make_shade(scene, cfg, _pallas_policy(cfg))
    s_end = jnp.asarray(s0 + n_samples, jnp.int32)

    def new_ray(sid):
        keys_s = prng.fold_all(keys0, sid)
        s_i = (sid % sqrt_spp).astype(dtype)
        s_j = (sid // sqrt_spp).astype(dtype)
        return generate_rays(camera, px, py, s_i, s_j, sqrt_spp,
                             cfg.width, cfg.height, keys_s)

    sid0 = jnp.full(shape, s0, jnp.int32)
    r0 = new_ray(sid0)
    state0 = (
        sid0,
        jnp.zeros(shape, jnp.int32),          # bounce index of current path
        r0.origin, r0.direction, r0.time,
        Vec3.ones(shape, dtype),              # T (current path throughput)
        Vec3.zeros(shape, dtype),             # L (sum over ALL samples)
        jnp.ones(shape, bool),                # current path alive
        jnp.asarray(0, jnp.int32),            # iteration counter (diagnostic)
    )

    def cond(st):
        return jnp.any(st[0] < s_end)

    def body(st):
        sid, b, o, d, time, T, L, alive, it = st
        kb = prng.fold_all(prng.fold_all(keys0, sid), b)
        o, d, T, L, alive2 = shade(
            arrays, Ray(origin=o, direction=d, time=time), T, L, alive, kb)
        # a path at its final bounce contributes nothing more
        # (camera.rs:161-163) — it is done the moment it is shaded
        alive2 = alive2 & (b + 1 < cfg.max_depth)
        done = alive & (~alive2)
        sid = sid + done.astype(jnp.int32)
        regen = done & (sid < s_end)
        # restart: fresh camera ray for the next stratification cell
        rn = new_ray(sid)
        o = Vec3.where(regen, rn.origin, o)
        d = Vec3.where(regen, rn.direction, d)
        time = jnp.where(regen, rn.time, time)
        T = Vec3.where(regen, Vec3.ones(shape, dtype), T)
        b = jnp.where(done, 0, b + 1)
        alive = alive2 | regen
        return sid, b, o, d, time, T, L, alive, it + 1

    out = jax.lax.while_loop(cond, body, state0)
    return out[6], out[8]


def radiance_regen_shuffle(scene: scenelib.Scene, arrays: scenelib.SceneArrays,
                           cfg: RenderConfig, camera, key, spp: int, s0=0,
                           record_lengths: bool = False):
    """Full-frame path regeneration with cross-pixel cell SHUFFLING:
    row-major radiance sums over stratification cells [s0, s0 + spp) —
    s0 may be a traced scalar, so a shard_map'd caller can hand each device
    its own cell range (parallel.make_sharded_frame_step).

    record_lengths=True additionally returns the per-(cell, pixel) PATH
    LENGTHS (spp, W*H) f32 (number of shades each cell's path executed,
    in [1, max_depth]) as a third output — the bucketing signal for the
    truncated-depth VJP scheme (diff/train.py): keys are (seed, pixel,
    sample, bounce) in both integrators, so the scan integrator replays
    the exact same path and its contributions past the recorded length
    are identically zero.

    Plain per-pixel regeneration barely reduces the while_loop trip count
    (480 vs 512 on example.sdl): one worst-case pixel whose paths always run
    the full depth dominates the max over lanes. Here lane i's k-th cell is
    pixel (i + k*stride) mod N — each lane's total path length is a sum over
    C cells of DIFFERENT pixels, which concentrates by the law of large
    numbers and collapses the trip count toward spp * mean_path_length.

    Per-cell radiance lands in a (N, C) column table via a C-wide one-hot
    add (the only extra per-iteration cost, ~3C fma); pixel sums are
    recovered with C static jnp.rolls — no gathers or scatters anywhere.
    Draws stay keyed by (seed, pixel, sample, bounce), so the estimate is
    identical to the scan/plain-regen integrators, just summed in a
    different lane order.

    Returns (L_sums row-major (N,) Vec3, n_iterations)."""
    from raysnail_tpu.camera import generate_rays

    n_pix = cfg.width * cfg.height
    dtype = cfg.dtype
    sqrt_spp = cfg.sqrt_spp
    if cfg.max_depth <= 0 or spp <= 0:
        out = (Vec3.zeros((n_pix,), dtype), jnp.asarray(0, jnp.int32))
        if record_lengths:
            return out + (jnp.zeros((max(spp, 0), n_pix), dtype),)
        return out
    policy = _pallas_policy(cfg)
    shade = _make_shade(scene, cfg, policy)

    # chunk width: largest divisor of spp <= the cap — wide enough that a
    # lane's chunk mixes many pixels (trip concentration), narrow enough
    # that the per-iteration one-hot add stays a few dozen fma (3C fma) and
    # the (N, C) f32 cell tables stay small. cfg.regen_chunk_cap (retraces
    # when changed) with the env var as the default for perf probes — the
    # env var alone is only read at first trace.
    import os
    cap = cfg.regen_chunk_cap or int(os.environ.get("RAYSNAIL_REGEN_C", "21"))
    C = max(d for d in range(1, min(spp, cap) + 1) if spp % d == 0)
    n_chunks = spp // C

    # On the mesh kernel a block of PKT consecutive lanes walks the BVH
    # together until its slowest lane is done, so blocks should be spatially
    # COHERENT: the plain golden-ratio pixel stride makes consecutive lanes
    # far-apart pixels. There the shuffle rotates at block granularity and
    # lanes decode to PKT-pixel image TILES, so every block stays a tight
    # frustum for all k while a lane's consecutive cells still land on
    # far-apart blocks.
    from raysnail_tpu.ops.mesh_kernel import BLOCK as PKT

    packet_kernel = policy["mesh_kernel"]
    tile = None
    if packet_kernel and n_pix % PKT == 0:
        tile = next(((tw, th) for tw, th in
                     ((16, 8), (8, 16), (32, 4), (4, 32), (64, 2), (128, 1))
                     if cfg.width % tw == 0 and cfg.height % th == 0), None)
    if packet_kernel and n_pix % PKT == 0:
        n_pkt = n_pix // PKT
        S = ((int(n_pkt * 0.6180339887) | 1) % n_pkt) * PKT
    else:
        # golden-ratio stride: a lane's consecutive cells land on far-apart
        # pixels, decorrelating their path lengths
        S = (int(n_pix * 0.6180339887) | 1) % n_pix
    lanes = jnp.arange(n_pix, dtype=jnp.int32)
    cols = jnp.arange(C, dtype=jnp.int32)

    def lane_pixel(k):
        """Rotated lane slot -> (pixel id, px, py); pure arithmetic (no
        gathers inside the while body)."""
        m = (lanes + k * S) % n_pix
        if tile is None:
            p = m
        else:
            tw, th = tile
            tiles_x = cfg.width // tw
            tid, within = m // PKT, m % PKT
            px_i = (tid % tiles_x) * tw + within % tw
            py_i = (tid // tiles_x) * th + within // tw
            p = py_i * cfg.width + px_i
        return p, (p % cfg.width).astype(dtype), (p // cfg.width).astype(dtype)

    def new_ray(k, cs0):
        p, px, py = lane_pixel(k)
        sid = cs0 + k
        keys_s = prng.fold_all(prng.fast_streams(key, p), sid)
        s_i = (sid % sqrt_spp).astype(dtype)
        s_j = (sid // sqrt_spp).astype(dtype)
        r = generate_rays(camera, px, py, s_i, s_j, sqrt_spp,
                          cfg.width, cfg.height, keys_s)
        return r, keys_s

    # sliding-window cell table (cfg.regen_window = W < C): the (N, C) f32
    # radiance tables are carried through every loop iteration. With a
    # window, cells land in column k % W; column r retires into the pixel
    # accumulator by ONE uniform roll (cell r is the same cell index for
    # every lane, so its slot->pixel shift r*S is uniform) as soon as every
    # lane is past it, and a lane stalls only when it would run W cells ahead
    # of the slowest lane (law-of-large-numbers concentration makes that
    # rare at W ~ 6-8).
    # regen_window > 0: window with a lax.cond'd retire; < 0: |W| with an
    # UNCONDITIONAL predicated retire (a cond with large carried buffers may
    # copy its operands)
    W = min(C, abs(cfg.regen_window)) if cfg.regen_window != 0 else C
    pred_retire = cfg.regen_window < 0 and W < C
    colsW = jnp.arange(W, dtype=jnp.int32)

    def chunk(carry, cs0):
        L_pix, it0 = carry
        k0 = jnp.zeros(n_pix, jnp.int32)
        r0, _ = new_ray(k0, cs0)
        zt = jnp.zeros((n_pix, W), dtype)
        st0 = (k0, jnp.zeros(n_pix, jnp.int32),
               r0.origin, r0.direction, r0.time,
               Vec3.ones((n_pix,), dtype),
               zt, zt, zt,
               jnp.ones(n_pix, bool), it0,
               jnp.asarray(0, jnp.int32), L_pix)
        if record_lengths:
            # tl: per-(lane, column) path length, written once at done;
            # lo: per-(cell, pixel) rows, filled as columns retire
            st0 = st0 + (zt, jnp.zeros((C, n_pix), dtype))

        def cond(st):
            return jnp.any(st[0] < C)

        def retire_one(r, tx, ty, tz, L_pix, *rest):
            """Fold column r % W (cell index r, every lane) into the pixel
            accumulator with its uniform slot->pixel roll, zero it, r += 1."""
            col = r % W
            shift = (r * S) % n_pix
            sl = lambda t: jax.lax.dynamic_slice_in_dim(t, col, 1, 1)[:, 0]
            L_pix = L_pix + Vec3(jnp.roll(sl(tx), shift),
                                 jnp.roll(sl(ty), shift),
                                 jnp.roll(sl(tz), shift))
            z = jnp.zeros((n_pix, 1), dtype)
            upd = lambda t: jax.lax.dynamic_update_slice(t, z, (0, col))
            if record_lengths:
                tl, lo = rest
                lo = jax.lax.dynamic_update_slice(
                    lo, jnp.roll(sl(tl), shift)[None, :], (r, 0))
                rest = (upd(tl), lo)
            return (r + 1, upd(tx), upd(ty), upd(tz), L_pix) + rest

        def body(st):
            k, b, o, d, time, T, tx, ty, tz, alive, it, r, L_pix, *rest = st
            p, _, _ = lane_pixel(k)
            keys_s = prng.fold_all(prng.fast_streams(key, p), cs0 + k)
            kb = prng.fold_all(keys_s, b)
            o, d, T, L_add, alive2 = shade(
                arrays, Ray(origin=o, direction=d, time=time), T,
                Vec3.zeros((n_pix,), dtype), alive, kb)
            oh = ((k % W)[:, None] == colsW[None, :]).astype(dtype)  # (N, W)
            tx = tx + oh * L_add.x[:, None]
            ty = ty + oh * L_add.y[:, None]
            tz = tz + oh * L_add.z[:, None]
            alive2 = alive2 & (b + 1 < cfg.max_depth)
            done = alive & (~alive2)
            if record_lengths:
                # the cell that just finished on a done lane ran b+1 shades
                tl, lo = rest
                tl = tl + oh * jnp.where(done, (b + 1).astype(dtype),
                                         0.0)[:, None]
                rest = (tl, lo)
            k = k + done.astype(jnp.int32)
            if W < C and pred_retire:
                # unconditional PREDICATED retire: always read column r % W,
                # roll it, and add/zero under the predicate — only (N,)-sized
                # ops, no cond, no operand copies
                can = (r < jnp.min(k)) & (r < C)
                canf = can.astype(dtype)
                col = r % W
                shift = (r * S) % n_pix
                sl = lambda t: jax.lax.dynamic_slice_in_dim(t, col, 1, 1)[:, 0]
                sx, sy, sz = sl(tx), sl(ty), sl(tz)
                L_pix = L_pix + Vec3(jnp.roll(sx, shift) * canf,
                                     jnp.roll(sy, shift) * canf,
                                     jnp.roll(sz, shift) * canf)
                upd = lambda t, s: jax.lax.dynamic_update_slice(
                    t, jnp.where(can, 0.0, s)[:, None], (0, col))
                tx, ty, tz = upd(tx, sx), upd(ty, sy), upd(tz, sz)
                if record_lengths:
                    tl, lo = rest
                    stl = sl(tl)
                    idx = jnp.minimum(r, C - 1)
                    cur = jax.lax.dynamic_slice(lo, (idx, 0), (1, n_pix))[0]
                    row = jnp.where(can, jnp.roll(stl, shift), cur)
                    lo = jax.lax.dynamic_update_slice(lo, row[None, :],
                                                      (idx, 0))
                    rest = (upd(tl, stl), lo)
                r = r + can.astype(jnp.int32)
                want = (~alive2) & (k < C)
                regen = want & (k < r + W)
            elif W < C:
                # retire at most one column per iteration (the slowest lane
                # gates retirement, so it advances ~1 cell per mean path
                # length anyway); skipped entirely when nothing can retire
                can = (r < jnp.min(k)) & (r < C)
                r, tx, ty, tz, L_pix, *rest = jax.lax.cond(
                    can, retire_one,
                    lambda r, a, bb, c, L, *m: (r, a, bb, c, L) + m,
                    r, tx, ty, tz, L_pix, *rest)
                want = (~alive2) & (k < C)
                regen = want & (k < r + W)
            else:
                regen = done & (k < C)
            rn, _ = new_ray(k, cs0)
            o = Vec3.where(regen, rn.origin, o)
            d = Vec3.where(regen, rn.direction, d)
            time = jnp.where(regen, rn.time, time)
            T = Vec3.where(regen, Vec3.ones((n_pix,), dtype), T)
            b = jnp.where(alive2, b + 1, 0)
            alive = alive2 | regen
            return (k, b, o, d, time, T, tx, ty, tz, alive, it + 1, r,
                    L_pix) + tuple(rest)

        # RAYSNAIL_REGEN_UNROLL=k runs k shade iterations per while trip:
        # probes how much of the canonical body is per-trip cond/scheduling
        # overhead (an extra iteration on an all-finished state is a no-op —
        # nothing regenerates once k >= C, so only the tail is padded)
        unroll = int(os.environ.get("RAYSNAIL_REGEN_UNROLL", "1"))
        if unroll > 1:
            one_iter = body

            def body(st):
                for _ in range(unroll):
                    st = one_iter(st)
                return st

        out = jax.lax.while_loop(cond, body, st0)
        tx, ty, tz, it = out[6], out[7], out[8], out[10]
        r, L_pix = out[11], out[12]
        rest = out[13:]
        lo = rest[1] if record_lengths else None
        if W < C:
            # columns r..C-1 (at most W of them: no lane ever started a cell
            # >= r + W) are still unretired
            for off in range(W):
                j = r + off
                do = j < C
                col = j % W
                sl = lambda t: jax.lax.dynamic_slice_in_dim(t, col, 1, 1)[:, 0]
                shift = (j * S) % n_pix
                zero = jnp.zeros((n_pix,), dtype)
                L_pix = L_pix + Vec3(
                    jnp.where(do, jnp.roll(sl(tx), shift), zero),
                    jnp.where(do, jnp.roll(sl(ty), shift), zero),
                    jnp.where(do, jnp.roll(sl(tz), shift), zero))
                if record_lengths:
                    tl = rest[0]
                    idx = jnp.minimum(j, C - 1)
                    cur = jax.lax.dynamic_slice(lo, (idx, 0), (1, n_pix))[0]
                    row = jnp.where(do, jnp.roll(sl(tl), shift), cur)
                    lo = jax.lax.dynamic_update_slice(lo, row[None, :],
                                                      (idx, 0))
        else:
            # regroup: column k's row i is lane slot (i + k*S) mod N -> roll
            # forward (slot == pixel unless tile mode; see below)
            for k in range(C):
                shift = (k * S) % n_pix
                L_pix = L_pix + Vec3(jnp.roll(tx[:, k], shift),
                                     jnp.roll(ty[:, k], shift),
                                     jnp.roll(tz[:, k], shift))
                if record_lengths:
                    tl = rest[0]
                    lo = jax.lax.dynamic_update_slice(
                        lo, jnp.roll(tl[:, k], shift)[None, :], (k, 0))
        return (L_pix, it), lo

    cs0s = jnp.asarray(s0, jnp.int32) + jnp.arange(n_chunks, dtype=jnp.int32) * C
    (L_pix, it), lens = jax.lax.scan(
        chunk, (Vec3.zeros((n_pix,), dtype), jnp.asarray(0, jnp.int32)), cs0s)
    if tile is not None:
        # slot -> row-major pixel: ONE gather outside all loops
        import numpy as np
        tw, th = tile
        m = np.arange(n_pix)
        tiles_x = cfg.width // tw
        tid, within = m // PKT, m % PKT
        px_i = (tid % tiles_x) * tw + within % tw
        py_i = (tid // tiles_x) * th + within // tw
        slot_pix = py_i * cfg.width + px_i     # pixel id held by slot m
        perm = np.empty(n_pix, np.int32)
        perm[slot_pix] = m                     # slot owning pixel p
        L_pix = L_pix.map(lambda a: jnp.take(a, jnp.asarray(perm)))
        if record_lengths:
            lens = jnp.take(lens, jnp.asarray(perm), axis=2)
    if record_lengths:
        # (n_chunks, C, N) -> (spp, N): row s = global cell s0 + s
        return L_pix, it, lens.reshape(spp, n_pix)
    return L_pix, it
