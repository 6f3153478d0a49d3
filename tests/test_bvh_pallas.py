"""The Pallas mesh kernel (ops/mesh_kernel.py, Triton route, interpret mode
on the CPU) against the plain XLA walk (geometry/triangles.intersect)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raysnail_tpu import ir
from raysnail_tpu.camera import Ray
from raysnail_tpu.geometry import triangles
from raysnail_tpu.geometry.hit import BIG
from raysnail_tpu.ops import mesh_kernel
from raysnail_tpu.prelude.vec import Vec3
from raysnail_tpu.scene import _build_triangles
from raysnail_tpu.scenes.meshes import torus_knot, uv_sphere

TMIN, TMAX = jnp.float32(1e-3), jnp.float32(1e30)


def _group(v, f, n):
    spec = ir.Mesh(vertices=v, indices=f, normals=n)
    return _build_triangles([(spec, 0)], lambda a: jnp.asarray(np.asarray(a), jnp.float32))


def _rays(rng, n_rays, origin_lo=-1.0, origin_hi=1.0, z_bias=-2.0):
    o = rng.uniform(origin_lo, origin_hi, (n_rays, 3)).astype(np.float32)
    d = rng.standard_normal((n_rays, 3)).astype(np.float32)
    d[:, 2] += z_bias  # aim forward-ish
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(
        origin=Vec3.from_array(jnp.asarray(o)),
        direction=Vec3.from_array(jnp.asarray(d)),
        time=jnp.zeros(n_rays, jnp.float32),
    )


def _assert_hits_match(h_ref, h_k, rtol=1e-5):
    np.testing.assert_array_equal(np.asarray(h_ref.valid), np.asarray(h_k.valid))
    both = np.asarray(h_ref.valid)
    np.testing.assert_allclose(
        np.asarray(h_ref.t)[both], np.asarray(h_k.t)[both], rtol=rtol)
    np.testing.assert_allclose(
        np.asarray(h_ref.normal.to_array())[both],
        np.asarray(h_k.normal.to_array())[both], atol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(h_ref.mat_id)[both], np.asarray(h_k.mat_id)[both])


def test_packet_traversal_matches_reference(rng_np):
    v, f, n = uv_sphere(10, 14, center=(0.0, 0.0, -3.0))
    group = _group(v, f, n)
    ray = _rays(rng_np, 300)  # not a multiple of BLOCK -> exercises padding
    h_ref = triangles.intersect(group, ray, TMIN, TMAX)
    h_k = triangles.intersect_kernel(group, ray, TMIN, TMAX, interpret=True)
    assert np.asarray(h_ref.valid).any()
    _assert_hits_match(h_ref, h_k)


def test_active_mask_suppresses_dead_lanes(rng_np):
    """Dead lanes must come back as misses without affecting live lanes."""
    v, f, n = uv_sphere(8, 12, center=(0.0, 0.0, -3.0))
    group = _group(v, f, n)
    n_rays = 256
    ray = _rays(rng_np, n_rays)
    alive = rng_np.random(n_rays) < 0.5
    h_all = triangles.intersect_kernel(group, ray, TMIN, TMAX, interpret=True)
    h_msk = triangles.intersect_kernel(group, ray, TMIN, TMAX,
                                       active=jnp.asarray(alive),
                                       interpret=True)
    np.testing.assert_array_equal(
        np.asarray(h_msk.valid), np.asarray(h_all.valid) & alive)
    live_hit = np.asarray(h_all.valid) & alive
    np.testing.assert_array_equal(
        np.asarray(h_msk.t)[live_hit], np.asarray(h_all.t)[live_hit])


def _case(name, rng):
    """-> (group, ray, t_cap or None, active or None) for one agreement case."""
    if name == "torus_knot":
        v, f, n = torus_knot(n_seg=60, n_ring=12)
        group = _group(v, f, n)
        o = np.tile(np.array([[0.0, 1.5, 4.0]], np.float32), (200, 1))
        tgt = rng.uniform(-1.5, 1.5, (200, 3)).astype(np.float32)
        d = tgt - o
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        ray = Ray(origin=Vec3.from_array(jnp.asarray(o)),
                  direction=Vec3.from_array(jnp.asarray(d)),
                  time=jnp.zeros(200, jnp.float32))
        return group, ray, None, None
    v, f, n = uv_sphere(10, 14, center=(0.0, 0.0, -3.0))
    group = _group(v, f, n)
    if name == "uv_sphere":
        return group, _rays(rng, 200), None, None
    if name == "all_miss":
        # every ray points away from the mesh
        return group, _rays(rng, 200, z_bias=+4.0), None, None
    if name == "dead_lanes":
        return group, _rays(rng, 200), None, jnp.asarray(rng.random(200) < 0.6)
    if name == "t_cap":
        ray = _rays(rng, 200)
        cap = jnp.asarray(rng.uniform(0.5, 4.0, 200).astype(np.float32))
        return group, ray, cap, None
    raise ValueError(name)


@pytest.mark.parametrize(
    "case", ["uv_sphere", "torus_knot", "all_miss", "dead_lanes", "t_cap"])
def test_kernel_matches_xla_walk(case):
    """Kernel hits agree with the XLA walk's, with the cap/mask semantics
    applied to the walk's result: dead lanes miss; a hit at or beyond t_cap
    may be pruned (the cheaper group's hit wins there anyway)."""
    rng = np.random.default_rng(11)
    group, ray, cap, active = _case(case, rng)
    h_ref = triangles.intersect(group, ray, TMIN, TMAX)
    h_k = triangles.intersect_kernel(group, ray, TMIN, TMAX, active=active,
                                     t_cap=cap, interpret=True)
    valid_ref = np.asarray(h_ref.valid)
    if case == "all_miss":
        assert not valid_ref.any()
    if active is not None:
        valid_ref = valid_ref & np.asarray(active)
    k_valid = np.asarray(h_k.valid)
    if cap is not None:
        capn = np.asarray(cap)
        t_ref = np.asarray(h_ref.t)
        below = valid_ref & (t_ref < capn * (1.0 - 1e-5))
        # every walk hit clearly below the cap is found; nothing the
        # kernel reports lies beyond the walk's hit
        assert below.any() and (~valid_ref).any()
        np.testing.assert_array_equal(k_valid[below], True)
        np.testing.assert_array_equal(k_valid[~valid_ref], False)
        np.testing.assert_allclose(np.asarray(h_k.t)[below], t_ref[below],
                                   rtol=1e-5)
        return
    np.testing.assert_array_equal(k_valid, valid_ref)
    both = valid_ref
    np.testing.assert_allclose(np.asarray(h_ref.t)[both],
                               np.asarray(h_k.t)[both], rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(h_ref.mat_id)[both],
                                  np.asarray(h_k.mat_id)[both])


@pytest.mark.parametrize("n_rays", [1, 127, 129, 384])
def test_kernel_pads_ray_counts(n_rays):
    """Ray counts that are not a multiple of BLOCK pad with dead lanes and
    slice back: shapes are (N,), and lane i's answer does not depend on N."""
    rng = np.random.default_rng(3)
    v, f, n = uv_sphere(8, 12, center=(0.0, 0.0, -3.0))
    group = _group(v, f, n)
    ray = _rays(rng, 384)
    full = mesh_kernel.traverse(group, ray.origin, ray.direction,
                                jnp.full(384, BIG, jnp.float32),
                                t_min=1e-3, t_max=1e30, interpret=True)
    part = jax.tree_util.tree_map(lambda a: a[:n_rays], ray)
    out = mesh_kernel.traverse(group, part.origin, part.direction,
                               jnp.full(n_rays, BIG, jnp.float32),
                               t_min=1e-3, t_max=1e30, interpret=True)
    assert [a.shape for a in out] == [(n_rays,)] * 4
    assert [a.dtype for a in out] == [jnp.float32, jnp.int32, jnp.float32,
                                      jnp.float32]
    for a, b in zip(out, full):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b)[:n_rays])
