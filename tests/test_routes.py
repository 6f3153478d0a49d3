"""Traversal routing by backend, the dense sweeps that replaced the box and
sphere kernels, gradients on the kernel route, and the compile-cache helper."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raysnail_tpu import integrator, ir
from raysnail_tpu.camera import Ray, build_camera
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.geometry import boxes, spheres
from raysnail_tpu.prelude.vec import Vec3
from raysnail_tpu.scene import SceneBuilder

TMIN, TMAX = 1e-3, 1e30


def _random_rays(rng, n, lo, hi):
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ray = Ray(origin=Vec3.from_array(jnp.asarray(o)),
              direction=Vec3.from_array(jnp.asarray(d)),
              time=jnp.zeros(n, jnp.float32))
    return ray, o.astype(np.float64), d.astype(np.float64)


def _scene_of(kind):
    b = SceneBuilder()
    mat = ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))
    if kind == "mesh":
        from raysnail_tpu.scenes.meshes import uv_sphere

        v, f, n = uv_sphere(6, 8)
        b.add(ir.Mesh(vertices=v, indices=f, normals=n, material=mat))
    elif kind == "boxes":
        for i in range(13):
            for j in range(10):
                b.add(ir.Box((i, 0.0, j), (i + 0.8, 1.0, j + 0.8), mat))
    else:
        c = np.random.default_rng(0).uniform(-20, 20, (4096, 3))
        for ci in c:
            b.add(ir.Sphere(tuple(ci), 0.2, mat))
    return b.compile()


@pytest.mark.parametrize("kind", ["mesh", "boxes", "spheres"])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_routing_table(backend, kind):
    """Meshes take the compiled kernel on a GPU and the XLA walk on a CPU;
    box groups of >= 130 and sphere groups of >= 4096 take their dense
    sweeps on both."""
    scene = _scene_of(kind)
    group = {"mesh": scene.arrays.triangles, "boxes": scene.arrays.boxes,
             "spheres": scene.arrays.spheres}[kind]
    assert group is not None
    want = {("gpu", "mesh"): "kernel", ("cpu", "mesh"): "xla"}.get(
        (backend, kind), "dense")
    assert integrator.routes(RenderConfig(), backend)[kind] == want
    policy = integrator._pallas_policy(RenderConfig(), backend)
    assert policy == dict(mesh_kernel=backend == "gpu", mesh_interpret=False)


@pytest.mark.parametrize("mesh_pallas", ["auto", "never", "force"])
@pytest.mark.parametrize("backend", ["cpu", "gpu"])
def test_mesh_pallas_option(backend, mesh_pallas):
    """"force" interprets the kernel only on a CPU, never on a GPU."""
    policy = integrator._pallas_policy(
        RenderConfig(mesh_pallas=mesh_pallas), backend)
    want_kernel = {"auto": backend == "gpu", "never": False,
                   "force": True}[mesh_pallas]
    assert policy["mesh_kernel"] == want_kernel
    assert policy["mesh_interpret"] == (mesh_pallas == "force"
                                        and backend == "cpu")


def test_unknown_backend_has_no_route():
    with pytest.raises(ValueError):
        integrator.routes(RenderConfig(), "tpu")


def test_dense_box_sweep_400_boxes_matches_numpy():
    """boxes.intersect on a book2-sized group (400 boxes) against a NumPy
    slab test: t_near if in range, else t_far (box.rs:131-134)."""
    rng = np.random.default_rng(4)
    lo = np.stack(np.meshgrid(np.arange(20) * 2.0, [0.0], np.arange(20) * 2.0,
                              indexing="ij"), -1).reshape(-1, 3)
    hi = lo + np.stack([np.full(400, 1.5), rng.uniform(0.5, 3.0, 400),
                        np.full(400, 1.5)], -1)
    group = boxes.BoxGroup(
        p_min=Vec3.from_array(jnp.asarray(lo, jnp.float32)),
        p_max=Vec3.from_array(jnp.asarray(hi, jnp.float32)),
        mat_id=jnp.arange(400, dtype=jnp.int32),
        active=jnp.ones(400, bool))
    ray, o, d = _random_rays(rng, 512, 0.0, 40.0)
    h = boxes.intersect(group, ray, TMIN, TMAX)

    inv = 1.0 / np.where(np.abs(d) < 1e-12, 1e-12, d)
    ta = (lo[None] - o[:, None]) * inv[:, None]
    tb = (hi[None] - o[:, None]) * inv[:, None]
    near = np.minimum(ta, tb).max(-1)
    far = np.maximum(ta, tb).min(-1)
    ok = near < far
    t = np.where(ok & (near > TMIN), near, np.where(ok & (far > TMIN), far, np.inf))
    t_best = t.min(1)
    valid = np.isfinite(t_best)
    assert valid.any() and (~valid).any()
    np.testing.assert_array_equal(np.asarray(h.valid), valid)
    np.testing.assert_allclose(np.asarray(h.t)[valid], t_best[valid], rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(h.mat_id)[valid],
                                  t.argmin(1)[valid])


def test_dense_sphere_sweep_4096_spheres_matches_numpy():
    """spheres.intersect's chunked sweep over 4096 spheres against a NumPy
    half-b quadratic with the t1-else-t2 rule (sphere.rs:83-109)."""
    rng = np.random.default_rng(5)
    c = rng.uniform(-20, 20, (4096, 3))
    r = rng.uniform(0.2, 0.8, 4096)
    group = spheres.SphereGroup(
        center=Vec3.from_array(jnp.asarray(c, jnp.float32)),
        radius=jnp.asarray(r, jnp.float32),
        speed=Vec3.zeros((4096,)),
        mat_id=jnp.arange(4096, dtype=jnp.int32),
        active=jnp.ones(4096, bool))
    ray, o, d = _random_rays(rng, 256, -20.0, 20.0)
    h = spheres.intersect(group, ray, TMIN, TMAX, chunk=512)

    l = o[:, None] - c[None]
    half_b = (d[:, None] * l).sum(-1)
    cc = (l * l).sum(-1) - r[None] ** 2
    delta = half_b ** 2 - cc
    sq = np.sqrt(np.maximum(delta, 0.0))
    t1, t2 = -half_b - sq, -half_b + sq
    ok = delta > 0
    t = np.where(ok & (t1 > TMIN), t1, np.where(ok & (t2 > TMIN), t2, np.inf))
    t_best = t.min(1)
    valid = np.isfinite(t_best)
    assert valid.any() and (~valid).any()
    np.testing.assert_array_equal(np.asarray(h.valid), valid)
    np.testing.assert_allclose(np.asarray(h.t)[valid], t_best[valid], rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(h.mat_id)[valid],
                                  t.argmin(1)[valid])


def test_grad_through_mesh_scene_on_kernel_route():
    """jax.grad through a mesh scene with the mesh on the kernel route: the
    wrapper detaches its inputs, so no tangent reaches the pallas_call and
    the material gradients stay finite and nonzero."""
    from raysnail_tpu.diff import extract_params
    from raysnail_tpu.diff.train import render_image_diff
    from raysnail_tpu.prelude import rng as prng
    from raysnail_tpu.scenes.meshes import uv_sphere

    cfg = RenderConfig(width=16, height=8, samples=4, max_depth=3,
                       mesh_pallas="force")
    v, f, n = uv_sphere(8, 12, center=(0.0, 0.0, -2.0))
    b = SceneBuilder()
    b.add(ir.Mesh(vertices=v, indices=f, normals=n,
                  material=ir.Lambertian(ir.Constant((0.7, 0.2, 0.2)))))
    b.add(ir.Sphere((2.0, 2.0, 0.0), 0.7,
                    ir.DiffuseLight(ir.Constant((1, 1, 1)), 4.0)), light=True)
    scene = b.compile()
    cam = build_camera(look_from=(0, 0, 1), look_at=(0, 0, -2), fov=50,
                       width=cfg.width, height=cfg.height)

    def scalar_out(p):
        img = render_image_diff(scene, cam, cfg, p, prng.key(0),
                                jnp.arange(4, dtype=jnp.int32))
        return jnp.mean(img.x + img.y + img.z)

    g = jax.grad(scalar_out)(extract_params(scene.arrays))
    leaves = jax.tree_util.tree_leaves(g)
    assert all(np.isfinite(np.asarray(l)).all() for l in leaves)
    assert np.abs(np.asarray(g.tex_color1.x)).max() > 1e-7


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_location(env_set, monkeypatch, tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the helper sets nothing and
    reports that directory; without it the cache goes to <repo>/.jax_cache,
    whatever the working directory."""
    from raysnail_tpu.utils import cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.chdir(tmp_path)
    if env_set:
        monkeypatch.setenv(cache.ENV, str(tmp_path / "cc"))
    else:
        monkeypatch.delenv(cache.ENV, raising=False)
    try:
        got = cache.enable_compile_cache()
        now = jax.config.jax_compilation_cache_dir
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if env_set:
        assert got == str(tmp_path / "cc")
        assert now == before
    else:
        assert got == os.path.join(repo, ".jax_cache")
        assert now == got


def test_take_table_gradient_is_a_one_hot_reduction():
    """take_table gathers forward; its table gradient is the per-row sum of
    the ray cotangents (what the gather's scatter-add computes), and integer
    tables pass through as plain gathers."""
    from raysnail_tpu.geometry import hit as hitlib

    rng = np.random.default_rng(6)
    table = jnp.asarray(rng.normal(size=7), jnp.float32)
    idx = jnp.asarray(rng.integers(0, 7, 1000), jnp.int32)
    w = jnp.asarray(rng.normal(size=1000), jnp.float32)
    np.testing.assert_array_equal(np.asarray(hitlib.take_table(table, idx)),
                                  np.asarray(table[idx]))
    g = jax.grad(lambda t: jnp.sum(w * hitlib.take_table(t, idx)))(table)
    want = np.bincount(np.asarray(idx), weights=np.asarray(w, np.float64),
                       minlength=7)
    np.testing.assert_allclose(np.asarray(g), want, rtol=1e-5, atol=1e-5)
    ints = jnp.arange(7, dtype=jnp.int32) * 3
    np.testing.assert_array_equal(np.asarray(hitlib.take_table(ints, idx)),
                                  np.asarray(ints)[np.asarray(idx)])
