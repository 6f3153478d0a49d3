"""Transformed rects (an early review's gap: the reference's TfFacade wraps any
hittable incl. AARect, tf_facade.rs:41-54; round 1 raised NotImplementedError
for them)."""

import math

import jax.numpy as jnp
import numpy as np

from raysnail_tpu import ir
from raysnail_tpu.camera import Ray, build_camera
from raysnail_tpu.config import RenderConfig
from raysnail_tpu.geometry import rects, transforms as tf
from raysnail_tpu.prelude.vec import Vec3
from raysnail_tpu.render import render
from raysnail_tpu.scene import SceneBuilder

TMIN, TMAX = jnp.float32(1e-3), jnp.float32(1e30)
MAT = ir.Lambertian(ir.Constant((0.7, 0.3, 0.3)))


def _rect_group(scene):
    return scene.arrays.rects


def _rand_rays(rng_np, n):
    o = rng_np.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng_np.standard_normal((n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return Ray(origin=Vec3.from_array(jnp.asarray(o)),
               direction=Vec3.from_array(jnp.asarray(d)),
               time=jnp.zeros(n, jnp.float32))


def test_rotated_rect_matches_axis_aligned(rng_np):
    """An XZ rect rotated +90 deg about x maps y->z: it must hit exactly like
    the equivalent XY rect specified directly."""
    m = ir.mat4(tf.rotate_x(math.radians(90.0)))
    b1 = SceneBuilder()
    # XZ rect at y=0.5, x in [-1,1], z in [-0.5, 0.5], rotated about x
    # (convention: y_obj = -z_world): world plane z = -0.5, y in [-0.5, 0.5]
    b1.add(ir.Rect(1, 0.5, -1.0, 1.0, -0.5, 0.5, MAT, transform=m))
    s1 = b1.compile()

    b2 = SceneBuilder()
    b2.add(ir.Rect(2, -0.5, -1.0, 1.0, -0.5, 0.5, MAT))
    s2 = b2.compile()

    ray = _rand_rays(rng_np, 500)
    h1 = rects.intersect(_rect_group(s1), ray, TMIN, TMAX)
    h2 = rects.intersect(_rect_group(s2), ray, TMIN, TMAX)
    np.testing.assert_array_equal(np.asarray(h1.valid), np.asarray(h2.valid))
    both = np.asarray(h1.valid)
    np.testing.assert_allclose(np.asarray(h1.t)[both], np.asarray(h2.t)[both],
                               rtol=1e-5)
    # normals agree up to sign convention of finalize (both face the ray)
    np.testing.assert_allclose(
        np.asarray(h1.normal.to_array())[both],
        np.asarray(h2.normal.to_array())[both], atol=1e-5)


def test_translated_rotated_rect_renders(rng_np):
    """End-to-end: a rect rotated 45 deg about y and translated renders
    without error and actually shows up in the image."""
    m = ir.mat4(tf.compose([tf.rotate_y(math.radians(45.0)),
                            tf.translate((0.0, 1.0, 0.0))]))
    b = SceneBuilder()
    b.add(ir.Rect(2, 0.0, -1.0, 1.0, 0.0, 2.0, MAT, transform=m))
    b.add(ir.Sphere((0, -1000.0, 0), 1000.0,
                    ir.Lambertian(ir.Constant((0.5, 0.5, 0.5)))))
    b.set_background((0.7, 0.8, 1.0))
    cfg = RenderConfig(width=48, height=32, samples=4, max_depth=4)
    cam = build_camera(look_from=(0, 1.5, 4), look_at=(0, 1, 0), fov=50,
                       width=cfg.width, height=cfg.height)
    img = render(b.compile(), cam, cfg, seed=3)
    assert np.isfinite(img).all()
    # the rect's reddish material must dominate some pixels
    reddish = (img[..., 0] > img[..., 2] + 0.05).mean()
    assert reddish > 0.05, f"rect not visible (reddish frac {reddish})"


def test_csg_of_transformed_sphere_renders():
    """CSG over transformed facades (intersection.rs:19-23 takes any
    hittable): intersection of two translated+scaled spheres forms a lens."""
    msphere = ir.mat4(tf.compose([tf.scale((1.0, 1.0, 1.0)),
                                  tf.translate((0.35, 0.0, 0.0))]))
    msphere2 = ir.mat4(tf.translate((-0.35, 0.0, 0.0)))
    lens = ir.Csg(
        "intersection",
        ir.Sphere((0.0, 0.0, 0.0), 1.0, transform=msphere),
        ir.Sphere((0.0, 0.0, 0.0), 1.0, transform=msphere2),
        material=ir.Lambertian(ir.Constant((0.2, 0.6, 0.2))),
    )
    b = SceneBuilder()
    b.add(lens)
    b.set_background((0.9, 0.9, 0.9))
    cfg = RenderConfig(width=48, height=32, samples=4, max_depth=3)
    cam = build_camera(look_from=(0, 0, 3.5), look_at=(0, 0, 0), fov=40,
                       width=cfg.width, height=cfg.height)
    img = render(b.compile(), cam, cfg, seed=3)
    assert np.isfinite(img).all()
    greenish = (img[..., 1] > img[..., 0] + 0.05).mean()
    assert greenish > 0.03, f"lens not visible (greenish frac {greenish})"
    # the lens is thinner than either sphere: corners must be background
    assert img[0, 0, 0] > 0.8
