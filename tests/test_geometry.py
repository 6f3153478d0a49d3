import jax.numpy as jnp
import numpy as np
import pytest

from raysnail_tpu.camera import Ray
from raysnail_tpu.geometry import BIG, boxes, quadrics, rects, spheres, transforms
from raysnail_tpu.prelude.vec import Vec3


def make_ray(origins, directions):
    o = Vec3.from_array(jnp.asarray(origins, jnp.float32))
    d = Vec3.from_array(jnp.asarray(directions, jnp.float32)).unit()
    return Ray(origin=o, direction=d, time=jnp.zeros(o.shape, jnp.float32))


def sphere_group(centers, radii, mat_ids=None):
    centers = np.asarray(centers, np.float32)
    radii = np.asarray(radii, np.float32)
    n = len(radii)
    return spheres.SphereGroup(
        center=Vec3.from_array(jnp.asarray(centers)),
        radius=jnp.asarray(radii),
        speed=Vec3.zeros((n,)),
        mat_id=jnp.asarray(mat_ids if mat_ids is not None else np.arange(n), jnp.int32),
        active=jnp.ones((n,), bool),
    )


TMIN, TMAX = jnp.float32(1e-3), jnp.float32(1e30)


class TestSpheres:
    def test_head_on(self):
        g = sphere_group([[0, 0, -5]], [1.0])
        ray = make_ray([[0, 0, 0]], [[0, 0, -1]])
        h = spheres.intersect(g, ray, TMIN, TMAX)
        assert bool(h.valid[0])
        np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(h.normal.to_array())[0], [0, 0, 1], atol=1e-6)
        assert bool(h.outside[0])

    def test_miss(self):
        g = sphere_group([[0, 0, -5]], [1.0])
        ray = make_ray([[0, 5, 0]], [[0, 0, -1]])
        h = spheres.intersect(g, ray, TMIN, TMAX)
        assert not bool(h.valid[0])
        assert float(h.t[0]) == pytest.approx(BIG)

    def test_inside_sphere_uses_t2(self):
        g = sphere_group([[0, 0, 0]], [2.0])
        ray = make_ray([[0, 0, 0]], [[0, 0, -1]])
        h = spheres.intersect(g, ray, TMIN, TMAX)
        assert bool(h.valid[0])
        np.testing.assert_allclose(float(h.t[0]), 2.0, rtol=1e-5)
        # normal flipped to face the ray (inside hit)
        np.testing.assert_allclose(np.asarray(h.normal.to_array())[0], [0, 0, 1], atol=1e-5)
        assert not bool(h.outside[0])

    def test_nearest_of_many(self):
        g = sphere_group([[0, 0, -5], [0, 0, -3], [0, 0, -9]], [1.0, 1.0, 1.0])
        ray = make_ray([[0, 0, 0]], [[0, 0, -1]])
        h = spheres.intersect(g, ray, TMIN, TMAX)
        np.testing.assert_allclose(float(h.t[0]), 2.0, rtol=1e-5)
        assert int(h.mat_id[0]) == 1

    def test_chunked_matches_direct(self):
        rng = np.random.default_rng(0)
        centers = rng.uniform(-10, 10, (64, 3))
        radii = rng.uniform(0.5, 2.0, 64)
        g = sphere_group(centers, radii)
        o = rng.uniform(-20, 20, (33, 3))
        d = rng.standard_normal((33, 3))
        ray = make_ray(o, d)
        h_direct = spheres.intersect(g, ray, TMIN, TMAX, chunk=512)
        h_chunked = spheres.intersect(g, ray, TMIN, TMAX, chunk=16)
        np.testing.assert_allclose(np.asarray(h_direct.t), np.asarray(h_chunked.t), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(h_direct.mat_id), np.asarray(h_chunked.mat_id))

    def test_chunked_ignores_packed_bvh_tables(self):
        # groups carry per-sphere rows only (no packed BVH side tables), so
        # the chunked sweep reshapes every field; inactive padding rows (as
        # scene compile adds above 512 spheres) never win
        rng = np.random.default_rng(1)
        centers = rng.uniform(-10, 10, (64, 3))
        radii = rng.uniform(0.5, 2.0, 64)
        g = sphere_group(centers, radii)
        assert set(g._fields) == {"center", "radius", "speed", "mat_id",
                                  "active"}
        pad = lambda a, v: jnp.concatenate([a, jnp.full((16,) + a.shape[1:], v, a.dtype)])
        g_pad = g._replace(
            center=g.center.map(lambda a: pad(a, 0.0)),
            radius=pad(g.radius, 1.0), speed=g.speed.map(lambda a: pad(a, 0.0)),
            mat_id=pad(g.mat_id, -1), active=pad(g.active, False))
        o = rng.uniform(-20, 20, (9, 3))
        d = rng.standard_normal((9, 3))
        ray = make_ray(o, d)
        h_plain = spheres.intersect(g, ray, TMIN, TMAX, chunk=16)
        h = spheres.intersect(g_pad, ray, TMIN, TMAX, chunk=16)
        np.testing.assert_allclose(np.asarray(h.t), np.asarray(h_plain.t), rtol=1e-5)
        np.testing.assert_array_equal(np.asarray(h.mat_id), np.asarray(h_plain.mat_id))

    def test_uv_poles_and_equator(self):
        g = sphere_group([[0, 0, 0]], [1.0])
        # hit +x side: phi = atan2(0, 1) = 0 -> u = 0.5; v = 0.5
        ray = make_ray([[5, 0, 0]], [[-1, 0, 0]])
        h = spheres.intersect(g, ray, TMIN, TMAX)
        np.testing.assert_allclose([float(h.u[0]), float(h.v[0])], [0.5, 0.5], atol=1e-6)

    def test_motion_blur(self):
        g = spheres.SphereGroup(
            center=Vec3.from_array(jnp.asarray([[0.0, 0.0, -5.0]])),
            radius=jnp.asarray([1.0]),
            speed=Vec3.from_array(jnp.asarray([[0.0, 2.0, 0.0]])),
            mat_id=jnp.zeros(1, jnp.int32),
            active=jnp.ones(1, bool),
        )
        o = Vec3.from_array(jnp.asarray([[0.0, 0.0, 0.0], [0.0, 0.0, 0.0]]))
        d = Vec3.from_array(jnp.asarray([[0.0, 0.0, -1.0], [0.0, 0.0, -1.0]]))
        ray = Ray(origin=o, direction=d, time=jnp.asarray([0.0, 1.0], jnp.float32))
        h = spheres.intersect(g, ray, TMIN, TMAX, moving=True)
        assert bool(h.valid[0])       # at t=0 center is on axis
        assert not bool(h.valid[1])   # at t=1 center moved to y=2 -> miss


class TestBoxes:
    def group(self, pmin, pmax):
        n = len(pmin)
        return boxes.BoxGroup(
            p_min=Vec3.from_array(jnp.asarray(pmin, jnp.float32)),
            p_max=Vec3.from_array(jnp.asarray(pmax, jnp.float32)),
            mat_id=jnp.arange(n, dtype=jnp.int32),
            active=jnp.ones(n, bool),
        )

    def test_entry_face(self):
        g = self.group([[-1, -1, -1]], [[1, 1, 1]])
        ray = make_ray([[0, 0, 5]], [[0, 0, -1]])
        h = boxes.intersect(g, ray, TMIN, TMAX)
        np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(h.normal.to_array())[0], [0, 0, 1], atol=1e-6)
        assert bool(h.outside[0])

    def test_inside_exit(self):
        g = self.group([[-1, -1, -1]], [[1, 1, 1]])
        ray = make_ray([[0, 0, 0]], [[1, 0, 0]])
        h = boxes.intersect(g, ray, TMIN, TMAX)
        np.testing.assert_allclose(float(h.t[0]), 1.0, rtol=1e-5)
        # exit face outward normal +x, flipped against ray -> -x... ray dir +x
        # outward normal +x has dot>0 -> flipped to -x, outside False
        np.testing.assert_allclose(np.asarray(h.normal.to_array())[0], [-1, 0, 0], atol=1e-6)
        assert not bool(h.outside[0])

    def test_diagonal_miss(self):
        g = self.group([[-1, -1, -1]], [[1, 1, 1]])
        ray = make_ray([[5, 5, 5]], [[1, 1, 1]])
        h = boxes.intersect(g, ray, TMIN, TMAX)
        assert not bool(h.valid[0])

    def test_oriented_box(self):
        # 45-degree rotated unit box about z; ray along x hits the corner edge
        m = transforms.rotate_z(np.pi / 4)
        inv_rot, inv_off = transforms.inverse_rows(m)
        rows = tuple(
            Vec3.from_array(jnp.asarray(inv_rot[i][None, :], jnp.float32)) for i in range(3)
        )
        off = Vec3.from_array(jnp.asarray(inv_off[None, :], jnp.float32))
        g = boxes.BoxGroup(
            p_min=Vec3.from_array(jnp.asarray([[-1.0, -1.0, -1.0]])),
            p_max=Vec3.from_array(jnp.asarray([[1.0, 1.0, 1.0]])),
            mat_id=jnp.zeros(1, jnp.int32),
            active=jnp.ones(1, bool),
            inv_rows=rows,
            inv_off=off,
        )
        ray = make_ray([[5, 0, 0]], [[-1, 0, 0]])
        h = boxes.intersect(g, ray, TMIN, TMAX)
        assert bool(h.valid[0])
        # rotated cube corner at x = sqrt(2) -> t = 5 - sqrt(2)
        np.testing.assert_allclose(float(h.t[0]), 5.0 - np.sqrt(2.0), rtol=1e-4)
        # normal is a world-space unit vector facing the ray
        n = np.asarray(h.normal.to_array())[0]
        np.testing.assert_allclose(np.linalg.norm(n), 1.0, rtol=1e-5)
        assert n[0] > 0.5

    def test_contains(self):
        pmin = Vec3.full((-1.0, -1.0, -1.0), ())
        pmax = Vec3.full((1.0, 1.0, 1.0), ())
        p_in = Vec3.full((0.0, 0.5, -0.5), (1,))
        p_out = Vec3.full((0.0, 1.5, 0.0), (1,))
        assert bool(boxes.contains(pmin, pmax, p_in)[0])
        assert not bool(boxes.contains(pmin, pmax, p_out)[0])


class TestQuadrics:
    def test_unit_sphere_quadric(self):
        # x^2+y^2+z^2-1 = 0
        coeffs = (1.0, 0, 0, 0, 1.0, 0, 0, 1.0, 0, -1.0)
        g = quadric_group([coeffs])
        ray = make_ray([[0, 0, 5]], [[0, 0, -1]])
        h = quadrics.intersect(g, ray, TMIN, TMAX)
        np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(h.normal.to_array())[0], [0, 0, 1], atol=1e-5)

    def test_cylinder(self):
        # x^2 + z^2 - 1 = 0 (infinite cylinder along y, SDL quadric.sdl)
        coeffs = (1.0, 0, 0, 0, 0.0, 0, 0, 1.0, 0, -1.0)
        g = quadric_group([coeffs])
        ray = make_ray([[5, 7, 0]], [[-1, 0, 0]])
        h = quadrics.intersect(g, ray, TMIN, TMAX)
        np.testing.assert_allclose(float(h.t[0]), 4.0, rtol=1e-5)

    def test_plane_linear_case(self):
        # 2*qg*y = 0 with qg = 0.5 -> plane y=0; a == 0 -> linear branch
        coeffs = (0.0, 0, 0, 0, 0.0, 0, 0.5, 0.0, 0, 0.0)
        g = quadric_group([coeffs])
        ray = make_ray([[0, 3, 0]], [[0, -1, 0]])
        h = quadrics.intersect(g, ray, TMIN, TMAX)
        np.testing.assert_allclose(float(h.t[0]), 3.0, rtol=1e-5)

    def test_transformed_sphere_quadric(self):
        # unit sphere scaled by 2 in x, translated to (0,0,-5)
        m = transforms.compose([transforms.scale((2.0, 1.0, 1.0)), transforms.translate((0, 0, -5))])
        coeffs = transforms.transform_quadric(transforms.sphere_to_quadric((0, 0, 0), 1.0), m)
        g = quadric_group([coeffs])
        ray = make_ray([[5, 0, -5]], [[-1, 0, 0]])
        h = quadrics.intersect(g, ray, TMIN, TMAX)
        # ellipsoid extends to x=2
        np.testing.assert_allclose(float(h.t[0]), 3.0, rtol=1e-4)
        np.testing.assert_allclose(np.asarray(h.normal.to_array())[0], [1, 0, 0], atol=1e-4)


def quadric_group(coeff_list):
    cols = np.asarray(coeff_list, np.float32).T
    n = cols.shape[1]
    return quadrics.QuadricGroup(
        *(jnp.asarray(c) for c in cols),
        mat_id=jnp.arange(n, dtype=jnp.int32),
        active=jnp.ones(n, bool),
    )


class TestRects:
    def test_xz_rect(self):
        g = rects.RectGroup(
            k_axis=jnp.asarray([1], jnp.int32),  # y = k plane
            k=jnp.asarray([2.0]),
            a0=jnp.asarray([-1.0]), a1=jnp.asarray([1.0]),
            b0=jnp.asarray([-1.0]), b1=jnp.asarray([1.0]),
            mat_id=jnp.zeros(1, jnp.int32),
            active=jnp.ones(1, bool),
        )
        ray = make_ray([[0.5, 5.0, 0.5]], [[0, -1, 0]])
        h = rects.intersect(g, ray, TMIN, TMAX)
        np.testing.assert_allclose(float(h.t[0]), 3.0, rtol=1e-5)
        np.testing.assert_allclose(np.asarray(h.normal.to_array())[0], [0, 1, 0], atol=1e-6)
        # xz rect: a-axis = x, b-axis = z (rect.rs:66-72)
        np.testing.assert_allclose([float(h.u[0]), float(h.v[0])], [0.75, 0.75], atol=1e-5)

    def test_outside_bounds(self):
        g = rects.RectGroup(
            k_axis=jnp.asarray([2], jnp.int32),
            k=jnp.asarray([0.0]),
            a0=jnp.asarray([-1.0]), a1=jnp.asarray([1.0]),
            b0=jnp.asarray([-1.0]), b1=jnp.asarray([1.0]),
            mat_id=jnp.zeros(1, jnp.int32),
            active=jnp.ones(1, bool),
        )
        ray = make_ray([[5.0, 0.0, 5.0]], [[0, 0, -1]])
        h = rects.intersect(g, ray, TMIN, TMAX)
        assert not bool(h.valid[0])


class TestTransformCompat:
    def test_rotation_matches_reference_sign(self):
        # The reference's rotate_by_y_axis(theta) maps +z toward... its matrix
        # is the transpose of standard Ry. Verify composition forward/inverse.
        m = transforms.compose([transforms.rotate_y(np.pi / 2)])
        v = np.array([1.0, 0.0, 0.0, 1.0])
        out = m @ v
        np.testing.assert_allclose(out[:3], [0, 0, -1], atol=1e-12)

    def test_quadric_conjugation_roundtrip(self):
        coeffs = transforms.sphere_to_quadric((1.0, 2.0, 3.0), 1.5)
        m = transforms.compose([
            transforms.rotate_x(0.3), transforms.scale((2.0, 1.0, 0.5)),
            transforms.translate((4, 5, 6)),
        ])
        fwd = transforms.transform_quadric(coeffs, m)
        back = transforms.transform_quadric(fwd, np.linalg.inv(m))
        np.testing.assert_allclose(back, coeffs, atol=1e-9)
