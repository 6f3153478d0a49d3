"""Scene compilation: host IR -> flat SoA device arrays + static closures.

This replaces the reference's `World { bvh, lights, background, default }`
(src/hittable/collection/world.rs) and its BVH-of-trait-objects with:

  * SceneArrays — a jit-friendly pytree of primitive groups + the material /
    texture / light tables (the differentiable leaves live here);
  * static closures — CSG trees, media, and structure flags that are baked
    into the traced program (scene structure changes retrace; parameter
    changes don't);
  * intersect() — the dense dispatcher that combines per-group winners.

The transform lowering (SURVEY.md sect.7 step 2) happens here: transforms are
decomposed and baked into primitive parameters at compile time, so the render
hot path has no transform facade.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from raysnail_tpu import ir, lights as lightslib, materials as matlib, textures as texlib
from raysnail_tpu.geometry import boxes, csg, media as medialib, quadrics, rects, spheres, triangles
from raysnail_tpu.geometry import transforms as tf
from raysnail_tpu.geometry.hit import Hit, combine_hits, miss
from raysnail_tpu.prelude import rng as prng
from raysnail_tpu.prelude.vec import Vec3


class Background(NamedTuple):
    """Vertical gradient c1 -> c2 on 0.5*(dir.y + 1) (world.rs:19-23; the SDL
    driver's fixed sky raysnail.rs:364-367). Solid color = c1 == c2."""
    c1: Vec3
    c2: Vec3

    def color(self, direction: Vec3) -> Vec3:
        t = 0.5 * (direction.y + 1.0)
        return self.c1 * (1.0 - t) + self.c2 * t


class SceneArrays(NamedTuple):
    spheres: Optional[spheres.SphereGroup]
    boxes: Optional[boxes.BoxGroup]
    rects: Optional[rects.RectGroup]
    quadrics: Optional[quadrics.QuadricGroup]
    triangles: Optional[triangles.TriangleGroup]
    materials: matlib.MaterialTable
    textures: texlib.TextureTable
    lights: Optional[lightslib.LightArrays]
    background: Background


@dataclasses.dataclass(frozen=True)
class SceneStatic:
    tex_modes: frozenset
    mat_kinds: frozenset
    light_kinds: frozenset
    moving: bool
    has_lights: bool
    n_media: int
    n_csg: int
    sphere_chunk: int = 512
    tri_brute: bool = False   # dense sweep instead of BVH walk (small meshes)
    has_absorb: bool = False  # any dielectric with Beer-Lambert absorption
    mix_depth: int = 1        # max Mixed-material nesting (resolve iterations)


@dataclasses.dataclass
class Scene:
    arrays: SceneArrays
    static: SceneStatic
    csg_trees: tuple      # closed over by the traced program
    media: tuple
    mandelbulbs: tuple

    def intersect(self, ray, t_min, t_max, key) -> Hit:
        return intersect(self, self.arrays, ray, t_min, t_max, key)


def intersect(scene: Scene, arrays: SceneArrays, ray, t_min, t_max, key,
              mesh_kernel: bool = False, mesh_interpret: bool = False,
              active=None) -> Hit:
    """Closest hit across all primitive groups. `arrays` is passed separately
    so a jitted caller can thread traced arrays while `scene` supplies the
    static structure. `key` is the per-ray key batch (only media draw from
    it). `active` is the integrator's alive mask — the mesh kernel uses it
    to stop dead lanes from walking the BVH."""
    best = miss(jnp.shape(ray.direction.x), ray.direction.x.dtype)
    if arrays.spheres is not None:
        best = combine_hits(
            best,
            spheres.intersect(arrays.spheres, ray, t_min, t_max,
                              moving=scene.static.moving,
                              chunk=scene.static.sphere_chunk,
                              need_uv=texlib.IMAGE in scene.static.tex_modes),
        )
    if arrays.boxes is not None:
        best = combine_hits(
            best, boxes.intersect(arrays.boxes, ray, t_min, t_max))
    if arrays.rects is not None:
        best = combine_hits(best, rects.intersect(arrays.rects, ray, t_min, t_max))
    if arrays.quadrics is not None:
        best = combine_hits(best, quadrics.intersect(arrays.quadrics, ray, t_min, t_max))
    if arrays.triangles is not None:
        # geometry gradients are out of scope: detach the mesh hit (the BVH
        # while_loop is not reverse-differentiable anyway)
        if mesh_kernel:
            # `best` from the cheap dense groups above caps the traversal:
            # a bounce ray that already hit the ground sphere at t=0.5 never
            # admits mesh nodes beyond it
            tri_hit = triangles.intersect_kernel(
                arrays.triangles, ray, t_min, t_max, active=active,
                t_cap=best.t, interpret=mesh_interpret)
        elif scene.static.tri_brute:
            tri_hit = triangles.intersect_brute(arrays.triangles, ray, t_min, t_max)
        else:
            tri_hit = triangles.intersect(arrays.triangles, ray, t_min, t_max)
        best = combine_hits(best, jax.lax.stop_gradient(tri_hit))
    if scene.csg_trees:
        best = combine_hits(best, csg.intersect_trees(scene.csg_trees, ray, t_min, t_max))
    if scene.media:
        us = prng.ray_uniforms(prng.fold_all(key, prng.MEDIUM), len(scene.media))
        best = combine_hits(
            best, medialib.intersect_media(scene.media, ray, t_min, t_max, us)
        )
    for bulb in scene.mandelbulbs:
        # same while_loop caveat as meshes: detached
        best = combine_hits(
            best,
            jax.lax.stop_gradient(bulb.hit(ray, t_min, t_max, active=active)))
    return best


# -- builder ---------------------------------------------------------------

class SceneBuilder:
    """Collects IR specs and lowers them to a Scene.

    `add(obj)` adds world geometry; `add(obj, light=True)` also registers the
    object in the light-sampling list (the reference adds light spheres to
    BOTH the world and `lights`, bin/raysnail.rs:353-362)."""

    def __init__(self):
        self.objects: list = []
        self.light_specs: list = []
        self.background = Background(
            c1=Vec3.full((1.0, 1.0, 1.0)), c2=Vec3.full((0.5, 0.7, 1.0))
        )

    def add(self, obj, light: bool = False):
        self.objects.append(obj)
        if light:
            # The light spec must describe the object's WORLD-space placement:
            # bake a translate+uniform-scale transform into the spec (matching
            # the geometry lowering below) and reject anything the sampler
            # cannot represent, so NEE never targets a pre-transform shape.
            m = ir.unmat4(obj.transform) if getattr(obj, "transform", None) else None
            ts = tf.is_translate_uniform_scale(m) if m is not None else (1.0, np.zeros(3))
            if isinstance(obj, ir.Sphere):
                if ts is None:
                    raise ValueError(
                        "light spheres only support translate/uniform-scale "
                        "transforms (anything else lowers to a quadric, which "
                        "the light sampler cannot target)")
                s, off = ts
                c = tuple(np.asarray(obj.center, np.float64) * s + off)
                self.light_specs.append(("sphere", c, obj.radius * abs(s)))
            elif isinstance(obj, ir.Rect) and obj.k_axis == 1:
                if ts is None:
                    raise ValueError(
                        "light rects only support translate/uniform-scale "
                        "transforms (a rotated rect light would need an "
                        "oriented-rect sampler; see rect.rs:141-153)")
                s, off = ts
                a0, a1 = sorted((obj.a0 * s + off[0], obj.a1 * s + off[0]))
                b0, b1 = sorted((obj.b0 * s + off[2], obj.b1 * s + off[2]))
                self.light_specs.append(
                    ("rect_xz", obj.k * s + off[1], a0, a1, b0, b1)
                )
            else:
                raise ValueError("lights must be spheres or XZ rects (rect.rs:141-153)")
        return self

    def set_background(self, c1, c2=None):
        c1 = Vec3.full(tuple(c1))
        self.background = Background(c1=c1, c2=Vec3.full(tuple(c2)) if c2 is not None else c1)
        return self

    def compile(self, dtype=jnp.float32) -> Scene:
        return _compile(self, dtype)


class _Tables:
    """Deduplicating collectors for materials and textures."""

    def __init__(self):
        self.tex_index: dict = {}
        self.tex_rows: list = []
        self.mat_index: dict = {}
        self.mat_rows: list = []
        self.images: list = []
        self.perlins: list = []
        self.deep_checker = False  # some checker has non-constant children
        self.checker_depth = 0     # max checker nesting (1 = plain checker)
        self._row_depth: list = [] # per-row checker nesting depth
        self.mix_depth = 1         # max Mixed-material nesting
        self._mat_depth: list = [] # per-row Mixed nesting depth
        # row 0: the world default white Lambertian (world.rs:25-60)
        self.material(ir.Lambertian(ir.Constant((1.0, 1.0, 1.0))))

    def texture(self, spec) -> int:
        spec = ir.as_texture(spec)
        if spec in self.tex_index:
            return self.tex_index[spec]
        row = dict(ttype=texlib.CONSTANT, color1=(0.0, 0.0, 0.0), color2=(0.0, 0.0, 0.0),
                   scale=1.0, image_id=-1, depth=0, perlin_id=-1,
                   child1=-1, child2=-1)
        if isinstance(spec, ir.Constant):
            row["color1"] = spec.rgb
        elif isinstance(spec, ir.Checker):
            # generic over child textures like the reference's Checker<T1,T2>
            # (checker.rs:8-28), INCLUDING checker-of-checker: children
            # register as their own table rows and evaluation descends the
            # static max nesting depth, re-deriving the cell sign with each
            # level's own scale (textures.evaluate).
            odd, even = ir.as_texture(spec.odd), ir.as_texture(spec.even)
            c1, c2 = self.texture(odd), self.texture(even)
            row.update(ttype=texlib.CHECKER, scale=spec.scale,
                       child1=c1, child2=c2)
            row["_depth"] = 1 + max(self._row_depth[c1], self._row_depth[c2])
            self.checker_depth = max(self.checker_depth, row["_depth"])
            if isinstance(odd, ir.Constant) and isinstance(even, ir.Constant):
                # fast path: constant cells read color1/color2 directly
                row.update(color1=odd.rgb, color2=even.rgb)
            else:
                self.deep_checker = True
        elif isinstance(spec, ir.ImageTex):
            from PIL import Image
            img = np.asarray(Image.open(spec.path).convert("RGB"), np.float32) / 255.0
            row.update(ttype=texlib.IMAGE, image_id=len(self.images))
            self.images.append(img)
        elif isinstance(spec, ir.Noise):
            ttype = {"normal": texlib.PERLIN, "turbulence": texlib.PERLIN_TURB,
                     "marble": texlib.PERLIN_MARBLE}[spec.kind]
            row.update(ttype=ttype, scale=spec.scale, depth=spec.depth,
                       perlin_id=len(self.perlins))
            self.perlins.append(_perlin_tables(spec))
        else:
            raise TypeError(f"unknown texture {spec!r}")
        idx = len(self.tex_rows)
        self._row_depth.append(row.pop("_depth", 0))
        self.tex_rows.append(row)
        self.tex_index[spec] = idx
        return idx

    def material(self, spec) -> int:
        if spec is None:
            return -1
        if spec in self.mat_index:
            return self.mat_index[spec]
        row = dict(mtype=matlib.LAMBERTIAN, tex_id=0, param0=0.0, param1=0.0,
                   emit_mult=0.0, phong_factor=0.0, phong_exponent=1.0,
                   mix_prob=0.0, mix_a=0, mix_b=0, absorb=(0.0, 0.0, 0.0))
        if isinstance(spec, ir.Lambertian):
            row.update(mtype=matlib.LAMBERTIAN, tex_id=self.texture(spec.texture),
                       phong_factor=spec.phong_factor, phong_exponent=spec.phong_exponent)
        elif isinstance(spec, ir.Metal):
            row.update(mtype=matlib.METAL, tex_id=self.texture(spec.texture),
                       phong_factor=spec.phong_factor, phong_exponent=spec.phong_exponent)
        elif isinstance(spec, ir.DiffuseMetal):
            row.update(mtype=matlib.DIFFUSE_METAL, tex_id=self.texture(spec.texture),
                       param0=spec.exponent,
                       phong_factor=spec.phong_factor, phong_exponent=spec.phong_exponent)
        elif isinstance(spec, ir.Dielectric):
            row.update(mtype=matlib.DIELECTRIC, tex_id=self.texture(ir.Constant(spec.rgb)),
                       param0=spec.ior, param1=1.0 if spec.schlick else 0.0,
                       absorb=tuple(spec.absorption))
        elif isinstance(spec, ir.BlinnPhong):
            row.update(mtype=matlib.BLINN_PHONG, tex_id=self.texture(spec.texture),
                       param0=spec.k_specular, param1=spec.exponent,
                       phong_factor=spec.phong_factor, phong_exponent=spec.phong_exponent)
        elif isinstance(spec, ir.DiffuseLight):
            row.update(mtype=matlib.DIFFUSE_LIGHT, tex_id=self.texture(spec.texture),
                       emit_mult=spec.multiplier)
        elif isinstance(spec, ir.Isotropic):
            row.update(mtype=matlib.ISOTROPIC, tex_id=self.texture(ir.Constant(spec.rgb)))
        elif isinstance(spec, ir.Mixed):
            # nests like the reference's Arc<dyn Material> pair
            # (mixed_material.rs:15-23): children register as their own rows;
            # resolve() iterates the scene's static max nesting depth
            a = self.material(spec.material_1)
            b = self.material(spec.material_2)
            row.update(mtype=matlib.MIXED, mix_prob=spec.probability_1, mix_a=a, mix_b=b)
            row["_depth"] = 1 + max(self._mat_depth[a], self._mat_depth[b])
            self.mix_depth = max(self.mix_depth, row["_depth"])
        else:
            raise TypeError(f"unknown material {spec!r}")
        idx = len(self.mat_rows)
        self._mat_depth.append(row.pop("_depth", 0))
        self.mat_rows.append(row)
        self.mat_index[spec] = idx
        return idx


def _perlin_tables(spec: ir.Noise):
    """Per-noise lattice parameters. The lattice VALUES are hash-derived on
    the fly (textures._lattice_corner) instead of the explicit
    float/vec/perm tables of noise.rs:41-70 (44 per-lane gathers per
    evaluation); only the seed, vector flag and smoothing mode remain."""
    seed = np.uint32((spec.seed + 12345) & 0xFFFFFFFF)
    smooth = {"none": 0, "linear": 1, "hermitian": 2}[spec.smooth]
    return seed, bool(spec.vector), smooth


def _compile(builder: SceneBuilder, dtype) -> Scene:
    tables = _Tables()

    sph, box_list, rect_list, quad_list, mesh_list = [], [], [], [], []
    csg_trees, media_nodes, bulbs = [], [], []
    moving = False

    def lower(obj, parent_tf: np.ndarray | None = None):
        nonlocal moving
        own = ir.unmat4(obj.transform) if getattr(obj, "transform", None) else None
        m = _combine_tf(parent_tf, own)

        if isinstance(obj, ir.Sphere):
            mat = tables.material(obj.material)
            if m is None:
                if any(obj.speed):
                    moving = True
                sph.append((obj.center, obj.radius, obj.speed, mat))
                return
            ts = tf.is_translate_uniform_scale(m)
            if ts is not None:
                s, off = ts
                c = np.asarray(obj.center) * s + off
                if any(obj.speed):
                    moving = True
                sph.append((tuple(c), obj.radius * s, obj.speed, mat))
            else:
                coeffs = tf.transform_quadric(
                    tf.sphere_to_quadric(obj.center, obj.radius), m
                )
                quad_list.append((coeffs, mat))
        elif isinstance(obj, ir.Box):
            mat = tables.material(obj.material)
            if m is None:
                box_list.append((obj.p_min, obj.p_max, mat, None, None))
            else:
                inv_rot, inv_off = tf.inverse_rows(m)
                box_list.append((obj.p_min, obj.p_max, mat, inv_rot, inv_off))
        elif isinstance(obj, ir.Rect):
            mat = tables.material(obj.material)
            if m is None:
                rect_list.append((obj, mat, None, None))
            else:
                inv_rot, inv_off = tf.inverse_rows(m)
                rect_list.append((obj, mat, inv_rot, inv_off))
        elif isinstance(obj, ir.Quadric):
            mat = tables.material(obj.material)
            coeffs = tuple(float(c) for c in obj.coeffs)
            if m is not None:
                coeffs = tf.transform_quadric(coeffs, m)
            quad_list.append((coeffs, mat))
        elif isinstance(obj, ir.Csg):
            mat = tables.material(obj.material)
            node = _lower_csg(obj, m, tables, dtype)
            csg_trees.append(node)
        elif isinstance(obj, ir.ConstantMedium):
            mat = tables.material(ir.Isotropic(obj.rgb))
            leaf = _leaf_of(obj.boundary, m, -1, tables, dtype, register_material=False)
            media_nodes.append(
                medialib.MediumNode(
                    boundary=leaf,
                    neg_inv_density=jnp.asarray(-1.0 / obj.density, dtype),
                    mat_id=mat,
                )
            )
        elif isinstance(obj, ir.Mandelbulb):
            from raysnail_tpu.geometry.mandelbulb import MandelbulbNode
            mat = tables.material(obj.material)
            bulbs.append(MandelbulbNode(mat_id=mat))
        elif isinstance(obj, ir.Mesh):
            mat = tables.material(obj.material)
            mesh_list.append((obj, mat))
        else:
            raise TypeError(f"unknown object {obj!r}")

    for obj in builder.objects:
        lower(obj)

    def f32(x):
        return jnp.asarray(np.asarray(x, np.float64), dtype)

    sphere_group = None
    if sph:
        chunk = 512
        n = len(sph)
        pad = (-n) % chunk if n > chunk else 0
        centers = np.asarray([s[0] for s in sph] + [(0, 0, 0)] * pad, np.float64)
        radii = np.asarray([s[1] for s in sph] + [1.0] * pad, np.float64)
        speeds = np.asarray([s[2] for s in sph] + [(0, 0, 0)] * pad, np.float64)
        mats = np.asarray([s[3] for s in sph] + [-1] * pad, np.int32)
        active = np.asarray([True] * n + [False] * pad)
        sphere_group = spheres.SphereGroup(
            center=Vec3.from_array(f32(centers)),
            radius=f32(radii),
            speed=Vec3.from_array(f32(speeds)),
            mat_id=jnp.asarray(mats),
            active=jnp.asarray(active),
        )

    box_group = None
    if box_list:
        any_oriented = any(b[3] is not None for b in box_list)
        pmin = f32([b[0] for b in box_list])
        pmax = f32([b[1] for b in box_list])
        mats = jnp.asarray([b[2] for b in box_list], jnp.int32)
        active = jnp.ones(len(box_list), bool)
        inv_rows = inv_off = None
        if any_oriented:
            eye = np.eye(3)
            rots = np.asarray([b[3] if b[3] is not None else eye for b in box_list])
            offs = np.asarray([b[4] if b[4] is not None else np.zeros(3) for b in box_list])
            inv_rows = tuple(Vec3.from_array(f32(rots[:, i, :])) for i in range(3))
            inv_off = Vec3.from_array(f32(offs))
        box_group = boxes.BoxGroup(
            p_min=Vec3.from_array(pmin), p_max=Vec3.from_array(pmax),
            mat_id=mats, active=active, inv_rows=inv_rows, inv_off=inv_off,
        )

    rect_group = None
    if rect_list:
        any_oriented = any(r[2] is not None for r in rect_list)
        inv_rows = inv_off = None
        if any_oriented:
            eye = np.eye(3)
            rots = np.asarray([r[2] if r[2] is not None else eye
                               for r in rect_list])
            offs = np.asarray([r[3] if r[3] is not None else np.zeros(3)
                               for r in rect_list])
            inv_rows = tuple(Vec3.from_array(f32(rots[:, i, :])) for i in range(3))
            inv_off = Vec3.from_array(f32(offs))
        rect_group = rects.RectGroup(
            k_axis=jnp.asarray([r.k_axis for r, *_ in rect_list], jnp.int32),
            k=f32([r.k for r, *_ in rect_list]),
            a0=f32([r.a0 for r, *_ in rect_list]),
            a1=f32([r.a1 for r, *_ in rect_list]),
            b0=f32([r.b0 for r, *_ in rect_list]),
            b1=f32([r.b1 for r, *_ in rect_list]),
            mat_id=jnp.asarray([m for _, m, *_ in rect_list], jnp.int32),
            active=jnp.ones(len(rect_list), bool),
            inv_rows=inv_rows, inv_off=inv_off,
        )

    quad_group = None
    if quad_list:
        cols = np.asarray([q[0] for q in quad_list], np.float64).T
        quad_group = quadrics.QuadricGroup(
            *(f32(c) for c in cols),
            mat_id=jnp.asarray([q[1] for q in quad_list], jnp.int32),
            active=jnp.ones(len(quad_list), bool),
        )

    BRUTE_FORCE_MAX = 32768  # triangles; above this the BVH walk wins
    tri_group = None
    tri_brute = False
    if mesh_list:
        tri_group = _build_triangles(mesh_list, f32)
        tri_brute = int(tri_group.mat_id.shape[0]) <= BRUTE_FORCE_MAX

    # light list
    light_arrays = None
    light_kinds = set()
    if builder.light_specs:
        kinds, centers, radii, ks, a0s, a1s, b0s, b1s = [], [], [], [], [], [], [], []
        for spec in builder.light_specs:
            if spec[0] == "sphere":
                kinds.append(lightslib.SPHERE)
                centers.append(spec[1]); radii.append(spec[2])
                ks.append(0.0); a0s.append(0.0); a1s.append(0.0); b0s.append(0.0); b1s.append(0.0)
                light_kinds.add(lightslib.SPHERE)
            else:
                kinds.append(lightslib.RECT_XZ)
                centers.append((0.0, 0.0, 0.0)); radii.append(0.0)
                _, k, a0, a1, b0, b1 = spec
                ks.append(k); a0s.append(a0); a1s.append(a1); b0s.append(b0); b1s.append(b1)
                light_kinds.add(lightslib.RECT_XZ)
        light_arrays = lightslib.LightArrays(
            kind=jnp.asarray(kinds, jnp.int32),
            center=Vec3.from_array(f32(centers)),
            radius=f32(radii), k=f32(ks),
            a0=f32(a0s), a1=f32(a1s), b0=f32(b0s), b1=f32(b1s),
        )

    # tables -> arrays
    tr = tables.tex_rows
    tex_modes = frozenset(r["ttype"] for r in tr)
    if tables.deep_checker or tables.checker_depth > 1:
        # static descent depth for nested / non-constant checkers
        tex_modes = tex_modes | {texlib.CHECKER_DEEP,
                                 ("checker_depth", tables.checker_depth)}
    atlas = atlas_wh = None
    if tables.images:
        mh = max(i.shape[0] for i in tables.images)
        mw = max(i.shape[1] for i in tables.images)
        atlas_np = np.zeros((len(tables.images), mh, mw, 3), np.float32)
        wh = []
        for i, img in enumerate(tables.images):
            atlas_np[i, : img.shape[0], : img.shape[1]] = img
            wh.append((img.shape[1], img.shape[0]))
        atlas = jnp.asarray(atlas_np)
        atlas_wh = jnp.asarray(wh, jnp.int32)
    perlin_seed = perlin_is_vec = perlin_smooth = None
    if tables.perlins:
        perlin_seed = jnp.asarray(
            np.asarray([p[0] for p in tables.perlins], np.uint32))
        perlin_is_vec = jnp.asarray([p[1] for p in tables.perlins])
        perlin_smooth = jnp.asarray([p[2] for p in tables.perlins], jnp.int32)

    texture_table = texlib.TextureTable(
        ttype=jnp.asarray([r["ttype"] for r in tr], jnp.int32),
        color1=Vec3.from_array(f32([r["color1"] for r in tr])),
        color2=Vec3.from_array(f32([r["color2"] for r in tr])),
        scale=f32([r["scale"] for r in tr]),
        image_id=jnp.asarray([r["image_id"] for r in tr], jnp.int32),
        depth=jnp.asarray([r["depth"] for r in tr], jnp.int32),
        child1=jnp.asarray([r["child1"] for r in tr], jnp.int32),
        child2=jnp.asarray([r["child2"] for r in tr], jnp.int32),
        atlas=atlas, atlas_wh=atlas_wh,
        perlin_id=jnp.asarray([r["perlin_id"] for r in tr], jnp.int32),
        perlin_seed=perlin_seed,
        perlin_is_vec=perlin_is_vec, perlin_smooth=perlin_smooth,
    )

    mr = tables.mat_rows
    mat_kinds = frozenset(r["mtype"] for r in mr)
    has_absorb = any(any(c != 0.0 for c in r["absorb"]) for r in mr)
    material_table = matlib.MaterialTable(
        mtype=jnp.asarray([r["mtype"] for r in mr], jnp.int32),
        tex_id=jnp.asarray([r["tex_id"] for r in mr], jnp.int32),
        param0=f32([r["param0"] for r in mr]),
        param1=f32([r["param1"] for r in mr]),
        emit_mult=f32([r["emit_mult"] for r in mr]),
        phong_factor=f32([r["phong_factor"] for r in mr]),
        phong_exponent=f32([r["phong_exponent"] for r in mr]),
        mix_prob=f32([r["mix_prob"] for r in mr]),
        mix_a=jnp.asarray([r["mix_a"] for r in mr], jnp.int32),
        mix_b=jnp.asarray([r["mix_b"] for r in mr], jnp.int32),
        absorb=Vec3.from_array(f32([r["absorb"] for r in mr])) if has_absorb else None,
    )

    arrays = SceneArrays(
        spheres=sphere_group, boxes=box_group, rects=rect_group,
        quadrics=quad_group, triangles=tri_group,
        materials=material_table, textures=texture_table,
        lights=light_arrays, background=builder.background,
    )
    static = SceneStatic(
        tex_modes=tex_modes,
        mat_kinds=mat_kinds,
        light_kinds=frozenset(light_kinds),
        moving=moving,
        has_lights=light_arrays is not None,
        n_media=len(media_nodes),
        n_csg=len(csg_trees),
        tri_brute=tri_brute,
        has_absorb=has_absorb,
        mix_depth=tables.mix_depth,
    )
    return Scene(arrays=arrays, static=static, csg_trees=tuple(csg_trees),
                 media=tuple(media_nodes), mandelbulbs=tuple(bulbs))


def _build_triangles(mesh_list, f32):
    """Merge all meshes into one triangle pool + one BVH; reorder per-face
    data into BVH leaf order (padding rows get mat_id = -2)."""
    from raysnail_tpu.accel.bvh import build_bvh
    from raysnail_tpu.io.obj import vertex_normals

    all_p0, all_p1, all_p2 = [], [], []
    all_n0, all_n1, all_n2 = [], [], []
    all_mat = []
    for spec, mat in mesh_list:
        v = np.asarray(spec.vertices, np.float64)
        faces = np.asarray(spec.indices, np.int32)
        n = spec.normals
        if n is None:
            n = vertex_normals(v, faces)
        else:
            n = np.asarray(n, np.float64)
        all_p0.append(v[faces[:, 0]]); all_p1.append(v[faces[:, 1]]); all_p2.append(v[faces[:, 2]])
        all_n0.append(n[faces[:, 0]]); all_n1.append(n[faces[:, 1]]); all_n2.append(n[faces[:, 2]])
        all_mat.append(np.full(len(faces), mat, np.int32))

    p0 = np.concatenate(all_p0); p1 = np.concatenate(all_p1); p2 = np.concatenate(all_p2)
    n0 = np.concatenate(all_n0); n1 = np.concatenate(all_n1); n2 = np.concatenate(all_n2)
    mat = np.concatenate(all_mat)

    bb_min = np.minimum(np.minimum(p0, p1), p2)
    bb_max = np.maximum(np.maximum(p0, p1), p2)
    bvh = build_bvh(bb_min, bb_max)

    order = bvh.prim_order
    pad = order < 0
    safe = np.where(pad, 0, order)

    def reorder(a, padval=0.0):
        out = a[safe].copy()
        out[pad] = padval
        return out

    p0o = reorder(p0); p1o = reorder(p1); p2o = reorder(p2)

    return triangles.TriangleGroup(
        p0=Vec3.from_array(f32(p0o)),
        edge_a=Vec3.from_array(f32(p0o - p1o)),
        edge_d=Vec3.from_array(f32(p0o - p2o)),
        n0=Vec3.from_array(f32(reorder(n0))),
        n1=Vec3.from_array(f32(reorder(n1))),
        n2=Vec3.from_array(f32(reorder(n2))),
        mat_id=jnp.asarray(np.where(pad, -2, mat[safe]).astype(np.int32)),
        bb_min=Vec3.from_array(jnp.asarray(bvh.bb_min)),
        bb_max=Vec3.from_array(jnp.asarray(bvh.bb_max)),
        first=jnp.asarray(bvh.first),
        count=jnp.asarray(bvh.count),
        miss=jnp.asarray(bvh.miss),
    )


def _combine_tf(parent, own):
    if parent is None and own is None:
        return None
    if parent is None:
        return own
    if own is None:
        return parent
    return parent @ own  # child's own transforms apply first


def _leaf_of(obj, m, inherit_mat, tables, dtype, register_material=True):
    """Lower a CSG child (Sphere/Box/Quadric/Csg) to a leaf/node, pushing the
    accumulated transform m down."""
    own = ir.unmat4(obj.transform) if getattr(obj, "transform", None) else None
    m = _combine_tf(m, own)
    mat = tables.material(obj.material) if register_material else inherit_mat

    def scal(x):
        return jnp.asarray(float(x), dtype)

    if isinstance(obj, ir.Sphere):
        if m is None:
            return csg.SphereLeaf(
                center=Vec3.full(tuple(obj.center), (), dtype),
                radius=scal(obj.radius), mat_id=mat,
            )
        ts = tf.is_translate_uniform_scale(m)
        if ts is not None:
            s, off = ts
            c = np.asarray(obj.center) * s + off
            return csg.SphereLeaf(
                center=Vec3.full(tuple(c), (), dtype),
                radius=scal(obj.radius * s), mat_id=mat,
            )
        coeffs = tf.transform_quadric(tf.sphere_to_quadric(obj.center, obj.radius), m)
        return csg.QuadricLeaf(coeffs=quadrics.Coeffs(*(scal(c) for c in coeffs)), mat_id=mat)
    if isinstance(obj, ir.Box):
        if m is None:
            return csg.BoxLeaf(
                p_min=Vec3.full(tuple(obj.p_min), (), dtype),
                p_max=Vec3.full(tuple(obj.p_max), (), dtype),
                inv_rows=None, inv_off=None, mat_id=mat,
            )
        inv_rot, inv_off = tf.inverse_rows(m)
        return csg.BoxLeaf(
            p_min=Vec3.full(tuple(obj.p_min), (), dtype),
            p_max=Vec3.full(tuple(obj.p_max), (), dtype),
            inv_rows=tuple(Vec3.full(tuple(inv_rot[i]), (), dtype) for i in range(3)),
            inv_off=Vec3.full(tuple(inv_off), (), dtype),
            mat_id=mat,
        )
    if isinstance(obj, ir.Quadric):
        coeffs = tuple(float(c) for c in obj.coeffs)
        if m is not None:
            coeffs = tf.transform_quadric(coeffs, m)
        return csg.QuadricLeaf(coeffs=quadrics.Coeffs(*(scal(c) for c in coeffs)), mat_id=mat)
    if isinstance(obj, ir.Rect):
        inv_rows = inv_off = None
        if m is not None:
            rot, off = tf.inverse_rows(m)
            inv_rows = tuple(Vec3.full(tuple(rot[i]), (), dtype) for i in range(3))
            inv_off = Vec3.full(tuple(off), (), dtype)
        return csg.RectLeaf(
            k_axis=int(obj.k_axis), k=scal(obj.k),
            a0=scal(obj.a0), a1=scal(obj.a1), b0=scal(obj.b0), b1=scal(obj.b1),
            inv_rows=inv_rows, inv_off=inv_off, mat_id=mat,
        )
    if isinstance(obj, ir.Mesh):
        if m is not None:
            v = np.asarray(obj.vertices, np.float64)
            vh = np.concatenate([v, np.ones((len(v), 1))], 1)
            obj = dataclasses.replace(obj, vertices=tuple(map(tuple, (vh @ m.T)[:, :3])),
                                      normals=None if obj.normals is None else tuple(
                                          map(tuple, np.asarray(obj.normals, np.float64)
                                              @ np.linalg.inv(m[:3, :3]))))
        f32 = lambda x: jnp.asarray(np.asarray(x, np.float64), dtype)
        group = _build_triangles([(obj, mat)], f32)
        brute = int(group.mat_id.shape[0]) <= 32768
        return csg.MeshLeaf(group=group, mat_id=mat, brute=brute)
    if isinstance(obj, ir.Csg):
        return _lower_csg(obj, m, tables, dtype)
    raise TypeError(f"unsupported CSG child {obj!r}")


def _lower_csg(obj: ir.Csg, m, tables: _Tables, dtype):
    # invariant: obj.transform is already folded into m by the caller
    mat = tables.material(obj.material)
    left = _leaf_of(obj.left, m, -1, tables, dtype)
    right = _leaf_of(obj.right, m, -1, tables, dtype)
    if obj.op == "intersection":
        return csg.IntersectionNode(left=left, right=right, mat_id=mat)
    if obj.op == "difference":
        minus_mat = getattr(right, "mat_id", -1)
        return csg.DifferenceNode(plus=left, minus=right, mat_id=mat,
                                  minus_mat_id=minus_mat)
    raise ValueError(f"unknown csg op {obj.op}")
