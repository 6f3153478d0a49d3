"""L2 material table: branch-free scatter over the whole ray batch.

The reference dispatches `Arc<dyn Material>::scatter` returning a boxed PDF
object (src/material/mod.rs:27-72). Here materials are rows of a SoA table;
sampling and pdf evaluation compute every material *kind present in the
scene* for the full batch and where-select by the per-ray material type —
divergence costs one extra elementwise pass per kind instead of scalar branching.

Material kinds and reference behavior:
  LAMBERTIAN    CosinePdf about the normal               lambertian.rs:39-50
  METAL         mirror reflect, skip_pdf, absorb if refl.n<=0  metal.rs:104-118
  DIFFUSE_METAL cos^e lobe about the reflected dir        metal.rs:54-68
  DIELECTRIC    Snell refract + TIR + optional Schlick, skip_pdf
                                                          dielectric.rs:55-93
  BLINN_PHONG   k_specular mixture of cos^e half-vector lobe and cosine
                                                          blinn_phong.rs:32-42
  DIFFUSE_LIGHT emissive only (both faces)                light.rs:31-40
  ISOTROPIC     uniform sphere scatter                    isotropic.rs:26-33
  MIXED         stochastic blend of two rows              mixed_material.rs:41-50
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raysnail_tpu.prelude import sampling
from raysnail_tpu.prelude.sampling import INV_PI, PI
from raysnail_tpu.prelude.vec import Vec3

LAMBERTIAN = 0
METAL = 1
DIFFUSE_METAL = 2
DIELECTRIC = 3
BLINN_PHONG = 4
DIFFUSE_LIGHT = 5
ISOTROPIC = 6
MIXED = 7

# bounded replacement for the reference's unbounded hemisphere-rejection loops
# (pdf.rs:130-140, 196-207): tries with fresh uniforms, keep the first valid
REJECT_TRIES = 4


class MaterialTable(NamedTuple):
    mtype: jax.Array          # (M,) int32
    tex_id: jax.Array         # (M,) int32 albedo texture
    param0: jax.Array         # (M,) DiffuseMetal exponent | Dielectric ior | BlinnPhong k_specular
    param1: jax.Array         # (M,) BlinnPhong exponent | Dielectric use-Schlick flag
    emit_mult: jax.Array      # (M,) DiffuseLight multiplier
    phong_factor: jax.Array   # (M,) CommonMaterialSettings (mod.rs:41-54)
    phong_exponent: jax.Array # (M,) stored as float; reference powi
    mix_prob: jax.Array       # (M,) MixedMaterial probability of row mix_a
    mix_a: jax.Array          # (M,) int32
    mix_b: jax.Array          # (M,) int32
    # EXTENSION: Beer-Lambert absorption for dielectric interiors; None when
    # no material uses it (the integrator then skips the term entirely)
    absorb: "Vec3 | None" = None


class Rows(NamedTuple):
    """Per-ray gathered material properties."""
    mtype: jax.Array
    tex_id: jax.Array
    param0: jax.Array
    param1: jax.Array
    emit_mult: jax.Array
    phong_factor: jax.Array
    phong_exponent: jax.Array


def resolve(table: MaterialTable, mat_id, u_mix, default_id: int = 0,
            depth: int = 1):
    """Map -1 (no material) to the world default row and resolve MIXED rows by
    sampling (mixed_material.rs:41-50). The reference's MixedMaterial holds two
    `Arc<dyn Material>` that can themselves be Mixed; nesting resolves by
    descending `depth` levels (the scene's static max nesting), each level
    consuming its own uniform (u_mix row i) like the recursion draws fresh
    randomness per call. u_mix: (depth, ...) — one uniform row per level."""
    m = jnp.where(mat_id < 0, default_id, mat_id)
    for lvl in range(depth):
        is_mix = table.mtype[m] == MIXED
        u = u_mix[lvl]
        picked = jnp.where(u < table.mix_prob[m], table.mix_a[m], table.mix_b[m])
        m = jnp.where(is_mix, picked, m)
    return m


def gather(table: MaterialTable, mat_id) -> Rows:
    """Per-ray material rows (hit.take_table on every field)."""
    from raysnail_tpu.geometry import hit as hitlib

    sel = lambda a: hitlib.take_table(a, mat_id)
    return Rows(
        mtype=sel(table.mtype), tex_id=sel(table.tex_id),
        param0=sel(table.param0), param1=sel(table.param1),
        emit_mult=sel(table.emit_mult), phong_factor=sel(table.phong_factor),
        phong_exponent=sel(table.phong_exponent),
    )


def is_skip_pdf(rows: Rows):
    return (rows.mtype == METAL) | (rows.mtype == DIELECTRIC)


def emitted(rows: Rows, tex_color: Vec3) -> Vec3:
    """DiffuseLight emission (light.rs:31-40); zero for everything else."""
    is_light = rows.mtype == DIFFUSE_LIGHT
    mult = jnp.where(is_light, rows.emit_mult, 0.0)
    return tex_color * mult


def _reject_sample(axis_onb: sampling.Onb, normal: Vec3, exponent, uniforms):
    """cos^e lobe about `axis`, rejecting directions below the surface
    horizon — bounded K-try version of pdf.rs:130-140."""
    d = axis_onb.local(sampling.cosine_power_direction(exponent, uniforms[0], uniforms[1]))
    accepted = d.dot(normal) > 0.0
    for k in range(1, REJECT_TRIES):
        cand = axis_onb.local(
            sampling.cosine_power_direction(exponent, uniforms[2 * k], uniforms[2 * k + 1])
        )
        take = (~accepted) & (cand.dot(normal) > 0.0)
        d = Vec3.where(take, cand, d)
        accepted = accepted | take
    # fallback when every try failed: mirror across the horizon by keeping the
    # last candidate (rare; the reference would keep spinning)
    return d


def bsdf_sample(rows: Rows, ray_dir: Vec3, normal: Vec3, uniforms, kinds: frozenset) -> Vec3:
    """srec.pdf.generate for every pdf-driven material kind; `uniforms` is a
    tuple of >= 2*REJECT_TRIES + 3 U[0,1) arrays."""
    onb_n = sampling.onb_from_w(normal)
    d = onb_n.local(sampling.cosine_direction(uniforms[0], uniforms[1]))  # LAMBERTIAN default

    if (DIFFUSE_METAL in kinds) or (BLINN_PHONG in kinds):
        reflected = ray_dir.reflect(normal)
        onb_r = sampling.onb_from_w(reflected)
        lobe = _reject_sample(onb_r, normal, rows.param0, uniforms[2:])
        if DIFFUSE_METAL in kinds:
            d = Vec3.where(rows.mtype == DIFFUSE_METAL, lobe, d)
        if BLINN_PHONG in kinds:
            lobe_bp = _reject_sample(onb_r, normal, rows.param1, uniforms[2:])
            u_spec = uniforms[2 + 2 * REJECT_TRIES]
            bp = Vec3.where(u_spec < rows.param0, lobe_bp, d)
            d = Vec3.where(rows.mtype == BLINN_PHONG, bp, d)

    if ISOTROPIC in kinds:
        sph = sampling.unit_sphere_direction(uniforms[0], uniforms[1])
        d = Vec3.where(rows.mtype == ISOTROPIC, sph, d)
    return d


def bsdf_pdf_value(rows: Rows, ray_dir: Vec3, normal: Vec3, direction: Vec3,
                   kinds: frozenset, proper: bool = False):
    """srec.pdf.value(direction) for every pdf-driven kind present.

    proper=False replicates the reference's quirky densities (used both as
    numerator and BSDF-branch denominator of the compat estimator).
    proper=True returns the TRUE density of what bsdf_sample draws — required
    for an unbiased one-sample-MIS mixture denominator:
      * DiffuseMetal: the cos^e lobe around the reflected direction
        ((e+1)/2pi cos_r^e); the reference's ReflectionPdf.value ignores the
        exponent entirely (pdf.rs:112-120).
      * BlinnPhong: k * that lobe + (1-k) * cosine — matching the sampler
        (pdf.rs:162-173 samples the lobe about REFLECTED), where the
        reference's .value mismatches its own sampler by evaluating a
        half-vector density (pdf.rs:176-195).
    The horizon-rejection renormalization of the lobe is ignored in both
    modes (the reference does the same)."""
    cos_n = direction.dot(normal)
    val = jnp.maximum(0.0, cos_n) * INV_PI  # LAMBERTIAN (pdf.rs:34-43)

    if (DIFFUSE_METAL in kinds) or (BLINN_PHONG in kinds):
        reflected = ray_dir.reflect(normal).unit()
        cos_r = jnp.maximum(0.0, direction.dot(reflected))
        if DIFFUSE_METAL in kinds:
            if proper:
                e = rows.param0
                dm = (e + 1.0) / (2.0 * PI) * jnp.power(jnp.maximum(cos_r, 1e-12), e)
            else:
                # ReflectionPdf.value ignores the exponent (pdf.rs:112-120)
                dm = cos_r * INV_PI
            val = jnp.where(rows.mtype == DIFFUSE_METAL, dm, val)
        if BLINN_PHONG in kinds:
            e = rows.param1
            k = rows.param0
            if proper:
                lobe = (e + 1.0) / (2.0 * PI) * jnp.power(jnp.maximum(cos_r, 1e-12), e)
                bp = k * lobe + (1.0 - k) * jnp.maximum(cos_n, 0.0) * INV_PI
            else:
                # BlinnPhongPdf.value (pdf.rs:176-195)
                h = (direction - ray_dir).unit()
                cos_spec = jnp.maximum(0.0, h.dot(normal))
                normal_pdf = (e + 1.0) / (2.0 * PI) * jnp.power(jnp.maximum(cos_spec, 1e-12), e)
                denom = (-ray_dir).dot(h)
                denom = jnp.where(jnp.abs(denom) < 1e-6, 1e-6, denom)
                bp = jnp.maximum(cos_n * INV_PI, 0.0) * (1.0 - k) + normal_pdf / (4.0 * denom) * k
            val = jnp.where(rows.mtype == BLINN_PHONG, bp, val)

    if ISOTROPIC in kinds:
        val = jnp.where(rows.mtype == ISOTROPIC, 1.0 / (4.0 * PI), val)
    return val


def gather_absorb(table: MaterialTable, mat_id) -> Vec3:
    """Per-ray Beer-Lambert absorption coefficients (extension)."""
    from raysnail_tpu.geometry import hit as hitlib

    return Vec3(*(hitlib.take_table(a, mat_id)
                  for a in (table.absorb.x, table.absorb.y, table.absorb.z)))


def specular_dir(rows: Rows, ray_dir: Vec3, normal: Vec3, outside, u_reflect,
                 kinds: frozenset):
    """skip_pdf materials: (direction, absorbed).

    METAL: mirror reflection, absorbed when reflected.n <= 0 (metal.rs:104-118).
    DIELECTRIC: Snell refraction with TIR and optional Schlick reflection
    probability (dielectric.rs:17-25, 55-93)."""
    reflected = ray_dir.reflect(normal)
    d = reflected
    absorbed = jnp.zeros(jnp.shape(u_reflect), bool)

    if METAL in kinds:
        absorbed = jnp.where(rows.mtype == METAL, reflected.dot(normal) <= 0.0, absorbed)

    if DIELECTRIC in kinds:
        ior = rows.param0
        refractive = jnp.where(outside, 1.0 / ior, ior)
        cos_theta = (-ray_dir).dot(normal)
        sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
        tir = refractive * sin_theta > 1.0

        r0 = (1.0 - refractive) / (1.0 + refractive)
        r0 = r0 * r0
        schlick = r0 + (1.0 - r0) * jnp.power(jnp.maximum(1.0 - cos_theta, 0.0), 5.0)
        reflect_prob = jnp.where(rows.param1 > 0.5, schlick, 0.0)
        do_reflect = tir | (u_reflect < reflect_prob)

        r_par = (ray_dir + normal * cos_theta) * refractive
        r_perp = normal * (-jnp.sqrt(jnp.maximum(0.0, 1.0 - r_par.length_squared())))
        refracted = (r_par + r_perp).unit()
        diel = Vec3.where(do_reflect, reflected, refracted)
        d = Vec3.where(rows.mtype == DIELECTRIC, diel, d)
    return d, absorbed


def phong_highlight(dir_to_light: Vec3, ray_dir: Vec3, normal: Vec3, rows: Rows):
    """Direct-light phong highlight multiplier (camera.rs:94-100, applied at
    camera.rs:199-206 with the NEGATED dir-to-light)."""
    d = -dir_to_light
    reflected = d - normal * (2.0 * d.dot(normal))
    spec = jnp.maximum(0.0, reflected.dot(-ray_dir))
    term = jnp.power(spec, rows.phong_exponent) * rows.phong_factor
    return jnp.where(rows.phong_factor > 0.0, 1.0 + term, 1.0)
