"""Render configuration and reference-compatibility flags.

The reference implementation has a handful of quirks (SURVEY.md sect.7 "hard
parts") that affect the rendered image. Each is gated behind a compat flag so
we can both (a) match the reference allclose for the benchmark quality gate
and (b) offer the physically-correct behavior.

Reference quirks covered (file:line cites into /root/reference):
  * hardcoded 1/pi light-branch pdf         src/camera.rs:199
  * HittablePdf value() falls back to a cosine pdf, not solid angle
                                            src/prelude/pdf.rs:254-263
  * effective spp = floor(sqrt(n))**2       src/painter.rs:110-118
  * adaptive-noise 5x5 window column bug    src/bin/raysnail.rs:163
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Static (trace-time) configuration of the renderer.

    All fields are hashable Python values so a RenderConfig can be closed
    over by jitted functions / used as a static argument.
    """

    # Image / sampling -----------------------------------------------------
    width: int = 800
    height: int = 500
    samples: int = 65           # requested spp; effective spp may round down
    max_depth: int = 8          # bounce budget (reference default: camera.rs:117)
    gamma: bool = True          # sqrt gamma on output (vec3.rs:225-240)

    # Numerics -------------------------------------------------------------
    dtype: Any = jnp.float32
    t_min: float = 1e-3         # reference uses 1e-4 in f64 (camera.rs:165)
    t_max: float = 3e4          # reference uses +inf; bounded for f32 (covers r=10000 ground spheres)
    shadow_eps: float = 2e-3    # reference: 0.0002 in f64 (camera.rs:211)

    # Estimator ------------------------------------------------------------
    light_sample_prob: float = 0.5   # 50/50 light-vs-BSDF split (camera.rs:194)
    compat_light_pdf: bool = True    # light branch pdf := 1/pi (camera.rs:199)
    proper_mis: bool = False         # one-sample MIS instead of compat estimator
    russian_roulette: bool = False   # optional RR termination (off = reference parity)

    # Compat flags ---------------------------------------------------------
    compat_spp_square: bool = True     # effective spp = floor(sqrt(n))**2
    compat_noise_bug: bool = False     # replicate the x=y 5x5 window bug
    # NOTE: the reference's untransformed-normal quirk (tf_facade.rs:49-53) is
    # a DOCUMENTED DEVIATION, not a flag: transforms are baked into primitive
    # arrays at scene-compile time and normals always use the correct
    # inverse-transpose (PARITY.md "Transform normals").

    # Execution ------------------------------------------------------------
    ray_batch: int = 1 << 25     # rays (pixels * spp cells) per device dispatch.
                                 # The sample axis accumulates IN the scan
                                 # carry (render.py), so dispatch memory is
                                 # O(pixels) no matter how many spp it covers:
                                 # the canonical 800x500@64spp frame (25.6M
                                 # cells) rides ONE dispatch
    mesh_pallas: str = "auto"    # triangle-mesh traversal route: "auto" (the
                                 # Triton kernel ops/mesh_kernel.py on a GPU,
                                 # the XLA walk on a CPU) | "never" (XLA walk)
                                 # | "force" (the kernel; interpret mode on a
                                 # CPU, for tests)
    path_regen: str = "auto"     # path-regeneration bounce loop ("auto" = on
                                 # for forward renders with the fast RNG):
                                 # a dead lane immediately starts its pixel's
                                 # next sample inside one while_loop, curing
                                 # the scan loop's ~30% live-lane occupancy
                                 # (scripts/alive_stats.py). "never" forces
                                 # the per-sample scan loop (the gradient
                                 # path always uses it).
    remat_bounces: bool = True   # jax.checkpoint the bounce body: backward
                                 # stores per-bounce carries only (forward-only
                                 # renders are unaffected)
    regen_chunk_cap: int = 0     # cap on the regen-shuffle chunk width C (the
                                 # largest divisor of spp <= cap); 0 = use the
                                 # RAYSNAIL_REGEN_C env default (21). Part of
                                 # the config so changing it RETRACES — the
                                 # env var alone is captured at first trace.
    regen_window: int = 0        # sliding-window width W for the regen-shuffle
                                 # per-cell radiance table: the (N, C) table
                                 # carried through the loop shrinks to
                                 # (N, W); finished columns
                                 # retire into the pixel accumulator by a
                                 # uniform roll as soon as every lane passes
                                 # them, and a lane stalls (rare) only when
                                 # > W-1 cells ahead of the slowest lane.
                                 # 0 = full-width table (no window).
    rng: str = "auto"            # "auto" (= fast) | "fast" (counter-hash) | "threefry"
    # fast = murmur3-fmix32 counter hash (4x threefry on CPU; the path-
    # regeneration integrators need it). threefry remains for crypto-grade
    # draws.

    # Adaptive oversampling (multi-pass) ------------------------------------
    passes: int = 1
    noise_threshold: float = 0.01    # raysnail.rs:405

    @property
    def sqrt_spp(self) -> int:
        """Stratification grid edge; reference painter.rs:110-118."""
        import math
        return max(1, int(math.isqrt(self.samples)))

    @property
    def effective_samples(self) -> int:
        if self.compat_spp_square:
            return self.sqrt_spp * self.sqrt_spp
        return self.samples

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    def __hash__(self):
        return hash(tuple(
            (f.name, str(getattr(self, f.name))) for f in dataclasses.fields(self)
        ))


DEFAULT = RenderConfig()
