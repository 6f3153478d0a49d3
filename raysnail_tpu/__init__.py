"""raysnail-tpu: a differentiable Monte Carlo path tracer for GPUs (JAX).

A from-scratch JAX/XLA/Pallas framework with the capabilities of the Rust
reference renderer (Varkalandar/raysnail): wavefront path tracing with an
iterative bounce loop, flat SoA scene arrays, batched/stackless intersection,
the full material & texture set, a PovRay-subset SDL parser, multi-pass
adaptive oversampling, and end-to-end differentiability of pixel radiance
w.r.t. material/emitter parameters — sharded over multi-GPU device meshes
with shard_map.

Layer map (mirrors SURVEY.md sect.1, re-designed for a data-parallel
accelerator):
  prelude/   L0 math, RNG, sampling, color
  texture    L1 texture table evaluation
  materials  L2 material table + branch-free scatter
  geometry/  L3 primitive SoA intersectors, CSG, transforms, media
  accel/     L4 BVH build (host/native) + traversal (device)
  ops/       L4 Pallas (Triton) mesh traversal kernel for the GPU
  camera     L5 thin-lens camera + ray generation
  integrator L5 wavefront bounce-loop estimator
  render     L6 painter equivalent: tiling, passes, adaptive oversampling
  sdl/       L7 scene-description parser -> scene IR
  scenes/    L8 built-in example scenes
  parallel/  device mesh + sharding of the render/train step
  diff/      inverse-rendering training step (optax)
"""

from raysnail_tpu.config import RenderConfig
from raysnail_tpu.prelude.vec import Vec3

__version__ = "0.1.0"
__all__ = ["RenderConfig", "Vec3", "__version__"]
