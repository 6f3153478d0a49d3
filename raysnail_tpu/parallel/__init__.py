"""Device-mesh parallelism: the multi-GPU replacement for the reference's
row-interleaved thread pool (src/painter.rs:239-302)."""

from raysnail_tpu.parallel.mesh import make_mesh
from raysnail_tpu.parallel.sharding import (
    make_padded_sharded_step,
    make_sharded_frame_step,
    make_sharded_sample_step,
    make_sharded_train_step,
    render_sharded,
)

__all__ = ["make_mesh", "make_padded_sharded_step", "make_sharded_frame_step",
           "make_sharded_sample_step", "make_sharded_train_step",
           "render_sharded"]
