"""Device mesh construction.

The renderer's parallel axes (SURVEY.md sect.5 "long-context" mapping):
  * "tile"   — pixels sharded across devices (the reference's row-interleaved
               decomposition, painter.rs:275-302, made spatial);
  * "sample" — stratification cells sharded across devices; partial radiance
               sums are combined with a psum over this axis.
The cards of one host are joined all to all by NVLink at one rate, so the
mesh follows the algorithm alone: any factoring of the devices into
(tile, sample) costs the same links. The only collectives are the sample-axis
psum of radiance sums and the whole-mesh gradient psum.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh


def _factor(n: int) -> tuple[int, int]:
    """n -> (tile, sample) with tile the larger, near-square factor."""
    best = (n, 1)
    for t in range(1, int(np.sqrt(n)) + 1):
        if n % t == 0:
            best = (n // t, t)
    return best


def make_mesh(n_tile: int | None = None, n_sample: int | None = None,
              devices=None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if n_tile is None and n_sample is None:
        n_tile, n_sample = _factor(n)
    elif n_tile is None:
        n_tile = n // n_sample
    elif n_sample is None:
        n_sample = n // n_tile
    assert n_tile * n_sample == n, (n_tile, n_sample, n)
    arr = np.asarray(devices).reshape(n_tile, n_sample)
    return Mesh(arr, ("tile", "sample"))
