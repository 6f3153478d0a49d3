"""Batched 3-vectors as a struct-of-arrays pytree.

The reference stores `Vec3 { x, y, z: f64 }` scalars (src/prelude/vec3.rs).
On an accelerator the idiomatic layout is struct-of-arrays: a Vec3 holds three
same-shape jnp arrays, so every component is a contiguous, coalesced array
instead of a strided trailing dim of 3. All arithmetic is elementwise over arbitrary batch
shapes; Vec3 is a registered pytree, so it flows through jit/scan/grad/sharding.
"""

from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

Array = Any


@jax.tree_util.register_pytree_node_class
class Vec3:
    """A batch of 3-vectors (or points, or RGB colors) in SoA form."""

    __slots__ = ("x", "y", "z")

    def __init__(self, x: Array, y: Array, z: Array):
        self.x, self.y, self.z = x, y, z

    # -- pytree protocol ---------------------------------------------------
    def tree_flatten(self):
        return (self.x, self.y, self.z), None

    @classmethod
    def tree_unflatten(cls, aux, children):
        return cls(*children)

    # -- constructors ------------------------------------------------------
    @classmethod
    def full(cls, v: Sequence[float] | float, shape=(), dtype=jnp.float32) -> "Vec3":
        if isinstance(v, (int, float)):
            v = (v, v, v)
        return cls(*(jnp.full(shape, c, dtype) for c in v))

    @classmethod
    def zeros(cls, shape=(), dtype=jnp.float32) -> "Vec3":
        z = jnp.zeros(shape, dtype)
        return cls(z, z, z)

    @classmethod
    def ones(cls, shape=(), dtype=jnp.float32) -> "Vec3":
        o = jnp.ones(shape, dtype)
        return cls(o, o, o)

    @classmethod
    def from_array(cls, a: Array) -> "Vec3":
        """From an array whose LAST axis has size 3."""
        a = jnp.asarray(a)
        return cls(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self) -> Array:
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    # -- shape / dtype -----------------------------------------------------
    @property
    def shape(self):
        return jnp.shape(self.x)

    @property
    def dtype(self):
        return jnp.result_type(self.x)

    def astype(self, dt) -> "Vec3":
        return Vec3(self.x.astype(dt), self.y.astype(dt), self.z.astype(dt))

    def reshape(self, *shape) -> "Vec3":
        return self.map(lambda c: jnp.reshape(c, shape))

    def broadcast_to(self, shape) -> "Vec3":
        return self.map(lambda c: jnp.broadcast_to(c, shape))

    def map(self, f) -> "Vec3":
        return Vec3(f(self.x), f(self.y), f(self.z))

    def __getitem__(self, idx) -> "Vec3":
        return Vec3(self.x[idx], self.y[idx], self.z[idx])

    # -- arithmetic --------------------------------------------------------
    def _coerce(self, o):
        if isinstance(o, Vec3):
            return o
        return Vec3(o, o, o)  # scalar / array broadcast

    def __add__(self, o):
        o = self._coerce(o)
        return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)

    __radd__ = __add__

    def __sub__(self, o):
        o = self._coerce(o)
        return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)

    def __rsub__(self, o):
        o = self._coerce(o)
        return Vec3(o.x - self.x, o.y - self.y, o.z - self.z)

    def __mul__(self, o):
        o = self._coerce(o)
        return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)

    __rmul__ = __mul__

    def __truediv__(self, o):
        o = self._coerce(o)
        return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)

    def __rtruediv__(self, o):
        o = self._coerce(o)
        return Vec3(o.x / self.x, o.y / self.y, o.z / self.z)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- geometry ----------------------------------------------------------
    def dot(self, o: "Vec3") -> Array:
        return self.x * o.x + self.y * o.y + self.z * o.z

    def cross(self, o: "Vec3") -> "Vec3":
        return Vec3(
            self.y * o.z - self.z * o.y,
            self.z * o.x - self.x * o.z,
            self.x * o.y - self.y * o.x,
        )

    def length_squared(self) -> Array:
        return self.dot(self)

    def length(self) -> Array:
        return jnp.sqrt(self.length_squared())

    def unit(self, eps: float = 1e-20) -> "Vec3":
        inv = jax.lax.rsqrt(jnp.maximum(self.length_squared(), eps))
        return self * inv

    def reflect(self, n: "Vec3") -> "Vec3":
        """Mirror reflection about normal n (reference vec3.rs:170-173)."""
        return self - n * (2.0 * self.dot(n))

    def min_component(self) -> Array:
        return jnp.minimum(self.x, jnp.minimum(self.y, self.z))

    def max_component(self) -> Array:
        return jnp.maximum(self.x, jnp.maximum(self.y, self.z))

    def sum(self) -> Array:
        return self.x + self.y + self.z

    def lerp(self, o: "Vec3", t) -> "Vec3":
        return self * (1.0 - t) + o * t

    def isfinite(self) -> Array:
        return jnp.isfinite(self.x) & jnp.isfinite(self.y) & jnp.isfinite(self.z)

    def near_zero(self, eps: float = 1e-8) -> Array:
        return (jnp.abs(self.x) < eps) & (jnp.abs(self.y) < eps) & (jnp.abs(self.z) < eps)

    # -- selection ---------------------------------------------------------
    @staticmethod
    def where(mask: Array, a: "Vec3", b: "Vec3") -> "Vec3":
        return Vec3(
            jnp.where(mask, a.x, b.x),
            jnp.where(mask, a.y, b.y),
            jnp.where(mask, a.z, b.z),
        )

    def __repr__(self):
        return f"Vec3(x={self.x!r}, y={self.y!r}, z={self.z!r})"


def vdot(a: Vec3, b: Vec3) -> Array:
    return a.dot(b)


def vec(x, y, z, dtype=jnp.float32) -> Vec3:
    """Construct a Vec3 of scalars (as 0-d arrays)."""
    return Vec3(jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype))
