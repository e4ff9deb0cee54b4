"""Structure-of-arrays 3-vector math.

The reference implements ``vec3`` as a scalar struct with operator overloads
(reference: vec3.h:4-84). Here each component is its own ``(N,)`` array
(structure-of-arrays) rather than an ``(N, 3)`` array with a minor
dimension of 3, so every operation is a full-width elementwise op on
contiguous memory and XLA fuses chains of them into single loops.

``Vec3`` is a NamedTuple, hence automatically a JAX pytree: it can be passed
through jit/scan/while_loop/shard_map, stacked, gathered and differentiated
component-wise.
"""

from __future__ import annotations

from typing import NamedTuple

import jax.numpy as jnp


class Vec3(NamedTuple):
    """SoA 3-vector: three same-shaped arrays (or scalars)."""

    x: jnp.ndarray
    y: jnp.ndarray
    z: jnp.ndarray

    # -- arithmetic -------------------------------------------------------
    def __add__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x + o.x, self.y + o.y, self.z + o.z)
        return Vec3(self.x + o, self.y + o, self.z + o)

    def __sub__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x - o.x, self.y - o.y, self.z - o.z)
        return Vec3(self.x - o, self.y - o, self.z - o)

    def __mul__(self, o):
        if isinstance(o, Vec3):  # component-wise (reference color mul)
            return Vec3(self.x * o.x, self.y * o.y, self.z * o.z)
        return Vec3(self.x * o, self.y * o, self.z * o)

    __rmul__ = __mul__

    def __truediv__(self, o):
        if isinstance(o, Vec3):
            return Vec3(self.x / o.x, self.y / o.y, self.z / o.z)
        return Vec3(self.x / o, self.y / o, self.z / o)

    def __neg__(self):
        return Vec3(-self.x, -self.y, -self.z)

    # -- utilities --------------------------------------------------------
    @staticmethod
    def full(shape, vx, vy, vz, dtype=jnp.float32):
        return Vec3(
            jnp.full(shape, vx, dtype),
            jnp.full(shape, vy, dtype),
            jnp.full(shape, vz, dtype),
        )

    @staticmethod
    def zeros(shape, dtype=jnp.float32):
        # Three distinct buffers: aliased components break jit donation
        # ("attempt to donate the same buffer twice").
        return Vec3(
            jnp.zeros(shape, dtype), jnp.zeros(shape, dtype),
            jnp.zeros(shape, dtype)
        )

    @staticmethod
    def from_array(a):
        """Build from a (..., 3) array (host/interop only)."""
        return Vec3(a[..., 0], a[..., 1], a[..., 2])

    def to_array(self):
        """Pack to (..., 3) (host/interop only — avoid in hot paths)."""
        return jnp.stack([self.x, self.y, self.z], axis=-1)

    @property
    def shape(self):
        return jnp.shape(self.x)

    def astype(self, dtype):
        return Vec3(self.x.astype(dtype), self.y.astype(dtype), self.z.astype(dtype))


def dot(a: Vec3, b: Vec3):
    return a.x * b.x + a.y * b.y + a.z * b.z


def cross(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        a.y * b.z - a.z * b.y,
        a.z * b.x - a.x * b.z,
        a.x * b.y - a.y * b.x,
    )


def length_sq(a: Vec3):
    return dot(a, a)


def length(a: Vec3):
    return jnp.sqrt(dot(a, a))


def normalized(a: Vec3) -> Vec3:
    """Plain normalize, matching the reference (vec3.h:71-76): no guard, a
    zero vector yields inf/nan exactly as the CUDA code would."""
    inv = 1.0 / length(a)
    return a * inv


def normalized_safe(a: Vec3, eps: float = 1e-20) -> Vec3:
    """Normalize with a zero-length guard (returns 0 for the zero vector).

    Used where the reference would produce NaNs that are later multiplied by
    a zero weight anyway — keeping NaNs out lets us run with masked lanes
    instead of relying on 0*NaN behavior.

    Double-``where`` so the VJP is NaN-free too: ``rsqrt`` must never see 0
    even on the non-taken branch, or its cotangent is inf and 0*inf = NaN.
    """
    n2 = dot(a, a)
    ok = n2 > eps
    inv = jnp.where(ok, jax_rsqrt(jnp.where(ok, n2, 1.0)), 0.0)
    return a * inv


def safe_div(num, den, eps: float = 0.0):
    """``num / den`` that is 0 (value AND gradient) where ``|den| <= eps``.

    The naive ``where(den != 0, num / den, 0)`` still differentiates the
    division at den == 0, yielding NaN cotangents; the inner ``where``
    replaces the unsafe denominator before the division is traced.
    """
    ok = jnp.abs(den) > eps
    return jnp.where(ok, num / jnp.where(ok, den, 1.0), 0.0)


def safe_length(a: Vec3, eps: float = 0.0):
    """sqrt(|a|^2) with a NaN-free gradient at the zero vector."""
    n2 = dot(a, a)
    ok = n2 > eps
    return jnp.where(ok, jnp.sqrt(jnp.where(ok, n2, 1.0)), 0.0)


def jax_rsqrt(x):
    import jax.lax as lax

    return lax.rsqrt(x)


def vmin(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.minimum(a.x, b.x), jnp.minimum(a.y, b.y), jnp.minimum(a.z, b.z))


def vmax(a: Vec3, b: Vec3) -> Vec3:
    return Vec3(jnp.maximum(a.x, b.x), jnp.maximum(a.y, b.y), jnp.maximum(a.z, b.z))


def where(mask, a: Vec3, b: Vec3) -> Vec3:
    return Vec3(
        jnp.where(mask, a.x, b.x),
        jnp.where(mask, a.y, b.y),
        jnp.where(mask, a.z, b.z),
    )


def gather(table: Vec3, idx) -> Vec3:
    """Gather rows of an SoA table: table components are (M,), idx is (...,).

    Three 1-D gathers; XLA fuses the address computation. ``mode='clip'``
    gives defined behavior for sentinel indices (callers mask results).
    """
    return Vec3(
        jnp.take(table.x, idx, axis=0, mode="clip"),
        jnp.take(table.y, idx, axis=0, mode="clip"),
        jnp.take(table.z, idx, axis=0, mode="clip"),
    )


def max_component(a: Vec3):
    return jnp.maximum(a.x, jnp.maximum(a.y, a.z))
