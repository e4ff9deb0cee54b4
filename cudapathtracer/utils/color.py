"""Color pipeline: Reinhard tonemap, gamma, quantization.

Replicates the reference's output transform (color.h:59-71, kernel.cu:774):
``c -> (c / (c + 1)) ** (1/2.2)`` then quantize to 8-bit with truncation
(the reference casts with ``(int)(c * 255)``, i.e. floor, not round —
kernel.cu:775). Colors here are SoA Vec3 (r, g, b as separate arrays); the
reference accumulates in double (color.h:6) — the device path stays in
f32, so the accumulator is f32 (see render/renderer.py for the
compensated-summation option that recovers the lost precision).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..ops.vecmath import Vec3


def tonemap_reinhard(c: Vec3) -> Vec3:
    """color.h:59-62 ``normalized``: c / (c + 1)."""
    return Vec3(c.x / (c.x + 1.0), c.y / (c.y + 1.0), c.z / (c.z + 1.0))


def tonemap_reinhard_inverse(c: Vec3) -> Vec3:
    """color.h:63-66 ``denormalized``: c / (1 - c)."""
    return Vec3(c.x / (1.0 - c.x), c.y / (1.0 - c.y), c.z / (1.0 - c.z))


def gamma_correct(c: Vec3, a: float) -> Vec3:
    """color.h:68-71 ``gammaCorrect``: c ** a (a = 1/2.2 at the call site)."""
    return Vec3(jnp.power(c.x, a), jnp.power(c.y, a), jnp.power(c.z, a))


def finalize(c: Vec3, gamma: float = 1.0 / 2.2) -> Vec3:
    """Full output transform: Reinhard then gamma (kernel.cu:774)."""
    return gamma_correct(tonemap_reinhard(c), gamma)


def quantize_u8(c: Vec3):
    """Truncating 8-bit quantization (kernel.cu:775) -> (..., 3) uint8."""
    def q(ch):
        return jnp.clip(ch * 255.0, 0.0, 255.0).astype(jnp.uint8)

    return jnp.stack([q(c.x), q(c.y), q(c.z)], axis=-1)
