import numpy as np
import jax.numpy as jnp

from cudapathtracer.ops import intersect
from cudapathtracer.ops.vecmath import Vec3
from cudapathtracer.utils.constants import MAX_FLOAT


def v3(*cols):
    """cols: list of (x,y,z) tuples -> batched Vec3."""
    a = np.asarray(cols, np.float32)
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def test_ray_triangle_basic_hit():
    o = v3((0, 0, -1))
    d = v3((0, 0, 1))
    tv0 = v3((-1, -1, 2))
    e1 = v3((2, 0, 0))
    e2 = v3((1, 2, 0))  # v2 - v0
    t = intersect.ray_triangle(o, d, tv0, e1, e2)
    np.testing.assert_allclose(np.asarray(t), [3.0], rtol=1e-6)


def test_ray_triangle_miss_is_sentinel():
    o = v3((5, 5, -1))
    d = v3((0, 0, 1))
    t = intersect.ray_triangle(
        o, d, v3((-1, -1, 2)), v3((2, 0, 0)), v3((1, 2, 0))
    )
    assert float(t[0]) == MAX_FLOAT


def test_ray_triangle_negative_t_returned():
    # Triangle BEHIND the ray: the reference returns negative t and lets
    # callers filter (modelLoader.h:81-82, kernel.cu:127).
    o = v3((0, 0, 5))
    d = v3((0, 0, 1))
    t = intersect.ray_triangle(
        o, d, v3((-1, -1, 2)), v3((2, 0, 0)), v3((1, 2, 0))
    )
    np.testing.assert_allclose(np.asarray(t), [-3.0], rtol=1e-6)


def test_ray_triangle_parallel_epsilon():
    # Ray in the triangle's plane: near-parallel cutoff |a| < 1e-5
    o = v3((0, 0, 2))
    d = v3((1, 0, 0))
    t = intersect.ray_triangle(
        o, d, v3((-1, -1, 2)), v3((2, 0, 0)), v3((1, 2, 0))
    )
    assert float(t[0]) == MAX_FLOAT


def test_ray_triangle_barycentric_edges():
    # Hit exactly on a vertex / on an edge still counts (>= 0 passes the
    # strict < 0 rejections)
    o = v3((-1, -1, 0), (0, -1, 0))
    d = v3((0, 0, 1), (0, 0, 1))
    t = intersect.ray_triangle(
        o, d,
        v3((-1, -1, 2), (-1, -1, 2)),
        v3((2, 0, 0), (2, 0, 0)),
        v3((1, 2, 0), (1, 2, 0)),
    )
    np.testing.assert_allclose(np.asarray(t), [2.0, 2.0], rtol=1e-6)


def test_ray_aabb():
    o = v3((0, 0, -5))
    inv = Vec3(1.0 / jnp.asarray([0.0 + 1e-30]), 1.0 / jnp.asarray([1e-30]),
               1.0 / jnp.asarray([1.0]))
    # axis-aligned ray straight through the box
    d = v3((0, 0, 1))
    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)  # inf components
    lo = v3((-1, -1, -1))
    hi = v3((1, 1, 1))
    assert bool(intersect.ray_aabb(o, inv_d, lo, hi)[0])
    # box fully behind the origin: unclipped says hit (reference
    # BVH.h:51-83 has no positive-t check), clipped says miss
    o2 = v3((0, 0, 5))
    assert bool(intersect.ray_aabb(o2, inv_d, lo, hi, clip=False)[0])
    assert not bool(intersect.ray_aabb(o2, inv_d, lo, hi, clip=True)[0])
    # t_best pruning
    t_far = jnp.asarray([100.0])
    t_near = jnp.asarray([3.0])
    assert bool(intersect.ray_aabb(o, inv_d, lo, hi, t_best=t_far)[0])
    assert not bool(intersect.ray_aabb(o, inv_d, lo, hi, t_best=t_near)[0])


def test_ray_aabb_miss():
    o = v3((5, 5, -5))
    d = v3((0, 0, 1))
    inv_d = Vec3(1.0 / d.x, 1.0 / d.y, 1.0 / d.z)
    assert not bool(
        intersect.ray_aabb(o, inv_d, v3((-1, -1, -1)), v3((1, 1, 1)))[0]
    )


def test_ray_sphere():
    o = v3((0, 0, -5), (0, 0, -5), (0, 3, -5))
    d = v3((0, 0, 1), (0, 0, 1), (0, 0, 1))
    c = v3((0, 0, 0), (0, 0, 0), (0, 0, 0))
    r = jnp.asarray([1.0, 1.0, 1.0])
    t = intersect.ray_sphere(o, d, c, r)
    np.testing.assert_allclose(float(t[0]), 4.0, rtol=1e-6)
    assert float(t[2]) == MAX_FLOAT
    # from inside: nearest positive root is the far side
    o_in = v3((0, 0, 0))
    t_in = intersect.ray_sphere(o_in, v3((0, 0, 1)), v3((0, 0, 0)),
                                jnp.asarray([1.0]))
    np.testing.assert_allclose(float(t_in[0]), 1.0, rtol=1e-6)


def test_bw_agrees_with_mt_random():
    """Baldwin-Weber is decision-equivalent to Moller-Trumbore: on random
    ray/triangle pairs the hit/miss verdicts agree (away from exact-tie
    boundaries) and hit t agree to ~1e-5 relative (BW re-derivation vs the
    MT epsilon ledger, modelLoader.h:49-123)."""
    rng = np.random.default_rng(7)
    N = 4096
    v0 = Vec3(*(jnp.asarray(rng.uniform(-1, 1, N), jnp.float32)
                for _ in range(3)))
    e1 = Vec3(*(jnp.asarray(rng.uniform(-1, 1, N), jnp.float32)
                for _ in range(3)))
    e2 = Vec3(*(jnp.asarray(rng.uniform(-1, 1, N), jnp.float32)
                for _ in range(3)))
    o = Vec3(*(jnp.asarray(rng.uniform(-3, 3, N), jnp.float32)
               for _ in range(3)))
    d = Vec3(*(jnp.asarray(rng.uniform(-1, 1, N), jnp.float32)
               for _ in range(3)))
    t_mt = np.asarray(intersect.ray_triangle(o, d, v0, e1, e2))
    t_bw = np.asarray(
        intersect.ray_triangle_any(o, d, v0, e1, e2, intersector="bw"))
    hit_mt = t_mt < MAX_FLOAT
    hit_bw = t_bw < MAX_FLOAT
    # verdicts may flip only on near-boundary cases; require them rare
    flip = hit_mt != hit_bw
    assert flip.mean() < 2e-3, f"verdict flips {flip.mean():.4f}"
    both = hit_mt & hit_bw
    np.testing.assert_allclose(t_bw[both], t_mt[both], rtol=2e-5, atol=2e-6)


def test_bw_degenerate_triangle_rejects():
    """Zero-area (padding) triangles must miss under BW exactly like MT."""
    z = v3((0, 0, 0))
    o = v3((0, 0, -1))
    d = v3((0, 0, 1))
    t = intersect.ray_triangle_any(o, d, z, z, z, intersector="bw")
    assert float(t[0]) == MAX_FLOAT
    # collinear edges (zero normal) too
    e = v3((1, 1, 1))
    t2 = intersect.ray_triangle_any(o, d, z, e, e, intersector="bw")
    assert float(t2[0]) == MAX_FLOAT


def test_bw_precompute_eager_matches_jit():
    """bw_precompute is jit-wrapped so eager callers get the identical
    FMA-contracted bits the in-jit engines compute (the engine bit-parity
    precondition; see the contraction note in ops/intersect.py)."""
    import jax

    rng = np.random.default_rng(3)
    N = 512
    e1 = Vec3(*(jnp.asarray(rng.uniform(-1, 1, N), jnp.float32)
                for _ in range(3)))
    e2 = Vec3(*(jnp.asarray(rng.uniform(-1, 1, N), jnp.float32)
                for _ in range(3)))
    a = intersect.bw_precompute(e1, e2)                    # eager call
    b = jax.jit(lambda x, y: intersect.bw_precompute(x, y))(e1, e2)
    for va, vb in zip(a, b):
        np.testing.assert_array_equal(np.asarray(va.x), np.asarray(vb.x))
        np.testing.assert_array_equal(np.asarray(va.y), np.asarray(vb.y))
        np.testing.assert_array_equal(np.asarray(va.z), np.asarray(vb.z))
