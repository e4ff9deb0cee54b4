import numpy as np
import jax.numpy as jnp

from cudapathtracer.ops import vecmath as vm


def _rand_vec(rng, n=64):
    a = rng.normal(size=(n, 3)).astype(np.float32)
    return a, vm.Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def test_ops_match_numpy():
    rng = np.random.default_rng(0)
    a_np, a = _rand_vec(rng)
    b_np, b = _rand_vec(rng)

    np.testing.assert_allclose((a + b).to_array(), a_np + b_np, rtol=1e-6)
    np.testing.assert_allclose((a - b).to_array(), a_np - b_np, rtol=1e-6)
    np.testing.assert_allclose((a * 2.0).to_array(), a_np * 2, rtol=1e-6)
    np.testing.assert_allclose((a * b).to_array(), a_np * b_np, rtol=1e-6)
    np.testing.assert_allclose(vm.dot(a, b), (a_np * b_np).sum(1), rtol=1e-5)
    np.testing.assert_allclose(
        vm.cross(a, b).to_array(), np.cross(a_np, b_np), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        vm.length(a), np.linalg.norm(a_np, axis=1), rtol=1e-6
    )
    n = vm.normalized(a).to_array()
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, rtol=1e-5)


def test_normalized_safe_zero():
    z = vm.Vec3(jnp.zeros(4), jnp.zeros(4), jnp.zeros(4))
    out = vm.normalized_safe(z).to_array()
    assert np.all(np.isfinite(out))
    np.testing.assert_array_equal(out, 0.0)


def test_gather_rows():
    table = vm.Vec3(jnp.arange(5.0), jnp.arange(5.0) * 10, jnp.arange(5.0) * 100)
    idx = jnp.asarray([3, 1, 4])
    g = vm.gather(table, idx)
    np.testing.assert_array_equal(g.x, [3, 1, 4])
    np.testing.assert_array_equal(g.z, [300, 100, 400])
    # 2-D table: must gather rows, not flatten
    t2 = vm.Vec3(
        jnp.arange(12.0).reshape(4, 3),
        jnp.arange(12.0).reshape(4, 3),
        jnp.arange(12.0).reshape(4, 3),
    )
    g2 = vm.gather(t2, jnp.asarray([2, 0]))
    assert g2.x.shape == (2, 3)
    np.testing.assert_array_equal(np.asarray(g2.x[0]), [6, 7, 8])


def test_where_and_minmax():
    a = vm.Vec3.full((3,), 1.0, 2.0, 3.0)
    b = vm.Vec3.full((3,), -1.0, 5.0, 0.0)
    m = jnp.asarray([True, False, True])
    w = vm.where(m, a, b)
    np.testing.assert_array_equal(w.x, [1, -1, 1])
    np.testing.assert_array_equal(vm.vmin(a, b).y, [2, 2, 2])
    np.testing.assert_array_equal(vm.vmax(a, b).y, [5, 5, 5])
    np.testing.assert_array_equal(vm.max_component(b), [5, 5, 5])
