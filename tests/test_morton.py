import numpy as np
import jax.numpy as jnp

from cudapathtracer.utils import morton


def _ref_morton_encode(x, y):
    """Literal transcription of camera.h:66-75 (the 16-iteration loop)."""
    index = 0
    for i in range(16):
        index |= ((x >> i) & 1) << (2 * i)
        index |= ((y >> i) & 1) << (2 * i + 1)
    return index


def _ref_morton_decode(index):
    """Literal transcription of camera.h:57-65."""
    x = y = 0
    for i in range(16):
        x |= ((index >> (2 * i)) & 1) << i
        y |= ((index >> (2 * i + 1)) & 1) << i
    return x, y


def test_encode_matches_reference_loop():
    rng = np.random.default_rng(0)
    xs = rng.integers(0, 1 << 16, 200)
    ys = rng.integers(0, 1 << 16, 200)
    ours = np.asarray(morton.morton_encode(jnp.asarray(xs), jnp.asarray(ys)))
    ref = np.array([_ref_morton_encode(int(x), int(y)) for x, y in zip(xs, ys)],
                   np.uint32)
    np.testing.assert_array_equal(ours, ref)


def test_decode_matches_reference_loop():
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 1 << 32, 200, dtype=np.uint64).astype(np.uint32)
    x, y = morton.morton_decode(jnp.asarray(idx))
    ref = np.array([_ref_morton_decode(int(i)) for i in idx], np.uint32)
    np.testing.assert_array_equal(np.asarray(x), ref[:, 0])
    np.testing.assert_array_equal(np.asarray(y), ref[:, 1])


def test_roundtrip():
    idx = jnp.arange(64 * 64, dtype=jnp.uint32)
    x, y = morton.morton_decode(idx)
    back = morton.morton_encode(x, y)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(idx))


def test_perm_is_permutation():
    p = np.asarray(morton.morton_to_scanline_perm(32, 32))
    assert np.array_equal(np.sort(p), np.arange(32 * 32))
