import numpy as np
import jax.numpy as jnp

from cudapathtracer.ops.vecmath import Vec3
from cudapathtracer.utils import color, ppm


def test_tonemap_reinhard():
    c = Vec3(jnp.asarray([0.0, 1.0, 3.0]), jnp.asarray([0.5, 0.5, 0.5]),
             jnp.asarray([9.0, 9.0, 9.0]))
    t = color.tonemap_reinhard(c)
    np.testing.assert_allclose(np.asarray(t.x), [0.0, 0.5, 0.75], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(t.z), 0.9, rtol=1e-6)
    # inverse
    back = color.tonemap_reinhard_inverse(t)
    np.testing.assert_allclose(np.asarray(back.x), [0.0, 1.0, 3.0], rtol=1e-5)


def test_gamma_and_quantize():
    c = Vec3(jnp.asarray([0.25]), jnp.asarray([0.5]), jnp.asarray([1.0]))
    g = color.gamma_correct(c, 0.5)
    np.testing.assert_allclose(np.asarray(g.x), [0.5], rtol=1e-6)
    q = color.quantize_u8(color.finalize(Vec3(
        jnp.asarray([1.0]), jnp.asarray([1.0]), jnp.asarray([1.0]))))
    # Reinhard(1) = 0.5; 0.5^(1/2.2) ~ 0.7297; *255 trunc = 186
    assert q[0, 0] == 186


def test_ppm_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (8, 16, 3)).astype(np.uint8)
    p = tmp_path / "t.ppm"
    ppm.write_ppm(p, img, flip_x=False)
    back = ppm.read_ppm(p)
    np.testing.assert_array_equal(back, img)


def test_ppm_flip_x(tmp_path):
    img = np.zeros((2, 4, 3), np.uint8)
    img[0, 0] = [255, 0, 0]
    p = tmp_path / "t.ppm"
    ppm.write_ppm(p, img, flip_x=True)
    back = ppm.read_ppm(p)
    np.testing.assert_array_equal(back[0, 3], [255, 0, 0])


def test_read_reference_keeper_format():
    """Our reader parses the reference's golden PPMs (P3 512 512 255,
    single-line body)."""
    import os

    keeper = "/root/reference/keepers/cornell-original.ppm"
    if not os.path.exists(keeper):
        import pytest

        pytest.skip("reference keepers not mounted")
    img = ppm.read_ppm(keeper)
    assert img.shape == (512, 512, 3)
    assert img.max() > 0


def test_png_roundtrip_matches_ppm():
    """PNG writer (utils/png.py): same image as the PPM path, lossless."""
    import numpy as np

    from cudapathtracer.utils.png import read_png, write_png
    from cudapathtracer.utils.ppm import read_ppm, write_ppm

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (16, 32, 3), dtype=np.uint8)
    import tempfile, os

    with tempfile.TemporaryDirectory() as d:
        pp = os.path.join(d, "a.ppm")
        pg = os.path.join(d, "a.png")
        write_ppm(pp, img)
        write_png(pg, img)
        a = read_ppm(pp)
        b = read_png(pg)
        assert np.array_equal(a, b)
        assert np.array_equal(b, img[:, ::-1])  # reference x-flip layout
