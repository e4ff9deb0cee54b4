"""Thin-lens depth-of-field tests (reference: camera.h:86-94).

The lens model (render/camera.py:77-93): origin = pos + lens_o with
lens_o sampled on the aperture disk (r = radius*sqrt(u1), theta = 2*pi*u2,
camera.h:86-88), direction = normalize(film_scaled - lens_o). All lens
samples of a pixel converge at ``pos + film_scaled`` — a point on the
plane z = pos.z - focal_length (the focal plane). Geometry at another
depth is blurred by the defocus disk. Round-3 verdict: the lens path was
implemented but never exercised with radius > 0; these tests render real
DOF and assert the focal-plane-sharp / off-plane-blurred contract
numerically.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudapathtracer import RenderConfig, init_accum, make_camera, render
from cudapathtracer.models import procedural
from cudapathtracer.render.camera import camera_rays
from cudapathtracer.render.renderer import (
    build_bvh_for_scene,
    finalize_image,
    render_batch_jit,
)
from cudapathtracer.ops.rng import pixel_keys, sample_key


def _emissive_quad_scene(half=0.4, z=0.0):
    """A single emissive quad at depth ``z`` facing +z, nothing else: the
    bounce-0 emission image is a crisp bright square whose edge profile
    directly reads out the camera's defocus blur (no MC noise at bounce 0
    beyond the lens integral itself)."""
    verts = np.array(
        [(-half, -half, z), (half, -half, z), (half, half, z),
         (-half, half, z)], np.float32)
    tris = np.array([(0, 1, 2), (0, 2, 3)], np.int32)
    return procedural.to_scene(dict(
        verts=verts, tris=tris, tri_mats=np.array([0, 0], np.int32),
        albedo=np.array([[0.0, 0.0, 0.0]], np.float32),
        emission=np.array([[10.0, 10.0, 10.0]], np.float32),
    ))


def _edge_width(img_u8):
    """Count of partial-intensity pixels along the center scanline — the
    blur transition band width (0 for a perfectly sharp binary edge)."""
    h = img_u8.shape[0]
    row = img_u8[h // 2].astype(np.float32).mean(axis=-1)
    m = row.max()
    assert m > 64.0, "center scanline must cross the bright quad"
    return int(np.sum((row > 0.1 * m) & (row < 0.9 * m)))


def _render_u8(scene, cam, cfg, seed=7):
    st = render(scene, cam, cfg, seed=seed)
    return np.asarray(finalize_image(st, cfg))


@pytest.mark.slow
def test_dof_focal_plane_sharp_off_plane_blurred():
    scene = _emissive_quad_scene(z=0.0)
    cfg = RenderConfig(width=64, height=64, spp=48, integrator="pt_nee",
                       samples_per_call=48)
    # camera at z=3 looking down -z; focal plane sits at z = 3 - focal_length
    in_focus = make_camera(pos=(0.0, 0.0, 3.0), width=64, height=64,
                           focal_length=3.0, radius=0.25)
    out_focus = make_camera(pos=(0.0, 0.0, 3.0), width=64, height=64,
                            focal_length=1.5, radius=0.25)

    w_sharp = _edge_width(_render_u8(scene, in_focus, cfg))
    w_blur = _edge_width(_render_u8(scene, out_focus, cfg))

    # in focus: every lens sample converges at the quad's depth -> the
    # edge is binary (pixel centers are point samples; no footprint).
    assert w_sharp <= 2, w_sharp
    # focal plane 1.5 units in front of the quad: defocus radius at the
    # quad is the full aperture (0.25 world units ~ 5 px either side at
    # this FOV) -> a wide penumbra on both vertical edges.
    assert w_blur >= w_sharp + 5, (w_sharp, w_blur)


def test_lens_rays_converge_at_focal_plane():
    """All lens samples of one pixel pass through the same focal-plane
    point (the thin-lens invariant the DOF render builds on)."""
    cam = make_camera(pos=(0.0, 0.0, 3.0), width=16, height=16,
                      focal_length=2.0, radius=0.3)
    idx = jnp.full((8,), 37, jnp.uint32)  # same pixel, 8 lens samples
    keys = pixel_keys(sample_key(jax.random.PRNGKey(5), jnp.int32(0)),
                      jnp.arange(8, dtype=jnp.uint32))  # distinct draws
    o, d = camera_rays(cam, idx, keys)
    # origins spread over the aperture disk
    spread = float(jnp.max(o.x) - jnp.min(o.x))
    assert spread > 1e-3, spread
    assert float(jnp.max(jnp.abs(o.z - 3.0))) == 0.0  # lens disk is planar
    # march each ray to the focal plane z = 1.0: x/y must coincide
    t = (1.0 - o.z) / d.z
    px = o.x + t * d.x
    py = o.y + t * d.y
    np.testing.assert_allclose(np.asarray(px), np.asarray(px)[0], atol=1e-5)
    np.testing.assert_allclose(np.asarray(py), np.asarray(py)[0], atol=1e-5)


def test_radius_zero_lens_path_equals_pinhole():
    """radius=0 with the lens path active == the pinhole fast path (the
    lens terms vanish identically, not approximately)."""
    cam = make_camera(pos=(0.0, 1.0, 3.0), width=16, height=16, radius=0.0)
    idx = jnp.arange(256, dtype=jnp.uint32)
    keys = pixel_keys(sample_key(jax.random.PRNGKey(3), jnp.int32(1)), idx)
    o1, d1 = camera_rays(cam, idx, keys, lens=True)
    o2, d2 = camera_rays(cam, idx, keys, lens=False)
    for a, b in ((o1, o2), (d1, d2)):
        np.testing.assert_array_equal(np.asarray(a.x), np.asarray(b.x))
        np.testing.assert_array_equal(np.asarray(a.y), np.asarray(b.y))
        np.testing.assert_array_equal(np.asarray(a.z), np.asarray(b.z))


def test_reuse_primary_hit_refuses_aperture():
    """renderer.render_batch_jit must refuse reuse_primary_hit with a real
    aperture (the cached primary hit would silently kill the DOF)."""
    scene = _emissive_quad_scene()
    cfg = RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                       samples_per_call=1, reuse_primary_hit=True)
    cam = make_camera(pos=(0.0, 0.0, 3.0), width=16, height=16,
                      focal_length=3.0, radius=0.2)
    bvh = build_bvh_for_scene(scene, cfg.leaf_size)
    with pytest.raises(AssertionError, match="pinhole"):
        render_batch_jit(scene, bvh, cam, cfg, jax.random.PRNGKey(0),
                         init_accum(cfg), 1)
