"""Primary-visibility boundary gradients (diff/edge_sampling.py).

The interior estimator is blind to silhouette motion: translating an
occluder that is uniformly shaded produces ~zero interior vertex gradient,
while the true derivative of the pixel-integrated image is the swept-area
term. These tests validate the edge-sampled boundary term against central
finite differences of high-spp jittered renders (common random numbers)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudapathtracer import RenderConfig, make_camera
from cudapathtracer.diff import render_grad as rg
from cudapathtracer.diff.edge_sampling import (
    EdgeTable,
    build_edge_table,
    boundary_image,
)
from cudapathtracer.models import procedural
from cudapathtracer.models.scene import make_scene
from cudapathtracer.render.renderer import build_bvh_for_scene


def occluder_scene():
    """Cornell box (no boxes) + a floating dark quad in front of the back
    wall; its 4 vertices are private to the quad, so moving them is pure
    silhouette motion of a flat, uniformly-lit occluder."""
    cb = procedural.cornell_box(with_boxes=False)
    verts = cb["verts"].tolist()
    tris = cb["tris"].tolist()
    mats = cb["tri_mats"].tolist()
    base = len(verts)
    # dark quad at z = 0.2, spanning x in [-0.4, 0.1], y in [0.6, 1.2]
    q = [(-0.4, 0.6, 0.2), (0.1, 0.6, 0.2), (0.1, 1.2, 0.2),
         (-0.4, 1.2, 0.2)]
    verts.extend(q)
    tris.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
    albedo = np.concatenate([cb["albedo"], [[0.05, 0.05, 0.05]]])
    emission = np.concatenate([cb["emission"], [[0.0, 0.0, 0.0]]])
    mats.extend([4, 4])
    scene = make_scene(np.array(verts, np.float32),
                       np.array(tris, np.int32),
                       np.array(mats, np.int32), albedo, emission)
    quad_vert_ids = [base, base + 1, base + 2, base + 3]
    return scene, np.array(tris, np.int32), quad_vert_ids


def test_edge_table_structure():
    _, tris, _ = occluder_scene()
    et = build_edge_table(tris)
    ev0 = np.asarray(et.ev0)
    ev1 = np.asarray(et.ev1)
    assert (ev0 < ev1).all()
    # every quad contributes 2 tris sharing a diagonal: interior edges have
    # fb >= 0, border edges fb == -1
    fb = np.asarray(et.fb)
    assert (fb >= 0).sum() >= 7  # 7 quads -> 7 shared diagonals
    # no duplicate undirected edges
    keys = ev0.astype(np.int64) * 1_000_000 + ev1
    assert np.unique(keys).size == keys.size


def test_boundary_image_value_is_zero():
    scene, tris, _ = occluder_scene()
    et = build_edge_table(tris)
    cam = make_camera(width=16, height=16)

    def radiance_stub(o, d, kidx):
        from cudapathtracer.ops.vecmath import Vec3
        return Vec3.full(o.x.shape, 1.0, 2.0, 3.0)

    img = boundary_image(scene, cam, et, radiance_stub,
                         jax.random.PRNGKey(0), 256, 256)
    assert float(jnp.abs(img.x).max()) == 0.0
    assert float(jnp.abs(img.z).max()) == 0.0


def test_silhouette_gradient_matches_fd():
    """d(mean image)/d(occluder x-translation): interior-only misses it,
    edge sampling recovers it within Monte-Carlo tolerance."""
    scene, tris, qids = occluder_scene()
    et = build_edge_table(tris)
    size = 32
    cam = make_camera(width=size, height=size)
    cfg = RenderConfig(width=size, height=size, spp=1, integrator="pt_nee",
                       jitter=True, traversal="brute")
    key = jax.random.PRNGKey(42)
    SPP = 48       # for the autodiff evaluations
    SPP_FD = 192   # the FD reference needs ~4x more: its signal lives in
    #                the one-pixel silhouette band and common-random-number
    #                cancellation leaves that band's jitter noise (measured:
    #                at 48 spp the FD estimate can even flip sign)
    ES = 8192

    qsel = jnp.zeros((scene.num_verts,), jnp.float32).at[
        jnp.asarray(qids)].set(1.0)

    def mean_img(dx, edge_samples, spp=SPP):
        verts = scene.verts._replace(x=scene.verts.x + dx * qsel)
        s = scene._replace(verts=verts)
        img = rg.render_image_diff(
            s, cam, cfg, key, spp,
            edge_samples=edge_samples, edge_table=et if edge_samples else
            None)
        return (jnp.mean(img.x) + jnp.mean(img.y) + jnp.mean(img.z)) / 3.0

    # autodiff, with and without the boundary term
    g_int = float(jax.grad(mean_img)(0.0, 0))
    g_edge = float(jax.grad(mean_img)(0.0, ES))

    # central finite difference on the primal (eps spans ~1 pixel so the
    # jittered estimator resolves the swept band)
    eps = 4.0 / size * 0.5
    fd = (float(mean_img(eps, 0, SPP_FD))
          - float(mean_img(-eps, 0, SPP_FD))) / (2 * eps)

    print(f"fd={fd:.5f} interior={g_int:.5f} with_edges={g_edge:.5f}")
    assert np.isfinite(fd) and np.isfinite(g_edge)
    # the occluder is uniform: interior alone misses most of the signal
    assert abs(g_int - fd) > abs(g_edge - fd), (
        f"boundary term did not improve: fd={fd} int={g_int} edge={g_edge}"
    )
    # and the boundary-corrected gradient is in the right ballpark
    assert abs(g_edge - fd) <= 0.35 * abs(fd) + 5e-3, (
        f"fd={fd} edge={g_edge}"
    )


def shadow_scene():
    """Floor + small down-facing area light + a floating occluder whose
    shadow lands where the camera looks. Moving the occluder in x moves
    the shadow — a pure SECONDARY (NEE) visibility discontinuity: the
    occluder is out of frame, so primary edge sampling can't see it and
    the interior gradient misses it entirely. The light is deliberately
    SMALL (solid angle ~0.02 sr from the floor) so the one un-modeled
    visibility term — the BRDF-branch cosine ray hitting the light
    directly, also occluder-dependent — is negligible next to the NEE
    term the shadow boundary estimator models."""
    verts = []
    tris = []
    mats = []

    def quad(a, b, c, d, m):
        base = len(verts)
        verts.extend([a, b, c, d])
        tris.extend([(base, base + 1, base + 2), (base, base + 2, base + 3)])
        mats.extend([m, m])

    # floor y=0 (normal +y), white
    quad((-2, 0, -2), (-2, 0, 2), (2, 0, 2), (2, 0, -2), 0)
    # small light at y=2 over z=1 (the camera at (0, 0.8, 3) looking down
    # -z sees the floor around z ~ 0.5-1.5); emission scaled to keep the
    # same direct illumination as a 0.4-half-size light
    s = 0.15
    quad((-s, 2.0, 1 + s), (s, 2.0, 1 + s), (s, 2.0, 1 - s),
         (-s, 2.0, 1 - s), 1)
    # occluder: small quad at y=1 under the light; its shadow lands on
    # the visible floor patch around z ~ 1
    oc = 0.3
    base_ids = len(verts)
    quad((-oc, 1.0, 1 + oc), (-oc, 1.0, 1 - oc), (oc, 1.0, 1 - oc),
         (oc, 1.0, 1 + oc), 0)
    occ_ids = list(range(base_ids, base_ids + 4))

    albedo = np.array([[0.7, 0.7, 0.7], [0.6, 0.6, 0.6]], np.float32)
    emission = np.array([[0, 0, 0], [114.0, 114.0, 114.0]], np.float32)
    scene = make_scene(np.array(verts, np.float32),
                       np.array(tris, np.int32),
                       np.array(mats, np.int32), albedo, emission)
    return scene, np.array(tris, np.int32), occ_ids


def test_shadow_silhouette_gradient_matches_fd():
    """d(x-weighted mean image)/d(occluder x-shift): the occluder is
    OFF-CAMERA, so interior + primary-edge terms are exactly zero; the
    NEE shadow boundary term (diff/edge_sampling.shadow_boundary_image)
    recovers the FD truth within Monte-Carlo tolerance (r1 verdict #5).
    The functional weights pixels by x because the plain mean is ~0 by
    the scene's x-symmetry (the shadow translates without changing area).
    Measured at blessing time: fd ~ 0.0435 (stable across eps), estimator
    mean ~ 0.0325 +- 0.006 over seeds — the ~25% residual is the
    remaining BRDF-branch direct term and bounce-1 shadows, documented in
    shadow_boundary_image's scope note."""
    from cudapathtracer.utils.morton import morton_decode

    scene, tris, occ_ids = shadow_scene()
    et = build_edge_table(tris)
    size = 32
    cam = make_camera(pos=(0.0, 0.8, 3.0), dist_from_film=1.0,
                      focal_length=3.0, width=size, height=size)
    cfg = RenderConfig(width=size, height=size, spp=1, integrator="pt_nee",
                       jitter=False, traversal="brute", num_bounces=2)
    key = jax.random.PRNGKey(7)
    SPP = 8
    SPP_FD = 256
    SES = 32768

    qsel = jnp.zeros((scene.num_verts,), jnp.float32).at[
        jnp.asarray(occ_ids)].set(1.0)
    idx = jnp.arange(size * size, dtype=jnp.uint32)
    px, _py = morton_decode(idx)
    wx = px.astype(jnp.float32) / size - 0.5

    def func(dx, ses, spp=SPP):
        verts = scene.verts._replace(x=scene.verts.x + dx * qsel)
        s = scene._replace(verts=verts)
        img = rg.render_image_diff(
            s, cam, cfg, key, spp,
            edge_table=et, shadow_edge_samples=ses)
        return jnp.mean((img.x + img.y + img.z) / 3.0 * wx)

    g_int = float(jax.grad(func)(0.0, 0))
    g_shadow = float(jax.grad(func)(0.0, SES))

    eps = 0.06
    fd = (float(func(eps, 0, SPP_FD))
          - float(func(-eps, 0, SPP_FD))) / (2 * eps)

    print(f"fd={fd:.5f} interior={g_int:.5f} with_shadow={g_shadow:.5f}")
    assert np.isfinite(fd) and np.isfinite(g_shadow)
    # occluder off-camera: interior + primary edges see nothing
    assert abs(g_int) < 0.05 * abs(fd), (g_int, fd)
    # shadow term recovers the FD truth within MC tolerance
    assert abs(g_shadow - fd) < abs(g_int - fd), (g_int, g_shadow, fd)
    assert fd * g_shadow > 0, (fd, g_shadow)
    assert 0.45 < g_shadow / fd < 1.5, (fd, g_shadow)
