import numpy as np
import jax
import jax.numpy as jnp

from cudapathtracer.models import procedural
from cudapathtracer.ops import sampling
from cudapathtracer.ops.vecmath import Vec3, dot


def _n(shape, x, y, z):
    return Vec3.full(shape, x, y, z)


def test_tangent_frame_reference_semantics():
    # For n = (0, 1, 0): c1 = cross(n, z) = (1, 0, 0) with |c1| = 1;
    # c2 = cross(n, y) = 0 -> picks c1 (kernel.cu:47-53).
    n = _n((1,), 0.0, 1.0, 0.0)
    t, b = sampling.tangent_frame(n)
    np.testing.assert_allclose(t.to_array(), [[1, 0, 0]], atol=1e-7)
    np.testing.assert_allclose(b.to_array(), [[0, 0, -1]], atol=1e-7)
    # tilted normal (NOT perpendicular to either frame axis): unnormalized
    # frame (reference quirk) — |t| = sin(angle to the chosen axis) < 1
    s = float(np.sqrt(0.2**2 + 0.9**2 + 0.4**2))
    n2 = Vec3(jnp.asarray([0.2 / s]), jnp.asarray([0.9 / s]),
              jnp.asarray([0.4 / s]))
    t2, b2 = sampling.tangent_frame(n2)
    assert float(jnp.sqrt(dot(t2, t2))[0]) < 1.0 - 1e-4
    t2o, b2o = sampling.tangent_frame(n2, orthonormal=True)
    np.testing.assert_allclose(float(jnp.sqrt(dot(t2o, t2o))[0]), 1.0, rtol=1e-6)


def test_hemisphere_samples_above_surface():
    key = jax.random.PRNGKey(0)
    u1 = jax.random.uniform(key, (4096,))
    u2 = jax.random.uniform(jax.random.fold_in(key, 1), (4096,))
    n = _n((4096,), 0.0, 1.0, 0.0)
    for fn in (sampling.uniform_hemisphere, sampling.cosine_hemisphere):
        d = fn(n, u1, u2)
        lens = np.linalg.norm(d.to_array(), axis=1)
        np.testing.assert_allclose(lens, 1.0, rtol=1e-5)
        assert np.all(np.asarray(dot(d, n)) >= -1e-6)


def test_cosine_hemisphere_mean_cos():
    # E[cos theta] = 2/3 for pdf cos/pi (orthonormal frame so the nominal
    # distribution is exact).
    key = jax.random.PRNGKey(42)
    m = 200_000
    u1 = jax.random.uniform(key, (m,))
    u2 = jax.random.uniform(jax.random.fold_in(key, 1), (m,))
    n = _n((m,), 0.0, 1.0, 0.0)
    d = sampling.cosine_hemisphere(n, u1, u2, orthonormal=True)
    mean_cos = float(jnp.mean(dot(d, n)))
    assert abs(mean_cos - 2.0 / 3.0) < 0.01


def test_uniform_hemisphere_reference_distribution():
    # reference randRay: y = u1 (cos uniform in [0,1]) -> E[cos] = 0.5
    key = jax.random.PRNGKey(7)
    m = 200_000
    u1 = jax.random.uniform(key, (m,))
    u2 = jax.random.uniform(jax.random.fold_in(key, 1), (m,))
    n = _n((m,), 0.0, 1.0, 0.0)
    d = sampling.uniform_hemisphere(n, u1, u2, orthonormal=True)
    mean_cos = float(jnp.mean(dot(d, n)))
    assert abs(mean_cos - 0.5) < 0.01


def test_triangle_point_fold():
    v0 = _n((2,), 0.0, 0.0, 0.0)
    a1 = _n((2,), 1.0, 0.0, 0.0)
    a2 = _n((2,), 0.0, 1.0, 0.0)
    u = jnp.asarray([0.25, 0.9])
    v = jnp.asarray([0.25, 0.8])
    p = sampling.sample_triangle_point(v0, a1, a2, u, v)
    np.testing.assert_allclose(np.asarray(p.x), [0.25, 1 - 0.9], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(p.y), [0.25, 1 - 0.8], rtol=1e-6)
    # folded points stay inside the triangle
    assert float(p.x[1] + p.y[1]) <= 1.0


def _ref_pick(rand_area, areas, lights):
    """Literal transcription of kernel.cu:231-244."""
    selected = 0
    for j in range(len(lights)):
        if 0 < rand_area < areas[j]:
            selected = lights[j]
        rand_area -= areas[j]
    return selected


def test_pick_light_matches_reference_scan():
    rng = np.random.default_rng(0)
    areas = rng.uniform(0.1, 2.0, 7).astype(np.float32)
    lights = rng.permutation(100)[:7].astype(np.int32)
    total = areas.sum()
    us = np.concatenate([rng.uniform(0, 1, 300), [0.0]])
    rand_areas = (total * us).astype(np.float32)
    ours = np.asarray(
        sampling.pick_light(
            jnp.asarray(rand_areas), jnp.asarray(areas), jnp.asarray(lights)
        )
    )
    ref = np.array(
        [_ref_pick(float(ra), areas, lights) for ra in rand_areas], np.int32
    )
    np.testing.assert_array_equal(ours, ref)
    # u == 0 -> fallback scene-tri 0 (reference quirk)
    assert ref[-1] == 0 and ours[-1] == 0


def test_light_areas_cornell():
    scene = procedural.to_scene(procedural.cornell_box())
    areas = sampling.triangle_areas(scene, scene.lights)
    total = float(jnp.sum(areas))
    np.testing.assert_allclose(total, float(scene.total_light_area), rtol=1e-6)
    np.testing.assert_allclose(total, (2 * 0.47) ** 2, rtol=1e-5)


def test_pick_light_slot_large_L_matches_scan():
    """L > 64 switches pick_light_slot to the binary-search path; it must
    agree with the small-L broadcast scan exactly (r1 verdict item 7)."""
    import numpy as np
    from cudapathtracer.ops.shading import pick_light_slot

    rng = np.random.default_rng(3)
    L = 517
    areas = jnp.asarray(rng.uniform(0.01, 2.0, L).astype(np.float32))
    total = float(jnp.cumsum(areas)[-1])  # the scan's own total
    x = jnp.asarray(
        rng.uniform(-0.1 * total, 1.1 * total, 20000).astype(np.float32))

    # reference: the broadcast scan (the small-L implementation, forced)
    cum = jnp.cumsum(areas)
    prev = cum - areas
    rem = x[:, None] - prev[None, :]
    match = (rem > 0.0) & (rem < areas[None, :])
    ref = jnp.where(jnp.any(match, axis=1),
                    jnp.argmax(match, axis=1).astype(jnp.int32), L)

    got = pick_light_slot(x, areas)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(ref))

    # boundary fallthrough: x exactly on a bin edge, <= 0, >= total
    edges = jnp.concatenate([cum[:5], jnp.asarray([0.0, -1.0, total,
                                                   total + 1.0])])
    got_e = pick_light_slot(edges, areas)
    assert int(got_e[5]) == L and int(got_e[6]) == L
    assert int(got_e[7]) == L and int(got_e[8]) == L


def test_many_light_scene_renders():
    """A 512-emissive-tri scene renders through the binary-search light
    pick without the (R, L) broadcast memory cliff."""
    import numpy as np
    from cudapathtracer import RenderConfig, make_camera, render
    from cudapathtracer.models.scene import make_scene

    rng = np.random.default_rng(0)
    # a field of 256 small emissive quads (512 tris) over a floor
    verts = [(-4, 0, -4), (-4, 0, 4), (4, 0, 4), (4, 0, -4)]
    tris = [(0, 1, 2), (0, 2, 3)]
    mats = [0, 0]
    for i in range(256):
        cx, cz = rng.uniform(-3, 3, 2)
        s = 0.05
        b = len(verts)
        verts += [(cx - s, 2.0, cz + s), (cx + s, 2.0, cz + s),
                  (cx + s, 2.0, cz - s), (cx - s, 2.0, cz - s)]
        tris += [(b, b + 1, b + 2), (b, b + 2, b + 3)]
        mats += [1, 1]
    albedo = np.array([[0.7, 0.7, 0.7], [0.5, 0.5, 0.5]], np.float32)
    emission = np.array([[0, 0, 0], [30.0, 30.0, 30.0]], np.float32)
    scene = make_scene(np.array(verts, np.float32),
                       np.array(tris, np.int32),
                       np.array(mats, np.int32), albedo, emission)
    assert int(scene.num_lights) == 512

    cam = make_camera(pos=(0.0, 1.0, 5.0), width=16, height=16)
    cfg = RenderConfig(width=16, height=16, spp=4, integrator="pt_nee",
                       samples_per_call=4, traversal="brute",
                       light_normal_mode="true")
    st = render(scene, cam, cfg, seed=2)
    img = np.asarray(st.img.x)
    assert np.isfinite(img).all() and img.max() > 0
