"""Packet traversal (ops/packets.py): bit-parity with the brute oracle and
with the fine BVH, overflow-fallback correctness, masking, and the cull's
conservativeness. The reference has no analogue (its traversal is per-thread,
kernel.cu:112-161); parity targets are our own oracles."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudapathtracer import RenderConfig, make_camera
from cudapathtracer.models import procedural
from cudapathtracer.ops import packets, traversal
from cudapathtracer.ops.rng import pixel_keys, sample_key
from cudapathtracer.ops.vecmath import Vec3
from cudapathtracer.render.camera import camera_rays
from cudapathtracer.render.renderer import build_bvh_for_scene


@pytest.fixture(scope="module")
def setup():
    scene = procedural.to_scene(procedural.cornell_with_sphere_mesh(subdiv=2))
    accel = build_bvh_for_scene(scene, leaf_size=4, cluster_size=16)
    td = traversal.make_trace_data(scene, accel.fine)
    pd = packets.make_packet_data(
        scene,
        Vec3(accel.cl_lo_x, accel.cl_lo_y, accel.cl_lo_z),
        Vec3(accel.cl_hi_x, accel.cl_hi_y, accel.cl_hi_z),
        accel.cl_tri,
    )
    cam = make_camera(width=32, height=32)
    idx = jnp.arange(32 * 32, dtype=jnp.uint32)
    keys = pixel_keys(sample_key(jax.random.PRNGKey(0), 0), idx)
    o, d = camera_rays(cam, idx, keys, jitter=False)
    return scene, td, pd, o, d


def test_packets_match_brute_primary(setup):
    scene, td, pd, o, d = setup
    hb = traversal.trace_bruteforce(o, d, scene)
    hp = packets.trace_packets(o, d, pd, fine_td=td, tile_size=64,
                               max_clusters=8)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
    np.testing.assert_array_equal(np.asarray(hp.t), np.asarray(hb.t))


def test_packets_overflow_fallback_still_exact(setup):
    """Tiny shortlist forces heavy overflow; the fine-BVH fallback must keep
    results exact."""
    scene, td, pd, o, d = setup
    hb = traversal.trace_bruteforce(o, d, scene)
    hp = packets.trace_packets(o, d, pd, fine_td=td, tile_size=64,
                               max_clusters=1)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
    np.testing.assert_array_equal(np.asarray(hp.t), np.asarray(hb.t))


def test_packets_incoherent_rays(setup):
    """Random origins/directions (worst case for tile bounds) stay exact."""
    scene, td, pd, _, _ = setup
    k = jax.random.PRNGKey(3)
    ko, kd = jax.random.split(k)
    R = 512
    o = Vec3.from_array(jax.random.uniform(ko, (R, 3), minval=0.0,
                                           maxval=1.0))
    d = Vec3.from_array(
        jax.random.normal(kd, (R, 3)) + 1e-3  # avoid exact zeros
    )
    hb = traversal.trace_bruteforce(o, d, scene)
    hp = packets.trace_packets(o, d, pd, fine_td=td, tile_size=128,
                               max_clusters=4)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
    np.testing.assert_array_equal(np.asarray(hp.t), np.asarray(hb.t))


def test_packets_mask_semantics(setup):
    scene, td, pd, o, d = setup
    R = o.x.shape[0]
    mask = (jnp.arange(R) % 3) != 0
    hp = packets.trace_packets(o, d, pd, fine_td=td, mask=mask,
                               tile_size=64, max_clusters=8)
    hb = traversal.trace_bruteforce(o, d, scene, mask=mask)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
    m = np.asarray(mask)
    assert (np.asarray(hp.tri)[~m] == -1).all()
    assert (np.asarray(hp.t)[~m] == 1e5).all()


def test_packets_nonmultiple_ray_count(setup):
    """R not a multiple of tile_size pads internally and trims the result."""
    scene, td, pd, o, d = setup
    sl = slice(0, 100)
    o2 = Vec3(o.x[sl], o.y[sl], o.z[sl])
    d2 = Vec3(d.x[sl], d.y[sl], d.z[sl])
    hb = traversal.trace_bruteforce(o2, d2, scene)
    hp = packets.trace_packets(o2, d2, pd, fine_td=td, tile_size=64,
                               max_clusters=8)
    assert hp.t.shape == (100,)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))


def test_cull_is_conservative(setup):
    """Every cluster containing a ray's true hit must pass the tile cull."""
    scene, td, pd, o, d = setup
    R = o.x.shape[0]
    P = 64
    Tl = R // P
    hb = traversal.trace_bruteforce(o, d, scene)

    def bounds(v):
        return v.reshape(Tl, P).min(1, keepdims=True), \
               v.reshape(Tl, P).max(1, keepdims=True)

    olo_x, ohi_x = bounds(np.asarray(o.x))
    olo_y, ohi_y = bounds(np.asarray(o.y))
    olo_z, ohi_z = bounds(np.asarray(o.z))
    dlo_x, dhi_x = bounds(np.asarray(d.x))
    dlo_y, dhi_y = bounds(np.asarray(d.y))
    dlo_z, dhi_z = bounds(np.asarray(d.z))
    hit, _ = packets.tile_cull(
        Vec3(jnp.asarray(olo_x), jnp.asarray(olo_y), jnp.asarray(olo_z)),
        Vec3(jnp.asarray(ohi_x), jnp.asarray(ohi_y), jnp.asarray(ohi_z)),
        Vec3(jnp.asarray(dlo_x), jnp.asarray(dlo_y), jnp.asarray(dlo_z)),
        Vec3(jnp.asarray(dhi_x), jnp.asarray(dhi_y), jnp.asarray(dhi_z)),
        Vec3(pd.cl_lo.x[None, :], pd.cl_lo.y[None, :], pd.cl_lo.z[None, :]),
        Vec3(pd.cl_hi.x[None, :], pd.cl_hi.y[None, :], pd.cl_hi.z[None, :]),
    )
    hit = np.asarray(hit)
    cl_tri = np.asarray(pd.tri)[:-1]  # drop sentinel row
    tri_best = np.asarray(hb.tri)
    for r in np.flatnonzero(tri_best >= 0):
        tile = r // P
        owners = np.flatnonzero((cl_tri == tri_best[r]).any(axis=1))
        assert hit[tile, owners].any(), (
            f"ray {r}: no owning cluster of tri {tri_best[r]} passed the cull"
        )


def test_render_packets_matches_bvh_render(setup):
    """End-to-end: a packets render equals the bvh render.

    Hit results are bit-identical (tests above), but the surrounding
    radiance arithmetic is fused differently by XLA in the two programs
    (FMA contraction), so the images agree to ULP-level tolerance only."""
    import cudapathtracer as cpt

    scene = procedural.to_scene(procedural.cornell_box())
    cam = make_camera(width=32, height=32)
    kw = dict(width=32, height=32, spp=2, integrator="pt_nee",
              samples_per_call=2)
    sp = cpt.render(scene, cam, RenderConfig(traversal="packets", **kw),
                    seed=5)
    sb = cpt.render(scene, cam, RenderConfig(traversal="bvh", **kw), seed=5)
    for a, b in [(sp.img.x, sb.img.x), (sp.img.y, sb.img.y),
                 (sp.img.z, sb.img.z)]:
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_windowed_sort_exact(setup):
    """sort_window > 0 (windowed ray sorting) stays exact vs brute force —
    any grouping is correct because each (ray, tri) test is position-
    independent and the U-bound/fallback covers dropped clusters — incl.
    with straggler rounds, masks, and R not a multiple of the window."""
    scene, td, pd, o, d = setup
    hb = traversal.trace_bruteforce(o, d, scene)
    for rounds in (1, 2):
        hp = packets.trace_packets(o, d, pd, fine_td=td, tile_size=64,
                                   max_clusters=8, sort=True,
                                   rounds=rounds, first_round_slots=2,
                                   sort_window=256)
        np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
        np.testing.assert_array_equal(np.asarray(hp.t), np.asarray(hb.t))

    R = o.x.shape[0]
    mask = (jnp.arange(R) % 3) != 0
    sl = slice(0, R - 100)  # R-100 = 924: not a multiple of the 256 window
    o2 = Vec3(o.x[sl], o.y[sl], o.z[sl])
    d2 = Vec3(d.x[sl], d.y[sl], d.z[sl])
    m2 = mask[sl]
    hb2 = traversal.trace_bruteforce(o2, d2, scene, mask=m2)
    hp2 = packets.trace_packets(o2, d2, pd, fine_td=td, mask=m2,
                                tile_size=64, max_clusters=8, sort=True,
                                sort_window=256)
    np.testing.assert_array_equal(np.asarray(hp2.tri), np.asarray(hb2.tri))
    np.testing.assert_array_equal(np.asarray(hp2.t), np.asarray(hb2.t))


def test_two_level_cull_exact(setup):
    """Hierarchical supercluster culling stays exact vs brute force — the
    dropped-super entries fold into the U bound, so rays whose shortlist
    missed the true owner re-trace through the fine BVH. Forced on with
    tiny super shortlists (heavy dropping), with/without rounds and with
    incoherent rays."""
    scene, td, pd, o, d = setup
    hb = traversal.trace_bruteforce(o, d, scene)
    for ms, fr in ((2, 1), (4, 2)):
        hp = packets.trace_packets(o, d, pd, fine_td=td, tile_size=64,
                                   max_clusters=8, two_level=True,
                                   super_factor=4, super_slots=ms,
                                   rounds=fr, first_round_slots=2, sort=True)
        np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
        np.testing.assert_array_equal(np.asarray(hp.t), np.asarray(hb.t))

    k = jax.random.PRNGKey(11)
    ko, kd = jax.random.split(k)
    R = 512
    o2 = Vec3.from_array(jax.random.uniform(ko, (R, 3), minval=0.0,
                                            maxval=1.0))
    d2 = Vec3.from_array(jax.random.normal(kd, (R, 3)) + 1e-3)
    hb2 = traversal.trace_bruteforce(o2, d2, scene)
    hp2 = packets.trace_packets(o2, d2, pd, fine_td=td, tile_size=128,
                                max_clusters=16, two_level=True,
                                super_factor=8, super_slots=3)
    np.testing.assert_array_equal(np.asarray(hp2.tri), np.asarray(hb2.tri))
    np.testing.assert_array_equal(np.asarray(hp2.t), np.asarray(hb2.t))


def test_t_cap_exact(setup):
    """Capped queries (t_cap): hits below the cap are exact, hits at/beyond
    it report as the canonical miss — matching apply_t_cap over the brute
    oracle, across rounds, the two-level cull and the fallback path."""
    scene, td, pd, o, d = setup
    hb = traversal.trace_bruteforce(o, d, scene)
    # caps straddling the real hit distances: some rays capped out, some not
    R = o.x.shape[0]
    caps = jnp.where(jnp.arange(R) % 2 == 0, 1.5,
                     jnp.asarray(hb.t))  # half at a fixed 1.5, half AT t
    ref = traversal.apply_t_cap(hb, caps)
    for kw in (dict(), dict(rounds=2, first_round_slots=2, sort=True),
               dict(max_clusters=1),           # heavy fallback
               dict(two_level=True, super_factor=4, super_slots=3)):
        hp = packets.trace_packets(o, d, pd, fine_td=td, tile_size=64,
                                   max_clusters=kw.pop("max_clusters", 8),
                                   t_cap=caps, **kw)
        np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(ref.tri))
        np.testing.assert_array_equal(np.asarray(hp.t), np.asarray(ref.t))


def test_multi_round_splitting_exact(setup):
    """rounds=2 (straggler splitting) must stay exact vs brute force, with
    coherent, incoherent and masked batches."""
    scene, td, pd, o, d = setup
    hb = traversal.trace_bruteforce(o, d, scene)
    hp = packets.trace_packets(o, d, pd, fine_td=td, tile_size=64,
                               max_clusters=8, rounds=2,
                               first_round_slots=2, sort=True)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
    np.testing.assert_array_equal(np.asarray(hp.t), np.asarray(hb.t))

    R = o.x.shape[0]
    mask = (jnp.arange(R) % 3) != 0
    hp2 = packets.trace_packets(o, d, pd, fine_td=td, mask=mask,
                                tile_size=64, max_clusters=8, rounds=2,
                                first_round_slots=1, sort=True)
    hb2 = traversal.trace_bruteforce(o, d, scene, mask=mask)
    np.testing.assert_array_equal(np.asarray(hp2.tri), np.asarray(hb2.tri))


def test_packets_match_brute_mt_intersector(setup):
    """The legacy 'mt' intersector stays selectable and engine-consistent:
    packets(mt) == brute(mt) bitwise (cfg.intersector plumbs it through
    every engine including the fine-BVH fallback)."""
    scene, td, pd, o, d = setup
    hb = traversal.trace_bruteforce(o, d, scene, intersector="mt")
    hp = packets.trace_packets(o, d, pd, fine_td=td, tile_size=64,
                               max_clusters=8, intersector="mt")
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(hb.tri))
    np.testing.assert_array_equal(np.asarray(hp.t), np.asarray(hb.t))


def test_packets_bw_vs_mt_only_tie_flips(setup):
    """BW and MT agree on t to ~1e-5 relative wherever both report a hit.

    Verdict flips (hit vs miss) DO occur, but only on shared-edge seams:
    this test camera is a 32x32 no-jitter pinhole over an axis-aligned
    cornell box, so a band of rays lands EXACTLY on the quad-diagonal
    seams (barycentric b2 ~ 3e-7). There MT's rounding can reject BOTH
    triangles of the quad (the watertightness crack MT always had —
    reference modelLoader.h rejects on any strictly-negative barycentric)
    while BW's rounding accepts one, or vice versa. Each intersector is
    self-consistent across engines (the bit-parity tests above); this test
    pins the cross-intersector contract: hit-t agreement + flips bounded
    to the pathological seam band."""
    scene, td, pd, o, d = setup
    h_bw = packets.trace_packets(o, d, pd, fine_td=td, tile_size=64,
                                 max_clusters=8, intersector="bw")
    h_mt = packets.trace_packets(o, d, pd, fine_td=td, tile_size=64,
                                 max_clusters=8, intersector="mt")
    t_bw, t_mt = np.asarray(h_bw.t), np.asarray(h_mt.t)
    both = (t_bw < 1e5) & (t_mt < 1e5)
    np.testing.assert_allclose(t_bw[both], t_mt[both], rtol=2e-5, atol=2e-6)
    flips = (t_bw < 1e5) != (t_mt < 1e5)
    assert flips.mean() < 0.06, f"seam-flip fraction {flips.mean():.4f}"


@pytest.mark.parametrize("max_clusters", [8, 1])
def test_visibility_decision_matches_brute(setup, max_clusters):
    """BDPT's shadow connections (integrators/bdpt.py) ask a capped
    visibility query: visible iff |t - len| <= EPS_VISIBILITY with
    t_cap = len + 2 eps. The packet engine's decision must equal the
    brute-force oracle's on every lane, with a normal shortlist and with a
    one-slot shortlist that sends most rays through the fallback."""
    from cudapathtracer.utils.constants import EPS_VISIBILITY

    scene, td, pd, o, d = setup
    # shadow-style queries: from just before the camera hits toward one
    # point on the ceiling — straight up from the scene's centre — so some
    # segments are occluded and some reach it
    h0 = traversal.trace_bruteforce(o, d, scene)
    t0 = jnp.where(h0.tri >= 0, h0.t - 1e-3, 1.0)
    pos = o + d * t0
    R = o.x.shape[0]
    c = Vec3(*(jnp.full((1,), jnp.mean(v)) for v in scene.verts))
    up = Vec3(jnp.zeros((1,)), jnp.ones((1,)), jnp.zeros((1,)))
    t_up = traversal.trace_bruteforce(c, up, scene).t
    tgt = Vec3(*(jnp.broadcast_to(v, (R,)) for v in c + up * t_up))
    seg = tgt - pos
    ln = jnp.sqrt(seg.x**2 + seg.y**2 + seg.z**2)
    dirn = Vec3(seg.x / ln, seg.y / ln, seg.z / ln)
    cap = ln + 2.0 * EPS_VISIBILITY

    ref = traversal.apply_t_cap(
        traversal.trace_bruteforce(pos, dirn, scene), cap)
    hp = packets.trace_packets(pos, dirn, pd, fine_td=td, tile_size=64,
                               max_clusters=max_clusters, sort=True,
                               t_cap=cap)

    def visible(h):
        return np.abs(np.asarray(h.t) - np.asarray(ln)) <= EPS_VISIBILITY

    vis_ref = visible(ref)
    assert vis_ref.any() and not vis_ref.all()  # both outcomes occur
    np.testing.assert_array_equal(visible(hp), vis_ref)
    np.testing.assert_array_equal(np.asarray(hp.tri), np.asarray(ref.tri))
