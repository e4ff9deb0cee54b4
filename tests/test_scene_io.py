import numpy as np
import jax.numpy as jnp
import pytest

from cudapathtracer.models import procedural
from cudapathtracer.models.loader import load_obj, load_objs
from cudapathtracer.models.objio import parse_mtl, parse_obj
from cudapathtracer.models.scene import make_scene, merge_scenes


@pytest.fixture
def cornell_obj(tmp_path):
    desc = procedural.cornell_box()
    obj = tmp_path / "cornell.obj"
    mtl = tmp_path / "cornell.mtl"
    procedural.write_obj(obj, mtl, desc)
    return obj, desc


def test_parse_obj_counts(cornell_obj):
    obj, desc = cornell_obj
    shapes, materials = parse_obj(obj)
    total_faces = sum(len(s.material_ids) for s in shapes)
    assert total_faces == desc["tris"].shape[0]
    assert len(materials) == 4
    by_name = {m.name: m for m in materials}
    np.testing.assert_allclose(
        by_name["red"].diffuse, desc["albedo"][1], rtol=1e-6
    )
    np.testing.assert_allclose(
        by_name["light"].emission, desc["emission"][3], rtol=1e-6
    )


def test_load_obj_scene_matches_procedural(cornell_obj):
    obj, desc = cornell_obj
    scene = load_obj(obj, use_native=False)
    ref = procedural.to_scene(desc)
    assert scene.num_tris == ref.num_tris
    assert scene.num_lights == ref.num_lights
    np.testing.assert_allclose(
        float(scene.total_light_area), float(ref.total_light_area), rtol=1e-5
    )
    # geometry equivalence: sorted triangle centroids match
    def centroids(s):
        v = np.stack([np.asarray(s.verts.x), np.asarray(s.verts.y),
                      np.asarray(s.verts.z)], 1)
        i = np.stack([np.asarray(s.tri_v0), np.asarray(s.tri_v1),
                      np.asarray(s.tri_v2)], 1)
        c = v[i].mean(1)
        return c[np.lexsort(c.T)]

    np.testing.assert_allclose(centroids(scene), centroids(ref), atol=1e-5)


def test_load_obj_transform(cornell_obj):
    obj, desc = cornell_obj
    s1 = load_obj(obj, use_native=False)
    s2 = load_obj(obj, origin=(1.0, 2.0, 3.0), scale=2.0, use_native=False)
    # v*scale + origin (modelLoader.h:171-173)
    np.testing.assert_allclose(
        np.asarray(s2.verts.x), np.asarray(s1.verts.x) * 2.0 + 1.0, rtol=1e-5
    )
    # light area scales by scale^2
    np.testing.assert_allclose(
        float(s2.total_light_area), float(s1.total_light_area) * 4.0,
        rtol=1e-5,
    )


def test_flip_normals(cornell_obj):
    obj, _ = cornell_obj
    s1 = load_obj(obj, use_native=False)
    s2 = load_obj(obj, flip_normals=True, use_native=False)
    np.testing.assert_allclose(
        np.asarray(s2.tri_norm.x), -np.asarray(s1.tri_norm.x), atol=1e-7
    )


def test_load_objs_merge(cornell_obj):
    obj, _ = cornell_obj
    merged = load_objs([(str(obj), (0, 0, 0), 1.0),
                        (str(obj), (5, 0, 0), 0.5)])
    single = load_obj(obj, use_native=False)
    assert merged.num_tris == 2 * single.num_tris
    assert merged.num_lights == 2 * single.num_lights
    # indices of the second copy must not collide with the first
    assert int(jnp.max(merged.tri_v0)) < merged.num_verts


def test_negative_indices_and_fan(tmp_path):
    p = tmp_path / "quad.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\n"
        "f -4 -3 -2 -1\n"  # negative indices + quad fan
    )
    shapes, _ = parse_obj(p)
    assert len(shapes) == 1
    assert len(shapes[0].material_ids) == 2  # fan-triangulated
    idx = np.asarray(shapes[0].indices).reshape(-1, 3)
    np.testing.assert_array_equal(idx[0], [0, 1, 2])
    np.testing.assert_array_equal(idx[1], [0, 2, 3])


def test_mtl_keys(tmp_path):
    p = tmp_path / "m.mtl"
    p.write_text(
        "newmtl a\nKa 0.1 0.1 0.1\nKd 0.2 0.3 0.4\nKs 1 1 1\n"
        "Ke 5 6 7\nNs 10\nNi 1.5\nd 0.9\nillum 2\n"
    )
    mats = parse_mtl(p)
    m = mats["a"]
    assert m.diffuse == (0.2, 0.3, 0.4)
    assert m.emission == (5.0, 6.0, 7.0)
    assert m.shininess == 10 and m.ior == 1.5 and m.illum == 2


def test_emissive_detection_red_channel_quirk():
    # emission.r == 0 but g > 0: the reference does NOT treat it as a light
    # (modelLoader.h:191 tests .r only) — replicated.
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    s = make_scene(verts, tris, [0], [[1, 1, 1]], [[0.0, 5.0, 0.0]])
    assert s.num_lights == 0
    s2 = make_scene(verts, tris, [0], [[1, 1, 1]], [[2.0, 0.0, 0.0]])
    assert s2.num_lights == 1


def test_obj_roundtrip_render_parity(tmp_path):
    """End-to-end at scale: colonnade written as OBJ+MTL, parsed back (the
    native parser when available), must render the IDENTICAL image as the
    procedural scene — loader, material mapping, normals, light table and
    accel all agree."""
    import cudapathtracer as cpt
    from cudapathtracer.models import procedural
    from cudapathtracer.models.loader import load_obj

    desc = procedural.colonnade(subdiv=1)
    po, pm = str(tmp_path / "c.obj"), str(tmp_path / "c.mtl")
    procedural.write_obj(po, pm, desc)
    loaded = load_obj(po)
    ref = procedural.to_scene(desc)
    assert loaded.num_tris == ref.num_tris
    assert abs(float(loaded.total_light_area)
               - float(ref.total_light_area)) < 1e-4

    cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=32, height=32,
                          focal_length=2.0)
    cfg = cpt.RenderConfig(width=32, height=32, spp=2,
                           integrator="pt_nee", samples_per_call=2)
    a = cpt.render(loaded, cam, cfg, seed=5)
    b = cpt.render(ref, cam, cfg, seed=5)
    import numpy as np

    np.testing.assert_allclose(np.asarray(a.img.x), np.asarray(b.img.x),
                               rtol=1e-4, atol=1e-5)
