"""Native C++ components vs their pure-Python twins: identical output."""

import numpy as np
import pytest

from cudapathtracer.accel import bvh as bvh_mod
from cudapathtracer.accel.native import (
    build_bvh_native,
    native_available,
    parse_obj_native,
)
from cudapathtracer.models import procedural
from cudapathtracer.models.objio import parse_obj

pytestmark = pytest.mark.skipif(
    not native_available(), reason="native lib not built and make failed"
)


@pytest.mark.parametrize("subdiv,leaf", [(1, 1), (1, 4), (2, 4), (2, 8)])
def test_bvh_builder_identical(subdiv, leaf):
    desc = procedural.colonnade(subdiv=subdiv)
    verts, tris = desc["verts"], desc["tris"]
    d, depth = build_bvh_native(verts, tris, leaf)
    flat, meta = bvh_mod.build_bvh(verts, tris, leaf)
    assert depth == meta.depth
    np.testing.assert_array_equal(d["node_skip"], np.asarray(flat.node_skip))
    np.testing.assert_array_equal(d["node_leaf"], np.asarray(flat.node_leaf))
    np.testing.assert_array_equal(d["leaf_tri"], np.asarray(flat.leaf_tri))
    np.testing.assert_array_equal(
        d["node_lo"],
        np.stack([np.asarray(flat.node_lo_x), np.asarray(flat.node_lo_y),
                  np.asarray(flat.node_lo_z)], 1),
    )
    np.testing.assert_array_equal(
        d["node_hi"],
        np.stack([np.asarray(flat.node_hi_x), np.asarray(flat.node_hi_y),
                  np.asarray(flat.node_hi_z)], 1),
    )


def test_bvh_builder_tiny():
    verts = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float32)
    tris = np.array([[0, 1, 2]], np.int32)
    d, depth = build_bvh_native(verts, tris, 4)
    assert d["node_skip"].shape[0] == 1
    assert d["node_leaf"][0] == 0
    assert d["node_skip"][0] == 1
    assert depth == 1


def test_obj_parser_identical(tmp_path):
    desc = procedural.cornell_box()
    obj = tmp_path / "c.obj"
    mtl = tmp_path / "c.mtl"
    procedural.write_obj(obj, mtl, desc)

    sh_py, mats_py = parse_obj(obj)
    sh_c, mats_c = parse_obj_native(str(obj))

    assert len(sh_c) == len(sh_py)
    assert len(mats_c) == len(mats_py)
    for mc, mp in zip(mats_c, mats_py):
        assert mc.name == mp.name
        np.testing.assert_allclose(mc.diffuse, mp.diffuse, rtol=1e-6)
        np.testing.assert_allclose(mc.emission, mp.emission, rtol=1e-6)
    for sc, sp in zip(sh_c, sh_py):
        np.testing.assert_allclose(sc.positions, sp.positions, rtol=1e-6)
        np.testing.assert_array_equal(sc.indices, sp.indices)
        np.testing.assert_array_equal(sc.material_ids, sp.material_ids)


def test_obj_parser_negative_indices(tmp_path):
    p = tmp_path / "q.obj"
    p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf -4 -3 -2 -1\n")
    sh_c, _ = parse_obj_native(str(p))
    sh_py, _ = parse_obj(p)
    np.testing.assert_array_equal(sh_c[0].indices, sh_py[0].indices)
    assert len(sh_c[0].material_ids) == 2


def test_obj_parser_vtn_forms(tmp_path):
    p = tmp_path / "t.obj"
    p.write_text(
        "v 0 0 0\nv 1 0 0\nv 0 1 0\n"
        "vt 0 0\nvt 1 0\nvt 0 1\n"
        "vn 0 0 1\n"
        "f 1/1/1 2/2/1 3/3/1\n"
        "f 1//1 2//1 3//1\n"
    )
    sh_c, _ = parse_obj_native(str(p))
    sh_py, _ = parse_obj(p)
    for c, pshape in zip(sh_c, sh_py):
        np.testing.assert_array_equal(c.indices, pshape.indices)
        np.testing.assert_allclose(c.positions, pshape.positions)


def test_loader_uses_native(tmp_path):
    from cudapathtracer.models.loader import load_obj

    desc = procedural.cornell_box()
    obj = tmp_path / "c.obj"
    procedural.write_obj(obj, tmp_path / "c.mtl", desc)
    s_native = load_obj(obj, use_native=True)
    s_python = load_obj(obj, use_native=False)
    np.testing.assert_array_equal(
        np.asarray(s_native.tri_v0), np.asarray(s_python.tri_v0)
    )
    np.testing.assert_allclose(
        np.asarray(s_native.verts.x), np.asarray(s_python.verts.x)
    )
