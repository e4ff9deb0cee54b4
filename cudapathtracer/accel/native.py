"""ctypes bindings for the native C++ components (native/*.cpp).

The reference's host-side hot paths are native C++ — the recursive BVH
build (BVH.h:133-328) and the string-heavy OBJ parse (tiny_obj_loader.cc).
Their twins here live in native/bvh_builder.cpp and
native/obj_loader.cpp, compiled to one shared library. These bindings load
it with ctypes (no pybind11 in this toolchain) and fall back gracefully:
callers catch ImportError/OSError and use the pure-Python twins, which are
tested to produce identical output.

The library is built on demand (``make -C native``) the first time it is
requested — a deliberate convenience so a fresh checkout works without a
separate build step; set CPT_NO_NATIVE=1 to disable native entirely.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_NATIVE_DIR = os.path.join(os.path.dirname(_HERE), "native")
_LIB_PATH = os.path.join(_NATIVE_DIR, "libcptnative.so")

_lib = None
_lock = threading.Lock()


class _BVHOut(C.Structure):
    _fields_ = [
        ("n_nodes", C.c_int64),
        ("n_leaves", C.c_int64),
        ("leaf_size", C.c_int32),
        ("depth", C.c_int32),
        ("node_lo", C.POINTER(C.c_float)),
        ("node_hi", C.POINTER(C.c_float)),
        ("node_skip", C.POINTER(C.c_int32)),
        ("node_leaf", C.POINTER(C.c_int32)),
        ("leaf_tri", C.POINTER(C.c_int32)),
    ]


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        if os.environ.get("CPT_NO_NATIVE"):
            raise ImportError("native disabled via CPT_NO_NATIVE")
        if not os.path.exists(_LIB_PATH):
            subprocess.run(
                ["make", "-C", _NATIVE_DIR], check=True,
                capture_output=True, text=True,
            )
        try:
            lib = C.CDLL(_LIB_PATH)
        except OSError:
            # A concurrent process may have published a new .so between our
            # stat and dlopen (the Makefile's rename is atomic, but an old
            # pre-atomic partial file could remain). Force one rebuild.
            subprocess.run(
                ["make", "-B", "-C", _NATIVE_DIR], check=True,
                capture_output=True, text=True,
            )
            lib = C.CDLL(_LIB_PATH)

        lib.cpt_build_bvh.restype = C.c_int
        lib.cpt_build_bvh.argtypes = [
            C.POINTER(C.c_float), C.c_int64,
            C.POINTER(C.c_int32), C.c_int64,
            C.c_int32, C.POINTER(_BVHOut),
        ]
        lib.cpt_free_bvh.argtypes = [C.POINTER(_BVHOut)]

        lib.cpt_parse_obj.restype = C.c_void_p
        lib.cpt_parse_obj.argtypes = [C.c_char_p, C.c_char_p]
        lib.cpt_obj_error.restype = C.c_char_p
        lib.cpt_obj_error.argtypes = [C.c_void_p]
        for name in ("cpt_obj_num_shapes", "cpt_obj_num_materials"):
            fn = getattr(lib, name)
            fn.restype = C.c_int64
            fn.argtypes = [C.c_void_p]
        for name in ("cpt_obj_shape_num_verts", "cpt_obj_shape_num_faces",
                     "cpt_obj_shape_num_normals",
                     "cpt_obj_shape_num_texcoords"):
            fn = getattr(lib, name)
            fn.restype = C.c_int64
            fn.argtypes = [C.c_void_p, C.c_int64]
        lib.cpt_obj_material.argtypes = [C.c_void_p, C.c_int64,
                                         C.POINTER(C.c_float)]
        lib.cpt_obj_material_extra.argtypes = [C.c_void_p, C.c_int64,
                                               C.POINTER(C.c_float)]
        lib.cpt_obj_material_name.restype = C.c_char_p
        lib.cpt_obj_material_name.argtypes = [C.c_void_p, C.c_int64]
        lib.cpt_obj_shape_data.argtypes = [
            C.c_void_p, C.c_int64, C.POINTER(C.c_float),
            C.POINTER(C.c_int32), C.POINTER(C.c_int32),
            C.POINTER(C.c_float), C.POINTER(C.c_float),
        ]
        lib.cpt_obj_free.argtypes = [C.c_void_p]

        _lib = lib
        return lib


def native_available() -> bool:
    try:
        _load()
        return True
    except Exception:
        return False


def build_bvh_native(verts, tri_indices, leaf_size: int = 4):
    """C++ binned-SAH build -> host arrays matching accel.bvh.build_bvh's
    FlatBVH fields. Returns (dict of arrays, depth)."""
    lib = _load()
    verts = np.ascontiguousarray(verts, np.float32)
    tris = np.ascontiguousarray(tri_indices, np.int32)
    out = _BVHOut()
    rc = lib.cpt_build_bvh(
        verts.ctypes.data_as(C.POINTER(C.c_float)), verts.shape[0],
        tris.ctypes.data_as(C.POINTER(C.c_int32)), tris.shape[0],
        leaf_size, C.byref(out),
    )
    if rc != 0:
        raise RuntimeError(f"cpt_build_bvh failed with code {rc}")
    try:
        n, nl = out.n_nodes, out.n_leaves
        node_lo = np.ctypeslib.as_array(out.node_lo, (n, 3)).copy()
        node_hi = np.ctypeslib.as_array(out.node_hi, (n, 3)).copy()
        node_skip = np.ctypeslib.as_array(out.node_skip, (n,)).copy()
        node_leaf = np.ctypeslib.as_array(out.node_leaf, (n,)).copy()
        leaf_tri = np.ctypeslib.as_array(out.leaf_tri,
                                         (nl, leaf_size)).copy()
        depth = int(out.depth)
    finally:
        lib.cpt_free_bvh(C.byref(out))
    return dict(node_lo=node_lo, node_hi=node_hi, node_skip=node_skip,
                node_leaf=node_leaf, leaf_tri=leaf_tri), depth


def parse_obj_native(path, mtl_base_dir=None):
    """C++ OBJ parse -> (shapes, materials) with the same duck-typed fields
    as models.objio.parse_obj (ObjShape/ObjMaterial)."""
    from ..models.objio import ObjMaterial, ObjShape

    lib = _load()
    h = lib.cpt_parse_obj(
        os.fspath(path).encode(),
        (mtl_base_dir or "").encode(),
    )
    if not h:
        raise RuntimeError("cpt_parse_obj returned NULL")
    try:
        err = lib.cpt_obj_error(h)
        if err:
            raise RuntimeError(err.decode())

        materials = []
        buf13 = (C.c_float * 13)()
        buf3 = (C.c_float * 3)()
        for i in range(lib.cpt_obj_num_materials(h)):
            lib.cpt_obj_material(h, i, buf13)
            lib.cpt_obj_material_extra(h, i, buf3)
            v = list(buf13)
            materials.append(ObjMaterial(
                name=lib.cpt_obj_material_name(h, i).decode(),
                ambient=tuple(v[0:3]),
                diffuse=tuple(v[3:6]),
                specular=tuple(v[6:9]),
                emission=tuple(v[9:12]),
                shininess=v[12],
                ior=buf3[0],
                dissolve=buf3[1],
                illum=int(buf3[2]),
            ))

        shapes = []
        for s in range(lib.cpt_obj_num_shapes(h)):
            nv = lib.cpt_obj_shape_num_verts(h, s)
            nf = lib.cpt_obj_shape_num_faces(h, s)
            nn = lib.cpt_obj_shape_num_normals(h, s)
            nt = lib.cpt_obj_shape_num_texcoords(h, s)
            pos = np.empty(nv * 3, np.float32)
            idx = np.empty(nf * 3, np.int32)
            mid = np.empty(nf, np.int32)
            nrm = np.empty(nn * 3, np.float32)
            tex = np.empty(nt * 2, np.float32)
            lib.cpt_obj_shape_data(
                h, s,
                pos.ctypes.data_as(C.POINTER(C.c_float)),
                idx.ctypes.data_as(C.POINTER(C.c_int32)),
                mid.ctypes.data_as(C.POINTER(C.c_int32)),
                nrm.ctypes.data_as(C.POINTER(C.c_float)),
                tex.ctypes.data_as(C.POINTER(C.c_float)),
            )
            shapes.append(ObjShape(
                name="", positions=pos.tolist(), normals=nrm.tolist(),
                texcoords=tex.tolist(), indices=idx.tolist(),
                material_ids=mid.tolist(),
            ))
        return shapes, materials
    finally:
        lib.cpt_obj_free(h)
