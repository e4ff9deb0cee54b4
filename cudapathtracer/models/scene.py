"""Scene representation: SoA arrays, a JAX pytree.

Mirrors the reference's flat device scene (modelLoader.h:14-41 ``triangle``,
``materialDesc``, ``sceneDesc``) as structure-of-arrays: vertices, triangle
vertex indices, per-triangle face normals and material ids, material
albedo/emission, an emissive-triangle index list and the total light area.
Triangle count is int32-indexed by design, like the reference
(modelLoader.h:27-28).

Being a NamedTuple pytree, a Scene can be donated to jit, replicated across
a device mesh, and differentiated (gradients flow to ``verts``,
``mat_albedo``, ``mat_emission`` — the gradient targets).

Spheres are a separate optional block (the reference's dormant sphere.h
capability, carried per the north star): center + radius + material id.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..ops.vecmath import Vec3, cross, length, normalized


class Scene(NamedTuple):
    verts: Vec3            # (V,) components
    tri_v0: jnp.ndarray    # (T,) int32
    tri_v1: jnp.ndarray    # (T,) int32
    tri_v2: jnp.ndarray    # (T,) int32
    tri_norm: Vec3         # (T,) face normals (modelLoader.h:201 winding)
    tri_mat: jnp.ndarray   # (T,) int32
    mat_albedo: Vec3       # (M,)
    mat_emission: Vec3     # (M,)
    lights: jnp.ndarray    # (L,) int32 scene-triangle indices of emissives
    total_light_area: jnp.ndarray  # () f32
    # dormant-capability sphere block (may be empty: S == 0)
    sph_center: Vec3       # (S,)
    sph_radius: jnp.ndarray  # (S,)
    sph_mat: jnp.ndarray   # (S,) int32

    @property
    def num_tris(self):
        return self.tri_v0.shape[0]

    @property
    def num_verts(self):
        return self.verts.x.shape[0]

    @property
    def num_mats(self):
        return self.mat_albedo.x.shape[0]

    @property
    def num_lights(self):
        return self.lights.shape[0]

    @property
    def num_spheres(self):
        return self.sph_radius.shape[0]


def _as_vec3(a, dtype=np.float32):
    a = np.asarray(a, dtype=dtype)
    return Vec3(jnp.asarray(a[:, 0]), jnp.asarray(a[:, 1]), jnp.asarray(a[:, 2]))


def make_scene(
    verts,
    tri_indices,
    tri_mats,
    albedo,
    emission,
    tri_normals=None,
    flip_normals=False,
    spheres=None,
):
    """Assemble a Scene from host arrays.

    Replicates the loader semantics of modelLoader.h:162-206 (with the quirk
    fixes recorded in SURVEY.md §7): face normals from winding
    ``normalize(cross(v1-v0, v2-v0))``, emissive detection by
    ``emission.r != 0`` (modelLoader.h:191), light area accumulation
    (modelLoader.h:194-197). Unlike the reference we do NOT duplicate the
    material table (modelLoader.h:137-159 pushes every MTL twice) and we use
    per-face material ids rather than shape-wide material_ids[0].

    verts: (V, 3) float; tri_indices: (T, 3) int; tri_mats: (T,) int;
    albedo/emission: (M, 3) float; spheres: optional (center (S,3),
    radius (S,), mat (S,)).
    """
    verts = np.asarray(verts, np.float32)
    tri_indices = np.asarray(tri_indices, np.int32)
    tri_mats = np.asarray(tri_mats, np.int32)
    albedo = np.asarray(albedo, np.float32).reshape(-1, 3)
    emission = np.asarray(emission, np.float32).reshape(-1, 3)
    T = tri_indices.shape[0]

    v0 = verts[tri_indices[:, 0]]
    v1 = verts[tri_indices[:, 1]]
    v2 = verts[tri_indices[:, 2]]
    if tri_normals is None:
        n = np.cross(v1 - v0, v2 - v0)
        nl = np.linalg.norm(n, axis=1, keepdims=True)
        n = n / np.where(nl == 0, 1.0, nl)
    else:
        n = np.asarray(tri_normals, np.float32)
    if flip_normals:
        n = -n

    # Emissive detection: emission.r != 0 (modelLoader.h:191 — quirk: only
    # the red channel is tested; replicated).
    is_light = emission[tri_mats, 0] != 0.0
    lights = np.nonzero(is_light)[0].astype(np.int32)
    areas = 0.5 * np.linalg.norm(
        np.cross(v1[lights] - v0[lights], v2[lights] - v0[lights]), axis=1
    )
    # typed accumulation at the host boundary: the reference types this
    # exact quantity (`siArea totalLightArea`, kernel.cu:422) and reads
    # .raw at the device boundary (kernel.cu:468) — same contract here
    # (utils/si.py; SURVEY.md §7 SI-units ledger entry)
    from ..utils.si import check_area, si_area

    total_light_area = np.float32(
        check_area(si_area(float(areas.sum())))
    )

    if spheres is None:
        sc = np.zeros((0, 3), np.float32)
        sr = np.zeros((0,), np.float32)
        sm = np.zeros((0,), np.int32)
    else:
        sc, sr, sm = spheres
        sc = np.asarray(sc, np.float32).reshape(-1, 3)
        sr = np.asarray(sr, np.float32).reshape(-1)
        sm = np.asarray(sm, np.int32).reshape(-1)

    scene = Scene(
        verts=_as_vec3(verts),
        tri_v0=jnp.asarray(tri_indices[:, 0]),
        tri_v1=jnp.asarray(tri_indices[:, 1]),
        tri_v2=jnp.asarray(tri_indices[:, 2]),
        tri_norm=_as_vec3(n.astype(np.float32)),
        tri_mat=jnp.asarray(tri_mats),
        mat_albedo=_as_vec3(albedo),
        mat_emission=_as_vec3(emission),
        lights=jnp.asarray(lights),
        total_light_area=jnp.asarray(total_light_area),
        sph_center=_as_vec3(sc) if sc.size else Vec3(jnp.zeros(0), jnp.zeros(0), jnp.zeros(0)),
        sph_radius=jnp.asarray(sr),
        sph_mat=jnp.asarray(sm),
    )
    register_host_geometry(scene, verts, tri_indices)
    return scene


# Host-side copies of scene geometry, keyed by the identity of the scene's
# device vertex array. The BVH builder needs geometry on the host, and
# every standard construction path starts from host arrays anyway, so the
# build needs no device readback.
_HOST_GEOMETRY: dict = {}


def register_host_geometry(scene: "Scene", verts, tri_indices):
    import weakref

    key = id(scene.verts.x)
    _HOST_GEOMETRY[key] = (
        np.asarray(verts, np.float32), np.asarray(tri_indices, np.int32)
    )
    try:
        # evict when the device array dies so a recycled id can't alias
        weakref.finalize(
            scene.verts.x, lambda k=key: _HOST_GEOMETRY.pop(k, None)
        )
    except TypeError:
        # can't track the array's lifetime -> don't cache at all: a stale
        # entry at a recycled id() would hand a LATER scene the wrong
        # geometry (the device-readback fallback is slow but safe)
        _HOST_GEOMETRY.pop(key, None)


def host_geometry(scene: "Scene"):
    """(verts (V,3) f32, tris (T,3) i32) host arrays, or None if this scene
    was not built through make_scene (fall back to device readback)."""
    return _HOST_GEOMETRY.get(id(scene.verts.x))


def merge_scenes(a: Scene, b: Scene) -> Scene:
    """Concatenate two scenes (the reference appends successive loadOBJ calls
    into one global SoA, modelLoader.h:43-47; this is the equivalent)."""
    vo = a.num_verts
    mo = a.num_mats
    to = a.num_tris

    def cat(x, y):
        return jnp.concatenate([x, y])

    def catv(x: Vec3, y: Vec3) -> Vec3:
        return Vec3(cat(x.x, y.x), cat(x.y, y.y), cat(x.z, y.z))

    return Scene(
        verts=catv(a.verts, b.verts),
        tri_v0=cat(a.tri_v0, b.tri_v0 + vo),
        tri_v1=cat(a.tri_v1, b.tri_v1 + vo),
        tri_v2=cat(a.tri_v2, b.tri_v2 + vo),
        tri_norm=catv(a.tri_norm, b.tri_norm),
        tri_mat=cat(a.tri_mat, b.tri_mat + mo),
        mat_albedo=catv(a.mat_albedo, b.mat_albedo),
        mat_emission=catv(a.mat_emission, b.mat_emission),
        lights=cat(a.lights, b.lights + to),
        total_light_area=a.total_light_area + b.total_light_area,
        sph_center=catv(a.sph_center, b.sph_center),
        sph_radius=cat(a.sph_radius, b.sph_radius),
        sph_mat=cat(a.sph_mat, b.sph_mat + mo),
    )


def recompute_derived(scene: Scene) -> Scene:
    """Recompute face normals and light areas from current vertex positions
    — the differentiable closure used by the gradient pass so that
    d(image)/d(verts) flows through normals and light pdfs too."""
    from ..ops.vecmath import gather

    v0 = gather(scene.verts, scene.tri_v0)
    v1 = gather(scene.verts, scene.tri_v1)
    v2 = gather(scene.verts, scene.tri_v2)
    n = normalized(cross(v1 - v0, v2 - v0))
    lv0 = gather(scene.verts, jnp.take(scene.tri_v0, scene.lights, mode="clip"))
    lv1 = gather(scene.verts, jnp.take(scene.tri_v1, scene.lights, mode="clip"))
    lv2 = gather(scene.verts, jnp.take(scene.tri_v2, scene.lights, mode="clip"))
    areas = length(cross(lv1 - lv0, lv2 - lv0)) * 0.5
    return scene._replace(tri_norm=n, total_light_area=jnp.sum(areas))
