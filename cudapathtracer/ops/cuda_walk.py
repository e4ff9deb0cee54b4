"""The per-ray closest-hit walk as a CUDA kernel, called through the XLA FFI.

One thread per ray walks the skip-link flat BVH (native/closest_hit.cu) —
the reference's one-thread-per-pixel trace (kernel.cu:112-161) without its
per-thread stack. Same contract as ``ops/traversal.trace``, which stays the
plain reference it is tested against on the card.

The shared library is built from the committed source with nvcc
(``make -C native cuda``) into the package's native directory on first use;
a failed build is an error. The kernel has no CPU or interpreter form:
``closest_hit`` refuses any platform but a GPU. What surrounds the kernel —
the operand layout below — is plain JAX and is tested on the CPU.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.constants import MAX_FLOAT
from .intersect import bw_precompute
from .traversal import Hit, TraceData

_NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
LIB_PATH = os.path.join(_NATIVE_DIR, "libcptcuda.so")
TARGET = "cpt_closest_hit"

_lock = threading.Lock()
_registered = False


def current_platform() -> str:
    """Platform that new computations run on: the device set by
    ``jax.default_device`` if any, else JAX's default backend."""
    dev = jax.config.jax_default_device
    if dev is None:
        return jax.default_backend()
    return dev if isinstance(dev, str) else dev.platform


def build_library() -> str:
    """Compile native/closest_hit.cu for sm_90a if the library is missing;
    returns its path. Raises on any build failure."""
    if not os.path.exists(LIB_PATH):
        out = subprocess.run(
            ["make", "-C", _NATIVE_DIR, "cuda",
             f"JAX_FFI_INCLUDE={jax.ffi.include_dir()}"],
            capture_output=True, text=True)
        if out.returncode != 0:
            raise RuntimeError(
                "building the CUDA closest-hit kernel failed:\n"
                + out.stdout[-4000:] + out.stderr[-4000:])
    return LIB_PATH


def _register():
    global _registered
    with _lock:
        if _registered:
            return
        lib = ctypes.CDLL(build_library())
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(lib.CptClosestHit), platform="CUDA")
        _registered = True


def pack_rays(o, d, mask=None, t_cap=None):
    """(7, R) f32 SoA: ox oy oz dx dy dz cap. The cap folds in the lane mask
    (masked lanes get 0: the kernel walks nothing for cap <= 0) and the
    optional visibility cap (a hit needs t < cap); +inf otherwise."""
    R = o.x.shape[0]
    cap = jnp.full((R,), jnp.inf, jnp.float32)
    if t_cap is not None:
        cap = jnp.broadcast_to(jnp.asarray(t_cap, jnp.float32), (R,))
    if mask is not None:
        cap = jnp.where(mask, cap, 0.0)
    return jnp.stack([o.x, o.y, o.z, d.x, d.y, d.z, cap]).astype(jnp.float32)


def pack_scene(td: TraceData, intersector: str = "bw"):
    """Kernel operands from TraceData: nodes (N, 8) = lo.xyz, hi.xyz, 0, 0;
    links (N, 2) = skip, leaf; tris (NL*L, 12) triangle records (bw: v0, n,
    m1, m2; mt: v0, e1, e2, 0); tri_ids (NL, L) with pad slots set to -1."""
    z = jnp.zeros_like(td.node_lo.x)
    nodes = jnp.stack([td.node_lo.x, td.node_lo.y, td.node_lo.z,
                       td.node_hi.x, td.node_hi.y, td.node_hi.z, z, z],
                      axis=1)
    links = jnp.stack([td.node_skip, td.node_leaf], axis=1).astype(jnp.int32)
    v0 = td.leaf_v0
    if intersector == "bw":
        n, m1, m2 = bw_precompute(td.leaf_e1, td.leaf_e2)
        cols = [v0, n, m1, m2]
    else:
        zz = jnp.zeros_like(v0.x)
        cols = [v0, td.leaf_e1, td.leaf_e2]
    comps = [c for v in cols for c in (v.x, v.y, v.z)]
    if intersector != "bw":
        comps += [zz, zz, zz]
    tris = jnp.stack(comps, axis=-1).reshape(-1, 12)
    tri_ids = jnp.where(td.leaf_tri < td.num_tris, td.leaf_tri,
                        -1).astype(jnp.int32)
    return nodes, links, tris, tri_ids


def closest_hit(o, d, td: TraceData, mask=None, t_cap=None,
                intersector: str = "bw") -> Hit:
    """Closest hit per ray on the GPU: ``traversal.trace`` followed by
    ``traversal.apply_t_cap``, in one kernel. Non-differentiable (inputs are
    detached), like every engine."""
    if current_platform() != "gpu":
        raise RuntimeError("the CUDA closest-hit kernel needs a GPU; "
                           f"JAX's platform is '{current_platform()}'")
    _register()
    o = jax.lax.stop_gradient(o)
    d = jax.lax.stop_gradient(d)
    td = jax.lax.stop_gradient(td)
    rays = pack_rays(o, d, mask, t_cap)
    R = rays.shape[1]
    t, tri = jax.ffi.ffi_call(
        TARGET,
        (jax.ShapeDtypeStruct((R,), jnp.float32),
         jax.ShapeDtypeStruct((R,), jnp.int32)),
    )(rays, *pack_scene(td, intersector), bw=np.int32(intersector == "bw"))
    return Hit(tri=tri, t=jnp.where(tri >= 0, t, MAX_FLOAT))
