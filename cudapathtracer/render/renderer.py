"""Progressive renderer: sample loop, running-mean accumulation, finalize.

The reference's render loop launches one kernel per progressive sample and
folds it into a running mean ``img = prev*(n-1)/n + sample/n``
(kernel.cu:709-736, 551-552). Here one jit'd call renders a *batch* of
samples (``lax.fori_loop`` inside jit — far fewer dispatches than the
reference's one-launch-per-sample), and the accumulation state is an
explicit pytree so rendering is resumable by construction (SURVEY.md §5.4:
saving (accumulator, sample count, key) suffices — exactly what
utils/checkpoint.py persists).

The reference accumulates in double (color.h:6); the device path stays in
f32 (accelerators run f64 far slower), so the accumulator is f32 with
optional Kahan compensated summation (``cfg.compensated_accum``) of the
running-mean update, which keeps the effective accumulation error near f64
levels at 256+ spp.
"""

from __future__ import annotations

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..accel.bvh import Accel, as_fine, build_bvh
from ..integrators.bdpt import BDPTParams, radiance_bdpt
from ..integrators.pt_nee import PTParams, radiance_pt_nee
from ..ops import cuda_walk, packets, traversal
from ..ops.rng import pixel_keys, sample_key
from ..ops.vecmath import Vec3
from ..utils.color import finalize as color_finalize
from ..utils.color import quantize_u8
from ..utils.config import RenderConfig
from ..utils.morton import morton_to_scanline_perm
from .camera import Camera, camera_rays


class AccumState(NamedTuple):
    """Resumable accumulation state (Morton pixel order)."""

    img: Vec3                 # (R,) running mean
    comp: Vec3                # (R,) Kahan compensation (zeros if disabled)
    n: jnp.ndarray            # () i32 — samples accumulated so far


def init_accum(cfg: RenderConfig) -> AccumState:
    r = cfg.num_pixels
    return AccumState(
        img=Vec3.zeros((r,)),
        comp=Vec3.zeros((r,)),
        n=jnp.zeros((), jnp.int32),
    )


def _accum_update(state: AccumState, sample: Vec3,
                  compensated: bool) -> AccumState:
    """Running mean (kernel.cu:551-552), optionally Kahan-compensated."""
    n = state.n + 1
    nf = n.astype(jnp.float32)
    if not compensated:
        img = state.img * ((nf - 1.0) / nf) + sample * (1.0 / nf)
        return AccumState(img=img, comp=state.comp, n=n)

    # Kahan: track the low-order bits lost by the running-mean update.
    def kahan(mean, comp, s):
        delta = (s - mean) / nf       # increment toward the new mean
        y = delta - comp
        t = mean + y
        comp_new = (t - mean) - y
        return t, comp_new

    ix, cx = kahan(state.img.x, state.comp.x, sample.x)
    iy, cy = kahan(state.img.y, state.comp.y, sample.y)
    iz, cz = kahan(state.img.z, state.comp.z, sample.z)
    return AccumState(img=Vec3(ix, iy, iz), comp=Vec3(cx, cy, cz), n=n)


def resolve_tile_size(cfg: RenderConfig, num_tris: int) -> int:
    """cfg.tile_size, or the auto default: P=256 rays per tile up to a
    cluster width C of 512, P=128 beyond, so the (P, C) fold block stays
    bounded. The rule predates the GPU port and is not yet tuned for the
    H100."""
    if cfg.tile_size is not None:
        return int(cfg.tile_size)
    c = cfg.cluster_size or adaptive_cluster_size(num_tris)
    return 256 if c <= 512 else 128


def resolve_traversal(cfg: RenderConfig) -> str:
    """cfg.traversal, with 'auto' resolved by platform: the CUDA per-ray
    walk (ops/cuda_walk.py) on a GPU, the XLA packet engine elsewhere. The
    platform is that of ``jax.default_device`` when one is set, so a
    computation placed on the CPU of a GPU machine gets the CPU's engine."""
    if cfg.traversal != "auto":
        return cfg.traversal
    return "cuda" if cuda_walk.current_platform() == "gpu" else "packets"


def _per_ray_walk(kind: str):
    """The per-ray closest-hit walk for this platform, as
    walk(o, d, td, mask=, t_cap=, intersector=) -> Hit."""
    if kind == "cuda" or (kind == "packets"
                          and cuda_walk.current_platform() == "gpu"):
        return cuda_walk.closest_hit

    def walk(o, d, td, mask=None, t_cap=None, intersector="bw"):
        h = traversal.trace(o, d, td, mask=mask, intersector=intersector)
        return h if t_cap is None else traversal.apply_t_cap(h, t_cap)

    return walk


def make_packet_prep(scene, bvh) -> packets.PacketData:
    """Scene-constant packet data, built once at setup and passed through
    the jit boundary so the per-dispatch render step does not re-gather
    the cluster blocks."""
    return packets.make_packet_data(
        scene,
        Vec3(bvh.cl_lo_x, bvh.cl_lo_y, bvh.cl_lo_z),
        Vec3(bvh.cl_hi_x, bvh.cl_hi_y, bvh.cl_hi_z),
        bvh.cl_tri,
    )


def make_trace_fn(scene, cfg: RenderConfig, bvh=None, prep=None):
    """Build the trace closure the integrators consume.

    Returns (trace_fn, trace_data). For every path but 'brute' the accel
    structure must be prebuilt on host (build_bvh_for_scene) and is closed
    over as a pytree so it can be donated/replicated. ``prep``: optional
    PacketData from make_packet_prep — static-scene callers hoist the
    packet precompute out of the per-dispatch step; None (differentiable
    vertex updates) rebuilds it in-trace so geometry changes flow through.

    ``trace_fn(o, d, mask, t_cap=None, vis_band=0.0)``: ``vis_band > 0``
    marks a visibility-only call site (integrators/bdpt.py); it only
    selects cfg.tile_size_vis, and every engine answers the closest-hit
    query.
    """
    def with_spheres(base):
        # fold analytic spheres (sphere.h capability) over the triangle hit;
        # static no-op for the common sphere-free scene
        if scene.num_spheres == 0:
            return base

        def fn(o, d, mask, t_cap=None, vis_band=0.0):
            h = base(o, d, mask, t_cap=t_cap, vis_band=vis_band)
            h = traversal.trace_spheres(o, d, scene, h.t, h.tri, mask=mask)
            # sphere hits beyond the cap must honor the capped contract too
            return h if t_cap is None else traversal.apply_t_cap(h, t_cap)

        return fn

    traversal_kind = resolve_traversal(cfg)
    if traversal_kind == "brute":
        def trace_fn(o, d, mask, t_cap=None, vis_band=0.0):
            h = traversal.trace_bruteforce(o, d, scene, mask=mask,
                                           intersector=cfg.intersector)
            return h if t_cap is None else traversal.apply_t_cap(h, t_cap)

        return with_spheres(trace_fn), None

    assert bvh is not None, "traversal requires a prebuilt accel structure"
    td = traversal.make_trace_data(scene, as_fine(bvh))

    if traversal_kind == "packets":
        assert isinstance(bvh, Accel), (
            "packet traversal needs the Accel bundle from build_bvh_for_scene"
        )
        pdata = prep if prep is not None else make_packet_prep(scene, bvh)

        # straggler rounds are tuned separately for pt_nee's long bounce
        # batches and BDPT's batched 2R/4R traces (integrators/bdpt.py)
        rounds = (cfg.packet_rounds if cfg.integrator == "pt_nee"
                  else cfg.packet_rounds_bdpt)
        ts_base = resolve_tile_size(cfg, scene.num_tris)
        walk = _per_ray_walk(traversal_kind)

        def trace_fn(o, d, mask, t_cap=None, vis_band=0.0):
            # visibility traces (vis_band > 0, BDPT connections) may use
            # their own tile size (cfg.tile_size_vis; None = shared)
            ts = (cfg.tile_size_vis
                  if vis_band > 0.0 and cfg.tile_size_vis is not None
                  else ts_base)
            return packets.trace_packets(
                o, d, pdata, fine_td=td, walk=walk, mask=mask,
                tile_size=ts, max_clusters=cfg.max_clusters,
                sort=cfg.packet_sort,
                rounds=rounds,
                first_round_slots=cfg.packet_first_round,
                sort_window=cfg.sort_window,
                two_level=cfg.two_level_cull,
                super_factor=cfg.super_factor,
                super_slots=cfg.super_slots,
                t_cap=t_cap,
                intersector=cfg.intersector,
            )

        return with_spheres(trace_fn), td

    walk = _per_ray_walk(traversal_kind)

    def trace_fn(o, d, mask, t_cap=None, vis_band=0.0):
        return walk(o, d, td, mask=mask, t_cap=t_cap,
                    intersector=cfg.intersector)

    return with_spheres(trace_fn), td


def _radiance(o, d, scene, trace_fn, keys, cfg: RenderConfig,
              primary_hit=None) -> Vec3:
    if cfg.integrator == "pt_nee":
        params = PTParams(
            num_bounces=cfg.num_bounces,
            orthonormal_frame=cfg.orthonormal_frame,
            light_normal_mode=cfg.light_normal_mode,
            branch_pdf_correction=cfg.branch_pdf_correction,
        )
        return radiance_pt_nee(o, d, scene, trace_fn, keys, params,
                               primary_hit=primary_hit)
    params = BDPTParams(orthonormal_frame=cfg.orthonormal_frame)
    return radiance_bdpt(o, d, scene, trace_fn, keys, params,
                         primary_hit=primary_hit)


def render_batch(scene, bvh, cam: Camera, cfg: RenderConfig, base_key,
                 state: AccumState, num_samples: int,
                 idx=None, prep: packets.PacketData | None = None
                 ) -> AccumState:
    """Render ``num_samples`` progressive samples into ``state``.

    Pure function of its inputs — jit it (cfg/num_samples static), donate
    ``state``. The sample index for RNG derivation is the *global* count
    ``state.n + i``, so resuming from a checkpoint reproduces the identical
    image as an uninterrupted run (tested).

    ``idx``: Morton pixel indices this call covers (default: whole image).
    The multi-chip path (parallel/shard.py) passes each chip its own tile
    of indices; because the RNG is keyed on (sample, pixel-index) and not
    on array position, a sharded render draws identical randoms and
    matches single-chip to XLA-fusion ULPs (tests/test_parallel.py).
    """
    trace_fn, _ = make_trace_fn(scene, cfg, bvh, prep=prep)
    if idx is None:
        idx = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)

    primary = None
    if cfg.reuse_primary_hit and not cfg.jitter:
        # reuse is only sound for a pinhole camera: with radius > 0 the lens
        # randoms vary per sample and a cached primary hit is stale. radius
        # is a tracer under jit (render_batch_jit checks concretely before
        # entering); assert here for direct concrete-value callers.
        try:
            assert float(cam.radius) == 0.0, (
                "cfg.reuse_primary_hit requires a pinhole camera (radius=0)"
            )
        except jax.errors.ConcretizationTypeError:
            pass  # under jit; render_batch_jit checked concretely already
        # pinhole + no jitter: every sample's primary rays are identical
        # (cfg.reuse_primary_hit is only set when the camera radius is 0),
        # so the first trace of the bounce loop is batch-invariant
        keys0 = pixel_keys(sample_key(base_key, state.n), idx)
        o0, d0 = camera_rays(cam, idx, keys0, jitter=False, lens=False)
        primary = trace_fn(o0, d0, jnp.ones(idx.shape, bool))

    R = idx.shape[0]

    def group_of(st: AccumState, S: int) -> AccumState:
        """Render S samples whose bounce rays trace as ONE (S*R,) batch.

        Radiance per sample is bit-identical to sequential rendering (RNG
        keys on the absolute sample index) and the accumulation applies the
        S per-sample updates in order, so the final image is bit-identical
        to S=1 for ANY grouping — which keeps checkpoint resume exact. The
        win is in the trace: S x the rays per sort window pack into denser,
        tighter packet tiles (see cfg.sample_batch).
        """
        keys = [pixel_keys(sample_key(base_key, st.n + i), idx)
                for i in range(S)]
        keys_b = jnp.concatenate(keys) if S > 1 else keys[0]
        idx_b = jnp.tile(idx, S) if S > 1 else idx
        # reuse_primary_hit certifies radius == 0 (asserted at the jit
        # boundary): skip the lens draws, and with jitter off the rays
        # don't depend on keys at all, so XLA hoists them out of the loop
        o, d = camera_rays(cam, idx_b, keys_b, jitter=cfg.jitter,
                           lens=not cfg.reuse_primary_hit)
        prim = primary
        if prim is not None and S > 1:
            prim = jax.tree_util.tree_map(
                lambda a: jnp.tile(a, S), primary
            )
        sample = _radiance(o, d, scene, trace_fn, keys_b, cfg,
                           primary_hit=prim)
        for i in range(S):
            sl = Vec3(sample.x[i * R:(i + 1) * R],
                      sample.y[i * R:(i + 1) * R],
                      sample.z[i * R:(i + 1) * R]) if S > 1 else sample
            st = _accum_update(st, sl, cfg.compensated_accum)
        return st

    S = max(1, int(cfg.sample_batch))
    state = jax.lax.fori_loop(
        0, num_samples // S, lambda g, st: group_of(st, S), state
    )
    if num_samples % S:
        state = jax.lax.fori_loop(
            0, num_samples % S, lambda i, st: group_of(st, 1), state
        )
    return state


@partial(jax.jit, static_argnames=("cfg", "num_samples"), donate_argnums=(5,))
def _render_batch_jit(scene, bvh, cam, cfg: RenderConfig, base_key, state,
                      num_samples: int, prep=None) -> AccumState:
    return render_batch(scene, bvh, cam, cfg, base_key, state, num_samples,
                        prep=prep)


def render_batch_jit(scene, bvh, cam, cfg: RenderConfig, base_key, state,
                     num_samples: int, prep=None) -> AccumState:
    """Jitted render_batch. The pinhole precondition of reuse_primary_hit is
    checked HERE, where cam.radius is still concrete (inside jit it is a
    tracer and the stale-hit bias would be silent)."""
    if cfg.reuse_primary_hit:
        # unconditional on jitter: group_of skips the lens draws whenever
        # reuse_primary_hit is set, so a radius > 0 camera would silently
        # lose its depth of field even when jitter disables hit reuse
        assert float(cam.radius) == 0.0, (
            "cfg.reuse_primary_hit requires a pinhole camera (radius=0): "
            "lens samples vary per sample, a cached primary hit is stale "
            "(and the lens draw is skipped entirely on this path)"
        )
    return _render_batch_jit(scene, bvh, cam, cfg, base_key, state,
                             num_samples, prep)


def render(scene, cam: Camera, cfg: RenderConfig, seed: int = 1234,
           bvh=None, state: AccumState | None = None,
           progress_cb=None) -> AccumState:
    """Full progressive render. Builds the BVH if needed (host, like the
    reference's buildBVH before the loop, kernel.cu:601), then renders
    ``cfg.spp`` samples in ``cfg.samples_per_call`` chunks.

    ``seed=1234`` mirrors the reference's curand seed (kernel.cu:532).
    """
    kind = resolve_traversal(cfg)
    if kind != "brute" and bvh is None:
        bvh = build_bvh_for_scene(scene, cfg.leaf_size,
                                  cluster_size=cfg.cluster_size)
    prep = make_packet_prep(scene, bvh) if kind == "packets" else None
    if state is None:
        state = init_accum(cfg)
    if (not cfg.reuse_primary_hit and not cfg.jitter
            and float(cam.radius) == 0.0):
        import dataclasses

        cfg = dataclasses.replace(cfg, reuse_primary_hit=True)
    base_key = jax.random.PRNGKey(seed)

    done = int(state.n)
    while done < cfg.spp:
        todo = min(cfg.samples_per_call, cfg.spp - done)
        state = render_batch_jit(scene, bvh, cam, cfg, base_key, state, todo,
                                 prep=prep)
        done += todo
        if progress_cb is not None:
            progress_cb(done, state)
    return state


def _build_flat_host(verts, tris, leaf_size: int, use_native: bool):
    """One flat BVH as HOST numpy arrays (lo (N,3), hi (N,3), skip, leaf,
    leaf_tri); native C++ builder preferred (far faster than the python
    twin on big scenes; bit-identical trees — tested). Everything stays on
    the host so the cluster extraction needs no device readback."""
    if use_native:
        built = None
        try:
            from ..accel.native import build_bvh_native

            built = build_bvh_native(verts, tris, leaf_size)
        except Exception as e:
            import warnings

            warnings.warn(
                "native BVH builder failed, falling back to the (much "
                f"slower) python twin: {type(e).__name__}: {e}"
            )
        if built is not None:
            from ..utils.constants import MAX_BVH_DEPTH

            d, depth = built
            if depth >= MAX_BVH_DEPTH:
                # same contract as the python twin (accel/bvh.py:331-334)
                # and the reference's fatal guard (kernel.cu:627-631);
                # traversal is stackless so it would not crash, but both
                # builders must enforce one contract — and this is a real
                # error, not a reason to fall back to the python twin
                # (which would only rebuild slowly and raise the same)
                raise RuntimeError(
                    f"BVH depth {depth} >= {MAX_BVH_DEPTH}"
                )
            return (d["node_lo"], d["node_hi"], d["node_skip"],
                    d["node_leaf"], d["leaf_tri"])
    flat, _meta = build_bvh(verts, tris, leaf_size)
    lo = np.stack([np.asarray(flat.node_lo_x), np.asarray(flat.node_lo_y),
                   np.asarray(flat.node_lo_z)], axis=1)
    hi = np.stack([np.asarray(flat.node_hi_x), np.asarray(flat.node_hi_y),
                   np.asarray(flat.node_hi_z)], axis=1)
    return (lo, hi, np.asarray(flat.node_skip), np.asarray(flat.node_leaf),
            np.asarray(flat.leaf_tri))


def _repack_clusters(cl_lo, cl_hi, cl_tri, num_tris: int, C: int):
    """Greedily merge preorder-consecutive under-full SAH leaves into full
    clusters. SAH recursion stops at <= C tris, leaving leaves part full;
    every pad slot costs a full triangle test in the dense fold.
    Preorder-adjacent leaves are siblings/cousins, so the merged box is
    close to their common ancestor's — slightly looser culling traded for
    fewer intersection slots. Only whole leaves whose combined count fits
    are merged: splitting leaves across clusters loosens the merged boxes
    further."""
    counts = (cl_tri < num_tris).sum(axis=1)
    K = cl_tri.shape[0]
    groups = []
    start, acc = 0, 0
    for k in range(K):
        if acc + counts[k] > C and acc > 0:
            groups.append((start, k))
            start, acc = k, 0
        acc += counts[k]
    groups.append((start, K))

    lo = np.empty((len(groups), 3), np.float32)
    hi = np.empty((len(groups), 3), np.float32)
    tri = np.full((len(groups), C), num_tris, np.int32)
    for g, (a, b) in enumerate(groups):
        lo[g] = cl_lo[a:b].min(axis=0)
        hi[g] = cl_hi[a:b].max(axis=0)
        ids = cl_tri[a:b].reshape(-1)
        ids = ids[ids < num_tris]
        tri[g, : ids.shape[0]] = ids
    return lo, hi, tri


def _upload_flat(lo, hi, skip, leaf, leaf_tri):
    from ..accel.bvh import FlatBVH

    return FlatBVH(
        node_lo_x=jnp.asarray(lo[:, 0]),
        node_lo_y=jnp.asarray(lo[:, 1]),
        node_lo_z=jnp.asarray(lo[:, 2]),
        node_hi_x=jnp.asarray(hi[:, 0]),
        node_hi_y=jnp.asarray(hi[:, 1]),
        node_hi_z=jnp.asarray(hi[:, 2]),
        node_skip=jnp.asarray(skip),
        node_leaf=jnp.asarray(leaf),
        leaf_tri=jnp.asarray(leaf_tri),
    )


def adaptive_cluster_size(num_tris: int) -> int:
    """Default cluster granularity, multiples of 128 in [256, 1024].

    ~T/160, so the cluster count K stays near 160 and the flat (Tl, K)
    cull stays small, clamped so small scenes keep a fixed-cost floor and
    big scenes a bounded (P, C) fold. The rule predates the GPU port and is
    not yet tuned for the H100."""
    c = max(256, round(num_tris / 160))
    return min(1024, 128 * max(2, round(c / 128)))


def build_bvh_for_scene(scene, leaf_size: int = 4, use_native: bool = True,
                        cluster_size: int | None = None) -> Accel:
    """Host accel build (the reference's pre-render buildBVH, kernel.cu:601).

    Returns the Accel bundle: the fine per-ray BVH (``leaf_size``) plus the
    coarse cluster level (``cluster_size``) for packet traversal."""
    from ..models.scene import host_geometry

    cached = host_geometry(scene)
    if cached is not None:
        # host copies registered at scene construction — no device readback
        verts, tris = cached
    else:
        verts = np.stack(
            [np.asarray(scene.verts.x), np.asarray(scene.verts.y),
             np.asarray(scene.verts.z)], axis=1
        )
        tris = np.stack(
            [np.asarray(scene.tri_v0), np.asarray(scene.tri_v1),
             np.asarray(scene.tri_v2)], axis=1
        )
    if cluster_size is None:
        cluster_size = adaptive_cluster_size(tris.shape[0])
    fine = _upload_flat(*_build_flat_host(verts, tris, leaf_size, use_native))
    c_lo, c_hi, c_skip, c_leaf, c_ltri = _build_flat_host(
        verts, tris, cluster_size, use_native)
    # cluster extraction on host arrays (leaves in leaf-id order == preorder)
    sel = np.flatnonzero(c_leaf >= 0)
    sel = sel[np.argsort(c_leaf[sel])]
    cl_lo, cl_hi, cl_tri = _repack_clusters(
        c_lo[sel], c_hi[sel], c_ltri, tris.shape[0], cluster_size)
    return Accel(
        fine=fine,
        cl_lo_x=jnp.asarray(cl_lo[:, 0]),
        cl_lo_y=jnp.asarray(cl_lo[:, 1]),
        cl_lo_z=jnp.asarray(cl_lo[:, 2]),
        cl_hi_x=jnp.asarray(cl_hi[:, 0]),
        cl_hi_y=jnp.asarray(cl_hi[:, 1]),
        cl_hi_z=jnp.asarray(cl_hi[:, 2]),
        cl_tri=jnp.asarray(cl_tri),
    )


def finalize_image(state: AccumState, cfg: RenderConfig):
    """Morton de-swizzle to scanline, Reinhard + gamma, quantize to u8
    (H, W, 3) — the PPM writer's pixel loop, vectorized (kernel.cu:764-778).
    """
    perm = morton_to_scanline_perm(cfg.width, cfg.height)
    img = Vec3(
        jnp.take(state.img.x, perm),
        jnp.take(state.img.y, perm),
        jnp.take(state.img.z, perm),
    )
    c = color_finalize(img)
    u8 = quantize_u8(c)
    return np.asarray(u8).reshape(cfg.height, cfg.width, 3)


def write_render(path, state: AccumState, cfg: RenderConfig):
    """Tonemapped image to disk; format by extension (.ppm default, .png
    via the dependency-free writer in utils/png.py)."""
    img = finalize_image(state, cfg)
    if str(path).lower().endswith(".png"):
        from ..utils.png import write_png

        write_png(path, img, flip_x=True)
    else:
        from ..utils.ppm import write_ppm

        write_ppm(path, img, flip_x=True)
