"""Smoke check: the main path of the path tracer on one NVIDIA GPU.

    python chip_smoke.py               # one card (an H100): phases 1-7
    python chip_smoke.py --four-gpus   # four cards: only phase 8

Everything runs in this one process, so the card is opened once. Phases:

1. device check: JAX must find a GPU (no CPU fallback); prints the card's
   name and power limit as nvidia-smi reports them;
2. pt_nee, the headline job: colonnade (20,884 tris) at 1024^2, 3 bounces,
   through ``render_batch_jit``; compile time, peak memory and a smoke
   Mrays/s; image checks; parity with the brute-force engine at 128^2;
3. BDPT, the reference's live integrator, at 512^2 on the same scene, with
   the same checks;
4. the inverse-rendering train step with both boundary terms at 256^2:
   three optimiser steps, then the first step's loss and gradients at 32^2
   against the same jitted function placed on the CPU;
5. the scale point: colonnade at 328,084 tris; the native BVH builder must
   have run; the memory analysis of one 1M-ray trace; that trace against
   the XLA per-ray walk on a 64k-ray subset;
6. the CUDA closest-hit kernel (the GPU's default trace) against its plain
   reference, ops/traversal.trace, on 1M bounce rays at 20k and 328k tris:
   hits, t, lane masks, visibility caps, both intersectors;
7. the engines side by side — the XLA packet engine, the XLA per-ray walk,
   the CUDA walk: one 1M-ray bounce trace and the headline render, at 20k
   and 328k tris.

``--four-gpus`` runs only phase 8: the sharded path on four cards (the
sharded render and the train step against one device).

Every timing printed is a smoke reading: one window, not a benchmark.
Any failed check raises, so the process exits non-zero and never prints
the last line. The last line of standard output is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.

Tolerances, with their reasons:

* HIT_AGREE: the same hit triangle on at least 1 - 1e-4 of rays. Two
  engines run the same formula in differently fused programs; FMA
  contraction can move t by an ULP and flip an exact tie on a shared edge.
* T_RTOL: t within 1e-5 relative where the triangles agree, for the same
  reason (XLA's GPU code, nvcc and the CPU contract differently).
* MEAN_RTOL: image channel means within 1e-4 relative; a flipped hit moves
  one pixel, not the mean.
* LOSS_RTOL / GRAD_REL_L2: train-step loss within 1e-5 relative and the
  gradient's relative L2 error under 1e-3 against the CPU; reductions run
  in another order on each backend.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import warnings

HIT_AGREE = 1.0 - 1e-4
T_RTOL = 1e-5
MEAN_RTOL = 1e-4
LOSS_RTOL = 1e-5
GRAD_REL_L2 = 1e-3

HEADLINE_SUBDIV = 3      # colonnade: 20,884 tris
SCALE_SUBDIV = 5         # colonnade: 328,084 tris


class SmokeFailure(AssertionError):
    """A check of the smoke run failed."""


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def log(msg):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def colonnade(subdiv):
    from cudapathtracer.models import procedural

    return procedural.to_scene(procedural.colonnade(subdiv=subdiv))


def colonnade_camera(size):
    from cudapathtracer import make_camera

    return make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                       focal_length=2.0)


def build_accel(scene, cfg):
    """Host BVH build; fails if the native builder did not run."""
    from cudapathtracer.render.renderer import build_bvh_for_scene

    t0 = time.perf_counter()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        bvh = build_bvh_for_scene(scene, cfg.leaf_size,
                                  cluster_size=cfg.cluster_size)
    dt = time.perf_counter() - t0
    fell_back = [w for w in caught if "native BVH builder" in str(w.message)]
    check(not fell_back, f"native BVH builder did not run: "
                         f"{fell_back[0].message if fell_back else ''}")
    log(f"  bvh: native builder, {scene.num_tris} tris, "
        f"{bvh.cl_tri.shape[0]} clusters of {bvh.cl_tri.shape[1]}, "
        f"{dt:.3f} s")
    return bvh


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def timed_render(scene, bvh, cam, cfg, spp, seed=1234):
    """(state, first-call seconds, steady seconds) of one render_batch_jit
    window of ``spp`` samples; the first call includes compilation."""
    import jax

    from cudapathtracer import init_accum
    from cudapathtracer.render.renderer import (
        make_packet_prep,
        render_batch_jit,
        resolve_traversal,
    )

    prep = (make_packet_prep(scene, bvh)
            if resolve_traversal(cfg) == "packets" else None)
    key = jax.random.PRNGKey(seed)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        st = render_batch_jit(scene, bvh, cam, cfg, key, init_accum(cfg),
                              spp, prep=prep)
        jax.block_until_ready(st)
        times.append(time.perf_counter() - t0)
    return st, times[0], times[1]


def image_stats(st):
    import numpy as np

    img = np.stack([np.asarray(st.img.x), np.asarray(st.img.y),
                    np.asarray(st.img.z)], axis=1)
    return img


def check_image(img, what):
    import numpy as np

    check(np.isfinite(img).all(), f"{what}: non-finite radiance")
    check(img.max() > 1.0, f"{what}: no light visible (max {img.max()})")
    check(img.mean() > 0.0, f"{what}: black image")


def check_cornell_walls(integrator, size=128, spp=4):
    """The reference's scene: red left wall, green right wall after the
    x-flip the image writer applies."""
    from cudapathtracer import (
        RenderConfig,
        finalize_image,
        make_camera,
        render,
    )
    from cudapathtracer.models import procedural

    scene = procedural.to_scene(procedural.cornell_box())
    cfg = RenderConfig(width=size, height=size, spp=spp,
                       integrator=integrator, samples_per_call=spp)
    st = render(scene, make_camera(width=size, height=size), cfg, seed=1)
    im = finalize_image(st, cfg)[:, ::-1].astype(float)
    band = max(1, size // 16)
    left = im[size // 4: 3 * size // 4, :band].mean(axis=(0, 1))
    right = im[size // 4: 3 * size // 4, -band:].mean(axis=(0, 1))
    check(left[0] > left[1] and left[0] > left[2],
          f"cornell {integrator}: left wall not red {left}")
    check(right[1] > right[0] and right[1] > right[2],
          f"cornell {integrator}: right wall not green {right}")
    log(f"  cornell {integrator} {size}^2: left wall rgb {left.round(1)}, "
        f"right wall rgb {right.round(1)} (red / green: ok)")


def compare_with_brute(scene, bvh, cfg, spp, size):
    """The same render through the default engine and brute force."""
    import dataclasses

    import numpy as np

    cam = colonnade_camera(size)
    c = dataclasses.replace(cfg, width=size, height=size, spp=spp,
                            samples_per_call=spp)
    a, _, _ = timed_render(scene, bvh, cam, c, spp)
    b, _, _ = timed_render(scene, None, cam,
                           dataclasses.replace(c, traversal="brute"), spp)
    ia, ib = image_stats(a), image_stats(b)
    ma, mb = ia.mean(axis=0), ib.mean(axis=0)
    rel = np.abs(ma - mb) / np.maximum(np.abs(mb), 1e-12)
    frac = float((np.abs(ia - ib) > 1e-3 * np.maximum(np.abs(ib), 1)).any(
        axis=1).mean())
    log(f"  vs brute at {size}^2: channel-mean rel diff {rel.max():.3e} "
        f"(limit {MEAN_RTOL:g}); pixels differing {frac:.2e}")
    check(rel.max() <= MEAN_RTOL,
          f"{cfg.integrator}: default engine vs brute force, channel means "
          f"differ by {rel.max():.3e} relative")


def report_render(label, cfg, spp, first, steady):
    rays = cfg.num_pixels * spp * (cfg.num_bounces + 1)
    log(f"  {label}: first call (compile + 1 window) {first:.3f} s; "
        f"window {steady:.4f} s for {spp} spp; "
        f"{rays / steady / 1e6:.3f} Mrays/s (smoke reading); "
        f"peak_bytes_in_use {peak_bytes()}")


def compare_hits(a, b, what, limit=HIT_AGREE):
    """Same triangle on >= limit of rays; t within T_RTOL where it is."""
    import numpy as np

    ta, tb = np.asarray(a.t), np.asarray(b.t)
    ia, ib = np.asarray(a.tri), np.asarray(b.tri)
    same = ia == ib
    agree = float(same.mean())
    hit = same & (ia >= 0)
    trel = (float((np.abs(ta[hit] - tb[hit])
                   / np.maximum(np.abs(tb[hit]), 1e-30)).max())
            if hit.any() else 0.0)
    log(f"  {what}: same triangle on {agree:.6f} of {ia.size} rays "
        f"(limit {limit:.4f}); max t rel diff {trel:.3e} (limit {T_RTOL:g})")
    check(agree >= limit, f"{what}: hit agreement {agree}")
    check(trel <= T_RTOL, f"{what}: t differs by {trel:.3e} relative")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def device_check(n_devices=1):
    """The platform must be a GPU; prints the device and the card's line
    from nvidia-smi. Returns the JAX device list."""
    import jax

    from cudapathtracer.utils.profiling import nvidia_smi_query

    devs = jax.devices()
    log(f"jax.devices(): {devs}")
    check(devs[0].platform == "gpu",
          f"no GPU: JAX found platform '{devs[0].platform}'")
    check(len(devs) >= n_devices,
          f"need {n_devices} GPUs, JAX found {len(devs)}")
    log(f"device_kind: {devs[0].device_kind}")
    smi = nvidia_smi_query("name,power.limit")
    check(smi, "nvidia-smi did not answer")
    for line in smi:
        log(f"nvidia-smi name, power.limit: {line}")
    return devs


def phase_pt_nee(size=1024, spp=4, subdiv=HEADLINE_SUBDIV, brute_size=128,
                 cornell_size=128):
    """Headline pt_nee render, image checks, brute-force parity."""
    from cudapathtracer import RenderConfig

    log(f"[pt_nee] colonnade subdiv {subdiv} at {size}^2, {spp} spp")
    scene = colonnade(subdiv)
    cfg = RenderConfig(width=size, height=size, spp=spp, integrator="pt_nee",
                       samples_per_call=spp, reuse_primary_hit=True)
    bvh = build_accel(scene, cfg)
    st, first, steady = timed_render(scene, bvh, colonnade_camera(size),
                                     cfg, spp)
    report_render(f"pt_nee {size}^2", cfg, spp, first, steady)
    check_image(image_stats(st), "pt_nee colonnade")
    check_cornell_walls("pt_nee", cornell_size)
    compare_with_brute(scene, bvh, cfg, 2, brute_size)
    return scene, bvh


def phase_bdpt(size=512, spp=2, subdiv=HEADLINE_SUBDIV, brute_size=128,
               cornell_size=128, scene=None, bvh=None):
    """BDPT render, image checks, brute-force parity."""
    from cudapathtracer import RenderConfig

    log(f"[bdpt] colonnade subdiv {subdiv} at {size}^2, {spp} spp")
    cfg = RenderConfig(width=size, height=size, spp=spp, integrator="bdpt",
                       samples_per_call=spp, reuse_primary_hit=True)
    if scene is None:
        scene = colonnade(subdiv)
        bvh = build_accel(scene, cfg)
    st, first, steady = timed_render(scene, bvh, colonnade_camera(size),
                                     cfg, spp)
    report_render(f"bdpt {size}^2", cfg, spp, first, steady)
    check_image(image_stats(st), "bdpt colonnade")
    check_cornell_walls("bdpt", cornell_size)
    compare_with_brute(scene, bvh, cfg, 1, brute_size)


def _train_setup(subdiv, size, device=None):
    """Scene, accel, camera, config and target for the train step, built
    with every array on ``device`` (None = the default device)."""
    import contextlib

    import jax

    from cudapathtracer import RenderConfig
    from cudapathtracer.diff import render_grad as rg

    ctx = (jax.default_device(device) if device is not None
           else contextlib.nullcontext())
    with ctx:
        scene = colonnade(subdiv)
        cfg = RenderConfig(width=size, height=size, spp=1,
                           integrator="pt_nee", samples_per_call=1)
        bvh = build_accel(scene, cfg)
        cam = colonnade_camera(size)
        # target: the same scene with brighter lights, rendered with the
        # key the steps use (common random numbers), so the loss has a
        # direction to go and no Monte Carlo floor
        p0 = rg.targets_of(scene)
        bright = p0._replace(emission=p0.emission * 1.5)
        target = rg.render_image_diff(rg.scene_with(scene, bright), cam, cfg,
                                      jax.random.PRNGKey(0), 1, bvh=bvh)
    return scene, bvh, cam, cfg, target


def _fit_materials(lr):
    """Adam on albedo and emission; vertices and spheres stay put (a
    vertex step past a BVH box would need a rebuild, diff/render_grad.py)."""
    import optax

    from cudapathtracer.diff import render_grad as rg
    from cudapathtracer.ops.vecmath import Vec3

    frozen = Vec3("freeze", "freeze", "freeze")
    fit = Vec3("fit", "fit", "fit")
    labels = rg.GradTargets(verts=frozen, albedo=fit, emission=fit,
                            sph_center=frozen, sph_radius="freeze")
    return optax.multi_transform(
        {"fit": optax.adam(lr), "freeze": optax.set_to_zero()}, labels)


def _flat(tree):
    import jax
    import numpy as np

    return np.concatenate([np.asarray(x).ravel()
                           for x in jax.tree_util.tree_leaves(tree)])


def phase_train(size=256, steps=3, ref_size=32, subdiv=HEADLINE_SUBDIV,
                edge_samples=32):
    """Three optimiser steps of the full train step (interior + both
    boundary terms); the first step at ``ref_size`` against the CPU."""
    import jax
    import numpy as np

    from cudapathtracer.diff import render_grad as rg
    from cudapathtracer.parallel import mesh as mesh_mod
    from cudapathtracer.parallel import shard as shard_mod

    log(f"[train] colonnade subdiv {subdiv} at {size}^2, both boundary "
        f"terms ({edge_samples} edge samples each), {steps} Adam steps")
    scene, bvh, cam, cfg, target = _train_setup(subdiv, size)
    mesh = mesh_mod.make_tile_mesh(1)
    tx = _fit_materials(0.05)
    step = shard_mod.make_train_step(
        scene, cam, cfg, mesh, spp=1, bvh=bvh, optimizer=tx,
        edge_samples=edge_samples, shadow_edge_samples=edge_samples)
    # placed as the step returns them, so step 1 reuses step 0's program
    rep = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())
    params = jax.device_put(rg.targets_of(scene), rep)
    opt_state = jax.device_put(tx.init(params), rep)
    key = jax.random.PRNGKey(0)
    losses = []
    for i in range(steps):
        t0 = time.perf_counter()
        loss, params, opt_state = step(params, opt_state, target, key)
        loss = float(loss)
        losses.append(loss)
        log(f"  step {i}: loss {loss:.9g}, {time.perf_counter() - t0:.3f} s"
            f"{' (includes compilation)' if i == 0 else ' (smoke reading)'}")
        check(np.isfinite(loss), f"train step {i}: loss {loss}")
    check(all(b <= a for a, b in zip(losses, losses[1:])),
          f"train loss rose: {losses}")
    log(f"  peak_bytes_in_use {peak_bytes()}")

    # the first step's loss and gradients against the CPU, same program
    cpu = jax.devices("cpu")[0]
    results = []
    for dev in (jax.devices()[0], cpu):
        sc, bv, ca, cf, tg = _train_setup(subdiv, ref_size, device=dev)
        with jax.default_device(dev):
            m = mesh_mod.make_tile_mesh(devices=[dev])
            grad_fn = jax.jit(shard_mod.make_sharded_grad_fn(
                sc, ca, cf, m, spp=1, bvh=bv, edge_samples=edge_samples,
                shadow_edge_samples=edge_samples))
            idx = jax.numpy.arange(cf.num_pixels, dtype=jax.numpy.uint32)
            loss, grads = grad_fn(rg.targets_of(sc), tg, idx,
                                  jax.random.PRNGKey(0))
        results.append((float(loss), _flat(grads)))
    (l_dev, g_dev), (l_cpu, g_cpu) = results
    lrel = abs(l_dev - l_cpu) / max(abs(l_cpu), 1e-30)
    grel = float(np.linalg.norm(g_dev - g_cpu)
                 / max(np.linalg.norm(g_cpu), 1e-30))
    log(f"  vs CPU at {ref_size}^2: loss {l_dev:.9g} vs {l_cpu:.9g} "
        f"(rel {lrel:.3e}, limit {LOSS_RTOL:g}); gradient rel L2 "
        f"{grel:.3e} (limit {GRAD_REL_L2:g})")
    check(lrel <= LOSS_RTOL, f"train loss vs CPU: rel diff {lrel:.3e}")
    check(grel <= GRAD_REL_L2, f"train grads vs CPU: rel L2 {grel:.3e}")
    return losses


def bounce_rays(scene, bvh, cfg, size, seed=7):
    """One incoherent bounce batch: the camera's hit points at size^2,
    pulled back off the surface, with uniformly random directions."""
    import jax
    import jax.numpy as jnp

    from cudapathtracer.ops.rng import pixel_keys, sample_key
    from cudapathtracer.ops.vecmath import Vec3, normalized
    from cudapathtracer.render.camera import camera_rays
    from cudapathtracer.render.renderer import make_trace_fn

    cam = colonnade_camera(size)

    @jax.jit
    def make(sc, bv, key):
        idx = jnp.arange(size * size, dtype=jnp.uint32)
        o, d = camera_rays(cam, idx, pixel_keys(sample_key(key, 0), idx))
        trace_fn, _ = make_trace_fn(sc, cfg, bv)
        h = trace_fn(o, d, jnp.ones(idx.shape, bool))
        pos = o + d * jnp.where(h.tri >= 0, h.t - 1e-3, 1.0)
        g = jax.random.normal(key, (3, idx.shape[0]))
        return pos, normalized(Vec3(g[0], g[1], g[2])), h.tri >= 0

    return make(scene, bvh, jax.random.PRNGKey(seed))


def trace_program(cfg):
    """jit of the renderer's trace closure, scene data as arguments."""
    import jax

    from cudapathtracer.render.renderer import make_trace_fn

    def f(scene, bvh, prep, o, d, mask):
        return make_trace_fn(scene, cfg, bvh, prep=prep)[0](o, d, mask)

    return jax.jit(f)


def time_trace(fn, args, reps=2):
    import jax

    out = fn(*args)
    jax.block_until_ready(out)
    t = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn(*args)
        jax.block_until_ready(out)
        t = min(t, time.perf_counter() - t0)
    return out, t


def memory_report(label, compiled):
    ma = compiled.memory_analysis()
    if ma is None:
        log(f"  {label}: memory_analysis not available")
        return
    log(f"  {label}: memory_analysis temp {ma.temp_size_in_bytes} B, "
        f"arguments {ma.argument_size_in_bytes} B, "
        f"outputs {ma.output_size_in_bytes} B")


def sort_rays(o, d, m, scene_lo, scene_hi):
    """The batch reordered by the packet engine's coherence key (direction
    octant, then origin Morton code)."""
    import jax
    import jax.numpy as jnp

    from cudapathtracer.ops.packets import ray_sort_keys
    from cudapathtracer.ops.vecmath import Vec3

    @jax.jit
    def f(o, d, m):
        order = jnp.argsort(ray_sort_keys(o, d, m, scene_lo, scene_hi))
        take = lambda v: Vec3(*(c[order] for c in v))  # noqa: E731
        return take(o), take(d), m[order]

    return f(o, d, m)


def phase_scale(subdiv=SCALE_SUBDIV, size=1024, subset=65536):
    """The 328k-tri scene: native build, memory analysis of one 1M-ray
    trace (the default engine and the XLA packet engine), the default
    trace against the XLA per-ray walk on a subset."""
    import dataclasses

    from cudapathtracer import RenderConfig
    from cudapathtracer.ops.traversal import Hit
    from cudapathtracer.ops.vecmath import Vec3
    from cudapathtracer.render.renderer import (
        make_packet_prep,
        resolve_traversal,
    )

    scene = colonnade(subdiv)
    cfg = RenderConfig(width=size, height=size, integrator="pt_nee")
    kind = resolve_traversal(cfg)
    log(f"[scale] colonnade subdiv {subdiv}, {size * size} bounce rays, "
        f"default traversal '{kind}'")
    bvh = build_accel(scene, cfg)
    prep = make_packet_prep(scene, bvh)
    o, d, m = bounce_rays(scene, bvh, cfg, size)
    hit = None
    for k in dict.fromkeys((kind, "packets")):
        fn = trace_program(dataclasses.replace(cfg, traversal=k))
        pp = prep if k == "packets" else None
        t0 = time.perf_counter()
        compiled = fn.lower(scene, bvh, pp, o, d, m).compile()
        log(f"  '{k}': compile of one {size * size}-ray trace "
            f"{time.perf_counter() - t0:.3f} s")
        memory_report(f"'{k}'", compiled)
        if k == kind:
            hit, dt = time_trace(compiled, (scene, bvh, pp, o, d, m))
            log(f"  '{k}': bounce trace {dt:.4f} s "
                f"({size * size / dt / 1e6:.3f} Mrays/s, smoke reading); "
                f"peak_bytes_in_use {peak_bytes()}")

    sub = slice(0, subset)
    os_, ds_ = Vec3(*(c[sub] for c in o)), Vec3(*(c[sub] for c in d))
    walk = trace_program(dataclasses.replace(cfg, traversal="bvh"))
    ref = walk(scene, bvh, None, os_, ds_, m[sub])
    compare_hits(Hit(tri=hit.tri[sub], t=hit.t[sub]), ref,
                 f"'{kind}' vs XLA per-ray walk ({subset} rays, "
                 f"{scene.num_tris} tris)")


def phase_kernel(subdivs=(HEADLINE_SUBDIV, SCALE_SUBDIV), size=1024,
                 subset=65536):
    """The CUDA walk against the plain XLA walk (ops/traversal.trace) on
    size^2 bounce rays: hits, t, the lane mask and visibility caps, both
    intersectors; times both on the unsorted and the sorted batch."""
    import jax
    import jax.numpy as jnp

    from cudapathtracer import RenderConfig
    from cudapathtracer.accel.bvh import as_fine
    from cudapathtracer.ops import cuda_walk, traversal
    from cudapathtracer.ops.vecmath import Vec3

    for subdiv in subdivs:
        scene = colonnade(subdiv)
        cfg = RenderConfig(width=size, height=size, integrator="pt_nee")
        bvh = build_accel(scene, cfg)
        td = jax.jit(traversal.make_trace_data)(scene, as_fine(bvh))
        o, d, m = bounce_rays(scene, bvh, cfg, size)
        subset = min(subset, o.x.shape[0])
        lo = Vec3(*(jnp.min(v) for v in scene.verts))
        hi = Vec3(*(jnp.max(v) for v in scene.verts))
        R = o.x.shape[0]
        tag = f"{scene.num_tris} tris, {R} rays"
        log(f"[kernel] {tag}")

        for isect in ("bw", "mt"):
            def kern_fn(o, d, td, m, c, i=isect):
                return cuda_walk.closest_hit(o, d, td, mask=m, t_cap=c,
                                             intersector=i)

            kern = jax.jit(kern_fn)
            def walk_fn(o, d, td, m, c, i=isect):
                h = traversal.trace(o, d, td, mask=m, intersector=i)
                return h if c is None else traversal.apply_t_cap(h, c)

            walk = jax.jit(walk_fn)
            if isect == "bw":
                for order, (oo, dd, mm) in (("unsorted", (o, d, m)),
                                            ("sorted", sort_rays(
                                                o, d, m, lo, hi))):
                    hk, tk = time_trace(kern, (oo, dd, td, mm, None))
                    hw, tw = time_trace(walk, (oo, dd, td, mm, None))
                    log(f"  {order} bounce trace: kernel {tk:.4f} s "
                        f"({R / tk / 1e6:.3f} Mrays/s), XLA walk "
                        f"{tw:.4f} s ({R / tw / 1e6:.3f} Mrays/s) "
                        "(smoke readings)")
                    compare_hits(hk, hw, f"kernel vs per-ray walk, {order},"
                                 f" {tag}")
            # mask and visibility caps, on a subset
            sub = slice(0, subset)
            os_, ds_ = Vec3(*(c[sub] for c in o)), Vec3(*(c[sub] for c in d))
            ms = m[sub] & (jnp.arange(subset) % 7 != 0)
            full = walk(os_, ds_, td, ms, None)
            cap = jnp.where(jnp.arange(subset) % 2 == 0,
                            0.5 * full.t + 0.05, jnp.inf)
            compare_hits(kern(os_, ds_, td, ms, cap), walk(os_, ds_, td, ms,
                                                           cap),
                         f"kernel vs per-ray walk, '{isect}', mask + caps, "
                         f"{subset} rays")


def phase_engines(subdivs=(HEADLINE_SUBDIV, SCALE_SUBDIV), size=1024, spp=1):
    """Closest-hit engines side by side — the XLA packet engine, the XLA
    per-ray walk, the CUDA walk: one 1M-ray bounce trace and the headline
    render, per scene size."""
    import dataclasses

    from cudapathtracer import RenderConfig
    from cudapathtracer.render.renderer import make_packet_prep

    for subdiv in subdivs:
        scene = colonnade(subdiv)
        base = RenderConfig(width=size, height=size, spp=spp,
                            integrator="pt_nee", samples_per_call=spp,
                            reuse_primary_hit=True)
        bvh = build_accel(scene, base)
        prep = make_packet_prep(scene, bvh)
        o, d, m = bounce_rays(scene, bvh, base, size)
        for kind in ("packets", "bvh", "cuda"):
            cfg = dataclasses.replace(base, traversal=kind)
            _, dt = time_trace(trace_program(cfg),
                               (scene, bvh, prep if kind == "packets"
                                else None, o, d, m), reps=1)
            log(f"[engines] {scene.num_tris} tris, {kind}: bounce trace "
                f"{dt:.4f} s ({size * size / dt / 1e6:.3f} Mrays/s)")
            _, first, steady = timed_render(scene, bvh,
                                            colonnade_camera(size), cfg, spp)
            report_render(f"[engines] {scene.num_tris} tris, {kind} render "
                          f"{size}^2", cfg, spp, first, steady)


def phase_four_gpus(n=4, size=512, spp=2, train_size=128,
                    subdiv=HEADLINE_SUBDIV, edge_samples=32):
    """The sharded path across ``n`` devices against one device: the
    render at ULP parity, the train step's loss and gradients."""
    import jax
    import numpy as np

    from cudapathtracer import RenderConfig, init_accum
    from cudapathtracer.diff import render_grad as rg
    from cudapathtracer.parallel import mesh as mesh_mod
    from cudapathtracer.parallel import shard as shard_mod

    log(f"[four] sharded render on {n} devices, colonnade at {size}^2")
    scene = colonnade(subdiv)
    cfg = RenderConfig(width=size, height=size, spp=spp, integrator="pt_nee",
                       samples_per_call=spp)
    bvh = build_accel(scene, cfg)
    cam = colonnade_camera(size)
    key = jax.random.PRNGKey(4)
    mesh = mesh_mod.make_tile_mesh(n)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        st = shard_mod.render_sharded_jit(scene, bvh, cam, cfg, key,
                                          init_accum(cfg), spp, mesh)
        jax.block_until_ready(st)
        times.append(time.perf_counter() - t0)
    ref, first1, steady1 = timed_render(scene, bvh, cam, cfg, spp, seed=4)
    report_render(f"{n}-device sharded render", cfg, spp, times[0], times[1])
    report_render("1-device render", cfg, spp, first1, steady1)
    a, b = image_stats(st), image_stats(ref)
    # the test suite's ULP contract (tests/test_parallel.py): identical
    # paths, FMA contraction may differ with the per-device shapes
    close = np.isclose(a, b, rtol=3e-6, atol=1e-7).all(axis=1)
    log(f"  sharded vs 1-device: {close.mean():.6f} of pixels within "
        f"rtol 3e-6 (limit {HIT_AGREE:.4f}); max |diff| "
        f"{np.abs(a - b).max():.3e}")
    check(close.mean() >= HIT_AGREE, "sharded render differs from 1-device")

    log(f"[four] train step on {n} devices at {train_size}^2 vs 1 device")
    sc, bv, ca, cf, tg = _train_setup(subdiv, train_size)
    idx = jax.numpy.arange(cf.num_pixels, dtype=jax.numpy.uint32)
    out = []
    for k in (n, 1):
        m = mesh_mod.make_tile_mesh(k)
        grad_fn = jax.jit(shard_mod.make_sharded_grad_fn(
            sc, ca, cf, m, spp=1, bvh=bv, edge_samples=edge_samples,
            shadow_edge_samples=edge_samples))
        loss, grads = grad_fn(rg.targets_of(sc), tg, idx,
                              jax.random.PRNGKey(0))
        out.append((float(loss), _flat(grads)))
    step = shard_mod.make_train_step(sc, ca, cf, mesh, spp=1, bvh=bv,
                                     optimizer=_fit_materials(0.05),
                                     edge_samples=edge_samples,
                                     shadow_edge_samples=edge_samples)
    p0 = rg.targets_of(sc)
    loss_step, _, _ = step(p0, _fit_materials(0.05).init(p0), tg,
                           jax.random.PRNGKey(0))
    (l_n, g_n), (l_1, g_1) = out
    lrel = abs(l_n - l_1) / max(abs(l_1), 1e-30)
    grel = float(np.linalg.norm(g_n - g_1) / max(np.linalg.norm(g_1), 1e-30))
    log(f"  loss {l_n:.9g} ({n} devices) vs {l_1:.9g} (1 device), rel "
        f"{lrel:.3e}; gradient rel L2 {grel:.3e}; make_train_step loss "
        f"{float(loss_step):.9g}")
    check(lrel <= LOSS_RTOL, f"{n}-device loss differs: {lrel:.3e}")
    check(grel <= GRAD_REL_L2, f"{n}-device grads differ: {grel:.3e}")
    check(abs(float(loss_step) - l_n) <= LOSS_RTOL * abs(l_n),
          "make_train_step loss differs from its gradient core")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the four-card sharded phase")
    args = ap.parse_args(argv)

    import jax

    from cudapathtracer.utils.compile_cache import enable_compile_cache

    n = 4 if args.four_gpus else 1
    devs = device_check(n)
    log(f"compile cache: {enable_compile_cache()}")
    t_start = time.perf_counter()
    with jax.default_matmul_precision("highest"):
        if args.four_gpus:
            phase_four_gpus(n)
        else:
            scene, bvh = phase_pt_nee()
            phase_bdpt(scene=scene, bvh=bvh)
            phase_train()
            phase_scale()
            phase_kernel()
            phase_engines()
    log(f"all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
