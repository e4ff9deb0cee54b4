"""Multi-device scaling-efficiency benchmark: renders the same workload on a
1-device mesh and on the full mesh and reports parallel efficiency.

Prints one JSON line:
  {"metric": "scaling efficiency 1->N", "value": eff, "unit": "ratio", ...}

Run it in one process on a machine with several GPUs (four H100s joined by
NVLink); with one visible device it reports N=1 (efficiency 1.0 by
definition). To exercise the sharded path mechanically, run on virtual CPU
devices (CPU timings say nothing about the GPUs):

  JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=8 \
      python bench_scaling.py

A jax.profiler trace of one sharded render step AND one distributed train
step (the gradient psum) is written to SCALE_PROFILE_DIR (default
profiles/scaling inside the checkout; set empty to skip) — the
trace shows whether the gradient all-reduce overlaps the backward sweep.
The artifact path rides in the JSON line as "profile_artifact".

Env knobs: SCALE_SIZE (default 512), SCALE_SPP (4), SCALE_SUBDIV (2),
SCALE_PROFILE_DIR (set empty to skip profiling).
"""

import json
import os
import sys
import time

import numpy as np


def main():
    import jax

    from cudapathtracer.utils.compile_cache import (
        REPO_ROOT,
        enable_compile_cache,
    )

    enable_compile_cache()

    import cudapathtracer as cpt
    from cudapathtracer.models import procedural
    from cudapathtracer.parallel import mesh as mesh_mod
    from cudapathtracer.parallel import shard as shard_mod
    from cudapathtracer.render.renderer import (
        build_bvh_for_scene,
        init_accum,
    )

    size = int(os.environ.get("SCALE_SIZE", "512"))
    spp = int(os.environ.get("SCALE_SPP", "4"))
    subdiv = int(os.environ.get("SCALE_SUBDIV", "2"))

    scene = procedural.to_scene(procedural.colonnade(subdiv=subdiv))
    accel = build_bvh_for_scene(scene, 4)
    cam = cpt.make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                          focal_length=2.0)
    cfg = cpt.RenderConfig(width=size, height=size, spp=spp,
                           integrator="pt_nee", samples_per_call=spp)
    key = jax.random.PRNGKey(7)
    n_all = len(jax.devices())

    def run(n_dev):
        mesh = mesh_mod.make_tile_mesh(n_dev)
        st = shard_mod.render_sharded_jit(
            scene, accel, cam, cfg, key, init_accum(cfg), spp, mesh)
        float(np.asarray(st.img.x[0]))  # compile + sync
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            st = shard_mod.render_sharded_jit(
                scene, accel, cam, cfg, key, init_accum(cfg), spp, mesh)
            float(np.asarray(st.img.x[0]))
            best = min(best, time.time() - t0)
        rays = cfg.num_pixels * spp * (cfg.num_bounces + 1)
        return rays / best / 1e6, st

    # profiler artifact: one sharded forward step + one train step (the
    # psum all-reduce) under jax.profiler.trace
    prof_dir = os.environ.get(
        "SCALE_PROFILE_DIR",
        os.path.join(REPO_ROOT, "profiles", "scaling"))
    if prof_dir:
        from cudapathtracer.diff import render_grad as rg

        mesh = mesh_mod.make_tile_mesh(n_all)
        small = cpt.RenderConfig(width=min(size, 256), height=min(size, 256),
                                 spp=1, integrator="pt_nee",
                                 samples_per_call=1)
        tgt = rg.render_image_diff(scene, cam, small, key, 1, bvh=accel)
        step = shard_mod.make_train_step(scene, cam, small, mesh, spp=1,
                                         bvh=accel, learning_rate=1e-3)
        params = rg.targets_of(scene)
        # compile OUTSIDE the trace so the artifact shows execution, not
        # tracing/compilation
        st = shard_mod.render_sharded_jit(
            scene, accel, cam, small, key, init_accum(small), 1, mesh)
        float(np.asarray(st.img.x[0]))
        loss, _, _ = step(params, None, tgt, key)
        float(loss)
        with jax.profiler.trace(prof_dir):
            st = shard_mod.render_sharded_jit(
                scene, accel, cam, small, key, init_accum(small), 1, mesh)
            float(np.asarray(st.img.x[0]))
            loss, _, _ = step(params, None, tgt, key)
            float(loss)
        print(f"# profiler trace written to {prof_dir}", file=sys.stderr)

    r1, img1 = run(1)
    if n_all == 1:
        eff = 1.0
        rn = r1
    else:
        rn, imgn = run(n_all)
        eff = rn / (r1 * n_all)
        a = np.asarray(img1.img.x)
        b = np.asarray(imgn.img.x)
        md = float(np.abs(a - b).max())
        # contract: equal to XLA fusion ULPs (tests/test_parallel.py)
        print(f"# sharded vs 1-dev image max |delta| = {md:.2e} "
              f"(ULP-level expected)", file=sys.stderr)

    print(json.dumps({
        "metric": f"scaling efficiency 1->{n_all} "
                  f"({jax.devices()[0].platform})",
        "value": round(eff, 3),
        "unit": "ratio",
        "vs_baseline": round(eff / 0.85, 3),
        "profile_artifact": prof_dir or None,
    }))
    print(f"# 1-dev {r1:.2f} Mrays/s; {n_all}-dev {rn:.2f} Mrays/s",
          file=sys.stderr)


if __name__ == "__main__":
    main()
