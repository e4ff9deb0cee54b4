"""Headline benchmark: rays/s on the sponza-class stress scene.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline"}.

Metric: Mrays/s using the reference's own accounting
(kernel.cu:757: rays = width*height*spp*(bounces+1)), on our sponza-stand-in
``colonnade`` scene (the real sponza OBJ is not shipped with the reference —
models/ is .gitignored). Baseline: the reference's best hand-recorded sponza
run, 1170 ms for 512^2 x 100 x 4 rays (metricsForSponza.txt:8, "best
occupancy") => 89.6 Mrays/s on its contemporary GPU. vs_baseline = ours /
89.6; it is context, not a target.

spp here is a measurement window, not a quality setting — throughput is
flat across spp because every sample is the same program.

The headline is the 20k-tri scene; the JSON also carries the SCALE SWEEP
(``mrays_82k``, ``mrays_328k``, ``mrays_1310k`` — colonnade subdiv 4/5/6).

Env knobs: BENCH_SPP (default 16), BENCH_SIZE (default 1024), BENCH_SUBDIV
(colonnade sphere subdiv, default 3 => 20,884 tris; 4 => ~82k; 5 => ~328k),
BENCH_SWEEP=0 to skip the sweep, BENCH_BIG=0 to skip the 1.31M point.

python chip_smoke.py is the quicker check that the whole path runs on the
GPU and agrees with its references.
"""

import json
import os
import time

BASELINE_MRAYS = 512 * 512 * 100 * 4 / (1170.0 * 1000.0)  # 89.61


def main():
    import jax

    from cudapathtracer.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    from cudapathtracer import RenderConfig, init_accum, make_camera
    from cudapathtracer.models import procedural
    from cudapathtracer.render.renderer import (
        build_bvh_for_scene,
        make_packet_prep,
        render_batch_jit,
        resolve_traversal,
    )

    spp = int(os.environ.get("BENCH_SPP", "16"))
    size = int(os.environ.get("BENCH_SIZE", "1024"))
    subdiv = int(os.environ.get("BENCH_SUBDIV", "3"))
    sbatch = int(os.environ.get("BENCH_SBATCH", "1"))
    with_bdpt = os.environ.get("BENCH_BDPT", "1") != "0"
    with_sweep = os.environ.get("BENCH_SWEEP", "1") != "0"

    import numpy as np

    def measure(subdiv, spp, repeats=3):
        """-> (Mrays/s, scene, bvh, build_s) for one colonnade scale."""
        desc = procedural.colonnade(subdiv=subdiv)
        scene = procedural.to_scene(desc)
        cfg = RenderConfig(
            width=size, height=size, spp=spp,
            integrator="pt_nee", samples_per_call=spp,
            sample_batch=sbatch,
            packet_rounds=int(os.environ.get("BENCH_ROUNDS", "1")),
            packet_first_round=int(os.environ.get("BENCH_FIRST", "2")),
            sort_window=int(os.environ.get("BENCH_SORTWIN", "0")),
            cluster_size=(int(os.environ["BENCH_C"])
                          if "BENCH_C" in os.environ else None),
            tile_size=(int(os.environ["BENCH_TILE"])
                       if "BENCH_TILE" in os.environ else None),
            two_level_cull={"auto": None, "0": False, "1": True}[
                os.environ.get("BENCH_TWO_LEVEL", "auto")],
            reuse_primary_hit=True)  # pinhole camera, no jitter
        t0 = time.time()
        bvh = build_bvh_for_scene(scene, cfg.leaf_size,
                                  cluster_size=cfg.cluster_size)
        t_build = time.time() - t0
        cam = make_camera(pos=(0.0, 2.0, 3.4), width=size, height=size,
                          focal_length=2.0)
        key = jax.random.PRNGKey(1234)
        prep = (make_packet_prep(scene, bvh)
                if resolve_traversal(cfg) == "packets" else None)

        # warmup / compile — must use the SAME num_samples as the timed
        # window (num_samples is a static jit arg; a different value
        # recompiles); a host readback synchronizes
        st = render_batch_jit(scene, bvh, cam, cfg, key, init_accum(cfg),
                              spp, prep=prep)
        float(np.asarray(st.img.x[0]))

        # timed window: spp samples; best of N
        dt = float("inf")
        for _ in range(repeats):
            t0 = time.time()
            st = render_batch_jit(scene, bvh, cam, cfg, key,
                                  init_accum(cfg), spp, prep=prep)
            float(np.asarray(st.img.x[0]))
            dt = min(dt, time.time() - t0)
        rays = cfg.num_pixels * spp * (cfg.num_bounces + 1)
        return rays / dt / 1e6, scene, bvh, t_build, cfg, dt

    mrays, scene, bvh, t_build, cfg, dt = measure(subdiv, spp)
    result = {
        "metric": "Mrays/s (colonnade %dk tris, %d^2, pt_nee, %d bounces)" % (
            scene.num_tris // 1000, size, cfg.num_bounces
        ),
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "vs_baseline": round(mrays / BASELINE_MRAYS, 3),
    }

    if with_sweep:
        # sponza-scale sweep: the baseline scene is 262k tris — report the
        # 82k and 328k numbers so vs_baseline is apples-to-apples, plus
        # the 1.31M-tri point (colonnade subdiv 6, ~4x sponza).
        # BENCH_BIG=0 skips the big point.
        sweep = [(4, "mrays_82k"), (5, "mrays_328k")]
        if os.environ.get("BENCH_BIG", "1") != "0":
            sweep.append((6, "mrays_1310k"))
        for sub, name in sweep:
            if sub == subdiv:
                result[name] = round(mrays, 2)
                continue
            mr, _, _, _, _, _ = measure(sub, max(4, spp // 2))
            result[name] = round(mr, 2)
        result["mrays_328k_vs_baseline"] = round(
            result["mrays_328k"] / BASELINE_MRAYS, 3)

    if with_bdpt:
        # secondary metric: BDPT — the reference's LIVE integrator
        # (kernel.cu:549) — at its live 512^2 config, same ray accounting
        import dataclasses

        bsize = 512
        # window >= 8 samples
        bspp = int(os.environ.get("BENCH_BDPT_SPP", str(max(8, spp // 4))))
        bsb = int(os.environ.get("BENCH_BDPT_SBATCH", "2"))
        # BDPT's batched 2R/4R traces get their own tile size
        btile = int(os.environ.get("BENCH_BDPT_TILE", "256"))
        btilev = os.environ.get("BENCH_BDPT_TILE_VIS")
        bcfg = dataclasses.replace(cfg, width=bsize, height=bsize,
                                   integrator="bdpt", spp=bspp,
                                   samples_per_call=bspp, sample_batch=bsb,
                                   tile_size=btile,
                                   tile_size_vis=(int(btilev) if btilev
                                                  else None))
        bcam = make_camera(pos=(0.0, 2.0, 3.4), width=bsize, height=bsize,
                           focal_length=2.0)
        key = jax.random.PRNGKey(1234)
        bprep = (make_packet_prep(scene, bvh)
                 if resolve_traversal(bcfg) == "packets" else None)
        st = render_batch_jit(scene, bvh, bcam, bcfg, key,
                              init_accum(bcfg), bspp, prep=bprep)
        float(np.asarray(st.img.x[0]))
        bdt = float("inf")
        for _ in range(3):
            t0 = time.time()
            st = render_batch_jit(scene, bvh, bcam, bcfg, key,
                                  init_accum(bcfg), bspp, prep=bprep)
            float(np.asarray(st.img.x[0]))
            bdt = min(bdt, time.time() - t0)
        brays = bcfg.num_pixels * bspp * (bcfg.num_bounces + 1)
        result["bdpt_mrays"] = round(brays / bdt / 1e6, 2)
        result["bdpt_vs_baseline"] = round(
            brays / bdt / 1e6 / BASELINE_MRAYS, 3)

    if os.environ.get("BENCH_TRAIN", "1") != "0":
        # train-step metric: one jitted value_and_grad step of the
        # inverse-rendering L2 loss on the headline scene, interior terms
        # only — the diff pass traces through the same engine
        # (diff/render_grad.py). grad_mrays uses the forward ray accounting
        # (pixels*spp*(bounces+1)); the true work is ~2 forward traces
        # (checkpoint remat) + backward math.
        import dataclasses

        from cudapathtracer.diff import render_grad as rg

        tsize = int(os.environ.get("BENCH_TRAIN_SIZE", "256"))
        tspp = int(os.environ.get("BENCH_TRAIN_SPP", "1"))
        tcfg = dataclasses.replace(cfg, width=tsize, height=tsize,
                                   spp=tspp, samples_per_call=tspp,
                                   sample_batch=1,
                                   reuse_primary_hit=False)
        tcam = make_camera(pos=(0.0, 2.0, 3.4), width=tsize, height=tsize,
                           focal_length=2.0)
        tkey = jax.random.PRNGKey(1234)
        target = rg.render_image_diff(scene, tcam, tcfg,
                                      jax.random.PRNGKey(9), tspp, bvh=bvh)
        loss_fn = rg.make_loss_fn(scene, tcam, tcfg, tkey, tspp, bvh=bvh)
        step = jax.jit(jax.value_and_grad(loss_fn))
        p0 = rg.targets_of(scene)
        loss, _ = step(p0, target)
        float(np.asarray(loss))
        tdt = float("inf")
        for _ in range(3):
            t0 = time.time()
            loss, grads = step(p0, target)
            float(np.asarray(loss))
            tdt = min(tdt, time.time() - t0)
        result["train_step_ms"] = round(tdt * 1000.0, 1)
        result["grad_mrays"] = round(
            tsize * tsize * tspp * (tcfg.num_bounces + 1) / tdt / 1e6, 2)

    print(json.dumps(result))
    # extra context on stderr (driver only parses stdout JSON)
    import sys

    print(
        f"# tris={scene.num_tris} bvh_build={t_build:.2f}s "
        f"window={dt:.2f}s spp={spp} device={jax.devices()[0]}",
        file=sys.stderr,
    )


if __name__ == "__main__":
    main()
