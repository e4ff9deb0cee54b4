"""(Re-)bless the golden images used by tests/test_goldens.py.

Run on CPU for reproducibility with CI (the test env): the goldens encode
the exact RNG stream + integrator semantics, so any intentional change to
either (e.g. the batched uniform_sites derivation) requires re-blessing.
Review the rendered PNGs in examples/ before committing new goldens.

Run: python tools/bless_goldens.py
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

import cudapathtracer as cpt  # noqa: E402
from cudapathtracer import RenderConfig, make_camera  # noqa: E402
from cudapathtracer.models import procedural  # noqa: E402
from cudapathtracer.render.renderer import finalize_image  # noqa: E402
from cudapathtracer.utils.ppm import write_ppm  # noqa: E402

GOLDENS = os.path.join(REPO, "tests", "goldens")


def bless(name, scene, cfg, cam):
    st = cpt.render(scene, cam, cfg, seed=1234)
    img = finalize_image(st, cfg)
    write_ppm(os.path.join(GOLDENS, name), img, flip_x=True)
    print(f"blessed {name}: mean u8 {img.astype(np.float64).mean():.1f}")


def bless_falsecolor():
    """BVH-traversal-cost falsecolor golden (the 'sponza bvh.ppm' analogue,
    r2 verdict #7): drift in traversal cost becomes visible in CI."""
    from cudapathtracer.render.renderer import build_bvh_for_scene
    from cudapathtracer.utils.profiling import falsecolor_state

    scene = procedural.to_scene(procedural.colonnade(subdiv=2))
    cfg = RenderConfig(width=64, height=64, spp=1, samples_per_call=1,
                       integrator="pt_nee")
    cam = make_camera(pos=(0.0, 2.0, 3.4), width=64, height=64,
                      focal_length=2.0)
    bvh = build_bvh_for_scene(scene, cfg.leaf_size)
    st, stats = falsecolor_state(scene, bvh, cam, cfg, seed=1234)
    img = finalize_image(st, cfg)
    write_ppm(os.path.join(GOLDENS, "colonnade_bvh_falsecolor_64.ppm"), img,
              flip_x=True)
    print(f"blessed colonnade_bvh_falsecolor_64.ppm: mean u8 "
          f"{img.astype(np.float64).mean():.1f}, "
          f"steps={int(stats.steps)}")


def main():
    cornell = procedural.to_scene(procedural.cornell_box())

    bless("cornell_pt_nee_64_spp16.ppm", cornell,
          RenderConfig(width=64, height=64, spp=16, integrator="pt_nee",
                       samples_per_call=16),
          make_camera(width=64, height=64))

    bless("cornell_bdpt_32_spp8.ppm", cornell,
          RenderConfig(width=32, height=32, spp=8, integrator="bdpt",
                       samples_per_call=8),
          make_camera(width=32, height=32))

    bless("cornell_sphere_pt_nee_32_spp8.ppm",
          procedural.cornell_with_analytic_sphere(),
          RenderConfig(width=32, height=32, spp=8, integrator="pt_nee",
                       samples_per_call=8),
          make_camera(width=32, height=32))

    # tighter drift alarm at 128^2
    bless("cornell_pt_nee_128_spp8.ppm", cornell,
          RenderConfig(width=128, height=128, spp=8, integrator="pt_nee",
                       samples_per_call=8),
          make_camera(width=128, height=128))


def _main_with_falsecolor():
    main()
    bless_falsecolor()


if __name__ == "__main__":
    _main_with_falsecolor()
