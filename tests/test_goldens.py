"""Golden-image regression (the role of the reference's keepers/ PPMs,
SURVEY.md §4): renders of fixed configs must stay within quantization
tolerance of blessed images.

The reference's own keepers can't be re-rendered here (its models/ are
.gitignored upstream), so the goldens are OUR blessed renders of the
procedural scenes — they catch any behavioral drift in the whole pipeline
(camera, RNG, traversal, integrators, accumulation, tonemap, PPM). The
tolerance (2/255 per channel) absorbs compiler-level FMA variation between
XLA releases while still flagging real changes."""

import os

import numpy as np
import pytest

import cudapathtracer as cpt
from cudapathtracer import RenderConfig, make_camera
from cudapathtracer.models import procedural
from cudapathtracer.render.renderer import finalize_image
from cudapathtracer.utils.ppm import read_ppm

GOLDENS = os.path.join(os.path.dirname(__file__), "goldens")


def _check(state, cfg, name, tol=2):
    img = finalize_image(state, cfg).astype(np.int32)
    # write_render flips x (the reference's PPM loop, kernel.cu:768)
    img = img[:, ::-1]
    gold = read_ppm(os.path.join(GOLDENS, name)).astype(np.int32)
    assert img.shape == gold.shape
    diff = np.abs(img - gold)
    frac_bad = (diff > tol).mean()
    assert frac_bad < 0.005, (
        f"{name}: {frac_bad:.2%} of channels differ by more than {tol}"
    )


def test_golden_cornell_pt_nee():
    scene = procedural.to_scene(procedural.cornell_box())
    cam = make_camera(width=64, height=64)
    cfg = RenderConfig(width=64, height=64, spp=16, integrator="pt_nee",
                       samples_per_call=16)
    st = cpt.render(scene, cam, cfg, seed=1234)
    _check(st, cfg, "cornell_pt_nee_64_spp16.ppm")


def test_golden_cornell_bdpt():
    scene = procedural.to_scene(procedural.cornell_box())
    cam = make_camera(width=32, height=32)
    cfg = RenderConfig(width=32, height=32, spp=8, integrator="bdpt",
                       samples_per_call=8)
    st = cpt.render(scene, cam, cfg, seed=1234)
    _check(st, cfg, "cornell_bdpt_32_spp8.ppm")


def test_golden_analytic_sphere():
    scene = procedural.cornell_with_analytic_sphere()
    cam = make_camera(width=32, height=32)
    cfg = RenderConfig(width=32, height=32, spp=8, integrator="pt_nee",
                       samples_per_call=8)
    st = cpt.render(scene, cam, cfg, seed=1234)
    _check(st, cfg, "cornell_sphere_pt_nee_32_spp8.ppm")


def test_golden_cornell_pt_nee_128():
    """Tighter drift alarm: 128^2 averages ~16x more paths per image than
    the 64^2 golden, so integrator-level drift that hides inside MC noise
    at 64^2 shows up here."""
    scene = procedural.to_scene(procedural.cornell_box())
    cam = make_camera(width=128, height=128)
    cfg = RenderConfig(width=128, height=128, spp=8, integrator="pt_nee",
                       samples_per_call=8)
    st = cpt.render(scene, cam, cfg, seed=1234)
    _check(st, cfg, "cornell_pt_nee_128_spp8.ppm")


def test_golden_bvh_falsecolor():
    """Traversal-cost falsecolor (the 'sponza bvh.ppm' keeper analogue,
    /root/reference/keepers/): drift in per-ray BVH visit counts — BVH
    build quality or traversal behavior — shows up as image drift here."""
    from cudapathtracer.render.renderer import build_bvh_for_scene
    from cudapathtracer.utils.profiling import falsecolor_state

    scene = procedural.to_scene(procedural.colonnade(subdiv=2))
    cfg = RenderConfig(width=64, height=64, spp=1, samples_per_call=1,
                       integrator="pt_nee")
    cam = make_camera(pos=(0.0, 2.0, 3.4), width=64, height=64,
                      focal_length=2.0)
    bvh = build_bvh_for_scene(scene, cfg.leaf_size)
    st, _ = falsecolor_state(scene, bvh, cam, cfg, seed=1234)
    _check(st, cfg, "colonnade_bvh_falsecolor_64.ppm")
