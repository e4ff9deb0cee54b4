import numpy as np
import jax
import jax.numpy as jnp
import pytest

from cudapathtracer import (
    RenderConfig,
    finalize_image,
    init_accum,
    make_camera,
    render,
)
from cudapathtracer.models import procedural


@pytest.fixture(scope="module")
def cornell():
    return procedural.to_scene(procedural.cornell_box())


@pytest.mark.parametrize("integrator", ["pt_nee", "bdpt"])
def test_render_smoke(cornell, integrator):
    cam = make_camera(width=16, height=16)
    cfg = RenderConfig(width=16, height=16, spp=2, integrator=integrator,
                       samples_per_call=2)
    st = render(cornell, cam, cfg)
    img = finalize_image(st, cfg)
    assert img.shape == (16, 16, 3)
    assert img.max() > 0  # something is lit
    assert np.all(np.isfinite(np.asarray(st.img.x)))


def test_bvh_equals_bruteforce(cornell):
    """Full renders through the packet engine vs the brute oracle.

    The TRACE results are bit-identical (tests/test_packets.py asserts
    that directly); the full-image comparison is to a few ULPs because the
    radiance arithmetic after the trace is fused by XLA differently around
    the two trace subgraphs (FMA contraction choices differ per graph —
    observed: identical hits, 1-2 ULP radiance deltas on ~1% of pixels)."""
    cam = make_camera(width=16, height=16)
    a = render(cornell, cam,
               RenderConfig(width=16, height=16, spp=4, integrator="pt_nee",
                            samples_per_call=4), seed=9)
    b = render(cornell, cam,
               RenderConfig(width=16, height=16, spp=4, integrator="pt_nee",
                            traversal="brute", samples_per_call=4), seed=9)
    np.testing.assert_allclose(np.asarray(a.img.x), np.asarray(b.img.x),
                               rtol=3e-6, atol=1e-7)
    np.testing.assert_allclose(np.asarray(a.img.y), np.asarray(b.img.y),
                               rtol=3e-6, atol=1e-7)


def test_deterministic_same_seed(cornell):
    cam = make_camera(width=16, height=16)
    cfg = RenderConfig(width=16, height=16, spp=3, integrator="bdpt",
                       samples_per_call=3)
    a = render(cornell, cam, cfg, seed=5)
    b = render(cornell, cam, cfg, seed=5)
    np.testing.assert_array_equal(np.asarray(a.img.x), np.asarray(b.img.x))
    c = render(cornell, cam, cfg, seed=6)
    assert np.abs(np.asarray(a.img.x) - np.asarray(c.img.x)).max() > 0


def test_resume_equals_straight_run(cornell):
    """The accumulation contract (SURVEY.md §5.4): rendering 2 then 3 more
    samples from the saved state equals rendering 5 straight."""
    cam = make_camera(width=16, height=16)
    cfg = RenderConfig(width=16, height=16, spp=5, integrator="pt_nee",
                       samples_per_call=5)
    full = render(cornell, cam, cfg, seed=3)

    cfg_a = RenderConfig(width=16, height=16, spp=2, integrator="pt_nee",
                         samples_per_call=2)
    part = render(cornell, cam, cfg_a, seed=3)
    resumed = render(cornell, cam, cfg, seed=3, state=part)
    np.testing.assert_allclose(
        np.asarray(full.img.x), np.asarray(resumed.img.x), rtol=1e-6
    )
    assert int(resumed.n) == 5


def test_running_mean_semantics(cornell):
    """img after n samples == mean of the n per-sample images
    (kernel.cu:551-552)."""
    cam = make_camera(width=8, height=8)
    base = RenderConfig(width=8, height=8, spp=1, integrator="pt_nee",
                        samples_per_call=1, compensated_accum=False)
    # render samples one at a time, collecting each sample's contribution
    st = None
    per_sample = []
    from cudapathtracer.render.renderer import init_accum as ia

    prev = np.zeros(64, np.float32)
    state = None
    for k in range(1, 4):
        cfg_k = RenderConfig(width=8, height=8, spp=k, integrator="pt_nee",
                             samples_per_call=1, compensated_accum=False)
        state = render(cornell, cam, cfg_k, seed=11, state=state)
        cur = np.asarray(state.img.x)
        # sample_k = n*cur - (n-1)*prev
        per_sample.append(k * cur - (k - 1) * prev)
        prev = cur
    mean = np.stack(per_sample).mean(0)
    np.testing.assert_allclose(prev, mean, rtol=1e-4, atol=1e-6)


def test_finalize_tonemap_range(cornell):
    cam = make_camera(width=16, height=16)
    cfg = RenderConfig(width=16, height=16, spp=2, integrator="pt_nee",
                       samples_per_call=2)
    st = render(cornell, cam, cfg)
    img = finalize_image(st, cfg)
    assert img.dtype == np.uint8
    # Reinhard maps to [0, 1): 255 only if mean radiance is enormous
    assert img.min() >= 0


def test_sample_batch_bit_identical(cornell):
    """cfg.sample_batch traces S samples' rays as one batch but must
    reproduce the S=1 image BIT-exactly: per-sample radiance is keyed on
    the absolute sample index and the accumulation updates stay sequential
    (render/renderer.group_of)."""
    import dataclasses

    cam = make_camera(width=16, height=16)
    cfg1 = RenderConfig(width=16, height=16, spp=5, integrator="pt_nee",
                        samples_per_call=5)
    a = render(cornell, cam, cfg1, seed=11)
    cfg4 = dataclasses.replace(cfg1, sample_batch=4)  # 1 group of 4 + 1 tail
    b = render(cornell, cam, cfg4, seed=11)
    np.testing.assert_array_equal(np.asarray(a.img.x), np.asarray(b.img.x))
    np.testing.assert_array_equal(np.asarray(a.img.y), np.asarray(b.img.y))
    np.testing.assert_array_equal(np.asarray(a.img.z), np.asarray(b.img.z))
    assert int(b.n) == 5


def test_tile_size_vis_bit_identical(cornell):
    """cfg.tile_size_vis retiles ONLY the visibility traces (BDPT's 4R
    connection batch, vis_band > 0). Packet results are grouping-invariant
    (the U bound + fallback make hits exact under any tiling), so the
    rendered image must be BIT-identical to the shared-tile-size run."""
    import dataclasses

    cam = make_camera(width=16, height=16)
    cfg1 = RenderConfig(width=16, height=16, spp=3, integrator="bdpt",
                        samples_per_call=3)
    a = render(cornell, cam, cfg1, seed=7)
    cfg2 = dataclasses.replace(cfg1, tile_size_vis=64)
    b = render(cornell, cam, cfg2, seed=7)
    np.testing.assert_array_equal(np.asarray(a.img.x), np.asarray(b.img.x))
    np.testing.assert_array_equal(np.asarray(a.img.y), np.asarray(b.img.y))
    np.testing.assert_array_equal(np.asarray(a.img.z), np.asarray(b.img.z))
