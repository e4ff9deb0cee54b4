import os
import subprocess
import sys

import numpy as np
import jax
import pytest

from cudapathtracer import RenderConfig, make_camera, render
from cudapathtracer.models import procedural
from cudapathtracer.utils.checkpoint import load_checkpoint, save_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cornell():
    return procedural.to_scene(procedural.cornell_box())


def test_checkpoint_roundtrip_resume(cornell, tmp_path):
    cam = make_camera(width=16, height=16)
    cfg5 = RenderConfig(width=16, height=16, spp=5, integrator="pt_nee",
                        samples_per_call=5)
    full = render(cornell, cam, cfg5, seed=3)

    cfg2 = RenderConfig(width=16, height=16, spp=2, integrator="pt_nee",
                        samples_per_call=2)
    part = render(cornell, cam, cfg2, seed=3)
    p = tmp_path / "ck.npz"
    save_checkpoint(p, part, seed=3, cfg=cfg2)
    loaded, seed = load_checkpoint(p, cfg2)
    assert seed == 3
    assert int(loaded.n) == 2

    resumed = render(cornell, cam, cfg5, seed=3, state=loaded)
    np.testing.assert_array_equal(
        np.asarray(full.img.x), np.asarray(resumed.img.x)
    )


def test_checkpoint_validates_config(cornell, tmp_path):
    cam = make_camera(width=16, height=16)
    cfg = RenderConfig(width=16, height=16, spp=1, integrator="pt_nee",
                       samples_per_call=1)
    st = render(cornell, cam, cfg, seed=1)
    p = tmp_path / "ck.npz"
    save_checkpoint(p, st, seed=1, cfg=cfg)
    other = RenderConfig(width=32, height=32, spp=1, integrator="pt_nee")
    with pytest.raises(AssertionError):
        load_checkpoint(p, other)


def _run_cli(args, timeout=560):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = ""  # let conftest-less subprocess pick default
    code = (
        "import jax; jax.config.update('jax_platforms','cpu');"
        "from cudapathtracer.cli import main; main(%r)" % (args,)
    )
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=timeout, cwd=REPO)


def test_cli_render_and_heatmap(tmp_path):
    out = str(tmp_path / "img.ppm")
    r = _run_cli(["render", "--scene", "cornell", "--size", "16", "--spp",
                  "2", "--samples-per-call", "2", "--integrator", "pt_nee",
                  "-o", out])
    assert r.returncode == 0, r.stderr[-2000:]
    assert os.path.exists(out)
    from cudapathtracer.utils.ppm import read_ppm

    img = read_ppm(out)
    assert img.shape == (16, 16, 3)
    assert "Mrays/s" in r.stderr

    csv = str(tmp_path / "out.csv")
    fc = str(tmp_path / "bvh.png")
    r2 = _run_cli(["heatmap", "--scene", "cornell", "--size", "16",
                   "-o", csv, "--falsecolor", fc])
    assert r2.returncode == 0, r2.stderr[-2000:]
    lines = open(csv).read().strip().splitlines()
    assert len(lines) == 36  # cornell tri count
    assert all(line.endswith(",") for line in lines)
    # the BVH falsecolor render (the 'sponza bvh.ppm' keeper capability)
    from cudapathtracer.utils.png import read_png

    img2 = read_png(fc)
    assert img2.shape == (16, 16, 3)
    assert img2.max() > 0


def test_cli_checkpoint_resume(tmp_path):
    out = str(tmp_path / "img.ppm")
    ck = str(tmp_path / "ck.npz")
    r1 = _run_cli(["render", "--scene", "cornell", "--size", "16", "--spp",
                   "2", "--samples-per-call", "2", "--integrator", "pt_nee",
                   "--checkpoint", ck, "-o", out])
    assert r1.returncode == 0, r1.stderr[-2000:]
    r2 = _run_cli(["render", "--scene", "cornell", "--size", "16", "--spp",
                   "4", "--samples-per-call", "2", "--integrator", "pt_nee",
                   "--checkpoint", ck, "-o", out])
    assert r2.returncode == 0, r2.stderr[-2000:]
    assert "resumed from" in r2.stderr
    st, _ = load_checkpoint(ck)
    assert int(st.n) == 4
