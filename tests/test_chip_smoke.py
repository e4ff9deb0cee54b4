"""chip_smoke.py on the CPU: it refuses to run without a GPU, and its
phases run end to end at tiny sizes (the card runs them at full size)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


def _run_smoke(cwd, pythonpath):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=pythonpath)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def _said_ok(out):
    return any(line.startswith('{"ok"') for line in out.splitlines())


def test_refuses_cpu_platform():
    r = _run_smoke(REPO, REPO)
    assert r.returncode != 0
    assert not _said_ok(r.stdout)
    assert "no GPU" in r.stderr


def test_refuses_without_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), "")
    assert r.returncode != 0
    assert not _said_ok(r.stdout)


@pytest.mark.parametrize("phase", ["pt_nee", "bdpt", "train", "scale"])
def test_phase_runs_tiny(phase, capsys):
    runs = {
        "pt_nee": lambda: chip_smoke.phase_pt_nee(
            size=32, spp=1, subdiv=1, brute_size=16, cornell_size=32),
        "bdpt": lambda: chip_smoke.phase_bdpt(
            size=32, spp=1, subdiv=1, brute_size=16, cornell_size=32),
        "train": lambda: chip_smoke.phase_train(
            size=16, steps=3, ref_size=16, subdiv=1, edge_samples=8),
        "scale": lambda: chip_smoke.phase_scale(
            subdiv=1, size=32, subset=256),
    }
    with jax.default_matmul_precision("highest"):
        runs[phase]()
    out = capsys.readouterr().out
    assert "native builder" in out
    if phase == "train":
        assert "vs CPU" in out


def test_check_raises_on_failure():
    with pytest.raises(chip_smoke.SmokeFailure, match="boom"):
        chip_smoke.check(False, "boom")


def test_compare_hits_flags_disagreement():
    import jax.numpy as jnp

    from cudapathtracer.ops.traversal import Hit

    a = Hit(tri=jnp.array([0, 1, 2, 3]), t=jnp.array([1.0, 2.0, 3.0, 4.0]))
    chip_smoke.compare_hits(a, a, "same")
    b = Hit(tri=jnp.array([0, 1, 2, 5]), t=jnp.array([1.0, 2.0, 3.0, 4.0]))
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_hits(a, b, "one of four differs")
    c = Hit(tri=a.tri, t=a.t * (1.0 + 1e-4))
    with pytest.raises(chip_smoke.SmokeFailure):
        chip_smoke.compare_hits(a, c, "t off by 1e-4")
