"""Instrumentation: timing, throughput, watchdog, traversal heatmaps.

JAX equivalents of the reference's three mechanisms (SURVEY.md §5.1):

* cudaEvent render-loop timer + Mrays/s report (kernel.cu:704-757)
  -> ``RenderTimer`` (wall clock around block_until_ready'd batches) with
  the reference's ray-accounting formula.
* per-sample >0.5 s watchdog (kernel.cu:712-723) -> ``RenderTimer.lap``
  warns through ``on_slow``.
* per-triangle BVH leaf-visit histogram dumped to out.csv
  (kernel.cu:133, 742-750) -> ``ops.traversal.trace(with_stats=True)``
  already returns the histogram; ``dump_visit_csv`` writes the same
  one-value-per-line CSV.

For deep profiles use ``jax.profiler.trace`` around a render batch and
inspect with TensorBoard/XProf — exposed here as ``profile_trace``.
"""

from __future__ import annotations

import contextlib
import time

import numpy as np


def mrays_per_sec(num_pixels: int, spp: int, bounces: int, seconds: float):
    """The reference's accounting: rays = pixels * spp * (bounces+1)
    (kernel.cu:757)."""
    return num_pixels * spp * (bounces + 1) / seconds / 1e6


class RenderTimer:
    """Wall-clock timing of progressive batches with a slow-lap watchdog."""

    def __init__(self, slow_threshold_s: float = 0.5, on_slow=None):
        self.slow_threshold_s = slow_threshold_s
        self.on_slow = on_slow or (lambda msg: print(msg))
        self.laps = []
        self._t0 = None
        self._start = None

    def start(self):
        self._start = self._t0 = time.perf_counter()
        return self

    def lap(self, label=""):
        t = time.perf_counter()
        dt = t - self._t0
        self._t0 = t
        self.laps.append(dt)
        if dt > self.slow_threshold_s:
            # kernel.cu:722-723 wording kept recognizable
            self.on_slow(
                f"-----Possible too long execution of {dt:f} seconds----- "
                f"{label}"
            )
        return dt

    @property
    def total(self):
        return time.perf_counter() - self._start

    def report(self, num_pixels: int, spp: int, bounces: int):
        """The reference's end-of-render block (kernel.cu:752-757)."""
        ms = self.total * 1000.0
        return {
            "total_ms": ms,
            "ms_per_loop": ms / max(1, len(self.laps)),
            "mrays_per_sec": mrays_per_sec(num_pixels, spp, bounces,
                                           self.total),
        }


def dump_visit_csv(path, tri_visits):
    """Per-triangle visit counts, one per line with trailing comma — the
    exact out.csv shape the reference emits (kernel.cu:746-749)."""
    v = np.asarray(tri_visits)
    with open(path, "w") as f:
        for x in v:
            f.write(f"{int(x)},\n")


@contextlib.contextmanager
def profile_trace(logdir):
    """jax.profiler capture around a block (view with xprof/tensorboard)."""
    import jax

    jax.profiler.start_trace(str(logdir))
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def nvidia_smi_query(fields: str):
    """One ``nvidia-smi --query-gpu=<fields>`` line per card (csv, no
    header, units kept), or None where nvidia-smi is missing or fails."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={fields}",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    if out.returncode != 0:
        return None
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


def device_health():
    """Device-health snapshot — the getGPUTemp analogue (kernel.cu:555-563).

    The reference polls NVML for GPU temperature and carries a (disabled)
    pause-above-60°C loop (kernel.cu:725-732). Here: device identity, live
    device-memory usage via jax's memory_stats(), and on a GPU the first
    card's temperature as nvidia-smi reports it. Returns a dict; values are
    None where the backend or the machine does not expose them.
    """
    import jax

    dev = jax.devices()[0]
    stats = None
    try:
        stats = dev.memory_stats()
    except Exception:
        pass
    out = {
        "device": str(dev),
        "platform": dev.platform,
        "temperature_c": None,
        "hbm_bytes_in_use": None,
        "hbm_bytes_limit": None,
    }
    if dev.platform == "gpu":
        temps = nvidia_smi_query("temperature.gpu")
        if temps:
            try:
                out["temperature_c"] = float(temps[0])
            except ValueError:
                pass
    if stats:
        out["hbm_bytes_in_use"] = stats.get("bytes_in_use")
        out["hbm_bytes_limit"] = stats.get("bytes_limit")
    return out


class HealthWatchdog:
    """The reference's thermal-throttle loop shape (kernel.cu:725-732),
    generalized and OFF by default — exactly like the reference, whose loop
    is commented out. ``check`` pauses while ``should_pause(health)`` holds
    (e.g. HBM pressure), polling every ``poll_s`` seconds."""

    def __init__(self, should_pause=None, poll_s: float = 5.0,
                 on_pause=None, max_wait_s: float = 300.0):
        self.should_pause = should_pause  # None = disabled (reference dflt)
        self.poll_s = poll_s
        self.on_pause = on_pause or (lambda msg: print(msg))
        self.max_wait_s = max_wait_s

    def check(self):
        if self.should_pause is None:
            return False
        waited = 0.0
        paused = False
        while self.should_pause(device_health()) and waited < self.max_wait_s:
            if not paused:
                self.on_pause("render paused: device health gate")
                paused = True
            time.sleep(self.poll_s)
            waited += self.poll_s
        if paused:
            self.on_pause("render resumed")
        return paused


def falsecolor_state(scene, bvh, cam, cfg, seed: int = 1234):
    """Per-pixel traversal-cost falsecolor as an AccumState — the library
    form of the reference's 'sponza bvh.ppm' keeper mode (cli.py heatmap
    --falsecolor uses this; tests/test_goldens.py blesses it).

    Red channel = normalized per-ray BVH node visits (costly = red),
    green = inverse — one primary-ray trace with stats, deterministic for
    a fixed (scene, camera, seed).
    """
    import jax
    import jax.numpy as jnp

    from ..accel.bvh import as_fine
    from ..ops import traversal
    from ..ops.rng import pixel_keys, sample_key
    from ..ops.vecmath import Vec3
    from ..render.camera import camera_rays
    from ..render.renderer import AccumState

    td = traversal.make_trace_data(scene, as_fine(bvh))
    idx = jnp.arange(cfg.num_pixels, dtype=jnp.uint32)
    keys = pixel_keys(sample_key(jax.random.PRNGKey(seed), 0), idx)
    o, d = camera_rays(cam, idx, keys)
    _, stats = traversal.trace(o, d, td, with_stats=True)
    v = stats.ray_visits.astype(jnp.float32)
    v = v / jnp.maximum(1.0, jnp.max(v))
    z = jnp.zeros_like(v)
    return AccumState(
        img=Vec3(v * 4.0, 1.0 - v, z),  # red = costly
        comp=Vec3(z, z, z),
        n=jnp.ones((), jnp.int32),
    ), stats
