"""Instrumentation utilities (utils/profiling.py): the reference's timer /
watchdog / Mrays accounting analogues (SURVEY.md §5.1)."""

import time

import numpy as np

from cudapathtracer.utils.profiling import (
    RenderTimer,
    dump_visit_csv,
    mrays_per_sec,
)


def test_mrays_accounting_matches_reference_formula():
    # kernel.cu:757: rays = IMAGE_SIZE * NUM_SAMPLES * (NUM_BOUNCES+1)
    assert mrays_per_sec(512 * 512, 100, 3, 1.0) == \
        512 * 512 * 100 * 4 / 1e6


def test_render_timer_watchdog_fires():
    warnings = []
    t = RenderTimer(slow_threshold_s=0.01,
                    on_slow=warnings.append).start()
    time.sleep(0.03)
    t.lap("slow sample")
    t.lap("fast sample")
    assert len(warnings) == 1
    assert "slow sample" in warnings[0]
    rep = t.report(64 * 64, 2, 3)
    assert rep["total_ms"] > 0
    assert rep["mrays_per_sec"] > 0


def test_dump_visit_csv(tmp_path):
    p = tmp_path / "out.csv"
    dump_visit_csv(str(p), np.array([3, 0, 7], np.int32))
    lines = p.read_text().strip().splitlines()
    # trailing comma per line — the reference's exact out.csv shape
    # (kernel.cu:746-749)
    assert lines == ["3,", "0,", "7,"]


def test_device_health_snapshot():
    from cudapathtracer.utils.profiling import device_health

    h = device_health()
    assert "device" in h and h["platform"] in ("cpu", "gpu")
    # temperature comes from nvidia-smi on a GPU; the key must exist
    # everywhere so callers can rely on the schema (None = not readable)
    assert "temperature_c" in h


def test_health_watchdog_pauses_and_resumes():
    from cudapathtracer.utils.profiling import HealthWatchdog

    calls = {"n": 0}

    def gate(health):
        calls["n"] += 1
        return calls["n"] <= 2  # pause for two polls, then clear

    msgs = []
    w = HealthWatchdog(should_pause=gate, poll_s=0.01, on_pause=msgs.append)
    assert w.check() is True
    assert msgs == ["render paused: device health gate", "render resumed"]
    # disabled by default, like the reference's commented-out loop
    assert HealthWatchdog().check() is False
