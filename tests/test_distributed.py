"""Two-process jax.distributed test (SURVEY.md §5.8 multi-host plan).

Exercises the REAL multi-process init path a multi-host run uses —
``parallel.mesh.initialize_distributed`` (jax.distributed over localhost
gRPC), a global 8-device mesh spanning 2 processes of
4 virtual CPU devices each, and a sharded render whose per-process
addressable shards must match a single-device reference. Complements
tests/test_parallel.py, which runs the same sharding single-process.
"""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_distributed_render():
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    worker = os.path.join(HERE, "distributed_worker.py")

    import tempfile

    ckdir = tempfile.mkdtemp(prefix="ckpt_dist_")
    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, "2", str(pid), ckdir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=900)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        pytest.fail("distributed workers timed out:\n" + "\n".join(outs))

    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {pid} failed (rc={p.returncode}):\n{out[-4000:]}"
        )
        assert f"OK process {pid}" in out, out[-2000:]
        assert "sharded checkpoint resume bit-exact" in out, out[-2000:]
        assert "cross-process grad psum parity" in out, out[-2000:]
