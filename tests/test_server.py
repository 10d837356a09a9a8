"""Resident server smoke test: start `fastp_tpu serve`, run jobs through
the thin client, byte-compare against the golden, shut down cleanly
(fastp_tpu/server.py, client.py)."""
import os
import subprocess
import sys
import time

import pytest

from test_parity import R1, GOLDEN, ROOT, normalize_json

pytestmark = pytest.mark.skipif(not os.path.exists(R1),
                                reason="reference testdata not available")


def test_server_round_trip(tmp_path):
    sock = str(tmp_path / "s.sock")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    srv = subprocess.Popen(
        [sys.executable, "-m", "fastp_tpu", "serve", "--socket", sock],
        env=env, cwd=str(tmp_path), stdout=subprocess.PIPE, text=True)
    try:
        line = srv.stdout.readline()
        assert line.split()[::2] == ["READY", "cpu"], line
        cenv = dict(env, FASTP_TPU_SERVER=sock)
        for k in range(2):  # second job exercises the warm/memoized path
            d = tmp_path / ("job%d" % k)
            d.mkdir()
            r = subprocess.run(
                [sys.executable, "-m", "fastp_tpu", "-i", R1, "-o", "out.fq"],
                cwd=str(d), env=cenv, capture_output=True, text=True,
                timeout=600)
            assert r.returncode == 0, r.stderr[-2000:]
            with open(d / "out.fq", "rb") as f:
                got = f.read()
            with open(os.path.join(GOLDEN, "cfg1_se_default", "out.fq"), "rb") as f:
                assert got == f.read()
            with open(d / "fastp.json") as f:
                got_json = normalize_json(f.read())
            with open(os.path.join(GOLDEN, "cfg1_se_default", "fastp.json")) as f:
                assert got_json == normalize_json(f.read())
        # clean shutdown via the client protocol
        rc = subprocess.run(
            [sys.executable, "-c",
             "from fastp_tpu.client import shutdown_server; "
             "import sys; sys.exit(0 if shutdown_server(%r) else 1)" % sock],
            env=env, timeout=60)
        assert rc.returncode == 0
        srv.wait(timeout=30)
    finally:
        if srv.poll() is None:
            srv.kill()
