"""2-process jax.distributed run: per-host input byte-range shards,
per-shard outputs, gathered stats -> ONE merged JSON equal to the
single-process golden (fastp_tpu/parallel/multihost.py).
"""
import os
import socket
import subprocess
import sys

import pytest

from test_parity import (R1, R2, GOLDEN, ROOT, normalize_json)

pytestmark = pytest.mark.skipif(not os.path.exists(R1),
                                reason="reference testdata not available")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _launch(tmpdir, args, port, pid, nprocs):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["FASTP_TPU_FS_EXCHANGE"] = "1"  # same machine => shared FS
    env["JAX_COORDINATOR_ADDRESS"] = "127.0.0.1:%d" % port
    env["JAX_NUM_PROCESSES"] = str(nprocs)
    env["JAX_PROCESS_ID"] = str(pid)
    cmd = [sys.executable, "-m", "fastp_tpu"] + args
    return subprocess.Popen(cmd, cwd=str(tmpdir), env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_two_process_pe(tmp_path):
    port = _free_port()
    args = ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq"]
    procs = [_launch(tmp_path, args, port, k, 2) for k in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err.decode(errors="replace")[-4000:]

    gdir = os.path.join(GOLDEN, "cfg2_pe_default")
    for out in ("out1.fq", "out2.fq"):
        got = b""
        for k in (1, 2):
            shard = os.path.join(str(tmp_path), "%04d.%s" % (k, out))
            assert os.path.exists(shard), "missing shard %s" % shard
            with open(shard, "rb") as f:
                got += f.read()
        with open(os.path.join(gdir, out), "rb") as f:
            want = f.read()
        assert got == want, "concatenated shards differ from golden %s" % out

    with open(os.path.join(str(tmp_path), "fastp.json")) as f:
        got_json = f.read()
    with open(os.path.join(gdir, "fastp.json")) as f:
        want_json = f.read()

    # the exact cross-shard dedup exchange makes the duplication rate
    # byte-identical to the single-process run, so no normalization
    assert normalize_json(got_json) == normalize_json(want_json)


def test_two_process_gzip_input(tmp_path):
    """Gzipped single-file inputs shard by record ranges (each process
    streams the gz and skips to its contiguous range); concatenated shard
    outputs and the merged report must match the single-process run."""
    import gzip
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", "2500", "--seed", "13",
                    "--out1", str(tmp_path / "R1.fq"),
                    "--out2", str(tmp_path / "R2.fq")],
                   check=True, capture_output=True)
    for name in ("R1.fq", "R2.fq"):
        with open(tmp_path / name, "rb") as f:
            with gzip.open(tmp_path / (name + ".gz"), "wb",
                           compresslevel=4) as g:
                g.write(f.read())
    args = ["-i", str(tmp_path / "R1.fq.gz"),
            "-I", str(tmp_path / "R2.fq.gz"),
            "-o", "out1.fq", "-O", "out2.fq"]

    sdir = tmp_path / "single"
    sdir.mkdir()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, "-m", "fastp_tpu"] + args,
                   cwd=str(sdir), env=env, check=True, capture_output=True)

    mdir = tmp_path / "multi"
    mdir.mkdir()
    port = _free_port()
    procs = [_launch(mdir, args, port, k, 2) for k in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err.decode(errors="replace")[-4000:]

    for out in ("out1.fq", "out2.fq"):
        got = b""
        for k in (1, 2):
            with open(mdir / ("%04d.%s" % (k, out)), "rb") as f:
                got += f.read()
        with open(sdir / out, "rb") as f:
            want = f.read()
        assert got == want, "gz-sharded output differs from single-process %s" % out

    with open(mdir / "fastp.json") as f:
        got_json = f.read()
    with open(sdir / "fastp.json") as f:
        want_json = f.read()
    assert normalize_json(got_json) == normalize_json(want_json)


def test_two_process_dedup_cross_shard(tmp_path):
    """--dedup with duplicates straddling the shard boundary must
    byte-match the single-process run (exact_dedup_verdicts)."""
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", "3000", "--dup-rate", "0.2", "--seed", "11",
                    "--out1", str(tmp_path / "R1.fq"),
                    "--out2", str(tmp_path / "R2.fq")],
                   check=True, capture_output=True)
    args = ["-i", str(tmp_path / "R1.fq"), "-I", str(tmp_path / "R2.fq"),
            "-o", "out1.fq", "-O", "out2.fq", "--dedup"]

    # single-process golden
    sdir = tmp_path / "single"
    sdir.mkdir()
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    subprocess.run([sys.executable, "-m", "fastp_tpu"] + args,
                   cwd=str(sdir), env=env, check=True, capture_output=True)

    mdir = tmp_path / "multi"
    mdir.mkdir()
    port = _free_port()
    procs = [_launch(mdir, args, port, k, 2) for k in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=900)
        assert p.returncode == 0, err.decode(errors="replace")[-4000:]

    for out in ("out1.fq", "out2.fq"):
        got = b""
        for k in (1, 2):
            with open(mdir / ("%04d.%s" % (k, out)), "rb") as f:
                got += f.read()
        with open(sdir / out, "rb") as f:
            want = f.read()
        assert got == want, "dedup output differs from single-process %s" % out

    with open(mdir / "fastp.json") as f:
        got_json = f.read()
    with open(sdir / "fastp.json") as f:
        want_json = f.read()
    assert normalize_json(got_json) == normalize_json(want_json)
