"""--local_processes N: the self-spawning same-host launcher
(cli.py:_spawn_local_shards).  The reference self-spawns worker threads
from -w N (src/peprocessor.cpp:750-754); here one parent invocation spawns
N record-range-sharded processes that merge into ONE report.  Unlike
test_multihost.py this needs no jax.distributed coordinator: the children
coordinate via FASTP_TPU_SHARD_INDEX/COUNT env and the same-host
filesystem exchange.
"""
import json
import os
import subprocess
import sys

import pytest

from test_parity import (R1, R2, GOLDEN, ROOT, normalize_json)

pytestmark = pytest.mark.skipif(not os.path.exists(R1),
                                reason="reference testdata not available")


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(tmpdir, args):
    return subprocess.run([sys.executable, "-m", "fastp_tpu"] + args,
                          cwd=str(tmpdir), env=_env(),
                          stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def test_local_processes_pe_golden(tmp_path):
    """ONE command with --local_processes 2: concatenated shard outputs and
    the merged JSON must equal the single-process golden."""
    r = _run(tmp_path, ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq",
                        "--local_processes", "2"])
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-4000:]

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
    assert normalize_json(got_json) == normalize_json(want_json)
    # shard logs are cleaned up on success
    assert not os.path.exists(str(tmp_path / ".fastp_shard_log.1"))


def test_local_processes_dedup_exact(tmp_path):
    """--dedup across 3 local processes (two filesystem-exchange rounds:
    the dedup pre-pass and the final stats merge) must byte-match the
    single-process run."""
    subprocess.run([sys.executable,
                    os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", "3000", "--dup-rate", "0.2", "--seed", "11",
                    "--out1", str(tmp_path / "R1.fq"),
                    "--out2", str(tmp_path / "R2.fq")],
                   check=True, capture_output=True)
    args = ["-i", str(tmp_path / "R1.fq"), "-I", str(tmp_path / "R2.fq"),
            "-o", "out1.fq", "-O", "out2.fq", "--dedup"]

    sdir = tmp_path / "single"
    sdir.mkdir()
    r = _run(sdir, args)
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-4000:]

    mdir = tmp_path / "multi"
    mdir.mkdir()
    r = _run(mdir, args + ["--local_processes", "3"])
    assert r.returncode == 0, r.stderr.decode(errors="replace")[-4000:]

    for out in ("out1.fq", "out2.fq"):
        got = b""
        for k in (1, 2, 3):
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


def test_local_processes_split_conflict(tmp_path):
    """--split + --local_processes is rejected up front (outputs are
    already sharded per process)."""
    r = _run(tmp_path, ["-i", R1, "-o", "out1.fq", "--split", "3",
                        "--local_processes", "2"])
    assert r.returncode != 0
    assert b"--local_processes" in r.stderr
