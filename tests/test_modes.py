"""I/O-mode coverage: split output, interleaved input, stdin/stdout, and
the folder batch driver.  Invariant-based (content conservation) plus
reference comparison where the reference binary defines the behavior
independently of threading (interleaved)."""
import glob
import gzip
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R1 = "/tmp/refbuild/testdata/R1.fq"
R2 = "/tmp/refbuild/testdata/R2.fq"

pytestmark = pytest.mark.skipif(not os.path.exists(R1),
                                reason="reference testdata not available")


def run_cli(workdir, args, stdin_data=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", "fastp_tpu"] + args,
                         cwd=str(workdir), env=env, input=stdin_data,
                         capture_output=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


def test_split_by_file_number(tmp_path):
    run_cli(tmp_path, ["-i", R1, "-o", "out.fq", "-s", "3"])
    parts = sorted(glob.glob(str(tmp_path / "0*.out.fq")))
    assert len(parts) == 3, parts
    joined = b"".join(open(p, "rb").read() for p in parts)
    # content conservation vs the unsplit golden
    golden = open(os.path.join(ROOT, "tests", "golden",
                               "cfg1_se_default", "out.fq"), "rb").read()
    assert sorted(joined.split(b"\n")) == sorted(golden.split(b"\n"))


def test_interleaved_matches_paired(tmp_path):
    # build an interleaved file from R1/R2
    def records(path):
        lines = open(path, "rb").read().splitlines()
        recs, i = [], 0
        while i < len(lines):
            if lines[i][:1] == b"@" and i + 3 < len(lines):
                recs.append(b"\n".join(lines[i:i + 4]) + b"\n")
                i += 4
            else:
                i += 1
        return recs
    rec1 = records(R1)
    rec2 = records(R2)
    n = min(len(rec1), len(rec2))
    inter = tmp_path / "inter.fq"
    with open(inter, "wb") as f:
        for a, b in zip(rec1[:n], rec2[:n]):
            f.write(a)
            f.write(b)
    d1 = tmp_path / "plain"
    d2 = tmp_path / "inter_run"
    d1.mkdir()
    d2.mkdir()
    run_cli(d1, ["-i", R1, "-I", R2, "-o", "o1.fq", "-O", "o2.fq"])
    run_cli(d2, ["--interleaved_in", "-i", str(inter),
                 "-o", "o1.fq", "-O", "o2.fq"])
    assert (d1 / "o1.fq").read_bytes() == (d2 / "o1.fq").read_bytes()
    assert (d1 / "o2.fq").read_bytes() == (d2 / "o2.fq").read_bytes()


def test_stdin_stdout(tmp_path):
    data = open(R1, "rb").read()
    res = run_cli(tmp_path, ["--stdin", "--stdout"], stdin_data=data)
    golden = open(os.path.join(ROOT, "tests", "golden",
                               "cfg1_se_default", "out.fq"), "rb").read()
    assert res.stdout == golden


def test_gzip_input(tmp_path):
    import gzip as gz
    for src, dst in ((R1, "R1.fq.gz"), (R2, "R2.fq.gz")):
        with gz.open(tmp_path / dst, "wb") as f:
            f.write(open(src, "rb").read())
    run_cli(tmp_path, ["-i", "R1.fq.gz", "-I", "R2.fq.gz",
                       "-o", "o1.fq", "-O", "o2.fq",
                       "--correction", "--cut_right"])
    golden = open(os.path.join(ROOT, "tests", "golden",
                               "cfg3_pe_correction", "out1.fq"), "rb").read()
    assert (tmp_path / "o1.fq").read_bytes() == golden


def test_batch_driver(tmp_path):
    indir = tmp_path / "in"
    indir.mkdir()
    import shutil
    shutil.copy(R1, indir / "samp_R1.fastq")
    shutil.copy(R2, indir / "samp_R2.fastq")
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "fastp_tpu.batch", "-i", str(indir),
         "-o", str(tmp_path / "out"), "-r", str(tmp_path / "rep")],
        env=env, capture_output=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-3000:]
    assert (tmp_path / "out" / "samp_R1.clean.fastq.gz").exists()
    assert (tmp_path / "rep" / "overall.html").exists()
    assert (tmp_path / "rep" / "samp_pe.fastq.json").exists()
    # gz outputs decode to the paired-run golden
    got = gzip.open(tmp_path / "out" / "samp_R1.clean.fastq.gz").read()
    golden = open(os.path.join(ROOT, "tests", "golden",
                               "cfg2_pe_default", "out1.fq"), "rb").read()
    assert got == golden


def test_index_filter_native_matches_python(tmp_path):
    # native index_filter (route_native.cpp) vs the per-name Python path
    import subprocess, sys, os
    from test_parity import R1, R2, ROOT
    idx = tmp_path / "bl.txt"
    idx.write_text("TATAGCCT\n")
    outs = {}
    for tag, extra_env in (("native", {}), ("python", {"FASTP_TPU_NO_NATIVE": "1"})):
        d = tmp_path / tag
        d.mkdir()
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   JAX_PLATFORM_NAME="cpu",
                   PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""),
                   **extra_env)
        r = subprocess.run(
            [sys.executable, "-m", "fastp_tpu", "-i", R1, "-I", R2,
             "-o", "o1.fq", "-O", "o2.fq",
             "--filter_by_index1", str(idx), "--filter_by_index_threshold", "1"],
            cwd=str(d), env=env, capture_output=True, text=True, timeout=600)
        assert r.returncode == 0, r.stderr[-2000:]
        outs[tag] = ((d / "o1.fq").read_bytes(), (d / "o2.fq").read_bytes())
    assert outs["native"] == outs["python"]
