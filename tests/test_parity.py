"""End-to-end byte-parity tests against recorded reference fastp outputs.

Golden outputs in tests/golden/* were produced by the reference binary
(fastp v1.0.1, built with a zlib shim) on testdata/R1.fq + R2.fq with -w 1.
FASTQ outputs must match byte-for-byte; JSON must match after normalizing
the "command" line (argv differs between the two programs).
"""
import json
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden")
# reference testdata fixtures (vendored copy in tests/testdata; a local
# reference build's copy is preferred when present so both stay in sync)
R1 = "/tmp/refbuild/testdata/R1.fq"
R2 = "/tmp/refbuild/testdata/R2.fq"
if not os.path.exists(R1):
    R1 = os.path.join(ROOT, "tests", "testdata", "R1.fq")
    R2 = os.path.join(ROOT, "tests", "testdata", "R2.fq")

pytestmark = pytest.mark.skipif(not os.path.exists(R1),
                                reason="reference testdata not available")


def run_cli(tmpdir, args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    cmd = [sys.executable, "-m", "fastp_tpu"] + args
    res = subprocess.run(cmd, cwd=str(tmpdir), env=env,
                         capture_output=True, text=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-4000:]
    return res


def normalize_json(text: str) -> str:
    # drop the command line (argv differs) but keep everything else verbatim
    return re.sub(r'\t"command": ".*"', '\t"command": "X"', text)


def compare_dir(tmpdir, golden_name, files):
    gdir = os.path.join(GOLDEN, golden_name)
    for f in files:
        with open(os.path.join(gdir, f), "rb") as fh:
            want = fh.read()
        with open(os.path.join(str(tmpdir), f), "rb") as fh:
            got = fh.read()
        if f.endswith(".json"):
            assert normalize_json(got.decode()) == normalize_json(want.decode()), \
                "JSON mismatch in %s/%s" % (golden_name, f)
        else:
            assert got == want, "FASTQ mismatch in %s/%s" % (golden_name, f)


def test_cfg1_se_default(tmp_path):
    run_cli(tmp_path, ["-i", R1, "-o", "out.fq"])
    compare_dir(tmp_path, "cfg1_se_default", ["out.fq", "fastp.json"])


def test_cfg2_pe_default(tmp_path):
    run_cli(tmp_path, ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq"])
    compare_dir(tmp_path, "cfg2_pe_default", ["out1.fq", "out2.fq", "fastp.json"])


def test_cfg3_pe_correction(tmp_path):
    run_cli(tmp_path, ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq",
                       "--correction", "--cut_right"])
    compare_dir(tmp_path, "cfg3_pe_correction", ["out1.fq", "out2.fq", "fastp.json"])


def test_cfg4_novaseq(tmp_path):
    run_cli(tmp_path, ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq",
                       "--trim_poly_g", "--trim_poly_x", "--umi", "--umi_loc",
                       "read1", "--umi_len", "4", "--low_complexity_filter"])
    compare_dir(tmp_path, "cfg4_novaseq", ["out1.fq", "out2.fq", "fastp.json"])


def test_cfg5_merge(tmp_path):
    run_cli(tmp_path, ["-i", R1, "-I", R2, "--merge", "--merged_out", "merged.fq",
                       "--out1", "out1.fq", "--out2", "out2.fq", "--dedup",
                       "--dup_calc_accuracy", "1", "--overrepresentation_analysis"])
    compare_dir(tmp_path, "cfg5_merge",
                ["merged.fq", "out1.fq", "out2.fq", "fastp.json"])


def test_cfg6_failed_unpaired(tmp_path):
    run_cli(tmp_path, ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq",
                       "--failed_out", "failed.fq", "--unpaired1", "up1.fq",
                       "--unpaired2", "up2.fq", "-l", "100"])
    compare_dir(tmp_path, "cfg6_failed",
                ["out1.fq", "out2.fq", "failed.fq", "up1.fq", "up2.fq", "fastp.json"])


def test_cfg7_split_by_number(tmp_path):
    # file-boundary parity for --split (reference: src/threadconfig.cpp:127-147)
    run_cli(tmp_path, ["-i", R1, "-I", R2, "-o", "out1.fq", "-O", "out2.fq",
                       "-s", "3", "-w", "1"])
    compare_dir(tmp_path, "cfg7_split",
                ["0001.out1.fq", "0001.out2.fq", "0002.out1.fq",
                 "0002.out2.fq", "0003.out1.fq", "0003.out2.fq", "fastp.json"])


def test_cfg8_failed_with_cutting(tmp_path):
    # failed/unpaired/overlapped routing under correction + window cutting:
    # failed reads carry the processed window (reference mutates Reads in
    # place) and both-fail pairs emit nothing (src/peprocessor.cpp:551-577)
    run_cli(tmp_path, ["-i", R1, "-I", R2, "-o", "o1.fq", "-O", "o2.fq",
                       "--correction", "--cut_right", "--failed_out", "failed.fq",
                       "--unpaired1", "up1.fq", "--overlapped_out", "ov.fq",
                       "-l", "100"])
    compare_dir(tmp_path, "cfg8_failed_cut",
                ["o1.fq", "o2.fq", "failed.fq", "up1.fq", "ov.fq", "fastp.json"])
