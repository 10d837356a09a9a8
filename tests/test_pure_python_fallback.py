"""FASTP_TPU_NO_NATIVE=1 (no C++ helpers) must stay byte-exact: covers the
record-based reader, Python serialization, BLAS dup hashing, and the
Python evaluator path."""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R1 = "/tmp/refbuild/testdata/R1.fq"
R2 = "/tmp/refbuild/testdata/R2.fq"

pytestmark = pytest.mark.skipif(not os.path.exists(R1),
                                reason="reference testdata not available")


def test_pure_python_pe(tmp_path):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["FASTP_TPU_NO_NATIVE"] = "1"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-m", "fastp_tpu", "-i", R1, "-I", R2,
         "-o", "o1.fq", "-O", "o2.fq", "--correction", "--cut_right"],
        cwd=str(tmp_path), env=env, capture_output=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-3000:]
    golden = open(os.path.join(ROOT, "tests", "golden",
                               "cfg3_pe_correction", "out1.fq"), "rb").read()
    assert (tmp_path / "o1.fq").read_bytes() == golden
