"""Parity on a synthetic 12k-pair corpus (generated deterministically),
covering adapter auto-detection (needs >=10000 records), overlap trimming,
correction, and insert-size statistics at realistic scale.

Golden outputs are produced on the fly by the reference binary if present
(built under /tmp/refbuild); otherwise these tests are skipped.
"""
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/tmp/refbuild/fastp"

pytestmark = [pytest.mark.slow, pytest.mark.skipif(not os.path.exists(REF),
                                reason="reference binary not available")]


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("synth")
    subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                    "--reads", "12000", "--out1", str(d / "R1.fq"),
                    "--out2", str(d / "R2.fq")], check=True)
    return d


def run_ref(workdir, args):
    subprocess.run([REF] + args + ["-w", "1"], cwd=str(workdir),
                   check=True, capture_output=True, timeout=600)


def run_mine(workdir, args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["JAX_PLATFORM_NAME"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", "fastp_tpu"] + args,
                         cwd=str(workdir), env=env, capture_output=True,
                         text=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-4000:]


def compare(refdir, mydir, files):
    import re
    for f in files:
        want = open(os.path.join(str(refdir), f), "rb").read()
        got = open(os.path.join(str(mydir), f), "rb").read()
        if f.endswith(".json"):
            norm = lambda t: re.sub(r'\t"command": ".*"', "C", t.decode())
            assert norm(got) == norm(want), "JSON mismatch: " + f
        else:
            assert got == want, "FASTQ mismatch: " + f


def test_synth_se_autodetect(corpus, tmp_path):
    ref = tmp_path / "ref"
    mine = tmp_path / "mine"
    ref.mkdir()
    mine.mkdir()
    args = ["-i", str(corpus / "R1.fq"), "-o", "out.fq"]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["out.fq", "fastp.json"])


def test_synth_pe_correction(corpus, tmp_path):
    ref = tmp_path / "ref"
    mine = tmp_path / "mine"
    ref.mkdir()
    mine.mkdir()
    args = ["-i", str(corpus / "R1.fq"), "-I", str(corpus / "R2.fq"),
            "-o", "out1.fq", "-O", "out2.fq", "--correction", "--cut_right",
            "--detect_adapter_for_pe"]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["out1.fq", "out2.fq", "fastp.json"])


def test_synth_pe_merge_routing(corpus, tmp_path):
    # exercises the native router's merged stream at scale
    ref = tmp_path / "ref"
    mine = tmp_path / "mine"
    ref.mkdir()
    mine.mkdir()
    args = ["-i", str(corpus / "R1.fq"), "-I", str(corpus / "R2.fq"),
            "--merge", "--merged_out", "merged.fq",
            "--out1", "out1.fq", "--out2", "out2.fq",
            "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
            "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["merged.fq", "out1.fq", "out2.fq", "fastp.json"])


def test_synth_pe_failed_unpaired_routing(corpus, tmp_path):
    # exercises the native router's failed/unpaired streams under cutting +
    # correction at scale (processed-window failed semantics)
    ref = tmp_path / "ref"
    mine = tmp_path / "mine"
    ref.mkdir()
    mine.mkdir()
    args = ["-i", str(corpus / "R1.fq"), "-I", str(corpus / "R2.fq"),
            "-o", "out1.fq", "-O", "out2.fq", "--correction", "--cut_right",
            "--failed_out", "failed.fq", "--unpaired1", "up1.fq",
            "--unpaired2", "up2.fq", "-l", "140",
            "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
            "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["out1.fq", "out2.fq", "failed.fq", "up1.fq",
                        "up2.fq", "fastp.json"])
