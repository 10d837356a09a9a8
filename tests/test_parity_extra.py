"""On-the-fly byte-parity vs the reference binary for features not in the
recorded-golden configs: overlapped_out, adapter FASTA lists, over-
representation analysis, phred64 input, index filtering, long reads."""
import os
import random
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = "/tmp/refbuild/fastp"
R1 = "/tmp/refbuild/testdata/R1.fq"
R2 = "/tmp/refbuild/testdata/R2.fq"

pytestmark = [pytest.mark.slow, pytest.mark.skipif(not os.path.exists(REF),
                                reason="reference binary not available")]


def run_ref(workdir, args):
    subprocess.run([REF] + args + ["-w", "1"], cwd=str(workdir), check=True,
                   capture_output=True, timeout=600)


def run_mine(workdir, args):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-m", "fastp_tpu"] + args,
                         cwd=str(workdir), env=env, capture_output=True,
                         text=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-3000:]


def compare(ref, mine, files):
    import re
    for f in files:
        want = open(os.path.join(str(ref), f), "rb").read()
        got = open(os.path.join(str(mine), f), "rb").read()
        if f.endswith(".json"):
            norm = lambda t: re.sub(r'\t"command": ".*"', "C", t.decode())
            assert norm(got) == norm(want), "JSON mismatch: " + f
        else:
            assert got == want, "FASTQ mismatch: " + f


def _two_dirs(tmp_path):
    a = tmp_path / "ref"
    b = tmp_path / "mine"
    a.mkdir()
    b.mkdir()
    return a, b


def test_overlapped_out(tmp_path):
    ref, mine = _two_dirs(tmp_path)
    args = ["-i", R1, "-I", R2, "-o", "o1.fq", "-O", "o2.fq",
            "--overlapped_out", "ov.fq"]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["o1.fq", "o2.fq", "ov.fq", "fastp.json"])


def test_adapter_fasta(tmp_path):
    fa = tmp_path / "ad.fa"
    fa.write_text(">a1\nAGATCGGAAGAGC\n>a2\nAAATTTCCCGGGAAATTTCCCGGG\n")
    ref, mine = _two_dirs(tmp_path)
    args = ["-i", R1, "-o", "out.fq", "--adapter_fasta", str(fa)]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["out.fq", "fastp.json"])


def test_overrepresentation(tmp_path):
    ref, mine = _two_dirs(tmp_path)
    args = ["-i", R1, "-I", R2, "-o", "o1.fq", "-O", "o2.fq", "-p",
            "-P", "1"]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["o1.fq", "o2.fq", "fastp.json"])


def test_phred64(tmp_path):
    # build a phred64 copy of R1
    src = open(R1, "rb").read().splitlines()
    out = []
    i = 0
    while i + 3 < len(src) or (i + 3 == len(src) - 0 and len(src) - i >= 4):
        if i + 3 >= len(src):
            break
        name, seq, strand, qual = src[i:i + 4]
        if not name.startswith(b"@"):
            i += 1
            continue
        q64 = bytes(min(c + 31, 255) for c in qual)
        out += [name, seq, strand, q64]
        i += 4
    p64 = tmp_path / "r1_p64.fq"
    p64.write_bytes(b"\n".join(out) + b"\n")
    ref, mine = _two_dirs(tmp_path)
    args = ["-i", str(p64), "-o", "out.fq", "--phred64"]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["out.fq", "fastp.json"])


def test_index_filter(tmp_path):
    bl = tmp_path / "blacklist.txt"
    bl.write_text("TATAGCCT\n")
    ref, mine = _two_dirs(tmp_path)
    args = ["-i", R1, "-o", "out.fq", "--filter_by_index1", str(bl)]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["out.fq", "fastp.json"])


def test_long_reads(tmp_path):
    rng = random.Random(11)
    recs = []
    for i in range(300):
        n = rng.randint(600, 1400)
        seq = "".join(rng.choice("ACGT") for _ in range(n))
        qual = "".join(chr(rng.randint(35, 70)) for _ in range(n))
        recs.append("@long%d\n%s\n+\n%s\n" % (i, seq, qual))
    lr = tmp_path / "long.fq"
    lr.write_text("".join(recs))
    ref, mine = _two_dirs(tmp_path)
    args = ["-i", str(lr), "-o", "out.fq"]
    run_ref(ref, args)
    run_mine(mine, args)
    compare(ref, mine, ["out.fq", "fastp.json"])
