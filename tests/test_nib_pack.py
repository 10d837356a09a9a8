"""4-bit input packing (native pack_nib + device _unpack_nib): byte parity
against the unpacked path on binned-quality data, exact host roundtrip
including exceptions, and clean fallback on >4 distinct qualities.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _native():
    from fastp_tpu.io import native
    if native.get_lib() is None:
        pytest.skip("native library unavailable")
    return native


def _synth(tmp_path, n=2000, **kw):
    out1 = str(tmp_path / "R1.fq")
    out2 = str(tmp_path / "R2.fq")
    args = [sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
            "--reads", str(n), "--out1", out1, "--out2", out2]
    for k, v in kw.items():
        args += ["--" + k.replace("_", "-"), str(v)]
    subprocess.run(args, check=True, capture_output=True)
    return out1, out2


def test_roundtrip_exact_with_exceptions(tmp_path):
    native = _native()
    r1, _ = _synth(tmp_path, n=1500, n_rate=0.01)  # N-rich: many exceptions
    from fastp_tpu.io.fastq import open_batch_reader
    b = open_batch_reader(r1).read_batch(1500, 160)
    qd = np.zeros(4, np.uint8)
    qn = np.zeros(1, np.int32)
    res = native.pack_nib(b.bases, b.quals, qd, qn)
    assert res is not None
    p, ei, eb, eq, n = res
    assert n > 0  # N bases must spill to the exception list
    W = b.width
    codes = np.stack([p & 15, p >> 4], -1).reshape(b.n, W).astype(np.int32)
    blut = np.frombuffer(b"ACGT", np.uint8)
    bb = blut[codes & 3]
    qq = qd[codes >> 2]
    m = np.arange(W)[None, :] < b.lengths[:, None]
    bb = np.where(m, bb, 0)
    qq = np.where(m, qq, 0)
    bb.reshape(-1)[ei[:n]] = eb[:n]
    qq.reshape(-1)[ei[:n]] = eq[:n]
    assert (bb == b.bases).all()
    assert (qq == b.quals).all()


def test_fallback_on_many_quals(tmp_path):
    native = _native()
    r1, _ = _synth(tmp_path, n=500, qual_bins="none")  # ~39 distinct quals
    from fastp_tpu.io.fastq import open_batch_reader
    b = open_batch_reader(r1).read_batch(500, 160)
    qd = np.zeros(4, np.uint8)
    qn = np.zeros(1, np.int32)
    assert native.pack_nib(b.bases, b.quals, qd, qn) is None


@pytest.mark.parametrize("seed,nqual,dirty", [
    (0, 1, 0.0), (1, 2, 0.0), (2, 3, 0.0), (3, 4, 0.0),
    (4, 4, 0.02), (5, 3, 0.005), (6, 2, 0.05), (7, 4, 0.0009),
])
def test_roundtrip_stress_vector_edges(seed, nqual, dirty):
    """Randomized decode(pack(x)) == x over the SIMD path's edge cases:
    partial dicts (nq 1-4), dict growth mid-stream (restart), exceptions
    scattered across and inside 32-position vector blocks, odd tails, and
    variable-length pad runs."""
    native = _native()
    rng = np.random.default_rng(seed)
    B, W = 257, 106  # odd sizes: exercises the scalar tail
    quals_pool = (np.array([35, 40, 51, 60], np.uint8))[:nqual]
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, W))
    # bias late: a rare qual value should first appear mid-stream so the
    # vector loop must fall back, learn, and restart with a bigger dict
    qidx = rng.integers(0, nqual, size=(B, W))
    if nqual > 1:
        first_half = np.arange(B * W).reshape(B, W) < (B * W // 3)
        qidx = np.where(first_half & (qidx == nqual - 1), 0, qidx)
    quals = quals_pool[qidx]
    if dirty:
        m = rng.random((B, W)) < dirty
        bases = np.where(m, np.uint8(ord("N")), bases)
        m2 = rng.random((B, W)) < dirty / 2
        quals = np.where(m2, np.uint8(2), quals)  # off-dict qual
    lengths = rng.integers(1, W + 1, size=B).astype(np.int32)
    mask = np.arange(W)[None, :] < lengths[:, None]
    bases = np.where(mask, bases, 0).astype(np.uint8)
    quals = np.where(mask, quals, 0).astype(np.uint8)
    qd = np.zeros(4, np.uint8)
    qn = np.zeros(1, np.int32)
    res = native.pack_nib(bases, quals, qd, qn)
    assert res is not None
    p, ei, eb, eq, n = res
    codes = np.stack([p & 15, p >> 4], -1).reshape(B, W).astype(np.int32)
    blut = np.frombuffer(b"ACGT", np.uint8)
    bb = np.where(mask, blut[codes & 3], 0).astype(np.uint8)
    qq = np.where(mask, qd[codes >> 2], 0).astype(np.uint8)
    bb.reshape(-1)[ei[:n]] = eb[:n]
    qq.reshape(-1)[ei[:n]] = eq[:n]
    assert (bb == bases).all(), "bases differ (seed=%d)" % seed
    assert (qq == quals).all(), "quals differ (seed=%d)" % seed


def _run_cli(args, cwd, extra_env=None):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if extra_env:
        env.update(extra_env)
    subprocess.run([sys.executable, "-m", "fastp_tpu"] + args, cwd=cwd,
                   env=env, check=True, capture_output=True)


def test_nib_byte_parity_full_pipeline(tmp_path):
    _native()
    r1, r2 = _synth(tmp_path, n=3000)
    base = ["-i", r1, "-I", r2, "--correction", "--cut_right",
            "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
            "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
    # FASTP_TPU_NO_P3 pins the first run to the nib path (the planar 3-bit
    # packer would otherwise win on this binned-quality data)
    _run_cli(base + ["-o", "nib1.fq", "-O", "nib2.fq", "-j", "nib.json",
                     "-h", "nib.html"], str(tmp_path),
             extra_env={"FASTP_TPU_NO_P3": "1"})
    _run_cli(base + ["-o", "ref1.fq", "-O", "ref2.fq", "-j", "ref.json",
                     "-h", "ref.html"], str(tmp_path),
             extra_env={"FASTP_TPU_NO_NIB": "1"})
    for a, b in (("nib1.fq", "ref1.fq"), ("nib2.fq", "ref2.fq")):
        with open(tmp_path / a, "rb") as f1, open(tmp_path / b, "rb") as f2:
            assert f1.read() == f2.read(), "%s differs" % a
    import re

    def norm(p):
        with open(tmp_path / p) as f:
            return re.sub(r'\t"command": ".*"', "C", f.read())

    assert norm("nib.json") == norm("ref.json")
