"""Planar 3-bit input packing (native pack_p3 + device _unpack_p3): exact
host roundtrip including exceptions, frequency-based dictionary learning (a
rare early third qual must not steal a dict slot), clean fallback on
many-qual data, and full-pipeline byte parity against the unpacked path.
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


def _decode(bp, qp, qd, B, W, lengths, ei, eb, eq, n):
    codes = np.stack([(bp >> (2 * k)) & 3 for k in range(4)],
                     -1).reshape(B, W).astype(np.int32)
    blut = np.frombuffer(b"ACGT", np.uint8)
    qbits = np.stack([(qp >> k) & 1 for k in range(8)],
                     -1).reshape(B, W).astype(np.int32)
    m = np.arange(W)[None, :] < lengths[:, None]
    bb = np.where(m, blut[codes], 0).astype(np.uint8)
    qq = np.where(m, qd[qbits], 0).astype(np.uint8)
    bb.reshape(-1)[ei[:n]] = eb[:n]
    qq.reshape(-1)[ei[:n]] = eq[:n]
    return bb, qq


def test_roundtrip_exact_with_exceptions(tmp_path):
    native = _native()
    r1, _ = _synth(tmp_path, n=1500, n_rate=0.01)  # N-rich: many exceptions
    from fastp_tpu.io.fastq import open_batch_reader
    b = open_batch_reader(r1).read_batch(1500, 160)
    qd = np.zeros(2, np.uint8)
    qn = np.zeros(1, np.int32)
    res = native.pack_p3(b.bases, b.quals, qd, qn)
    assert res is not None
    bp, qp, ei, eb, eq, n = res
    assert n > 0  # N bases and off-dict quals must spill to exceptions
    bb, qq = _decode(bp, qp, qd, b.n, b.width, b.lengths, ei, eb, eq, n)
    assert (bb == b.bases).all()
    assert (qq == b.quals).all()


def test_dict_learned_by_frequency():
    """A rare qual value occurring FIRST must not win a dict slot: the
    dictionary is the top-2 by count of the first batch (unlike nib's
    first-come learning, where 4 slots make order irrelevant)."""
    native = _native()
    B, W = 64, 64
    bases = np.full((B, W), ord("A"), np.uint8)
    quals = np.full((B, W), 70, np.uint8)          # 'F' dominant
    quals[:, 1::3] = 56                            # '8' second
    quals[0, 0] = 35                               # rare '#' FIRST position
    qd = np.zeros(2, np.uint8)
    qn = np.zeros(1, np.int32)
    res = native.pack_p3(bases, quals, qd, qn)
    assert res is not None
    assert set(qd.tolist()) == {70, 56}
    bp, qp, ei, eb, eq, n = res
    assert n == 1  # only the single '#' is an exception
    lengths = np.full(B, W, np.int32)
    bb, qq = _decode(bp, qp, qd, B, W, lengths, ei, eb, eq, n)
    assert (bb == bases).all() and (qq == quals).all()


def test_fallback_on_many_quals(tmp_path):
    native = _native()
    r1, _ = _synth(tmp_path, n=500, qual_bins="none")  # ~39 distinct quals
    from fastp_tpu.io.fastq import open_batch_reader
    b = open_batch_reader(r1).read_batch(500, 160)
    qd = np.zeros(2, np.uint8)
    qn = np.zeros(1, np.int32)
    assert native.pack_p3(b.bases, b.quals, qd, qn) is None


@pytest.mark.parametrize("seed,nqual,dirty", [
    (0, 1, 0.0), (1, 2, 0.0), (2, 2, 0.02), (3, 1, 0.05), (4, 2, 0.0009),
])
def test_roundtrip_stress_vector_edges(seed, nqual, dirty):
    """Randomized decode(pack(x)) == x over the SIMD path's edge cases:
    1- and 2-entry dicts, exceptions inside and across 32-position vector
    blocks, odd tails, and variable-length pad runs (W=104: 8-aligned but
    not 32-aligned, so every row crosses vector/scalar boundaries)."""
    native = _native()
    rng = np.random.default_rng(seed)
    B, W = 257, 104
    quals_pool = (np.array([35, 40], np.uint8))[:nqual]
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(B, W))
    quals = quals_pool[rng.integers(0, nqual, size=(B, W))]
    if dirty:
        m = rng.random((B, W)) < dirty
        bases = np.where(m, np.uint8(ord("N")), bases)
        m2 = rng.random((B, W)) < dirty / 2
        quals = np.where(m2, np.uint8(2), quals)  # off-dict qual
    lengths = rng.integers(1, W + 1, size=B).astype(np.int32)
    mask = np.arange(W)[None, :] < lengths[:, None]
    bases = np.where(mask, bases, 0).astype(np.uint8)
    quals = np.where(mask, quals, 0).astype(np.uint8)
    qd = np.zeros(2, np.uint8)
    qn = np.zeros(1, np.int32)
    res = native.pack_p3(bases, quals, qd, qn)
    assert res is not None
    bp, qp, ei, eb, eq, n = res
    bb, qq = _decode(bp, qp, qd, B, W, lengths, ei, eb, eq, n)
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


def test_p3_byte_parity_full_pipeline(tmp_path):
    """p3 vs the fully UNPACKED path (FASTP_TPU_NO_INPUT_PACK) over the
    bench-flavor config on binned-quality data where p3 engages."""
    _native()
    r1, r2 = _synth(tmp_path, n=3000)
    base = ["-i", r1, "-I", r2, "--correction", "--cut_right",
            "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
            "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
    _run_cli(base + ["-o", "p31.fq", "-O", "p32.fq", "-j", "p3.json",
                     "-h", "p3.html"], str(tmp_path))
    _run_cli(base + ["-o", "ref1.fq", "-O", "ref2.fq", "-j", "ref.json",
                     "-h", "ref.html"], str(tmp_path),
             extra_env={"FASTP_TPU_NO_INPUT_PACK": "1"})
    for a, b in (("p31.fq", "ref1.fq"), ("p32.fq", "ref2.fq")):
        with open(tmp_path / a, "rb") as f1, open(tmp_path / b, "rb") as f2:
            assert f1.read() == f2.read(), "%s differs" % a
    import re

    def norm(p):
        with open(tmp_path / p) as f:
            return re.sub(r'\t"command": ".*"', "C", f.read())

    assert norm("p3.json") == norm("ref.json")
