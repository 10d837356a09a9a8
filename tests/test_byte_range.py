"""Byte-range reader + multi-host shard-range arithmetic unit tests
(fastp_tpu/parallel/multihost.py, io/fastq.py byte_range support)."""
import gzip
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from fastp_tpu.io.fastq import FastqReader
from fastp_tpu.parallel import multihost


def _write_corpus(path, n, name_fmt="@r%d xx"):
    with open(path, "w") as f:
        for i in range(n):
            seq = "ACGT" * (3 + i % 5)
            f.write("%s\n%s\n+\n%s\n" % (name_fmt % i, seq, "F" * len(seq)))


def _read_names(path, rng=None):
    r = FastqReader(path, byte_range=rng)
    names = []
    while True:
        rec = r.read()
        if rec is None:
            break
        names.append(rec.name)
    r.close()
    return names


def test_shard_ranges_cover_all_records(tmp_path):
    p1 = str(tmp_path / "R1.fq")
    p2 = str(tmp_path / "R2.fq")
    _write_corpus(p1, 103)
    _write_corpus(p2, 103, name_fmt="@r%d yy")  # different name lengths
    for n in (2, 3, 5):
        r1, r2 = multihost.shard_ranges(p1, p2, n)
        # contiguous, non-overlapping, full coverage
        assert r1[0][0] == 0 and r1[-1][1] == os.path.getsize(p1)
        assert all(r1[k][1] == r1[k + 1][0] for k in range(n - 1))
        names1 = []
        names2 = []
        for k in range(n):
            s1 = _read_names(p1, r1[k])
            s2 = _read_names(p2, r2[k])
            # paired shards hold the SAME records
            assert [x.split(b" ")[0] for x in s1] == \
                   [x.split(b" ")[0] for x in s2]
            names1 += s1
            names2 += s2
        assert names1 == _read_names(p1)
        assert names2 == _read_names(p2)


def test_align_to_record_never_splits(tmp_path):
    p = str(tmp_path / "R.fq")
    # quality lines full of '@' and '+' try to fool the aligner
    with open(p, "w") as f:
        for i in range(50):
            f.write("@r%d\nACGTACGTAC\n+\n@@++@@++@@\n" % i)
    size = os.path.getsize(p)
    for frac in (1, 3, 7, 13, 29):
        pos = multihost._align_to_record(p, size * frac // 31)
        names = _read_names(p, (pos, size))
        assert all(n.startswith(b"@r") for n in names)
        # the remainder parses to whole records: count matches offset math
        with open(p, "rb") as f:
            head = f.read(pos)
        assert head.count(b"\n") % 4 == 0


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
def test_empty_shard_warns(gz, tmp_path, monkeypatch, capsys):
    """Shards start at multiples of --batch_size: 100 pairs in batches of
    64 over 4 shards leave shards 1 and 3 without reads, and they say so."""
    from fastp_tpu.config import Options
    paths = []
    for m in (1, 2):
        p = str(tmp_path / ("R%d.fq" % m))
        _write_corpus(p, 100)
        if gz:
            with open(p, "rb") as f, gzip.open(p + ".gz", "wb") as g:
                g.write(f.read())
            p += ".gz"
        paths.append(p)
    monkeypatch.setenv("FASTP_TPU_SHARD_COUNT", "4")
    empty = []
    for k in range(4):
        monkeypatch.setenv("FASTP_TPU_SHARD_INDEX", str(k))
        opt = Options()
        opt.in1, opt.in2 = paths
        opt.batchSize = 64
        multihost.shard_options(opt)
        if "has no reads" in capsys.readouterr().err:
            empty.append(k + 1)
    assert empty == [1, 3]
