"""Micro-benchmarks for the native host hot paths (no device involved).

Measures tokenize / dup hash / nib pack / serialize on a synthetic PE150
batch — the host stages that feed the device, so these bound the
produce-side throughput.  Run on an idle host:

    python tools/bench_host_paths.py [--batch 32768] [--width 160]
"""
import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from fastp_tpu.io import native as native_mod  # noqa: E402


def synth_chunk(n, readlen, seed=0):
    rng = np.random.default_rng(seed)
    bases = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=(n, readlen))
    quals = rng.choice(np.frombuffer(b"FFFF:F,F", np.uint8), size=(n, readlen))
    recs = []
    for i in range(n):
        recs.append(b"@SIM:1:FCX:1:2106:%d:%d 1:N:0:ATCACG\n" % (i, i * 7))
        recs.append(bases[i].tobytes() + b"\n+\n" + quals[i].tobytes() + b"\n")
    return b"".join(recs)


def timeit(fn, reps=5):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=32768)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--readlen", type=int, default=150)
    args = ap.parse_args()
    lib = native_mod.get_lib()
    assert lib is not None, "native library unavailable"
    B, W = args.batch, args.width

    chunk = np.frombuffer(synth_chunk(B, args.readlen), np.uint8)
    mb = chunk.size / 1e6
    t = timeit(lambda: native_mod.tokenize(chunk, True, B, W, False))
    print("tokenize   %7.1f ms  (%.0f MB/s, %d records)"
          % (t * 1e3, mb / t, B))

    n, bases, quals, lengths = native_mod.tokenize(chunk, True, B, W, False)[:4]
    res = native_mod.tokenize(chunk, True, B, W, False)
    n, bases, quals, lengths, name_off, name_len, strand_off, strand_len = res[:8]

    # dup hash (pair, 1 buffer like the default level)
    from fastp_tpu.duplicate import Duplicate  # noqa: E402
    from fastp_tpu.config import Options  # noqa: E402
    opt = Options()
    opt.in2 = "x"  # paired
    opt.duplicate.enabled = True
    dup = Duplicate(opt)
    t = timeit(lambda: dup.check_batch_pe(bases, lengths, bases, lengths), 3)
    print("dup hash   %7.1f ms  (%.1f us/pair)" % (t * 1e3, t * 1e6 / B))
    dup.release()

    qdict = np.zeros(4, np.uint8)
    qn = np.zeros(1, np.int32)
    t = timeit(lambda: native_mod.pack_nib(bases, quals, qdict, qn))
    print("pack_nib   %7.1f ms  (%.0f MB/s in)" % (t * 1e3, B * W / 1e6 / t))

    start = np.zeros(B, np.int32)
    rlen = lengths.copy()
    emit = np.ones(B, np.uint8)
    t = timeit(lambda: native_mod.serialize(
        chunk, name_off, name_len, chunk, strand_off, strand_len,
        bases, quals, start, rlen, emit, W))
    out_mb = (name_len.sum() + strand_len.sum() + 2 * int(rlen.sum()) + 4 * B) / 1e6
    print("serialize  %7.1f ms  (%.0f MB/s out)" % (t * 1e3, out_mb / t))


if __name__ == "__main__":
    main()
