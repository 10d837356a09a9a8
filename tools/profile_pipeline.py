"""Break down host vs device time for the PE pipeline on a synthetic corpus.

Usage: PYTHONPATH=. python tools/profile_pipeline.py [--pairs 50000] [--batch 16384]
Prints per-phase seconds: read+tokenize, device step (blocked), host routing,
serialization, write, and total.
"""
import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--pairs", type=int, default=50000)
    ap.add_argument("--batch", type=int, default=16384)
    ap.add_argument("--corpus", default=os.path.join(ROOT, ".bench", "profile"))
    args = ap.parse_args()

    r1 = os.path.join(args.corpus, "R1.fq")
    if not os.path.exists(r1):
        import subprocess
        os.makedirs(args.corpus, exist_ok=True)
        subprocess.run([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                        "--reads", str(args.pairs),
                        "--out1", r1, "--out2", os.path.join(args.corpus, "R2.fq")],
                       check=True)

    from fastp_tpu.config import Options
    from fastp_tpu.io.fastq import open_batch_reader
    from fastp_tpu.io import native as native_mod
    from fastp_tpu.pipeline.static_cfg import device_cfg_from_options
    from fastp_tpu.pipeline.device import build_pe_step, unpack_from_host
    import jax

    opt = Options()
    opt.in1 = r1
    opt.in2 = os.path.join(args.corpus, "R2.fq")
    opt.correction.enabled = True
    opt.qualityCut.enabledRight = True
    opt.adapter.sequence = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
    opt.adapter.hasSeqR1 = True
    opt.adapter.sequenceR2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
    opt.adapter.hasSeqR2 = True
    cfg = device_cfg_from_options(opt)
    step = build_pe_step(cfg)

    t = {"read": 0.0, "step": 0.0, "host": 0.0, "serial": 0.0}
    width = 160
    reader1 = open_batch_reader(opt.in1)
    reader2 = open_batch_reader(opt.in2)
    nlib = native_mod.get_lib()
    print("native lib:", "yes" if nlib else "no", file=sys.stderr)

    total_reads = 0
    t_all = time.time()
    nbatches = 0
    while True:
        t0 = time.time()
        batch1 = reader1.read_batch(args.batch, width)
        batch2 = reader2.read_batch(args.batch, width)
        t["read"] += time.time() - t0
        if batch1 is None or batch2 is None:
            break
        B = batch1.n
        total_reads += 2 * B
        width = batch1.width
        t0 = time.time()
        # plain-step signature: (b1, q1, l1, b2, q2, l2, *aux); this cfg
        # has no UMI/index/dedup so aux is the scalar valid count
        out = step(batch1.bases, batch1.quals, batch1.lengths,
                   batch2.bases, batch2.quals, batch2.lengths,
                   np.int32(B))
        out = unpack_from_host(jax.device_get(out), step.layout)
        t["step"] += time.time() - t0

        t0 = time.time()
        if "emit_pair" in out:
            emitp = out["emit_pair"][:B].astype(np.uint8)
        else:  # lean layouts ship pass flags only
            emitp = (out["pass1"][:B] & out["pass2"][:B]).astype(np.uint8)
        for bt, tf_key, rl_key in ((batch1, "total_front1", "rlen1"),
                                   (batch2, "total_front2", "rlen2")):
            nbuf, noff, nlen_a = bt.name_buffers()
            sbuf, soff, slen_a = bt.strand_buffers()
            blob = native_mod.serialize(
                nbuf, noff, nlen_a, sbuf, soff, slen_a,
                bt.bases, bt.quals, out[tf_key][:B], out[rl_key][:B],
                emitp, bt.width)
        t["serial"] += time.time() - t0
        nbatches += 1

    wall = time.time() - t_all
    print("batches=%d reads=%d wall=%.2fs  %.0f reads/s" %
          (nbatches, total_reads, wall, total_reads / wall))
    for k, v in t.items():
        print("  %-8s %.2fs (%.0f%%)" % (k, v, 100 * v / wall))


if __name__ == "__main__":
    main()
