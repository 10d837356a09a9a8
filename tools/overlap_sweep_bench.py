"""Check and time the PE overlap sweep candidates on the accelerator.

    python tools/overlap_sweep_bench.py [--batch 65536] [--width 160]

Each ungapped sweep -- the offset loop (`_analyze_loop`, what `analyze`
runs off the CPU) and the one-hot conv under the clean/dirty `lax.cond`
(what it runs on the CPU) -- runs on a B x L sample of random reads with
planted overlaps (seeded).  Each must equal `hostview.host_analyze_overlap`,
the numpy port of the reference, in overlapped/offset/overlap_len/diff with
zero tolerance; its time is the median of 20 runs after warm-up.  The f32
conv (L > 256) is checked the same way at L=320, and the k-mer counts of
`stats.stat_batch` against a numpy count.
"""
import argparse
import os
import subprocess
import sys
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from fastp_tpu.pipeline.hostview import host_analyze_overlap  # noqa: E402

DIFF_LIMIT, OV_REQ, DIFF_PCT = 5, 30, 0.2
FIELDS = ("overlapped", "offset", "overlap_len", "diff")
ACGT = np.frombuffer(b"ACGT", np.uint8)
COMP = np.zeros(256, np.uint8)
for _k, _v in ((65, 84), (84, 65), (67, 71), (71, 67), (78, 78)):
    COMP[_k] = _v


def make_sample(B, L, seed):
    """Random reads of length 60..min(L, 151); 3 rows in 4 get a planted
    overlap (forward or backward offset) with 0-4 mismatches."""
    rng = np.random.default_rng(seed)
    lmax = min(L, 151)
    l1 = rng.integers(60, lmax + 1, B).astype(np.int32)
    l2 = rng.integers(60, lmax + 1, B).astype(np.int32)
    s1 = ACGT[rng.integers(0, 4, (B, L))]
    s2 = ACGT[rng.integers(0, 4, (B, L))]
    s1[rng.random((B, L)) < 0.002] = ord("N")
    for i in np.flatnonzero(rng.random(B) < 0.75):
        a, b = int(l1[i]), int(l2[i])
        k = int(rng.integers(0, 40))
        if rng.random() < 0.8:   # forward: s1[k+j] pairs with rc(s2)[j]
            olen = min(a - k, b)
            src = s1[i, k:k + olen]
            dst = b - 1 - np.arange(olen)
        else:                    # backward: rc(s2)[k+j] pairs with s1[j]
            olen = min(a, b - k)
            src = s1[i, :olen]
            dst = b - 1 - (k + np.arange(olen))
        if olen <= 0:
            continue
        s2[i, dst] = COMP[src]
        for _ in range(int(rng.integers(0, 5))):
            s2[i, int(rng.integers(0, b))] = ACGT[int(rng.integers(0, 4))]
    pos = np.arange(L)[None, :]
    s1[pos >= l1[:, None]] = 0
    s2[pos >= l2[:, None]] = 0
    return s1, l1, s2, l2


def _ref_rows(args):
    s1, l1, s2, l2 = args
    out = np.zeros((len(l1), 4), np.int64)
    for r in range(len(l1)):
        out[r] = host_analyze_overlap(s1[r, :l1[r]], s2[r, :l2[r]],
                                      DIFF_LIMIT, OV_REQ, DIFF_PCT)
    return out


def host_reference(s1, l1, s2, l2):
    """[B, 4] (found, offset, overlap_len, diff), spread over the cores
    before this process starts JAX."""
    parts = np.array_split(np.arange(len(l1)), 4 * (os.cpu_count() or 1))
    work = [(s1[p], l1[p], s2[p], l2[p]) for p in parts]
    with ProcessPoolExecutor() as ex:
        return np.concatenate(list(ex.map(_ref_rows, work)))


def mismatched_rows(res, ref):
    bad = np.zeros(len(ref), bool)
    for j, f in enumerate(FIELDS):
        bad |= np.asarray(res[f]).astype(np.int64) != ref[:, j]
    return int(bad.sum())


def kmer_numpy(bases, lengths):
    val = np.full(bases.shape, -1, np.int64)
    for v, c in enumerate(b"ATCG"):  # the reference's base2val order
        val[bases == c] = v
    B, L = bases.shape
    key = np.zeros((B, L - 4), np.int64)
    ok = np.arange(4, L)[None, :] < lengths[:, None]
    for k in range(5):
        col = val[:, 4 - k:L - k]
        ok &= col >= 0
        key += np.maximum(col, 0) << (2 * k)
    return np.bincount(key[ok], minlength=1024)


def timed(fn, args, n=20):
    for _ in range(3):
        _block(fn(*args))
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        _block(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts)), float(np.min(ts))


def _block(tree):
    import jax
    jax.tree_util.tree_map(lambda x: x.block_until_ready(), tree)


def sweeps():
    """name -> the ungapped sweep as the pipeline step traces it."""
    import jax
    import jax.numpy as jnp
    from fastp_tpu.ops import overlap
    consts = (DIFF_LIMIT, OV_REQ, DIFF_PCT)

    def loop(s1, l1, s2, l2):
        return overlap._analyze_loop(s1, l1, s2, l2, *consts, False)

    def cond(s1, l1, s2, l2):
        ok = (lambda x: jnp.all((x == 0) | (x == 65) | (x == 67) | (x == 71)
                                | (x == 84) | (x == 78)))
        return jax.lax.cond(
            ok(s1) & ok(s2),
            lambda ops: overlap.analyze_conv(*ops, *consts),
            lambda ops: overlap._analyze_loop(*ops, *consts, False),
            (s1, l1, s2, l2))
    return {"loop": loop, "cond": cond}


def compile_sweep(fn, args):
    import jax
    t0 = time.perf_counter()
    comp = jax.jit(fn).lower(*args).compile()
    return comp, time.perf_counter() - t0


def op_phase(B, L, seed):
    s1, l1, s2, l2 = make_sample(B, L, seed)
    t0 = time.perf_counter()
    ref = host_reference(s1, l1, s2, l2)
    print("host reference: %d rows, %d overlapped, %.1fs"
          % (B, int(ref[:, 0].sum()), time.perf_counter() - t0), flush=True)
    s1w, l1w, s2w, l2w = make_sample(8192, 320, seed + 1)
    ref_w = host_reference(s1w, l1w, s2w, l2w)

    import jax
    args = [jax.device_put(a) for a in (s1, l1, s2, l2)]
    from fastp_tpu.ops import overlap
    ok = True
    for name, fn in sweeps().items():
        try:
            comp, tc = compile_sweep(fn, args)
            bad = mismatched_rows(comp(*args), ref)
            med, best = timed(comp, args)
            print("sweep %-6s B=%d L=%d: compile %.1fs, median %.3f ms, "
                  "min %.3f ms, rows differing from host reference: %d"
                  % (name, B, L, tc, med * 1e3, best * 1e3, bad), flush=True)
            ok &= bad == 0
        except Exception as e:  # report every candidate, then fail below
            ok = False
            print("sweep %-6s FAILED: %s: %s"
                  % (name, type(e).__name__, str(e)[:2000]), flush=True)

    wide = overlap.analyze_conv(s1w, l1w, s2w, l2w, DIFF_LIMIT, OV_REQ,
                                DIFF_PCT)
    bad = mismatched_rows(wide, ref_w)
    print("f32 conv L=320 B=8192: rows differing from host reference: %d"
          % bad, flush=True)
    ok &= bad == 0

    from fastp_tpu.ops.stats import stat_batch
    rng = np.random.default_rng(seed + 2)
    bases = np.frombuffer(b"ACGTN", np.uint8)[
        rng.choice(5, (B, L), p=[.245, .245, .245, .245, .02])]
    lengths = rng.integers(0, L + 1, B).astype(np.int32)
    bases = np.where(np.arange(L)[None, :] < lengths[:, None], bases, 0)
    quals = np.full((B, L), 70, np.uint8)
    got = np.asarray(jax.jit(stat_batch)(bases, quals, lengths,
                                         np.ones(B, bool))["kmer"])
    want = kmer_numpy(bases, lengths)
    kbad = int((got[:1024] != want).sum()) + int(got[1024:].any())
    print("k-mer counts B=%d L=%d: %d bins differ from numpy (total %d)"
          % (B, L, kbad, int(want.sum())), flush=True)
    return ok and kbad == 0


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=65536)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--seed", type=int, default=11)
    a = ap.parse_args()
    try:
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip(), flush=True)
    except (OSError, subprocess.SubprocessError):
        print("nvidia-smi: not available", flush=True)
    ok = op_phase(a.batch, a.width, a.seed)
    import jax
    d = jax.devices()[0]
    print("device: %s %s x%d, jax %s" % (d.platform, d.device_kind,
                                         len(jax.devices()), jax.__version__),
          flush=True)
    print("ALL OK" if ok else "FAILED", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
