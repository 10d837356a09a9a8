"""Per-cycle quality/content statistics (reference: src/stats.cpp:232-332).

stat_batch computes, for a batch of (possibly masked) reads, the same
accumulators Stats::statRead builds per read:
  cycle_q20/q30/content/qual[8, L], cycle_total_base/qual[L],
  qual_hist[128], kmer[2048], reads, length_sum.

Formulation: per-cycle tensors are masked reductions over the batch axis;
the quality histogram is a one-hot equality reduction; the joint 10-bit
k-mer histogram is a matmul of two bf16 one-hot factors (high 6 bits x low
4 bits) with f32 accumulation -- 0/1 operands are exact in bf16 and counts
stay below 2^24 per batch, so the matmul is exact.  No scatters anywhere.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from .common import pos_iota, base_slot, base2val

Q20_CHAR = ord('5')
Q30_CHAR = ord('?')
KMER_BINS = 2 << 10  # mKmerBufLen = 2<<(5*2) = 2048 (only 1024 used by 10-bit keys)


def stat_batch(bases, quals, lengths, include):
    """include: bool[B] -- which reads contribute (e.g. post-filter pass).

    Returns a dict of int32 accumulators for one batch.
    """
    B, L = bases.shape
    rlen = lengths.astype(jnp.int32)
    pos = pos_iota(B, L)
    in_read = (pos < rlen[:, None]) & include[:, None]
    q = quals.astype(jnp.int32)
    qm33 = jnp.where(in_read, q - 33, 0)
    slot = base_slot(bases)  # 0..7

    is_q30 = in_read & (q >= Q30_CHAR)
    is_q20 = in_read & (q >= Q20_CHAR)

    cycle_content = []
    cycle_q20 = []
    cycle_q30 = []
    cycle_qual = []
    for s in range(8):
        m = (slot == s) & in_read
        cycle_content.append(jnp.sum(m, axis=0, dtype=jnp.int32))
        cycle_q20.append(jnp.sum(m & is_q20, axis=0, dtype=jnp.int32))
        cycle_q30.append(jnp.sum(m & is_q30, axis=0, dtype=jnp.int32))
        cycle_qual.append(jnp.sum(jnp.where(m, qm33, 0), axis=0, dtype=jnp.int32))
    cycle_content = jnp.stack(cycle_content)
    cycle_q20 = jnp.stack(cycle_q20)
    cycle_q30 = jnp.stack(cycle_q30)
    cycle_qual = jnp.stack(cycle_qual)

    cycle_total_base = jnp.sum(in_read, axis=0, dtype=jnp.int32)
    cycle_total_qual = jnp.sum(qm33, axis=0, dtype=jnp.int32)

    # quality histogram: one-hot equality reduction (no scatter)
    qh_q = jnp.where(in_read, jnp.clip(q, 0, 127), 128)
    qual_hist = jnp.sum(qh_q[:, :, None] == jnp.arange(128)[None, None, :],
                        axis=(0, 1), dtype=jnp.int32)

    # --- 5-mer counting via one-hot matmul ---
    val = base2val(bases)  # -1 for non-ACGT
    v = jnp.where(val >= 0, val, 0)
    ok = (val >= 0) & (pos < rlen[:, None])

    def shift(a, k, fill):
        return jnp.concatenate([jnp.full((B, k), fill, a.dtype), a[:, :L - k]], axis=1)

    kmer = v
    valid = ok
    for k in range(1, 5):
        kmer = kmer + (shift(v, k, 0) << (2 * k))
        valid = valid & shift(ok, k, False)
    valid = valid & (pos >= 4) & include[:, None]

    hi = (kmer >> 4).astype(jnp.int32)        # 6 bits, 0..63
    lo = (kmer & 0xF).astype(jnp.int32)       # 4 bits, 0..15
    # joint [64, 16] histogram = contraction of the two one-hot factors over
    # the position axis, batched over reads, then reduced over the batch.
    # Exact: per-bin counts < 2^24, f32 accumulation.
    oh_hi = ((hi[:, :, None] == jnp.arange(64)[None, None, :])
             & valid[:, :, None]).astype(jnp.bfloat16)
    oh_lo = (lo[:, :, None] == jnp.arange(16)[None, None, :]).astype(jnp.bfloat16)
    per_read = jax.lax.dot_general(oh_hi, oh_lo, (((1,), (1,)), ((0,), (0,))),
                                   preferred_element_type=jnp.float32)  # [B, 64, 16]
    counts_2d = jnp.sum(per_read, axis=0)
    kmer_counts = jnp.zeros((KMER_BINS,), jnp.int32).at[:1024].set(
        counts_2d.astype(jnp.int32).reshape(-1))

    reads = jnp.sum(include, dtype=jnp.int32)
    length_sum = jnp.sum(jnp.where(include, rlen, 0), dtype=jnp.int32)

    return {
        "cycle_q20": cycle_q20,
        "cycle_q30": cycle_q30,
        "cycle_content": cycle_content,
        "cycle_qual": cycle_qual,
        "cycle_total_base": cycle_total_base,
        "cycle_total_qual": cycle_total_qual,
        "qual_hist": qual_hist,
        "kmer": kmer_counts,
        "reads": reads,
        "length_sum": length_sum,
    }
