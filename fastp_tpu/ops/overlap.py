"""PE overlap analysis (reference: src/overlapanalysis.cpp:16-183).

The reference scans offsets sequentially per pair and accepts the first
offset whose Hamming-distance test passes, with an early-break quirk (break
at the first mismatch index i < 50 where the running diff exceeds the
limit; a full scan that exceeded the limit late still accepts when
i(=overlap_len) > 50).

Acceptance is equivalent to (proof in tests/test_overlap_equiv.py):
    accept  <=>  prefix50 <= limit  AND  (total <= limit  OR  olen > 50)
where prefix50 = mismatches among the first min(50, olen) overlap positions
and total = mismatches over the whole overlap (the reported diff).  Both
are plain masked sums, so each offset needs only a static-shift compare +
two reductions -- no gathers, cumsums, or argmax on the hot path.  The
offset scan is a lax.fori_loop with first-accept-wins carries.
"""
from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from .common import pos_iota, rc

COMPLETE_COMPARE_REQUIRE = 50


def _onehot_acgtn(seq, length, dtype):
    """[B, L] bytes -> [B, 5, L] one-hot over A/C/G/T/N, zero beyond
    `length` and for any other byte (clean-alphabet batches only)."""
    B, L = seq.shape
    mask = (pos_iota(B, L) < length[:, None])
    chans = jnp.stack([seq == 65, seq == 67, seq == 71, seq == 84, seq == 78],
                      axis=1)
    return (chans & mask[:, None, :]).astype(dtype)


def _xcorr(lhs, rhs, pad_right: int):
    """out[b, t] = sum_{c,i} lhs[b, c, i+t] * rhs[b, c, i] for t=0..W-1.

    One grouped conv: each batch row is its own filter group, so the whole
    offset sweep runs as one convolution instead of n_off serialized
    compare+reduce kernels."""
    B, C, L = lhs.shape
    lhsp = jnp.pad(lhs, ((0, 0), (0, 0), (0, pad_right)))
    # feature-grouped conv: one group of C channels per batch row (XLA
    # lowers this as depthwise; batch_group_count materializes all pairs).
    # f32 operands (L > 256) must not run in TF32 on a GPU: HIGHEST keeps
    # every partial sum an exact integer.
    prec = (jax.lax.Precision.HIGHEST if lhs.dtype == jnp.float32
            else None)
    out = jax.lax.conv_general_dilated(
        lhsp.reshape(1, B * C, L + pad_right), rhs,
        window_strides=(1,),
        padding="VALID",
        dimension_numbers=("NCH", "OIH", "NCH"),
        feature_group_count=B,
        precision=prec,
        preferred_element_type=jnp.float32)
    return out[0]  # [B, W]


def _select_first_accept(mm_f, mm50_f, mm_b, mm50_b, len1, len2,
                         diff_limit: int, overlap_require: int,
                         diff_pct: float, n_off: int):
    """Shared accept/first-wins selection over mismatch matrices.

    The first-accept-wins order (all forward offsets, then backward) is
    reproduced by an argmax over the concatenated accept matrix."""
    B = len1.shape[0]
    offs = jax.lax.broadcasted_iota(jnp.int32, (B, n_off), 1)

    def judge(mm, mm50, olen, active):
        olen_c = jnp.maximum(olen, 0)
        limit = jnp.minimum(diff_limit,
                            (olen_c.astype(jnp.float32) * diff_pct).astype(jnp.int32))
        accept = active & (mm50 <= limit) & \
            ((mm <= limit) | (olen_c > COMPLETE_COMPARE_REQUIRE))
        return accept

    olen_f = jnp.minimum(len1[:, None] - offs, len2[:, None])
    act_f = offs < (len1 - overlap_require)[:, None]
    acc_f = judge(mm_f, mm50_f, olen_f, act_f)

    olen_b = jnp.minimum(len1[:, None], len2[:, None] - offs)
    act_b = offs < (len2 - overlap_require)[:, None]
    acc_b = judge(mm_b, mm50_b, olen_b, act_b)

    accept = jnp.concatenate([acc_f, acc_b], axis=1)
    olen_all = jnp.concatenate([olen_f, olen_b], axis=1)
    mm_all = jnp.concatenate([mm_f, mm_b], axis=1)
    idx = jnp.argmax(accept, axis=1)
    found = jnp.take_along_axis(accept, idx[:, None], axis=1)[:, 0]
    offset = jnp.where(idx < n_off, idx, -(idx - n_off)).astype(jnp.int32)
    ol = jnp.take_along_axis(olen_all, idx[:, None], axis=1)[:, 0]
    diff = jnp.take_along_axis(mm_all, idx[:, None], axis=1)[:, 0]
    return {
        "overlapped": found,
        "offset": jnp.where(found, offset, 0),
        "overlap_len": jnp.where(found, ol, 0),
        "diff": jnp.where(found, diff, 0),
        "has_gap": jnp.zeros((B,), bool),
    }


def analyze_conv(seq1, len1, seq2, len2, diff_limit: int, overlap_require: int,
                 diff_pct: float):
    """Batched OverlapAnalysis::analyze via one-hot cross-correlation.

    EXACT for clean-alphabet (ACGTN) reads: with one-hot channels the match
    count at offset t is an inner product, so mismatches = olen - matches.
    """
    B, L = seq1.shape
    len1 = len1.astype(jnp.int32)
    len2 = len2.astype(jnp.int32)
    rc2 = rc(seq2, len2)
    n_off = max(L - overlap_require, 1)
    dt = jnp.bfloat16 if L <= 256 else jnp.float32

    oh1 = _onehot_acgtn(seq1, len1, dt)
    oh2 = _onehot_acgtn(rc2, len2, dt)
    k50 = min(COMPLETE_COMPARE_REQUIRE, L)

    m_f = _xcorr(oh1, oh2, n_off)[:, :n_off]
    m_b = _xcorr(oh2, oh1, n_off)[:, :n_off]
    p50_f = _xcorr(oh1, oh2[:, :, :k50], n_off)[:, :n_off]
    p50_b = _xcorr(oh2, oh1[:, :, :k50], n_off)[:, :n_off]

    offs = jax.lax.broadcasted_iota(jnp.int32, (B, n_off), 1)
    olen_f = jnp.maximum(jnp.minimum(len1[:, None] - offs, len2[:, None]), 0)
    olen_b = jnp.maximum(jnp.minimum(len1[:, None], len2[:, None] - offs), 0)
    mm_f = olen_f - jnp.round(m_f).astype(jnp.int32)
    mm_b = olen_b - jnp.round(m_b).astype(jnp.int32)
    mm50_f = jnp.minimum(olen_f, COMPLETE_COMPARE_REQUIRE) - \
        jnp.round(p50_f).astype(jnp.int32)
    mm50_b = jnp.minimum(olen_b, COMPLETE_COMPARE_REQUIRE) - \
        jnp.round(p50_b).astype(jnp.int32)
    return _select_first_accept(mm_f, mm50_f, mm_b, mm50_b, len1, len2,
                                diff_limit, overlap_require, diff_pct, n_off)


def analyze(seq1, len1, seq2, len2, diff_limit: int, overlap_require: int,
            diff_pct: float, allow_gap: bool = False, clean=None,
            spmd: bool = False):
    """Batched OverlapAnalysis::analyze.

    seq1/seq2: uint8[B, L] windowed reads; len1/len2: int32[B].
    Returns dict(overlapped bool[B], offset int32[B], overlap_len int32[B],
                 diff int32[B], has_gap bool[B]).

    `clean` (traced bool scalar or None): on the CPU, batches with
    clean=True at runtime take the one-hot cross-correlation (exact for
    ACGTN-only batches) and dirty ones the byte-exact offset loop, via
    lax.cond.  Every other platform runs the offset loop for every batch:
    on an H100 it sweeps a 64k x 160 batch about 4x faster than the conv
    (PERF.md, "Bring-up findings"), while XLA's CPU backend runs the conv
    faster.

    `spmd`: the step is being partitioned over a device mesh.  The grouped
    conv puts the batch in the CHANNEL dimension, which GSPMD cannot shard
    on dp — it all-gathers the one-hot tensors (f32[1, B*5, n_off], tens of
    MB) and re-runs the FULL conv on every device (measured ~100x wall on
    an 8-device virtual CPU mesh).  The sequential-offset loop is row-local
    (dynamic_slice on axis 1 + masked reduces), so each shard sweeps only
    its own rows — it partitions perfectly and stays byte-exact for any
    alphabet, so the clean/dirty cond disappears too.
    """
    if spmd and not allow_gap:
        return _analyze_loop(seq1, len1, seq2, len2, diff_limit,
                             overlap_require, diff_pct, False)
    if (clean is not None and not allow_gap
            and jax.default_backend() == "cpu"):
        return jax.lax.cond(
            clean,
            lambda ops: analyze_conv(*ops, diff_limit, overlap_require, diff_pct),
            lambda ops: _analyze_loop(*ops, diff_limit, overlap_require,
                                      diff_pct, False),
            (seq1, len1, seq2, len2))
    return _analyze_loop(seq1, len1, seq2, len2, diff_limit, overlap_require,
                         diff_pct, allow_gap)


@partial(jax.jit, static_argnames=("diff_limit", "overlap_require", "diff_pct", "allow_gap"))
def _analyze_loop(seq1, len1, seq2, len2, diff_limit: int, overlap_require: int,
                  diff_pct: float, allow_gap: bool = False):
    """Sequential-offset formulation (byte-exact for ANY input bytes)."""
    B, L = seq1.shape
    len1 = len1.astype(jnp.int32)
    len2 = len2.astype(jnp.int32)
    rc2 = rc(seq2, len2)
    i_pos = pos_iota(B, L)

    # pad seq1/rc2 so shifted static slices are safe
    z = jnp.zeros((B, L), seq1.dtype)
    seq1p = jnp.concatenate([seq1, z], axis=1)  # [B, 2L]
    rc2p = jnp.concatenate([rc2, z], axis=1)

    def eval_offset(shifted_a, base_b, olen):
        """accept/diff at one offset given aligned rows.

        shifted_a[i] vs base_b[i] for i < olen."""
        limit = jnp.minimum(diff_limit,
                            (olen.astype(jnp.float32) * diff_pct).astype(jnp.int32))
        in_ov = i_pos < olen[:, None]
        mm = (shifted_a != base_b) & in_ov
        total = jnp.sum(mm, axis=1, dtype=jnp.int32)
        pre50 = jnp.sum(mm & (i_pos < COMPLETE_COMPARE_REQUIRE), axis=1,
                        dtype=jnp.int32)
        accept = (pre50 <= limit) & ((total <= limit) |
                                     (olen > COMPLETE_COMPARE_REQUIRE))
        return accept, total

    init = (jnp.zeros((B,), bool), jnp.zeros((B,), jnp.int32),
            jnp.zeros((B,), jnp.int32), jnp.zeros((B,), jnp.int32))

    def fwd_body(off, state):
        found, f_off, f_ol, f_diff = state
        active = off < len1 - overlap_require
        olen = jnp.minimum(len1 - off, len2)
        s1 = jax.lax.dynamic_slice_in_dim(seq1p, off, L, axis=1)
        acc, diff = eval_offset(s1, rc2, olen)
        new = acc & active & ~found
        return (found | new,
                jnp.where(new, off, f_off),
                jnp.where(new, olen, f_ol),
                jnp.where(new, diff, f_diff))

    n_off = L - overlap_require if L > overlap_require else 0
    state = jax.lax.fori_loop(0, n_off, fwd_body, init)

    def bwd_body(k, state):
        # offset = -k, k starts at 0 (the reference re-tests offset 0)
        found, f_off, f_ol, f_diff = state
        active = k < len2 - overlap_require
        olen = jnp.minimum(len1, len2 - k)
        s2 = jax.lax.dynamic_slice_in_dim(rc2p, k, L, axis=1)
        acc, diff = eval_offset(s2, seq1, olen)
        new = acc & active & ~found
        return (found | new,
                jnp.where(new, -k, f_off),
                jnp.where(new, olen, f_ol),
                jnp.where(new, diff, f_diff))

    state = jax.lax.fori_loop(0, n_off, bwd_body, state)
    found, off, ol, diff = state
    has_gap = jnp.zeros((B,), bool)

    if allow_gap:
        def gap_diff(ins, norm, cmplen, limit):
            """Matcher::diffWithOneInsertion vectorized (src/matcher.cpp:56-101).

            ins/norm: uint8[B, L] (ins compared at i, i+1; norm at i).
            cmplen/limit: int32[B]. Returns diff[B] (-1 = over limit)."""
            i = i_pos
            ins_sh = jnp.concatenate([ins[:, 1:], jnp.zeros((B, 1), ins.dtype)], axis=1)
            acc_l = jnp.cumsum(((ins != norm) & (i < cmplen[:, None])).astype(jnp.int32), axis=1)
            mm_r = ((ins_sh != norm) & (i < cmplen[:, None])).astype(jnp.int32)
            suf = jnp.cumsum(mm_r[:, ::-1], axis=1)[:, ::-1]
            accl_prev = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), acc_l[:, :-1]], axis=1)
            cand = accl_prev + suf
            valid = (i >= 1) & (i < cmplen[:, None])
            min_diff = jnp.min(jnp.where(valid, cand, 10 ** 8), axis=1)
            total_l = acc_l[:, -1]  # = accLeft[cmplen-1]; accLeft[cmplen-2] needed
            # accLeft[cmplen-2]: subtract the last in-range term
            last_idx = jnp.clip(cmplen - 1, 0, L - 1)
            last_mm = jnp.sum(((ins != norm) & (i == last_idx[:, None])).astype(jnp.int32), axis=1)
            accl_cm2 = total_l - last_mm
            # accRight[cmplen-1] = mm_r at i = cmplen-1
            accr_last = jnp.sum((mm_r > 0) & (i == last_idx[:, None]), axis=1).astype(jnp.int32)
            over = (accl_cm2 + accr_last) > limit
            has_cand = jnp.any(valid, axis=1)
            return jnp.where(over | ~has_cand, -1, min_diff)

        def gap_fwd_body(off, state):
            found, f_off, f_ol, f_diff, f_gap = state
            active = off < len1 - overlap_require
            olen = jnp.minimum(len1 - off, len2)
            limit = jnp.minimum(diff_limit,
                                (olen.astype(jnp.float32) * diff_pct).astype(jnp.int32))
            s1 = jax.lax.dynamic_slice_in_dim(seq1p, off, L, axis=1)
            cl = olen - 1
            d1 = gap_diff(s1, rc2, cl, limit)
            d2 = gap_diff(rc2, s1, cl, limit)
            dd = jnp.where((d1 < 0) | (d1 > limit), d2, d1)
            acc = (dd <= limit) & (dd >= 0)
            new = acc & active & ~found
            return (found | new, jnp.where(new, off, f_off),
                    jnp.where(new, olen, f_ol), jnp.where(new, dd, f_diff),
                    jnp.where(new, True, f_gap))

        def gap_bwd_body(k, state):
            found, f_off, f_ol, f_diff, f_gap = state
            active = k < len2 - overlap_require
            olen = jnp.minimum(len1, len2 - k)
            limit = jnp.minimum(diff_limit,
                                (olen.astype(jnp.float32) * diff_pct).astype(jnp.int32))
            s2 = jax.lax.dynamic_slice_in_dim(rc2p, k, L, axis=1)
            cl = olen - 1
            d1 = gap_diff(seq1, s2, cl, limit)
            d2 = gap_diff(s2, seq1, cl, limit)
            dd = jnp.where((d1 < 0) | (d1 > limit), d2, d1)
            acc = (dd <= limit) & (dd >= 0)
            new = acc & active & ~found
            return (found | new, jnp.where(new, -k, f_off),
                    jnp.where(new, olen, f_ol), jnp.where(new, dd, f_diff),
                    jnp.where(new, True, f_gap))

        gstate = (found, off, ol, diff, has_gap)
        gstate = jax.lax.fori_loop(0, n_off, gap_fwd_body, gstate)
        gstate = jax.lax.fori_loop(0, n_off, gap_bwd_body, gstate)
        found, off, ol, diff, has_gap = gstate

    return {
        "overlapped": found,
        "offset": jnp.where(found, off, 0),
        "overlap_len": jnp.where(found, ol, 0),
        "diff": jnp.where(found, diff, 0),
        "has_gap": has_gap & found,
    }
