"""Jitted per-batch device pipelines (SE and PE).

One device roundtrip per batch: host supplies raw padded tensors plus
host-computed masks (UMI pre-trim, index-filter drops, dedup decisions),
the device executes the full trim/cut/adapter/overlap/correct/filter/stat
pipeline (reference order: src/seprocessor.cpp:196-315 for SE,
src/peprocessor.cpp:361-600 for PE) and returns per-read scalars, windowed
(possibly corrected) content arrays, and batch-reduced stat tensors.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from .._jaxcache import ensure_compile_cache
ensure_compile_cache()

from ..config import PASS_FILTER, FILTER_RESULT_TYPES
from ..ops import trim as trim_ops
from ..ops import polyx as polyx_ops
from ..ops import adapter as adapter_ops
from ..ops import overlap as overlap_ops
from ..ops import correct as correct_ops
from ..ops import merge as merge_ops
from ..ops import filter as filter_ops
from ..ops import stats as stats_ops
from ..ops.common import roll_front
from .static_cfg import DeviceCfg


class _FilterCfgView:
    """Adapter of DeviceCfg attribute names for ops.filter/trim."""

    def __init__(self, cfg: DeviceCfg):
        for k in ("enabledFront", "enabledTail", "enabledRight",
                  "windowSizeFront", "qualityFront", "windowSizeTail",
                  "qualityTail", "windowSizeRight", "qualityRight",
                  "qualfilter_enabled", "qualifiedQual",
                  "unqualifiedPercentLimit", "avgQualReq", "nBaseLimit",
                  "lengthFilter_enabled", "requiredLength", "maxLength",
                  "complexity_enabled", "complexity_threshold_percent"):
            setattr(self, k, getattr(cfg, k))


def _multi_fasta_match_req(n: int) -> int:
    """reference: src/adaptertrimmer.cpp:48-52"""
    if n > 256:
        return 6
    if n > 16:
        return 5
    return 4


def _trim_one_end(bases, quals, lengths, pre_trim, cfg: DeviceCfg, is_r2: bool):
    """UMI pre-trim roll + trimAndCut + window roll. Returns
    (w_bases, w_quals, rlen, alive, front_trimmed, total_front)."""
    v = _FilterCfgView(cfg)
    l0 = lengths.astype(jnp.int32)
    b1 = roll_front(bases, pre_trim)
    q1 = roll_front(quals, pre_trim)
    l1 = l0 - pre_trim
    fr = cfg.front2 if is_r2 else cfg.front1
    tl = cfg.tail2 if is_r2 else cfg.tail1
    front, rlen, alive = trim_ops.trim_and_cut(b1, q1, l1, fr, tl, v)
    w_b = roll_front(b1, front)
    w_q = roll_front(q1, front)
    # frontTrimmed semantics: 0 on the fast identity/resize paths
    any_cut = cfg.enabledFront or cfg.enabledTail or cfg.enabledRight
    if fr == 0 and not any_cut:
        front_trimmed = jnp.zeros_like(front)
    else:
        front_trimmed = front
    return w_b, w_q, jnp.where(alive, rlen, 0), alive, front_trimmed, pre_trim + front


def _apply_seq_adapters(w_b, rlen, alive, cfg: DeviceCfg, is_r2: bool,
                        ov_trimmed=None):
    """Adapter by sequence + FASTA list (reference adapter block).
    Returns (rlen', info dict)."""
    out = {"rlen_pre_adapter": rlen}
    B = w_b.shape[0]
    adapter_seq = cfg.adapter_seq2 if is_r2 else cfg.adapter_seq1
    has_seq = cfg.has_seq2 if is_r2 else cfg.has_seq1
    if cfg.adapter_enabled and has_seq and len(adapter_seq) > 0:
        new_len, found, fpos = adapter_ops.trim_by_sequence(w_b, rlen, adapter_seq)
        gate = alive
        if ov_trimmed is not None:
            gate = gate & ~ov_trimmed
        found = found & gate
        rlen = jnp.where(found, new_len, rlen)
        out["ad_found"] = found
        out["ad_pos"] = fpos
    else:
        out["ad_found"] = jnp.zeros((B,), bool)
        out["ad_pos"] = jnp.zeros((B,), jnp.int32)
    out["rlen_post_adapter"] = rlen

    if cfg.adapter_enabled and cfg.fasta_adapters:
        mreq = _multi_fasta_match_req(len(cfg.fasta_adapters))
        for a in cfg.fasta_adapters:
            new_len, found, _ = adapter_ops.trim_by_sequence(w_b, rlen, a, mreq)
            rlen = jnp.where(found & alive, new_len, rlen)
    out["rlen_post_fasta"] = rlen
    return rlen, out


def _apply_polyx_maxlen(w_b, rlen, alive, cfg: DeviceCfg, is_r2: bool):
    """polyX trimming + maxLen resize. Returns (rlen', polyx_reads, polyx_bases)."""
    if cfg.polyx_enabled:
        new_len, has_poly, poly, nbases = polyx_ops.trim_polyx(w_b, rlen, cfg.polyx_min_len)
        has_poly = has_poly & alive
        rlen = jnp.where(has_poly, new_len, rlen)
        polyx_reads = jnp.zeros((5,), jnp.int32).at[
            jnp.where(has_poly, poly, 4)].add(1)[:4]
        polyx_bases = jnp.zeros((5,), jnp.int32).at[
            jnp.where(has_poly, poly, 4)].add(jnp.where(has_poly, nbases, 0))[:4]
    else:
        polyx_reads = jnp.zeros((4,), jnp.int32)
        polyx_bases = jnp.zeros((4,), jnp.int32)

    max_len = cfg.maxLen2 if is_r2 else cfg.maxLen1
    if max_len > 0:
        rlen = jnp.where(alive & (rlen > max_len), max_len, rlen)
    return rlen, polyx_reads, polyx_bases


import os as _os

def _mega_pack(out: dict, layout: dict):
    """Fuse every packed output into ONE uint8 buffer.

    Each D2H buffer pays a fixed transfer latency regardless of size; the
    packed tree still has ~13 leaves.  One bitcast+concat brings that to
    one fetch.  Only used off-mesh: on a
    device mesh the per-read halves shard while stats replicate, which a
    single fused buffer cannot express (see _mega_pack_sharded)."""
    meta = []
    parts = []
    off = 0
    for k in sorted(out):
        v = out[k]
        u8v = v if v.dtype == jnp.uint8 else jax.lax.bitcast_convert_type(v, jnp.uint8)
        flat = u8v.reshape(-1)
        n = int(flat.shape[0])
        meta.append((k, str(v.dtype), tuple(v.shape), off, n))
        off += n
        parts.append(flat)
    layout["mega"] = meta
    return {"_blob": jnp.concatenate(parts)}


def _mega_pack_sharded(out: dict, B: int, layout: dict):
    """Mesh variant of _mega_pack: ONE [B, M] uint8 blob for everything
    per-read (shards on dp, so each device ships exactly one D2H buffer of
    its own rows) plus ONE replicated blob for the batch-reduced stats;
    only the batch-level sparse correction lists stay separate leaves."""
    rows_meta = []   # (key, dtype, K, byte_off, elem_bytes)
    rows_parts = []
    repl_meta = []   # (key, dtype, shape, byte_off, nbytes)
    repl_parts = []
    roff = soff = 0
    for k in sorted(out):
        v = out[k]
        if k in ("_corr_rows", "_corr_pos", "_corr_u8"):
            continue  # batch-level lists: leave as their own leaves
        if v.ndim == 2 and v.shape[1] == B:   # [K, B] per-read matrices
            u8v = jax.lax.bitcast_convert_type(v.T, jnp.uint8) \
                if v.dtype != jnp.uint8 else v.T
            if u8v.ndim == 2:   # 1-byte dtypes: bitcast adds no byte dim
                u8v = u8v[..., None]
            K, nb = v.shape[0], u8v.shape[-1]
            rows_parts.append(u8v.reshape(B, K * nb))
            rows_meta.append((k, str(v.dtype), K, roff, nb))
            roff += K * nb
            out.pop(k)
        elif v.ndim >= 1 and v.shape[0] != B:  # batch-reduced stats/counters
            u8v = (v if v.dtype == jnp.uint8
                   else jax.lax.bitcast_convert_type(v, jnp.uint8))
            flat = u8v.reshape(-1)
            repl_meta.append((k, str(v.dtype), tuple(v.shape), soff,
                              int(flat.shape[0])))
            soff += int(flat.shape[0])
            repl_parts.append(flat)
            out.pop(k)
    if rows_parts:
        out["_rows_blob"] = jnp.concatenate(rows_parts, axis=1)
    if repl_parts:
        out["_repl_blob"] = jnp.concatenate(repl_parts)
    layout["mega_rows"] = rows_meta
    layout["mega_repl"] = repl_meta
    return out


# batch-reduced outputs that are pure sums: in accumulate mode they fold
# into the on-device accumulator instead of riding the per-batch D2H blob
_ACC_KEYS = ("isize_hist", "corr_matrix", "polyx_reads", "polyx_bases",
             "result_hist")


def pack_for_host(out, B: int, layout: dict, mega: bool = False,
                  width: int = 0, accum: bool = False):
    """Merge the many per-read/stat outputs into a handful of dense buffers.

    Each D2H buffer fetch pays a fixed latency regardless of size; the
    unpacked tree has 80+ leaves, the packed form ships ~6 buffers.  Key orders and stat shapes are recorded
    into `layout` at trace time; the runner unpacks with unpack_from_host().
    """
    if _os.environ.get("FASTP_TPU_NO_PACK"):
        layout["i16_keys"] = []
        layout["i32_keys"] = []
        layout["bool_keys"] = []
        layout["stat_keys"] = []
        layout["stats_shapes"] = {}
        return out
    # 0) sparse correction lists + scalar counters -> three buffers;
    #    rows fit uint16 / window positions fit uint8 for typical shapes
    if "c1_rows" in out:
        rows = jnp.stack([out.pop("c1_rows"), out.pop("c2_rows")])
        pos = jnp.stack([out.pop("c1_pos"), out.pop("c2_pos")])
        if B <= 65535 and 0 < width <= 65535:
            # row indices < B fit u16; window positions < width fit u8/u16
            out["_corr_rows"] = rows.astype(jnp.uint16)
            out["_corr_pos"] = pos.astype(jnp.uint8 if width <= 255
                                          else jnp.uint16)
        else:
            out["_corr_rows"] = rows
            out["_corr_pos"] = pos
        out["_corr_u8"] = jnp.stack([out.pop(k) for k in
                                     ("c1_base", "c1_qual", "c2_base", "c2_qual")])
        out["_corr_n"] = jnp.stack([out.pop("c1_count"), out.pop("c2_count"),
                                    out.pop("corrected_reads")])
    # 1) [B] int16 per-read scalars -> one [K, B] matrix
    i16_keys = sorted(k for k, v in out.items()
                      if not isinstance(v, dict) and getattr(v, "ndim", 0) == 1
                      and v.shape[0] == B and v.dtype == jnp.int16)
    if i16_keys:
        out["_i16"] = jnp.stack([out.pop(k) for k in i16_keys])
    # 1a) [B] bias-64 int8 scalars -> one [K, B] matrix
    i8_keys = sorted(k for k, v in out.items()
                     if not isinstance(v, dict) and getattr(v, "ndim", 0) == 1
                     and v.shape[0] == B and v.dtype == jnp.int8)
    if i8_keys:
        out["_i8"] = jnp.stack([out.pop(k) for k in i8_keys])
    # 1b) [B] int32 scalars (long-read mode skips the i16 downcast)
    i32_keys = sorted(k for k, v in out.items()
                      if not isinstance(v, dict) and getattr(v, "ndim", 0) == 1
                      and v.shape[0] == B and v.dtype == jnp.int32)
    if i32_keys:
        out["_i32"] = jnp.stack([out.pop(k) for k in i32_keys])
    # 2) [B] bool flags -> bit-packed [ceil(K/8), B] uint8 (8x fewer D2H
    #    bytes than a bool matrix)
    b_keys = sorted(k for k, v in out.items()
                    if not isinstance(v, dict) and getattr(v, "ndim", 0) == 1
                    and v.shape[0] == B and v.dtype == jnp.bool_)
    if b_keys:
        rows = [out.pop(k).astype(jnp.uint8) for k in b_keys]
        words = []
        for w0 in range(0, len(rows), 8):
            chunk = rows[w0:w0 + 8]
            bits = chunk[0]
            for j in range(1, len(chunk)):
                bits = bits | (chunk[j] << j)
            words.append(bits)
        out["_bool"] = jnp.stack(words)
    # 3) every stats dict -> one flat int32 vector (+ per-key shape table:
    #    post_merged stats are wider than the others in merge mode)
    stat_keys = sorted(k for k, v in out.items() if isinstance(v, dict))
    stats_shapes = {}
    for k in stat_keys:
        d = out.pop(k)
        dkeys = sorted(d)
        stats_shapes[k] = [(dk, tuple(d[dk].shape)) for dk in dkeys]
        out["_stats_" + k] = jnp.concatenate(
            [d[dk].astype(jnp.int32).reshape(-1) for dk in dkeys])
    layout["i16_keys"] = i16_keys
    layout["i8_keys"] = i8_keys
    layout["i32_keys"] = i32_keys
    layout["bool_keys"] = b_keys
    layout["stat_keys"] = stat_keys
    layout["stats_shapes"] = stats_shapes
    # 4) accumulate mode: batch-reduced sums leave the per-batch transfer
    #    entirely — they concatenate into one int32 delta vector the step
    #    adds to a resident on-device accumulator, fetched ONCE per run
    #    (these are pure sums)
    if accum:
        acc_meta = []
        acc_parts = []
        aoff = 0
        for k in (list(k for k in sorted(out) if k.startswith("_stats_"))
                  + [k for k in _ACC_KEYS if k in out]):
            v = out.pop(k)
            flat = v.astype(jnp.int32).reshape(-1)
            n = int(flat.shape[0])
            acc_meta.append((k, tuple(v.shape), aoff, n))
            aoff += n
            acc_parts.append(flat)
        layout["acc"] = acc_meta
        layout["stat_keys"] = []  # per-batch unpack no longer sees stats
        out["_acc_delta"] = (jnp.concatenate(acc_parts) if acc_parts
                             else jnp.zeros((0,), jnp.int32))
    else:
        layout["acc"] = None
    delta = out.pop("_acc_delta", None)  # stays on device, never in the blob
    if mega == "sharded":
        out = _mega_pack_sharded(out, B, layout)
        layout.pop("mega", None)
    elif mega:
        out = _mega_pack(out, layout)
        layout.pop("mega_rows", None)
        layout.pop("mega_repl", None)
    else:
        for k in ("mega", "mega_rows", "mega_repl"):
            layout.pop(k, None)
    if delta is not None:
        out["_acc_delta"] = delta
    # per-shape registry: retracing at a new (B, width) must not invalidate
    # the layout of a shape that may still be dispatched later (a jit cache
    # hit does not re-run this code, so the flat entries alone go stale)
    layout[("shape", B, width)] = {
        k: layout[k] for k in ("i16_keys", "i8_keys", "i32_keys",
                               "bool_keys", "stat_keys", "stats_shapes",
                               "mega", "mega_rows", "mega_repl", "acc")
        if k in layout}
    return out


def unpack_from_host(out: dict, layout: dict) -> dict:
    """Inverse of pack_for_host on fetched numpy arrays."""
    import numpy as np
    out = dict(out)
    if "_blob" in out:
        blob = out.pop("_blob")
        for k, dt, shp, off, n in layout["mega"]:
            out[k] = blob[off:off + n].view(np.dtype(dt)).reshape(shp)
    if "_rows_blob" in out:
        rb = out.pop("_rows_blob")  # [B, M] uint8, dp-sharded on a mesh
        Bn = rb.shape[0]
        for k, dt, K, off, nb in layout["mega_rows"]:
            out[k] = np.ascontiguousarray(
                rb[:, off:off + K * nb]).view(np.dtype(dt)).reshape(Bn, K).T
    if "_repl_blob" in out:
        blob = out.pop("_repl_blob")
        for k, dt, shp, off, n in layout["mega_repl"]:
            out[k] = blob[off:off + n].copy().view(np.dtype(dt)).reshape(shp)
    if "_corr_rows" in out:
        m = out.pop("_corr_rows").astype(np.int32)
        out["c1_rows"], out["c2_rows"] = m[0], m[1]
        m = out.pop("_corr_pos").astype(np.int32)
        out["c1_pos"], out["c2_pos"] = m[0], m[1]
        m = out.pop("_corr_u8")
        for j, k in enumerate(("c1_base", "c1_qual", "c2_base", "c2_qual")):
            out[k] = m[j]
        m = out.pop("_corr_n")
        out["c1_count"], out["c2_count"], out["corrected_reads"] = m[0], m[1], m[2]
    for packed, lkey in (("_i16", "i16_keys"), ("_i32", "i32_keys")):
        if packed in out:
            m = out.pop(packed)
            for j, k in enumerate(layout[lkey]):
                out[k] = m[j]
    if "_i8" in out:
        m = out.pop("_i8").astype(np.int16)
        for j, k in enumerate(layout["i8_keys"]):
            out[k] = m[j] + _I8_BIAS
    if "_bool" in out:
        m = out.pop("_bool")
        for j, k in enumerate(layout["bool_keys"]):
            out[k] = ((m[j // 8] >> (j % 8)) & 1).astype(bool)
    for k in layout["stat_keys"]:
        shapes = layout["stats_shapes"][k]
        vec = out.pop("_stats_" + k)
        d = {}
        off = 0
        for dk, shp in shapes:
            n = 1
            for s in shp:
                n *= s
            d[dk] = vec[off:off + n].reshape(shp)
            off += n
        out[k] = d
    return out


def unpack_acc(acc_vec, layout: dict) -> dict:
    """Unpack the fetched run-level accumulator vector (accumulate mode)
    into the same keys a per-batch fetch would have carried: stat dicts
    (via stats_shapes) plus the named reduced arrays."""
    out = {}
    for k, shp, off, n in layout["acc"]:
        v = acc_vec[off:off + n].reshape(shp)
        if k.startswith("_stats_"):
            sk = k[len("_stats_"):]
            d = {}
            o = 0
            for dk, dshp in layout["stats_shapes"][sk]:
                m = 1
                for s in dshp:
                    m *= s
                d[dk] = v[o:o + m].reshape(dshp)
                o += m
            out[sk] = d
        else:
            out[k] = v
    return out


# per-read fields whose values are statically within [-64, 191] whenever
# the padded width is <= 190: these ship as bias-64 int8 (half of int16).
# ov_offset (can reach -(W-overlapRequire)) and ad_pos (can reach -adapter
# length) stay int16.
_I8_KEYS = frozenset((
    "rlen", "rlen1", "rlen2", "total_front", "total_front1", "total_front2",
    "result", "result1", "result2", "rlen_pre_adapter", "rlen_post_adapter",
    "rlen1_pre_adapter", "rlen1_post_adapter", "rlen2_pre_adapter",
    "rlen2_post_adapter", "rlen1_pre_ovtrim", "rlen2_pre_ovtrim",
    "ov_olen", "ov_diff"))
_I8_BIAS = 64


def _slim_outputs(out, B: int, L: int, extra_i8=()):
    """Downcast [B] int32 per-read outputs to int16 — and the statically
    byte-ranged ones to bias-64 int8 — when the read width guarantees they
    fit; the per-read matrix dominates D2H bytes.
    Row-index lists stay int32 (they index up to B).  `extra_i8` adds keys
    whose range the caller has proven byte-sized for this config (e.g.
    ad_pos when every adapter is <= 64 bases)."""
    if L > 32000 or _os.environ.get("FASTP_TPU_NO_SLIM"):
        return out
    # row-index lists also fit int16 whenever B does
    keep_i32 = () if B <= 32767 else ("c1_rows", "c2_rows")
    # int8 biasing is only invertible through unpack_from_host, which the
    # FASTP_TPU_NO_PACK escape hatch bypasses
    use_i8 = L <= 190 and not _os.environ.get("FASTP_TPU_NO_PACK")
    for k, v in list(out.items()):
        if (not isinstance(v, dict) and k not in keep_i32
                and getattr(v, "ndim", 0) == 1 and v.shape[0] == B
                and v.dtype == jnp.int32):
            if use_i8 and (k in _I8_KEYS or k in extra_i8):
                out[k] = (v - _I8_BIAS).astype(jnp.int8)
            else:
                out[k] = v.astype(jnp.int16)
    return out


import functools


def _max_adapter_len(cfg: DeviceCfg) -> int:
    lens = [len(cfg.adapter_seq1), len(cfg.adapter_seq2)]
    lens += [len(a) for a in cfg.fasta_adapters]
    return max(lens)


def _extra_i8_keys(cfg: DeviceCfg):
    # ad_pos ranges over [-adapter_len, width): bias-64 int8 covers
    # [-64, 191], so byte-sized whenever every adapter is <= 64 bases
    # (width <= 190 is checked per batch in _slim_outputs)
    if _max_adapter_len(cfg) <= 64:
        return ("ad_pos", "ad_pos1", "ad_pos2")
    return ()


def aux_arg_names(cfg: DeviceCfg):
    """Trailing per-batch aux args, statically derived from cfg.

    Masks that are dead by configuration (UMI pre-trims, index-filter
    drops, dedup verdicts) are synthesized as zeros at trace time instead
    of riding the H2D transfer; the [B] valid mask is always a contiguous
    prefix (padding is a suffix by construction in _pad_batch /
    pad_to_multiple), so a scalar count replaces it."""
    names = []
    if cfg.has_pretrim:
        names += ["pre_trim1", "pre_trim2"] if cfg.paired else ["pre_trim"]
    if cfg.has_index_drop:
        names.append("index_drop")
    if cfg.has_dedup:
        names.append("dedup_out")
    names.append("nvalid")
    return tuple(names)


def _expand_aux(cfg: DeviceCfg, B: int, aux):
    """Trace-side: reconstruct (pre1, pre2, idx, ded, valid) from aux."""
    d = dict(zip(aux_arg_names(cfg), aux))
    z32 = jnp.zeros((B,), jnp.int32)
    zb = jnp.zeros((B,), bool)
    pre1 = d.get("pre_trim1", d.get("pre_trim", z32))
    pre1 = pre1.astype(jnp.int32)
    pre2 = d.get("pre_trim2", z32)
    pre2 = pre2.astype(jnp.int32)
    idx = d.get("index_drop", zb)
    ded = d.get("dedup_out", zb)
    valid = jnp.arange(B, dtype=jnp.int32) < jnp.asarray(d["nvalid"],
                                                         jnp.int32)
    return pre1, pre2, idx, ded, valid


def make_aux(cfg: DeviceCfg, valid_or_n, pre_trim1=None, pre_trim2=None,
             index_drop=None, dedup_out=None):
    """Host-side twin of _expand_aux: build the numpy aux tuple.

    valid_or_n: the [B] valid mask (contiguous-prefix) or an int count.
    Pre-trims ship as int16 (UMI splices are short; halves the bytes)."""
    out = []
    if cfg.has_pretrim:
        out.append(np.asarray(pre_trim1, np.int16))
        if cfg.paired:
            out.append(np.asarray(pre_trim2, np.int16))
    if cfg.has_index_drop:
        out.append(index_drop)
    if cfg.has_dedup:
        out.append(dedup_out)
    n = (valid_or_n if isinstance(valid_or_n, (int, np.integer))
         else int(valid_or_n.sum()))
    out.append(np.int32(n))
    return tuple(out)


def length_dtype(width: int):
    """H2D dtype for per-read lengths: int16 halves the bytes whenever a
    row fits (width is static per compiled step, so the choice is too)."""
    return np.int16 if width <= 32000 else np.int32


def _finalize_step(inner, layout, accum, n_args: int):
    """Close a step builder over the accumulate mode.

    accum False: jit(inner) (status quo).  'spec': return the raw traced
    function — used only under jax.eval_shape to learn the accumulator
    length without compiling anything.  True / 'donate': the jitted step
    takes the resident accumulator as one extra trailing arg and returns
    (outputs, acc + delta); 'donate' additionally donates the old
    accumulator buffer (not supported on the CPU backend)."""
    if not accum:
        step = jax.jit(inner)
    elif accum == "spec":
        step = inner
    else:
        def with_acc(*args):
            out = inner(*args[:-1])
            delta = out.pop("_acc_delta")
            return out, args[-1] + delta
        step = jax.jit(with_acc,
                       donate_argnums=(n_args,) if accum == "donate" else ())
    step.layout = layout
    return step


@functools.lru_cache(maxsize=16)
def build_se_step(cfg: DeviceCfg, packed: bool = False, mega: bool = False,
                  accum=False):
    """Memoized on (cfg, packed, mega, accum): a resident process
    (``fastp_tpu serve``) reuses the jitted step and its compiled
    executable across runs, so the one-time compile is paid once per
    configuration, not once per job.  Bounded LRU: a
    server handling many distinct configurations evicts cold steps (letting
    their compiled executables be collected) instead of growing without
    limit."""
    fview = _FilterCfgView(cfg)
    layout = {}
    extra_i8 = _extra_i8_keys(cfg)
    acc_on = bool(accum)

    def se_step(bases, quals, lengths, pre_trim, index_drop, dedup_out, valid):
        pre = stats_ops.stat_batch(bases, quals, lengths, valid)
        w_b, w_q, rlen, alive, front_trimmed, total_front = _trim_one_end(
            bases, quals, lengths, pre_trim, cfg, is_r2=False)
        alive = alive & ~index_drop & valid
        if cfg.polyg_enabled:
            rlen = jnp.where(alive, polyx_ops.trim_polyg(w_b, rlen, cfg.polyg_min_len), rlen)
        rlen, ad = _apply_seq_adapters(w_b, rlen, alive, cfg, is_r2=False)
        rlen, polyx_reads, polyx_bases = _apply_polyx_maxlen(w_b, rlen, alive, cfg, False)
        result = filter_ops.pass_filter(w_b, w_q, rlen, alive, fview)
        passed = (result == PASS_FILTER) & alive
        emit = passed & ~dedup_out
        post = stats_ops.stat_batch(w_b, w_q, rlen, emit)
        B, L = bases.shape
        out = {
            "pre": pre, "post": post,
            "total_front": total_front,
            "rlen": rlen,
            "result": result,
            "alive": alive,
            "emit": emit,
            "ad_found": ad["ad_found"],
            "ad_pos": ad["ad_pos"],
            "rlen_pre_adapter": ad["rlen_pre_adapter"],
            "rlen_post_adapter": ad["rlen_post_adapter"],
            "polyx_reads": polyx_reads,
            "polyx_bases": polyx_bases,
        }
        if cfg.lean:
            # per-read result codes reduce to the counting histogram the
            # host would build (add_filter_result_array over ~index_drop);
            # `alive` only feeds the --failed_out path, excluded by lean
            counted = valid & ~index_drop
            out["result_hist"] = jnp.zeros((FILTER_RESULT_TYPES,), jnp.int32) \
                .at[jnp.where(counted, result, 0)] \
                .add(counted.astype(jnp.int32))
            del out["result"], out["alive"]
            if not cfg.adapter_enabled:
                for k in ("ad_found", "ad_pos", "rlen_pre_adapter",
                          "rlen_post_adapter"):
                    del out[k]
            # total_front is statically pre_trim unless a front trim/cut
            # can move the window start on device (runner synthesizes it)
            if cfg.front1 == 0 and not cfg.enabledFront:
                del out["total_front"]
        return pack_for_host(_slim_outputs(out, B, L, extra_i8),
                             B, layout, mega, L, acc_on)

    n_aux = len(aux_arg_names(cfg))
    if packed == "p3":
        def p3_step(bp, qp, ei, eb, eq, qlut, lengths, *aux):
            lengths = lengths.astype(jnp.int32)
            bases, quals = _unpack_p3(bp, qp, qlut, lengths, ei, eb, eq)
            pre, _, idx, ded, valid = _expand_aux(cfg, bp.shape[0], aux)
            return se_step(bases, quals, lengths, pre, idx, ded, valid)
        inner, n_args = p3_step, 7 + n_aux
    elif packed == "nib":
        def nib_step(p, qlut, ei, eb, eq, lengths, *aux):
            lengths = lengths.astype(jnp.int32)
            bases, quals = _unpack_nib(p, qlut, lengths, ei, eb, eq)
            pre, _, idx, ded, valid = _expand_aux(cfg, p.shape[0], aux)
            return se_step(bases, quals, lengths, pre, idx, ded, valid)
        inner, n_args = nib_step, 6 + n_aux
    elif packed:
        def packed_step(p, ei, eb, eq, lengths, *aux):
            lengths = lengths.astype(jnp.int32)
            bases, quals = _unpack_bq(p, ei, eb, eq)
            pre, _, idx, ded, valid = _expand_aux(cfg, p.shape[0], aux)
            return se_step(bases, quals, lengths, pre, idx, ded, valid)
        inner, n_args = packed_step, 5 + n_aux
    else:
        def plain_step(bases, quals, lengths, *aux):
            lengths = lengths.astype(jnp.int32)
            pre, _, idx, ded, valid = _expand_aux(cfg, bases.shape[0], aux)
            return se_step(bases, quals, lengths, pre, idx, ded, valid)
        inner, n_args = plain_step, 3 + n_aux
    return _finalize_step(inner, layout, accum, n_args)


def _unpack_nib(p, qlut, lengths, idx, base, qual):
    """Invert the host 4-bit packer (native pack_nib): each nibble is
    qcode*4 + bcode (low nibble = even position); bases decode through a
    fixed ACGT LUT and quals through the per-run learned dictionary qlut
    (u8[4]); pad re-zeroes from the length mask; exceptions scatter raw
    (base, qual) bytes back in."""
    B, Wh = p.shape
    W = Wh * 2
    lo = p & 15
    hi = p >> 4
    codes = jnp.stack([lo, hi], axis=-1).reshape(B, W).astype(jnp.int32)
    blut = jnp.array([65, 67, 71, 84], jnp.uint8)
    b = blut[codes & 3]
    q = qlut[codes >> 2]
    m = jnp.arange(W, dtype=jnp.int32)[None, :] < lengths[:, None]
    b = jnp.where(m, b, 0)
    q = jnp.where(m, q, 0)
    b = b.reshape(-1).at[idx].set(base, mode="drop").reshape(B, W)
    q = q.reshape(-1).at[idx].set(qual, mode="drop").reshape(B, W)
    return b, q


def _unpack_p3(bp, qp, qlut, lengths, idx, base, qual):
    """Invert the host 3-bit planar packer (native pack_p3): bp holds 2-bit
    base codes (4 positions/byte, position 0 in bits 0-1) decoding through
    a fixed ACGT LUT; qp holds 1 bit/position (8/byte) indexing the 2-entry
    learned qual dictionary qlut (u8[2]); pad re-zeroes from the length
    mask; exceptions scatter raw (base, qual) bytes back in."""
    B, Wb = bp.shape
    W = Wb * 4
    bcodes = jnp.stack([(bp >> (2 * k)) & 3 for k in range(4)],
                       axis=-1).reshape(B, W).astype(jnp.int32)
    blut = jnp.array([65, 67, 71, 84], jnp.uint8)
    b = blut[bcodes]
    qbits = jnp.stack([(qp >> k) & 1 for k in range(8)],
                      axis=-1).reshape(B, W).astype(jnp.int32)
    q = qlut[qbits]
    m = jnp.arange(W, dtype=jnp.int32)[None, :] < lengths[:, None]
    b = jnp.where(m, b, 0)
    q = jnp.where(m, q, 0)
    b = b.reshape(-1).at[idx].set(base, mode="drop").reshape(B, W)
    q = q.reshape(-1).at[idx].set(qual, mode="drop").reshape(B, W)
    return b, q


def _unpack_bq(p, idx, base, qual):
    """Invert the host packer (native pack_bq): packed = (q-33)*5 + code,
    255 = pad; exceptions scatter raw (base, qual) bytes back in."""
    B, W = p.shape
    is_pad = p == 255
    q = jnp.where(is_pad, 0, (p // 5) + 33).astype(jnp.uint8)
    lut = jnp.array([65, 67, 71, 84, 78], jnp.uint8)
    b = jnp.where(is_pad, 0, lut[(p % 5).astype(jnp.int32)])
    b = b.reshape(-1).at[idx].set(base, mode="drop").reshape(B, W)
    q = q.reshape(-1).at[idx].set(qual, mode="drop").reshape(B, W)
    return b, q


@functools.lru_cache(maxsize=16)
def build_pe_step(cfg: DeviceCfg, packed: bool = False, mega: bool = False,
                  accum=False):
    """Memoized on (cfg, packed, mega, accum) — see build_se_step."""
    fview = _FilterCfgView(cfg)
    layout = {}
    extra_i8 = _extra_i8_keys(cfg)
    acc_on = bool(accum)
    # mega == "sharded" <=> the step runs partitioned over a device mesh:
    # the overlap sweep must use its row-local (partition-friendly)
    # formulation — see ops/overlap.py:analyze(spmd=)
    spmd = mega == "sharded"

    def pe_step(b1, q1, l1, b2, q2, l2, pre_trim1, pre_trim2, index_drop,
                dedup_out, valid):
        B, L = b1.shape
        pre1 = stats_ops.stat_batch(b1, q1, l1, valid)
        pre2 = stats_ops.stat_batch(b2, q2, l2, valid)

        w1, wq1, rlen1, alive1, ft1, tf1 = _trim_one_end(b1, q1, l1, pre_trim1, cfg, False)
        w2, wq2, rlen2, alive2, ft2, tf2 = _trim_one_end(b2, q2, l2, pre_trim2, cfg, True)
        alive1 = alive1 & ~index_drop & valid
        alive2 = alive2 & ~index_drop & valid
        both = alive1 & alive2

        if cfg.polyg_enabled:
            rlen1 = jnp.where(both, polyx_ops.trim_polyg(w1, rlen1, cfg.polyg_min_len), rlen1)
            rlen2 = jnp.where(both, polyx_ops.trim_polyg(w2, rlen2, cfg.polyg_min_len), rlen2)

        out = {}
        corr_matrix = jnp.zeros((64,), jnp.int32)
        corrected = jnp.zeros((B,), jnp.int32)
        r1c = jnp.zeros((B,), bool)
        r2c = jnp.zeros((B,), bool)
        ov_trimmed = jnp.zeros((B,), bool)
        rlen1_pre_ovtrim = rlen1
        rlen2_pre_ovtrim = rlen2

        # clean-alphabet flag: ACGTN/pad everywhere -> where the platform's
        # sweep is the conv (ops/overlap.py), it runs as exact one-hot
        # cross-correlations; any other byte (lowercase, IUPAC) falls back
        # to the byte-exact offset loop
        def _acgtn(x):
            return ((x == 0) | (x == 65) | (x == 67) | (x == 71)
                    | (x == 84) | (x == 78))
        # spmd: the loop path needs no clean/dirty cond
        clean = None if spmd else jnp.all(_acgtn(b1)) & jnp.all(_acgtn(b2))

        need_ov = cfg.adapter_enabled or cfg.correction_enabled
        ov = overlap_ops.analyze(w1, rlen1, w2, rlen2,
                                 cfg.overlap_diff_limit, cfg.overlap_require,
                                 cfg.overlap_diff_pct,
                                 cfg.allow_gap_overlap if need_ov else False,
                                 clean=clean, spmd=spmd)
        ov_ok = ov["overlapped"] & both

        # insert size (reference: statInsertSize, src/peprocessor.cpp:698-711)
        isize = jnp.where(
            ov_ok,
            jnp.where(ov["offset"] > 0,
                      rlen1 + rlen2 - ov["overlap_len"] + ft1 + ft2,
                      ov["overlap_len"] + ft1 + ft2),
            cfg.insert_size_max)
        isize = jnp.minimum(isize, cfg.insert_size_max)
        isize_hist = jnp.zeros((cfg.insert_size_max + 1,), jnp.int32).at[
            jnp.where(both, isize, cfg.insert_size_max)].add(both.astype(jnp.int32))

        # sparse-correction slot budget scales with batch so realistic
        # error rates never overflow into the per-row host recompute
        # (FASTP_TPU_CORR_CAP: test hook to force the overflow fallback).
        # B//8 sits about 2x above the NovaSeq-binned synthetic corpus's
        # count (~3.7k/side at 64k pairs) without shipping a D2H slot per
        # row
        CORR_C = (int(_os.environ.get("FASTP_TPU_CORR_CAP", "0"))
                  or max(2048, B // 8))
        if cfg.correction_enabled:
            do = ov_ok & ~ov["has_gap"]
            (w1, wq1, w2, wq2, corr_matrix, corrected, r1c, r2c, masks) = \
                correct_ops.correct_by_overlap(
                    w1, wq1, rlen1, w2, wq2, rlen2,
                    do, ov["offset"], ov["overlap_len"], ov["diff"])
            if spmd:
                # mesh path: the batch-level sparse compaction is a GLOBAL
                # nonzero (cumsum over [B*W]) that GSPMD can only realize
                # with all-gathers + cross-shard all-reduces of the [C]
                # slot arrays (measured 12.5s vs 0.85s per 2048-row batch
                # on an 8-device host mesh).  Per-ROW top-K extraction is
                # shard-local and rides the dp-sharded rows blob; rows
                # with count > K fall back to the exact host recompute.
                K = int(_os.environ.get("FASTP_TPU_CORR_K", "12"))
                p1, b1d, q1d, c1 = correct_ops.extract_deltas(
                    masks["mask1"], w1, wq1, K)
                p2, b2d, q2d, c2 = correct_ops.extract_deltas(
                    masks["mask2"], w2, wq2, K)
                ldt = jnp.int16 if L <= 32000 else jnp.int32
                out["c1k_pos"] = p1.T.astype(ldt)
                out["c2k_pos"] = p2.T.astype(ldt)
                out["c1k_u8"] = jnp.concatenate([b1d, q1d], axis=1).T
                out["c2k_u8"] = jnp.concatenate([b2d, q2d], axis=1).T
                out["c1k_cnt"] = c1
                out["c2k_cnt"] = c2
            else:
                (out["c1_rows"], out["c1_pos"], out["c1_base"],
                 out["c1_qual"], out["c1_count"]) = \
                    correct_ops.extract_deltas_sparse(
                        masks["mask1"], w1, wq1, CORR_C)
                (out["c2_rows"], out["c2_pos"], out["c2_base"],
                 out["c2_qual"], out["c2_count"]) = \
                    correct_ops.extract_deltas_sparse(
                        masks["mask2"], w2, wq2, CORR_C)
            # corrected-read counter, reduced on device
            # (reference: src/peprocessor.cpp:440-443 via FilterResult)
            corr_any = corrected > 0
            both_c = r1c & r2c
            out["corrected_reads"] = (
                2 * jnp.sum(corr_any & both_c, dtype=jnp.int32)
                + jnp.sum(corr_any & ~both_c, dtype=jnp.int32))

        if cfg.adapter_enabled:
            nl1, nl2, ov_trimmed = adapter_ops.trim_by_overlap(
                rlen1, rlen2, ov_ok, ov["offset"], ov["overlap_len"], ft1, ft2)
            rlen1 = jnp.where(both, nl1, rlen1)
            rlen2 = jnp.where(both, nl2, rlen2)
            ov_trimmed = ov_trimmed & both

        rlen1, ad1 = _apply_seq_adapters(w1, rlen1, both, cfg, False, ov_trimmed)
        rlen2, ad2 = _apply_seq_adapters(w2, rlen2, both, cfg, True, ov_trimmed)

        # overlapped_out: re-analysis with diff percent 0 on the
        # adapter-trimmed (pre-polyX) reads (src/peprocessor.cpp:461-468)
        if cfg.overlapped_out:
            ov0 = overlap_ops.analyze(w1, rlen1, w2, rlen2,
                                      cfg.overlap_diff_limit, cfg.overlap_require,
                                      0.0, clean=clean, spmd=spmd)
            out["ov0_ok"] = ov0["overlapped"] & both
            out["ov0_offset"] = ov0["offset"]
            out["ov0_len"] = ov0["overlap_len"]

        rlen1, px_r1, px_b1 = _apply_polyx_maxlen(w1, rlen1, both, cfg, False)
        rlen2, px_r2, px_b2 = _apply_polyx_maxlen(w2, rlen2, both, cfg, True)

        # merge-mode overlap analysis on the final trimmed reads
        if cfg.merge_enabled:
            ovm = overlap_ops.analyze(w1, rlen1, w2, rlen2,
                                      cfg.overlap_diff_limit, cfg.overlap_require,
                                      cfg.overlap_diff_pct, False, clean=clean,
                                      spmd=spmd)
            ovm_ok = ovm["overlapped"] & both
            m_seq, m_qual, m_len, m_len1, m_len2 = merge_ops.merge_pairs(
                w1, wq1, rlen1, w2, wq2, rlen2,
                ovm_ok, ovm["offset"], ovm["overlap_len"], out_width=2 * L)
            m_result = filter_ops.pass_filter(m_seq, m_qual, m_len, ovm_ok, fview)
            m_emit = ovm_ok & (m_result == PASS_FILTER)
            out["merged_ok"] = ovm_ok
            out["m_len"] = m_len
            out["m_len1"] = m_len1
            out["m_len2"] = m_len2
            out["m_result"] = m_result
            out["m_emit"] = m_emit
            out["ovm_olen"] = ovm["overlap_len"]
            out["post_merged"] = stats_ops.stat_batch(m_seq, m_qual, m_len, m_emit)

        result1 = filter_ops.pass_filter(w1, wq1, rlen1, alive1, fview)
        result2 = filter_ops.pass_filter(w2, wq2, rlen2, alive2, fview)
        pass1 = (result1 == PASS_FILTER) & alive1
        pass2 = (result2 == PASS_FILTER) & alive2
        emit_pair = pass1 & pass2 & ~dedup_out & ~index_drop
        post1 = stats_ops.stat_batch(w1, wq1, rlen1, emit_pair)
        post2 = stats_ops.stat_batch(w2, wq2, rlen2, emit_pair)

        if cfg.merge_enabled and cfg.merge_include_unmerged:
            # per-mate post stats for unmerged survivors, which the host
            # adds into the merged-stream stats (reference statRead calls at
            # src/peprocessor.cpp:503,513 feed getPostStats1 for both mates)
            not_merged = ~out["merged_ok"] & ~dedup_out & alive1 & alive2
            out["post_um1"] = stats_ops.stat_batch(
                w1, wq1, rlen1, not_merged & pass1)
            out["post_um2"] = stats_ops.stat_batch(
                w2, wq2, rlen2, not_merged & pass2)

        out.update({
            "pre1": pre1, "pre2": pre2, "post1": post1, "post2": post2,
            "ov_offset": ov["offset"], "ov_olen": ov["overlap_len"],
            "ov_ok": ov_ok, "ov_hasgap": ov["has_gap"], "ov_diff": ov["diff"],
            "total_front1": tf1, "total_front2": tf2,
            "rlen1": rlen1, "rlen2": rlen2,
            "result1": result1, "result2": result2,
            "alive1": alive1, "alive2": alive2,
            "pass1": pass1, "pass2": pass2,
            "emit_pair": emit_pair,
            "ov_trimmed": ov_trimmed,
            "rlen1_pre_ovtrim": rlen1_pre_ovtrim,
            "rlen2_pre_ovtrim": rlen2_pre_ovtrim,
            "ad_found1": ad1["ad_found"], "ad_pos1": ad1["ad_pos"],
            "ad_found2": ad2["ad_found"], "ad_pos2": ad2["ad_pos"],
            # (rlen{1,2}_post_adapter are not exported: unlike the SE
            # runner's recording loop, no PE host stage reads them)
            "rlen1_pre_adapter": ad1["rlen_pre_adapter"],
            "rlen2_pre_adapter": ad2["rlen_pre_adapter"],
            "polyx_reads": px_r1 + px_r2,
            "polyx_bases": px_b1 + px_b2,
            "isize_hist": isize_hist,
            "corr_matrix": corr_matrix,
        })
        if cfg.lean:
            # per-read result codes reduce to the exact counting histogram
            # route_pe builds (max(r1,r2) weighted 2 over ~index_drop rows);
            # fields that only feed the --failed_out / fallback branches
            # (excluded by lean) stay on device, and the overlap /
            # adapter-recording scalars ship only for the configs whose host
            # stage reads them
            counted = valid & ~index_drop
            hist = jnp.zeros((FILTER_RESULT_TYPES,), jnp.int32)
            if cfg.merge_enabled:
                # merge-mode counting (route_pe's three row classes):
                # merged rows count m_result x2; include_unmerged rows count
                # result1 and result2 x1 each; the rest count max(r1,r2) x2.
                # merged_ok already embeds counted (alive1/2 include
                # ~index_drop & valid), so mm == merged_ok.
                mm = out["merged_ok"]
                if cfg.merge_include_unmerged:
                    um = alive1 & alive2 & ~mm
                else:
                    um = jnp.zeros((B,), bool)
                normal = counted & ~(mm | um)
                hist = hist.at[jnp.where(mm, out["m_result"], 0)] \
                    .add(jnp.where(mm, 2, 0))
                if cfg.merge_include_unmerged:
                    um32 = um.astype(jnp.int32)
                    hist = hist.at[jnp.where(um, result1, 0)].add(um32)
                    hist = hist.at[jnp.where(um, result2, 0)].add(um32)
                    r1ok = alive1 & (result1 == PASS_FILTER)
                    r2ok = alive2 & (result2 == PASS_FILTER)
                    # the unmerged-survivor emit bits route_pe needs (1 bit
                    # each on the packed bool word) + the read_passed
                    # contribution as a batch scalar
                    out["um_emit1"] = um & r1ok & ~dedup_out
                    out["um_emit2"] = um & r2ok & ~dedup_out
                    out["um_both_pass"] = jnp.sum(
                        um & r1ok & r2ok, dtype=jnp.int32)[None]
                hist = hist.at[
                    jnp.where(normal, jnp.maximum(result1, result2), 0)] \
                    .add(jnp.where(normal, 2, 0))
                # route_pe derives everything else from m_emit/normal/pass*:
                # the wide per-read merge fields stay on device
                out["normal"] = normal
                for k in ("m_result", "m_len", "merged_ok", "post1",
                          "post2"):
                    del out[k]
            else:
                hist = hist.at[
                    jnp.where(counted, jnp.maximum(result1, result2), 0)] \
                    .add(jnp.where(counted, 2, 0))
            out["result_hist"] = hist
            for k in ("result1", "result2", "alive1", "alive2", "emit_pair"):
                del out[k]
            # the five per-read overlap fields only serve the sparse-
            # correction overflow fallback; a 1-bit corr_able flag (free:
            # it rides the existing bool word) plus an exact host overlap
            # re-analysis (hostview.host_analyze_overlap) replaces them
            if cfg.correction_enabled:
                out["corr_able"] = (out["ov_ok"] & ~out["ov_hasgap"]
                                    & (out["ov_diff"] != 0))
            for k in ("ov_offset", "ov_olen", "ov_diff", "ov_ok",
                      "ov_hasgap"):
                del out[k]
            if not (cfg.adapter_enabled or cfg.correction_enabled):
                del out["rlen1_pre_ovtrim"], out["rlen2_pre_ovtrim"]
            if not cfg.adapter_enabled:
                for k in ("ov_trimmed", "ad_found1", "ad_pos1", "ad_found2",
                          "ad_pos2", "rlen1_pre_adapter",
                          "rlen2_pre_adapter"):
                    del out[k]
            # total_front is statically pre_trim (host-known) unless a
            # front trim/cut can move the window start on device
            if cfg.front1 == 0 and not cfg.enabledFront:
                del out["total_front1"]
            if cfg.front2 == 0 and not cfg.enabledFront:
                del out["total_front2"]
        return pack_for_host(_slim_outputs(out, B, L, extra_i8),
                             B, layout, mega, L, acc_on)

    n_aux = len(aux_arg_names(cfg))
    if packed == "p3":
        def p3_step(bp1, qp1, e1i, e1b, e1q, bp2, qp2, e2i, e2b, e2q,
                    qlut, l1, l2, *aux):
            l1 = l1.astype(jnp.int32)
            l2 = l2.astype(jnp.int32)
            b1, q1 = _unpack_p3(bp1, qp1, qlut, l1, e1i, e1b, e1q)
            b2, q2 = _unpack_p3(bp2, qp2, qlut, l2, e2i, e2b, e2q)
            pre1, pre2, idx, ded, valid = _expand_aux(cfg, bp1.shape[0], aux)
            return pe_step(b1, q1, l1, b2, q2, l2, pre1, pre2,
                           idx, ded, valid)
        inner, n_args = p3_step, 13 + n_aux
    elif packed == "nib":
        def nib_step(p1, e1i, e1b, e1q, p2, e2i, e2b, e2q, qlut, l1, l2,
                     *aux):
            l1 = l1.astype(jnp.int32)
            l2 = l2.astype(jnp.int32)
            b1, q1 = _unpack_nib(p1, qlut, l1, e1i, e1b, e1q)
            b2, q2 = _unpack_nib(p2, qlut, l2, e2i, e2b, e2q)
            pre1, pre2, idx, ded, valid = _expand_aux(cfg, p1.shape[0], aux)
            return pe_step(b1, q1, l1, b2, q2, l2, pre1, pre2,
                           idx, ded, valid)
        inner, n_args = nib_step, 11 + n_aux
    elif packed:
        def packed_step(p1, e1i, e1b, e1q, p2, e2i, e2b, e2q, l1, l2, *aux):
            l1 = l1.astype(jnp.int32)
            l2 = l2.astype(jnp.int32)
            b1, q1 = _unpack_bq(p1, e1i, e1b, e1q)
            b2, q2 = _unpack_bq(p2, e2i, e2b, e2q)
            pre1, pre2, idx, ded, valid = _expand_aux(cfg, p1.shape[0], aux)
            return pe_step(b1, q1, l1, b2, q2, l2, pre1, pre2,
                           idx, ded, valid)
        inner, n_args = packed_step, 10 + n_aux
    else:
        def plain_step(b1, q1, l1, b2, q2, l2, *aux):
            l1 = l1.astype(jnp.int32)
            l2 = l2.astype(jnp.int32)
            pre1, pre2, idx, ded, valid = _expand_aux(cfg, b1.shape[0], aux)
            return pe_step(b1, q1, l1, b2, q2, l2, pre1, pre2,
                           idx, ded, valid)
        inner, n_args = plain_step, 6 + n_aux
    return _finalize_step(inner, layout, accum, n_args)
