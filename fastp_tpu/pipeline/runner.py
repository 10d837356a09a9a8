"""Streaming SE/PE processors: host IO <-> device pipeline.

Replaces the reference's reader/worker/writer thread fabric
(reference: src/seprocessor.cpp, src/peprocessor.cpp) with a batched
pipeline: decode batch -> one jitted device step -> serialize/emit.
Output order is input order (equivalent to the reference, whose writer
threads consume per-worker queues in pack order).
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional

import numpy as np

from ..config import Options, PASS_FILTER, FAILED_TYPES, FILTER_RESULT_TYPES
from ..io.fastq import (FastqReader, OutputWriter, encode_batch,
                        open_batch_reader)
from ..duplicate import Duplicate
from ..umi import UmiProcessor
from ..utils.readname import fix_mgi, first_index, last_index
from ..report.stats_model import Stats
from ..report.filter_model import FilterResult
from ..report.jsonreport import JsonReporter
from ..report.htmlreport import HtmlReporter
from .static_cfg import device_cfg_from_options
from .device import build_se_step, build_pe_step


def _round_width(n: int) -> int:
    return max(32, -(-n // 32) * 32)


def _index_match(blacklist: List[str], target: bytes, threshold: int) -> bool:
    """reference: src/filter.cpp:242-258"""
    t = target.decode("latin-1")
    for item in blacklist:
        diff = 0
        ok = True
        for s in range(min(len(item), len(t))):
            if item[s] != t[s]:
                diff += 1
                if diff > threshold:
                    ok = False
                    break
        if ok and diff <= threshold:
            return True
    return False


def _padded_slice_matrix(ba: np.ndarray, rows: np.ndarray,
                         lo: np.ndarray, hi: np.ndarray):
    """(mat [n, maxL] u8 zero-padded, L [n]) for slices ba[rows, lo:hi]."""
    W = ba.shape[1]
    L = np.maximum(hi - lo, 0).astype(np.int64)
    maxL = int(L.max()) if L.size else 0
    if maxL == 0:
        return np.zeros((len(rows), 0), np.uint8), L
    j = np.arange(maxL)
    idx = np.clip(lo.astype(np.int64)[:, None] + j[None, :], 0, W - 1)
    mat = np.where(j[None, :] < L[:, None], ba[rows[:, None], idx], 0)
    return mat.astype(np.uint8, copy=False), L


def _unique_rows(mat: np.ndarray):
    """np.unique over whole rows via a void view; returns
    (first_indices, counts, row_getter)."""
    m = np.ascontiguousarray(mat)
    if m.shape[1] == 0:
        return (np.zeros(1 if len(m) else 0, np.int64),
                np.array([len(m)] if len(m) else [], np.int64))
    v = m.view(np.dtype((np.void, m.shape[1]))).reshape(-1)
    _, first, counts = np.unique(v, return_index=True, return_counts=True)
    return first.astype(np.int64), counts.astype(np.int64)


def group_slices(ba: np.ndarray, rows: np.ndarray,
                 lo: np.ndarray, hi: np.ndarray):
    """Group the variable-length row slices ba[rows[k], lo[k]:hi[k]].

    Returns [(pos, bytes, count)] in first-occurrence order (pos = index
    within `rows`), so count-aware FilterResult adds replay the exact
    sequential insertion order.  Batches repeat the same few adapter
    strings thousands of times; ONE padded gather + ONE whole-row
    np.unique replaces the per-row Python loop (the slice length rides in
    the key header, so zero padding cannot alias across lengths)."""
    mat, L = _padded_slice_matrix(ba, rows, lo, hi)
    hdr = L.astype("<u2")[:, None].view(np.uint8).reshape(len(rows), 2)
    first, counts = _unique_rows(np.hstack([hdr, mat]))
    out = [(int(f), mat[f, :int(L[f])].tobytes(), int(c))
           for f, c in zip(first, counts)]
    out.sort(key=lambda t: t[0])
    return out


def group_pair_slices(ba1, lo1, hi1, ba2, lo2, hi2, rows):
    """Pair variant of group_slices: groups by the concatenated
    (slice1, slice2) content.  Returns [(pos, bytes1, bytes2, count)] in
    first-occurrence order."""
    m1, L1 = _padded_slice_matrix(ba1, rows, lo1, hi1)
    m2, L2 = _padded_slice_matrix(ba2, rows, lo2, hi2)
    hdr = np.stack([L1, L2], axis=1).astype("<u2").view(np.uint8) \
        .reshape(len(rows), 4)
    first, counts = _unique_rows(np.hstack([hdr, m1, m2]))
    out = [(int(f), m1[f, :int(L1[f])].tobytes(),
            m2[f, :int(L2[f])].tobytes(), int(c))
           for f, c in zip(first, counts)]
    out.sort(key=lambda t: t[0])
    return out


class _OverRepCounter:
    """Overrepresented-sequence counting on sampled reads
    (reference: src/stats.cpp:312-329).  Scanning runs in the native
    library when available (hash probes per position are the hot part);
    accumulated counts fold back into the Stats dicts via flush()."""

    def __init__(self, stats: Stats, opt: Options):
        self.stats = stats
        self.sampling = opt.overRepAnalysis.sampling
        self.enabled = opt.overRepAnalysis.enabled and len(stats.overrep) > 0
        self.eval_len = stats.evaluated_seq_len
        self._h = None
        if self.enabled:
            from ..io import native as native_mod
            lib = native_mod.get_lib()
            if lib is not None:
                self._lib = lib
                self._keys = [k.encode("latin-1") for k in stats.overrep]
                lens = np.array([len(k) for k in self._keys], np.int32)
                offs = np.zeros(len(self._keys), np.int64)
                np.cumsum(lens[:-1], out=offs[1:])
                blob = np.frombuffer(b"".join(self._keys), np.uint8)
                steps = np.array([10, 20, 40, 100,
                                  min(150, self.eval_len - 2)], np.int32)
                self._h = lib.ora_create(blob, offs, lens, len(self._keys),
                                         self.eval_len, steps, len(steps))
                self._counts = np.zeros(len(self._keys), np.int64)
                self._dist = np.zeros((len(self._keys), self.eval_len), np.int64)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ora_destroy(self._h)
            self._h = None

    def _scan(self, seq: bytes):
        """Pure-Python scan of one read (fallback path)."""
        st = self.stats
        rlen = len(seq)
        steps = (10, 20, 40, 100, min(150, self.eval_len - 2))
        for step in steps:
            i = 0
            while i < rlen - step:
                k = seq[i:i + step].decode("latin-1")
                if k in st.overrep:
                    st.overrep[k] += 1
                    dist = st.overrep_dist[k]
                    for p in range(i, min(i + step, self.eval_len)):
                        dist[p] += 1
                    i += step
                i += 1

    def stat_read(self, seq: bytes, read_index: int):
        if not self.enabled or read_index % self.sampling != 0:
            return
        if self._h is not None:
            b = np.frombuffer(seq, np.uint8).reshape(1, -1)
            self._lib.ora_stat_batch(
                self._h, np.ascontiguousarray(b), b.shape[1],
                np.zeros(1, np.int32), np.array([len(seq)], np.int32),
                np.zeros(1, np.int32), 1, self._counts, self._dist)
        else:
            self._scan(seq)

    def stat_rows(self, bases: np.ndarray, start, rlen, rows: np.ndarray):
        """Scan the selected (already sampled) rows of a padded batch."""
        if not self.enabled or rows.size == 0:
            return
        if self._h is not None:
            self._lib.ora_stat_batch(
                self._h, np.ascontiguousarray(bases), bases.shape[1],
                np.ascontiguousarray(start, np.int32),
                np.ascontiguousarray(rlen, np.int32),
                np.ascontiguousarray(rows, np.int32), rows.size,
                self._counts, self._dist)
        else:
            for i in rows.tolist():
                s0 = int(start[i])
                self._scan(bases[i, s0:s0 + int(rlen[i])].tobytes())

    def flush(self):
        """Fold native accumulators into the Stats dicts (idempotent)."""
        if self._h is None or not self.enabled:
            return
        st = self.stats
        for ki, key in enumerate(self._keys):
            c = int(self._counts[ki])
            if c:
                k = key.decode("latin-1")
                st.overrep[k] += c
                st.overrep_dist[k] += self._dist[ki]
        self._counts[:] = 0
        self._dist[:] = 0


class BaseProcessor:
    def __init__(self, opt: Options):
        self.opt = opt
        self.cfg = device_cfg_from_options(opt)
        self.umi = UmiProcessor(opt)
        from ..parallel import multihost
        # one shard of a multi-process run: dedup verdicts come from the
        # exact cross-shard pre-pass, the adapter maps are logged for the
        # in-order replay at merge, and _finish merges every shard's stats
        self.sharded = multihost.active()
        self.duplicate = None
        if opt.duplicate.enabled:
            pre = (multihost.exact_dedup_verdicts(opt)
                   if self.sharded else None)
            self.duplicate = Duplicate(opt, precomputed=pre)
        self.width = _round_width(max(opt.seqLen1, opt.seqLen2, 32))
        import jax
        from ..parallel.mesh import make_mesh, build_sharded_step
        n_dev = opt.deviceCount or jax.local_device_count()
        self.mesh = make_mesh(n_dev) if n_dev > 1 else None
        self.n_dev = n_dev if self.mesh is not None else 1
        # single fused D2H buffer off-mesh; on a mesh: one dp-sharded
        # per-read blob (one D2H buffer per device) + one replicated
        # stats blob (_mega_pack_sharded)
        self._mega = True if self.mesh is None else "sharded"
        # accumulate mode: batch-reduced stat sums stay in a resident
        # on-device accumulator (one fetch per RUN, not per batch).  Off on
        # a mesh (stats replicate across
        # shards there).  Merge mode accumulates only on the native routed
        # path: the pure-Python fallback stats unmerged survivors per row
        # on the host, which would double-count device post_um dicts.
        import os as _os
        from ..io import native as _native
        self._accum = False
        merge_ok = not opt.merge.enabled or _native.get_lib() is not None
        if (self.mesh is None and merge_ok
                and not _os.environ.get("FASTP_TPU_NO_ACCUM")
                and not _os.environ.get("FASTP_TPU_NO_PACK")):
            self._accum = ("donate" if jax.default_backend() != "cpu"
                           else True)
        self._acc_state = {}

    def _wrap_step(self, step_fn):
        if self.mesh is None:
            return step_fn
        from ..parallel.mesh import build_sharded_step
        return build_sharded_step(step_fn, self.mesh, 0)

    def _call_step(self, step, spec_builder, width: int, args):
        """Invoke a device step, chaining the on-device accumulator in
        accumulate mode.  Runs on the single upload worker, so the
        per-(step, width) accumulator handoff is ordered."""
        if not self._accum:
            return step(*args)
        import jax
        st = self._acc_state.setdefault(id(step), {})
        ent = st.get(width)
        if ent is None:
            # learn the accumulator length without compiling anything: the
            # acc-less 'spec' twin populates its layout under eval_shape
            spec = spec_builder()
            jax.eval_shape(spec, *args)
            meta = spec.layout["acc"]
            n = (meta[-1][2] + meta[-1][3]) if meta else 0
            acc = jax.device_put(np.zeros(n, np.int32))
            ent = st[width] = [acc, None, 0]
        out, ent[0] = step(*args, ent[0])
        if ent[1] is None:
            B = args[0].shape[0]  # batch-major leading arg
            ent[1] = step.layout.get(("shape", B, width)) or dict(step.layout)
        return out

    def _fold_accs(self):
        """Fetch every accumulator chain (ONE D2H per chain — normally one
        per run) and yield its unpacked value dict.  Callers feed each dict
        through the same add_batch/... calls a per-batch fetch used, so the
        existing width-growth logic applies.  Empty when accumulate mode is
        off."""
        if not self._accum or not self._acc_state:
            return []
        import jax
        from .device import unpack_acc
        out = []
        for st in self._acc_state.values():
            for acc, snap, _ in st.values():
                if snap is not None:  # None: chain never ran a real batch
                    out.append(unpack_acc(jax.device_get(acc), snap))
        self._acc_state = {}
        return out

    def _cpu_backend(self) -> bool:
        if not hasattr(self, "_is_cpu"):
            import jax
            self._is_cpu = jax.default_backend() == "cpu"
        return self._is_cpu

    def _try_pack_nib(self, bases, quals):
        """(packed_nibbles, exc_idx, exc_base, exc_qual) or None.

        4-bit packing (2-bit base + 2-bit learned qual dictionary) halves
        the dominant H2D bytes vs the 1-byte scheme on modern binned-quality
        data.  The choice is sticky per run: once a batch falls back (N-rich
        or >4 distinct quals), nib stays off so the device keeps running ONE
        compiled program for the rest of the run."""
        import os
        if (os.environ.get("FASTP_TPU_NO_INPUT_PACK")
                or os.environ.get("FASTP_TPU_NO_NIB")
                or getattr(self, "_nib_dead", False)
                or bases.shape[1] % 2):
            return None
        from ..io import native as native_mod
        if native_mod.get_lib() is None:
            return None
        if not hasattr(self, "_qdict"):
            self._qdict = np.zeros(4, np.uint8)
            self._qdict_n = np.zeros(1, np.int32)
        res = native_mod.pack_nib(bases, quals, self._qdict, self._qdict_n)
        if res is None:
            self._nib_dead = True
            return None
        return res[:4]

    def _try_pack_p3(self, bases, quals):
        """(bplane, qplane, exc_idx, exc_base, exc_qual) or None.

        Planar 3-bit packing (2-bit base plane + 1-bit qual plane over a
        2-entry frequency-learned qual dictionary) cuts H2D bytes 25%
        below the 4-bit nib scheme on two-level binned data (NovaSeq: one
        dominant high qual + one low; rarities ride the exception
        scatter).  Sticky per run like nib: one fallback and p3 stays off
        so the device keeps running ONE program."""
        import os
        if (os.environ.get("FASTP_TPU_NO_INPUT_PACK")
                or os.environ.get("FASTP_TPU_NO_NIB")
                or os.environ.get("FASTP_TPU_NO_P3")
                or getattr(self, "_p3_dead", False)
                or bases.shape[1] % 8):
            return None
        from ..io import native as native_mod
        if native_mod.get_lib() is None:
            return None
        if not hasattr(self, "_qdict2"):
            self._qdict2 = np.zeros(2, np.uint8)
            self._qdict2_n = np.zeros(1, np.int32)
        res = native_mod.pack_p3(bases, quals, self._qdict2, self._qdict2_n)
        if res is None:
            self._p3_dead = True
            return None
        return res[:5]

    def _learn_p3_dict(self, *quals):
        """Pre-learn the 2-entry p3 qual dict from the COMBINED histogram
        of both mates' first batches (same top-2-by-count rule as the
        native learner, smallest value winning ties).  An R1-only dict can
        starve R2 when the mates' dominant qual bins differ: R2's
        exceptions overflow and p3 goes sticky-dead for the whole run."""
        import os
        if (os.environ.get("FASTP_TPU_NO_INPUT_PACK")
                or os.environ.get("FASTP_TPU_NO_NIB")
                or os.environ.get("FASTP_TPU_NO_P3")
                or getattr(self, "_p3_dead", False)):
            return
        if not hasattr(self, "_qdict2"):
            self._qdict2 = np.zeros(2, np.uint8)
            self._qdict2_n = np.zeros(1, np.int32)
        if self._qdict2_n[0] >= 2:
            return
        hist = np.zeros(256, np.int64)
        for q in quals:
            hist += np.bincount(np.asarray(q, np.uint8).ravel(),
                                minlength=256)
        hist[0] = 0  # pad
        if not hist.any():
            return  # empty batch: the native learner handles it later
        q0 = int(np.argmax(hist))  # first max = smallest value, as native
        hist[q0] = 0
        q1 = int(np.argmax(hist)) if hist.any() else q0
        self._qdict2[0] = q0
        self._qdict2[1] = q1
        self._qdict2_n[0] = 2

    def _try_pack_inputs(self, bases, quals):
        """(packed, exc_idx, exc_base, exc_qual) or None.

        Packing halves the dominant H2D bytes (base+qual -> one byte per
        position); exceptional bytes ride along as an exact scatter list."""
        import os
        if os.environ.get("FASTP_TPU_NO_INPUT_PACK"):
            return None
        from ..io import native as native_mod
        if native_mod.get_lib() is None:
            return None
        res = native_mod.pack_bq(bases, quals)
        if res is None:
            return None
        return res[:4]

    def _pad_batch(self, arrays, B, target=None):
        """Pad batch-major arrays to a fixed target size (and a multiple of
        the device count) with a valid mask.  Keeping every batch the same
        shape avoids a full XLA recompile for the final partial batch.  On the CPU backend small inputs pad to a bucket
        ladder instead: compiling a 16384-row program to process a 9-read
        test file costs minutes of XLA CPU time for nothing."""
        tgt = max(B, target or B)
        if self._cpu_backend():
            for bucket in (256, 1024, 4096):
                if B <= bucket:
                    tgt = bucket
                    break
        tgt = -(-tgt // self.n_dev) * self.n_dev
        pad = tgt - B
        if pad == 0:
            return arrays, np.ones(B, bool)
        out = []
        for a in arrays:
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            out.append(np.pad(a, widths))
        valid = np.zeros(tgt, bool)
        valid[:B] = True
        return out, valid

    def _fetch_pool(self):
        """Two-worker executor that runs jax.device_get off-thread.

        The D2H wait releases the GIL, so fetching on side threads lets the
        next batch's host-side work (tokenize, dup hash, pack, dispatch)
        overlap the transfer; result order is preserved by the per-batch
        futures.  The worker count (FASTP_TPU_FETCH_WORKERS, default 2) was
        tuned for an earlier host link and is untested over PCIe."""
        if not hasattr(self, "_fetch_exec"):
            import os as _os
            from concurrent.futures import ThreadPoolExecutor
            nw = int(_os.environ.get("FASTP_TPU_FETCH_WORKERS", "2"))
            self._fetch_exec = ThreadPoolExecutor(max_workers=max(1, nw))
        return self._fetch_exec

    def _upload_pool(self):
        """Single-worker executor for input pack + H2D staging + dispatch.

        Separate from the fetch worker so batch k+1's upload overlaps
        batch k's D2H recv (both wait with the GIL released); one worker
        keeps dispatch order == input order."""
        if not hasattr(self, "_upload_exec"):
            from concurrent.futures import ThreadPoolExecutor
            self._upload_exec = ThreadPoolExecutor(max_workers=1)
        return self._upload_exec

    def _prep_pool(self):
        """Single-worker executor running produce() (tokenize + host pre +
        dispatch submission) ahead of the main loop: the heavy host prep of
        batches k+1/k+2 overlaps batch k's routing/serialization and the
        transfers.  One worker keeps reader/dup state sequential."""
        if not hasattr(self, "_prep_exec"):
            from concurrent.futures import ThreadPoolExecutor
            self._prep_exec = ThreadPoolExecutor(max_workers=1)
        return self._prep_exec

    def _batch_stream(self, produce, depth: int = None):
        """Yield produce() results with `depth` calls in flight on the prep
        worker (the generator ends at the first None).

        Depth bounds how many batches are in flight end-to-end (produce ->
        dispatch -> fetch); it must exceed a batch's pipeline latency over
        one stage time for the main loop never to stall on a future.  The
        default 3 (FASTP_TPU_PREFETCH overrides) was tuned for an earlier
        host link and is untested over PCIe."""
        import os as _os
        from collections import deque
        if depth is None:
            depth = max(1, int(_os.environ.get("FASTP_TPU_PREFETCH", "3")))
        pool = self._prep_pool()
        q = deque(pool.submit(produce) for _ in range(depth))
        while True:
            item = q.popleft().result()
            if item is None:
                for f in q:  # drain the speculative Nones
                    f.result()
                return
            q.append(pool.submit(produce))
            yield item

    def _submit_batch(self, dispatch_fn, *args):
        """Pipeline one batch: dispatch on the upload worker, fetch on the
        fetch worker. Returns a future of (fetched numpy tree, layout).

        The layout dict is snapshotted right after this batch's dispatch
        (= after any retrace for a new shape), because a later batch's
        retrace mutates the shared step.layout before this batch is
        unpacked — the prefetch pipeline makes that ordering routine."""
        import jax
        import time as _t

        key = ("shape", args[0].shape[0], args[0].shape[1])
        if not hasattr(self, "_t_dispatch"):
            self._t_dispatch = [0.0]
            self._t_get = [0.0]

        def _dispatch_snap():
            t0 = _t.monotonic()
            out, layout_all = dispatch_fn(*args)
            self._t_dispatch[0] += _t.monotonic() - t0
            snap = layout_all.get(key)
            if snap is None:  # debug paths without a shape entry
                snap = {k: v for k, v in layout_all.items()
                        if not isinstance(k, tuple)}
            return out, snap

        disp = self._upload_pool().submit(_dispatch_snap)

        def _fetch():
            out, layout = disp.result()
            t0 = _t.monotonic()
            res = jax.device_get(out), layout
            self._t_get[0] += _t.monotonic() - t0
            return res

        return self._fetch_pool().submit(_fetch)

    def _close_pool(self):
        """Shut the executors down at end of run (a resident server
        process would otherwise leak threads per job)."""
        for attr in ("_prep_exec", "_upload_exec", "_fetch_exec"):
            if hasattr(self, attr):
                getattr(self, attr).shutdown(wait=True)
                delattr(self, attr)

    def _index_drop_mask(self, names1, names2=None) -> np.ndarray:
        n = len(names1)
        mask = np.zeros(n, bool)
        if not self.opt.indexFilter.enabled:
            return mask
        th = self.opt.indexFilter.threshold
        bl1 = self.opt.indexFilter.blacklist1
        bl2 = self.opt.indexFilter.blacklist2
        for i in range(n):
            if _index_match(bl1, first_index(names1[i]), th):
                mask[i] = True
            elif names2 is not None and _index_match(bl2, last_index(names2[i]), th):
                mask[i] = True
        return mask

    @staticmethod
    def _blacklist_blob(items):
        lens = np.array([len(s) for s in items], np.int32)
        offs = np.zeros(len(items), np.int64)
        if len(items) > 1:
            np.cumsum(lens[:-1], out=offs[1:])
        blob = np.frombuffer(b"".join(s.encode("latin-1") for s in items)
                             or b"\0", np.uint8)
        return blob, offs, lens

    def _index_drop_mask_batches(self, batch1, batch2=None) -> np.ndarray:
        """Native batched index-blacklist filter over the raw name buffers
        (reference: src/filter.cpp:224-258); Python fallback per name."""
        B = batch1.n
        if not self.opt.indexFilter.enabled:
            return np.zeros(B, bool)
        import ctypes
        from ..io import native as native_mod
        lib = native_mod.get_lib()
        if lib is None:
            return self._index_drop_mask(
                batch1.names, batch2.names if batch2 is not None else None)
        if not hasattr(self, "_bl_cache"):
            self._bl_cache = (
                self._blacklist_blob(self.opt.indexFilter.blacklist1),
                self._blacklist_blob(self.opt.indexFilter.blacklist2))
        (b1b, b1o, b1l), (b2b, b2o, b2l) = self._bl_cache
        nb1, noff1, nlen1 = batch1.name_buffers()
        drop = np.zeros(B, np.uint8)
        if batch2 is not None:
            nb2, noff2, nlen2 = batch2.name_buffers()
            nb2c = np.ascontiguousarray(nb2)
            noff2c = np.ascontiguousarray(noff2[:B], np.int64)
            nlen2c = np.ascontiguousarray(nlen2[:B], np.int32)
            p2 = (nb2c.ctypes.data_as(ctypes.c_void_p),
                  noff2c.ctypes.data_as(ctypes.c_void_p),
                  nlen2c.ctypes.data_as(ctypes.c_void_p))
        else:
            p2 = (None, None, None)
        lib.index_filter(
            np.ascontiguousarray(nb1),
            np.ascontiguousarray(noff1[:B], np.int64),
            np.ascontiguousarray(nlen1[:B], np.int32),
            p2[0], p2[1], p2[2],
            b1b, b1o, b1l, len(b1l), b2b, b2o, b2l, len(b2l),
            self.opt.indexFilter.threshold, B, drop)
        return drop.astype(bool)


class SingleEndProcessor(BaseProcessor):
    """reference: src/seprocessor.cpp:196-315"""

    def __init__(self, opt: Options):
        super().__init__(opt)
        inner = build_se_step(self.cfg, mega=self._mega, accum=self._accum)
        self._plain_layout = inner.layout
        self.step = self._wrap_step(inner)
        self._packed_step = None
        self._packed_layout = None
        self._nib_step = None
        self._nib_layout = None
        self._p3_step = None
        self._p3_layout = None
        self.pre_stats = Stats(opt, False, self.width)
        self.post_stats = Stats(opt, False, self.width)
        self.filter_result = FilterResult(opt, False, log=self.sharded)
        self.overrep_pre = _OverRepCounter(self.pre_stats, opt)
        self.overrep_post = _OverRepCounter(self.post_stats, opt)

    def _dispatch(self, bases_p, quals_p, lengths_p, pre_trim_p,
                  index_drop_p, dedup_p, valid):
        """Returns (device outputs, layout dict of the step that ran)."""
        from .device import make_aux, length_dtype
        W = bases_p.shape[1]
        lengths_p = lengths_p.astype(length_dtype(W))
        aux = make_aux(self.cfg, valid, pre_trim_p, None,
                       index_drop_p, dedup_p)
        p3 = self._try_pack_p3(bases_p, quals_p)
        if p3 is not None:
            if self._p3_step is None:
                inner = build_se_step(self.cfg, packed="p3",
                                      mega=self._mega, accum=self._accum)
                self._p3_layout = inner.layout
                self._p3_step = self._wrap_step(inner)
            bp, qp, ei, eb, eq = p3
            out = self._call_step(
                self._p3_step,
                lambda: build_se_step(self.cfg, packed="p3",
                                      mega=self._mega, accum="spec"),
                W, (bp, qp, ei, eb, eq, self._qdict2.copy(),
                    lengths_p) + aux)
            return out, self._p3_layout
        nib = self._try_pack_nib(bases_p, quals_p)
        if nib is not None:
            if self._nib_step is None:
                inner = build_se_step(self.cfg, packed="nib",
                                      mega=self._mega, accum=self._accum)
                self._nib_layout = inner.layout
                self._nib_step = self._wrap_step(inner)
            p, ei, eb, eq = nib
            out = self._call_step(
                self._nib_step,
                lambda: build_se_step(self.cfg, packed="nib",
                                      mega=self._mega, accum="spec"),
                W, (p, self._qdict.copy(), ei, eb, eq, lengths_p) + aux)
            return out, self._nib_layout
        pk = self._try_pack_inputs(bases_p, quals_p)
        if pk is None:
            out = self._call_step(
                self.step,
                lambda: build_se_step(self.cfg, mega=self._mega,
                                      accum="spec"),
                W, (bases_p, quals_p, lengths_p) + aux)
            return out, self._plain_layout
        if self._packed_step is None:
            inner = build_se_step(self.cfg, packed=True, mega=self._mega,
                                  accum=self._accum)
            self._packed_layout = inner.layout
            self._packed_step = self._wrap_step(inner)
        p, ei, eb, eq = pk
        out = self._call_step(
            self._packed_step,
            lambda: build_se_step(self.cfg, packed=True, mega=self._mega,
                                  accum="spec"),
            W, (p, ei, eb, eq, lengths_p) + aux)
        return out, self._packed_layout

    def process(self) -> Dict:
        opt = self.opt
        reader = open_batch_reader(opt.in1, opt.phred64,
                                   getattr(opt, "shardRange1", None),
                                   getattr(opt, "shardRecRange", None))
        from ..io import native as native_mod
        nlib = native_mod.get_lib()
        out_writer = None
        failed_writer = None
        if not opt.split.enabled:
            if opt.out1 or opt.outputToSTDOUT:
                out_writer = OutputWriter(opt.out1, opt.compression,
                                          opt.outputToSTDOUT, opt.writerBufferSize)
            if opt.failedOut:
                failed_writer = OutputWriter(opt.failedOut, opt.compression,
                                             buffer_size=opt.writerBufferSize)
        split = SplitWriterSet(opt) if opt.split.enabled else None

        reads_seen = 0
        reads_read = 0
        self._last_reported = 0
        adapter_seq1 = self.cfg.adapter_seq1
        import jax

        eof = False

        def produce():
            """Read + host-pre + async device dispatch for one batch (the
            next batch's upload/compute overlaps the current fetch/host)."""
            nonlocal eof, reads_read
            if eof:
                return None
            n = opt.batchSize
            if opt.readsToProcess > 0:
                n = min(n, opt.readsToProcess - reads_read)
                if n <= 0:
                    eof = True
                    return None
            batch = reader.read_batch(n, self.width)
            if batch is None:
                eof = True
                return None
            B = batch.n
            self.width = batch.width

            index_drop = self._index_drop_mask_batches(batch)
            if opt.fixMGI:
                batch.set_names([fix_mgi(nm)[0] for nm in batch.names])
            if opt.umi.enabled:
                res = self.umi.process_batch_arrays(batch)
                if res is not None:
                    pre_trim = res[0]
                else:
                    names_u, _, pre_trim, _ = self.umi.process_batch(
                        batch.names, batch.seqs())
                    batch.set_names(names_u)
                    pre_trim = np.asarray(pre_trim, np.int32)
            else:
                pre_trim = np.zeros(B, np.int32)

            dedup_out = np.zeros(B, bool)
            if self.duplicate is not None:
                dup = self.duplicate.check_batch_se(batch.bases, batch.lengths)
                if opt.duplicate.dedup:
                    dedup_out = dup

            (bases_p, quals_p, lengths_p, pre_trim_p, index_drop_p,
             dedup_p), valid = self._pad_batch(
                [batch.bases, batch.quals, batch.lengths, pre_trim,
                 index_drop, dedup_out], B, target=opt.batchSize)
            # two-stage pipeline: upload+dispatch of batch k+1 overlaps the
            # D2H fetch of batch k, and both overlap the host prep here
            out_dev = self._submit_batch(
                self._dispatch, bases_p, quals_p, lengths_p, pre_trim_p,
                index_drop_p, dedup_p, valid)
            reads_read += B
            if opt.verbose and reads_read >= self._last_reported + 1000000:
                from ..utils.log import loginfo
                self._last_reported = reads_read
                loginfo("loaded %dM reads" % (reads_read // 1000000))
            return (out_dev, batch, B, index_drop, pre_trim, dedup_out)

        for pending in self._batch_stream(produce):
            out, batch, B, index_drop, pre_trim, dedup_out = pending
            bases, quals_arr, lengths = batch.bases, batch.quals, batch.lengths
            # ONE batched D2H fetch of the packed buffers (each buffer pays
            # a fixed latency; the packed tree has ~8 leaves, not 80)
            from .device import unpack_from_host
            fetched, layout = out.result()
            out = unpack_from_host(fetched, layout)
            # lean steps drop total_front when no front trim/cut can move
            # the window start on device: it is exactly the host pre-trim
            if "total_front" not in out:
                out["total_front"] = pre_trim

            if not self._accum:
                self.pre_stats.add_batch(out["pre"])
                self.post_stats.add_batch(out["post"])
                self.filter_result.add_polyx_trimmed(out["polyx_reads"],
                                                     out["polyx_bases"])

            # filter result counting (exclude index-dropped and pad rows);
            # in lean mode the device histogram carries the same counts
            if "result" in out:
                res = out["result"][:B][~index_drop]
                self.filter_result.add_filter_result_array(res, 1)
            elif "result_hist" in out:
                self.filter_result.filter_read_stats += \
                    out["result_hist"].astype(np.int64)

            # adapter recording (grouped; see group_slices)
            ad_found = out.get("ad_found")
            if ad_found is not None and ad_found.any():
                alen = len(adapter_seq1)
                frows = np.flatnonzero(ad_found)
                ps = out["ad_pos"][frows].astype(np.int64)
                tfs = out["total_front"][frows].astype(np.int64)
                pres = out["rlen_pre_adapter"][frows].astype(np.int64)
                posts = out["rlen_post_adapter"][frows].astype(np.int64)
                entries = []
                neg = ps < 0
                negrows = np.flatnonzero(neg)
                if negrows.size:
                    uniq, first, counts = np.unique(
                        ps[negrows], return_index=True, return_counts=True)
                    for k in range(uniq.size):
                        entries.append((int(negrows[first[k]]),
                                        adapter_seq1[:alen + int(uniq[k])].decode(),
                                        int(counts[k])))
                nrm = np.flatnonzero(~neg)
                lo = tfs + posts
                hi = tfs + pres
                fr = self.filter_result
                if fr._adrec is not None:
                    # normal rows stream to the native recorder in row
                    # order, interleaved with the synthesized prefixes
                    # (see pe_runner: in-order per-row adds == grouped
                    # replay under the cap semantics)
                    entries.sort(key=lambda t: t[0])
                    start = 0
                    for idx, s, c in entries + [(frows.size + 1, "", 0)]:
                        seg = nrm[(nrm >= start) & (nrm < idx)]
                        if seg.size:
                            fr.add_adapter_trimmed_rows_bulk(
                                bases, frows[seg], lo[seg], hi[seg], False)
                        if s:
                            fr.add_adapter_trimmed(s, False, count=c)
                        start = idx
                else:
                    if nrm.size:
                        for p0, bb, c in group_slices(
                                bases, frows[nrm], lo[nrm], hi[nrm]):
                            entries.append((int(nrm[p0]),
                                            bb.decode("latin-1"), c))
                    entries.sort(key=lambda t: t[0])
                    for _, s, c in entries:
                        fr.add_adapter_trimmed(s, False, count=c)

            # overrepresentation sampling (pre on original, post on emitted)
            if self.overrep_pre.enabled:
                samp = self.overrep_pre.sampling
                rows = np.arange((-reads_seen) % samp, B, samp, dtype=np.int32)
                self.overrep_pre.stat_rows(
                    batch.bases, np.zeros(B, np.int32), lengths, rows)
            # serialization
            emit = out["emit"]
            tf = out["total_front"]
            rlen = out["rlen"]
            result = out.get("result")  # absent in lean mode (no --failed_out)
            emit_np = emit[:B]
            post_count = int(emit_np.sum())
            if nlib is not None:
                nbuf, noff, nlen_a = batch.name_buffers()
                sbuf, soff, slen_a = batch.strand_buffers()
                blob = native_mod.serialize(
                    nbuf, noff, nlen_a, sbuf, soff, slen_a,
                    bases, quals_arr, tf[:B], rlen[:B],
                    emit_np, batch.width)
            else:
                out_parts = []
                for i in np.flatnonzero(emit_np):
                    s0 = int(tf[i])
                    s1 = s0 + int(rlen[i])
                    out_parts += [batch.name(i), b"\n",
                                  bases[i, s0:s1].tobytes(), b"\n",
                                  batch.strand(i), b"\n",
                                  quals_arr[i, s0:s1].tobytes(), b"\n"]
                blob = b"".join(out_parts)
            if self.overrep_post.enabled:
                rows = np.flatnonzero(emit_np)
                sel = rows[np.arange(rows.size) % self.overrep_post.sampling == 0]
                self.overrep_post.stat_rows(bases, tf[:B], rlen[:B],
                                            sel.astype(np.int32))
            failed_parts = []
            if failed_writer is not None:
                # failed reads show the processed window when they survived
                # trimming, pristine bytes when trim killed them (the
                # reference mutates the Read in place: src/seprocessor.cpp:273)
                alive = out["alive"]
                for i in np.flatnonzero(~emit_np & ~index_drop & ~dedup_out):
                    tag = FAILED_TYPES[int(result[i])].encode()
                    if alive[i]:
                        s0 = int(tf[i])
                        s1 = s0 + int(rlen[i])
                        seq = bases[i, s0:s1].tobytes()
                        qual = quals_arr[i, s0:s1].tobytes()
                    else:
                        p0 = int(pre_trim[i])
                        ln = int(lengths[i])
                        seq = bases[i, p0:ln].tobytes()
                        qual = quals_arr[i, p0:ln].tobytes()
                    failed_parts += [batch.name(i) + b" " + tag, b"\n",
                                     seq, b"\n", batch.strand(i), b"\n",
                                     qual, b"\n"]

            if split is not None:
                split.write1(blob, post_count if opt.split.byFileLines else B)
            elif out_writer is not None:
                out_writer.write(blob)
            if failed_writer is not None:
                failed_writer.write(b"".join(failed_parts))

            reads_seen += B

        # accumulate mode: run-level device sums arrive once, here
        for vals in self._fold_accs():
            if "pre" in vals:
                self.pre_stats.add_batch(vals["pre"])
                self.post_stats.add_batch(vals["post"])
            if "polyx_reads" in vals:
                self.filter_result.add_polyx_trimmed(vals["polyx_reads"],
                                                     vals["polyx_bases"])
            if "result_hist" in vals:
                self.filter_result.filter_read_stats += \
                    vals["result_hist"].astype(np.int64)

        if opt.verbose:
            from ..utils.log import loginfo
            loginfo("batch loop done (%d reads)" % reads_seen)
        reader.close()
        if out_writer:
            out_writer.close()
        if failed_writer:
            failed_writer.close()
        if split is not None:
            split.close()
        self._close_pool()
        if opt.verbose:
            from ..utils.log import loginfo
            loginfo("writers drained")

        return self._finish()

    def _finish(self) -> Dict:
        opt = self.opt
        self.overrep_pre.flush()
        self.overrep_post.flush()
        if self.sharded:
            from ..parallel import multihost
            # gather every shard's accumulators; only process 0 reports
            if not multihost.merge_processor_stats(self, is_pe=False):
                if self.duplicate is not None:
                    self.duplicate.release()
                return {"pre": self.pre_stats, "post": self.post_stats,
                        "filter": self.filter_result, "dup_rate": 0.0}
        sys.stderr.write("Read1 before filtering:\n")
        self._print_stats(self.pre_stats)
        sys.stderr.write("\nRead1 after filtering:\n")
        self._print_stats(self.post_stats)
        sys.stderr.write("\nFiltering result:\n")
        self._print_filter_result()
        dup_rate = 0.0
        if opt.duplicate.enabled:
            dup_rate = self.duplicate.get_dup_rate()
            sys.stderr.write(
                "\nDuplication rate (may be overestimated since this is SE data): %s%%\n"
                % _cpp_pct(dup_rate * 100.0))
        jr = JsonReporter(opt)
        jr.set_dup(dup_rate)
        jr.report(self.filter_result, self.pre_stats, self.post_stats)
        hr = HtmlReporter(opt)
        hr.set_dup(dup_rate)
        hr.report(self.filter_result, self.pre_stats, self.post_stats)
        if self.duplicate is not None:
            self.duplicate.release()  # recycle the Bloom buffers (server)
        return {"pre": self.pre_stats, "post": self.post_stats,
                "filter": self.filter_result, "dup_rate": dup_rate}

    def _print_stats(self, st: Stats):
        st.summarize()
        sys.stderr.write("total reads: %d\n" % st.reads)
        sys.stderr.write("total bases: %d\n" % st.bases)
        b = st.bases if st.bases else 1
        sys.stderr.write("Q20 bases: %d(%s%%)\n" % (st.q20_total, _cpp_pct(st.q20_total * 100.0 / st.bases if st.bases else float('nan'))))
        sys.stderr.write("Q30 bases: %d(%s%%)\n" % (st.q30_total, _cpp_pct(st.q30_total * 100.0 / st.bases if st.bases else float('nan'))))
        sys.stderr.write("Q40 bases: %d(%s%%)\n" % (st.q40_total, _cpp_pct(st.q40_total * 100.0 / st.bases if st.bases else float('nan'))))

    def _print_filter_result(self):
        fr = self.filter_result
        opt = self.opt
        from ..config import FAIL_QUALITY, FAIL_N_BASE, FAIL_LENGTH, FAIL_TOO_LONG, FAIL_COMPLEXITY
        sys.stderr.write("reads passed filter: %d\n" % fr.filter_read_stats[PASS_FILTER])
        sys.stderr.write("reads failed due to low quality: %d\n" % fr.filter_read_stats[FAIL_QUALITY])
        sys.stderr.write("reads failed due to too many N: %d\n" % fr.filter_read_stats[FAIL_N_BASE])
        if opt.lengthFilter.enabled:
            sys.stderr.write("reads failed due to too short: %d\n" % fr.filter_read_stats[FAIL_LENGTH])
            if opt.lengthFilter.maxLength > 0:
                sys.stderr.write("reads failed due to too long: %d\n" % fr.filter_read_stats[FAIL_TOO_LONG])
        if opt.complexityFilter.enabled:
            sys.stderr.write("reads failed due to low complexity: %d\n" % fr.filter_read_stats[FAIL_COMPLEXITY])
        if opt.adapter.enabled:
            sys.stderr.write("reads with adapter trimmed: %d\n" % fr.trimmed_adapter_reads)
            sys.stderr.write("bases trimmed due to adapters: %d\n" % fr.trimmed_adapter_bases)
        if opt.polyXTrim.enabled:
            sys.stderr.write("reads with polyX in 3' end: %d\n" % fr.get_total_polyx_trimmed_reads())
            sys.stderr.write("bases trimmed in polyX tail: %d\n" % fr.get_total_polyx_trimmed_bases())
        if opt.correction.enabled:
            sys.stderr.write("reads corrected by overlap analysis: %d\n" % fr.corrected_reads)
            sys.stderr.write("bases corrected by overlap analysis: %d\n" % fr.get_total_corrected_bases())


def _cpp_pct(x: float) -> str:
    from ..report.stats_model import cpp_num
    return cpp_num(x)


class SplitWriterSet:
    """Split-output rotation (reference: src/threadconfig.cpp:106-157).

    Emulates the reference's per-worker round-robin file numbering with
    `thread` virtual workers: worker t owns file numbers t+1, t+1+T, ...
    """

    def __init__(self, opt: Options, paired: bool = False):
        self.opt = opt
        self.paired = paired
        self.T = opt.thread
        self.next_worker = 0
        self.worker_split = list(range(1, self.T + 1))  # current file number per worker
        self.worker_count = [0] * self.T
        self.cur = {}
        self._writers1 = [None] * self.T
        self._writers2 = [None] * self.T
        self.finished = [False] * self.T

    def _filename(self, number: int, base: str) -> str:
        d = self.opt.split.digits
        num = str(number)
        if d > 0:
            num = num.zfill(d)
        import os
        dirname, fname = os.path.split(base)
        return os.path.join(dirname, "%s.%s" % (num, fname)) if dirname else "%s.%s" % (num, fname)

    def _open(self, t: int):
        opt = self.opt
        if opt.out1:
            self._writers1[t] = OutputWriter(self._filename(self.worker_split[t], opt.out1),
                                             opt.compression, buffer_size=opt.writerBufferSize)
        if self.paired and opt.out2:
            self._writers2[t] = OutputWriter(self._filename(self.worker_split[t], opt.out2),
                                             opt.compression, buffer_size=opt.writerBufferSize)

    def write1(self, blob: bytes, processed: int, blob2: bytes = None):
        t = self.next_worker
        self.next_worker = (self.next_worker + 1) % self.T
        if self.finished[t]:
            return
        if self._writers1[t] is None and self.opt.out1:
            self._open(t)
        if self._writers1[t] is not None:
            self._writers1[t].write(blob)
        if blob2 is not None and self._writers2[t] is not None:
            self._writers2[t].write(blob2)
        self._mark(t, processed)

    def _mark(self, t: int, count: int):
        """reference: src/threadconfig.cpp:127-147 (markProcessed): rotate
        to the worker's next file number, except in by-file-number mode
        when the quota is reached — then the current (last) file keeps
        absorbing reads, and workers beyond number%T stop consuming
        (their reads are dropped, as the reference's stopped threads
        leave their remaining packs unconsumed)."""
        opt = self.opt
        self.worker_count[t] += count
        if self.worker_count[t] >= opt.split.size:
            if (opt.split.byFileLines
                    or (self.worker_split[t] - 1) + self.T < opt.split.number):
                self.worker_count[t] = 0
                self.worker_split[t] += self.T
                if self._writers1[t]:
                    self._writers1[t].close()
                    self._writers1[t] = None
                if self._writers2[t]:
                    self._writers2[t].close()
                    self._writers2[t] = None
            elif (opt.split.number % self.T > 0
                    and t >= opt.split.number % self.T):
                self.finished[t] = True

    def close(self):
        for t in range(self.T):
            if self._writers1[t]:
                self._writers1[t].close()
            if self._writers2[t]:
                self._writers2[t].close()
        # fill the quota with empty files (reference: threadconfig.cpp:151-157)
        if self.opt.split.byFileNumber:
            for num in range(1, self.opt.split.number + 1):
                import os
                f1 = self._filename(num, self.opt.out1) if self.opt.out1 else None
                if f1 and not os.path.exists(f1):
                    open(f1, "wb").close()
                if self.paired and self.opt.out2:
                    f2 = self._filename(num, self.opt.out2)
                    if not os.path.exists(f2):
                        open(f2, "wb").close()
