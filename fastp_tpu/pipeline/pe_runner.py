"""Paired-end streaming processor (reference: src/peprocessor.cpp:361-711).

Output routing, unpaired/failed handling, merging, overlapped-out, insert
size estimation, and adapter/correction accounting all follow the reference
worker loop; the per-pair compute happens in one jitted device step.
"""
from __future__ import annotations

import sys
from typing import Dict, List

import numpy as np

from ..config import Options, PASS_FILTER, FAILED_TYPES
from ..io.fastq import (FastqReader, OutputWriter, encode_batch, ArrayBatch,
                        open_batch_reader)
from ..io import native as native_mod
from ..report.stats_model import Stats, cpp_num
from ..report.filter_model import FilterResult
from ..report.jsonreport import JsonReporter
from ..report.htmlreport import HtmlReporter
from ..utils.readname import fix_mgi
from .device import build_pe_step
from .hostview import (PairWindowView, host_analyze_overlap,
                       host_correct_pair)
from .runner import (BaseProcessor, SplitWriterSet, _OverRepCounter,
                     _round_width, group_slices, group_pair_slices)


class _SeqView:
    """List-like adapter exposing an ArrayBatch's per-row seq/qual bytes."""

    def __init__(self, batch: ArrayBatch, quals: bool = False):
        self.batch = batch
        self.quals = quals

    def __getitem__(self, i: int) -> bytes:
        return (self.batch.qual_bytes(i) if self.quals
                else self.batch.seq_bytes(i))

    def __len__(self):
        return self.batch.n


def _split_interleaved(batch: ArrayBatch):
    """De-interleave a batch into (left, right) halves (even/odd rows)."""
    def half(sel):
        return ArrayBatch(
            len(sel), batch.width,
            np.ascontiguousarray(batch.bases[sel]),
            np.ascontiguousarray(batch.quals[sel]),
            np.ascontiguousarray(batch.lengths[sel]), chunk=batch.chunk,
            name_off=batch.name_off[sel] if batch.name_off is not None else None,
            name_len=batch.name_len[sel] if batch.name_len is not None else None,
            strand_off=batch.strand_off[sel] if batch.strand_off is not None else None,
            strand_len=batch.strand_len[sel] if batch.strand_len is not None else None,
            names=([batch.names[i] for i in sel] if batch.name_off is None else None),
            strands=([batch.strands[i] for i in sel] if batch.strand_off is None else None))
    n2 = batch.n // 2
    even = np.arange(0, 2 * n2, 2)
    odd = even + 1
    return half(even), half(odd)


class _InterleavedPairSource:
    """Batch source reading pairs from a single interleaved stream."""

    def __init__(self, reader):
        self.reader = reader

    def read_pair_batch(self, n: int, width: int):
        batch = self.reader.read_batch(2 * n, width)
        if batch is None or batch.n < 2:
            return None, None
        return _split_interleaved(batch)


class PairEndProcessor(BaseProcessor):
    def __init__(self, opt: Options):
        super().__init__(opt)
        inner = build_pe_step(self.cfg, mega=self._mega, accum=self._accum)
        self._plain_layout = inner.layout
        self.step = self._wrap_step(inner)
        self._packed_step = None
        self._packed_layout = None
        self._nib_step = None
        self._nib_layout = None
        self._p3_step = None
        self._p3_layout = None
        self.width = _round_width(max(opt.seqLen1, opt.seqLen2, 32))
        self.pre_stats1 = Stats(opt, False, self.width)
        self.post_stats1 = Stats(opt, False, self.width * 2)
        self.pre_stats2 = Stats(opt, True, self.width)
        self.post_stats2 = Stats(opt, True, self.width)
        self.filter_result = FilterResult(opt, True, log=self.sharded)
        self.insert_hist = np.zeros(opt.insertSizeMax + 1, np.int64)
        self.overrep_pre1 = _OverRepCounter(self.pre_stats1, opt)
        self.overrep_pre2 = _OverRepCounter(self.pre_stats2, opt)
        self.overrep_post1 = _OverRepCounter(self.post_stats1, opt)
        self.overrep_post2 = _OverRepCounter(self.post_stats2, opt)

    def process(self) -> Dict:
        import os as _os
        prof_path = _os.environ.get("FASTP_TPU_CPUPROFILE")
        if prof_path:
            # main-thread CPU profile of the route/unpack path (the prep/
            # upload/fetch workers are NOT covered; see FASTP_TPU_TIMING
            # for their wall split).  Dumps pstats to $FASTP_TPU_CPUPROFILE
            # (FASTP_TPU_PROFILE is the xprof device-trace dir, cli.py).
            import cProfile
            prof = cProfile.Profile()
            prof.enable()
            try:
                return self._process_inner()
            finally:
                prof.disable()
                prof.dump_stats(prof_path)
        return self._process_inner()

    def _process_inner(self) -> Dict:
        opt = self.opt
        if opt.interleavedInput:
            pair_src = _InterleavedPairSource(open_batch_reader(
                opt.in1, opt.phred64, getattr(opt, "shardRange1", None),
                getattr(opt, "shardRecRange", None)))
            reader1 = reader2 = None
        else:
            reader1 = open_batch_reader(opt.in1, opt.phred64,
                                        getattr(opt, "shardRange1", None),
                                        getattr(opt, "shardRecRange", None))
            reader2 = open_batch_reader(opt.in2, opt.phred64,
                                        getattr(opt, "shardRange2", None),
                                        getattr(opt, "shardRecRange", None))
            pair_src = None

        writers = {}
        split = None
        if not opt.split.enabled:
            if opt.out1:
                writers["out1"] = OutputWriter(opt.out1, opt.compression,
                                               buffer_size=opt.writerBufferSize)
            if opt.out2:
                writers["out2"] = OutputWriter(opt.out2, opt.compression,
                                               buffer_size=opt.writerBufferSize)
            if opt.outputToSTDOUT:
                writers["stdout"] = OutputWriter("", opt.compression, to_stdout=True)
            if opt.unpaired1:
                writers["unpaired1"] = OutputWriter(opt.unpaired1, opt.compression,
                                                    buffer_size=opt.writerBufferSize)
            if opt.unpaired2 and opt.unpaired2 != opt.unpaired1:
                writers["unpaired2"] = OutputWriter(opt.unpaired2, opt.compression,
                                                    buffer_size=opt.writerBufferSize)
            if opt.merge.enabled and opt.merge.out:
                writers["merged"] = OutputWriter(opt.merge.out, opt.compression,
                                                 buffer_size=opt.writerBufferSize)
            if opt.failedOut:
                writers["failed"] = OutputWriter(opt.failedOut, opt.compression,
                                                 buffer_size=opt.writerBufferSize)
            if opt.overlappedOut:
                writers["overlapped"] = OutputWriter(opt.overlappedOut, opt.compression,
                                                     buffer_size=opt.writerBufferSize)
        else:
            split = SplitWriterSet(opt, paired=True)

        pairs_seen = 0
        pairs_read = 0
        self._last_reported = 0
        a1 = self.cfg.adapter_seq1
        a2 = self.cfg.adapter_seq2
        import jax

        eof = False

        import time as _ptime
        t_sub = {"read": 0.0, "dup": 0.0, "pad": 0.0, "submit": 0.0}

        def produce():
            """Read one batch, run host-side pre-ops, dispatch the device
            step asynchronously.  Called for batch k+1 BEFORE batch k's
            results are fetched, so the next upload+compute overlaps the
            current download+host work."""
            nonlocal eof, pairs_read
            if eof:
                return None
            n = opt.batchSize
            if opt.readsToProcess > 0:
                n = min(n, opt.readsToProcess - pairs_read)
                if n <= 0:
                    eof = True
                    return None
            _t = _ptime.monotonic()
            if pair_src is not None:
                batch1, batch2 = pair_src.read_pair_batch(n, self.width)
            else:
                batch1 = reader1.read_batch(n, self.width)
                batch2 = reader2.read_batch(n, self.width)
            t_sub["read"] += _ptime.monotonic() - _t
            if batch1 is None or batch2 is None:
                eof = True
                return None
            if batch1.n != batch2.n:
                sys.stderr.write("\nWARNNIG: different read numbers of the input files\n"
                                 "Read1 count: %d\nRead2 count: %d\n"
                                 "Ignore the unmatched reads\n\n" % (batch1.n, batch2.n))
                m = min(batch1.n, batch2.n)
                batch1 = batch1.head(m)
                batch2 = batch2.head(m)
            B = batch1.n
            if batch1.width != batch2.width:
                w = max(batch1.width, batch2.width)
                batch1 = batch1.widen(w)
                batch2 = batch2.widen(w)
            self.width = batch1.width

            index_drop = self._index_drop_mask_batches(batch1, batch2)
            if opt.fixMGI:
                batch1.set_names([fix_mgi(nm)[0] for nm in batch1.names])
                batch2.set_names([fix_mgi(nm)[0] for nm in batch2.names])
            if opt.umi.enabled:
                res = self.umi.process_batch_arrays(batch1, batch2)
                if res is not None:
                    pre_trim1, pre_trim2 = res
                else:
                    names1u, names2u, pre_trim1, pre_trim2 = self.umi.process_batch(
                        batch1.names, _SeqView(batch1), batch2.names, _SeqView(batch2))
                    batch1.set_names(names1u)
                    batch2.set_names(names2u)
                    pre_trim1 = np.asarray(pre_trim1, np.int32)
                    pre_trim2 = np.asarray(pre_trim2, np.int32)
            else:
                pre_trim1 = np.zeros(B, np.int32)
                pre_trim2 = np.zeros(B, np.int32)

            b1, q1, l1 = batch1.bases, batch1.quals, batch1.lengths
            b2, q2, l2 = batch2.bases, batch2.quals, batch2.lengths

            dedup_out = np.zeros(B, bool)
            if self.duplicate is not None:
                _t = _ptime.monotonic()
                dup = self.duplicate.check_batch_pe(b1, l1, b2, l2)
                t_sub["dup"] += _ptime.monotonic() - _t
                if opt.duplicate.dedup:
                    dedup_out = dup

            _t = _ptime.monotonic()
            (b1p, q1p, l1p, b2p, q2p, l2p, pt1p, pt2p, idxp, dedp), valid = \
                self._pad_batch([b1, q1, l1, b2, q2, l2, pre_trim1, pre_trim2,
                                 index_drop, dedup_out], B,
                                target=opt.batchSize)
            t_sub["pad"] += _ptime.monotonic() - _t
            # two-stage pipeline: pack+H2D+dispatch of batch k+1 (upload
            # worker) overlaps the D2H recv of batch k (fetch worker), and
            # both overlap this host-side prep (tokenize/dup/pad) of k+2
            _t = _ptime.monotonic()
            out_dev = self._submit_batch(
                self._dispatch_pe, b1p, q1p, l1p, b2p, q2p, l2p, pt1p, pt2p,
                idxp, dedp, valid)
            t_sub["submit"] += _ptime.monotonic() - _t
            pairs_read += B
            if opt.verbose and pairs_read >= self._last_reported + 1000000:
                from ..utils.log import loginfo
                self._last_reported = pairs_read
                loginfo("Read1: loaded %dM reads" % (pairs_read // 1000000))
                loginfo("Read2: loaded %dM reads" % (pairs_read // 1000000))
            return (out_dev, batch1, batch2, B, index_drop,
                    pre_trim1, pre_trim2, dedup_out)

        import os as _os
        import time as _time
        timing = _os.environ.get("FASTP_TPU_TIMING")
        if timing:
            import resource as _res
            _ru0 = _res.getrusage(_res.RUSAGE_SELF)
            _wall0 = _time.monotonic()
        t_fetch = t_route = t_flush = 0.0
        t_prod = [0.0]  # accumulated on the prep worker

        def produce_timed():
            _t0 = _time.monotonic()
            try:
                return produce()
            finally:
                t_prod[0] += _time.monotonic() - _t0

        for pending in self._batch_stream(produce_timed):
            (out, batch1, batch2, B, index_drop,
             pre_trim1, pre_trim2, dedup_out) = pending
            # ONE batched D2H fetch of the packed buffers (each buffer pays
            # a fixed latency; the packed tree has ~8 leaves, not 80)
            from .device import unpack_from_host
            _t = _time.monotonic()
            fetched, layout = out.result()
            out = unpack_from_host(fetched, layout)
            # lean steps drop total_front when no front trim/cut can move
            # the window start on device: it is exactly the host-known
            # pre-trim (consumers only touch rows < B, so length B is fine)
            if "total_front1" not in out:
                out["total_front1"] = pre_trim1
            if "total_front2" not in out:
                out["total_front2"] = pre_trim2
            t_fetch += _time.monotonic() - _t
            _t = _time.monotonic()

            if not self._accum:
                # accumulate mode keeps these running sums ON DEVICE; they
                # arrive once per run via _fold_accs() after the loop
                self.pre_stats1.add_batch(out["pre1"])
                self.pre_stats2.add_batch(out["pre2"])
                self.insert_hist[:len(out["isize_hist"])] += out["isize_hist"]
                self.filter_result.add_polyx_trimmed(out["polyx_reads"],
                                                     out["polyx_bases"])
                if opt.correction.enabled:
                    self.filter_result.add_correction_matrix(out["corr_matrix"])
            if opt.correction.enabled:
                self.filter_result.inc_corrected_reads(int(out["corrected_reads"]))
            if "result_hist" in out:
                # lean without accumulate (mesh): the device-side histogram
                # replaces route_pe's max(result1, result2) counting
                self.filter_result.filter_read_stats += \
                    out["result_hist"].astype(np.int64)

            rlen1 = out["rlen1"]
            rlen2 = out["rlen2"]
            view = PairWindowView(_SeqView(batch1), _SeqView(batch1, True),
                                  _SeqView(batch2), _SeqView(batch2, True),
                                  out, opt.correction.enabled, batch1.width,
                                  ov_params=(opt.overlapDiffLimit,
                                             opt.overlapRequire,
                                             opt.overlapDiffPercentLimit / 100.0))

            # --- adapter recording -----------------------------------------
            if opt.adapter.enabled:
                # corrections never land in the overlap-clipped region (they
                # stay inside [start1, start1+olen) which the clip keeps), so
                # ov-trimmed adapters slice the raw arrays; rows with
                # corrections fall back to the correction-aware view for the
                # by-sequence case, where regions can intersect
                hc = view.has_corr if opt.correction.enabled else None
                tf1a = out["total_front1"]
                tf2a = out["total_front2"]
                ba1, ba2 = batch1.bases, batch2.bases
                ovt = out["ov_trimmed"]
                fr = self.filter_result
                rows = np.flatnonzero(ovt)
                if rows.size:
                    s01 = tf1a[rows].astype(np.int64)
                    s02 = tf2a[rows].astype(np.int64)
                    lo1 = s01 + out["rlen1_pre_adapter"][rows]
                    hi1 = s01 + out["rlen1_pre_ovtrim"][rows]
                    lo2 = s02 + out["rlen2_pre_adapter"][rows]
                    hi2 = s02 + out["rlen2_pre_ovtrim"][rows]
                    # native bulk recorder (exact row order, caps in C++);
                    # grouped Python replay only without the native lib
                    if not fr.add_adapter_trimmed_pairs_bulk(
                            ba1, lo1, hi1, ba2, lo2, hi2, rows):
                        for _, b1b, b2b, c in group_pair_slices(
                                ba1, lo1, hi1, ba2, lo2, hi2, rows):
                            fr.add_adapter_trimmed_pair(
                                b1b.decode("latin-1"), b2b.decode("latin-1"),
                                count=c)
                for found_key, pos_key, pre_key, slicer, tfa, ba, aseq, is_r2 in (
                        ("ad_found1", "ad_pos1", "rlen1_pre_adapter",
                         view.r1_slice, tf1a, ba1, a1, False),
                        ("ad_found2", "ad_pos2", "rlen2_pre_adapter",
                         view.r2_slice, tf2a, ba2, a2, True)):
                    found = out[found_key]
                    if not found.any():
                        continue
                    frows = np.flatnonzero(found)
                    ps = out[pos_key][frows].astype(np.int64)
                    pres = out[pre_key][frows].astype(np.int64)
                    tfs = tfa[frows].astype(np.int64)
                    hcs = (hc[frows] if hc is not None
                           else np.zeros(frows.size, bool))
                    entries = []  # explicit strings: (idx, str, count)
                    neg = ps < 0
                    negrows = np.flatnonzero(neg)
                    if negrows.size:  # adapter clipped at the read start
                        uniq, first, counts = np.unique(
                            ps[negrows], return_index=True, return_counts=True)
                        for k in range(uniq.size):
                            entries.append((
                                int(negrows[first[k]]),
                                aseq[:len(aseq) + int(uniq[k])].decode(),
                                int(counts[k])))
                    # rows with corrections intersecting the adapter region
                    # need the correction-aware per-row view
                    for j in np.flatnonzero(~neg & hcs).tolist():
                        entries.append((
                            j, slicer(int(frows[j]), int(ps[j]),
                                      int(pres[j])).decode("latin-1"), 1))
                    nrm = np.flatnonzero(~neg & ~hcs)
                    entries.sort(key=lambda t: t[0])
                    lo = tfs + ps
                    hi = tfs + pres
                    if fr._adrec is not None:
                        # merged walk in row order: normal segments go to
                        # the native recorder in bulk, explicit strings
                        # (synthesized prefixes / corrected rows) one by
                        # one; per-row in-order adds are exactly the
                        # grouped replay (counts never change the cap's
                        # key-set size)
                        start = 0
                        for idx, s, c in entries + [(len(found) + 1, "", 0)]:
                            seg = nrm[(nrm >= start) & (nrm < idx)]
                            if seg.size:
                                fr.add_adapter_trimmed_rows_bulk(
                                    ba, frows[seg], lo[seg], hi[seg], is_r2)
                            if s:
                                fr.add_adapter_trimmed(s, is_r2, count=c)
                            start = idx
                    else:
                        if nrm.size:
                            for p0, bb, c in group_slices(
                                    ba, frows[nrm], lo[nrm], hi[nrm]):
                                entries.append((int(nrm[p0]),
                                                bb.decode("latin-1"), c))
                        entries.sort(key=lambda t: t[0])
                        for _, s, c in entries:
                            fr.add_adapter_trimmed(s, is_r2, count=c)

            # --- overrepresentation sampling (pre) -------------------------
            if self.overrep_pre1.enabled:
                samp = self.overrep_pre1.sampling
                rows = np.arange((-pairs_seen) % samp, B, samp, dtype=np.int32)
                zeros = np.zeros(B, np.int32)
                self.overrep_pre1.stat_rows(batch1.bases, zeros,
                                            batch1.lengths, rows)
                self.overrep_pre2.stat_rows(batch2.bases, zeros,
                                            batch2.lengths, rows)

            # --- outputs & filter-result counting --------------------------
            parts = {k: [] for k in ("out1", "out2", "single", "unpaired1",
                                     "unpaired2", "merged", "failed", "overlapped")}
            result1 = out.get("result1")  # absent in lean mode, where the
            result2 = out.get("result2")  # routed path never reads them
            pass1 = out["pass1"]
            pass2 = out["pass2"]
            merged_count = 0
            read_passed = 0
            post1_extra = 0

            routed = native_mod.get_lib() is not None
            if opt.overlappedOut and not routed:
                # (route_pe emits this stream natively on the routed path)
                ov0 = out["ov0_ok"]
                for i in np.flatnonzero(ov0):
                    off = max(0, int(out["ov0_offset"][i]))
                    ol = int(out["ov0_len"][i])
                    # reference quirk (src/peprocessor.cpp:464): the
                    # string(str, pos) ctor keeps the portion AFTER the overlap
                    s1w, q1w = view.r1(i, int(rlen1[i]))
                    seq = s1w[off:][ol:]
                    qual = q1w[off:][ol:]
                    parts["overlapped"] += [batch1.name(i), b"\n", seq, b"\n",
                                            batch1.strand(i), b"\n", qual, b"\n"]

            merge_on = opt.merge.enabled
            if merge_on:
                if not routed:  # the per-row fallback reads these per read
                    m_ok = out["merged_ok"]
                    m_res = out["m_result"]
                    m_len = out["m_len"]
                    m_len1 = out["m_len1"]
                    m_len2 = out["m_len2"]
                    ovm_ol = out["ovm_olen"]
                if not self._accum:
                    # accumulate mode keeps post_merged on device
                    self.post_stats1.add_batch(out["post_merged"])

            if routed:
                from .pe_route import route_pe
                rparts, read_passed, merged_count = route_pe(
                    self, out, batch1, batch2, B, index_drop,
                    pre_trim1, pre_trim2, dedup_out)
                for k, v in rparts.items():
                    parts[k].append(v)
                if (merge_on and opt.merge.includeUnmerged
                        and not self._accum):
                    self.post_stats1.add_batch(out["post_um1"])
                    self.post_stats1.add_batch(out["post_um2"])
            else:
              for i in range(B):
                if index_drop[i]:
                    continue
                merge_processed = False
                if merge_on:
                    if m_ok[i]:
                        self.filter_result.add_filter_result(int(m_res[i]), 2)
                        if m_res[i] == PASS_FILTER:
                            tag = b" merged_%d_%d" % (int(m_len1[i]), int(m_len2[i]))
                            strand = batch1.strand(i)
                            if strand != b"+":
                                strand = strand + tag
                            ms, mq = view.merged(i, int(rlen1[i]), int(rlen2[i]),
                                                 int(ovm_ol[i]), int(m_len1[i]),
                                                 int(m_len2[i]))
                            parts["merged"] += [
                                batch1.name(i) + tag, b"\n", ms, b"\n",
                                strand, b"\n", mq, b"\n"]
                            read_passed += 1
                            merged_count += 1
                        merge_processed = True
                    elif (opt.merge.includeUnmerged and out["alive1"][i]
                          and out["alive2"][i]):
                        # reference merge block requires both mates alive
                        # (src/peprocessor.cpp:491); dead-mate rows fall
                        # through to normal routing
                        r1ok = result1[i] == PASS_FILTER
                        r2ok = result2[i] == PASS_FILTER
                        self.filter_result.add_filter_result(int(result1[i]), 1)
                        if r1ok and not dedup_out[i]:
                            s1w, q1w = view.r1(i, int(rlen1[i]))
                            parts["merged"] += [batch1.name(i), b"\n", s1w, b"\n",
                                                batch1.strand(i), b"\n", q1w, b"\n"]
                            self._stat_post1_read(s1w, q1w)
                        self.filter_result.add_filter_result(int(result2[i]), 1)
                        if r2ok and not dedup_out[i]:
                            s2w, q2w = view.r2(i, int(rlen2[i]))
                            parts["merged"] += [batch2.name(i), b"\n", s2w, b"\n",
                                                batch2.strand(i), b"\n", q2w, b"\n"]
                            self._stat_post1_read(s2w, q2w)
                        if r1ok and r2ok:
                            read_passed += 1
                        merge_processed = True

                if not merge_processed:
                    self.filter_result.add_filter_result(
                        max(int(result1[i]), int(result2[i])), 2)
                    if dedup_out[i]:
                        continue
                    if pass1[i] and pass2[i]:
                        s1, qq1 = view.r1(i, int(rlen1[i]))
                        s2, qq2 = view.r2(i, int(rlen2[i]))
                        if opt.outputToSTDOUT and not merge_on:
                            parts["single"] += [batch1.name(i), b"\n", s1, b"\n",
                                                batch1.strand(i), b"\n", qq1, b"\n",
                                                batch2.name(i), b"\n", s2, b"\n",
                                                batch2.strand(i), b"\n", qq2, b"\n"]
                        else:
                            parts["out1"] += [batch1.name(i), b"\n", s1, b"\n",
                                              batch1.strand(i), b"\n", qq1, b"\n"]
                            parts["out2"] += [batch2.name(i), b"\n", s2, b"\n",
                                              batch2.strand(i), b"\n", qq2, b"\n"]
                        if not merge_on:
                            if self.overrep_post1.enabled:
                                self.overrep_post1.stat_read(s1, read_passed)
                                self.overrep_post2.stat_read(s2, read_passed)
                        read_passed += 1
                    elif pass1[i]:
                        fail2 = (view.r2(i, int(rlen2[i]))
                                 if out["alive2"][i] else None)
                        if opt.unpaired1:
                            s1w, q1w = view.r1(i, int(rlen1[i]))
                            parts["unpaired1"] += [batch1.name(i), b"\n", s1w, b"\n",
                                                   batch1.strand(i), b"\n", q1w, b"\n"]
                            if opt.failedOut:
                                self._failed_row(parts, batch2, i, pre_trim2[i],
                                                 FAILED_TYPES[int(result2[i])],
                                                 win=fail2)
                        else:
                            if opt.failedOut:
                                self._failed_row(parts, batch1, i, pre_trim1[i],
                                                 "paired_read_is_failing",
                                                 win=view.r1(i, int(rlen1[i])))
                                self._failed_row(parts, batch2, i, pre_trim2[i],
                                                 FAILED_TYPES[int(result2[i])],
                                                 win=fail2)
                    elif pass2[i]:
                        fail1 = (view.r1(i, int(rlen1[i]))
                                 if out["alive1"][i] else None)
                        target = None
                        if opt.unpaired2 and opt.unpaired2 != opt.unpaired1:
                            target = "unpaired2"
                        elif opt.unpaired1:
                            target = "unpaired1"
                        if target:
                            s2w, q2w = view.r2(i, int(rlen2[i]))
                            parts[target] += [batch2.name(i), b"\n", s2w, b"\n",
                                              batch2.strand(i), b"\n", q2w, b"\n"]
                            if opt.failedOut:
                                self._failed_row(parts, batch1, i, pre_trim1[i],
                                                 FAILED_TYPES[int(result1[i])],
                                                 win=fail1)
                        else:
                            if opt.failedOut:
                                self._failed_row(parts, batch1, i, pre_trim1[i],
                                                 FAILED_TYPES[int(result1[i])],
                                                 win=fail1)
                                self._failed_row(parts, batch2, i, pre_trim2[i],
                                                 "paired_read_is_failing",
                                                 win=view.r2(i, int(rlen2[i])))
                    # both-fail pairs write NOTHING to --failed_out
                    # (no such branch in src/peprocessor.cpp:551-577)

            if not merge_on and not self._accum:
                self.post_stats1.add_batch(out["post1"])
                self.post_stats2.add_batch(out["post2"])
            if merge_on:
                self.filter_result.add_merged_pairs(merged_count)

            t_route += _time.monotonic() - _t
            _t = _time.monotonic()
            # flush parts to writers
            if opt.outputToSTDOUT:
                blob = b"".join(parts["merged"] if merge_on else parts["single"])
                sys.stdout.buffer.write(blob)
                # file-backed side streams still flush in stdout mode (the
                # reference keeps every writer; in merge+stdout mode the
                # unmerged passing pairs go to out1/out2 writers while the
                # merged stream goes to stdout)
                for key in ("out1", "out2", "unpaired1", "unpaired2",
                            "failed", "overlapped"):
                    if key in writers and parts[key]:
                        writers[key].write(b"".join(parts[key]))
            elif split is not None:
                split.write1(b"".join(parts["out1"]),
                             read_passed if opt.split.byFileLines else B,
                             b"".join(parts["out2"]))
            else:
                for key in ("out1", "out2", "unpaired1", "unpaired2",
                            "merged", "failed", "overlapped"):
                    if key in writers and parts[key]:
                        writers[key].write(b"".join(parts[key]))

            t_flush += _time.monotonic() - _t
            pairs_seen += B

        # accumulate mode: the run-level device accumulator arrives now
        # (one fetch per chain instead of per batch)
        for vals in self._fold_accs():
            if "pre1" in vals:
                self.pre_stats1.add_batch(vals["pre1"])
                self.pre_stats2.add_batch(vals["pre2"])
            if "post1" in vals and not opt.merge.enabled:
                self.post_stats1.add_batch(vals["post1"])
                self.post_stats2.add_batch(vals["post2"])
            if "post_merged" in vals:
                self.post_stats1.add_batch(vals["post_merged"])
            if "post_um1" in vals:
                self.post_stats1.add_batch(vals["post_um1"])
                self.post_stats1.add_batch(vals["post_um2"])
            if "isize_hist" in vals:
                self.insert_hist[:len(vals["isize_hist"])] += vals["isize_hist"]
            if "polyx_reads" in vals:
                self.filter_result.add_polyx_trimmed(vals["polyx_reads"],
                                                     vals["polyx_bases"])
            if "corr_matrix" in vals and opt.correction.enabled:
                self.filter_result.add_correction_matrix(vals["corr_matrix"])
            if "result_hist" in vals:
                self.filter_result.filter_read_stats += \
                    vals["result_hist"].astype(np.int64)

        if timing:
            sys.stderr.write(
                "TIMING produce=%.2fs fetch_wait=%.2fs route=%.2fs "
                "flush=%.2fs pairs=%d "
                "[read=%.2fs dup=%.2fs pad=%.2fs submit=%.2fs]\n"
                % (t_prod[0], t_fetch, t_route, t_flush, pairs_seen,
                   t_sub["read"], t_sub["dup"], t_sub["pad"],
                   t_sub["submit"]))
            if hasattr(self, "_t_dispatch"):
                sys.stderr.write(
                    "TIMING workers dispatch=%.2fs device_get=%.2fs\n"
                    % (self._t_dispatch[0], self._t_get[0]))
            # process-wide CPU vs wall for the batch loop: cpu << wall
            # means the wall is device/IO waits
            _ru1 = _res.getrusage(_res.RUSAGE_SELF)
            sys.stderr.write(
                "TIMING cpu user=%.2fs sys=%.2fs wall=%.2fs "
                "minflt=%d majflt=%d\n"
                % (_ru1.ru_utime - _ru0.ru_utime,
                   _ru1.ru_stime - _ru0.ru_stime,
                   _time.monotonic() - _wall0,
                   _ru1.ru_minflt - _ru0.ru_minflt,
                   _ru1.ru_majflt - _ru0.ru_majflt))
        if opt.verbose:
            from ..utils.log import loginfo
            loginfo("batch loop done (%d pairs)" % pairs_seen)
        if reader1:
            reader1.close()
        if reader2:
            reader2.close()
        if pair_src is not None:
            pair_src.reader.close()
        for wtr in writers.values():
            wtr.close()
        if split is not None:
            split.close()
        self._close_pool()
        if opt.verbose:
            from ..utils.log import loginfo
            loginfo("writers drained")

        return self._finish()

    def _dispatch_pe(self, b1p, q1p, l1p, b2p, q2p, l2p, pt1p, pt2p,
                     idxp, dedp, valid):
        """Returns (device outputs, layout dict of the step that ran)."""
        from .device import make_aux, length_dtype
        W = b1p.shape[1]
        ldt = length_dtype(W)
        l1p = l1p.astype(ldt)
        l2p = l2p.astype(ldt)
        aux = make_aux(self.cfg, valid, pt1p, pt2p, idxp, dedp)
        if getattr(self, "_qdict2_n", np.zeros(1))[0] < 2:
            self._learn_p3_dict(q1p, q2p)
        p31 = self._try_pack_p3(b1p, q1p)
        p32 = self._try_pack_p3(b2p, q2p) if p31 is not None else None
        if p31 is not None and p32 is not None:
            if self._p3_step is None:
                inner = build_pe_step(self.cfg, packed="p3",
                                      mega=self._mega, accum=self._accum)
                self._p3_layout = inner.layout
                self._p3_step = self._wrap_step(inner)
            bp1, qp1, e1i, e1b, e1q = p31
            bp2, qp2, e2i, e2b, e2q = p32
            out = self._call_step(
                self._p3_step,
                lambda: build_pe_step(self.cfg, packed="p3",
                                      mega=self._mega, accum="spec"),
                W, (bp1, qp1, e1i, e1b, e1q, bp2, qp2, e2i, e2b, e2q,
                    self._qdict2.copy(), l1p, l2p) + aux)
            return out, self._p3_layout
        nib1 = self._try_pack_nib(b1p, q1p)
        nib2 = self._try_pack_nib(b2p, q2p) if nib1 is not None else None
        if nib1 is not None and nib2 is not None:
            if self._nib_step is None:
                inner = build_pe_step(self.cfg, packed="nib",
                                      mega=self._mega, accum=self._accum)
                self._nib_layout = inner.layout
                self._nib_step = self._wrap_step(inner)
            p1, e1i, e1b, e1q = nib1
            p2, e2i, e2b, e2q = nib2
            out = self._call_step(
                self._nib_step,
                lambda: build_pe_step(self.cfg, packed="nib",
                                      mega=self._mega, accum="spec"),
                W, (p1, e1i, e1b, e1q, p2, e2i, e2b, e2q,
                    self._qdict.copy(), l1p, l2p) + aux)
            return out, self._nib_layout
        pk1 = self._try_pack_inputs(b1p, q1p)
        pk2 = self._try_pack_inputs(b2p, q2p) if pk1 is not None else None
        if pk1 is None or pk2 is None:
            out = self._call_step(
                self.step,
                lambda: build_pe_step(self.cfg, mega=self._mega,
                                      accum="spec"),
                W, (b1p, q1p, l1p, b2p, q2p, l2p) + aux)
            return out, self._plain_layout
        if self._packed_step is None:
            inner = build_pe_step(self.cfg, packed=True, mega=self._mega,
                                  accum=self._accum)
            self._packed_layout = inner.layout
            self._packed_step = self._wrap_step(inner)
        p1, e1i, e1b, e1q = pk1
        p2, e2i, e2b, e2q = pk2
        out = self._call_step(
            self._packed_step,
            lambda: build_pe_step(self.cfg, packed=True, mega=self._mega,
                                  accum="spec"),
            W, (p1, e1i, e1b, e1q, p2, e2i, e2b, e2q, l1p, l2p) + aux)
        return out, self._packed_layout

    def _stat_post1_read(self, seq: bytes, qual: bytes):
        """Single-read post-stats accumulation for includeUnmerged mode."""
        st = self.post_stats1
        n = len(seq)
        if n > st.buf_len:
            st._grow(_round_width(n))
        s = np.frombuffer(seq, np.uint8)
        q = np.frombuffer(qual, np.uint8).astype(np.int64)
        slot = s & 7
        st.reads += 1
        st.length_sum += n
        pos = np.arange(n)
        np.add.at(st.cycle_content, (slot, pos), 1)
        np.add.at(st.cycle_qual, (slot, pos), q - 33)
        np.add.at(st.cycle_q20, (slot[q >= ord('5')], pos[q >= ord('5')]), 1)
        np.add.at(st.cycle_q30, (slot[q >= ord('?')], pos[q >= ord('?')]), 1)
        st.cycle_total_base[:n] += 1
        st.cycle_total_qual[:n] += q - 33
        np.add.at(st.qual_hist, np.clip(q, 0, 127), 1)
        # kmers
        v = np.full(n, -1, np.int64)
        v[s == 65] = 0
        v[s == 84] = 1
        v[s == 67] = 2
        v[s == 71] = 3
        if n >= 5:
            keys = np.zeros(n - 4, np.int64)
            ok = np.ones(n - 4, bool)
            for k in range(5):
                chunk = v[k:k + n - 4]
                keys = (keys << 2) | np.maximum(chunk, 0)
                ok &= chunk >= 0
            keys = ((keys << 0) & 0x3FF)
            np.add.at(st.kmer, keys[ok], 1)
        st._summarized = False

    def _failed_row(self, parts, batch: ArrayBatch, i: int, pre_trim, tag,
                    win=None):
        """win = (seq, qual) processed-window bytes for a read that survived
        trimming (the reference mutates the Read in place, so failed output
        shows the processed content); None = trim-killed, pristine bytes."""
        if isinstance(tag, str):
            tag = tag.encode()
        if win is not None:
            seq, qual = win
        else:
            p0 = int(pre_trim)
            ln = int(batch.lengths[i])
            seq = batch.bases[i, p0:ln].tobytes()
            qual = batch.quals[i, p0:ln].tobytes()
        parts["failed"] += [batch.name(i) + b" " + tag, b"\n", seq, b"\n",
                            batch.strand(i), b"\n", qual, b"\n"]

    def _patch_corrections(self, batch1: ArrayBatch, batch2: ArrayBatch,
                           out, B: int):
        """Apply the device's sparse correction deltas in place to the padded
        arrays so the native serializer emits corrected content.  Overflowing
        batches (count > capacity) are recomputed exactly on host
        (reference: src/basecorrector.cpp:16-83)."""
        if "c1k_pos" in out:  # mesh path: per-row top-K deltas (spmd-local)
            return self._patch_corrections_rowwise(batch1, batch2, out, B)
        C = out["c1_rows"].shape[0]  # slot capacity baked into the step
        n1 = int(out["c1_count"])
        n2 = int(out["c2_count"])
        if n1 == 0 and n2 == 0:
            return
        if n1 > C or n2 > C:
            self._host_correct_all(batch1, batch2, out, B)
            return
        tf1 = out["total_front1"]
        tf2 = out["total_front2"]
        for bt, tf, rows_k, pos_k, base_k, qual_k, cnt in (
                (batch1, tf1, "c1_rows", "c1_pos", "c1_base", "c1_qual", n1),
                (batch2, tf2, "c2_rows", "c2_pos", "c2_base", "c2_qual", n2)):
            if cnt == 0:
                continue
            rows = out[rows_k][:cnt]
            apos = tf[rows] + out[pos_k][:cnt]
            ok = apos < bt.lengths[rows]
            rows, apos = rows[ok], apos[ok]
            bt.bases[rows, apos] = out[base_k][:cnt][ok]
            bt.quals[rows, apos] = out[qual_k][:cnt][ok]

    def _patch_corrections_rowwise(self, batch1: ArrayBatch,
                                   batch2: ArrayBatch, out, B: int):
        """Mesh-path twin of _patch_corrections: per-row [K, B] delta
        matrices (device extract_deltas) instead of the batch-level sparse
        lists; rows whose count exceeds K are recomputed exactly on host."""
        K = out["c1k_pos"].shape[0]
        cnt1 = np.asarray(out["c1k_cnt"][:B], np.int64)
        cnt2 = np.asarray(out["c2k_cnt"][:B], np.int64)
        if not (cnt1.any() or cnt2.any()):
            return
        over = (cnt1 > K) | (cnt2 > K)
        ks = np.arange(K)
        for bt, tf_k, pos_k, u8_k, cnt in (
                (batch1, "total_front1", "c1k_pos", "c1k_u8", cnt1),
                (batch2, "total_front2", "c2k_pos", "c2k_u8", cnt2)):
            posm = np.asarray(out[pos_k][:, :B], np.int64)      # [K, B]
            u8 = out[u8_k][:, :B]                               # [2K, B]
            valid = (ks[:, None] < np.minimum(cnt, K)[None, :]) & ~over[None, :]
            kk, rows = np.nonzero(valid)
            if rows.size == 0:
                continue
            tf = np.asarray(out[tf_k], np.int64)
            apos = tf[rows] + posm[kk, rows]
            ok = apos < bt.lengths[rows]
            rows, apos, kk = rows[ok], apos[ok], kk[ok]
            bt.bases[rows, apos] = u8[kk, rows]
            bt.quals[rows, apos] = u8[K + kk, rows]
        if over.any():
            self._host_correct_all(batch1, batch2, out, B,
                                   rows=np.flatnonzero(over))

    def _host_correct_all(self, batch1: ArrayBatch, batch2: ArrayBatch,
                          out, B: int, rows=None):
        """Exact host recomputation of every correctable row (sparse-list
        overflow path); `rows` restricts to the given row indices (the
        rowwise path's per-row overflows)."""
        if "ov_ok" in out:
            do = (out["ov_ok"][:B] & ~out["ov_hasgap"][:B]
                  & (out["ov_diff"][:B] != 0))
        else:  # lean step: the flag bit replaces the per-read ov fields
            do = out["corr_able"][:B]
        if rows is not None:
            m = np.zeros(B, bool)
            m[rows] = True
            do = do & m
        opt = self.opt
        ovp = (opt.overlapDiffLimit, opt.overlapRequire,
               opt.overlapDiffPercentLimit / 100.0)
        tf1, tf2 = out["total_front1"], out["total_front2"]
        b1, q1 = batch1.bases, batch1.quals
        b2, q2 = batch2.bases, batch2.quals
        for i in np.flatnonzero(do):
            s01, s02 = int(tf1[i]), int(tf2[i])
            e1, e2 = int(batch1.lengths[i]), int(batch2.lengths[i])
            s1 = bytearray(b1[i, s01:e1].tobytes())
            qq1 = bytearray(q1[i, s01:e1].tobytes())
            s2 = bytearray(b2[i, s02:e2].tobytes())
            qq2 = bytearray(q2[i, s02:e2].tobytes())
            if "ov_offset" in out:
                off, ol = int(out["ov_offset"][i]), int(out["ov_olen"][i])
            else:
                p1 = int(out["rlen1_pre_ovtrim"][i])
                p2 = int(out["rlen2_pre_ovtrim"][i])
                _, off, ol, _ = host_analyze_overlap(
                    b1[i, s01:s01 + p1], b2[i, s02:s02 + p2], *ovp)
            host_correct_pair(s1, qq1, s2, qq2,
                              int(out["rlen2_pre_ovtrim"][i]),
                              off, ol)
            b1[i, s01:e1] = np.frombuffer(bytes(s1), np.uint8)
            q1[i, s01:e1] = np.frombuffer(bytes(qq1), np.uint8)
            b2[i, s02:e2] = np.frombuffer(bytes(s2), np.uint8)
            q2[i, s02:e2] = np.frombuffer(bytes(qq2), np.uint8)

    def _failed(self, parts, name, seq, strand, qual, pre_trim, tag):
        p0 = int(pre_trim)
        if isinstance(tag, str):
            tag = tag.encode()
        parts["failed"] += [name + b" " + tag, b"\n", seq[p0:], b"\n",
                            strand, b"\n", qual[p0:], b"\n"]

    def _finish(self) -> Dict:
        opt = self.opt
        for c in (self.overrep_pre1, self.overrep_pre2,
                  self.overrep_post1, self.overrep_post2):
            c.flush()
        if self.sharded:
            from ..parallel import multihost
            # gather every shard's accumulators; only process 0 reports
            if not multihost.merge_processor_stats(self, is_pe=True):
                if self.duplicate is not None:
                    self.duplicate.release()
                return {"pre1": self.pre_stats1, "post1": self.post_stats1,
                        "pre2": self.pre_stats2, "post2": self.post_stats2,
                        "filter": self.filter_result, "dup_rate": 0.0,
                        "insert_peak": 0}
        sys.stderr.write("Read1 before filtering:\n")
        self._print_stats(self.pre_stats1)
        sys.stderr.write("\nRead2 before filtering:\n")
        self._print_stats(self.pre_stats2)
        if not opt.merge.enabled:
            sys.stderr.write("\nRead1 after filtering:\n")
            self._print_stats(self.post_stats1)
            sys.stderr.write("\nRead2 after filtering:\n")
            self._print_stats(self.post_stats2)
        else:
            sys.stderr.write("\nMerged and filtered:\n")
            self._print_stats(self.post_stats1)
        sys.stderr.write("\nFiltering result:\n")
        from .runner import SingleEndProcessor
        SingleEndProcessor._print_filter_result(self)

        dup_rate = 0.0
        if opt.duplicate.enabled:
            dup_rate = self.duplicate.get_dup_rate()
            sys.stderr.write("\nDuplication rate: %s%%\n" % cpp_num(dup_rate * 100.0))

        peak = self._peak_insert_size()
        sys.stderr.write("\nInsert size peak (evaluated by paired-end reads): %d\n" % peak)

        if opt.merge.enabled:
            sys.stderr.write("\nRead pairs merged: %d\n" % self.filter_result.merged_pairs)
            if self.post_stats1.get_reads() > 0:
                post_pct = 100.0 * self.filter_result.merged_pairs / self.post_stats1.get_reads()
                pre_pct = 100.0 * self.filter_result.merged_pairs / self.pre_stats1.get_reads()
                sys.stderr.write("%% of original read pairs: %s%%\n" % cpp_num(pre_pct))
                sys.stderr.write("%% in reads after filtering: %s%%\n" % cpp_num(post_pct))
            sys.stderr.write("\n")

        jr = JsonReporter(opt)
        jr.set_dup(dup_rate)
        jr.set_insert_hist(self.insert_hist, peak)
        jr.report(self.filter_result, self.pre_stats1, self.post_stats1,
                  self.pre_stats2, self.post_stats2)
        hr = HtmlReporter(opt)
        hr.set_dup(dup_rate)
        hr.set_insert_hist(self.insert_hist, peak)
        hr.report(self.filter_result, self.pre_stats1, self.post_stats1,
                  self.pre_stats2, self.post_stats2)
        if self.duplicate is not None:
            self.duplicate.release()  # recycle the Bloom buffers (server)
        return {"pre1": self.pre_stats1, "post1": self.post_stats1,
                "pre2": self.pre_stats2, "post2": self.post_stats2,
                "filter": self.filter_result, "dup_rate": dup_rate,
                "insert_peak": peak}

    def _peak_insert_size(self) -> int:
        """reference: src/peprocessor.cpp:337-347"""
        peak = 0
        max_count = -1
        for i in range(self.opt.insertSizeMax):
            if self.insert_hist[i] > max_count:
                peak = i
                max_count = int(self.insert_hist[i])
        return peak

    def _print_stats(self, st):
        from .runner import SingleEndProcessor
        SingleEndProcessor._print_stats(self, st)
