"""Command-line interface, flag-compatible with the reference
(reference: src/main.cpp:16-520).

Every option keeps the reference's long/short name, default, and
behavior-relevant validation; the `command` string recorded in reports is
the joined argv, as in the reference.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

from .config import (Options, error_exit, num2qual, FASTP_TPU_VER,
                     UMI_LOC_INDEX1, UMI_LOC_INDEX2, UMI_LOC_READ1,
                     UMI_LOC_READ2, UMI_LOC_PER_INDEX, UMI_LOC_PER_READ)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="fastp_tpu", add_help=True,
        description="fastp_tpu: ultra-fast all-in-one FASTQ preprocessor on an accelerator")
    a = p.add_argument
    # I/O
    a("-i", "--in1", default="", help="read1 input file name")
    a("-o", "--out1", default="", help="read1 output file name")
    a("-I", "--in2", default="", help="read2 input file name")
    a("-O", "--out2", default="", help="read2 output file name")
    a("--unpaired1", default="")
    a("--unpaired2", default="")
    a("--overlapped_out", default="")
    a("--failed_out", default="")
    a("-m", "--merge", action="store_true")
    a("--merged_out", default="")
    a("--include_unmerged", action="store_true")
    a("-6", "--phred64", action="store_true")
    a("-z", "--compression", type=int, default=4)
    a("--stdin", action="store_true")
    a("--stdout", action="store_true")
    a("--interleaved_in", action="store_true")
    a("--reads_to_process", type=int, default=0)
    a("--dont_overwrite", action="store_true")
    a("--fix_mgi_id", action="store_true")
    a("-V", "--verbose", action="store_true")
    # adapter
    a("-A", "--disable_adapter_trimming", action="store_true")
    a("-a", "--adapter_sequence", default="auto")
    a("--adapter_sequence_r2", default="auto")
    a("--adapter_fasta", default="")
    a("-2", "--detect_adapter_for_pe", action="store_true")
    a("--allow_gap_overlap_trimming", action="store_true")
    # trimming
    a("-f", "--trim_front1", type=int, default=0)
    a("-t", "--trim_tail1", type=int, default=0)
    a("-b", "--max_len1", type=int, default=0)
    a("-F", "--trim_front2", type=int, default=None)
    a("-T", "--trim_tail2", type=int, default=None)
    a("-B", "--max_len2", type=int, default=None)
    # dedup
    a("-D", "--dedup", action="store_true")
    a("--dup_calc_accuracy", type=int, default=None)
    a("--dont_eval_duplication", action="store_true")
    # polyG
    a("-g", "--trim_poly_g", action="store_true")
    a("--poly_g_min_len", type=int, default=10)
    a("-G", "--disable_trim_poly_g", action="store_true")
    # polyX
    a("-x", "--trim_poly_x", action="store_true")
    a("--poly_x_min_len", type=int, default=10)
    # quality cutting
    a("-5", "--cut_front", action="store_true")
    a("-3", "--cut_tail", action="store_true")
    a("-r", "--cut_right", action="store_true")
    a("-W", "--cut_window_size", type=int, default=4)
    a("-M", "--cut_mean_quality", type=int, default=20)
    a("--cut_front_window_size", type=int, default=None)
    a("--cut_front_mean_quality", type=int, default=None)
    a("--cut_tail_window_size", type=int, default=None)
    a("--cut_tail_mean_quality", type=int, default=None)
    a("--cut_right_window_size", type=int, default=None)
    a("--cut_right_mean_quality", type=int, default=None)
    # quality filtering
    a("-Q", "--disable_quality_filtering", action="store_true")
    a("-q", "--qualified_quality_phred", type=int, default=15)
    a("-u", "--unqualified_percent_limit", type=int, default=40)
    a("-n", "--n_base_limit", type=int, default=5)
    a("-e", "--average_qual", type=int, default=0)
    # length filtering
    a("-L", "--disable_length_filtering", action="store_true")
    a("-l", "--length_required", type=int, default=15)
    a("--length_limit", type=int, default=0)
    # low complexity
    a("-y", "--low_complexity_filter", action="store_true")
    a("-Y", "--complexity_threshold", type=int, default=30)
    # index filtering
    a("--filter_by_index1", default="")
    a("--filter_by_index2", default="")
    a("--filter_by_index_threshold", type=int, default=0)
    # correction / overlap
    a("-c", "--correction", action="store_true")
    a("--overlap_len_require", type=int, default=30)
    a("--overlap_diff_limit", type=int, default=5)
    a("--overlap_diff_percent_limit", type=int, default=20)
    # umi
    a("-U", "--umi", action="store_true")
    a("--umi_loc", default="")
    a("--umi_len", type=int, default=0)
    a("--umi_prefix", default="")
    a("--umi_skip", type=int, default=0)
    a("--umi_delim", default=":")
    # overrepresentation
    a("-p", "--overrepresentation_analysis", action="store_true")
    a("-P", "--overrepresentation_sampling", type=int, default=20)
    # reporting
    a("-j", "--json", default="fastp.json")
    a("-h2", "--html", default="fastp.html")
    a("-R", "--report_title", default="fastp report")
    # threading
    a("-w", "--thread", type=int, default=3)
    # splitting
    a("-s", "--split", type=int, default=0)
    a("-S", "--split_by_lines", type=int, default=0)
    a("-d", "--split_prefix_digits", type=int, default=4)
    # deprecated
    a("--cut_by_quality5", action="store_true")
    a("--cut_by_quality3", action="store_true")
    a("--cut_by_quality_aggressive", action="store_true")
    a("--discard_unmerged", action="store_true")
    # fastp_tpu extensions
    a("--batch_size", type=int, default=8192,
      help="reads per device batch (fastp_tpu extension)")
    a("--devices", type=int, default=0,
      help="data-parallel device shards; 0 = all local devices")
    a("--local_processes", type=int, default=0,
      help="self-spawn N record-range-sharded processes on this host "
           "(one per chip on a multi-chip host; merged single report)")
    return p


def options_from_args(args, argv) -> Options:
    opt = Options()
    opt.in1 = args.in1
    opt.in2 = args.in2
    opt.out1 = args.out1
    opt.out2 = args.out2
    opt.unpaired1 = args.unpaired1
    opt.unpaired2 = args.unpaired2
    opt.failedOut = args.failed_out
    opt.overlappedOut = args.overlapped_out
    if not opt.unpaired2:
        opt.unpaired2 = opt.unpaired1
    opt.compression = args.compression
    opt.readsToProcess = args.reads_to_process
    opt.phred64 = args.phred64
    opt.dontOverwrite = args.dont_overwrite
    opt.inputFromSTDIN = args.stdin
    opt.outputToSTDOUT = args.stdout
    opt.interleavedInput = args.interleaved_in
    opt.verbose = args.verbose
    opt.fixMGI = args.fix_mgi_id

    opt.duplicate.dedup = args.dedup
    opt.duplicate.enabled = (not args.dont_eval_duplication) or args.dedup
    if args.dup_calc_accuracy is None:
        opt.duplicate.accuracyLevel = 3 if opt.duplicate.dedup else 1
    else:
        opt.duplicate.accuracyLevel = min(6, max(1, args.dup_calc_accuracy))

    opt.merge.enabled = args.merge
    opt.merge.out = args.merged_out
    opt.merge.includeUnmerged = args.include_unmerged

    opt.adapter.enabled = not args.disable_adapter_trimming
    opt.adapter.detectAdapterForPE = args.detect_adapter_for_pe
    opt.adapter.allowGapOverlapTrimming = args.allow_gap_overlap_trimming
    opt.adapter.sequence = args.adapter_sequence
    opt.adapter.sequenceR2 = args.adapter_sequence_r2
    opt.adapter.fastaFile = args.adapter_fasta
    if (opt.adapter.sequenceR2 == "auto" and not opt.adapter.detectAdapterForPE
            and opt.adapter.sequence != "auto"):
        opt.adapter.sequenceR2 = opt.adapter.sequence
    if opt.adapter.fastaFile:
        opt.loadFastaAdapters()

    opt.trim.front1 = args.trim_front1
    opt.trim.tail1 = args.trim_tail1
    opt.trim.maxLen1 = args.max_len1
    opt.trim.front2 = args.trim_front2 if args.trim_front2 is not None else opt.trim.front1
    opt.trim.tail2 = args.trim_tail2 if args.trim_tail2 is not None else opt.trim.tail1
    opt.trim.maxLen2 = args.max_len2 if args.max_len2 is not None else opt.trim.maxLen1

    if args.trim_poly_g and args.disable_trim_poly_g:
        error_exit("You cannot enabled both trim_poly_g and disable_trim_poly_g")
    elif args.trim_poly_g:
        opt.polyGTrim.enabled = True
    elif args.disable_trim_poly_g:
        opt.polyGTrim.enabled = False
    opt.polyGTrim.minLen = args.poly_g_min_len

    if args.trim_poly_x:
        opt.polyXTrim.enabled = True
    opt.polyXTrim.minLen = args.poly_x_min_len

    opt.qualityCut.enabledFront = args.cut_front or args.cut_by_quality5
    opt.qualityCut.enabledTail = args.cut_tail or args.cut_by_quality3
    opt.qualityCut.enabledRight = args.cut_right or args.cut_by_quality_aggressive
    opt.qualityCut.windowSizeShared = args.cut_window_size
    opt.qualityCut.qualityShared = args.cut_mean_quality
    opt.qualityCut.windowSizeFront = (args.cut_front_window_size
                                      if args.cut_front_window_size is not None
                                      else opt.qualityCut.windowSizeShared)
    opt.qualityCut.qualityFront = (args.cut_front_mean_quality
                                   if args.cut_front_mean_quality is not None
                                   else opt.qualityCut.qualityShared)
    opt.qualityCut.windowSizeTail = (args.cut_tail_window_size
                                     if args.cut_tail_window_size is not None
                                     else opt.qualityCut.windowSizeShared)
    opt.qualityCut.qualityTail = (args.cut_tail_mean_quality
                                  if args.cut_tail_mean_quality is not None
                                  else opt.qualityCut.qualityShared)
    opt.qualityCut.windowSizeRight = (args.cut_right_window_size
                                      if args.cut_right_window_size is not None
                                      else opt.qualityCut.windowSizeShared)
    opt.qualityCut.qualityRight = (args.cut_right_mean_quality
                                   if args.cut_right_mean_quality is not None
                                   else opt.qualityCut.qualityShared)

    opt.qualfilter.enabled = not args.disable_quality_filtering
    opt.qualfilter.qualifiedQual = num2qual(args.qualified_quality_phred)
    opt.qualfilter.unqualifiedPercentLimit = args.unqualified_percent_limit
    opt.qualfilter.avgQualReq = args.average_qual
    opt.qualfilter.nBaseLimit = args.n_base_limit

    opt.lengthFilter.enabled = not args.disable_length_filtering
    opt.lengthFilter.requiredLength = args.length_required
    opt.lengthFilter.maxLength = args.length_limit

    opt.complexityFilter.enabled = args.low_complexity_filter
    opt.complexityFilter.threshold = min(100, max(0, args.complexity_threshold)) / 100.0

    opt.correction.enabled = args.correction
    opt.overlapRequire = args.overlap_len_require
    opt.overlapDiffLimit = args.overlap_diff_limit
    opt.overlapDiffPercentLimit = args.overlap_diff_percent_limit

    opt.thread = args.thread
    opt.jsonFile = args.json
    opt.htmlFile = args.html
    opt.reportTitle = args.report_title

    opt.split.enabled = args.split > 0 or args.split_by_lines > 0
    opt.split.digits = args.split_prefix_digits
    if args.split > 0 and args.split_by_lines > 0:
        error_exit("You cannot set both splitting by file number (--split) and splitting by file lines (--split_by_lines), please choose either.")
    if args.split > 0:
        opt.split.number = args.split
        opt.split.needEvaluation = True
        opt.split.byFileNumber = True
    if args.split_by_lines > 0:
        lines = args.split_by_lines
        if lines % 4 != 0:
            error_exit("Line number (--split_by_lines) should be a multiple of 4")
        opt.split.size = lines // 4
        opt.split.needEvaluation = False
        opt.split.byFileLines = True
    if opt.inputFromSTDIN or opt.in1 == "/dev/stdin":
        if opt.split.needEvaluation:
            error_exit("Splitting by file number is not supported in STDIN mode")

    opt.umi.enabled = args.umi
    opt.umi.length = args.umi_len
    opt.umi.prefix = args.umi_prefix
    opt.umi.skip = args.umi_skip
    opt.umi.delimiter = args.umi_delim
    if opt.umi.enabled:
        umi_loc = args.umi_loc.lower()
        if not umi_loc:
            error_exit("You've enabled UMI by (--umi), you should specify the UMI location by (--umi_loc)")
        if umi_loc not in ("index1", "index2", "read1", "read2", "per_index", "per_read"):
            error_exit("UMI location can only be index1/index2/read1/read2/per_index/per_read")
        if not opt.isPaired() and umi_loc in ("index2", "read2"):
            error_exit("You specified the UMI location as " + umi_loc + ", but the input data is not paired end.")
        if opt.umi.length == 0 and umi_loc in ("read1", "read2", "per_read"):
            error_exit("You specified the UMI location as " + umi_loc + ", but the length is not specified (--umi_len).")
        opt.umi.location = {
            "index1": UMI_LOC_INDEX1, "index2": UMI_LOC_INDEX2,
            "read1": UMI_LOC_READ1, "read2": UMI_LOC_READ2,
            "per_index": UMI_LOC_PER_INDEX, "per_read": UMI_LOC_PER_READ,
        }[umi_loc]

    opt.overRepAnalysis.enabled = args.overrepresentation_analysis
    opt.overRepAnalysis.sampling = args.overrepresentation_sampling

    opt.initIndexFiltering(args.filter_by_index1, args.filter_by_index2,
                           args.filter_by_index_threshold)

    opt.batchSize = args.batch_size
    # FASTP_TPU_DEVICES supplies the default shard count when --devices is
    # left at 0 (operator knob; the test tier pins 1 to keep golden-parity
    # subprocesses off the 8-way forced-host-device mesh)
    opt.deviceCount = args.devices or int(os.environ.get(
        "FASTP_TPU_DEVICES", "0"))

    opt.command = " ".join(argv) + " "
    return opt


def shard_child_env(base, k: int, n: int, cards, servers):
    """Environment of --local_processes child k of n: its shard, its one
    card, and its resident server when FASTP_TPU_SERVERS names them."""
    env = dict(base)
    # one card per child: cards[k] on a GPU host, index k otherwise (a CPU
    # backend ignores it); children routed to servers are thin clients, so
    # any N shares the cards
    slot = k % len(cards) if servers and cards else k
    env["CUDA_VISIBLE_DEVICES"] = cards[slot] if slot < len(cards) else str(k)
    env["FASTP_TPU_SHARD_INDEX"] = str(k)
    env["FASTP_TPU_SHARD_COUNT"] = str(n)
    env.pop("FASTP_TPU_LOCAL_PROCESSES", None)
    if servers:
        env["FASTP_TPU_SERVER"] = servers[k % len(servers)]
    return env


def _spawn_local_shards(argv, n: int, opt) -> int:
    """Self-spawning same-host scale-out: run the job as N record-range-
    sharded processes and merge their stats into one report.

    The reference scales one process with -w N worker threads
    (reference: src/peprocessor.cpp:750-754, src/options.cpp:14); here the
    job runs as N processes, each with its own GIL, page tables and card.
    Children reuse the multi-host machinery (parallel/multihost.py):
    record-aligned input shards, per-shard "0001."-prefixed outputs, exact
    cross-shard dedup, and a single merged JSON/HTML report from shard 0
    via the same-host filesystem exchange.

    Card assignment: child k sees one card, CUDA_VISIBLE_DEVICES=k, so no
    two JAX processes share a card; on a GPU host N may not exceed the
    visible cards.  FASTP_TPU_SERVERS=sock0,sock1,... instead routes child
    k to resident server k%len (one warm server per card), and then any N
    is allowed.
    """
    import subprocess
    from .config import error_exit
    if opt.split.enabled:
        error_exit("--split cannot be combined with --local_processes "
                   "(outputs are already sharded per process)")
    if opt.inputFromSTDIN or opt.in1 in ("/dev/stdin", "-"):
        error_exit("--local_processes does not support STDIN input")
    child_args = []
    i = 1
    while i < len(argv):
        if argv[i] == "--local_processes":
            i += 2
            continue
        if argv[i].startswith("--local_processes="):
            i += 1
            continue
        child_args.append(argv[i])
        i += 1
    servers = [s for s in os.environ.get("FASTP_TPU_SERVERS", "").split(",")
               if s]
    from .parallel.cards import visible_gpus, check_one_process_per_card
    cards = visible_gpus()
    if not servers:
        try:
            check_one_process_per_card(n, cards, "--local_processes")
        except ValueError as e:
            error_exit(str(e))
    log_dir = os.path.dirname(os.path.abspath(opt.jsonFile)) or "."
    procs = []
    logs = []
    for k in range(n):
        env = shard_child_env(os.environ, k, n, cards, servers)
        # shard 0 keeps the console (it prints the merged summary); other
        # shards log to files that surface only on failure
        if k == 0:
            errdst = None
        else:
            logs.append(os.path.join(log_dir, ".fastp_shard_log.%d" % k))
            errdst = open(logs[-1], "wb")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "fastp_tpu"] + child_args,
            env=env, stderr=errdst))
        if errdst is not None:
            errdst.close()
    rc = 0
    for k, p in enumerate(procs):
        r = p.wait()
        if r != 0:
            rc = rc or r
            sys.stderr.write("fastp_tpu: shard %d/%d exited with %d\n"
                             % (k, n, r))
            if k > 0:
                try:
                    with open(os.path.join(
                            log_dir, ".fastp_shard_log.%d" % k), "rb") as f:
                        sys.stderr.buffer.write(f.read()[-4000:])
                except OSError:
                    pass
    if rc == 0:
        for pth in logs:
            try:
                os.unlink(pth)
            except OSError:
                pass
    return rc


def main(argv=None):
    if argv is None:
        argv = sys.argv
    if len(argv) == 1:
        sys.stderr.write("fastp_tpu: an ultra-fast all-in-one FASTQ preprocessor (JAX)\n"
                         "version %s\n" % FASTP_TPU_VER)
        build_parser().print_usage(sys.stderr)
        sys.stderr.write(
            "also: fastp_tpu test                      # built-in self tests\n"
            "      fastp_tpu serve --socket PATH       # resident server "
            "(point jobs at it with FASTP_TPU_SERVER=PATH)\n")
        return 0
    if len(argv) == 2 and argv[1] == "test":
        from .selftest import run_self_tests
        return 0 if run_self_tests() else 1
    if len(argv) == 2 and argv[1] in ("-v", "--version"):
        print("fastp %s" % FASTP_TPU_VER)
        return 0

    # map fastp's -h (html file) vs argparse -h (help): fastp uses -h for html
    cooked = []
    i = 1
    while i < len(argv):
        tok = argv[i]
        if tok == "-h":
            cooked.append("-h2")
        else:
            cooked.append(tok)
        i += 1
    args = build_parser().parse_args(cooked)
    if args.discard_unmerged:
        sys.stderr.write("DEPRECATED: --discard_unmerged has no effect now, see the introduction for merging.\n")

    opt = options_from_args(args, argv)
    t1 = time.time()

    n_local = args.local_processes or int(os.environ.get(
        "FASTP_TPU_LOCAL_PROCESSES", "0"))
    if n_local > 1 and not os.environ.get("FASTP_TPU_SHARD_COUNT"):
        return _spawn_local_shards(argv, n_local, opt)

    # early input existence check (the reference's FastqReader error_exits
    # on open failure before validate runs at main.cpp:485)
    from .config import check_file_valid
    if opt.in1 and not opt.inputFromSTDIN and opt.in1 != "/dev/stdin":
        check_file_valid(opt.in1)
    if opt.in2:
        check_file_valid(opt.in2)

    support_evaluation = not opt.inputFromSTDIN and opt.in1 != "/dev/stdin"
    from .evaluator import Evaluator
    eva = Evaluator(opt)
    if support_evaluation:
        eva.evaluate_seq_len()
        if opt.overRepAnalysis.enabled:
            eva.evaluate_overrep_seqs()

    read_num = 0
    if opt.shallDetectAdapter(False):
        if not support_evaluation:
            sys.stderr.write("Adapter auto-detection is disabled for STDIN mode\n")
        else:
            sys.stderr.write("Detecting adapter sequence for read1...\n")
            adapt, read_num = eva.eval_adapter_and_read_num(False)
            if len(adapt) > 60:
                # reference quirk: main.cpp:455 calls resize(0, 60), which
                # truncates to EMPTY, discarding >60bp detections
                adapt = ""
            if len(adapt) > 0:
                opt.adapter.sequence = adapt
                opt.adapter.detectedAdapter1 = adapt
            else:
                sys.stderr.write("No adapter detected for read1\n")
                opt.adapter.sequence = ""
            sys.stderr.write("\n")
    if opt.shallDetectAdapter(True):
        if not support_evaluation:
            sys.stderr.write("Adapter auto-detection is disabled for STDIN mode\n")
        else:
            sys.stderr.write("Detecting adapter sequence for read2...\n")
            adapt, read_num = eva.eval_adapter_and_read_num(True)
            if len(adapt) > 60:
                adapt = ""  # same reference resize(0, 60) quirk
            if len(adapt) > 0:
                opt.adapter.sequenceR2 = adapt
                opt.adapter.detectedAdapter2 = adapt
            else:
                sys.stderr.write("No adapter detected for read2\n")
                opt.adapter.sequenceR2 = ""
            sys.stderr.write("\n")

    # reference order: validate runs after adapter detection (main.cpp:485)
    opt.validate()

    if opt.split.needEvaluation and support_evaluation:
        if read_num == 0:
            read_num = eva.evaluate_read_num()
        opt.split.size = read_num // opt.split.number
        if opt.split.size <= 0:
            opt.split.size = 1
            sys.stderr.write("WARNING: the input file has less reads than the number of files to split\n")

    if (not args.trim_poly_g and not args.disable_trim_poly_g and support_evaluation):
        if eva.is_two_color_system():
            opt.polyGTrim.enabled = True

    from .pipeline.runner import SingleEndProcessor
    from .pipeline.pe_runner import PairEndProcessor
    from .parallel.mesh import init_distributed
    init_distributed()  # no-op unless JAX_COORDINATOR_ADDRESS is set
    from .parallel import multihost
    if multihost.active():
        # shard the input byte ranges / output names for this process
        multihost.shard_options(opt)

    import contextlib
    prof_dir = os.environ.get("FASTP_TPU_PROFILE")
    if prof_dir:
        import jax
        prof_ctx = jax.profiler.trace(prof_dir)
        sys.stderr.write("Writing xprof trace to %s\n" % prof_dir)
    else:
        prof_ctx = contextlib.nullcontext()
    with prof_ctx:
        if opt.isPaired():
            PairEndProcessor(opt).process()
        else:
            SingleEndProcessor(opt).process()

    t2 = time.time()
    sys.stderr.write("\nJSON report: %s\n" % opt.jsonFile)
    sys.stderr.write("HTML report: %s\n" % opt.htmlFile)
    sys.stderr.write("\n%s\n" % opt.command)
    sys.stderr.write("fastp v%s (fastp_tpu), time used: %d seconds\n"
                     % (FASTP_TPU_VER, int(t2 - t1)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
