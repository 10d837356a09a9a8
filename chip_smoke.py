"""End-to-end smoke run of fastp_tpu on a CUDA GPU.

    python chip_smoke.py                # one card: every phase below
    python chip_smoke.py --four-cards   # four cards: the scale-out paths only

Phases, in order; the first failure ends the run with a nonzero exit code:

  device     the card (nvidia-smi name and power limit), JAX's devices, and
             the native host helper built from fastp_tpu/native/*.cpp
  compile    the PE step at config-3 flags, 64k pairs x width 160: compile
             time and compiled.memory_analysis()
  kernels    every overlap sweep the GPU can run, the f32 conv at L=320 and
             the k-mer counts, each against its numpy reference at real
             width (tools/overlap_sweep_bench.py); then the `gpu`-marked
             tests
  goldens    the eight tests/golden configurations through the CLI (thin
             client -> one `fastp_tpu serve`), byte-compared
  gpu-vs-cpu 131,072 synthetic PE150 pairs plus dirty-alphabet pairs, config
             3 and config 5 on the GPU and in a JAX_PLATFORMS=cpu process:
             FASTQ and JSON (command line normalised) byte-equal
  served     2,000,000 PE150 pairs through the same server: config 3 three
             times, SE config 1 twice, config 5; read totals, wall, reads/s
             and the FASTP_TPU_TIMING stage split

With --four-cards: config 3 on 2,000,000 pairs on one card, with
--devices 4 (one process, dp mesh) and with --local_processes 4 (one
process per card); both must equal the one-card run byte for byte, and
nvidia-smi must show every card busy during each four-card run.

Only one JAX process uses a card at a time: this script itself never starts
JAX; each phase that needs the card is one child process that exits before
the next starts.  Every child meant for the card runs with
JAX_PLATFORMS=cuda, so a card that fails to start ends the run instead of
leaving JAX on the CPU; the server also names its backend on its READY
line, and anything but gpu fails the run.  The last line of standard output
is one JSON object, {"ok": true, "device": {...}}, printed only when every
phase passed.
"""
import argparse
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, ".chip_smoke")
TESTDATA = os.path.join(ROOT, "tests", "testdata")
GOLDEN = os.path.join(ROOT, "tests", "golden")
A1 = "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA"
A2 = "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"
BATCH = ["--batch_size", "65536"]
BIG_PAIRS = 2000000  # the served and four-card corpus, in PE150 pairs
CFG3 = ["--correction", "--cut_right", "-a", A1,
        "--adapter_sequence_r2", A2] + BATCH
CFG5 = ["--merge", "--merged_out", "merged.fq", "--dedup",
        "--overrepresentation_analysis", "-a", A1,
        "--adapter_sequence_r2", A2] + BATCH
PE_OUT = ["-o", "out1.fq", "-O", "out2.fq"]
GOLDENS = {  # tests/test_parity.py's eight configurations
    "cfg1_se_default": (["-i", "R1", "-o", "out.fq"], ["out.fq"]),
    "cfg2_pe_default": (["-i", "R1", "-I", "R2", "-o", "out1.fq",
                         "-O", "out2.fq"], ["out1.fq", "out2.fq"]),
    "cfg3_pe_correction": (["-i", "R1", "-I", "R2", "-o", "out1.fq",
                            "-O", "out2.fq", "--correction", "--cut_right"],
                           ["out1.fq", "out2.fq"]),
    "cfg4_novaseq": (["-i", "R1", "-I", "R2", "-o", "out1.fq", "-O",
                      "out2.fq", "--trim_poly_g", "--trim_poly_x", "--umi",
                      "--umi_loc", "read1", "--umi_len", "4",
                      "--low_complexity_filter"], ["out1.fq", "out2.fq"]),
    "cfg5_merge": (["-i", "R1", "-I", "R2", "--merge", "--merged_out",
                    "merged.fq", "--out1", "out1.fq", "--out2", "out2.fq",
                    "--dedup", "--dup_calc_accuracy", "1",
                    "--overrepresentation_analysis"],
                   ["merged.fq", "out1.fq", "out2.fq"]),
    "cfg6_failed": (["-i", "R1", "-I", "R2", "-o", "out1.fq", "-O",
                     "out2.fq", "--failed_out", "failed.fq", "--unpaired1",
                     "up1.fq", "--unpaired2", "up2.fq", "-l", "100"],
                    ["out1.fq", "out2.fq", "failed.fq", "up1.fq", "up2.fq"]),
    "cfg7_split": (["-i", "R1", "-I", "R2", "-o", "out1.fq", "-O", "out2.fq",
                    "-s", "3", "-w", "1"],
                   ["%04d.out%d.fq" % (s, m) for s in (1, 2, 3)
                    for m in (1, 2)]),
    "cfg8_failed_cut": (["-i", "R1", "-I", "R2", "-o", "o1.fq", "-O",
                         "o2.fq", "--correction", "--cut_right",
                         "--failed_out", "failed.fq", "--unpaired1",
                         "up1.fq", "--overlapped_out", "ov.fq", "-l", "100"],
                        ["o1.fq", "o2.fq", "failed.fq", "up1.fq", "ov.fq"]),
}
_children = []


class PhaseError(Exception):
    pass


def log(msg):
    print(msg, flush=True)


def env_for(platform="cuda", **extra):
    """A child's environment: JAX held to `platform` (the card unless
    told otherwise), this checkout first on the import path."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("FASTP_TPU_SERVER", None)
    env["JAX_PLATFORMS"] = platform
    env.update(extra)
    return env


def start(cmd, **kw):
    p = subprocess.Popen(cmd, **kw)
    _children.append(p)
    return p


def run(cmd, timeout, **kw):
    p = start(cmd, stdout=kw.pop("stdout", subprocess.PIPE),
              stderr=kw.pop("stderr", subprocess.PIPE), text=True, **kw)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        out, err = p.communicate()
        raise PhaseError("timed out after %ds: %s\n%s" % (
            timeout, " ".join(cmd[:6]), (err or "")[-3000:]))
    return p.returncode, out or "", err or ""


def stop_children():
    for p in _children:
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
            p.wait()


def card_line():
    """`name, power.limit` of every card, as nvidia-smi reports them."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.SubprocessError) as e:
        raise PhaseError("nvidia-smi failed: %s" % e)
    if r.returncode != 0 or not r.stdout.strip():
        raise PhaseError("nvidia-smi found no card: %s" % r.stderr.strip())
    return r.stdout.strip()


def md5(path):
    h = hashlib.md5()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 24), b""):
            h.update(chunk)
    return h.hexdigest()


def normalize_json(text):
    return re.sub(r'\t"command": ".*"', '\t"command": "X"', text)


def same_outputs(dir_a, dir_b, names):
    """Names whose bytes differ (JSON: after normalising the command)."""
    bad = []
    for n in names:
        pa, pb = os.path.join(dir_a, n), os.path.join(dir_b, n)
        if not (os.path.exists(pa) and os.path.exists(pb)):
            bad.append(n + " (missing)")
        elif n.endswith(".json"):
            with open(pa) as fa, open(pb) as fb:
                if normalize_json(fa.read()) != normalize_json(fb.read()):
                    bad.append(n)
        elif md5(pa) != md5(pb):
            bad.append(n)
    return bad


def synth(pairs, seed, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    return start([sys.executable, os.path.join(ROOT, "tools", "make_synth.py"),
                  "--reads", str(pairs), "--seed", str(seed),
                  "--out1", os.path.join(out_dir, "R1.fq"),
                  "--out2", os.path.join(out_dir, "R2.fq")],
                 stdout=subprocess.DEVNULL)


def wait_ok(proc, what, timeout):
    try:
        rc = proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        raise PhaseError("%s timed out" % what)
    if rc != 0:
        raise PhaseError("%s exited with %d" % (what, rc))


def append_dirty_pairs(out_dir, n=400, seed=5):
    """Append n pairs whose reads carry lowercase and IUPAC bytes, so the
    dirty-alphabet branch of every sweep runs."""
    import random
    rng = random.Random(seed)
    clean, dirty = "ACGT", "acgtnRYKMSWBDHV"
    with open(os.path.join(out_dir, "R1.fq"), "a") as f1, \
            open(os.path.join(out_dir, "R2.fq"), "a") as f2:
        for i in range(n):
            ins = "".join(rng.choice(clean) for _ in range(rng.randint(90, 220)))
            comp = ins[::-1].translate(str.maketrans("ACGT", "TGCA"))
            for f, seq, mate in ((f1, ins, 1), (f2, comp, 2)):
                s = list(seq[:151].ljust(151, "A"))
                for _ in range(rng.randint(1, 6)):
                    s[rng.randrange(151)] = rng.choice(dirty)
                q = "".join(rng.choice("FF:,F") for _ in range(151))
                f.write("@DIRTY:%d %d:N:0:ACGT\n%s\n+\n%s\n"
                        % (i, mate, "".join(s), q))


# -- phases run in child processes (each owns the card while it runs) ----

def child_device():
    """Device facts, native helper, first compile, sweep checks."""
    import jax
    devs = jax.devices()
    log("jax %s: %s" % (jax.__version__, devs))
    for d in devs:
        log("  device %d: platform=%s kind=%s" % (d.id, d.platform,
                                                  d.device_kind))
    if devs[0].platform != "gpu":
        raise PhaseError("JAX platform is %r, not gpu" % devs[0].platform)
    from fastp_tpu.io import native
    lib = native.get_lib()
    if lib is None:
        raise PhaseError("native helper did not build or load")
    so = native.LIB_PATH
    newest = max(os.path.getmtime(s) for s in native._SRCS)
    if os.path.getmtime(so) < newest:
        raise PhaseError("native helper %s is not built from %s"
                         % (so, native._SRCS))
    log("native helper: %s (built from %s)" % (
        os.path.relpath(so, ROOT),
        ", ".join(os.path.relpath(s, ROOT) for s in native._SRCS)))

    import numpy as np
    from fastp_tpu.cli import build_parser, options_from_args
    from fastp_tpu.pipeline.static_cfg import device_cfg_from_options
    from fastp_tpu.pipeline.device import build_pe_step, aux_arg_names
    argv = ["fastp_tpu", "-i", os.path.join(TESTDATA, "R1.fq"),
            "-I", os.path.join(TESTDATA, "R2.fq")] + PE_OUT + CFG3
    opt = options_from_args(build_parser().parse_args(argv[1:]), argv)
    opt.validate()
    cfg = device_cfg_from_options(opt)
    B, L = 65536, 160
    rng = np.random.default_rng(0)
    b = np.frombuffer(b"ACGT", np.uint8)[rng.integers(0, 4, (B, L))]
    q = rng.integers(35, 75, (B, L), dtype=np.uint8)
    n = np.full(B, 151, np.int32)
    aux = []
    for name in aux_arg_names(cfg):
        if name.startswith("pre_trim"):
            aux.append(np.zeros(B, np.int16))
        elif name == "nvalid":
            aux.append(np.int32(B))
        else:
            aux.append(np.zeros(B, bool))
    step = build_pe_step(cfg, mega=True)
    t0 = time.perf_counter()
    compiled = step.lower(b, q, n, b[:, ::-1].copy(), q, n, *aux).compile()
    log("compile: PE step, config-3 flags, B=%d L=%d: %.1fs" % (
        B, L, time.perf_counter() - t0))
    log("compile: memory_analysis: %s" % (compiled.memory_analysis(),))
    out = compiled(b, q, n, b[:, ::-1].copy(), q, n, *aux)
    jax.block_until_ready(out)

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import overlap_sweep_bench
    if not overlap_sweep_bench.op_phase(B, L, seed=11):
        raise PhaseError("an overlap sweep or the k-mer counts differ from "
                         "their numpy reference")
    kinds = {d.device_kind for d in devs}
    print(json.dumps({"platform": devs[0].platform,
                      "kind": sorted(kinds)[0], "count": len(devs)}))


# -- phases run here -----------------------------------------------------

def phase_child(name, timeout):
    cmd = [sys.executable, os.path.abspath(__file__), "--child", name]
    rc, out, err = run(cmd, timeout, env=env_for(), cwd=ROOT)
    lines = out.strip().splitlines()
    for ln in lines[:-1]:
        log("  " + ln)
    if rc != 0 or not lines:
        raise PhaseError("child %s exited with %d:\n%s%s" % (
            name, rc, out[-2000:], err[-4000:]))
    return json.loads(lines[-1])


def phase_gpu_tests():
    """The `gpu`-marked tests, named by file: a `tests` package installed
    elsewhere can shadow this repo's tests/ for cross-test imports."""
    files = []
    for f in sorted(os.listdir(os.path.join(ROOT, "tests"))):
        if f.startswith("test_") and f.endswith(".py"):
            with open(os.path.join(ROOT, "tests", f)) as fh:
                if "pytest.mark.gpu" in fh.read():
                    files.append(os.path.join("tests", f))
    rc, out, err = run([sys.executable, "-m", "pytest", "-q", "-m", "gpu",
                        "-p", "no:cacheprovider"] + files, 900,
                       env=env_for("cuda,cpu"), cwd=ROOT)
    tail = out.strip().splitlines()[-1:] or [""]
    log("gpu tests: %s" % tail[0])
    if rc != 0 or "skipped" in tail[0] or "passed" not in tail[0]:
        raise PhaseError("gpu-marked tests did not all pass:\n%s%s"
                         % (out[-3000:], err[-2000:]))


class Server:
    """One `fastp_tpu serve` whose READY line must name the backend
    `expect`; jobs go through the thin client."""

    def __init__(self, workdir=WORK, platform="cuda", expect="gpu"):
        self.sock = os.path.join(workdir, "serve.sock")
        self.platform = platform
        try:
            os.unlink(self.sock)
        except OSError:
            pass
        self.err_path = os.path.join(workdir, "serve.err")
        self.err = open(self.err_path, "w")
        t0 = time.perf_counter()
        self.proc = start([sys.executable, "-m", "fastp_tpu", "serve",
                           "--socket", self.sock],
                          env=env_for(platform, FASTP_TPU_TIMING="1"),
                          cwd=workdir, stdout=subprocess.PIPE,
                          stderr=self.err, text=True)
        while True:
            line = self.proc.stdout.readline()
            if line.startswith("READY"):
                break
            if not line:
                raise PhaseError("server died before READY:\n"
                                 + open(self.err_path).read()[-4000:])
        backend = line.split()[-1]
        if backend != expect:
            self.proc.kill()
            self.proc.wait()
            self.err.close()
            raise PhaseError("server runs on %s, not %s: %s"
                             % (backend, expect, line.strip()))
        log("server READY on %s after %.1fs"
            % (backend, time.perf_counter() - t0))

    def job(self, args, cwd, timeout=900):
        os.makedirs(cwd, exist_ok=True)
        t0 = time.perf_counter()
        rc, out, err = run([sys.executable, "-m", "fastp_tpu"] + args,
                           timeout, cwd=cwd,
                           env=env_for(self.platform,
                                       FASTP_TPU_SERVER=self.sock))
        wall = time.perf_counter() - t0
        if rc != 0:
            raise PhaseError("job %s exited with %d:\n%s" % (
                " ".join(args), rc, err[-4000:]))
        if self.proc.poll() is not None:  # the client ran the job itself
            raise PhaseError("server exited during job %s" % " ".join(args))
        return wall, err

    def close(self):
        from_client = subprocess.run(
            [sys.executable, "-c", "from fastp_tpu.client import "
             "shutdown_server; shutdown_server(%r)" % self.sock],
            env=env_for("cpu"), cwd=ROOT, timeout=60)
        try:
            self.proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            self.proc.kill()
        self.err.close()
        if from_client.returncode != 0 or self.proc.returncode != 0:
            raise PhaseError("server did not shut down cleanly")


def phase_goldens(srv):
    r = {"R1": os.path.join(TESTDATA, "R1.fq"),
         "R2": os.path.join(TESTDATA, "R2.fq")}
    for name, (args, outs) in GOLDENS.items():
        d = os.path.join(WORK, "golden", name)
        shutil.rmtree(d, ignore_errors=True)
        wall, _ = srv.job([r.get(a, a) for a in args], d)
        bad = same_outputs(d, os.path.join(GOLDEN, name),
                           outs + ["fastp.json"])
        if bad:
            raise PhaseError("golden %s differs: %s" % (name, bad))
        log("golden %-20s byte-equal (%d files, %.1fs)"
            % (name, len(outs) + 1, wall))


def _pe_args(data, extra):
    return ["-i", os.path.join(data, "R1.fq"), "-I",
            os.path.join(data, "R2.fq")] + PE_OUT + extra


def start_cpu_reference(data, name, extra):
    d = os.path.join(WORK, "cpu_" + name)
    shutil.rmtree(d, ignore_errors=True)
    os.makedirs(d)
    err = open(os.path.join(d, "stderr.txt"), "w")
    return d, start([sys.executable, "-m", "fastp_tpu"] + _pe_args(data, extra),
                    cwd=d, env=env_for("cpu"), stdout=subprocess.DEVNULL,
                    stderr=err)


def json_total_reads(path):
    with open(path) as f:
        return json.load(f)["summary"]["before_filtering"]["total_reads"]


def timing_lines(err):
    return [ln for ln in err.splitlines() if ln.startswith("TIMING")]


def phase_served(srv, data, pairs, card):
    se_data = os.path.join(data, "R1.fq")
    jobs = [("config3 #%d" % k, _pe_args(data, CFG3), 2 * pairs)
            for k in (1, 2, 3)]
    # the first SE job compiles the SE step; the second is steady state
    jobs += [("SE config1 #%d" % k, ["-i", se_data, "-o", "out.fq"] + BATCH,
              pairs) for k in (1, 2)]
    jobs.append(("config5", _pe_args(data, CFG5), 2 * pairs))
    for name, args, reads in jobs:
        d = os.path.join(WORK, "served")
        shutil.rmtree(d, ignore_errors=True)
        wall, err = srv.job(args, d, timeout=1200)
        total = json_total_reads(os.path.join(d, "fastp.json"))
        if total != reads:
            raise PhaseError("%s: JSON total_reads %d, input has %d"
                             % (name, total, reads))
        log("served %-11s %d reads: wall %.2fs, %.0f reads/s [%s]"
            % (name, reads, wall, reads / wall, card))
        for ln in timing_lines(err):
            log("    " + ln)
    shutil.rmtree(os.path.join(WORK, "served"), ignore_errors=True)


def one_card():
    card = card_line()
    log("card: %s" % card)
    os.makedirs(WORK, exist_ok=True)
    # CPU-only preparation overlaps the card phases: corpora, then the
    # JAX_PLATFORMS=cpu reference runs
    par = os.path.join(WORK, "parity")
    big = os.path.join(WORK, "big")
    gen_par = synth(131072, 3, par)
    gen_big = synth(BIG_PAIRS, 4, big)

    dev = phase_child("device", 900)
    log("phase device+compile+kernels: ok")
    phase_gpu_tests()

    wait_ok(gen_par, "parity corpus", 600)
    append_dirty_pairs(par)
    cpu = {name: start_cpu_reference(par, name, extra)
           for name, extra in (("config3", CFG3), ("config5", CFG5))}

    srv = Server()
    try:
        phase_goldens(srv)
        for name, extra in (("config3", CFG3), ("config5", CFG5)):
            d = os.path.join(WORK, "gpu_" + name)
            shutil.rmtree(d, ignore_errors=True)
            wall, _ = srv.job(_pe_args(par, extra), d)
            cdir, proc = cpu[name]
            wait_ok(proc, "CPU reference " + name, 900)
            outs = [f for f in sorted(os.listdir(cdir))
                    if f.endswith(".fq") or f == "fastp.json"]
            bad = same_outputs(d, cdir, outs)
            if bad or len(outs) < 3:
                raise PhaseError("GPU and CPU differ for %s: %s (compared %s)"
                                 % (name, bad, outs))
            log("gpu-vs-cpu %s: %s byte-equal (GPU job %.1fs)"
                % (name, ", ".join(outs), wall))
        wait_ok(gen_big, "2M-pair corpus", 900)
        phase_served(srv, big, BIG_PAIRS, card)
    finally:
        srv.close()
    shutil.rmtree(big, ignore_errors=True)
    return dev


class CardSampler(threading.Thread):
    """Highest nvidia-smi utilization.gpu seen on each card while a run
    goes (this process stays off JAX, so it never holds a card)."""

    def __init__(self):
        super().__init__(daemon=True)
        self.halt = threading.Event()
        self.peak = {}

    def run(self):
        while not self.halt.is_set():
            try:
                r = subprocess.run(
                    ["nvidia-smi", "--query-gpu=index,utilization.gpu",
                     "--format=csv,noheader,nounits"],
                    capture_output=True, text=True, timeout=30)
                for ln in r.stdout.splitlines():
                    idx, util = (int(x) for x in ln.split(","))
                    self.peak[idx] = max(self.peak.get(idx, 0), util)
            except (OSError, ValueError, subprocess.SubprocessError):
                pass
            self.halt.wait(0.2)

    def __enter__(self):
        self.start()
        return self

    def __exit__(self, *exc):
        self.halt.set()
        self.join()


def four_cards():
    card = card_line()
    log("cards: %s" % card.replace("\n", " | "))
    if len(card.splitlines()) < 4:
        raise PhaseError("four cards needed, nvidia-smi lists %d"
                         % len(card.splitlines()))
    os.makedirs(WORK, exist_ok=True)
    data = os.path.join(WORK, "big")
    wait_ok(synth(BIG_PAIRS, 4, data), "2M-pair corpus", 900)
    runs = {}
    for name, extra in (("1card", ["--devices", "1"]),
                        ("devices4", ["--devices", "4"]),
                        ("local_processes4", ["--local_processes", "4"])):
        d = os.path.join(WORK, name)
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        env = env_for()
        if name == "1card":
            env["CUDA_VISIBLE_DEVICES"] = "0"
        walls = []
        for _ in range(2):  # the first run compiles
            with CardSampler() as sampler:
                t0 = time.perf_counter()
                rc, _, err = run([sys.executable, "-m", "fastp_tpu"]
                                 + _pe_args(data, CFG3 + extra), 1200,
                                 cwd=d, env=env)
                walls.append(time.perf_counter() - t0)
            if rc != 0:
                raise PhaseError("%s exited with %d:\n%s"
                                 % (name, rc, err[-4000:]))
        runs[name] = d
        log("%-17s %d reads: first %.2fs, wall %.2fs, %.0f reads/s, "
            "peak utilization per card %s [%s]"
            % (name, 2 * BIG_PAIRS, walls[0], walls[1],
               2 * BIG_PAIRS / walls[1],
               dict(sorted(sampler.peak.items())), card.splitlines()[0]))
        if name != "1card" and (len(sampler.peak) < 4
                                or min(sampler.peak.values()) == 0):
            raise PhaseError("%s left a card idle: %s" % (name, sampler.peak))
    base = runs["1card"]
    for name in ("devices4", "local_processes4"):
        d = runs[name]
        if name == "local_processes4":
            for out in ("out1.fq", "out2.fq"):
                with open(os.path.join(d, out), "wb") as f:
                    for s in range(4):
                        with open(os.path.join(d, "%04d.%s" % (s + 1, out)),
                                  "rb") as g:
                            shutil.copyfileobj(g, f)
        bad = same_outputs(d, base, ["out1.fq", "out2.fq", "fastp.json"])
        if bad:
            raise PhaseError("%s differs from the one-card run: %s"
                             % (name, bad))
        log("%s: FASTQ and merged JSON byte-equal to the one-card run" % name)
    shutil.rmtree(data, ignore_errors=True)
    dev = phase_child("device_count", 300)
    if dev["count"] != 4:
        raise PhaseError("JAX sees %d devices, not 4" % dev["count"])
    return dev


def child_device_count():
    import jax
    devs = jax.devices()
    print(json.dumps({"platform": devs[0].platform,
                      "kind": devs[0].device_kind, "count": len(devs)}))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.child:
        sys.path.insert(0, ROOT)
        try:
            if a.child == "device":
                child_device()
            elif a.child == "device_count":
                child_device_count()
        except PhaseError as e:
            sys.stderr.write("FAILED: %s\n" % e)
            return 1
        return 0
    t0 = time.perf_counter()
    try:
        dev = four_cards() if a.four_cards else one_card()
        if dev["platform"] != "gpu":
            raise PhaseError("not a GPU: %s" % dev)
    except PhaseError as e:
        log("FAILED: %s" % e)
        return 1
    finally:
        stop_children()
    log("all phases passed in %.1fs" % (time.perf_counter() - t0))
    print(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
