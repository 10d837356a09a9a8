"""Benchmark driver: prints ONE JSON line
{"metric": ..., "value": N, "unit": ..., "vs_baseline": N, ...raw data}.

Measures end-to-end PE preprocessing throughput (reads/sec/chip) on a
synthetic 150bp PE corpus with the full default pipeline plus correction and
sliding-window cutting (BASELINE config 3 flavor), explicit adapters for
both programs.  vs_baseline compares against reference fastp with 16 worker
threads measured on this host (tools/bench_baseline.json caches the number
if the reference binary is unavailable at bench time).

Protocol: the reference runs cold each time (its startup is trivial).
fastp_tpu runs in its deployment mode — a resident server process
(`fastp_tpu serve`) started once per card: the first (warmup) job pays the
accelerator's one-time costs (client start + XLA compile); timed jobs then
run at steady state through the millisecond-startup thin client, exactly as
a production pipeline feeding many FASTQ files would.  Raw per-run seconds
for BOTH sides plus the warmup cost are emitted so the protocol and any
baseline drift are auditable.  The output does not yet name the device;
chip_smoke.py is the check that the system runs on a GPU.

Deadline safety: the whole bench self-budgets against BENCH_BUDGET seconds
(default 1100).  A watchdog thread emits the best-available JSON snapshot
and exits just before the budget runs out, so a slow phase (corpus or
reference binary regeneration) can never end the bench with NO output.
Phases run most-important-first (corpus -> our timed runs -> baseline ->
optional gz variant) and each phase checks the remaining budget before
starting.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
BENCH_DIR = os.path.join(ROOT, ".bench", "fastp_bench")
N_PAIRS = int(os.environ.get("BENCH_PAIRS", "2000000"))
REF_BIN = "/tmp/refbuild/fastp"
BASELINE_CACHE = os.path.join(ROOT, "tools", "bench_baseline.json")
SOCK = os.path.join(BENCH_DIR, "serve.sock")

FLAGS = ["--correction", "--cut_right",
         "-a", "AGATCGGAAGAGCACACGTCTGAACTCCAGTCA",
         "--adapter_sequence_r2", "AGATCGGAAGAGCGTCGTGTAGGGAAAGAGTGT"]
ARGS = ["-i", os.path.join(BENCH_DIR, "R1.fq"),
        "-I", os.path.join(BENCH_DIR, "R2.fq"),
        "-o", "out1.fq", "-O", "out2.fq"] + FLAGS

REPEATS = int(os.environ.get("BENCH_REPEATS", "9"))
# Default budget sits under plausible external timeouts; the watchdog
# emits whatever has been gathered by BUDGET-25s.
BUDGET = float(os.environ.get("BENCH_BUDGET", "1100"))
T0 = time.time()

CORPUS_VERSION = "v3-nova4"  # bump when make_synth output changes


def remaining():
    return BUDGET - (time.time() - T0)


# ---------------------------------------------------------------------------
# snapshot state + guaranteed single-line emission

_emit_lock = threading.Lock()
_emitted = False
SNAP = {
    "runs": [],          # our timed run seconds
    "warmup": None,
    "ref_runs": [],
    "gz_runs": [],
    "baseline": 0.0,
    "baseline_source": None,
    "notes": [],
    "protocol": "median of steady-state runs through a resident pre-warmed "
                "server (fastp_tpu serve --warm-run); reference cold-started "
                "per run; budget-supervised (BENCH_BUDGET=%ds)" % BUDGET,
}
_children = []  # live Popen objects the watchdog must reap


def _run(cmd, **kw):
    """subprocess.run equivalent that registers the child in _children so
    the watchdog's emit_and_exit can SIGKILL an in-flight client instead of
    orphaning it past the bench's own exit."""
    timeout = kw.pop("timeout", None)
    check = kw.pop("check", False)
    if kw.pop("capture_output", False):
        kw["stdout"] = subprocess.PIPE
        kw["stderr"] = subprocess.PIPE
    p = subprocess.Popen(cmd, **kw)
    _children.append(p)
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        raise
    finally:
        try:
            _children.remove(p)
        except ValueError:
            pass
    if check and p.returncode != 0:
        raise subprocess.CalledProcessError(p.returncode, cmd, out, err)
    return subprocess.CompletedProcess(cmd, p.returncode, out, err)


def _median(xs):
    xs = sorted(xs)
    n = len(xs)
    return (xs[n // 2] if n % 2 else (xs[n // 2 - 1] + xs[n // 2]) / 2.0)


def emit_and_exit(code=0):
    """Print the ONE result line from current snapshot state and exit.

    The whole emission happens INSIDE the lock: a losing caller blocks
    until the winner's write+flush is complete, so its os._exit can never
    truncate the result line (the old release-then-write window could)."""
    global _emitted
    _emit_lock.acquire()
    if _emitted:
        _emit_lock.release()
        os._exit(code)
    _emitted = True
    runs = list(SNAP["runs"])
    baseline = SNAP["baseline"]
    ours = 2 * N_PAIRS / _median(runs) if runs else 0.0
    best = 2 * N_PAIRS / min(runs) if runs else 0.0
    rec = {
        "metric": "pe150_full_pipeline_reads_per_sec_per_chip",
        "value": round(ours, 1),
        "unit": "reads/s",
        "vs_baseline": round(ours / baseline, 4) if baseline and runs else None,
        "pairs": N_PAIRS,
        "runs_seconds": [round(r, 2) for r in runs],
        "best_reads_per_sec": round(best, 1),
        # cold-start operability: run 0 is the FIRST client job through the
        # freshly warmed server, so its overhead over the steady median is
        # the recorded first-job-after-warm cost
        "first_job_over_steady_seconds": (
            round(runs[0] - _median(runs), 2) if len(runs) >= 3 else None),
        "run_spread_max_over_min": (
            round(max(runs) / min(runs), 3) if runs else None),
        "server_warmup_seconds": (round(SNAP["warmup"], 2)
                                  if SNAP["warmup"] else None),
        "ref_runs_seconds": [round(r, 2) for r in SNAP["ref_runs"]],
        "gz_input_runs_seconds": [round(r, 2) for r in SNAP["gz_runs"]],
        # >1.0 means gz input runs FASTER than the plain-text median;
        # median/median (the old min-based form flattered the gz side)
        "plain_over_gz_median": (
            round(_median(runs) / _median(SNAP["gz_runs"]), 3)
            if SNAP["gz_runs"] and runs else None),
        "baseline_reads_per_sec": round(baseline, 1),
        "baseline_source": SNAP["baseline_source"],
        "elapsed_seconds": round(time.time() - T0, 1),
        "protocol": SNAP["protocol"],
    }
    if SNAP["notes"]:
        rec["notes"] = SNAP["notes"]
    sys.stdout.write(json.dumps(rec) + "\n")
    sys.stdout.flush()
    # snapshot: _run() on other threads mutates _children concurrently, and
    # index-based iteration over a shrinking list can skip a live child
    for p in list(_children):
        if p.poll() is None:
            try:
                p.send_signal(signal.SIGKILL)
            except OSError:
                pass
    os._exit(code)


def _watchdog():
    # leave 25s of slack for snapshot emission before the external timeout
    while True:
        r = remaining()
        if r <= 25:
            SNAP["notes"].append("watchdog: budget exhausted, partial result")
            emit_and_exit(0)
        time.sleep(min(10.0, max(1.0, r - 25)))


# ---------------------------------------------------------------------------
# phases

def ensure_corpus():
    r1 = os.path.join(BENCH_DIR, "R1.fq")
    vfile = os.path.join(BENCH_DIR, "corpus_version")
    ver_ok = (os.path.exists(vfile)
              and open(vfile).read().strip() == CORPUS_VERSION)
    # ~330 bytes/record: require the file to match the requested N_PAIRS
    if not (ver_ok and os.path.exists(r1)
            and N_PAIRS * 250 < os.path.getsize(r1) < N_PAIRS * 450):
        os.makedirs(BENCH_DIR, exist_ok=True)
        _run([sys.executable,
                        os.path.join(ROOT, "tools", "make_synth.py"),
                        "--reads", str(N_PAIRS),
                        "--out1", r1, "--out2", os.path.join(BENCH_DIR, "R2.fq")],
                       check=True, timeout=max(60, remaining() - 60))
        with open(vfile, "w") as f:
            f.write(CORPUS_VERSION)
    w1 = os.path.join(BENCH_DIR, "warm_R1.fq")
    # 8 batches at 32k pairs: enough to reach the run-time allocation
    # high-water mark (route/serialize workspaces, dup Bloom commit, glibc
    # arena growth) so the FIRST timed run matches steady state
    n_warm = 262144
    if not (ver_ok and os.path.exists(w1)
            and n_warm * 250 < os.path.getsize(w1) < n_warm * 450):
        _run([sys.executable,
                        os.path.join(ROOT, "tools", "make_synth.py"),
                        "--reads", str(n_warm), "--seed", "7",
                        "--out1", w1,
                        "--out2", os.path.join(BENCH_DIR, "warm_R2.fq")],
                       check=True, timeout=max(60, remaining() - 60))


def _load_baseline_cache():
    if not os.path.exists(BASELINE_CACHE):
        return None
    try:
        with open(BASELINE_CACHE) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _use_cache(cache, tag):
    SNAP["baseline"] = cache["fastp_w16_reads_per_sec"]
    SNAP["baseline_source"] = tag
    SNAP["ref_runs"] = cache.get("raw_seconds", [])


def measure_reference():
    """Baseline reads/s for fastp -w 16 on this host.

    Re-measures IN-SESSION whenever enough budget remains after our own
    runs (the reference is protocol-sensitive to host load).  The
    cache (tools/bench_baseline.json) is the fallback when budget or the
    binary is unavailable; it records raw seconds + host_cores +
    corpus_version so any reuse is auditable.  Like our own headline, the
    baseline is the MEDIAN of its runs.
    """
    cache = _load_baseline_cache()
    cache_ok = (cache and cache.get("pairs") == N_PAIRS
                and cache.get("host_cores") == os.cpu_count()
                and cache.get("corpus_version") == CORPUS_VERSION)
    if not os.path.exists(REF_BIN) and remaining() > 700:
        try:  # /tmp wiped between sessions: rebuild the reference
            _run(["sh", os.path.join(ROOT, "tools", "build_reference.sh")],
                 check=True, capture_output=True,
                 timeout=max(60, remaining() - 500))
        except subprocess.SubprocessError as e:
            SNAP["notes"].append("reference rebuild failed: %s" % (e,))
    if not os.path.exists(REF_BIN):
        if cache_ok:
            _use_cache(cache, "cache(host_cores=%d)" % os.cpu_count())
        elif cache:  # stale cache beats nothing; flag it
            _use_cache(cache, "stale-cache(pairs=%s,cores=%s,corpus=%s)" % (
                cache.get("pairs"), cache.get("host_cores"),
                cache.get("corpus_version")))
        else:
            SNAP["notes"].append("no reference binary and no cache")
        return
    # measuring within this run needs generous slack; fall back to the cache
    # below 400s
    if remaining() < 400:
        if cache_ok:
            _use_cache(cache, "cache(host_cores=%d)" % os.cpu_count())
            SNAP["notes"].append("baseline from cache (budget left %.0fs)"
                                 % remaining())
        elif cache:
            _use_cache(cache, "stale-cache")
        return
    workdir = os.path.join(BENCH_DIR, "ref_run")
    os.makedirs(workdir, exist_ok=True)
    runs = []
    n_runs = 2 if remaining() > 800 else 1
    for _ in range(n_runs):
        if remaining() < 120:
            break
        t0 = time.time()
        try:
            _run([REF_BIN] + ARGS + ["-w", "16"], cwd=workdir,
                           check=True, capture_output=True,
                           timeout=max(60, remaining() - 60))
        except subprocess.SubprocessError as e:
            SNAP["notes"].append("ref run failed: %s" % (e,))
            break
        runs.append(time.time() - t0)
        SNAP["ref_runs"] = list(runs)
        # keep the watchdog snapshot honest mid-measurement
        SNAP["baseline"] = 2 * N_PAIRS / _median(runs)
        SNAP["baseline_source"] = "measured(n=%d)" % len(runs)
    if not runs:
        if cache:
            _use_cache(cache, "stale-cache")
        return
    med = 2 * N_PAIRS / _median(runs)
    SNAP["baseline"] = med
    SNAP["baseline_source"] = "measured"
    if N_PAIRS >= 1000000:
        try:
            with open(BASELINE_CACHE, "w") as f:
                json.dump({"fastp_w16_reads_per_sec": med, "pairs": N_PAIRS,
                           "host_cores": os.cpu_count(),
                           "corpus_version": CORPUS_VERSION,
                           "previous_value": (cache or {}).get(
                               "fastp_w16_reads_per_sec"),
                           "raw_seconds": [round(r, 2) for r in runs]}, f)
        except OSError:
            pass


def _client_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["FASTP_TPU_SERVER"] = SOCK
    # glibc (2.34+) MADV_HUGEPAGEs malloc arenas: on virtualized hosts with
    # slow 4KB faults this cuts first-touch cost.  mmap_threshold /
    # trim_threshold: the per-batch multi-MB numpy buffers otherwise go
    # through mmap/munmap per batch and re-fault every page every batch.
    # Keeping big blocks in the arena reuses already-faulted pages.
    # Tunables are only read at process start, so set them for the children.
    tun = env.get("GLIBC_TUNABLES", "")
    for kv in ("glibc.malloc.hugetlb=1",
               "glibc.malloc.mmap_threshold=1073741824",
               "glibc.malloc.trim_threshold=1073741824"):
        if kv.split("=")[0] not in tun:
            tun = tun + (":" if tun else "") + kv
    env["GLIBC_TUNABLES"] = tun
    return env


class _ExternalServer:
    """Marker for an already-running resident server the bench reuses
    (deployment mode: one warm server per host serves many jobs).  Not a
    child of this process: never killed, never shut down."""

    def poll(self):
        return None


def _probe_server(timeout=30.0):
    """True when a live resident server answers a --version job on SOCK.

    Raw-socket mirror of fastp_tpu.client's frame protocol with a hard
    timeout (a wedged leftover server must not hang the bench), output
    discarded (the bench's stdout is the ONE json result line)."""
    import socket
    import struct
    conn = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    conn.settimeout(timeout)
    try:
        conn.connect(SOCK)
        req = json.dumps({"op": "run", "argv": ["fastp_tpu", "--version"],
                          "cwd": BENCH_DIR, "env": {}}) + "\n"
        conn.sendall(req.encode())

        def recv_exact(n):
            parts = []
            while n:
                b = conn.recv(n)
                if not b:
                    raise ConnectionError("closed")
                parts.append(b)
                n -= len(b)
            return b"".join(parts)

        while True:
            tag = recv_exact(1)
            (n,) = struct.unpack("<I", recv_exact(4))
            payload = recv_exact(n) if n else b""
            if tag == b"R":
                return json.loads(payload).get("rc") == 0
    except (OSError, ValueError, ConnectionError):
        return False
    finally:
        conn.close()


def _start_server(env, wait_budget):
    # an already-running warm server (left by a previous bench/session or
    # started by an operator) is the deployment mode — reuse it when it
    # answers
    if os.path.exists(SOCK) and _probe_server():
        SNAP["notes"].append("reused already-running warm server")
        return _ExternalServer()
    try:
        os.unlink(SOCK)
    except OSError:
        pass
    warm_dir = os.path.join(BENCH_DIR, "warm_run")
    os.makedirs(warm_dir, exist_ok=True)
    warm_argv = ["fastp_tpu",
                 "-i", os.path.join(BENCH_DIR, "warm_R1.fq"),
                 "-I", os.path.join(BENCH_DIR, "warm_R2.fq"),
                 "-o", os.path.join(warm_dir, "w1.fq"),
                 "-O", os.path.join(warm_dir, "w2.fq"),
                 "-j", os.path.join(warm_dir, "w.json"),
                 "-h", os.path.join(warm_dir, "w.html")] + FLAGS + [
                 "--batch_size", "65536"]
    serve_err = open(os.path.join(BENCH_DIR, "serve.err"), "w")
    senv = dict(env)
    senv["FASTP_TPU_TIMING"] = "1"  # per-run stage splits land in serve.err
    proc = subprocess.Popen(
        [sys.executable, "-m", "fastp_tpu", "serve", "--socket", SOCK,
         "--warm-run", json.dumps(warm_argv)],
        env=senv, cwd=BENCH_DIR, stdout=subprocess.PIPE,
        stderr=serve_err, text=True)
    _children.append(proc)
    # the warm run absorbs the cold XLA compile when the persistent cache
    # misses.  readline() blocks, so a killer thread fires at the wait
    # budget (readline then returns at EOF) — without it a silently-hung
    # backend init would wedge the whole bench.
    deadline = time.time() + wait_budget
    killer = threading.Timer(wait_budget, proc.send_signal, (signal.SIGKILL,))
    killer.daemon = True
    killer.start()
    try:
        while time.time() < deadline:
            line = proc.stdout.readline()
            if line.startswith("READY"):
                return proc
            if proc.poll() is not None or not line:
                return None
    finally:
        killer.cancel()
    proc.send_signal(signal.SIGKILL)
    return None


def _stop_server(proc, env):
    if isinstance(proc, _ExternalServer):
        return  # not ours: leave it warm for the next job/bench
    try:
        _run([sys.executable, "-c",
                        "from fastp_tpu.client import shutdown_server;"
                        "shutdown_server(%r)" % SOCK],
                       env=env, timeout=60)
        proc.wait(timeout=30)
    except (subprocess.SubprocessError, OSError):
        proc.send_signal(signal.SIGKILL)  # exact PID we started


def _ensure_gz_corpus():
    """One-time gzip copies of the corpus (gzipped INPUT bench variant).

    Compresses through fastp_tpu's native libdeflate writer (multi-member,
    one member per 4MB chunk), falling back to the gzip CLI.
    """
    paths = []
    for name in ("R1.fq", "R2.fq"):
        src = os.path.join(BENCH_DIR, name)
        dst = src + ".gz"
        if not (os.path.exists(dst)
                and os.path.getmtime(dst) >= os.path.getmtime(src)):
            # compress to a temp path and os.replace: a mid-compress kill
            # (budget watchdog / timeout) must never leave a truncated .gz
            # that the mtime check above would accept as a valid corpus
            tmp = dst + ".tmp"
            r = _run(
                [sys.executable, os.path.join(ROOT, "tools", "gzip_corpus.py"),
                 src, tmp], env=_client_env(),
                timeout=max(30, remaining() - 60))
            if r.returncode != 0:
                with open(tmp, "wb") as f:
                    _run(["gzip", "-1", "-c", src], stdout=f,
                                   check=True,
                                   timeout=max(30, remaining() - 60))
            os.replace(tmp, dst)
        paths.append(dst)
    return paths


def measure_ours():
    """Timed steady-state runs through the pre-warmed resident server.

    Updates SNAP incrementally so the watchdog snapshot always reflects
    every completed run.  Falls back to cold per-process runs if the
    server never reaches READY inside its wait budget.
    """
    workdir = os.path.join(BENCH_DIR, "run")
    os.makedirs(workdir, exist_ok=True)
    env = _client_env()
    # 64k batches: tuned for an earlier host link, untested over PCIe
    cmd = [sys.executable, "-m", "fastp_tpu"] + ARGS + ["--batch_size", "65536"]

    # reserve time for >=2 timed runs (~60s each worst case) + slack
    wait_budget = max(90, remaining() - 240)
    t_start = time.time()
    server = _start_server(env, wait_budget)
    if server is None:
        try:
            with open(os.path.join(BENCH_DIR, "serve.err")) as f:
                sys.stderr.write("bench: server died during warmup:\n"
                                 + f.read()[-4000:] + "\n")
        except OSError:
            pass
        SNAP["notes"].append("server warmup failed/timed out after %.0fs"
                             % (time.time() - t_start))
        if remaining() > 300:
            server = _start_server(env, max(90, remaining() - 240))
    if server is not None:
        SNAP["warmup"] = time.time() - t_start
    cenv = env
    if isinstance(server, _ExternalServer) and remaining() > 400:
        # a reused server may not have compiled this config yet: one
        # untimed warm job compiles it before the timed runs, matching the
        # fresh-server path whose --warm-run does exactly this
        warm_cmd = [sys.executable, "-m", "fastp_tpu",
                    "-i", os.path.join(BENCH_DIR, "warm_R1.fq"),
                    "-I", os.path.join(BENCH_DIR, "warm_R2.fq"),
                    "-o", "w1.fq", "-O", "w2.fq"] + FLAGS + [
                    "--batch_size", "65536"]
        try:
            _run(warm_cmd, cwd=workdir, env=cenv, capture_output=True,
                 timeout=max(60, min(600, remaining() - 300)))
        except subprocess.SubprocessError:
            SNAP["notes"].append("reuse warm job failed/timed out")
    def _gz_variant():
        # gz-input variant (native libdeflate inflate path): real-world
        # FASTQ is .gz, so the codec must hold the plain rate.  Runs in
        # the MIDDLE of the plain runs, so host load drift hits both
        # alike.  Same executable shape.
        if not (SNAP["runs"] and server is not None and remaining() > 200):
            return
        try:
            gz1, gz2 = _ensure_gz_corpus()
            gz_dir = os.path.join(BENCH_DIR, "gz_run")
            os.makedirs(gz_dir, exist_ok=True)
            gz_cmd = [sys.executable, "-m", "fastp_tpu",
                      "-i", gz1, "-I", gz2,
                      "-o", "out1.fq", "-O", "out2.fq"] + FLAGS + [
                      "--batch_size", "65536"]
            for k in range(2):
                if remaining() < 120:
                    break
                t0 = time.time()
                _run(gz_cmd, cwd=gz_dir, env=cenv, check=True,
                               capture_output=True,
                               timeout=max(60, remaining() - 45))
                SNAP["gz_runs"].append(time.time() - t0)
        except subprocess.SubprocessError as e:
            sys.stderr.write("bench: gz variant failed (%s)\n" % (e,))

    try:
        for k in range(REPEATS):
            if SNAP["runs"] and remaining() < max(SNAP["runs"]) * 1.5 + 60:
                SNAP["notes"].append("stopped after %d runs (budget)"
                                     % len(SNAP["runs"]))
                break
            if k == (REPEATS + 1) // 2:
                _gz_variant()  # mid-session: same weather as the median run
            t0 = time.time()
            try:
                r = _run(cmd, cwd=workdir, env=cenv, check=True,
                                   capture_output=True,
                                   timeout=max(60, remaining() - 45))
                with open(os.path.join(BENCH_DIR, "run%d.err" % k), "wb") as f:
                    f.write(r.stderr)  # keeps FASTP_TPU_TIMING stage splits
            except subprocess.SubprocessError as e:
                sys.stderr.write("bench: run %d failed (%s)\n" % (k, e))
                SNAP["notes"].append("run %d failed" % k)
                if server is not None and server.poll() is not None:
                    break  # server died: no point repeating
                continue
            SNAP["runs"].append(time.time() - t0)
        if not SNAP["gz_runs"]:
            _gz_variant()  # the mid-point was skipped (early break)
    finally:
        if server is not None:
            _stop_server(server, env)
    if not SNAP["runs"] and remaining() > 240:
        # server path yielded nothing: cold per-process fallback (pays the
        # compile in-run; better than no number at all)
        SNAP["notes"].append("cold-run fallback (server unavailable)")
        for _ in range(REPEATS):
            if remaining() < 120:
                break
            t0 = time.time()
            try:
                _run(cmd, cwd=workdir,
                               env=dict(env, FASTP_TPU_SERVER=""),
                               check=True, capture_output=True,
                               timeout=max(60, remaining() - 45))
            except subprocess.SubprocessError as e:
                sys.stderr.write("bench: cold run failed (%s)\n" % (e,))
                continue
            SNAP["runs"].append(time.time() - t0)


def _file_bytes(path):
    with open(path, "rb") as f:
        return f.read()


def measure_devices(n_devices: int, pairs: int, backend: str):
    """Host scale-out harness: run the pipeline (a) over an n-device
    jax.sharding mesh in one process (--devices), (b) as n record-range-
    sharded local processes (--local_processes), and (c) over 1 device,
    emitting reads/s, scaling efficiency, and BYTE-PARITY of each scaled
    run's output against the 1-device run.  With backend=cpu this
    exercises the full sharded/sharding machinery on virtual host devices
    (they share the host's cores, so efficiency is a correctness/coverage
    signal, not a hardware number); on a multi-GPU host run with
    backend=gpu for hardware scaling numbers.  Every run is one JAX
    process at a time, and the --local_processes children each get one
    card (the CLI pins them with CUDA_VISIBLE_DEVICES), so no two JAX
    processes ever share a card."""
    if backend == "gpu":
        from fastp_tpu.parallel.cards import (visible_gpus,
                                              check_one_process_per_card)
        check_one_process_per_card(n_devices, visible_gpus(), "--devices")
    dev_dir = os.path.join(BENCH_DIR, "dev%d" % pairs)
    r1 = os.path.join(dev_dir, "R1.fq")
    r2 = os.path.join(dev_dir, "R2.fq")
    if not os.path.exists(r1):
        os.makedirs(dev_dir, exist_ok=True)
        _run([sys.executable,
                        os.path.join(ROOT, "tools", "make_synth.py"),
                        "--reads", str(pairs),
                        "--out1", r1, "--out2", r2],
                       check=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if backend == "cpu":
        env["JAX_PLATFORMS"] = "cpu"
        env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=%d "
                            % n_devices + env.get("XLA_FLAGS", ""))
    base = [sys.executable, "-m", "fastp_tpu",
            "-i", r1, "-I", r2, "-o", "out1.fq", "-O", "out2.fq"] + FLAGS

    def timed(workdir, cmd, n_runs=3):
        """Cold run 0 pays compile/init; the reported number is the median
        of the remaining warm(-cache) runs."""
        os.makedirs(workdir, exist_ok=True)
        secs = []
        for _ in range(n_runs):
            t0 = time.time()
            _run(cmd, cwd=workdir, env=env, check=True,
                 capture_output=True, timeout=7200)
            secs.append(time.time() - t0)
        return secs

    points = {}
    raw = {}
    # (1) single device, single process
    d1 = os.path.join(dev_dir, "run1")
    raw["1dev"] = timed(d1, base + ["--devices", "1", "--batch_size", "8192"])
    points["1dev"] = 2 * pairs / _median(raw["1dev"][1:])
    golden = {out: _file_bytes(os.path.join(d1, out))
              for out in ("out1.fq", "out2.fq")}
    # (2) n-device dp mesh, one process
    dm = os.path.join(dev_dir, "run%d" % n_devices)
    raw["mesh"] = timed(dm, base + ["--devices", str(n_devices),
                                    "--batch_size", "8192"])
    points["mesh"] = 2 * pairs / _median(raw["mesh"][1:])
    mesh_parity = all(_file_bytes(os.path.join(dm, out)) == golden[out]
                      for out in ("out1.fq", "out2.fq"))
    # (3) n local processes (record-range shards, merged report)
    dp = os.path.join(dev_dir, "procs%d" % n_devices)
    penv_extra = {"FASTP_TPU_DEVICES": "1"}
    env.update(penv_extra)
    raw["procs"] = timed(dp, base + ["--local_processes", str(n_devices),
                                     "--batch_size", "8192"])
    for k in penv_extra:
        env.pop(k, None)
    points["procs"] = 2 * pairs / _median(raw["procs"][1:])
    procs_parity = True
    for out in ("out1.fq", "out2.fq"):
        cat = b"".join(_file_bytes(os.path.join(
            dp, "%04d.%s" % (s + 1, out))) for s in range(n_devices))
        procs_parity = procs_parity and cat == golden[out]
    print(json.dumps({
        "metric": "pe150_mesh_reads_per_sec",
        "value": round(points["mesh"], 1),
        "unit": "reads/s",
        "vs_baseline": None,
        "devices": n_devices,
        "backend": backend,
        "pairs": pairs,
        "reads_per_sec_1dev": round(points["1dev"], 1),
        "reads_per_sec_mesh": round(points["mesh"], 1),
        "reads_per_sec_local_processes": round(points["procs"], 1),
        "scaling_efficiency_mesh": round(
            points["mesh"] / (points["1dev"] * n_devices), 3),
        "scaling_efficiency_local_processes": round(
            points["procs"] / (points["1dev"] * n_devices), 3),
        "byte_parity_mesh_vs_1dev": mesh_parity,
        "byte_parity_local_processes_vs_1dev": procs_parity,
        "runs_seconds": {k: [round(s, 2) for s in v]
                         for k, v in raw.items()},
        "protocol": "3 cold-process runs per point, median of the 2 "
                    "post-compile-cache runs; mesh = jax.sharding dp via "
                    "--devices in one process; local_processes = "
                    "self-spawned record-range shards merged into one "
                    "report; parity = output bytes equal the 1-device "
                    "run (virtual CPU devices share host cores, so "
                    "efficiency is meaningful on real multi-chip hosts)",
    }))


def measure_merge(pairs: int):
    """Merge-mode bench variant (BASELINE config 5 flavor: merge + dedup)
    vs the plain pipeline on the same corpus, both through one resident
    server.  Emits the wall ratio of merge+dedup over plain."""
    global N_PAIRS
    N_PAIRS = pairs
    ensure_corpus()
    env = _client_env()
    plain_cmd = [sys.executable, "-m", "fastp_tpu"] + ARGS + [
        "--batch_size", "65536"]
    merge_cmd = [sys.executable, "-m", "fastp_tpu",
                 "-i", os.path.join(BENCH_DIR, "R1.fq"),
                 "-I", os.path.join(BENCH_DIR, "R2.fq"),
                 "--merge", "--merged_out", "merged.fq",
                 "-o", "out1.fq", "-O", "out2.fq", "--dedup"] + FLAGS + [
                 "--batch_size", "65536"]
    t0 = time.time()
    server = _start_server(env, max(90, remaining() - 420))
    warmup = time.time() - t0
    cenv = env
    res = {"plain": [], "merge": []}
    try:
        workdir = os.path.join(BENCH_DIR, "merge_run")
        os.makedirs(workdir, exist_ok=True)
        # plain first (the warm run compiled this executable), then merge
        # (its run 0 pays the one-time compile)
        for name, cmd, n in (("plain", plain_cmd, 2), ("merge", merge_cmd, 3)):
            for _ in range(n):
                if remaining() < 150:
                    break
                t0 = time.time()
                try:
                    _run(cmd, cwd=workdir, env=cenv, check=True,
                         capture_output=True, timeout=max(60, remaining() - 45))
                except subprocess.SubprocessError as e:
                    # a timed-out/failed run must not lose the runs
                    # already gathered — emit partial
                    sys.stderr.write("merge-bench: %s run failed (%s)\n"
                                     % (name, e))
                    continue
                res[name].append(time.time() - t0)
    finally:
        if server is not None:
            _stop_server(server, env)
    plain = _median(res["plain"]) if res["plain"] else None
    # merge run 0 pays the compile; steady state is the rest
    steady = res["merge"][1:] if len(res["merge"]) > 1 else res["merge"]
    merge = _median(steady) if steady else None
    print(json.dumps({
        "metric": "pe150_merge_dedup_reads_per_sec",
        "value": round(2 * pairs / merge, 1) if merge else None,
        "unit": "reads/s",
        "vs_baseline": None,
        "pairs": pairs,
        "plain_runs_seconds": [round(r, 2) for r in res["plain"]],
        "merge_runs_seconds": [round(r, 2) for r in res["merge"]],
        "merge_over_plain_wall": (round(merge / plain, 3)
                                  if merge and plain else None),
        "server_warmup_seconds": round(warmup, 2),
        "protocol": "one resident server; plain (--correction --cut_right) "
                    "2 runs then merge+dedup 3 runs (merge run 0 pays its "
                    "one-time compile, excluded from the steady median)",
    }))


def main():
    if "--merge-bench" in sys.argv:
        import argparse
        ap = argparse.ArgumentParser()
        ap.add_argument("--merge-bench", action="store_true")
        ap.add_argument("--pairs", type=int, default=N_PAIRS)
        a = ap.parse_args()
        # no watchdog here: its snapshot emits the main-metric record;
        # the per-phase remaining() timeouts bound every wait instead
        measure_merge(a.pairs)
        return
    if "--devices" in sys.argv:
        import argparse
        ap = argparse.ArgumentParser()
        ap.add_argument("--devices", type=int, required=True)
        ap.add_argument("--pairs", type=int,
                        default=int(os.environ.get("BENCH_MESH_PAIRS", "100000")))
        ap.add_argument("--backend", choices=["cpu", "gpu"], default="cpu")
        a = ap.parse_args()
        measure_devices(a.devices, a.pairs, a.backend)
        return
    wd = threading.Thread(target=_watchdog, daemon=True)
    wd.start()
    try:
        ensure_corpus()
    except subprocess.SubprocessError as e:
        SNAP["notes"].append("corpus generation failed: %s" % (e,))
        emit_and_exit(0)
    measure_ours()
    measure_reference()
    emit_and_exit(0)


if __name__ == "__main__":
    main()
