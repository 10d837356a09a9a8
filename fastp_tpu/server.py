"""Resident server mode: keep one warm process, run many jobs.

The one-time costs of a cold fastp_tpu run are the accelerator client's
start and the XLA compile (cached on disk after the first run).  The
reference amortizes nothing because its startup is trivial; ours amortizes
them by staying resident: the jitted pipeline steps are memoized on their
static config (pipeline/device.py), so every job after the first with the
same configuration runs at steady-state throughput immediately.

This is the deployment mode for production/serving: start `fastp_tpu serve
--socket /path.sock` once per card (CUDA_VISIBLE_DEVICES=k), then point the CLI at it with
FASTP_TPU_SERVER=/path.sock (the thin client in client.py never imports
JAX, so client startup is milliseconds).

Protocol (unix stream socket, one job per connection):
  request:  one JSON line {"argv": [...], "cwd": "...", "op": "run"}
            (op may also be "ping" or "shutdown")
  response: frames of [tag:1 byte][len:u32 LE][payload]
            tag 'O' = stdout bytes, 'E' = stderr bytes,
            tag 'R' = final JSON {"rc": int} and end-of-job
"""
from __future__ import annotations

import json
import os
import socket
import struct
import sys
import traceback


def send_frame(conn: socket.socket, tag: bytes, payload: bytes):
    conn.sendall(tag + struct.pack("<I", len(payload)) + payload)


def recv_exact(conn: socket.socket, n: int) -> bytes:
    parts = []
    while n:
        b = conn.recv(n)
        if not b:
            raise ConnectionError("peer closed")
        parts.append(b)
        n -= len(b)
    return b"".join(parts)


class _SockStream:
    """File-like that forwards writes to the client as framed chunks.
    Stands in for sys.stdout / sys.stderr during a job; exposes itself as
    .buffer so `sys.stdout.buffer.write(bytes)` works too."""

    def __init__(self, conn: socket.socket, tag: bytes):
        self._conn = conn
        self._tag = tag
        self.buffer = self
        self.encoding = "utf-8"

    def write(self, data):
        if isinstance(data, str):
            data = data.encode("utf-8", "replace")
        if data:
            send_frame(self._conn, self._tag, data)
        return len(data)

    def flush(self):
        pass

    def isatty(self):
        return False


class _NullStream:
    """Swallow job output during a pre-READY warm run."""

    def __init__(self):
        self.buffer = self
        self.encoding = "utf-8"

    def write(self, data):
        return len(data)

    def flush(self):
        pass

    def isatty(self):
        return False


def _run_job(argv, cwd, conn, jobenv=None) -> int:
    from .cli import main as cli_main
    old_out, old_err, old_cwd = sys.stdout, sys.stderr, os.getcwd()
    # overlay the client's job-level FASTP_TPU_* knobs for this job only
    saved_env = {}
    for k, v in (jobenv or {}).items():
        if not k.startswith("FASTP_TPU_"):
            continue
        saved_env[k] = os.environ.get(k)
        os.environ[k] = str(v)
    if conn is None:
        sys.stdout = _NullStream()
        sys.stderr = _NullStream()
    else:
        sys.stdout = _SockStream(conn, b"O")
        sys.stderr = _SockStream(conn, b"E")
    try:
        os.chdir(cwd)
        rc = cli_main(argv)
        return int(rc) if rc else 0
    except SystemExit as e:
        code = e.code
        if code is None:
            return 0
        return code if isinstance(code, int) else 1
    except BrokenPipeError:
        return 1
    except BaseException:
        try:
            tb = traceback.format_exc()
            sys.stderr.write(tb)
            if conn is None:  # pre-READY warm run: don't lose the evidence
                old_err.write(tb)
                old_err.flush()
        except Exception:
            pass
        return 1
    finally:
        sys.stdout, sys.stderr = old_out, old_err
        os.chdir(old_cwd)
        for k, v in saved_env.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def serve(sock_path: str, warm_run=None) -> int:
    # resident process: dup Bloom buffers are pooled across jobs, so pay
    # the full page-commit once (ideally pre-READY via the warm run)
    # instead of lazy write faults inside every job's batches
    os.environ.setdefault("FASTP_TPU_POOL_PREFAULT", "1")
    # start the accelerator client before binding: a backend that fails to
    # start ends the server with its error.  READY names the backend, since
    # with JAX_PLATFORMS unset JAX falls back to the CPU when the GPU fails.
    import jax
    backend = jax.default_backend()
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    srv = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
    srv.bind(sock_path)
    srv.listen(8)
    if warm_run:
        # run one representative job before READY: batches pad to
        # --batch_size, so a small input with production flags compiles
        # the exact executable timed jobs will hit
        rc = _run_job(warm_run, ".", None)
        sys.stdout.write("WARMED rc=%d\n" % rc)
        sys.stdout.flush()
    sys.stdout.write("READY %d %s\n" % (os.getpid(), backend))
    sys.stdout.flush()
    while True:
        conn, _ = srv.accept()
        try:
            buf = b""
            while not buf.endswith(b"\n"):
                chunk = conn.recv(65536)
                if not chunk:
                    buf = b""
                    break
                buf += chunk
            if not buf:
                continue
            req = json.loads(buf)
            op = req.get("op", "run")
            if op == "ping":
                send_frame(conn, b"R", json.dumps({"rc": 0}).encode())
                continue
            if op == "shutdown":
                send_frame(conn, b"R", json.dumps({"rc": 0}).encode())
                conn.close()
                break
            rc = _run_job(req["argv"], req.get("cwd", "."), conn,
                          req.get("env"))
            send_frame(conn, b"R", json.dumps({"rc": rc}).encode())
        except (ConnectionError, BrokenPipeError, json.JSONDecodeError):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass
    srv.close()
    try:
        os.unlink(sock_path)
    except OSError:
        pass
    return 0


def serve_main(args) -> int:
    import argparse
    p = argparse.ArgumentParser(prog="fastp_tpu serve")
    p.add_argument("--socket", required=True, help="unix socket path")
    p.add_argument("--warm-run", default=None, metavar="JSON_ARGV",
                   help="JSON list of CLI args for a representative job to "
                        "run (output suppressed) before READY; pre-loads "
                        "the pipeline executable for that config/shape")
    ns = p.parse_args(args)
    warm_run = json.loads(ns.warm_run) if ns.warm_run else None
    try:
        return serve(ns.socket, warm_run=warm_run)
    except BaseException:
        # accelerator failures during init or warm-run otherwise kill the
        # daemon with a traceback nobody captured
        sys.stderr.write("fastp_tpu serve: FATAL\n" + traceback.format_exc())
        sys.stderr.flush()
        raise
