import os
import sys

# On hosts where first-touch page faults are slow (virtualized memory),
# glibc.malloc.hugetlb=1 makes glibc MADV_HUGEPAGE its arenas (2MB faults
# instead of 4KB ones).  The tunable is only
# read at process start, so re-exec once with it set.  Skip for the thin
# client path (no heavy allocation) and when explicitly disabled.
if (os.name == "posix" and "glibc.malloc.hugetlb" not in
        os.environ.get("GLIBC_TUNABLES", "")
        and not os.environ.get("FASTP_TPU_NO_REEXEC")
        and not os.environ.get("FASTP_TPU_SERVER")):
    os.environ["GLIBC_TUNABLES"] = (
        os.environ.get("GLIBC_TUNABLES", "")
        + (":" if os.environ.get("GLIBC_TUNABLES") else "")
        + "glibc.malloc.hugetlb=1")
    os.environ["FASTP_TPU_NO_REEXEC"] = "1"  # belt: never loop
    try:
        os.execv(sys.executable, [sys.executable, "-m", "fastp_tpu"]
                 + sys.argv[1:])
    except OSError:
        pass

# `fastp_tpu serve --socket ...`: resident server mode (see server.py)
if len(sys.argv) >= 2 and sys.argv[1] == "serve":
    from .server import serve_main
    sys.exit(serve_main(sys.argv[2:]))

# When FASTP_TPU_SERVER names a live server socket, route the job there via
# the thin client (no JAX import: millisecond startup, warm executables).
# STDIN-streaming jobs stay local; on any client failure fall back to local.
_srv = os.environ.get("FASTP_TPU_SERVER")
if (_srv and os.path.exists(_srv) and "--stdin" not in sys.argv
        and "/dev/stdin" not in sys.argv
        # the --local_processes launcher must run locally (its CHILDREN
        # are what route to servers, one per chip via FASTP_TPU_SERVERS)
        and not any(a.startswith("--local_processes") for a in sys.argv)):
    from .client import run_via_server
    _rc = run_via_server(_srv, sys.argv)
    if _rc is not None:
        sys.exit(_rc)

from .cli import main

sys.exit(main())
