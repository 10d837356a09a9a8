import os

# Run tests on a virtual 8-device CPU mesh.  Tests that need a GPU are
# marked `gpu`, ask for the `gpu_device` fixture below and skip on the CPU;
# they run on a card only when the caller asks JAX for CUDA itself:
#   JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_sweep.py
if "cuda" not in os.environ.get("JAX_PLATFORMS", ""):
    os.environ["JAX_PLATFORMS"] = "cpu"
# CLI subprocess tests default to ONE device: mesh byte-parity has its own
# dedicated tests (test_multidevice passes --devices explicitly), and an
# 8-way forced-host-device mesh both multiplies compute 8x and can flake
# XLA:CPU's 40s collective-rendezvous timeout under load.
os.environ.setdefault("FASTP_TPU_DEVICES", "1")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (flags + " --xla_force_host_platform_device_count=8").strip()

import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# Persistent XLA compile cache for tests that import ops directly (the
# pipeline enables it via fastp_tpu.pipeline.device; per-op golden tests
# would otherwise recompile their sweeps on every run, which dominates the
# slow tier's wall time).
from fastp_tpu._jaxcache import ensure_compile_cache
ensure_compile_cache()

# The byte-parity tests invoke the CLI with /tmp/refbuild/testdata paths
# because the recorded goldens embed those command strings.  /tmp does not
# survive between sessions while the vendored fixtures in tests/testdata do
# (byte-identical copies) -- materialize the expected layout on demand so
# the golden tests never skip just because /tmp was wiped.
_REFDATA = "/tmp/refbuild/testdata"
if not os.path.exists(os.path.join(_REFDATA, "R1.fq")):
    import shutil
    os.makedirs(_REFDATA, exist_ok=True)
    _here = os.path.dirname(os.path.abspath(__file__))
    for _f in ("R1.fq", "R2.fq"):
        shutil.copyfile(os.path.join(_here, "testdata", _f),
                        os.path.join(_REFDATA, _f))


import pytest


@pytest.fixture
def gpu_device():
    """The first GPU, for tests marked `gpu`; skips where JAX sees none.

    Decided here, when the test runs, never at import or collection time:
    the CPU tier skips these; chip_smoke.py runs them on the card with
    JAX_PLATFORMS=cuda,cpu."""
    import jax
    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a GPU (run by chip_smoke.py on the card)")
    return devs[0]
