"""The PE overlap sweep as compiled for a CUDA GPU.

Marked `gpu`: the CPU tier skips these; chip_smoke.py runs them on the card
with `JAX_PLATFORMS=cuda,cpu python -m pytest -m gpu tests/test_gpu_sweep.py`.
"""
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))
from overlap_sweep_bench import make_sample  # noqa: E402

pytestmark = pytest.mark.gpu

DIFF_LIMIT, OV_REQ, DIFF_PCT = 5, 30, 0.2
FIELDS = ("overlapped", "offset", "overlap_len", "diff")


def _sample(clean, B=4096, L=160, seed=3):
    s1, l1, s2, l2 = make_sample(B, L, seed)
    if not clean:  # lowercase/IUPAC bytes in one row in 8
        rng = np.random.default_rng(seed)
        dirty = np.frombuffer(b"acgtnRYKM", np.uint8)
        rows = rng.choice(B, B // 8, replace=False)
        s1[rows, rng.integers(0, 60, len(rows))] = \
            dirty[rng.integers(0, len(dirty), len(rows))]
    return s1, l1, s2, l2


@pytest.mark.parametrize("clean", [True, False], ids=["clean", "dirty"])
def test_gpu_sweep_matches_cpu_loop(gpu_device, clean):
    """analyze() as the GPU step traces it (its platform's sweep, under the
    pipeline's clean-alphabet flag) equals the byte-exact offset loop."""
    import jax
    import jax.numpy as jnp
    from fastp_tpu.ops import overlap

    def ok(x):
        return jnp.all((x == 0) | (x == 65) | (x == 67) | (x == 71)
                       | (x == 84) | (x == 78))

    def on_gpu(a, la, b, lb):
        return overlap.analyze(a, la, b, lb, DIFF_LIMIT, OV_REQ, DIFF_PCT,
                               False, clean=ok(a) & ok(b))

    s1, l1, s2, l2 = _sample(clean)
    args = [jax.device_put(x, gpu_device) for x in (s1, l1, s2, l2)]
    got = jax.device_get(jax.jit(on_gpu)(*args))
    cpu = jax.devices("cpu")[0]
    want = jax.device_get(overlap._analyze_loop(
        *[jax.device_put(x, cpu) for x in (s1, l1, s2, l2)],
        DIFF_LIMIT, OV_REQ, DIFF_PCT, False))
    for k in FIELDS:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
