"""Differential test: the pure-Python routing/stat fallback
(FASTP_TPU_NO_NATIVE=1) must byte-match the native routed fast path on the
drift-prone stream combinations (merge + unpaired + failed + overlapped;
reference semantics: src/peprocessor.cpp:488-579).

Each case runs the SAME config twice — native helpers on vs off — and
compares every output file plus the JSON report (command line normalized).
No golden recordings needed: the native path is itself byte-parity-tested
against the reference binary in test_parity*.py, so equality here pins the
fallback to reference behavior transitively.
"""
import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
R1 = "/tmp/refbuild/testdata/R1.fq"
R2 = "/tmp/refbuild/testdata/R2.fq"

pytestmark = [pytest.mark.skipif(not os.path.exists(R1),
                                 reason="reference testdata not available"),
              pytest.mark.slow]


def _run(tmp_path, sub, args, no_native):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    if no_native:
        env["FASTP_TPU_NO_NATIVE"] = "1"
    else:
        env.pop("FASTP_TPU_NO_NATIVE", None)
    d = tmp_path / sub
    d.mkdir()
    res = subprocess.run(
        [sys.executable, "-m", "fastp_tpu", "-i", R1, "-I", R2] + args,
        cwd=str(d), env=env, capture_output=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-3000:]
    return d


def _diff_outputs(a, b):
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        fa, fb = (a / n).read_bytes(), (b / n).read_bytes()
        if n.endswith(".json"):
            ja, jb = json.loads(fa), json.loads(fb)
            ja.pop("command", None), jb.pop("command", None)
            assert ja == jb, "JSON mismatch in %s" % n
        elif n.endswith(".html"):
            continue  # embeds the command line; JSON equality covers stats
        else:
            assert fa == fb, "byte mismatch in %s" % n


CASES = {
    # the full merge-mode stream fan-out: merged + unmerged-to-out +
    # unpaired both sides + failed (reference: peprocessor.cpp:488-579)
    "merge_full": ["--merge", "--merged_out", "m.fq",
                   "--include_unmerged",
                   "--unpaired1", "u1.fq", "--unpaired2", "u2.fq",
                   "--failed_out", "f.fq",
                   "-o", "o1.fq", "-O", "o2.fq",
                   "--correction", "--cut_right",
                   "-l", "100", "-j", "r.json", "-h", "r.html"],
    # overlapped_out + failed + unpaired without merge
    "overlapped_failed": ["--overlapped_out", "ov.fq",
                          "--unpaired1", "u1.fq",
                          "--failed_out", "f.fq",
                          "-o", "o1.fq", "-O", "o2.fq",
                          "-q", "30", "-l", "120", "--correction",
                          "-j", "r.json", "-h", "r.html"],
    # dedup interacting with merge routing
    "merge_dedup": ["--merge", "--merged_out", "m.fq", "--dedup",
                    "--failed_out", "f.fq",
                    "-o", "o1.fq", "-O", "o2.fq",
                    "-j", "r.json", "-h", "r.html"],
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_fallback_matches_native(tmp_path, name):
    args = CASES[name]
    a = _run(tmp_path, "native", args, no_native=False)
    b = _run(tmp_path, "fallback", args, no_native=True)
    _diff_outputs(a, b)
