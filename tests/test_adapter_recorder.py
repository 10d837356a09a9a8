"""Native adapter-count recorder vs the pure-Python dict path.

The recorder (fastq_native.cpp adrec_*) must reproduce FilterResult's
map semantics bit-exactly (reference: src/filterresult.cpp:115-183):
insertion caps at >20000 keys, low-complexity skip past >5000 keys, the
pair path's early return on a rejected NEW adapter1 key, and counter
updates that precede (and survive) map rejections.
"""
import numpy as np
import pytest

from fastp_tpu.io import native as native_mod
from fastp_tpu.report import filter_model
from fastp_tpu.report.filter_model import FilterResult
from fastp_tpu.config import Options

pytestmark = pytest.mark.skipif(native_mod.get_lib() is None,
                                reason="native lib unavailable")


def _mk_pair(with_native: bool, log: bool = False) -> FilterResult:
    fr = FilterResult(Options(), paired=True, log=log)
    if not with_native:
        fr._adrec = None
        fr._events = {} if log else None
    return fr


def _rand_mat(rng, n, w):
    return rng.integers(65, 85, size=(n, w), dtype=np.uint8)


def test_bulk_pairs_match_python_replay():
    rng = np.random.default_rng(7)
    B, W = 4096, 96
    ba1 = _rand_mat(rng, B, W)
    ba2 = _rand_mat(rng, B, W)
    rows = np.arange(B, dtype=np.int64)
    lo1 = rng.integers(0, 40, B).astype(np.int64)
    hi1 = lo1 + rng.integers(0, 30, B)          # includes empty slices
    lo2 = rng.integers(0, 40, B).astype(np.int64)
    hi2 = lo2 + rng.integers(0, 30, B)
    # force repeats so increments are exercised
    ba1[B // 2:] = ba1[:B // 2]
    ba2[B // 2:] = ba2[:B // 2]
    lo1[B // 2:] = lo1[:B // 2]
    hi1[B // 2:] = hi1[:B // 2]
    lo2[B // 2:] = lo2[:B // 2]
    hi2[B // 2:] = hi2[:B // 2]

    nat = _mk_pair(True)
    assert nat._adrec is not None
    assert nat.add_adapter_trimmed_pairs_bulk(ba1, lo1, hi1, ba2, lo2, hi2,
                                              rows)
    py = _mk_pair(False)
    for k in range(B):
        a1 = ba1[k, lo1[k]:hi1[k]].tobytes().decode("latin-1")
        a2 = ba2[k, lo2[k]:hi2[k]].tobytes().decode("latin-1")
        py.add_adapter_trimmed_pair(a1, a2)

    assert nat.adapter1 == py.adapter1
    assert nat.adapter2 == py.adapter2
    assert nat.trimmed_adapter_reads == py.trimmed_adapter_reads
    assert nat.trimmed_adapter_bases == py.trimmed_adapter_bases


def test_caps_and_low_complexity(monkeypatch):
    # shrink the caps so the test exercises both thresholds cheaply on
    # the PYTHON side; the native side uses the real constants, so build
    # enough keys to cross the real 5000/20000 thresholds instead
    rng = np.random.default_rng(3)
    n_keys = 26000
    W = 12
    ba1 = rng.integers(65, 91, size=(n_keys, W), dtype=np.uint8)
    # sprinkle low-complexity keys (runs of one letter) throughout
    ba1[::7, :] = 65
    ba2 = rng.integers(65, 91, size=(n_keys, W), dtype=np.uint8)
    rows = np.arange(n_keys, dtype=np.int64)
    z = np.zeros(n_keys, np.int64)
    w = np.full(n_keys, W, np.int64)

    nat = _mk_pair(True)
    assert nat.add_adapter_trimmed_pairs_bulk(ba1, z, w, ba2, z, w, rows)
    py = _mk_pair(False)
    for k in range(n_keys):
        py.add_adapter_trimmed_pair(ba1[k].tobytes().decode("latin-1"),
                                    ba2[k].tobytes().decode("latin-1"))
    assert nat.adapter1 == py.adapter1
    assert nat.adapter2 == py.adapter2
    # the cap actually engaged (map saturates just past MAX_ADAPTER_REC)
    assert len(py.adapter1) <= filter_model.MAX_ADAPTER_REC + 1
    assert len(py.adapter1) > filter_model.MAX_ADAPTER_REC - 1


def test_single_adds_and_state_dict_roundtrip(monkeypatch):
    nat = _mk_pair(True)
    py = _mk_pair(False)
    seqs = ["ACGT", "ACGT", "A", "AAAAAA", "TTTTGGGGCCC", ""]
    for s in seqs:
        nat.add_adapter_trimmed(s, is_r2=False)
        py.add_adapter_trimmed(s, is_r2=False)
        nat.add_adapter_trimmed(s, is_r2=True, inc_trimmed_counter=False,
                                count=3)
        py.add_adapter_trimmed(s, is_r2=True, inc_trimmed_counter=False,
                               count=3)
    assert nat.adapter1 == py.adapter1
    assert nat.adapter2 == py.adapter2
    assert nat.trimmed_adapter_reads == py.trimmed_adapter_reads
    assert nat.trimmed_adapter_bases == py.trimmed_adapter_bases
    # the same adds split over two shards: their logs, replayed in shard
    # order, rebuild the maps; merge_state adds the counters
    shards = [_mk_pair(True, log=True), _mk_pair(True, log=True)]
    for i, s in enumerate(seqs):
        sh = shards[i * 2 // len(seqs)]
        sh.add_adapter_trimmed(s, is_r2=False)
        sh.add_adapter_trimmed(s, is_r2=True, inc_trimmed_counter=False,
                               count=3)
    sts = [sh.state_dict() for sh in shards]
    merged = shards[0]
    merged.replay_adapter_logs([st["adapter_log"] for st in sts])
    merged.merge_state(sts[1])
    assert merged.adapter1 == py.adapter1
    assert merged.adapter2 == py.adapter2
    assert merged.trimmed_adapter_reads == py.trimmed_adapter_reads
    assert merged.trimmed_adapter_bases == py.trimmed_adapter_bases


@pytest.mark.parametrize("with_native", [True, False],
                         ids=["native", "python"])
def test_shard_logs_replay_to_one_process_maps(with_native, monkeypatch):
    """Past the caps, the maps depend on the order of adds across shards
    (and adapter2 on whether a NEW adapter1 was dropped): three shards'
    logs replayed in order equal one FilterResult fed every add."""
    rng = np.random.default_rng(11)
    n = 2 * filter_model.MAX_ADAPTER_REC + 3000
    keys = rng.integers(65, 69, size=(n, 12), dtype=np.uint8)
    keys[::7] = keys[1::7][:len(keys[::7])]  # repeats across shards
    adds = [(keys[k].tobytes().decode("latin-1"),
             keys[(k * 5) % n].tobytes().decode("latin-1")[:1 + k % 11])
            for k in range(n)]
    one = _mk_pair(with_native)
    for a1, a2 in adds:
        if len(a2) % 3:
            one.add_adapter_trimmed_pair(a1, a2)
        else:
            one.add_adapter_trimmed(a2, is_r2=True)
    shards = [_mk_pair(with_native, log=True) for _ in range(3)]
    for k, (a1, a2) in enumerate(adds):
        sh = shards[k * 3 // n]
        if len(a2) % 3:
            sh.add_adapter_trimmed_pair(a1, a2)
        else:
            sh.add_adapter_trimmed(a2, is_r2=True)
    merged = shards[0]
    merged.replay_adapter_logs([sh.state_dict()["adapter_log"]
                                for sh in shards])
    assert len(one.adapter1) > filter_model.MAX_ADAPTER_REC
    assert merged.adapter1 == one.adapter1
    assert merged.adapter2 == one.adapter2


def _log_len(fr):
    if fr._adrec is not None:
        return len(fr.state_dict()["adapter_log"]["events"]) // 3
    return len(fr.state_dict()["adapter_log"])


@pytest.mark.parametrize("with_native", [True, False],
                         ids=["native", "python"])
def test_shard_log_grows_with_distinct_adds(with_native):
    """A shard's log keeps each distinct add once (counts summed), however
    many reads repeat it, and its replay still equals one process fed
    every add in order, across the caps."""
    rng = np.random.default_rng(5)
    n_kinds = 2 * filter_model.MAX_ADAPTER_REC + 3000  # half touch map 1
    keys = rng.integers(65, 69, size=(n_kinds, 10), dtype=np.uint8)
    kinds = [(keys[k].tobytes().decode("latin-1"),
              keys[(k * 7) % n_kinds].tobytes().decode("latin-1")[:1 + k % 9],
              k % 4) for k in range(n_kinds)]
    # every kind three times: in order, then shuffled, then in order
    seq = (list(range(n_kinds)) + list(rng.permutation(n_kinds))
           + list(range(n_kinds)))
    one = _mk_pair(with_native)
    shards = [_mk_pair(with_native, log=True) for _ in range(2)]
    for j, k in enumerate(seq):
        a1, a2, how = kinds[k]
        for fr in (one, shards[j * 2 // len(seq)]):
            if how == 0:
                fr.add_adapter_trimmed(a2, is_r2=True, count=2)
            elif how == 1:
                fr.add_adapter_trimmed(a1, is_r2=False)
            else:
                fr.add_adapter_trimmed_pair(a1 if how == 2 else "", a2)
    assert _log_len(shards[0]) <= n_kinds
    assert _log_len(shards[1]) <= n_kinds
    merged = shards[0]
    merged.replay_adapter_logs([sh.state_dict()["adapter_log"]
                                for sh in shards])
    assert len(one.adapter1) > filter_model.MAX_ADAPTER_REC
    assert merged.adapter1 == one.adapter1
    assert merged.adapter2 == one.adapter2
