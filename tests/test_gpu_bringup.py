"""CPU checks of what surrounds the GPU path: the overlap sweep chosen by
platform, the compile-cache location, one card per --local_processes
child, a server whose backend fails to start or is not the expected one,
and chip_smoke.py refusing to report success without a GPU."""
import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform", ["cpu", "gpu"])
def test_analyze_picks_sweep_by_platform(platform, monkeypatch):
    """The ungapped sweep follows jax.default_backend() alone."""
    import jax
    import jax.numpy as jnp
    from fastp_tpu.ops import overlap
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    B, L = 8, 64
    s = np.full((B, L), 65, np.uint8)
    n = np.full(B, L, np.int32)
    jaxpr = jax.make_jaxpr(lambda a, b: overlap.analyze(
        a, n, b, n, 5, 30, 0.2, False, clean=jnp.all(a > 0)))(s, s)
    text = str(jaxpr)
    if platform == "cpu":
        assert "cond[" in text and "conv_general_dilated" in text
    else:
        assert "cond[" not in text and "conv_general_dilated" not in text
        assert "name=_analyze_loop" in text


@pytest.mark.parametrize("from_env", [True, False], ids=["env", "default"])
def test_compile_cache_dir(from_env, tmp_path):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits at
    the fixed <repo>/.jax_cache."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("FASTP_TPU_NO_COMPILE_CACHE", None)
    want = str(tmp_path / "cc") if from_env else os.path.join(ROOT,
                                                               ".jax_cache")
    if from_env:
        env["JAX_COMPILATION_CACHE_DIR"] = want
    else:
        env.pop("JAX_COMPILATION_CACHE_DIR", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "from fastp_tpu._jaxcache import ensure_compile_cache as e; e(); "
         "import jax; print(jax.config.jax_compilation_cache_dir)"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == want


@pytest.mark.parametrize("cards", [["0", "1", "2", "3"], ["3", "5"], []],
                         ids=["4cards", "restricted", "cpu"])
def test_local_process_child_env(cards):
    """Child k of --local_processes sees exactly one card and no variable
    of another accelerator runtime."""
    from fastp_tpu.cli import shard_child_env
    base = {"PATH": "/bin", "FASTP_TPU_LOCAL_PROCESSES": "2"}
    n = max(len(cards), 2)
    for k in range(n):
        env = shard_child_env(base, k, n, cards, [])
        want = cards[k] if cards else str(k)
        assert env["CUDA_VISIBLE_DEVICES"] == want
        assert env["FASTP_TPU_SHARD_INDEX"] == str(k)
        assert env["FASTP_TPU_SHARD_COUNT"] == str(n)
        assert "FASTP_TPU_LOCAL_PROCESSES" not in env
        assert not [v for v in env if v.startswith("TPU_")]


def test_one_process_per_card_rule(monkeypatch):
    from fastp_tpu.parallel import cards
    cards.check_one_process_per_card(4, ["0", "1", "2", "3"], "x")
    cards.check_one_process_per_card(8, [], "x")  # CPU run: no cards
    with pytest.raises(ValueError, match="2 are visible"):
        cards.check_one_process_per_card(4, ["0", "1"], "--local_processes")
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert cards.visible_gpus() == []
    monkeypatch.setenv("JAX_PLATFORMS", "cuda")
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "2,3")
    assert cards.visible_gpus() == ["2", "3"]


def test_serve_exits_when_backend_fails(tmp_path):
    """A backend that cannot start ends `serve` with its error: no retry,
    no READY."""
    env = dict(os.environ, JAX_PLATFORMS="no_such_platform",
               PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "fastp_tpu", "serve",
                        "--socket", str(tmp_path / "s.sock")],
                       env=env, cwd=str(tmp_path), capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    assert "READY" not in r.stdout
    assert "FATAL" in r.stderr
    assert not (tmp_path / "s.sock").exists()


@pytest.mark.parametrize("expect", ["cpu", "gpu"])
def test_smoke_server_backend_check(expect, tmp_path):
    """chip_smoke's served phases accept a server only when its READY line
    names the expected backend: a server on the CPU (where JAX lands when
    the GPU fails to start and JAX_PLATFORMS is unset) fails the phase and
    is stopped."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(ROOT, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    try:
        if expect == "gpu":
            with pytest.raises(smoke.PhaseError,
                               match="server runs on cpu, not gpu"):
                smoke.Server(str(tmp_path), platform="cpu", expect=expect)
        else:
            smoke.Server(str(tmp_path), platform="cpu", expect=expect).close()
        assert all(p.poll() is not None for p in smoke._children)
    finally:
        smoke.stop_children()


@pytest.mark.parametrize("alone", [False, True], ids=["repo", "alone"])
def test_chip_smoke_fails_without_gpu(alone, tmp_path):
    """No accelerator, or no repo around the script: nonzero exit and no
    success line."""
    script = os.path.join(ROOT, "chip_smoke.py")
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script = str(tmp_path / "chip_smoke.py")
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    r = subprocess.run([sys.executable, script], env=env, cwd=str(tmp_path),
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
