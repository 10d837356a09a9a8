"""Which CUDA cards a launcher may hand to its JAX children.

A JAX process reserves most of every card it can see when it first uses
one, so a second process on the same card fails for want of memory.
Launchers that start several JAX processes (`--local_processes`,
bench.py's scale-out harness) therefore give child k exactly one card with
CUDA_VISIBLE_DEVICES and must learn the card count WITHOUT starting JAX
themselves, which would put the launcher on every card first.
"""
from __future__ import annotations

import os
import subprocess
from typing import List


def visible_gpus() -> List[str]:
    """CUDA device ids the children's JAX would use; [] on a CPU run.

    JAX_PLATFORMS naming no CUDA platform means a CPU run.  Otherwise the
    ids come from CUDA_VISIBLE_DEVICES when the launcher itself is
    restricted, else from nvidia-smi (absent: no card)."""
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cuda" not in plats and "gpu" not in plats:
        return []
    restricted = os.environ.get("CUDA_VISIBLE_DEVICES")
    if restricted is not None:
        return [d.strip() for d in restricted.split(",") if d.strip()]
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=index",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.SubprocessError):
        return []
    if r.returncode != 0:
        return []
    return [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]


def check_one_process_per_card(n: int, cards: List[str], what: str):
    """Raise ValueError when n JAX children would share a card."""
    if cards and n > len(cards):
        raise ValueError(
            "%s %d needs %d GPUs but %d are visible (%s): a JAX process "
            "reserves most of its card's memory, so two cannot share one. "
            "Use at most %d, or route the children to one resident server "
            "per card with FASTP_TPU_SERVERS=sock0,sock1,..."
            % (what, n, n, len(cards), ",".join(cards), len(cards)))
