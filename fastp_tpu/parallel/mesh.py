"""Data-parallel execution over a jax.sharding.Mesh.

The reference scales with worker threads over read packs
(reference: src/peprocessor.cpp:750-754); the equivalent here is
read-batch sharding over a 1-D 'dp' device mesh.  Batch tensors are sharded
on the batch axis, per-read outputs come back sharded, and batch-reduced
stat tensors are summed across shards by XLA-inserted collectives (NCCL
over NVLink on a GPU host) via replicated output shardings.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


_dist_initialized = False


def init_distributed():
    """Multi-host initialization (call once per process before device use).

    The reference scales with threads in one process; the equivalent here
    is one process per host with jax.distributed handling the coordination
    plane, controlled by JAX_COORDINATOR_ADDRESS (host:port of process 0),
    JAX_NUM_PROCESSES and JAX_PROCESS_ID, all three given explicitly: no
    cluster environment is probed.  A no-op when JAX_COORDINATOR_ADDRESS
    is unset.

    Several processes on one GPU host must not share a card: a JAX process
    reserves most of the memory of every card it sees.  Start process k
    with CUDA_VISIBLE_DEVICES=k (as --local_processes does for its
    children, parallel/cards.py), so each process drives exactly one card.
    """
    import os
    global _dist_initialized
    if _dist_initialized:
        return True
    if os.environ.get("JAX_COORDINATOR_ADDRESS"):
        jax.distributed.initialize(
            coordinator_address=os.environ["JAX_COORDINATOR_ADDRESS"],
            num_processes=int(os.environ.get("JAX_NUM_PROCESSES", "1")),
            process_id=int(os.environ.get("JAX_PROCESS_ID", "0")))
        # latch only after success so a transient coordinator failure can
        # be retried by a later job in the same (resident) process
        _dist_initialized = True
        return True
    return False


def make_mesh(n_devices: int = 0) -> Mesh:
    # local devices only: each host shards its own batches over its own
    # chips (host arrays are not addressable on a cross-process mesh);
    # cross-host reduction happens at the stats layer (parallel/multihost.py)
    devs = jax.local_devices()
    if n_devices and n_devices < len(devs):
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("dp",))


def _out_shardings_for(tree, mesh, batch: int):
    """Leaves with a leading batch dim shard on dp; everything else
    (reduced stats, scalars, batch-level sparse lists) replicates."""
    shard = NamedSharding(mesh, P("dp"))
    repl = NamedSharding(mesh, P())

    shard1 = NamedSharding(mesh, P(None, "dp"))

    def assign(leaf):
        nd = getattr(leaf, "ndim", 0)
        if nd >= 1 and leaf.shape[0] == batch:
            return shard
        if nd == 2 and leaf.shape[1] == batch:
            return shard1  # packed [K, B] per-read matrices
        return repl

    return jax.tree_util.tree_map(assign, tree)


def build_sharded_step(step_fn, mesh: Mesh, n_batch_args: int):
    """Wrap a device step for mesh execution.

    step_fn: the un-jitted/batch step (build_se_step/build_pe_step result).
    n_batch_args: number of leading array args sharded on the batch axis
    (all args are batch-major here, so all get P('dp')).

    Returns a callable taking numpy arrays; stats outputs are replicated
    (already summed across shards), per-read outputs are gathered to host.
    """
    shard = NamedSharding(mesh, P("dp"))
    repl = NamedSharding(mesh, P())
    n_dev = mesh.devices.size

    jitted = {}

    def call(*args):
        # tiny side tables (e.g. the 4-entry qual LUT) replicate; anything
        # batch-major with a dp-divisible leading dim shards
        put = [jax.device_put(
                   a, shard if (getattr(a, "ndim", 0) >= 1
                                and a.shape[0] >= n_dev
                                and a.shape[0] % n_dev == 0) else repl)
               for a in args]
        key = tuple((a.shape, str(a.dtype)) for a in args)
        if key not in jitted:
            # trace once to learn the output tree, then re-jit with shardings
            out_tree = jax.eval_shape(step_fn, *put)
            out_sh = _out_shardings_for(out_tree, mesh, args[0].shape[0])
            jitted[key] = jax.jit(step_fn, out_shardings=out_sh)
        return jitted[key](*put)

    return call


def pad_to_multiple(arrays_1d_or_2d, n: int, batch: int):
    """Pad batch-major numpy arrays so batch % n == 0.

    Returns (padded_list, valid_mask, padded_batch)."""
    rem = batch % n
    pad = 0 if rem == 0 else n - rem
    out = []
    for a in arrays_1d_or_2d:
        if pad == 0:
            out.append(a)
        else:
            widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
            out.append(np.pad(a, widths))
    valid = np.ones(batch + pad, bool)
    if pad:
        valid[batch:] = False
    return out, valid, batch + pad
