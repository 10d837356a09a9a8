"""Shared helpers for batched read ops.

All ops operate on fixed-width padded tensors:
  bases: uint8[B, L] raw ASCII (A/T/C/G/N...), 0 beyond `lengths`
  quals: uint8[B, L] raw phred+33 ASCII, 0 beyond `lengths`
  lengths: int32[B]

Reads are "windowed": the live read occupies positions [0, len) of its row.
Length-mutating ops return new lengths (and occasionally a front offset that
the caller applies with `roll_front`).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

A, T, C, G, N = 65, 84, 67, 71, 78  # ASCII codes


def pos_iota(B: int, L: int, dtype=jnp.int32):
    return jax.lax.broadcasted_iota(dtype, (B, L), 1)


def valid_mask(lengths, L):
    B = lengths.shape[0]
    return pos_iota(B, L) < lengths[:, None]


def _shift_left(arr, k: int):
    """Static left shift along lanes with zero fill (slice + pad: no gather)."""
    B, L = arr.shape
    if k <= 0:
        return arr
    if k >= L:
        return jnp.zeros_like(arr)
    return jnp.concatenate([arr[:, k:], jnp.zeros((B, k), arr.dtype)], axis=1)


def _shift_right(arr, k: int):
    B, L = arr.shape
    if k <= 0:
        return arr
    if k >= L:
        return jnp.zeros_like(arr)
    return jnp.concatenate([jnp.zeros((B, k), arr.dtype), arr[:, :L - k]], axis=1)


def roll_front(arr, front):
    """Shift each row left by `front[b]`, filling with 0 (erase(0, front)).

    Per-row variable shifts decomposed into log2(L) static shifts
    selected by the shift's bits -- no per-element gathers.
    """
    B, L = arr.shape
    f = jnp.clip(front.astype(jnp.int32), 0, L)
    out = arr
    k = 1
    bit = 0
    while k < L + 1:
        shifted = _shift_left(out, k)
        take = ((f >> bit) & 1) == 1
        out = jnp.where(take[:, None], shifted, out)
        k <<= 1
        bit += 1
    return out


def roll_back(arr, shift):
    """Shift each row right by `shift[b]` >= 0, filling with 0."""
    B, L = arr.shape
    f = jnp.clip(shift.astype(jnp.int32), 0, L)
    out = arr
    k = 1
    bit = 0
    while k < L + 1:
        shifted = _shift_right(out, k)
        take = ((f >> bit) & 1) == 1
        out = jnp.where(take[:, None], shifted, out)
        k <<= 1
        bit += 1
    return out


def complement(bases):
    """Complement of ASCII bases; anything not ATCG (upper/lower) -> 'N'.

    reference: src/util.h:16-33
    """
    b = bases
    up = jnp.where((b >= 97) & (b <= 122), b - 32, b)  # tolower -> upper
    out = jnp.full_like(b, N)
    out = jnp.where(up == A, T, out)
    out = jnp.where(up == T, A, out)
    out = jnp.where(up == C, G, out)
    out = jnp.where(up == G, C, out)
    return out


def reverse_rows(arr, lengths):
    """Reverse each row's first `lengths[b]` elements; pad stays 0.

    flip (free lane reversal) + variable left-roll by L - len.
    """
    B, L = arr.shape
    return roll_front(arr[:, ::-1], L - lengths.astype(jnp.int32))


def rc(bases, lengths):
    """Reverse complement (reference: src/sequence.cpp:23-50)."""
    rev = reverse_rows(arr=bases, lengths=lengths)
    comp = complement(rev)
    return jnp.where(rev > 0, comp, 0).astype(bases.dtype)


def first_true_index(mask, default):
    """Index of first True along axis 1; `default` (scalar or [B]) if none."""
    any_ = jnp.any(mask, axis=1)
    idx = jnp.argmax(mask, axis=1).astype(jnp.int32)
    return jnp.where(any_, idx, default)


def base_slot(bases):
    """base & 0x07 (reference stats slot, src/stats.cpp:249)."""
    return (bases & 0x07).astype(jnp.int32)


def base2val(bases):
    """A=0 T=1 C=2 G=3, else -1 (reference: src/stats.cpp:334-347)."""
    v = jnp.full(bases.shape, -1, dtype=jnp.int32)
    v = jnp.where(bases == A, 0, v)
    v = jnp.where(bases == T, 1, v)
    v = jnp.where(bases == C, 2, v)
    v = jnp.where(bases == G, 3, v)
    return v
