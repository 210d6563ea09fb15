"""Device-side multi-string BWT construction (prefix doubling).

The reference delegates BWT construction to the external grlBWT tool
(README.md:74-96). Here the multi-string rotation sort runs on the device:
each round sorts the combined (rank, rank-at-offset-k) keys with XLA's sort
and re-ranks - O(log n) rounds of O(n log n) device sort, no host round
trips inside a round. Endmarker tie-breaking by sequence index matches the
oracle/grlBWT semantics (distinct ascending separators).

Outputs the rotation order (suffix array of the cyclic text), from which the
BWT, document array, and per-sequence offsets all derive by gathers - these
feed rindex build (`build_rindex_from_sa`) directly, so the whole
text -> index build runs device-side except run-length encoding.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.alphabet import NENDMARKER


def _rerank(order, key1_sorted, key2_sorted, n):
    bump = (key1_sorted[1:] != key1_sorted[:-1]) | (key2_sorted[1:] != key2_sorted[:-1])
    bumps = jnp.concatenate((jnp.zeros(1, jnp.int32), jnp.cumsum(bump.astype(jnp.int32))))
    return jnp.zeros(n, jnp.int32).at[order].set(bumps)


@functools.partial(jax.jit, static_argnames=("n",))
def _doubling_round(rank: jax.Array, k, n: int):
    # two-key sort (no combined key: avoids int overflow at any n)
    idx = jnp.arange(n, dtype=jnp.int32)
    second = rank[(idx + k) % n]
    r_s, s_s, order = jax.lax.sort((rank, second, idx), num_keys=2)
    new_rank = _rerank(order, r_s, s_s, n)
    return new_rank, new_rank.max()


def rotation_order_device(keys: np.ndarray) -> np.ndarray:
    """Permutation sorting all rotations of `keys` (host in, host out)."""
    n = int(keys.size)
    kd = jnp.asarray(keys, jnp.int32)
    idx = jnp.arange(n, dtype=jnp.int32)
    k_s, order0 = jax.lax.sort((kd, idx), num_keys=1)
    rank = _rerank(order0, k_s, k_s, n)
    k = 1
    while k < n:
        rank, mx = _doubling_round(rank, k, n)
        if int(mx) == n - 1:
            break
        k *= 2
    return np.asarray(jnp.argsort(rank))


def bwt_from_lines_device(lines: list[bytes]):
    """Multi-string BWT of '\n'-terminated sequences, computed on device.

    Returns (bwt bytes array, da, sa_pos, seq_lengths) - the same contract as
    models.oracle.oracle_from_lines.
    """
    parts, seq_idx, sa_parts, seq_lengths = [], [], [], []
    for i, line in enumerate(lines):
        arr = np.frombuffer(line, dtype=np.uint8).astype(np.int64) + len(lines)
        full = np.concatenate((arr, [i]))  # distinct separator, ordered by seq
        parts.append(full)
        seq_idx.append(np.full(full.size, i, dtype=np.int64))
        sa_parts.append(np.arange(full.size, dtype=np.int64))
        seq_lengths.append(full.size)
    keys = np.concatenate(parts)
    seq_idx = np.concatenate(seq_idx)
    sa_pos = np.concatenate(sa_parts)
    n = keys.size
    order = rotation_order_device(keys)
    prev = (order - 1) % n
    bwt_keys = keys[prev]
    bwt = np.where(bwt_keys >= len(lines), bwt_keys - len(lines), NENDMARKER).astype(np.uint8)
    return bwt, seq_idx[order], sa_pos[order], np.array(seq_lengths, dtype=np.int64)
