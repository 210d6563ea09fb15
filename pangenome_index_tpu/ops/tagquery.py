"""Batched tag-array interval queries on device.

Replaces sd_vector rank/select + sequential varint skipping
(query_compressed_compact, src/tag_arrays.cpp:856-890) with two batched
searchsorteds, a bounded gather window, and an in-lane sort-based dedupe.
Capacity-bounded: lanes needing more than `capacity` runs are flagged so the
host can re-query them (jitted programs need static shapes; fixture/read
workloads fit comfortably).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .tables import TagTables

START_EVERY_K = 10  # encoded_start_every_k_run (tag_arrays.hpp:120)


class TagQueryResult(NamedTuple):
    positions: jax.Array  # [B, capacity] unique packed positions, padded with -1
    n_unique: jax.Array   # [B]
    n_runs: jax.Array     # [B] the reference's reported run count
    overflow: jax.Array   # [B]


@functools.partial(jax.jit, static_argnames=("capacity", "exact"))
def query_tags_batch(tt: TagTables, start: jax.Array, end: jax.Array,
                     capacity: int = 64, exact: bool = False) -> TagQueryResult:
    """start/end: [B] inclusive BWT intervals.

    exact=False reproduces the reference's run-range math including the
    off-by-one when the first run index is a multiple of 10 (see
    models/tagarray.py:query_runs); exact=True returns precisely the runs
    overlapping [start, end].
    """
    t = tt.bwt_start.shape[0]
    first_bit = jnp.searchsorted(tt.bwt_start, start, side="right").astype(jnp.int32)
    end_bit = jnp.searchsorted(tt.bwt_start, end, side="right").astype(jnp.int32)
    run_nums = end_bit - first_bit + 1
    if exact:
        s = jnp.maximum(first_bit - 1, 0)
    else:
        s = jnp.where(first_bit % START_EVERY_K == 0, first_bit, first_bit - 1)
    overflow = run_nums > capacity

    win = s[:, None] + jnp.arange(capacity, dtype=jnp.int32)[None, :]
    valid = (jnp.arange(capacity)[None, :] < run_nums[:, None]) & (win < t) & (win >= 0)
    vals = tt.pos_enc[jnp.clip(win, 0, t - 1)]
    big = jnp.iinfo(vals.dtype).max
    vals = jnp.where(valid, vals, big)
    vals = jax.lax.sort(vals, dimension=1)
    # dedupe: keep first occurrence
    keep = jnp.concatenate(
        [jnp.ones((vals.shape[0], 1), bool), vals[:, 1:] != vals[:, :-1]], axis=1
    ) & (vals != big)
    n_unique = keep.sum(axis=1).astype(jnp.int32)
    # compact the kept values to the front of each lane
    order = jnp.argsort(~keep, axis=1, stable=True)
    compacted = jnp.take_along_axis(vals, order, axis=1)
    kept_sorted = jnp.take_along_axis(keep, order, axis=1)
    out = jnp.where(kept_sorted, compacted, -1)
    return TagQueryResult(out, n_unique, run_nums, overflow)


@functools.partial(jax.jit, static_argnames=("capacity",))
def query_mem_tags(tt: TagTables, bwt_start: jax.Array, size: jax.Array,
                   count: jax.Array, capacity: int = 32):
    """Tag lookups for every buffered MEM of a find_mems batch - the second
    half of the reference serving path (per-MEM query_compressed_compact +
    total_tag_time, src/find_mems.cpp:129, 144-145), batched over all
    (read, MEM) slots at once.

    bwt_start/size: [B, M] MemResult buffers; count: [B]. Returns
    (n_unique [B, M] int32 with invalid slots zeroed,
     overflow [B, M] bool - lanes whose run span exceeded `capacity`).

    Dedupe here is an O(capacity^2) pairwise mask (count a value when no
    earlier window slot holds it), not the serving path's sort + argsort
    compaction: at the small capacities MEM intervals need (run span is ~1
    on pangenome workloads - one locus across haplotypes IS one tag run)
    the pairwise form is pure vector math, while two [B*M, cap] sorts
    dominated the measured tag half. Counts are identical (cross-checked
    against the native engine every bench run); position lists for OUTPUT
    still come from query_tags_batch (the CLI path)."""
    B, M = bwt_start.shape
    t = tt.bwt_start.shape[0]
    valid = jnp.arange(M, dtype=jnp.int32)[None, :] \
        < jnp.minimum(count, M).astype(jnp.int32)[:, None]
    s = jnp.where(valid, bwt_start, 0).reshape(B * M).astype(tt.bwt_start.dtype)
    e = jnp.where(valid, bwt_start + size - 1, 0).reshape(B * M) \
        .astype(tt.bwt_start.dtype)
    first_bit = jnp.searchsorted(tt.bwt_start, s, side="right").astype(jnp.int32)
    end_bit = jnp.searchsorted(tt.bwt_start, e, side="right").astype(jnp.int32)
    run_nums = end_bit - first_bit + 1
    rs = jnp.where(first_bit % START_EVERY_K == 0, first_bit, first_bit - 1)
    win = rs[:, None] + jnp.arange(capacity, dtype=jnp.int32)[None, :]
    ok = (jnp.arange(capacity)[None, :] < run_nums[:, None]) \
        & (win < t) & (win >= 0)
    vals = tt.pos_enc[jnp.clip(win, 0, t - 1)]
    big = jnp.iinfo(vals.dtype).max
    vals = jnp.where(ok, vals, big)
    # first-occurrence count: slot j is unique iff no slot i < j equals it
    dup = (vals[:, :, None] == vals[:, None, :]) \
        & (jnp.arange(capacity)[None, :, None]
           > jnp.arange(capacity)[None, None, :])
    uniq = (vals != big) & ~dup.any(axis=2)
    nu = jnp.where(valid, uniq.sum(axis=1).astype(jnp.int32).reshape(B, M), 0)
    ov = (run_nums > capacity).reshape(B, M) & valid
    return nu, ov
