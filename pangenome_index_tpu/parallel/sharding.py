"""Multi-chip sharding for the query engine.

The reference's only distribution mechanisms are per-chromosome index shards
on the filesystem plus OpenMP within a host (SURVEY §2.1). The device-mesh
design replaces them with a 2-D device mesh:

  * ``data`` axis - reads are batch-sharded; each device runs the full MEM
    state machine on its slice (the analog of OpenMP-over-reads,
    find_mems.cpp:96-139).
  * ``model`` axis - the run table itself is sharded by contiguous BWT run
    ranges (the analog of per-chromosome shards, merge_tags.cpp). rank6
    becomes: every model-shard answers locally if it owns the position's run,
    else contributes zeros; one psum over ``model`` combines - exactly one
    shard owns any position, so the sum is exact.

`shard_rindex` pads the run table to the mesh size with sentinel runs
(run_start = n+1) that can never be a predecessor of a valid position.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.rindex import RIndex
from ..ops.tables import RIndexTables, rindex_to_device


def make_mesh(n_data: int, n_model: int, devices=None) -> Mesh:
    devices = np.asarray(devices if devices is not None else jax.devices())
    if devices.size < n_data * n_model:
        raise ValueError(f"need {n_data * n_model} devices, have {devices.size}")
    grid = devices[: n_data * n_model].reshape(n_data, n_model)
    return Mesh(grid, axis_names=("data", "model"))


def pad_rindex_tables(idx: RIndex, n_shards: int,
                      checkpoint: bool = False,
                      ckpt_block: int = 64,
                      super_shift: int | None = None,
                      mem_only: bool = False) -> RIndexTables:
    """Device tables with the run dimension padded to a multiple of n_shards
    using sentinel runs (start = n+1, full cumulative counts).

    checkpoint=True additionally builds the checkpoint rank table (the
    round-2 serving representation, ops/tables.py:build_ckpt_rows) with its
    row count padded to a multiple of n_shards; rows are contiguous
    64-position ranges, so range-sharding them over `model` keeps the
    one-gather rank path (the pad rows duplicate the final
    totals-checkpoint row and are unreachable for positions <= n).

    mem_only (requires checkpoint): the per-run/locate tables ship as stubs
    (ops/tables.py mem_only), tiled to n_shards rows so the 'model'-sharded
    in_specs still apply - the big-index mesh deployment shape (MEM serving
    reads only ckpt(+super), C and n)."""
    r = idx.n_runs
    pad = 0 if mem_only else (-r) % n_shards
    if pad:
        full_cum = idx.cum[-1].copy()
        full_cum[idx.run_sym[-1]] += idx.run_len[-1]
        idx = RIndex(
            run_sym=np.concatenate((idx.run_sym, np.zeros(pad, np.int8))),
            run_start=np.concatenate((idx.run_start, np.full(pad, idx.n + 1, np.int64))),
            run_len=np.concatenate((idx.run_len, np.zeros(pad, np.int64))),
            cum=np.concatenate((idx.cum, np.tile(full_cum, (pad, 1)))),
            C=idx.C, n=idx.n, n_seq=idx.n_seq, max_len=idx.max_len,
            samples=np.concatenate((idx.samples, np.zeros(pad, np.int64))),
            last_sorted=np.concatenate((idx.last_sorted, np.full(pad, np.iinfo(np.int64).max // 4, np.int64))),
            last_to_run=np.concatenate((idx.last_to_run, np.zeros(pad, np.int64))),
        )
    t = rindex_to_device(idx, checkpoint=checkpoint, ckpt_block=ckpt_block,
                         super_shift=super_shift, mem_only=mem_only)
    if mem_only:
        # the 1-row stubs must still divide over 'model': tile to n_shards
        t = t._replace(run_sym=jnp.tile(t.run_sym, n_shards),
                       run_start=jnp.tile(t.run_start, n_shards))
    if checkpoint:
        rows = np.asarray(t.ckpt)
        rpad = (-rows.shape[0]) % n_shards
        if rpad:
            rows = np.concatenate((rows, np.tile(rows[-1], (rpad, 1))))
        t = t._replace(ckpt=jnp.asarray(rows))
    return t


def shard_tables(t: RIndexTables, mesh: Mesh) -> RIndexTables:
    """Place tables on the mesh: run-dimension arrays sharded over 'model',
    small tables replicated."""
    run_sharded = NamedSharding(mesh, P("model"))
    run_sharded2 = NamedSharding(mesh, P("model", None))
    repl = NamedSharding(mesh, P())

    def put(x, s):
        return jax.device_put(x, s)

    return RIndexTables(
        run_sym=put(t.run_sym, run_sharded),
        run_start=put(t.run_start, run_sharded),
        # with a checkpoint table the per-run cum is the trimmed [1, 6]
        # fallback stub (tables.py) - replicate it; otherwise it is the rank
        # provider and shards with the runs
        cum=put(t.cum, repl if t.ckpt is not None else run_sharded2),
        C=put(t.C, repl),
        samples=put(t.samples, repl),
        last_sorted=put(t.last_sorted, repl),
        last_to_run=put(t.last_to_run, repl),
        n=put(t.n, repl),
        n_seq=put(t.n_seq, repl),
        max_len=put(t.max_len, repl),
        ckpt=None if t.ckpt is None else put(t.ckpt, run_sharded2),
        # two-level superblock bases: a handful of rows - replicate
        ckpt_super=None if t.ckpt_super is None else put(t.ckpt_super, repl),
    )


def rows_per_device(x: jax.Array) -> list[int]:
    """Leading-dimension rows of `x` that each device holds, in mesh-device
    order (a range-sharded table shows n_model equal slices)."""
    return [s.data.shape[0] for s in
            sorted(x.addressable_shards, key=lambda s: s.device.id)]


def distributed_ckpt_rank6(local_ckpt, pos, axis="model", super_base=None):
    """Checkpoint rank6 with the row table range-sharded over `axis` (call
    inside shard_map) - the round-2 one-gather representation, distributed.

    local_ckpt: [rows_local, width] this shard's contiguous row slice (rows
    cover 64- or 128-position ranges, ops/tables.py:build_ckpt_rows); pos:
    [B], replicated over `axis`. Exactly one shard owns each position's row:
    it gathers + SWAR-counts locally (ops/rank.py:ckpt_row_rank6), everyone
    else contributes zeros, one psum combines. This serves indexes whose
    checkpoint table exceeds one device's memory with one gather per rank
    query.

    super_base: replicated two-level base table for global n >= 2^31
    (RIndexTables.ckpt_super): local rows are superblock-relative int32 and
    the absolute int64 base is added once after the psum - so model sharding
    serves shards whose GLOBAL position space exceeds 2^31 with int32
    shard-local rows (VERDICT r3 item 4)."""
    from ..ops.rank import ckpt_row_rank6

    width = local_ckpt.shape[-1]
    shift = 6 if width == 16 else 7
    rows_local = local_ckpt.shape[0]
    g_row = pos >> shift
    l_row = g_row - jax.lax.axis_index(axis).astype(g_row.dtype) * rows_local
    owns = (l_row >= 0) & (l_row < rows_local)
    row = local_ckpt[jnp.clip(l_row, 0, rows_local - 1)]
    r6 = ckpt_row_rank6(row, pos, width)
    r6 = jax.lax.psum(jnp.where(owns[:, None], r6, 0), axis)
    if super_base is not None:
        ss = super_base.shape[-1] - 6
        r6 = super_base[pos >> ss][..., :6] + r6
    return r6


def distributed_rank6(local_run_start, local_run_sym, local_cum, pos, axis="model"):
    """rank6 with the run table sharded over `axis` (call inside shard_map).

    local_run_start: [r_local] this shard's contiguous run slice;
    pos: [B] (replicated over `axis`). Exactly one shard's slice contains the
    predecessor run of each position; the others contribute zeros and a psum
    combines.
    """
    j = jnp.searchsorted(local_run_start, pos, side="right") - 1
    owns = j >= 0
    nxt = jax.lax.ppermute(
        local_run_start[0], axis, [(i, (i - 1) % jax.lax.axis_size(axis)) for i in range(jax.lax.axis_size(axis))]
    )
    is_last = jax.lax.axis_index(axis) == jax.lax.axis_size(axis) - 1
    upper = jnp.where(is_last, jnp.iinfo(pos.dtype).max, nxt)
    owns = owns & (pos < upper)
    jc = jnp.clip(j, 0, local_run_start.shape[0] - 1)
    base = local_cum[jc]
    sym = local_run_sym[jc].astype(jnp.int32)
    onehot = (jnp.arange(6, dtype=jnp.int32)[None, :] == sym[:, None]).astype(base.dtype)
    local = jnp.where(owns[:, None], base + onehot * (pos - local_run_start[jc])[:, None], 0)
    return jax.lax.psum(local, axis)
