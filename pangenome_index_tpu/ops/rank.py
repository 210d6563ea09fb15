"""Batched rank / LF primitives on the device tables.

rank(pos, c) = cum[j, c] + (run_sym[j] == c) * (pos - run_start[j]) with
j = searchsorted(run_start, pos, 'right') - 1 - the vectorized replacement
for the reference's sd_vector predecessor + in-block linear scan
(src/r-index.cpp:558-568). All entry points are batched over a leading lane
axis; the searchsorted is the only O(log r) component and every lane runs it
independently (XLA lowers to a vectorized binary-search gather loop).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .tables import RIndexTables


from .tables import BUCKET_SHIFT


def run_of(t: RIndexTables, pos):
    """Run id containing each position (pos may be 0..n inclusive).

    With bucket_lo present: O(1) bucket jump + 7 fixed halving probes
    (bucket width 2^BUCKET_SHIFT bounds the search window to 64 runs),
    instead of a log2(r) binary search over the whole run table.
    """
    if t.bucket_lo is None:
        return jnp.searchsorted(t.run_start, pos, side="right").astype(t.pos_dtype) - 1
    r = t.run_start.shape[0]
    b = jnp.minimum(pos >> BUCKET_SHIFT, t.bucket_lo.shape[0] - 1)
    j = t.bucket_lo[b]
    for step in (64, 32, 16, 8, 4, 2, 1):
        cand = j + step
        cc = jnp.minimum(cand, r - 1)
        ok = (cand <= r - 1) & (t.run_start[cc] <= pos)
        j = jnp.where(ok, cand, j)
    return j


_NIB = 0x11111111  # one bit per 4-bit nibble


def ckpt_row_rank6(row, pos, width: int):
    """rank6 from gathered checkpoint rows: base occ + SWAR nibble counting.

    row: [..., width] int32 checkpoint rows (already gathered - the caller
    owns the gather so the model-sharded provider can reuse this math on its
    local shard, parallel/sharding.py:distributed_ckpt_rank6); pos: [...].

    Each row holds the bucket's occ checkpoints (cols 0..5) and its 64 (or
    128) BWT codes as 4-bit nibbles (LSB-first). Counting symbol c among the
    first (pos & 63) nibbles is branch-free int32 vector math: nibbles at and
    past the cutoff are forced to 0xF (matches no code), then per word a
    nibble equals c iff (word ^ c*0x11111111) has a zero nibble, and
    zero-nibble counting is the classic multiply-accumulate reduction.
    ~300 vector ops/lane, in place of a second gather row.
    """
    nwords = {16: 8, 24: 16}[width]
    base = row[..., :6]
    payload = row[..., 6 : 6 + nwords]         # [B, nwords] int32 (8 nibbles each)
    i = (pos & (nwords * 8 - 1)).astype(jnp.int32)
    # per-word cutoff: word w keeps its first clamp(i - 8w, 0, 8) nibbles
    thr = jnp.clip(i[..., None] - 8 * jnp.arange(nwords, dtype=jnp.int32), 0, 8)
    full = thr >= 8
    mask = jnp.where(full, -1, (1 << (4 * jnp.where(full, 0, thr))) - 1)
    masked = (payload & mask) | ~mask          # dropped nibbles -> 0xF
    counts = []
    for c in range(6):
        x = masked ^ (c * _NIB)                # nibble == 0 iff code matches
        nz = (x | (x >> 1) | (x >> 2) | (x >> 3)) & _NIB  # 1 iff nibble != 0
        n_nz = ((nz * _NIB) >> 28) & 0xF       # nibble-sum of nz (<= 8, exact)
        counts.append((8 - n_nz).sum(axis=-1))  # 0xF fillers never match c
    return base + jnp.stack(counts, axis=-1).astype(base.dtype)


def _ckpt_rank6(t: RIndexTables, pos):
    """Checkpoint-mode rank6: ONE 64B gather + SWAR nibble counting.

    Two-level layout (n >= 2^31): rows hold superblock-relative int32
    counts; the absolute base is one more gather into the tiny replicated
    ckpt_super table (its width statically encodes super_shift)."""
    pos = jnp.asarray(pos)
    # bucket size is encoded in the row width (16 -> 64 codes, 24 -> 128):
    # static at trace time, so no extra table field is needed
    width = t.ckpt.shape[-1]
    shift = 6 if width == 16 else 7
    row = t.ckpt[pos >> shift]                 # the one gather
    r6 = ckpt_row_rank6(row, pos, width)
    if t.ckpt_super is not None:
        ss = t.ckpt_super.shape[-1] - 6
        r6 = t.ckpt_super[pos >> ss][..., :6] + r6
    return r6


def ckpt_rank6_pair(t: RIndexTables, k, ks):
    """(rank6(k), rank6(ks)) for the extension's paired queries, exploiting
    same-bucket locality: when k and ks land in the same checkpoint bucket
    (common late in extension chains, where interval size s = ks - k is
    small), the second gather's index clamps to row 0 - a cache-resident row
    - and the row is reused via a select. Same issued-row count, but the
    distinct-line traffic drops with the same-bucket fraction; gather
    locality is what large tables pay for."""
    width = t.ckpt.shape[-1]
    shift = 6 if width == 16 else 7
    b1 = k >> shift
    b2 = ks >> shift
    same = b1 == b2
    row1 = t.ckpt[b1]
    row2 = t.ckpt[jnp.where(same, 0, b2)]
    row2 = jnp.where(same[:, None], row1, row2)
    r1 = ckpt_row_rank6(row1, k, width)
    r2 = ckpt_row_rank6(row2, ks, width)
    if t.ckpt_super is not None:
        ss = t.ckpt_super.shape[-1] - 6
        r1 = t.ckpt_super[k >> ss][..., :6] + r1
        r2 = t.ckpt_super[ks >> ss][..., :6] + r2
    return r1, r2


def rank(t: RIndexTables, pos, code):
    """occ(code, [0, pos)) for batched pos [B] and codes [B] (or scalars)."""
    if t.ckpt is not None:
        r6 = _ckpt_rank6(t, pos)
        code_arr = jnp.asarray(code, jnp.int32)
        if r6.ndim == 1:
            return r6[code_arr]
        code_b = jnp.broadcast_to(code_arr, r6.shape[:-1])
        oh = jnp.arange(6, dtype=jnp.int32) == code_b[..., None]
        return jnp.where(oh, r6, 0).sum(axis=-1)
    if t.rank_table is not None:
        pos = jnp.asarray(pos)
        if pos.ndim == 0:
            return t.rank_table[pos, code]
        lane = jnp.arange(pos.shape[0])
        return t.rank_table[pos][lane, code]
    if t.pos_to_run is not None:
        j = t.pos_to_run[pos]
        row = t.rec[j]
        extra = jnp.where(row[..., 1] == code, pos - row[..., 0], 0)
        if row.ndim == 2:
            # per-lane column select as one-hot math, not a gather (the
            # query loops are gather-row-issue-rate bound)
            code_b = jnp.broadcast_to(jnp.asarray(code, jnp.int32), row.shape[:1])
            oh = jnp.arange(6, dtype=jnp.int32)[None, :] == code_b[:, None]
            return jnp.where(oh, row[:, 2:8], 0).sum(axis=1) + extra
        return row[2 + code] + extra
    j = run_of(t, pos)
    sym = t.run_sym[j].astype(code.dtype if hasattr(code, "dtype") else jnp.int32)
    extra = jnp.where(sym == code, pos - t.run_start[j], 0)
    return t.cum[j, code] + extra


def rank6(t: RIndexTables, pos):
    """All-symbol rank vectors: pos [B] -> [B, 6].

    Checkpoint mode: ONE 64B gather + SWAR count (the serving default).
    Ultra mode: ONE gather (per-position rank table).
    Dense mode: exactly two gathers (pos->run map, packed 32B record).
    """
    if t.ckpt is not None:
        return _ckpt_rank6(t, pos)
    if t.rank_table is not None:
        return t.rank_table[pos][..., :6]
    if t.pos_to_run is not None:
        j = t.pos_to_run[pos]
        row = t.rec[j]  # [B, 8]: start, sym, cum0..cum5
        sym = row[:, 1].astype(jnp.int32)
        onehot = (jnp.arange(6, dtype=jnp.int32)[None, :] == sym[:, None]).astype(row.dtype)
        return row[:, 2:8] + onehot * (pos - row[:, 0])[:, None]
    j = run_of(t, pos)
    base = t.cum[j]  # [B, 6]
    sym = t.run_sym[j].astype(jnp.int32)  # [B]
    onehot = (jnp.arange(6, dtype=jnp.int32)[None, :] == sym[:, None]).astype(base.dtype)
    return base + onehot * (pos - t.run_start[j])[:, None]


def lf_range(t: RIndexTables, first, second, code):
    """Batched LF mapping (r-index.cpp:650-686): first/second/code [B].

    Empty results use the reference's (1, 0) sentinel.
    """
    valid = (code > 0) & (first <= second)
    safe_first = jnp.where(valid, first, 0)
    safe_second = jnp.where(valid, second, 0)
    lo = rank(t, safe_first, code)
    inside = rank(t, safe_second + 1, code) - lo
    ok = valid & (inside > 0)
    start = lo + t.C[code]
    one = jnp.ones_like(first)
    return (jnp.where(ok, start, one), jnp.where(ok, start + inside - 1, 0))


def count(t: RIndexTables, codes, lengths):
    """Batched backward search: codes [B, L] (right-padded), lengths [B].

    Processes each read right-to-left (count_encoded, r-index.hpp:550-556).
    Returns (first, second) [B].
    """
    B, L = codes.shape
    pd = t.pos_dtype
    first = jnp.zeros(B, pd)
    second = jnp.full(B, t.n - 1, pd)
    iotaL = jnp.arange(L, dtype=jnp.int32)[None, :]

    def body(i, state):
        first, second = state
        # position from the right: index lengths-1-i, skip when i >= length
        pos = (lengths - 1 - i).astype(jnp.int32)
        active = pos >= 0
        # read-local code lookup as a one-hot select-sum (no gather row)
        c = jnp.where(iotaL == pos[:, None], codes, 0).sum(axis=1)
        nf, ns = lf_range(t, first, second, c.astype(pd))
        first = jnp.where(active, nf, first)
        second = jnp.where(active, ns, second)
        return first, second

    first, second = jax.lax.fori_loop(0, L, body, (first, second))
    return first, second


def locate_next(t: RIndexTables, prev):
    """Batched locateNext (r-index.cpp:1369-1372)."""
    i = jnp.searchsorted(t.last_sorted, prev, side="right").astype(t.pos_dtype) - 1
    run = t.last_to_run[i] + 1
    return t.samples[run] + (prev - t.last_sorted[i])
