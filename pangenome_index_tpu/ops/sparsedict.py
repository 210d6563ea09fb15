"""Sparse long-seed dictionary: bi-intervals of every length-s substring
that actually occurs in the index.

The dense 4^m seed table (ops/mertable.py) caps at m=14 by its footprint;
the aligner-realistic min_len=31 workload still pays ~2(min_len-1-m)
DEPENDENT rank gathers per MEM call for the remaining extensions. The
reference's own trick lifts the cap: index only k-mers that occur
(unique_kmer.hpp:95-191 enumerates occurring k-mers over the graph;
kmers_to_bplustree_worker, algorithm.hpp:134-162, enumerates all length-k
strings with nonempty BWT intervals by recursive backward search).

Here the enumeration is a level-synchronous frontier (the breadth-first
form of that recursion, same machinery as core/anchor.py): level t holds
the bi-intervals of every distinct length-t substring; one batched rank6
pair per level extends all of them by the four bases at once. Entry count
is bounded by the index's distinct-s-mer count (r-driven), not 4^s.

Serving: a read window's interval becomes ONE sorted-array lookup
(host-side np.searchsorted over the packed keys - the same host precompute
treatment as read_mer_keys) feeding a per-position dictionary row index;
the engine cascades per-position seed lengths: long seed -> dense m-mer ->
stepwise extension (ops/mems.py). Exactness argument is the seed-table
one: interval sizes are non-increasing along an extension, so a window
whose final interval passes min_occ implies every skipped intermediate
check passed; windows that miss (error sites, absent substrings) fall back
to the shorter tiers (semantics preserved from algorithm.hpp:653-736).
"""

from __future__ import annotations

import numpy as np

from ..models.rindex import RIndex
from ..utils.alphabet import KP_WEIGHT
from ..device import memory_budget
from .mertable import BASE_CODES

#: longest supported window: 2 bits/base must fit an int64 key
MAX_S = 31

def build_sparse_dict(idx: RIndex, s: int, min_keep: int = 1):
    """Enumerate all length-s ACGT substrings with interval size >= min_keep.

    Returns (keys [D] int64 sorted ascending, vals [D, 3]) where keys pack
    2-bit bases with the LEFTMOST character in the highest bits (matching
    read_mer_keys) and vals rows are (k, kp, size) bi-intervals - int32 when
    every value fits, else int64.

    Construction is right-to-left prepending, so concatenating the four
    branch blocks in base order keeps keys sorted at every level with no
    final sort. Work: sum over levels of 2 batched rank6 calls on the
    frontier (shared by all four children of an entry)."""
    if not 1 <= s <= MAX_S:
        raise ValueError(f"s must be in [1, {MAX_S}]")
    keys = np.zeros(1, np.int64)
    k = np.zeros(1, np.int64)
    kp = np.zeros(1, np.int64)
    sz = np.full(1, idx.n, np.int64)
    thresh = max(int(min_keep), 1)
    for t in range(s):
        r_k = idx.rank6(k)
        r_ks = idx.rank6(k + sz)
        delta = r_ks - r_k  # [D_t, 6]
        parts = []
        for b, code in enumerate(BASE_CODES):
            code = int(code)
            s2 = delta[:, code]
            keep = s2 >= thresh
            k2 = (r_k[:, code] + idx.C[code])[keep]
            kp2 = (kp + (KP_WEIGHT[code][None, :] * delta).sum(axis=1))[keep]
            parts.append((keys[keep] | (np.int64(b) << (2 * t)),
                          k2, kp2, s2[keep]))
        keys = np.concatenate([p[0] for p in parts])
        k = np.concatenate([p[1] for p in parts])
        kp = np.concatenate([p[2] for p in parts])
        sz = np.concatenate([p[3] for p in parts])
    dt = np.int32 if idx.n < 2**31 else np.int64
    return keys, np.stack((k, kp, sz), axis=1).astype(dt)


#: device-build state columns (one [C, 8] row per frontier entry; 8 keeps
#: rows 32-byte aligned at int32): key_lo/key_hi split the packed 2-bit key
#: into 30-bit halves so the state stays int32 (the table dtype) at n < 2^31
_COL_KLO, _COL_KHI, _COL_K, _COL_KP, _COL_SZ = range(5)
_KEY_SPLIT = 15  # bases 0..14 in key_lo (bits 0..29), 15.. in key_hi
#: longest window the int32 device build holds (two 30-bit key halves)
MAX_S_INT32 = 2 * _KEY_SPLIT


def auto_window(min_len: int, idx: RIndex) -> int:
    """The auto window: min_len - 1 (step 1 of every MEM call becomes ONE
    stepwise extension), capped at the longest window the device build of
    this index holds (MAX_S_INT32 on int32 positions, else MAX_S)."""
    from .tables import needs_int64

    return min(min_len - 1, MAX_S if needs_int64(idx) else MAX_S_INT32)

_level_step_jit = None  # lazily-jitted _level_step_device (one per C shape)


def _level_step_device(t, state, cnt, level, thresh, kpw):
    """One frontier level on device: state [C, 8] -> (new_state [C, 8],
    new_cnt, total_keep). total_keep > C means children were dropped
    (overflow); the caller re-runs the whole device phase at 4x capacity.

    Child order is branch-major with within-branch source order preserved -
    identical to the host build's concatenation, so keys stay sorted and
    the final arrays match build_sparse_dict elementwise."""
    import jax.numpy as jnp

    from .rank import rank6

    C = state.shape[0]
    dt = state.dtype
    lane = jnp.arange(C, dtype=jnp.int32)
    active = lane < cnt
    k = jnp.where(active, state[:, _COL_K], 0)
    sz = jnp.where(active, state[:, _COL_SZ], 0)
    r_k = rank6(t, k)                      # [C, 6]
    delta = rank6(t, k + sz) - r_k         # [C, 6]
    # key bit of this level: goes to key_lo below _KEY_SPLIT bases, else hi
    lvl = jnp.asarray(level, jnp.int32)
    in_lo = lvl < _KEY_SPLIT
    sh = jnp.where(in_lo, 2 * lvl, 2 * lvl - 2 * _KEY_SPLIT)
    out = jnp.zeros_like(state)
    ncnt = jnp.zeros((), jnp.int32)
    for b, code in enumerate(BASE_CODES):
        code = int(code)
        s2 = delta[:, code]
        keep = active & (s2 >= thresh)
        child = jnp.empty_like(state)
        bbit = jnp.asarray(b, dt) << sh.astype(dt)
        child = child.at[:, _COL_KLO].set(
            state[:, _COL_KLO] | jnp.where(in_lo, bbit, 0))
        child = child.at[:, _COL_KHI].set(
            state[:, _COL_KHI] | jnp.where(in_lo, 0, bbit))
        child = child.at[:, _COL_K].set(r_k[:, code] + t.C[code])
        child = child.at[:, _COL_KP].set(
            state[:, _COL_KP] + (delta * kpw[code][None, :]).sum(axis=1))
        child = child.at[:, _COL_SZ].set(s2)
        pos = jnp.cumsum(keep.astype(jnp.int32)) - 1
        # dropped lanes get DISTINCT out-of-bounds slots (5C + lane, past any
        # kept-but-overflowing dst <= 4C-1) so the unique_indices contract
        # holds even on collisions; mode="drop" discards everything >= C
        dst = jnp.where(keep, ncnt + pos, 5 * C + lane)
        out = out.at[dst].set(child, mode="drop", unique_indices=True)
        ncnt = ncnt + keep.sum(dtype=jnp.int32)
    return out, jnp.minimum(ncnt, C), ncnt


def _run_levels_device(tables, state, cnt, t0, s, thresh, kpw):
    """Device levels as chained per-level dispatches with one sync at the
    end: intermediate state stays on the device and only the accumulated
    overflow flag is fetched. Returns (state, cnt, overflowed-flag device
    scalar); on overflow some children were dropped and the caller restarts
    the device phase at 4x capacity."""
    import jax
    import jax.numpy as jnp

    global _level_step_jit
    if _level_step_jit is None:
        _level_step_jit = jax.jit(_level_step_device)
    C = state.shape[0]
    step = _level_step_jit
    ovf = jnp.zeros((), jnp.bool_)
    for lvl in range(t0, s):
        state, cnt, total = step(tables, state, cnt,
                                 jnp.asarray(lvl, jnp.int32), thresh, kpw)
        ovf = ovf | (total > C)
    return state, cnt, ovf


def build_sparse_dict_device(idx: RIndex, tables, s: int, min_keep: int = 1,
                             host_levels_max: int = 1 << 14,
                             capacity: int | None = None, verbose: bool = False):
    """`build_sparse_dict` with the frontier levels on the device.

    The host build's cost is r-driven binary searches with DRAM-latency
    cache misses; the device checkpoint rank6 is one 64 B gather + SWAR
    count per query. Small levels stay on host (numpy, microseconds) so at most
    two device programs ever compile (the fixed 1M-lane early-level
    capacity and the plateau capacity); levels then run as per-level
    dispatches chained on device with ONE host sync at the end
    (_run_levels_device). Capacity defaults to ~1.7x r pow2-rounded
    (measured entry counts are 1.4-2.4x r); overflow restarts the device
    phase at 4x. A state past the memory budget's `sdict_build_max` raises
    MemoryError.

    Exact-equality contract with build_sparse_dict is tested per level
    count and elementwise (tests/test_sparsedict.py)."""
    import jax
    import jax.numpy as jnp

    if not 1 <= s <= MAX_S:
        raise ValueError(f"s must be in [1, {MAX_S}]")
    if s > MAX_S_INT32 and tables.pos_dtype == jnp.int32:
        raise ValueError(f"the int32 device build holds windows of at most "
                         f"{MAX_S_INT32} bases (s={s})")
    thresh = max(int(min_keep), 1)
    # ---- host levels (identical math to build_sparse_dict) ----
    keys = np.zeros(1, np.int64)
    k = np.zeros(1, np.int64)
    kp = np.zeros(1, np.int64)
    sz = np.full(1, idx.n, np.int64)
    t0 = 0
    while t0 < s and 4 * len(keys) <= host_levels_max:
        r_k = idx.rank6(k)
        delta = idx.rank6(k + sz) - r_k
        parts = []
        for b, code in enumerate(BASE_CODES):
            code = int(code)
            s2 = delta[:, code]
            keep = s2 >= thresh
            parts.append((keys[keep] | (np.int64(b) << (2 * t0)),
                          (r_k[:, code] + idx.C[code])[keep],
                          (kp + (KP_WEIGHT[code][None, :] * delta).sum(axis=1))[keep],
                          s2[keep]))
        keys = np.concatenate([p[0] for p in parts])
        k = np.concatenate([p[1] for p in parts])
        kp = np.concatenate([p[2] for p in parts])
        sz = np.concatenate([p[3] for p in parts])
        t0 += 1
    if t0 == s:
        dt = np.int32 if idx.n < 2**31 else np.int64
        return keys, np.stack((k, kp, sz), axis=1).astype(dt)
    # ---- device levels (fused dispatches) ----
    pd = tables.pos_dtype
    jnp_dt = pd
    cnt = len(keys)
    if capacity is None:
        # entry counts measure 1.4-2.4x r; 1.7x before
        # pow2 rounding covers every measured config, overflow restarts at
        # 4x for the tail
        capacity = max(4 * cnt, (17 * idx.n_runs) // 10, 1 << 12)
    C = 1 << (int(capacity) - 1).bit_length()
    itemsize = np.dtype(np.int32 if jnp_dt == jnp.int32 else np.int64).itemsize
    run = _run_levels_device
    kpw = jnp.asarray(KP_WEIGHT, jnp_dt)

    def pack_state(Cap):
        st = np.zeros((Cap, 8), dtype=np.int64)
        st[:cnt, _COL_KLO] = keys[:cnt] & ((1 << (2 * _KEY_SPLIT)) - 1)
        st[:cnt, _COL_KHI] = keys[:cnt] >> (2 * _KEY_SPLIT)
        st[:cnt, _COL_K] = k
        st[:cnt, _COL_KP] = kp
        st[:cnt, _COL_SZ] = sz
        return jnp.asarray(st, jnp_dt)

    # levels producing <= 4^PA_LVL entries run at a small fixed capacity
    # (overflow-impossible: cnt_t <= 4^t), so the big-C program only covers
    # the plateau levels - the early levels no longer pay C-lane work
    PA_LVL = 10
    Ca = 1 << (2 * PA_LVL)
    build_max = memory_budget().sdict_build_max
    while True:
        if 2 * C * 8 * itemsize > build_max:
            raise MemoryError(
                f"sparse dict device build state 2x{C}x8x{itemsize}B exceeds "
                f"the {build_max >> 20} MB budget")
        tA = min(PA_LVL, s)
        thresh_dev = jnp.asarray(thresh, jnp_dt)
        cnt_dev = jnp.asarray(cnt, jnp.int32)
        if t0 < tA and Ca < C:
            state, cnt_dev, _ = run(tables, pack_state(Ca), cnt_dev,
                                    t0, tA, thresh_dev, kpw)
            state = jnp.zeros((C, 8), jnp_dt).at[:Ca].set(state)
            tB = tA
        else:
            state = pack_state(C)
            tB = t0
        ovf = False
        if tB < s:
            state, cnt_dev, ovf = run(tables, state, cnt_dev, tB, s,
                                      thresh_dev, kpw)
        if not bool(ovf):
            break
        C *= 4  # some level dropped children: restart the device phase
        if verbose:
            print(f"sparse dict device: overflow -> capacity {C}", flush=True)
    cnt = int(cnt_dev)
    if verbose:
        print(f"sparse dict device: {cnt} entries at capacity {C}", flush=True)
    st = np.asarray(jax.device_get(state[:cnt])).astype(np.int64)
    out_keys = st[:, _COL_KLO] | (st[:, _COL_KHI] << (2 * _KEY_SPLIT))
    dt = np.int32 if idx.n < 2**31 else np.int64
    vals = np.ascontiguousarray(
        st[:, (_COL_K, _COL_KP, _COL_SZ)]).astype(dt)
    return out_keys, vals


def sparse_dict_key(idx: RIndex, s: int, min_keep: int = 1) -> str:
    """Content key of (index, s, min_keep) - the dictionary is a pure
    function of these (same scheme as mertable.mer_table_key)."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.int64([0x5D1C7, s, min_keep, idx.n, idx.n_runs]).tobytes())
    h.update(np.ascontiguousarray(idx.run_sym).tobytes())
    h.update(np.ascontiguousarray(idx.run_len).tobytes())
    return h.hexdigest()[:16]


def get_sparse_dict(idx: RIndex, s: int, path=None, min_keep: int = 1,
                    tables=None):
    """Cached build: (keys, vals) persisted at `path` keyed by content.

    When device tables are passed the frontier runs on the device
    (build_sparse_dict_device), otherwise on the host (build_sparse_dict);
    both give the same arrays. A failed device build raises."""
    import os
    import sys

    key = sparse_dict_key(idx, s, min_keep)
    if path is not None and os.path.exists(path):
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["key"]) == key:
                    return z["keys"], z["vals"]
            print(f"sparse dict {path}: stale key, rebuilding", file=sys.stderr)
        except Exception as exc:
            print(f"sparse dict {path}: unreadable ({exc}), rebuilding",
                  file=sys.stderr)
    if tables is not None:
        keys, vals = build_sparse_dict_device(idx, tables, s, min_keep)
    else:
        keys, vals = build_sparse_dict(idx, s, min_keep)
    if path is not None:
        try:
            tmp = f"{path}.tmp{os.getpid()}"
            with open(tmp, "wb") as fh:
                np.savez(fh, keys=keys, vals=vals, key=key)
            os.replace(tmp, path)
        except Exception as exc:
            print(f"sparse dict {path}: not saved ({exc})", file=sys.stderr)
    return keys, vals


def read_windows_fast(codes: np.ndarray, lengths: np.ndarray, s: int,
                      dict_keys: np.ndarray):
    """(keys, valid, dict row idx) in one native OpenMP pass when available
    (src/cpp/read_windows.cpp: rolling keys + radix-bucketed lookups;
    bit-identical to read_mer_keys + lookup_read_windows, fuzz-tested).
    The numpy pair costs over a second per 16384x150 bp batch on one
    core."""
    from .mertable import read_mer_keys

    try:
        from .. import native

        if len(dict_keys) == 0:
            raise RuntimeError("empty dictionary: numpy path handles it")
        return native.read_windows_native(codes, lengths, s,
                                          dict_keys=dict_keys)
    except Exception:
        rk, rv = read_mer_keys(codes, lengths, s)
        return rk, rv, lookup_read_windows(dict_keys, rk, rv)


def lookup_read_windows(keys: np.ndarray, read_keys: np.ndarray,
                        read_valid: np.ndarray) -> np.ndarray:
    """Dictionary row index per read window (-1 = absent/invalid).

    read_keys/read_valid: [B, L+1] from read_mer_keys(codes, lens, s).
    Host-side np.searchsorted - one binary search per window, outside the
    device serving loop (the same once-per-batch host precompute as the
    read keys themselves). Queries are sorted first: consecutive probes
    then walk the key array nearly monotonically (cache-resident upper
    levels), measured 2.4x faster than direct random-order lookups."""
    if len(keys) == 0:  # nothing occurs at this s (tiny index): all miss
        return np.full(read_keys.shape, -1, np.int32)
    flat = read_keys.reshape(-1).astype(np.int64)
    o = np.argsort(flat, kind="stable")
    ps = np.searchsorted(keys, flat[o])
    pos = np.empty_like(ps)
    pos[o] = ps
    pos_c = np.minimum(pos, len(keys) - 1)
    hit = (keys[pos_c] == flat) & read_valid.reshape(-1)
    return np.where(hit, pos_c, -1).reshape(read_keys.shape).astype(np.int32)
