"""m-mer seed table: precomputed FMD bi-intervals for every ACGT m-mer.

MEM finding restarts backward extension from the full interval at every
find_mems_function call (steps 1 and 3, algorithm.hpp:661, 718). Interval
sizes are non-increasing along an extension, so if the final m-mer interval
still satisfies min_occ, every intermediate step did too - meaning the first
m extensions can be replaced by ONE table lookup with exact semantics
(dropout cases fall back to stepwise extension to recover the precise
failure position).

The table is built by level-synchronous batched extension (4^1 -> 4^2 ->
... -> 4^m), on the device or in host numpy; at m=14 it is 4^14 x 3 int32 =
3.2 GB of device memory, and skips 2m of the ~(2*min_len + forward)
extensions per MEM call.
"""

from __future__ import annotations

import numpy as np

from ..models.rindex import RIndex
from ..utils.alphabet import KP_WEIGHT

#: ACGT bases in 2-bit key order (A=0, C=1, G=2, T=3) -> alphabet codes
BASE_CODES = np.array([1, 2, 3, 5], dtype=np.int64)
#: alphabet code -> 2-bit base (or -1)
CODE_TO_BASE = np.full(8, -1, dtype=np.int64)
for _b, _c in enumerate(BASE_CODES):
    CODE_TO_BASE[_c] = _b


def _batched_backward_extend(idx: RIndex, k, kp, s, code: int):
    r_k = idx.rank6(k)
    r_ks = idx.rank6(k + s)
    delta = r_ks - r_k
    kp2 = kp + (KP_WEIGHT[code][None, :] * delta).sum(axis=1)
    s2 = delta[:, code]
    k2 = r_k[:, code] + idx.C[code]
    ok = s2 > 0
    return np.where(ok, k2, 0), np.where(ok, kp2, 0), np.where(ok, s2, 0)


def build_mer_table(idx: RIndex, m: int) -> np.ndarray:
    """[4^m, 3] array of (k, kp, s) for every m-mer, keyed by the 2-bit pack
    with the LEFTMOST character in the highest bits (matching core/kmers)."""
    k = np.zeros(1, dtype=np.int64)
    kp = np.zeros(1, dtype=np.int64)
    s = np.full(1, idx.n, dtype=np.int64)
    # build right-to-left: level t holds intervals of all length-t suffixes,
    # keyed by their 2-bit pack (leftmost char of the suffix in high bits)
    for t in range(m):
        size = 4**t
        nk = np.empty(4 * size, dtype=np.int64)
        nkp = np.empty(4 * size, dtype=np.int64)
        ns = np.empty(4 * size, dtype=np.int64)
        for b, code in enumerate(BASE_CODES):
            # prepending base b: new_key = b << (2t) | old_key
            ek, ekp, es = _batched_backward_extend(idx, k, kp, s, int(code))
            nk[b * size : (b + 1) * size] = ek
            nkp[b * size : (b + 1) * size] = ekp
            ns[b * size : (b + 1) * size] = es
        k, kp, s = nk, nkp, ns
    return np.stack((k, kp, s), axis=1)


_build_mer_jit = None

#: levels at/below this depth run as one fori_loop over the full 4^FORI_BASE
#: key space; deeper levels expand explicitly (4x per level). 12 keeps the
#: fori carries at 3 x 67 MB (int32) while the last levels never
#: double-buffer the full-depth state: at m=14 the peak is old state + new
#: state + the output stack instead of a double-buffered 3.2 GB carry.
FORI_BASE = 12


def build_mer_table_device(t, m: int, fori_base: int | None = None) -> "jax.Array":
    """Device-side table build, hybrid schedule.

    Phase 1 - batched extension over the full 4^min(m, FORI_BASE) key space
    with a fori_loop over the levels (fixed shapes, ONE compiled extend:
    the growing-shape expansion traced as 4m separate extends took minutes
    of XLA time per process). Every key carries its own interval state;
    after level v, state[key] is the bi-interval of key's length-v suffix
    (keys sharing low bits duplicate work - a bounded redundancy factor).

    Phase 2 - explicit 4x expansion per remaining level (m - FORI_BASE
    extra traced extends, only ever 2 at the m=14 default): peak memory is
    old state + new state instead of a double-buffered full-width carry,
    and the last level writes the [4^m, 3] output layout directly.

    All extends run under lax.map slabs so gather temps stay O(slab).
    The jitted builder is module-level, so repeat calls with the same
    tables/m hit the jit cache instead of re-tracing."""
    global _build_mer_jit
    if _build_mer_jit is None:
        import functools

        import jax
        import jax.numpy as jnp

        from .fmd import extend

        SLAB = 1 << 18

        def _slabbed(fn, args, size):
            slab = min(size, SLAB)
            n_slabs = size // slab
            res = jax.lax.map(fn, tuple(a.reshape((n_slabs, slab) + a.shape[1:])
                                        for a in args))
            return tuple(r.reshape((size,) + r.shape[2:]) for r in res)

        def _ext_at(t, v):
            def one(args):
                kk, k1, kp1, s1 = args
                # prepend the char left of the length-v suffix: 2-bit
                # base at bit 2v; codes are 1,2,3,5 for bases 0,1,2,3
                b = (kk >> (2 * v)) & 3
                c = b + 1 + (b == 3)
                return extend(t, k1, kp1, s1, c)
            return one

        @functools.partial(jax.jit, static_argnames=("m", "base"))
        def _build(t, m, base):
            pd = t.pos_dtype
            size = 4**base
            slab = min(size, SLAB)
            n_slabs = size // slab
            keys = jnp.arange(size, dtype=jnp.int32).reshape(n_slabs, slab)
            k = jnp.zeros((n_slabs, slab), pd)
            kp = jnp.zeros((n_slabs, slab), pd)
            s = jnp.full((n_slabs, slab), t.n, pd)

            def body(v, st):
                return jax.lax.map(_ext_at(t, v), (keys, *st))

            k, kp, s = jax.lax.fori_loop(0, base, body, (k, kp, s))
            k, kp, s = (a.reshape(size) for a in (k, kp, s))
            for v in range(base, m):
                # new_key = b << (2v) | old_key: tile the old state 4x; the
                # prepended base is read off the new key inside the extend
                size *= 4
                keys = jnp.arange(size, dtype=jnp.int32)
                k, kp, s = (jnp.tile(a, 4) for a in (k, kp, s))
                if v == m - 1:
                    # final level emits the [4^m, 3] table layout directly
                    def last(args, _v=v, _t=t):
                        ek, ekp, es = _ext_at(_t, _v)(args)
                        return (jnp.stack((ek, ekp, es), axis=-1),)
                    return _slabbed(last, (keys, k, kp, s), size)[0]
                k, kp, s = _slabbed(_ext_at(t, v), (keys, k, kp, s), size)
            return jnp.stack((k, kp, s), axis=1)

        _build_mer_jit = _build
    base = min(m, FORI_BASE if fori_base is None else fori_base)
    return _build_mer_jit(t, m, base)


def mer_table_key(idx: RIndex, m: int) -> str:
    """Content key of the (index, m) pair the table is a pure function of."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.int64([m, idx.n, idx.n_runs]).tobytes())
    h.update(np.ascontiguousarray(idx.run_sym).tobytes())
    h.update(np.ascontiguousarray(idx.run_len).tobytes())
    return h.hexdigest()[:16]


def get_mer_table(idx: RIndex, m: int, path=None, tables=None):
    """Seed table for serving: the npz cache at `path` when its content key
    matches (a pure function of (index, m)), else a build - on the GPU by
    `build_mer_table_device` against `tables` (device RIndexTables; built
    here if not given), on a requested CPU backend by the numpy
    `build_mer_table`. A build is persisted to `path`, except on the GPU for
    tables past the memory budget's `mer_cache_max`, which are rebuilt in
    every process rather than fetched, written and read back.

    Returns (table_np, table_device): a GPU build also returns the device
    array, so a serving engine needs no host round trip; table_np is None
    when such a table was not fetched for the cache. A failed build raises."""
    import sys

    from ..device import memory_budget, serving_device

    dev = serving_device()
    on_gpu = dev.platform == "gpu"
    key = mer_table_key(idx, m)
    nbytes = 4**m * 3 * (8 if idx.n >= 2**31 else 4)
    if on_gpu and path is not None and nbytes > memory_budget(dev).mer_cache_max:
        path = None
    if path is not None:
        try:
            with np.load(path, allow_pickle=False) as z:
                if str(z["key"]) == key:
                    return z["table"], None
            print(f"mer cache {path}: stale key, rebuilding", file=sys.stderr)
        except FileNotFoundError:
            pass
        except Exception as exc:
            print(f"mer cache {path}: unreadable ({exc}), rebuilding",
                  file=sys.stderr)
    if on_gpu:
        if tables is None:
            from .tables import rindex_to_device

            tables = rindex_to_device(idx, checkpoint=idx.n < 2**31)
        table_dev = build_mer_table_device(tables, m)
        table = np.asarray(table_dev) if path is not None else None
    else:
        table_dev = None
        table = build_mer_table(idx, m)
    if path is not None:
        _persist_mer(path, table, key)
    return table, table_dev


def _persist_mer(path, table, key):
    import os
    import sys

    try:
        tmp = f"{path}.tmp{os.getpid()}"
        with open(tmp, "wb") as fh:
            np.savez(fh, table=table, key=key)
        os.replace(tmp, path)
    except Exception as exc:
        print(f"mer cache {path}: not saved ({exc})", file=sys.stderr)


def seed_difficulty(mer_table, keys, valid, min_occ, lengths=None, m=None):
    """Per-read work proxy for work-sorted chunking: the number of *in-read*
    windows whose precomputed m-mer interval fails min_occ (error sites and
    rare regions force stepwise fallback and extra MEM restarts, which set
    the lockstep loop's iteration count). Sorting a multi-chunk batch by this
    proxy makes each lane chunk work-homogeneous, so the per-chunk max tracks
    the chunk mean instead of the global max. Accepts numpy or jax arrays of
    matching kinds; returns [B] counts.

    With lengths/m given, only windows inside each read count: padding
    windows past a short read's end need zero loop iterations, so counting
    them (as ~valid alone would) would rank short reads hardest and weaken
    chunk work-homogeneity for variable-length batches.
    """
    s = mer_table[keys.reshape(-1), 2].reshape(keys.shape)
    bad = ((s < max(int(min_occ), 1)) & valid).sum(axis=1)
    if lengths is None:
        return bad + (~valid).sum(axis=1)
    # invalid-but-inside windows = in-read window count minus valid count
    in_read = (lengths - (m - 1)).clip(0)
    return bad + in_read - valid.sum(axis=1)


def read_mer_keys_fast(codes: np.ndarray, lengths: np.ndarray, m: int):
    """read_mer_keys through the native OpenMP pass when available
    (src/cpp/read_windows.cpp; bit-identical, fuzz-tested) - the rolling
    numpy scan costs ~0.56 s per 16384x150 bp batch of serving host
    precompute, the native pass milliseconds."""
    try:
        from .. import native

        k, v, _ = native.read_windows_native(codes, lengths, m)
        return k, v
    except Exception:
        return read_mer_keys(codes, lengths, m)


def read_mer_keys(codes: np.ndarray, lengths: np.ndarray, m: int):
    """Per-position rolling m-mer keys for a read batch.

    codes: [B, L] alphabet codes. Returns (keys [B, L+1] int32 - int64 when
    2m > 31 bits, i.e. m > 15 (the long-seed dictionary windows) -
    valid [B, L+1] bool) where entry i describes the window codes[i-m+1 .. i];
    valid requires the window to be ACGT-only and fully inside the read.

    Computed as a rolling scan over columns (L vector steps of [B] work):
    the old [B, L, m]-window materialization cost ~1 ms/read of host time at
    the long-seed sizes - slower than the device serving it feeds. Key bits
    at non-ACGT positions are garbage by construction; `valid` masks them
    (and every consumer clamps/filters through it)."""
    B, L = codes.shape
    base = CODE_TO_BASE[codes]
    ok = base >= 0
    keys = np.zeros((B, L + 1), dtype=np.int64)
    valid = np.zeros((B, L + 1), dtype=bool)
    if L >= m:
        mask = (np.int64(1) << (2 * m)) - 1
        k = np.zeros(B, np.int64)
        run = np.zeros(B, np.int32)  # consecutive ACGT count ending at i
        b = np.maximum(base, 0)
        for i in range(L):
            k = ((k << 2) | b[:, i]) & mask
            run = np.where(ok[:, i], run + 1, 0)
            if i >= m - 1:
                keys[:, i] = k
                valid[:, i] = run >= m
        valid[:, :L] &= np.arange(L)[None, :] < lengths[:, None]
    return keys.astype(np.int32 if m <= 15 else np.int64), valid
