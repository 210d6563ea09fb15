"""Host-side r-index model: flat-array construction and numpy queries.

This is the accelerator-first re-design of the reference's ``FastLocate``
(include/pangenome_index/r-index.hpp, src/r-index.cpp). Instead of 10-run
blocks with per-block cumulative counts and linear in-block scans
(r-index.hpp:134-297), we keep **flat per-run tables**:

    run_sym[r]   int8   dense code of each logical run
    run_start[r] i64    BWT offset of the run head
    cum[r, 6]    i64    occ counts of every code before the run head
    C[7]         i64    exclusive prefix counts per code over the whole BWT
    samples[r]   i64    packed (seq_id, seq_offset) SA sample at each run head
    last_sorted[r] i64  sorted packed text positions of run tails
    last_to_run[r] i64  run id of each sorted tail

rank(pos, c) is then one searchsorted + one gather instead of a predecessor
query plus a <=10-run scan (replaces r-index.cpp:558-568), which is the form
that vectorizes onto device lanes (see ops/rank.py).

Semantics preserved exactly from the reference:
* every endmarker occurrence is its own logical run (r-index.cpp:840-928)
* samples are packed as seq_id * max_length + offset with offsets measured
  as distance flips (r-index.cpp:1082-1083, 1110-1113); the flipped offset
  equals the suffix start position within its sequence
* locateNext(prev) = samples[last_to_run[pred(prev)] + 1] + (prev - pred_pos)
  (r-index.cpp:1369-1372)
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from ..formats.rlbwt import RLBWT
from ..utils.alphabet import BYTE_TO_CODE, COMP_CODE, KP_WEIGHT, NENDMARKER, SIGMA


@dataclass
class RIndex:
    # run tables
    run_sym: np.ndarray      # int8 [r]
    run_start: np.ndarray    # int64 [r]
    run_len: np.ndarray      # int64 [r]
    cum: np.ndarray          # int64 [r, 6]
    C: np.ndarray            # int64 [7]
    n: int                   # BWT size (total text length incl endmarkers)
    n_seq: int
    max_len: int             # longest sequence length incl endmarker
    # locate machinery
    samples: np.ndarray      # int64 [r]
    last_sorted: np.ndarray  # int64 [r]
    last_to_run: np.ndarray  # int64 [r]
    # full SA (kept when built with keep_sa=True): per BWT row, the sequence
    # id and the suffix start offset within that sequence
    sa_seq: np.ndarray | None = None
    sa_pos: np.ndarray | None = None
    seq_lengths: np.ndarray | None = None

    @property
    def n_runs(self) -> int:
        return len(self.run_sym)

    # ------------------------------------------------------------- packing
    def pack(self, seq_id, seq_offset):
        return seq_id * self.max_len + seq_offset

    def seq_id(self, packed):
        return packed // self.max_len

    def seq_offset(self, packed):
        return packed % self.max_len

    # --------------------------------------------------------------- rank
    def run_of(self, pos):
        """Run id containing BWT position pos (pos == n maps to last run)."""
        return np.searchsorted(self.run_start, pos, side="right") - 1

    def rank(self, pos, code):
        """occ(code, [0, pos)) - replaces FastLocate::rankAt (r-index.cpp:558)."""
        j = self.run_of(pos)
        extra = np.where(self.run_sym[j] == code, pos - self.run_start[j], 0)
        return self.cum[j, code] + extra

    def rank6(self, pos):
        """All-symbol rank vector at pos - replaces rank_at_cached
        (r-index.cpp:593-603) without the N-absent aliasing quirk."""
        pos = np.asarray(pos)
        j = self.run_of(pos)
        out = self.cum[j].copy()
        sym = self.run_sym[j]
        out[..., :] += (np.arange(SIGMA) == sym[..., None]) * (pos - self.run_start[j])[..., None]
        return out

    def bwt_code_at(self, pos):
        return self.run_sym[self.run_of(pos)]

    # ----------------------------------------------------------------- LF
    def lf_range(self, first, second, code):
        """LF mapping of a range for one symbol (r-index.cpp:650-686).

        Returns the empty sentinel (1, 0) exactly like the reference when the
        symbol is the endmarker/unknown (code 0) or the range is/become empty.
        """
        if code == 0 or first > second:
            return (1, 0)
        lo = int(self.rank(first, code))
        inside = int(self.rank(second + 1, code)) - lo
        if inside == 0:
            return (1, 0)
        start = lo + int(self.C[code])
        return (start, start + inside - 1)

    def count(self, pattern: bytes):
        """Backward search; returns BWT range (r-index.hpp:541-556)."""
        rng = (0, self.n - 1)
        for b in reversed(pattern):
            rng = self.lf_range(rng[0], rng[1], int(BYTE_TO_CODE[b]))
        return rng

    # ---------------------------------------------------------------- psi
    def psi_perm(self) -> np.ndarray:
        """The full backward-navigation permutation pi[i] = C[c]+rank(i,c)
        (vectorized form of FastLocate::psi, r-index.cpp:530-533)."""
        pi = np.zeros(self.n, dtype=np.int64)
        sym = self.run_sym.astype(np.int64)
        base = self.C[sym] + self.cum[np.arange(self.n_runs), sym]
        # rows of run j map to base[j] + offset_in_run
        reps = self.run_len
        row = np.repeat(base, reps) + (np.arange(self.n) - np.repeat(self.run_start, reps))
        return row

    # -------------------------------------------------------------- locate
    def locate_first(self) -> int:
        return int(self.samples[0])

    def locate_next(self, prev):
        idx = np.searchsorted(self.last_sorted, prev, side="right") - 1
        run = self.last_to_run[idx] + 1
        return self.samples[run] + (prev - self.last_sorted[idx])

    def decompress_sa(self) -> np.ndarray:
        """SA in packed coords for every row (r-index.cpp:1345-1356 chains
        locateNext row by row; here lanes = runs and each lane walks its own
        run via locateNext, so the wall time is max run length batches of
        vectorized work, not n scalar steps)."""
        out = np.zeros(self.n, dtype=np.int64)
        cur = self.samples.copy()
        lens = self.run_len
        active = np.ones(self.n_runs, dtype=bool)
        t = 0
        while active.any():
            out[self.run_start[active] + t] = cur[active]
            t += 1
            active = active & (lens > t)
            if active.any():
                cur[active] = self.locate_next(cur[active])
        return out

    def decompress_da(self) -> np.ndarray:
        return self.seq_id(self.decompress_sa())

    def occ_end_of_seq(self):
        """(i, SA[i]) pairs for rows 0..n_seq-1 (FastLocate::OCC, r-index.hpp:529)."""
        prev = self.locate_first()
        occ = [(0, prev)]
        for i in range(1, self.n_seq):
            prev = int(self.locate_next(prev))
            occ.append((i, prev))
        return occ

    # ----------------------------------------------------------------- FMD
    def backward_extend(self, bint, code):
        """Li-style FMD backward extension (r-index.cpp:1395-1428)."""
        k, kp, s = bint
        r_ks = self.rank6(k + s)
        r_k = self.rank6(k)
        delta = r_ks - r_k
        kp = kp + int((KP_WEIGHT[code] * delta).sum())
        if r_k[code] >= r_ks[code]:
            return (0, 0, 0)
        return (int(r_k[code] + self.C[code]), int(kp), int(delta[code]))

    def forward_extend(self, bint, code):
        k, kp, s = bint
        t = self.backward_extend((kp, k, s), int(COMP_CODE[code]))
        return (t[1], t[0], t[2])


def _native_walk_available() -> bool:
    if os.environ.get("PANIDX_NO_NATIVE_WALK"):
        return False
    from .. import native

    return native.available() and hasattr(native.get_lib(), "panindex_psi_walk_v2")


def build_rindex_from_sa(rlbwt: RLBWT, seq_of_row: np.ndarray, pos_of_row: np.ndarray,
                         seq_lengths: np.ndarray) -> RIndex:
    """Construction fast path when the suffix array is already known (e.g.
    from the oracle during benchmarking): skips the psi walk entirely."""
    idx = build_rindex(rlbwt, _sa_hint=(seq_of_row, pos_of_row, seq_lengths))
    return idx


def build_rindex(rlbwt: RLBWT, progress: bool = False, _sa_hint=None,
                 keep_sa: bool = False) -> RIndex:
    """Construct the r-index from a run-length BWT.

    Replaces the FastLocate constructor (src/r-index.cpp:778-1139). The
    sequential per-sequence psi-walk (the reference's hot loop,
    r-index.cpp:1025-1094) becomes a lane-per-sequence batched walk over the
    psi permutation: one gather per step for all sequences at once.
    """
    syms = BYTE_TO_CODE[rlbwt.syms].astype(np.int8)
    freqs = rlbwt.freqs.astype(np.int64)

    # the index is defined over the fixed 6-symbol alphabet (utils/alphabet);
    # unknown bytes would silently alias to the endmarker and corrupt every
    # structure downstream - reject them loudly
    from ..utils.alphabet import NUC

    bad = ~np.isin(rlbwt.syms, NUC)
    if bad.any():
        vals = sorted(set(int(b) for b in rlbwt.syms[bad]))[:10]
        raise ValueError(
            f"BWT contains bytes outside the {{\\n,A,C,G,N,T}} alphabet: {vals}"
        )

    # split endmarker runs into unit runs (r-index.cpp:840-928)
    is_end = syms == 0
    reps = np.where(is_end, freqs, 1)
    run_sym = np.repeat(syms, reps)
    run_len = np.where(np.repeat(is_end, reps), 1, np.repeat(freqs, reps))
    r = run_sym.size
    run_start = np.zeros(r, dtype=np.int64)
    np.cumsum(run_len[:-1], out=run_start[1:])
    n = int(run_len.sum())

    # per-code totals and exclusive prefix C over the full 6-code space
    totals = np.zeros(SIGMA, dtype=np.int64)
    np.add.at(totals, run_sym.astype(np.int64), run_len)
    C = np.zeros(SIGMA + 1, dtype=np.int64)
    np.cumsum(totals, out=C[1:])

    # per-run cumulative occ before the run head
    cum = np.zeros((r, SIGMA), dtype=np.int64)
    contrib = np.zeros((r, SIGMA), dtype=np.int64)
    contrib[np.arange(r), run_sym.astype(np.int64)] = run_len
    np.cumsum(contrib[:-1], axis=0, out=cum[1:])

    n_seq = int(totals[0])
    if n_seq == 0:
        raise ValueError("BWT contains no endmarkers")

    idx = RIndex(
        run_sym=run_sym, run_start=run_start, run_len=run_len, cum=cum,
        C=C, n=n, n_seq=n_seq, max_len=1,
        samples=np.zeros(r, dtype=np.int64),
        last_sorted=np.zeros(r, dtype=np.int64),
        last_to_run=np.zeros(r, dtype=np.int64),
    )

    if _sa_hint is not None:
        # keep the caller's dtype (the native SA-IS hands int32 below 2^31 -
        # half the build-plane bytes); packing upcasts on the r-sized slice
        seq_of_row, pos_of_row = (np.asarray(a) for a in _sa_hint[:2])
        seq_len = np.asarray(_sa_hint[2], np.int64)
        max_len = int(seq_len.max())
        idx.max_len = max_len

        def packed_at(rows):
            return seq_of_row[rows].astype(np.int64) * max_len + pos_of_row[rows]

        if keep_sa:
            idx.sa_seq, idx.sa_pos, idx.seq_lengths = seq_of_row, pos_of_row, seq_len
    elif _native_walk_available():
        # --- run-length-bounded native walk (src/cpp/psi_walk.cpp) ---
        # Memory stays O(r): samples are recorded at run heads/tails during
        # the walk itself, so neither the psi permutation nor any per-row
        # array is ever materialized (the numpy fallback below needs
        # ~25 B/char of those). keep_sa builds ask the same walk for the
        # per-row (lane, step) arrays the tag gather consumes - O(n) output,
        # but no O(n) walk temporaries and a ~40x faster walk. Same reference
        # semantics: per-sequence psi walk + distance-flipped offsets
        # (r-index.cpp:1025-1094).
        from .. import native

        psi_base = C[run_sym.astype(np.int64)] + cum[np.arange(r), run_sym.astype(np.int64)]
        res = native.psi_walk_native(
            run_start, psi_base, run_sym == 0, n, n_seq, full_sa=keep_sa)
        h_seq, h_t, t_seq, t_t, seq_len = res[:5]
        max_len = int(seq_len.max())
        idx.max_len = max_len
        idx.samples = h_seq * max_len + (seq_len[h_seq] - 1 - h_t)
        tail_packed = t_seq * max_len + (seq_len[t_seq] - 1 - t_t)
        order = np.argsort(tail_packed, kind="stable")
        idx.last_sorted = tail_packed[order]
        idx.last_to_run = order.astype(np.int64)
        if keep_sa:
            sa_seq, sa_t = res[5], res[6]
            idx.sa_seq = sa_seq
            idx.sa_pos = seq_len[sa_seq] - 1 - sa_t
            idx.seq_lengths = seq_len
        return idx
    else:
        # --- lane-per-sequence psi walk assigning (seq, step) to every row ---
        pi = idx.psi_perm()
        bwt_codes = np.repeat(run_sym, run_len)
        seq_of_row = np.zeros(n, dtype=np.int64)
        t_of_row = np.zeros(n, dtype=np.int64)
        seq_len = np.zeros(n_seq, dtype=np.int64)

        cur = np.arange(n_seq, dtype=np.int64)
        active = np.ones(n_seq, dtype=bool)
        lanes = np.arange(n_seq, dtype=np.int64)
        t = 0
        while active.any():
            rows = cur[active]
            seq_of_row[rows] = lanes[active]
            t_of_row[rows] = t
            # a lane stops after visiting the row whose BWT char is the endmarker
            stop = bwt_codes[rows] == 0
            seq_len[lanes[active][stop]] = t + 1
            nxt = pi[rows]
            still = ~stop
            cur[active] = np.where(still, nxt, cur[active])
            new_active = active.copy()
            new_active[active] = still
            active = new_active
            t += 1

        max_len = int(seq_len.max())
        idx.max_len = max_len

        # --- samples at run heads; `last` marks at run tails ---
        # suffix position of row w = seq_len - 1 - t (the distance flip at
        # r-index.cpp:1082-1083); equals the suffix start offset in its sequence.
        def packed_at(rows):
            s = seq_of_row[rows]
            off = seq_len[s] - 1 - t_of_row[rows]
            return s * max_len + off

        if keep_sa:
            idx.sa_seq = seq_of_row
            idx.sa_pos = seq_len[seq_of_row] - 1 - t_of_row
            idx.seq_lengths = seq_len

    idx.samples = packed_at(run_start)
    tail_rows = run_start + run_len - 1
    tail_packed = packed_at(tail_rows)
    order = np.argsort(tail_packed, kind="stable")
    idx.last_sorted = tail_packed[order]
    idx.last_to_run = order.astype(np.int64)
    return idx
