"""Batched MEM finding: lane-per-read state machine on the device.

The reference finds MEMs one read at a time with data-dependent loops
(find_mems_function / find_all_mems, algorithm.hpp:653-757). Here thousands
of reads run in lockstep lanes inside one `lax.while_loop`; every iteration
performs ONE bidirectional extension for every active lane (two rank6
gathers), and per-lane phase logic advances the 3-step algorithm with masks.
Divergence (reads at different phases/positions) costs idle lanes, not
correctness - the algorithm, including dropout rules, the bint2 bookkeeping,
and the P[e] NUL sentinel of step 3, matches models/mems.py exactly (tested
lane-vs-scalar in tests/test_device_engine.py).

Phases: 0 = start a find_mems_function call at x, 1/2/3 = the reference's
three steps, 4 = read done, 5 = entering step 3 next iteration (so the m-mer
seed lookup for step 3 shares ONE one-hot block with the step-1 lookup - the
[B, L+1] seed-table reads are the second-largest per-iteration memory cost
after the rank gathers). MEMs land in
fixed-capacity per-lane buffers (capacity overflow is flagged, not silently
dropped; `count` stays exact past the capacity).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from .fmd import extend
from .tables import RIndexTables


class MemResult(NamedTuple):
    start: jax.Array   # [B, M]
    end: jax.Array     # [B, M]
    bwt_start: jax.Array  # [B, M]
    size: jax.Array    # [B, M]
    count: jax.Array   # [B] number of MEMs found (may exceed M)
    overflow: jax.Array  # [B] bool: count exceeded capacity M


def find_mems_impl(t: RIndexTables, codes: jax.Array, lengths: jax.Array,
                   min_len, min_occ, capacity: int = 32, rank6_fn=None,
                   mer_table=None, mer_keys=None, mer_valid=None,
                   mer_m: int = 0, with_stats: bool = False,
                   cond_every: int = 8, pair_rank: bool | None = None,
                   sdict_vals=None, sdict_idx=None,
                   sdict_m: int = 0) -> MemResult:
    """codes: [B, L] int32 (0-padded), lengths: [B]. Returns MemResult.

    The pad column j == length reads code 0 - the reference's std::string NUL
    sentinel behavior in step 3 (algorithm.hpp:722-732).

    rank6_fn overrides the rank provider (for model-parallel index shards);
    note it is called once per loop iteration inside lax.while_loop, so with a
    collective-based provider every device must run the same iteration count -
    the while condition only depends on replicated lane state, which holds
    when codes/lengths are identical across the model axis.

    sdict_vals/sdict_idx/sdict_m add the sparse long-seed dictionary tier
    (ops/sparsedict.py): sdict_idx[b, i] is the dictionary row of the
    length-sdict_m window ending at i (-1 = absent), sdict_vals[d] its
    (k, kp, s) bi-interval. Per position the LONGEST tier whose interval
    passes min_occ wins (long seed -> dense mer_table row -> stepwise);
    seed lengths become per-position, so one dictionary hit replaces
    sdict_m - mer_m dependent extension steps at step-1/step-3 entries.
    Without a dictionary the compiled program is unchanged.

    with_stats=True additionally returns {"steps": total active-lane
    extensions executed, "iters": loop iterations} - the in-serving step
    rate these imply is the BASELINE.json inner-loop efficiency metric.
    """
    B, L = codes.shape
    if L >= 0xFFFF:  # (start, end) pack into one int32 buffer, 16 bits each
        raise ValueError(f"read length {L} exceeds the 65534 engine limit")
    pd = t.pos_dtype
    # codes live in the loop as int8: the per-iteration one-hot select reads
    # the whole [B, L+1] table, so narrow dtype = 4x less HBM traffic
    codes = jnp.pad(codes.astype(jnp.int8), ((0, 0), (0, 1)))
    lengths = lengths.astype(pd)
    min_len = jnp.asarray(min_len, pd)
    min_occ = jnp.asarray(min_occ, pd)
    N = t.n.astype(pd)
    M = capacity

    # Pre-resolve the m-mer seed lookups for every read position ONCE, outside
    # the loop: seed_*[b, i] = (k, kp, s) of the m-mer window ending at i,
    # with s = 0 for invalid windows. Inside the loop a seed is then a single
    # per-lane row lookup instead of 4 (keys, valid, table row x2).
    seed_k = seed_kp = seed_s = seed_len = None
    if mer_table is not None:
        rows = mer_table[mer_keys.reshape(-1)].reshape(B, L + 1, 3)
        ok = mer_valid & (rows[..., 2] > 0)
        rows = jnp.where(ok[..., None], rows, 0).astype(pd)
        seed_k, seed_kp, seed_s = rows[..., 0], rows[..., 1], rows[..., 2]
    if sdict_vals is not None:
        # long-seed tier: one [B*(L+1)]-row gather into the sparse dictionary
        # (the dense-tier gather above is the same shape), then a
        # longest-tier-first merge. Selection against min_occ happens HERE,
        # outside the loop - min_occ is a traced scalar, so no extra in-loop
        # reads beyond the int8 seed_len table.
        if seed_k is None:
            zf = jnp.zeros((B, L + 1), pd)
            seed_k = seed_kp = seed_s = zf
        # dense-tier rows were zeroed when invalid, so seed_s > 0 marks them
        seed_len = jnp.where(seed_s > 0, jnp.int8(mer_m), jnp.int8(0))
        D = sdict_vals.shape[0]
        lrows = sdict_vals[jnp.clip(sdict_idx, 0, D - 1).reshape(-1)] \
            .reshape(B, L + 1, 3).astype(pd)
        ls = lrows[..., 2]
        use = (sdict_idx >= 0) & (ls >= jnp.maximum(min_occ, 1)) & (ls > 0)
        seed_k = jnp.where(use, lrows[..., 0], seed_k)
        seed_kp = jnp.where(use, lrows[..., 1], seed_kp)
        seed_s = jnp.where(use, ls, seed_s)
        seed_len = jnp.where(use, jnp.int8(sdict_m), seed_len)

    # Per-lane lookups into the [B, L+1] read-local tables (codes, seeds) are
    # one-hot select-sums, not gathers: they cost O(L) vector work per lane
    # per step in exchange for one gather stream less in a loop designed as
    # gather-bound (whether that trade holds on the GPU is not measured).
    iotaL = jnp.arange(L + 1, dtype=jnp.int32)[None, :]

    def take_local(tab, idx):
        return jnp.where(iotaL == idx[:, None], tab, 0).sum(axis=1)

    class S(NamedTuple):
        phase: jax.Array
        x: jax.Array
        j: jax.Array
        k: jax.Array
        kp: jax.Array
        s: jax.Array
        k2: jax.Array
        kp2: jax.Array
        s2: jax.Array
        m_se: jax.Array      # [B, M] int32: (start << 16) | end, halves the
        m_bwt: jax.Array     # per-iteration read+write traffic of the buffers
        m_size: jax.Array
        cnt: jax.Array
        it: jax.Array
        steps: jax.Array     # [] total active-lane extensions (stats)

    z = jnp.zeros(B, pd)
    zM = jnp.zeros((B, M), pd)
    st = S(phase=jnp.zeros(B, jnp.int32), x=z, j=z, k=z, kp=z, s=z,
           k2=z, kp2=z, s2=z, m_se=jnp.zeros((B, M), jnp.int32),
           m_bwt=zM, m_size=zM,
           cnt=jnp.zeros(B, jnp.int32), it=jnp.zeros((), jnp.int32),
           steps=jnp.zeros((), jnp.int32))

    max_iters = 4 * (L + 1) * (L + 1) + 64

    def cond(st: S):
        return (st.phase != 4).any() & (st.it < max_iters)

    def body(st: S) -> S:
        phase, x, j = st.phase, st.x, st.j
        k, kp, s = st.k, st.kp, st.s
        k2, kp2, s2 = st.k2, st.kp2, st.s2

        # --- phase 0: begin a new find_mems_function call at x ---
        p0 = phase == 0
        finished = p0 & ((x >= lengths) | (lengths - x < min_len))
        enter1 = p0 & ~finished
        enter3 = phase == 5          # emitted last iteration; step 3 starts now
        phase = jnp.where(finished, 4, jnp.where(enter1, 1, phase))
        phase = jnp.where(enter3, 3, phase)
        j = jnp.where(enter1, x + min_len - 1, j)
        k = jnp.where(enter1, 0, k)
        kp = jnp.where(enter1, 0, kp)
        s = jnp.where(enter1, N, s)
        if seed_k is not None:
            # ONE shared m-mer seed block for both entry points (a lane is
            # never enter1 and enter3 in the same iteration): step 1 seeds
            # with the window ending at x+min_len-1, step 3 with the window
            # ending at e (carried in j). Exact: interval sizes are
            # non-increasing, so a passing seed implies every skipped check
            # passed; a failing seed falls back to stepwise extension.
            widx = jnp.where(enter1, x + min_len - 1, j)
            oh_w = iotaL == jnp.clip(widx, 0, L).astype(jnp.int32)[:, None]
            row_s = jnp.where(oh_w, seed_s, 0).sum(axis=1)
            if seed_len is None:
                # dense tier only: static seed length (the round-4 program)
                can1 = (enter1 & (min_len > mer_m)
                        & (row_s >= min_occ) & (row_s > 0))
                can3 = (enter3 & (j - mer_m > x)
                        & (row_s >= min_occ) & (row_s > 0))
                j_seed1, j_seed3 = x + min_len - 1 - mer_m, j - mer_m
            else:
                # cascaded tiers: per-position seed length (one extra int8
                # one-hot read per iteration - see ops/sparsedict.py)
                row_len = jnp.where(oh_w, seed_len, 0).sum(axis=1).astype(pd)
                okrow = (row_s >= min_occ) & (row_s > 0) & (row_len > 0)
                can1 = enter1 & (min_len > row_len) & okrow
                can3 = enter3 & (j - row_len > x) & okrow
                j_seed1, j_seed3 = x + min_len - 1 - row_len, j - row_len
            can = can1 | can3
            j = jnp.where(can1, j_seed1, jnp.where(can3, j_seed3, j))
            k = jnp.where(can, jnp.where(oh_w, seed_k, 0).sum(axis=1), k)
            kp = jnp.where(can, jnp.where(oh_w, seed_kp, 0).sum(axis=1), kp)
            s = jnp.where(can, row_s, s)

        # --- one extension step for all active lanes ---
        p1, p2, p3 = phase == 1, phase == 2, phase == 3
        act = p1 | p2 | p3
        jc = jnp.clip(j, 0, L).astype(jnp.int32)
        c = take_local(codes, jc)
        nk, nkp, ns = extend(t, k, kp, s, c, forward=p2, rank6_fn=rank6_fn,
                             pair=pair_rank)
        fail = act & ((ns < min_occ) | (ns <= 0))

        # --- transitions ---
        p1_fail = p1 & fail
        p1_ok = p1 & ~fail
        p1_boundary = p1_ok & ((j == x) | (j == 0))
        p1_cont = p1_ok & ~p1_boundary
        e1 = x + min_len
        p1_to3 = p1_boundary & (e1 >= lengths)   # step 2 loop never runs
        p1_to2 = p1_boundary & ~(e1 >= lengths)

        p2_fail = p2 & fail
        p2_ok = p2 & ~fail
        p2_to3 = p2_ok & (j + 1 >= lengths)      # reached read end
        p2_cont = p2_ok & ~p2_to3

        p3_fail = p3 & fail
        p3_ok = p3 & ~fail
        p3_done = p3_ok & (j - 1 == x)
        p3_cont = p3_ok & ~p3_done

        # bint2 bookkeeping: set after a successful step-1 completion or any
        # successful step-2 extension (algorithm.hpp:684-699)
        upd2 = p1_boundary | p2_ok
        k2 = jnp.where(upd2, nk, k2)
        kp2 = jnp.where(upd2, nkp, kp2)
        s2 = jnp.where(upd2, ns, s2)

        # emits (entering step 3)
        emit = p1_to3 | p2_fail | p2_to3
        e_val = jnp.where(p1_to3, e1, jnp.where(p2_fail, j, lengths))

        # MEM emission as a one-hot ADD, not a scatter: each (lane, col) slot
        # is written at most once (cnt strictly increments on emit), buffers
        # start at zero, and overflow columns mask to nothing - so += of a
        # one-hot outer product is exact and keeps the loop free of scatter
        # rows (the loop is gather/scatter row-issue-rate bound).
        oh_col = (jnp.arange(M, dtype=jnp.int32)[None, :] == st.cnt[:, None]) \
            & emit[:, None]                                       # [B, M]

        def put(buf, val):
            return buf + jnp.where(oh_col, val[:, None], 0)

        se = (x.astype(jnp.int32) << 16) | e_val.astype(jnp.int32)
        m_se = put(st.m_se, se)
        m_bwt = put(st.m_bwt, k2.astype(pd))
        m_size = put(st.m_size, s2.astype(pd))
        cnt = st.cnt + emit.astype(jnp.int32)

        # new x / phase
        x = jnp.where(p1_fail | p3_fail, j + 1, jnp.where(p3_done, x + 1, x))
        phase = jnp.where(p1_fail | p3_fail | p3_done, 0, phase)
        phase = jnp.where(p1_to2, 2, phase)
        phase = jnp.where(emit, 5, phase)    # seed + enter step 3 next iter

        # new j
        j = jnp.where(p1_cont | p3_cont, j - 1, j)
        j = jnp.where(p1_to2 | p1_to3, e1, j)
        j = jnp.where(p2_cont, j + 1, j)
        j = jnp.where(p2_to3, lengths, j)
        # p2_fail: j stays (= e)

        # new interval registers
        keep_new = p1_cont | p1_to2 | p2_cont | p3_cont
        k = jnp.where(keep_new, nk, k)
        kp = jnp.where(keep_new, nkp, kp)
        s = jnp.where(keep_new, ns, s)
        restart3 = emit  # step 3 starts from the full interval (and is seeded
        k = jnp.where(restart3, 0, k)        # by the shared block next iter)
        kp = jnp.where(restart3, 0, kp)
        s = jnp.where(restart3, N, s)

        steps = st.steps + (act.sum() if with_stats else 0)
        return S(phase, x, j, k, kp, s, k2, kp2, s2,
                 m_se, m_bwt, m_size, cnt, st.it + 1, steps)

    if cond_every > 1:
        # check the all-lanes-done reduction every K iterations: the body is
        # a no-op for finished lanes (act/emit all false), so up to K-1
        # wasted trailing iterations buy K-1 skipped cond computations
        # (counts identical; `it` in with_stats may overshoot by <K)
        block = lambda st: jax.lax.fori_loop(0, cond_every,
                                             lambda i, s: body(s), st)
        st = jax.lax.while_loop(cond, block, st)
    else:
        st = jax.lax.while_loop(cond, body, st)
    res = MemResult((st.m_se >> 16).astype(pd), (st.m_se & 0xFFFF).astype(pd),
                    st.m_bwt, st.m_size, st.cnt, st.cnt > M)
    if with_stats:
        return res, {"steps": st.steps, "iters": st.it}
    return res


find_mems_batch = functools.partial(
    jax.jit, static_argnames=("capacity", "mer_m", "with_stats",
                              "cond_every", "pair_rank",
                              "sdict_m"))(find_mems_impl)
