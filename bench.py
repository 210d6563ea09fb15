"""Benchmark: MEM-finding throughput (reads/s) of the device engine on a GPU.

Workload: a synthetic pangenome of 8 haplotypes over a 2.5 Mbp backbone
(20 Mbp of text), 16,384 reads of 150 bp with 1% errors, min_len=20,
min_occ=1 - the find_mems serving path (reference: src/find_mems.cpp) with
the m=14 dense seed table and the s=19 long-seed dictionary. It reports
reads/s for MEM finding alone and for both serving halves (MEM finding +
one tag lookup per buffered MEM). The native C++ engine (src/cpp) serves a
read subset on one thread as the baseline, and its MEM counts and per-MEM
tag counts must equal the device's.

Runs in one process on the first GPU and exits non-zero without one. The
JSON line it prints last is the result; it names the device and the card's
power limit. The synthetic index and tag array are cached under
.bench_cache/.

    python bench.py
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np

BASE_LEN = 2_500_000
SEED = 3
N_HAPS = 8
N_READS = 16384
READ_LEN = 150
MIN_LEN = 20
MIN_OCC = 1
MER_M = 14
LONG_SEED = MIN_LEN - 1
# MEM buffer capacity for BOTH engines: counts stay exact past the capacity
# on both engines (device: ops/mems.py emission masks out, count is
# unconditional; native: panindex_native.cpp:126-129) and overflow is
# flagged for a refind - the bounded-capacity serving contract
MEM_CAP = 8
#: engine kwargs sliced per read chunk (everything else is whole-table)
PER_READ_KEYS = ("mer_keys", "mer_valid", "sdict_idx")


def log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def encode_reads(reads, n_reads, read_len):
    from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE

    codes = np.zeros((n_reads, read_len), np.int32)
    for i, r in enumerate(reads):
        codes[i, :] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    return codes, np.full(n_reads, read_len, np.int32)


def serve_measure(idx, codes, lens, min_len=MIN_LEN, min_occ=MIN_OCC,
                  mer_m=MER_M, sdict_s=0, sdict_path=None, tag_tables=None,
                  tag_capacity=8, chunk=None, iters=3, measure_ext=False):
    """Device serving measurement on the serving device: checkpoint-rank
    tables, the m-mer seed table built on the device, the s-window long-seed
    dictionary (loaded from `sdict_path` when it holds the artifact, else
    built on the device), work-sorted chunking. Every timed window ends in
    block_until_ready.

    tag_tables (a host TagArray): additionally measure both serving halves -
    MEM finding + per-buffered-MEM tag lookups (find_mems.cpp:96-146) -
    with per-MEM unique counts (tag_nu/tag_ov) for cross-checks.

    chunk=None races 4096 against 8192 lanes per launch on the first reads
    and keeps the faster, as `find-mems` does.

    Returns a dict: device_rps, tags_rps, per-read MEM counts, compile and
    set-up seconds, peak device bytes, and (measure_ext) the LF-step rate."""
    import jax
    import jax.numpy as jnp

    from pangenome_index_tpu.device import serving_device
    from pangenome_index_tpu.ops.mems import find_mems_batch
    from pangenome_index_tpu.ops.mertable import (build_mer_table_device,
                                                  read_mer_keys_fast,
                                                  seed_difficulty)
    from pangenome_index_tpu.ops.sparsedict import (get_sparse_dict,
                                                    read_windows_fast)
    from pangenome_index_tpu.ops.tables import rindex_to_device

    dev = serving_device()
    n_reads = len(codes)
    t0 = time.perf_counter()
    t = jax.block_until_ready(rindex_to_device(idx, checkpoint=True))
    mer_kw = {}
    order = np.arange(n_reads)
    if mer_m:
        mer_table = jax.block_until_ready(build_mer_table_device(t, mer_m))
        mk, mv = read_mer_keys_fast(codes, lens, mer_m)
        # work-sorted chunking: order reads by the seed-table difficulty
        # proxy so each lockstep chunk is work-homogeneous (results are
        # inverse-permuted back)
        proxy = np.asarray(seed_difficulty(mer_table, jnp.asarray(mk),
                                           jnp.asarray(mv), min_occ,
                                           lengths=jnp.asarray(lens), m=mer_m))
        order = np.argsort(proxy, kind="stable")
        mer_kw = dict(mer_table=mer_table, mer_keys=jnp.asarray(mk[order]),
                      mer_valid=jnp.asarray(mv[order]), mer_m=mer_m)
    if sdict_s:
        keys_sd, vals_sd = get_sparse_dict(idx, sdict_s, path=sdict_path,
                                           tables=t)
        _, rv, di = read_windows_fast(codes, lens, sdict_s, keys_sd)
        log(f"long-seed dict s={sdict_s}: {len(keys_sd)} entries, window "
            f"hit rate {(di >= 0).sum() / max(rv.sum(), 1):.1%}")
        mer_kw.update(sdict_vals=jnp.asarray(vals_sd),
                      sdict_idx=jnp.asarray(di[order]), sdict_m=sdict_s)
    codes_d = jnp.asarray(codes[order])
    lens_d = jnp.asarray(lens[order])
    jax.block_until_ready((codes_d, mer_kw))
    setup_s = time.perf_counter() - t0
    log(f"tables, seed table m={mer_m} and dictionary ready in {setup_s:.1f}s")

    def dispatch(lo, hi, tt=None):
        kw = {k: (v[lo:hi] if k in PER_READ_KEYS else v)
              for k, v in mer_kw.items()}
        res = find_mems_batch(t, codes_d[lo:hi], lens_d[lo:hi], min_len,
                              min_occ, capacity=MEM_CAP, **kw)
        if tt is None:
            return (res.count,)
        from pangenome_index_tpu.ops.tagquery import query_mem_tags

        return (res.count, *query_mem_tags(tt, res.bwt_start, res.size,
                                           res.count, capacity=tag_capacity))

    def run_all(c, tt=None):
        # every chunk is dispatched before the one sync: chunks queue
        # back-to-back on the device
        pending = [dispatch(s, s + c, tt) for s in range(0, n_reads, c)]
        return jax.block_until_ready(pending)

    def unsort(pending, i):
        a = np.concatenate([np.asarray(p[i]) for p in pending])
        out = np.empty_like(a)
        out[order] = a
        return out

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        return out, time.perf_counter() - t0

    compile_s = 0.0
    if chunk is None:
        best_dt = None
        for cand in (4096, 8192):
            sub = min(cand, n_reads)
            compile_s += timed(lambda: jax.block_until_ready(
                dispatch(0, sub)))[1]
            dt = timed(lambda: jax.block_until_ready(dispatch(0, sub)))[1] / sub
            log(f"chunk={cand}: {1 / dt:.0f} reads/s on {sub} reads")
            if best_dt is None or dt < best_dt:
                chunk, best_dt = cand, dt
    pending, dt = timed(lambda: run_all(chunk))
    compile_s += dt
    counts = unsort(pending, 0)
    log(f"compile + first run: {dt:.1f}s, {int(counts.sum())} MEMs")
    dts = [timed(lambda: run_all(chunk))[1] for _ in range(iters)]
    device_rps = n_reads * iters / sum(dts)
    log(f"MEMs only: {1e3 * sum(dts) / iters:.1f} ms/batch -> "
        f"{device_rps:.0f} reads/s")
    out = dict(device_rps=device_rps, counts=counts, mer_m=mer_m,
               sdict_s=sdict_s, chunk=chunk, setup_s=setup_s,
               tags_rps=None, tag_nu=None, tag_ov=None, tag_ov_frac=0.0)
    if tag_tables is not None:
        from pangenome_index_tpu.ops.tables import tags_to_device

        tt = tags_to_device(tag_tables)
        pending, dt = timed(lambda: run_all(chunk, tt))
        compile_s += dt
        dts = [timed(lambda: run_all(chunk, tt))[1] for _ in range(iters)]
        cs, nus, ovs = (unsort(pending, i) for i in range(3))
        tags_rps = n_reads * iters / sum(dts)
        n_buffered = int(np.minimum(cs, MEM_CAP).sum())
        out.update(tags_rps=tags_rps, tag_nu=nus, tag_ov=ovs,
                   tag_ov_frac=float(ovs.sum() / max(n_buffered, 1)))
        log(f"MEMs + tags: {1e3 * sum(dts) / iters:.1f} ms/batch -> "
            f"{tags_rps:.0f} reads/s ({n_buffered} tag queries, overflow "
            f"{out['tag_ov_frac']:.2%})")
    if measure_ext:
        out["ext_rate"] = measure_ext_rate(t, idx.n)
        log(f"LF/extension steps: {out['ext_rate'] / 1e6:.1f} M/s "
            f"(each = 2 six-symbol rank queries)")
    out["compile_s"] = compile_s
    stats = dev.memory_stats() or {}
    out["peak_bytes_in_use"] = stats.get("peak_bytes_in_use")
    return out


def measure_ext_rate(t, n, lanes=4096):
    """LF-steps/s of the plain checkpoint gather (the BASELINE.json
    inner-loop metric): a fixed-iteration extension loop with every lane
    always active, timed as the difference of 1100 and 100 iterations."""
    import jax
    import jax.numpy as jnp

    from pangenome_index_tpu.ops import fmd

    @jax.jit
    def ext_loop(t, k, kp, s, c, iters):
        def body(i, st):
            k, kp, s = st
            nk, nkp, ns = fmd.extend(t, k, kp, s, (c + i) % 5 + 1)
            empty = ns <= 0
            return (jnp.where(empty, 0, nk), jnp.where(empty, 0, nkp),
                    jnp.where(empty, t.n, ns))
        k, kp, s = jax.lax.fori_loop(0, iters, body, (k, kp, s))
        return k.sum() + kp.sum() + s.sum()

    kz = jnp.zeros(lanes, t.run_start.dtype)
    sz = jnp.full(lanes, n, t.run_start.dtype)
    cz = jnp.zeros(lanes, jnp.int32)

    def run(iters):
        t0 = time.perf_counter()
        jax.block_until_ready(ext_loop(t, kz, kz, sz, cz, iters))
        return time.perf_counter() - t0

    run(100)  # compile
    return lanes * 1000 / (run(1100) - run(100))


def native_baseline(idx, codes, lens, counts=None, n_threads=1, nb=256,
                    min_len=MIN_LEN, min_occ=MIN_OCC, tags=None, tag_dev=None):
    """Native C++ engine on the first `nb` reads: returns (mem_rps,
    combined_rps) - combined_rps also runs the tag half over every buffered
    MEM, the loop the device's both-halves number runs (find_mems.cpp:96-146;
    None without `tags`). Raises when the device's per-read MEM counts
    (`counts`) or per-MEM unique tag counts (`tag_dev` = (tag_nu, tag_ov))
    differ from the native engine's."""
    from pangenome_index_tpu import native

    nb = min(len(codes), nb)
    t0 = time.perf_counter()
    s, e, b, z, cnt = native.find_mems_native(
        idx, codes[:nb], lens[:nb], min_len, min_occ, capacity=MEM_CAP,
        n_threads=n_threads)
    host_dt = time.perf_counter() - t0
    log(f"native {n_threads}-thread: {nb / host_dt:.1f} reads/s "
        f"({int(cnt.sum())} MEMs on {nb} reads)")
    if counts is not None and not np.array_equal(cnt, counts[:nb]):
        raise RuntimeError("native and device MEM counts differ")
    if tags is None:
        return nb / host_dt, None
    # tag half: one query per buffered MEM, flattened (find_mems.cpp:129)
    eff = np.minimum(cnt, s.shape[1]).astype(np.int64)
    ii = np.repeat(np.arange(nb), eff)
    within = np.arange(len(ii)) - np.repeat(np.cumsum(eff) - eff, eff)
    t0 = time.perf_counter()
    qs = b[ii, within]
    tpos, tuniq, truns = native.query_tags_native(
        tags, qs, qs + z[ii, within] - 1, capacity=256, n_threads=n_threads)
    tag_dt = time.perf_counter() - t0
    if tag_dev is not None:
        nu_d, ov_d = tag_dev
        ok = ~ov_d[ii, within]  # device counts are capacity-partial on overflow
        if not np.array_equal(tuniq[ok], nu_d[ii, within][ok]):
            raise RuntimeError("native and device tag unique counts differ")
        log(f"tag unique counts equal on {int(ok.sum())} MEMs")
    return nb / host_dt, nb / (host_dt + tag_dt)


def main():
    from pangenome_index_tpu.device import (device_record, serving_device,
                                            setup_compile_cache)
    from pangenome_index_tpu.ops.sparsedict import sparse_dict_key
    from pangenome_index_tpu.utils.synth import (build_synth_index,
                                                 synth_reads, synth_tag_array)

    dev = serving_device()
    if dev.platform != "gpu":
        log(f"no GPU (serving device: {dev}); nothing measured")
        return 1
    setup_compile_cache()
    cache = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         ".bench_cache")
    t0 = time.perf_counter()
    idx, lines = build_synth_index(BASE_LEN, N_HAPS, snp_rate=0.002,
                                   seed=SEED, cache_dir=cache)
    tags = synth_tag_array(idx, lines=lines, cache_dir=cache)
    log(f"index: n={idx.n} runs={idx.n_runs}, tag array {tags.n_runs} runs "
        f"({time.perf_counter() - t0:.1f}s)")
    reads = synth_reads(lines, N_READS, READ_LEN, error_rate=0.01, seed=1)
    codes, lens = encode_reads(reads, N_READS, READ_LEN)

    host_rps, host_comb = native_baseline(idx, codes, lens, tags=tags)
    sd_path = os.path.join(cache, f"sdict_{sparse_dict_key(idx, LONG_SEED)}.npz")
    m = serve_measure(idx, codes, lens, mer_m=MER_M, sdict_s=LONG_SEED,
                      sdict_path=sd_path, tag_tables=tags, measure_ext=True)
    native_baseline(idx, codes, lens, m["counts"], tags=tags,
                    tag_dev=(m["tag_nu"], m["tag_ov"]))
    print(json.dumps({
        "metric": "mem_find_reads_per_s",
        "value": m["device_rps"],
        "unit": (f"reads/s (150bp, min_len {MIN_LEN}, min_occ {MIN_OCC}, "
                 f"{idx.n // 1_000_000} Mbp synthetic pangenome)"),
        "with_tags_reads_per_s": m["tags_rps"],
        "vs_baseline": m["device_rps"] / host_rps,
        "with_tags_vs_baseline": m["tags_rps"] / host_comb,
        "vs_baseline_meaning": ("1 GPU vs 1 native-engine CPU thread "
                                "(src/cpp, same algorithm and data)"),
        "tag_overflow_frac": m["tag_ov_frac"],
        "seed_m": m["mer_m"], "long_seed_s": m["sdict_s"],
        "lanes_per_launch": m["chunk"],
        "lf_steps_per_s": m["ext_rate"],
        "compile_s": m["compile_s"], "setup_s": m["setup_s"],
        "peak_bytes_in_use": m["peak_bytes_in_use"],
        "device": device_record(dev),
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
