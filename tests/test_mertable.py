"""m-mer seed table: seeded MEM engine must be exactly equal to unseeded."""

import jax.numpy as jnp
import numpy as np
import pytest

from pangenome_index_tpu.formats.rlbwt import read_rlbwt
from pangenome_index_tpu.models.rindex import build_rindex
from pangenome_index_tpu.ops.mems import find_mems_batch
from pangenome_index_tpu.ops.mertable import build_mer_table, read_mer_keys
from pangenome_index_tpu.ops.tables import rindex_to_device
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE


@pytest.mark.parametrize("m", [4, 6, 8])
def test_seeded_equals_unseeded(ref_data, m):
    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    t = rindex_to_device(idx)
    with open(ref_data / "bidirectional_test/contigs_xy", "rb") as fh:
        lines = [l for l in fh.read().split(b"\n") if l]
    rng = np.random.default_rng(13)
    N, L = 32, 60
    reads = []
    for _ in range(N):
        l1 = lines[int(rng.integers(len(lines)))]
        l2 = lines[int(rng.integers(len(lines)))]
        a = int(rng.integers(0, len(l1) - L // 2))
        b = int(rng.integers(0, len(l2) - L // 2))
        reads.append(l1[a : a + L // 2] + l2[b : b + L // 2])
    codes = np.zeros((N, L), np.int32)
    lens = np.full(N, L, np.int32)
    for i, r in enumerate(reads):
        codes[i, :] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    cd, ln = jnp.asarray(codes), jnp.asarray(lens)
    mt = jnp.asarray(build_mer_table(idx, m), t.pos_dtype)
    mk, mv = read_mer_keys(codes, lens, m)
    for min_len, min_occ in [(10, 1), (12, 2), (m, 1)]:  # m==min_len: no seed path
        ref = find_mems_batch(t, cd, ln, min_len, min_occ, capacity=16)
        res = find_mems_batch(t, cd, ln, min_len, min_occ, capacity=16,
                              mer_table=mt, mer_keys=jnp.asarray(mk),
                              mer_valid=jnp.asarray(mv), mer_m=m)
        for a, b in zip(res, ref):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mer_table_values(ref_data):
    # table entries equal stepwise backward extension of the mer
    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    m = 5
    table = build_mer_table(idx, m)
    from pangenome_index_tpu.ops.mertable import BASE_CODES

    rng = np.random.default_rng(1)
    for _ in range(40):
        key = int(rng.integers(0, 4**m))
        bases = [(key >> (2 * (m - 1 - i))) & 3 for i in range(m)]
        bint = (0, 0, idx.n)
        for b in reversed(bases):
            bint = idx.backward_extend(bint, int(BASE_CODES[b]))
        assert tuple(table[key]) == bint


def test_mer_table_device_equals_host(ref_data):
    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    t = rindex_to_device(idx)
    from pangenome_index_tpu.ops.mertable import build_mer_table_device

    for m in (1, 3, 6):
        host = build_mer_table(idx, m)
        dev = np.asarray(build_mer_table_device(t, m))
        np.testing.assert_array_equal(dev, host.astype(dev.dtype))


def test_seed_difficulty_counts(ref_data):
    # proxy = windows whose m-mer interval fails min_occ, plus invalid windows
    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    m = 4
    table = build_mer_table(idx, m)
    from pangenome_index_tpu.ops.mertable import read_mer_keys, seed_difficulty

    codes = np.array([[1, 2, 3, 5, 1, 2], [1, 1, 4, 1, 1, 1]], np.int32)  # ACGTAC, AANAAA
    lens = np.array([6, 6], np.int32)
    keys, valid = read_mer_keys(codes, lens, m)
    prox = np.asarray(seed_difficulty(table, keys, valid, 1))
    # brute force per window
    for b in range(2):
        exp = 0
        for i in range(codes.shape[1] + 1):
            if not valid[b, i]:
                exp += 1
            elif table[keys[b, i], 2] < 1:
                exp += 1
        assert prox[b] == exp
    # the N-containing read has strictly more invalid windows
    assert prox[1] > prox[0]


def test_seed_difficulty_ignores_padding_windows(ref_data):
    # with lengths/m given, windows past a short read's end do not count:
    # a short clean read must rank easier than an equal-length-prefix read,
    # not harder (the padding windows need zero loop iterations)
    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    m = 4
    table = build_mer_table(idx, m)
    from pangenome_index_tpu.ops.mertable import read_mer_keys, seed_difficulty

    codes = np.array([[1, 2, 3, 5, 1, 2, 3, 5], [1, 2, 3, 5, 0, 0, 0, 0]], np.int32)
    lens = np.array([8, 4], np.int32)
    keys, valid = read_mer_keys(codes, lens, m)
    prox = np.asarray(seed_difficulty(table, keys, valid, 1, lengths=lens, m=m))
    # brute force: only windows ending inside the read count
    for b in range(2):
        exp = 0
        for i in range(m - 1, int(lens[b])):
            if not valid[b, i] or table[keys[b, i], 2] < 1:
                exp += 1
        assert prox[b] == exp
    assert prox[1] <= prox[0]


def test_mer_table_device_hybrid_schedule(ref_data):
    """The phase-2 explicit expansion (levels past fori_base) must produce
    the identical table to the pure-fori schedule and the host build."""
    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    t = rindex_to_device(idx)
    from pangenome_index_tpu.ops.mertable import build_mer_table_device

    for m, base in [(5, 2), (6, 5), (4, 4)]:
        host = build_mer_table(idx, m)
        dev = np.asarray(build_mer_table_device(t, m, fori_base=base))
        np.testing.assert_array_equal(dev, host.astype(dev.dtype))


def test_serve_measure_small_mer_m_attempts_build(ref_data):
    """A small mer_m (1-3) builds its table and serves the same counts as
    the unseeded engine."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent.parent))
    import bench

    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    rng = np.random.default_rng(5)
    codes = rng.integers(1, 6, (32, 40)).astype(np.int32)
    lens = np.full(32, 40, np.int32)
    m = bench.serve_measure(idx, codes, lens, min_len=8, min_occ=1, chunk=32,
                            mer_m=3, iters=1)
    assert m["mer_m"] == 3
    m0 = bench.serve_measure(idx, codes, lens, min_len=8, min_occ=1, chunk=32,
                             mer_m=0, iters=1)
    np.testing.assert_array_equal(m["counts"], m0["counts"])


def test_get_mer_table_cache_roundtrip(tmp_path, ref_data):
    """get_mer_table: build -> persist -> cache hit with matching key."""
    from pangenome_index_tpu.ops.mertable import build_mer_table, get_mer_table

    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    path = str(tmp_path / "seed.npz")
    t1, _ = get_mer_table(idx, 5, path=path)
    np.testing.assert_array_equal(np.asarray(t1, np.int64),
                                  build_mer_table(idx, 5))
    t2, dev2 = get_mer_table(idx, 5, path=path)
    assert dev2 is None  # cache hit: no build
    np.testing.assert_array_equal(np.asarray(t2, np.int64),
                                  np.asarray(t1, np.int64))


def test_serve_measure_sdict_and_tags(ref_data):
    """bench.serve_measure with the long-seed dictionary AND the tag loop:
    counts equal the unseeded engine; per-MEM tag unique counts equal the
    native engine on non-overflow lanes."""
    import sys

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent.parent))
    import bench
    from pangenome_index_tpu import native
    from pangenome_index_tpu.utils.synth import synth_tag_array

    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    with open(ref_data / "bidirectional_test/contigs_xy", "rb") as fh:
        lines = [l for l in fh.read().split(b"\n") if l]
    tags = synth_tag_array(idx, lines=lines, node_len=64)
    rng = np.random.default_rng(9)
    B, L = 48, 40
    codes = np.zeros((B, L), np.int32)
    for i in range(B):
        line = lines[int(rng.integers(len(lines)))]
        a = int(rng.integers(0, len(line) - L))
        codes[i] = BYTE_TO_CODE[np.frombuffer(line[a : a + L], np.uint8)]
    lens = np.full(B, L, np.int32)
    m = bench.serve_measure(idx, codes, lens, min_len=12, min_occ=1, chunk=16,
                            mer_m=5, iters=1, tag_tables=tags, sdict_s=11)
    m0 = bench.serve_measure(idx, codes, lens, min_len=12, min_occ=1, chunk=16,
                             mer_m=0, iters=1)
    np.testing.assert_array_equal(m["counts"], m0["counts"])
    assert m["tags_rps"] is not None and m["tag_nu"] is not None
    if native.available():
        eff = np.minimum(m["counts"], bench.MEM_CAP).astype(np.int64)
        s_, e_, b_, z_, cnt = native.find_mems_native(
            idx, codes, lens, 12, 1, capacity=bench.MEM_CAP)
        ii = np.repeat(np.arange(B), eff)
        w = np.arange(len(ii)) - np.repeat(np.cumsum(eff) - eff, eff)
        qs = b_[ii, w]
        qe = qs + z_[ii, w] - 1
        _, tuniq, _ = native.query_tags_native(tags, qs, qe, capacity=256)
        ok = ~m["tag_ov"][ii, w]
        np.testing.assert_array_equal(tuniq[ok], m["tag_nu"][ii, w][ok])


def test_seed_difficulty_device_table_matches_host(ref_data):
    """seed_difficulty must accept a device (jax) mer table and produce the
    host result - the CLI's work-sorted chunking uses the device table
    directly when a big table skips the npz cache (get_mer_table returns
    table_np=None)."""
    import jax.numpy as jnp

    from pangenome_index_tpu.formats.rlbwt import read_rlbwt
    from pangenome_index_tpu.models.rindex import build_rindex
    from pangenome_index_tpu.ops.mertable import (build_mer_table,
                                                  read_mer_keys,
                                                  seed_difficulty)

    idx = build_rindex(read_rlbwt(
        ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    m = 6
    mt = build_mer_table(idx, m)
    rng = np.random.default_rng(2)
    codes = rng.integers(1, 6, (8, 40)).astype(np.int32)
    lens = rng.integers(10, 41, 8).astype(np.int32)
    mk, mv = read_mer_keys(codes, lens, m)
    host = seed_difficulty(mt, mk, mv, 2, lengths=lens, m=m)
    dev = np.asarray(seed_difficulty(jnp.asarray(mt), mk, mv, 2,
                                     lengths=lens, m=m))
    np.testing.assert_array_equal(np.asarray(host), dev)
