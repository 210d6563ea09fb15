"""Device engine vs host model: lane-for-lane equality of rank/LF/count/FMD/
MEM/tag-query on the bidirectional fixture (runs on the CPU backend with a
virtual 8-device mesh; the same code path runs on the GPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pangenome_index_tpu.formats import tags as tagfmt
from pangenome_index_tpu.formats.rlbwt import read_rlbwt
from pangenome_index_tpu.models.mems import find_all_mems
from pangenome_index_tpu.models.rindex import build_rindex
from pangenome_index_tpu.ops import fmd, rank
from pangenome_index_tpu.ops.mems import find_mems_batch
from pangenome_index_tpu.ops.tables import rindex_to_device, tags_to_device
from pangenome_index_tpu.ops.tagquery import query_tags_batch
from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE


@pytest.fixture(scope="module")
def setup(ref_data):
    idx = build_rindex(read_rlbwt(ref_data / "bidirectional_test/contigs_xy.rl_bwt"))
    t = rindex_to_device(idx)
    with open(ref_data / "bidirectional_test/contigs_xy", "rb") as fh:
        lines = [l for l in fh.read().split(b"\n") if l]
    return idx, t, lines


@pytest.mark.parametrize("mode", [{}, {"dense": True}, {"ultra": True},
                                  {"bucketed": False}, {"checkpoint": True}])
def test_rank_matches_host(setup, mode):
    idx, _, _ = setup
    t = rindex_to_device(idx, **mode)
    rng = np.random.default_rng(0)
    pos = rng.integers(0, idx.n + 1, size=256)
    host = np.stack([idx.rank6(int(p)) for p in pos])
    dev = np.asarray(rank.rank6(t, jnp.asarray(pos, t.pos_dtype)))
    np.testing.assert_array_equal(dev, host)


@pytest.mark.parametrize("mode", [{"dense": True}, {"ultra": True},
                                  {"checkpoint": True}])
def test_mems_fast_modes_match(setup, mode):
    idx, t_ref, lines = setup
    t = rindex_to_device(idx, **mode)
    rng = np.random.default_rng(17)
    reads = _make_reads(lines, rng, 12, length=40)
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    ref = find_mems_batch(t_ref, jnp.asarray(codes), jnp.asarray(lens), 10, 1, capacity=16)
    res = find_mems_batch(t, jnp.asarray(codes), jnp.asarray(lens), 10, 1, capacity=16)
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_count_matches_host(setup):
    idx, t, lines = setup
    rng = np.random.default_rng(1)
    pats = []
    for _ in range(64):
        line = lines[int(rng.integers(len(lines)))]
        a = int(rng.integers(0, len(line) - 15))
        pats.append(line[a : a + int(rng.integers(3, 15))])
    L = max(len(p) for p in pats)
    codes = np.zeros((len(pats), L), np.int32)
    lens = np.array([len(p) for p in pats], np.int32)
    for i, p in enumerate(pats):
        codes[i, : len(p)] = BYTE_TO_CODE[np.frombuffer(p, np.uint8)]
    f, s = rank.count(t, jnp.asarray(codes), jnp.asarray(lens))
    for i, p in enumerate(pats):
        hf, hs = idx.count(p)
        assert (int(f[i]), int(s[i])) == (hf, hs)


def test_extend_matches_host(setup):
    idx, t, lines = setup
    rng = np.random.default_rng(2)
    B = 128
    # random intervals built from short backward searches + random next codes
    k = np.zeros(B, np.int64)
    kp = np.zeros(B, np.int64)
    s = np.full(B, idx.n, np.int64)
    for step in range(6):
        c = rng.integers(1, 6, size=B)
        fwd = rng.integers(0, 2, size=B).astype(bool)
        host = np.array([
            (idx.forward_extend((k[i], kp[i], s[i]), int(c[i])) if fwd[i]
             else idx.backward_extend((k[i], kp[i], s[i]), int(c[i])))
            for i in range(B)
        ])
        dk, dkp, ds = fmd.extend(
            t, jnp.asarray(k, t.pos_dtype), jnp.asarray(kp, t.pos_dtype),
            jnp.asarray(s, t.pos_dtype), jnp.asarray(c, jnp.int32),
            forward=jnp.asarray(fwd),
        )
        np.testing.assert_array_equal(np.asarray(dk), host[:, 0])
        np.testing.assert_array_equal(np.asarray(dkp), host[:, 1])
        np.testing.assert_array_equal(np.asarray(ds), host[:, 2])
        # keep non-empty lanes going, reset empty ones
        k, kp, s = host[:, 0], host[:, 1], host[:, 2]
        empty = s == 0
        k[empty], kp[empty], s[empty] = 0, 0, idx.n


def _make_reads(lines, rng, n_reads, length=60):
    reads = []
    for _ in range(n_reads):
        l1 = lines[int(rng.integers(len(lines)))]
        l2 = lines[int(rng.integers(len(lines)))]
        a = int(rng.integers(0, len(l1) - length // 2))
        b = int(rng.integers(0, len(l2) - length // 2))
        reads.append(l1[a : a + length // 2] + l2[b : b + length // 2])
    return reads


def test_mems_batch_matches_host(setup, ref_data):
    idx, t, lines = setup
    rng = np.random.default_rng(3)
    reads = _make_reads(lines, rng, 24)
    reads += [l for l in (ref_data / "bidirectional_test/reads.txt").read_bytes().split(b"\n") if l]
    L = max(len(r) for r in reads)
    B = len(reads)
    codes = np.zeros((B, L), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    for min_len, min_occ in [(5, 1), (10, 1), (10, 2)]:
        res = find_mems_batch(t, jnp.asarray(codes), jnp.asarray(lens), min_len, min_occ)
        for i, r in enumerate(reads):
            host = find_all_mems(idx, r, min_len, min_occ)
            cnt = int(res.count[i])
            assert cnt == len(host), (i, r, cnt, len(host))
            for m in range(cnt):
                hm = host[m]
                got = (int(res.start[i, m]), int(res.end[i, m]),
                       int(res.bwt_start[i, m]), int(res.size[i, m]))
                assert got == (hm.start, hm.end, hm.bwt_start, hm.size)


def test_tag_query_batch_matches_host(setup, ref_data):
    _, _, _ = setup
    tags = tagfmt.load_tags_file(ref_data / "bidirectional_test/xy_bidirectional_compressed.tags")
    tt = tags_to_device(tags)
    rng = np.random.default_rng(4)
    starts = rng.integers(0, tags.total - 60, size=128)
    ends = starts + rng.integers(0, 60, size=128)
    res = query_tags_batch(tt, jnp.asarray(starts, tt.bwt_start.dtype),
                           jnp.asarray(ends, tt.bwt_start.dtype))
    for i in range(len(starts)):
        vals, nruns = tags.query(int(starts[i]), int(ends[i]))
        assert int(res.n_runs[i]) == nruns
        assert not bool(res.overflow[i])
        got = np.asarray(res.positions[i][: int(res.n_unique[i])])
        np.testing.assert_array_equal(got, vals)


def test_locate_next_batch(setup):
    idx, t, _ = setup
    sa = idx.decompress_sa()
    prev = jnp.asarray(sa[:-1], t.pos_dtype)
    nxt = np.asarray(rank.locate_next(t, prev))
    np.testing.assert_array_equal(nxt, sa[1:])


def test_checkpoint_128_block_rank_equality():
    """128-code checkpoint rows (0.75 B/pos) match the 64-code rows and the
    host rank for all 6 symbols."""
    import numpy as np

    from pangenome_index_tpu.ops import rank as rankops
    from pangenome_index_tpu.ops.tables import rindex_to_device
    from pangenome_index_tpu.utils.synth import build_synth_index

    idx, _ = build_synth_index(20_000, 4, seed=2)
    t128 = rindex_to_device(idx, checkpoint=True, ckpt_block=128)
    pos = np.random.default_rng(0).integers(0, idx.n + 1, 2048)
    got = np.asarray(rankops.rank6(t128, pos))
    want = np.stack([idx.rank(pos, c) for c in range(6)], axis=1)
    assert np.array_equal(got, want)


def test_ckpt_rows_chunked_equals_oneshot(setup):
    """The memory-bounded chunked checkpoint-table builder produces the same
    rows regardless of chunk size (round-3: bounded build temporaries)."""
    from pangenome_index_tpu.ops.tables import build_ckpt_rows
    idx, _, _ = setup
    for blk in (64, 128):
        one, _ = build_ckpt_rows(idx, ckpt_block=blk, chunk=1 << 30)
        for chunk in (blk, 5 * blk, 1 << 12):
            np.testing.assert_array_equal(
                build_ckpt_rows(idx, ckpt_block=blk, chunk=chunk)[0], one)


def test_two_level_ckpt_rows_reconstruct_single_level(setup):
    """Two-level rows (superblock-relative occ + ckpt_super bases) must
    reconstruct the absolute single-level rows exactly (the n >= 2^31
    layout, exercised here with a small forced super_shift)."""
    from pangenome_index_tpu.ops.tables import build_ckpt_rows
    idx, _, _ = setup
    single, none = build_ckpt_rows(idx, ckpt_block=64)
    assert none is None
    for ss in (8, 10, 13):
        rows, sup = build_ckpt_rows(idx, ckpt_block=64, super_shift=ss)
        assert sup is not None and sup.shape[1] == 6 + ss
        # payload words identical
        np.testing.assert_array_equal(rows[:, 6:], single[:, 6:])
        sb = (np.arange(rows.shape[0], dtype=np.int64) << 6) >> ss
        np.testing.assert_array_equal(rows[:, :6] + sup[sb, :6], single[:, :6])
        # chunked build equality in two-level form too
        rows2, sup2 = build_ckpt_rows(idx, ckpt_block=64, super_shift=ss,
                                      chunk=1 << 9)
        np.testing.assert_array_equal(rows2, rows)
        np.testing.assert_array_equal(sup2, sup)


def test_two_level_ckpt_rank_and_mems_match(setup):
    """rank6 and the full MEM engine through the two-level checkpoint tables
    equal the single-level/host results."""
    idx, t_ref, lines = setup
    t2 = rindex_to_device(idx, checkpoint=True, super_shift=9)
    assert t2.ckpt_super is not None
    rng = np.random.default_rng(3)
    pos = rng.integers(0, idx.n + 1, size=256)
    host = np.stack([idx.rank6(int(p)) for p in pos])
    dev = np.asarray(rank.rank6(t2, jnp.asarray(pos, t2.pos_dtype)))
    np.testing.assert_array_equal(dev, host)
    reads = _make_reads(lines, rng, 12, length=40)
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    ref = find_mems_batch(t_ref, jnp.asarray(codes), jnp.asarray(lens), 10, 1, capacity=16)
    res = find_mems_batch(t2, jnp.asarray(codes), jnp.asarray(lens), 10, 1, capacity=16)
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_mem_only_tables_match(setup):
    """mem_only checkpoint tables (per-run/locate stubs) must serve MEM
    finding identically - they ship only ckpt(+super), C and n."""
    idx, t_ref, lines = setup
    t = rindex_to_device(idx, checkpoint=True, mem_only=True)
    assert t.run_start.shape[0] == 1 and t.samples.shape[0] == 1
    rng = np.random.default_rng(31)
    reads = _make_reads(lines, rng, 12, length=40)
    L = max(len(r) for r in reads)
    codes = np.zeros((len(reads), L), np.int32)
    lens = np.array([len(r) for r in reads], np.int32)
    for i, r in enumerate(reads):
        codes[i, : len(r)] = BYTE_TO_CODE[np.frombuffer(r, np.uint8)]
    ref = find_mems_batch(t_ref, jnp.asarray(codes), jnp.asarray(lens), 10, 1, capacity=16)
    res = find_mems_batch(t, jnp.asarray(codes), jnp.asarray(lens), 10, 1, capacity=16)
    for a, b in zip(res, ref):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
