"""Sparse long-seed dictionary: build correctness + engine equality.

The dictionary must hold exactly the occurring length-s substrings with
their exact bi-intervals, and plugging it into the MEM engine (cascaded
with or without the dense tier) must leave every output identical - the
seeds only SKIP extensions that are guaranteed to pass.
"""

import numpy as np
import pytest

from pangenome_index_tpu.formats.rlbwt import read_rlbwt
from pangenome_index_tpu.models.rindex import build_rindex
from pangenome_index_tpu.ops.mertable import (BASE_CODES, build_mer_table,
                                              read_mer_keys)
from pangenome_index_tpu.ops.sparsedict import (build_sparse_dict,
                                                get_sparse_dict,
                                                lookup_read_windows)


@pytest.fixture(scope="module")
def idx(ref_data):
    return build_rindex(read_rlbwt(
        ref_data / "bidirectional_test/contigs_xy.rl_bwt"))


def _key_to_bytes(key: int, s: int) -> bytes:
    return bytes(b"ACGT"[(key >> (2 * (s - 1 - t))) & 3] for t in range(s))


def test_dict_entries_exact_and_complete(idx, ref_data):
    """Every occurring s-mer appears exactly once with its exact interval
    (cross-checked against idx.count) and the dense 4^s table restricted to
    nonempty rows; keys come out sorted with no extra entries."""
    s = 6
    keys, vals = build_sparse_dict(idx, s)
    assert np.all(np.diff(keys) > 0)  # sorted, unique
    dense = build_mer_table(idx, s)  # [4^s, 3] ground truth
    nonempty = np.flatnonzero(dense[:, 2] > 0)
    np.testing.assert_array_equal(keys, nonempty)
    np.testing.assert_array_equal(np.asarray(vals, np.int64), dense[nonempty])
    # spot-check bi-intervals against count() on the decoded strings
    rng = np.random.default_rng(5)
    for d in rng.choice(len(keys), size=20, replace=False):
        first, second = idx.count(_key_to_bytes(int(keys[d]), s))
        assert first == vals[d, 0] and second - first + 1 == vals[d, 2]


def test_dict_min_keep_filters(idx):
    keys1, vals1 = build_sparse_dict(idx, 5, min_keep=1)
    keys3, vals3 = build_sparse_dict(idx, 5, min_keep=3)
    sel = vals1[:, 2] >= 3
    np.testing.assert_array_equal(keys3, keys1[sel])
    np.testing.assert_array_equal(vals3, vals1[sel])


def test_get_sparse_dict_cache_roundtrip(idx, tmp_path):
    p = str(tmp_path / "d.npz")
    k1, v1 = get_sparse_dict(idx, 5, path=p)
    k2, v2 = get_sparse_dict(idx, 5, path=p)
    np.testing.assert_array_equal(k1, k2)
    np.testing.assert_array_equal(v1, v2)


@pytest.mark.parametrize("s,min_keep,host_max", [(6, 1, 4), (11, 1, 64),
                                                 (9, 3, 4), (3, 1, 1 << 14)])
def test_device_build_equals_host(idx, s, min_keep, host_max):
    """The on-device frontier build must reproduce the host build
    elementwise: same sorted keys, same (k, kp, sz) rows - across the
    host->device switch level, min_keep filtering, and the all-host case
    (host_max large enough that no device level runs)."""
    from pangenome_index_tpu.ops.sparsedict import build_sparse_dict_device
    from pangenome_index_tpu.ops.tables import rindex_to_device

    t = rindex_to_device(idx, checkpoint=True)
    ref_keys, ref_vals = build_sparse_dict(idx, s, min_keep=min_keep)
    keys, vals = build_sparse_dict_device(idx, t, s, min_keep=min_keep,
                                          host_levels_max=host_max)
    np.testing.assert_array_equal(keys, ref_keys)
    np.testing.assert_array_equal(vals, ref_vals)
    assert vals.dtype == ref_vals.dtype


def test_device_build_capacity_growth(idx):
    """Starting from a deliberately undersized capacity, overflow detection
    must grow tiers and still produce the exact host result."""
    from pangenome_index_tpu.ops.sparsedict import build_sparse_dict_device
    from pangenome_index_tpu.ops.tables import rindex_to_device

    t = rindex_to_device(idx, checkpoint=True)
    ref_keys, ref_vals = build_sparse_dict(idx, 8)
    keys, vals = build_sparse_dict_device(idx, t, 8, host_levels_max=4,
                                          capacity=64)
    np.testing.assert_array_equal(keys, ref_keys)
    np.testing.assert_array_equal(vals, ref_vals)


def test_device_build_budget_guard(idx, tmp_path, monkeypatch):
    """Past the device-memory budget the device build refuses (MemoryError),
    and get_sparse_dict passes the error on instead of building on the
    host."""
    import pytest as _pytest

    from pangenome_index_tpu.device import MemoryBudget
    from pangenome_index_tpu.ops import sparsedict as sd
    from pangenome_index_tpu.ops.tables import rindex_to_device

    t = rindex_to_device(idx, checkpoint=True)
    monkeypatch.setattr(sd, "memory_budget", lambda: MemoryBudget(16 * 1024))
    with _pytest.raises(MemoryError):
        sd.build_sparse_dict_device(idx, t, 8, host_levels_max=4)
    with _pytest.raises(MemoryError):
        sd.get_sparse_dict(idx, 8, path=str(tmp_path / "g.npz"), tables=t)
    assert not (tmp_path / "g.npz").exists()


def test_get_sparse_dict_device_path(idx, tmp_path):
    """get_sparse_dict(tables=...) routes through the device build and
    produces the same cached artifact as the host path."""
    from pangenome_index_tpu.ops.tables import rindex_to_device

    t = rindex_to_device(idx, checkpoint=True)
    k_host, v_host = get_sparse_dict(idx, 7, path=str(tmp_path / "h.npz"))
    k_dev, v_dev = get_sparse_dict(idx, 7, path=str(tmp_path / "d.npz"),
                                   tables=t)
    np.testing.assert_array_equal(k_dev, k_host)
    np.testing.assert_array_equal(v_dev, v_host)


def test_lookup_read_windows(idx):
    s = 7
    keys, vals = build_sparse_dict(idx, s)
    codes = np.zeros((2, 16), np.int32)
    from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE

    codes[0, :] = BYTE_TO_CODE[np.frombuffer(b"GATTACAGATTACAGT", np.uint8)]
    codes[1, :12] = BYTE_TO_CODE[np.frombuffer(b"TTTTTTTTTTTT", np.uint8)]
    lens = np.array([16, 12], np.int32)
    rk, rv = read_mer_keys(codes, lens, s)
    di = lookup_read_windows(keys, rk, rv)
    assert di.shape == rk.shape and di.dtype == np.int32
    for b in range(2):
        for i in range(17):
            if di[b, i] >= 0:
                assert rv[b, i] and keys[di[b, i]] == rk[b, i]
            elif rv[b, i]:
                assert rk[b, i] not in keys  # genuine miss


def _reads_for(idx, ref_data, n=24, L=40, err=0.08, seed=11):
    from pangenome_index_tpu.utils.alphabet import BYTE_TO_CODE

    text = (ref_data / "bidirectional_test/contigs_xy").read_bytes()
    lines = [l for l in text.split(b"\n") if l]
    rng = np.random.default_rng(seed)
    codes = np.zeros((n, L), np.int32)
    lens = np.full(n, L, np.int32)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    for i in range(n):
        line = lines[int(rng.integers(len(lines)))]
        a = int(rng.integers(0, len(line) - L))
        r = np.frombuffer(line[a : a + L], np.uint8).copy()
        ne = rng.binomial(L, err)
        if ne:
            pos = rng.choice(L, size=ne, replace=False)
            r[pos] = alpha[rng.integers(0, 4, ne)]
        codes[i] = BYTE_TO_CODE[r]
    return codes, lens


@pytest.mark.parametrize("min_len,min_occ,mer_m", [(12, 1, 0), (12, 1, 6),
                                                   (16, 3, 6), (12, 2, 11)])
def test_engine_equality_with_sparse_dict(idx, ref_data, min_len, min_occ,
                                          mer_m):
    """find_mems with the long-seed tier (s = min_len - 1) cascaded over the
    dense tier: every output field equals the unseeded engine, at min_occ
    values that exercise both tier selections and with error reads forcing
    misses. mer_m = 11 makes the long tier only 1 longer than the dense one
    (the boundary case); mer_m = 0 runs the dictionary-only cascade."""
    import jax.numpy as jnp

    from pangenome_index_tpu.ops.mems import find_mems_batch
    from pangenome_index_tpu.ops.tables import rindex_to_device

    t = rindex_to_device(idx, checkpoint=True)
    codes, lens = _reads_for(idx, ref_data)
    base = find_mems_batch(t, jnp.asarray(codes), jnp.asarray(lens),
                           min_len, min_occ, capacity=16)

    s = min_len - 1
    keys, vals = build_sparse_dict(idx, s)
    rk, rv = read_mer_keys(codes, lens, s)
    di = lookup_read_windows(keys, rk, rv)
    kw = dict(sdict_vals=jnp.asarray(vals), sdict_idx=jnp.asarray(di),
              sdict_m=s)
    if mer_m:
        mt = build_mer_table(idx, mer_m)
        mk, mv = read_mer_keys(codes, lens, mer_m)
        kw.update(mer_table=jnp.asarray(mt, t.pos_dtype),
                  mer_keys=jnp.asarray(mk), mer_valid=jnp.asarray(mv),
                  mer_m=mer_m)
    got = find_mems_batch(t, jnp.asarray(codes), jnp.asarray(lens),
                          min_len, min_occ, capacity=16, **kw)
    for a, b in zip(base, got):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_long_seed_actually_fires(idx, ref_data):
    """The cascade must actually take the long tier (iteration count drops
    vs the dense-tier-only engine), not silently fall back."""
    import jax.numpy as jnp

    from pangenome_index_tpu.ops.mems import find_mems_batch
    from pangenome_index_tpu.ops.tables import rindex_to_device

    t = rindex_to_device(idx, checkpoint=True)
    codes, lens = _reads_for(idx, ref_data, err=0.0)
    min_len, min_occ, mer_m, s = 16, 1, 6, 15
    mt = build_mer_table(idx, mer_m)
    mk, mv = read_mer_keys(codes, lens, mer_m)
    mer_kw = dict(mer_table=jnp.asarray(mt, t.pos_dtype),
                  mer_keys=jnp.asarray(mk), mer_valid=jnp.asarray(mv),
                  mer_m=mer_m)
    _, st_dense = find_mems_batch(t, jnp.asarray(codes), jnp.asarray(lens),
                                  min_len, min_occ, capacity=16,
                                  with_stats=True, cond_every=1, **mer_kw)
    keys, vals = build_sparse_dict(idx, s)
    di = lookup_read_windows(keys, *read_mer_keys(codes, lens, s))
    res, st_long = find_mems_batch(t, jnp.asarray(codes), jnp.asarray(lens),
                                   min_len, min_occ, capacity=16,
                                   with_stats=True, cond_every=1,
                                   sdict_vals=jnp.asarray(vals),
                                   sdict_idx=jnp.asarray(di), sdict_m=s,
                                   **mer_kw)
    assert int(st_long["steps"]) < int(st_dense["steps"])
    assert int(res.count.sum()) > 0


def test_device_build_refuses_s31_with_int32_state():
    """The int32 state splits keys into two 30-bit halves: a 31-base window
    cannot be held, and the build says so instead of corrupting keys."""
    from pangenome_index_tpu.ops.sparsedict import build_sparse_dict_device
    from pangenome_index_tpu.ops.tables import rindex_to_device
    from pangenome_index_tpu.utils.synth import build_synth_index

    small, _ = build_synth_index(2000, 2, seed=5)
    t = rindex_to_device(small, checkpoint=True)
    with pytest.raises(ValueError, match="30 bases"):
        build_sparse_dict_device(small, t, 31)


def test_auto_window_stops_at_what_the_device_build_holds():
    """The auto window is min_len - 1, capped at 30 bases on int32 indexes
    (the device build's limit) and 31 on int64 ones; an explicit s=31 still
    reaches the build's ValueError."""
    from types import SimpleNamespace

    from pangenome_index_tpu.ops.sparsedict import MAX_S, MAX_S_INT32, auto_window
    from pangenome_index_tpu.utils.synth import build_synth_index

    small, _ = build_synth_index(2000, 2, seed=5)
    assert auto_window(20, small) == 19
    assert auto_window(31, small) == MAX_S_INT32 == 30
    assert auto_window(40, small) == MAX_S_INT32
    big = SimpleNamespace(n=2**31, n_seq=1, max_len=1, n_runs=1)
    assert auto_window(40, big) == MAX_S == 31
