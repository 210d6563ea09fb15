"""RecordTable (flat decoded GBWT) equality vs the per-record reference
implementations, on GBZ graphs generated from a seed (written and read back
through the GBZ codec) and, where present, the reference's fixtures."""

import numpy as np
import pytest

from pangenome_index_tpu.formats.gbwt_table import RecordTable
from pangenome_index_tpu.formats.gbz import load_gbz
from pangenome_index_tpu import native

#: seeded graphs, then the reference fixtures (skipped when absent)
FIXTURES = ["synth-bubbles", "synth-random", "x.giraffe.gbz",
            "bidirectional_test/xy.gbz"]


def _seeded_gbz(name):
    from pangenome_index_tpu.core.gbwt_build import random_pangenome_gbz
    from pangenome_index_tpu.utils.synth import synth_graph_gbz

    if name == "synth-bubbles":
        return synth_graph_gbz(3000, 4, site_rate=0.01, seed=3,
                               max_node_len=64)[0]
    return random_pangenome_gbz(np.random.default_rng(23), n_nodes=40,
                                n_paths=3)


@pytest.fixture(scope="module", params=FIXTURES)
def gbz(request, tmp_path_factory):
    from conftest import REF_DATA
    from pangenome_index_tpu.formats.gbz_write import save_gbz

    if request.param.startswith("synth-"):
        path = tmp_path_factory.mktemp("gbz") / f"{request.param}.gbz"
        save_gbz(_seeded_gbz(request.param), path)
        return load_gbz(path)
    if not (REF_DATA / request.param).exists():
        pytest.skip("reference test_data not available")
    return load_gbz(REF_DATA / request.param)


def test_native_decode_matches_python_fallback(gbz):
    if not native.available():
        pytest.skip("no native toolchain")
    tn = RecordTable.from_gbwt(gbz.index, use_native=True)
    tf = RecordTable.from_gbwt(gbz.index, use_native=False)
    for f in ("edge_ptr", "edge_node", "edge_off", "run_ptr", "run_rank",
              "run_len", "run_cum", "occ_before"):
        assert np.array_equal(getattr(tn, f), getattr(tf, f)), f


def test_extract_all_matches_record_walk(gbz):
    t = gbz.index.table()
    seqs = np.arange(gbz.index.sequences, dtype=np.int64)
    visits, ptr = t.extract_all(seqs)
    for s in range(gbz.index.sequences):
        assert visits[ptr[s]:ptr[s + 1]].tolist() == gbz.index.extract(s)


def test_vectorized_lf_matches_record_lf(gbz):
    t = gbz.index.table()
    g = gbz.index
    comps, offs, want_n, want_o = [], [], [], []
    for comp in range(min(t.n_rec, 64)):
        if t.run_ptr[comp + 1] == t.run_ptr[comp]:
            continue
        rec = g.record(g.comp_to_node(comp))
        for off in range(min(rec.size, 7)):
            n, o = rec.lf(off)
            comps.append(comp)
            offs.append(off)
            want_n.append(n)
            want_o.append(o)
    node, off2 = t.lf(np.array(comps), np.array(offs))
    assert node.tolist() == want_n
    assert off2.tolist() == want_o


def test_first_nodes(gbz):
    t = gbz.index.table()
    seqs = np.arange(gbz.index.sequences, dtype=np.int64)
    fn = t.first_nodes(seqs)
    for s in range(gbz.index.sequences):
        assert int(fn[s]) == gbz.index.extract(s)[0]


def test_component_labels_vs_union_find(gbz):
    t = gbz.index.table()
    first = int(gbz.graph.node_ids[0])
    labels = t.component_labels(first, len(gbz.graph.node_ids))
    # oracle: python union-find over Record.edges (the pre-table implementation)
    parent: dict[int, int] = {}

    def find(x):
        while parent.setdefault(x, x) != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    for nid in gbz.graph.node_ids:
        for orient in (0, 1):
            rec = gbz.index.record(2 * int(nid) + orient)
            for succ, _ in rec.edges:
                if succ:
                    a, b = find(int(nid)), find(succ >> 1)
                    if a != b:
                        parent[max(a, b)] = min(a, b)
    for i, nid in enumerate(gbz.graph.node_ids):
        assert labels[i] == find(int(nid))


def test_visits_text_and_tags_match_scalar(gbz):
    from pangenome_index_tpu.core.tagbuild import visits_to_tags, visits_to_text
    from pangenome_index_tpu.formats.gbz import node_seq

    for sid in range(min(gbz.index.sequences, 4)):
        visits = np.array(gbz.index.extract(sid), np.int64)
        text = visits_to_text(gbz, visits).tobytes()
        want = b"".join(node_seq(gbz, n >> 1, bool(n & 1)) for n in visits.tolist())
        assert text == want
        tags = visits_to_tags(gbz, visits)
        parts = []
        for n in visits.tolist():
            nid, rev = n >> 1, n & 1
            ln = len(want) and len(node_seq(gbz, nid, False))
            parts.extend((nid << 11) | (rev << 10) | o for o in range(ln))
        assert tags.tolist() == parts


def test_fallback_extract_matches_native(gbz, monkeypatch):
    """The numpy lockstep extract_all (no native lib) matches the walker."""
    import pangenome_index_tpu.formats.gbwt_table as gt

    t = RecordTable.from_gbwt(gbz.index, use_native=False)
    seqs = np.arange(gbz.index.sequences, dtype=np.int64)
    want_v, want_p = t.extract_all(seqs)
    monkeypatch.setattr(gt, "_native_lib", lambda: None)
    got_v, got_p = t.extract_all(seqs)
    assert np.array_equal(got_v, want_v) and np.array_equal(got_p, want_p)
