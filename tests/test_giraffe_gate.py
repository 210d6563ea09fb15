"""The x.giraffe correctness gate (BASELINE.md config 1).

x.giraffe.gbz is the reference's canonical toolchain-produced fixture (a
GRCh38 chrX slice built by vg giraffe autoindexing, consumed at
build_tags.cpp:51) - a stronger GBZ-parser exercise than the hand-adjacent
xy fixtures. The reference commits no tag/MEM outputs for it, so the gate
is: the full pipeline runs, every tag value verifies against a fresh
ground-truth build (the cross-check the reference carries commented out at
tags_check.cpp:368-441), and the serving engines agree with each other and
with the committed text.

x.giraffe.ri is a stale artifact in a pre-header serialization (first u64 is
0x30a00, not the 0x6B3741D8 header tag of r-index.hpp:91): the reference's
own Header::check (r-index.cpp:179-199) rejects it, no reference example
reads it (README.md:400-403 always rebuilds test_output.ri from x.rl_bwt),
and we reject it the same way - pinned below.
"""

import numpy as np
import pytest

from test_cli import run


@pytest.mark.slow
def test_giraffe_build_tags_and_verify(ref_data, tmp_path):
    run(["build-tags", str(ref_data / "x.giraffe.gbz"),
         str(ref_data / "x.rl_bwt"), "x.tags"], tmp_path)
    out = run(["tags-check", "x.tags",
               "--verify-gbz", str(ref_data / "x.giraffe.gbz"),
               "--verify-rlbwt", str(ref_data / "x.rl_bwt")], tmp_path)
    text = out.stdout.decode()
    assert "verification OK" in text
    # shape pin (r-index over x.rl_bwt: 3 sequences, 3012 total characters)
    assert "3009 BWT positions" in text


@pytest.mark.slow
def test_giraffe_find_mems_engines_agree(ref_data, tmp_path):
    run(["build-rindex", str(ref_data / "x.rl_bwt"), "-o", "x.ri"], tmp_path)
    run(["build-tags", str(ref_data / "x.giraffe.gbz"),
         str(ref_data / "x.rl_bwt"), "x.tags"], tmp_path)
    run(["convert-tags", "x.tags", "x_c.tags", "--compact"], tmp_path)
    # README.md:400-403's own smoke workload: small_test_nl.txt reads, 5 1
    reads = str(ref_data / "small_test_nl.txt")
    host = run(["find-mems", "x.ri", "x_c.tags", reads, "5", "1",
                "--engine", "host"], tmp_path).stdout.decode()
    dev = run(["find-mems", "x.ri", "x_c.tags", reads, "5", "1",
               "--engine", "device"], tmp_path).stdout.decode()
    strip = lambda s: [l for l in s.splitlines() if not l.startswith("Total time")]
    assert strip(host) == strip(dev)
    assert "MEM START" in host and "Number of unique positions" in host


def test_giraffe_tags_ground_truth_positions(ref_data):
    """Every tag must be a real graph position whose node carries the right
    base: decode tag (node, orient, offset) per BWT row and compare the node
    character against the indexed text character at that suffix start."""
    from pangenome_index_tpu.core.tagbuild import tags_per_row
    from pangenome_index_tpu.formats.gbz import load_gbz, node_seq
    from pangenome_index_tpu.formats.rlbwt import read_rlbwt
    from pangenome_index_tpu.models.oracle import oracle_from_file
    from pangenome_index_tpu.models.rindex import build_rindex

    gbz = load_gbz(ref_data / "x.giraffe.gbz")
    idx = build_rindex(read_rlbwt(ref_data / "x.rl_bwt"), keep_sa=True)
    tags = tags_per_row(gbz, idx)
    with open(ref_data / "x.newline_separated", "rb") as fh:
        lines = [l for l in fh.read().split(b"\n") if l]
    oracle = oracle_from_file(ref_data / "x.newline_separated")
    # suffix-start character of each non-endmarker BWT row, via the oracle SA
    rows = np.arange(idx.n_seq, idx.n)
    text_char = np.array([lines[oracle.da[r]][oracle.sa_pos[r]] for r in rows])
    seqs = {}
    for i, t in enumerate(tags.tolist()):
        nid, rev, off = t >> 11, (t >> 10) & 1, t & 0x3FF
        key = (nid, rev)
        if key not in seqs:
            seqs[key] = node_seq(gbz, nid, bool(rev))
        assert seqs[key][off] == text_char[i], f"row {rows[i]}: tag {t}"


def test_x_giraffe_ri_is_rejected_like_reference(ref_data):
    from pangenome_index_tpu.formats import ri

    with pytest.raises(ValueError, match="tag"):
        ri.load_file(ref_data / "x.giraffe.ri")
