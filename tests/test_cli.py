"""CLI-level pipeline regression: run the real `panidx` commands end-to-end
and byte-compare every intermediate against the committed fixtures."""

import pathlib
import subprocess
import sys

import pytest

ENV_KEYS = ["PATH", "HOME"]
REPO = pathlib.Path(__file__).resolve().parent.parent


def run(args, tmp_path, check=True, env_extra=None):
    import os

    env = {k: os.environ[k] for k in ENV_KEYS if k in os.environ}
    env["PYTHONPATH"] = str(REPO)
    env["JAX_PLATFORMS"] = "cpu"
    if env_extra:
        env.update(env_extra)
    return subprocess.run(
        [sys.executable, "-m", "pangenome_index_tpu.cli", *args],
        capture_output=True, env=env, cwd=tmp_path, timeout=300, check=check,
    )


@pytest.mark.slow
def test_full_pipeline_byte_equality(ref_data, tmp_path):
    ref = ref_data / "bidirectional_test"
    run(["extract-text", str(ref / "xy.gbz"), "-o", "xy.txt"], tmp_path)
    assert (tmp_path / "xy.txt").read_bytes() == (ref / "contigs_xy").read_bytes()

    run(["build-bwt", "xy.txt", "xy.rl_bwt"], tmp_path)
    assert (tmp_path / "xy.rl_bwt").read_bytes() == (ref / "contigs_xy.rl_bwt").read_bytes()

    run(["build-rindex", "xy.rl_bwt", "-o", "xy.ri", "--format", "legacy"], tmp_path)
    assert (tmp_path / "xy.ri").read_bytes() == (ref / "xy.ri").read_bytes()

    run(["build-tags", str(ref / "xy.gbz"), "xy.rl_bwt", "xy.tags"], tmp_path)
    assert (tmp_path / "xy.tags").read_bytes() == (ref / "xy_bidirectional.tags").read_bytes()

    # streamed-SA mode (windowed native psi walks): same bytes
    run(["build-tags", str(ref / "xy.gbz"), "xy.rl_bwt", "xy_s.tags",
         "--stream-sa", "--sa-window-bytes", "16384"], tmp_path)
    assert (tmp_path / "xy_s.tags").read_bytes() == (ref / "xy_bidirectional.tags").read_bytes()

    run(["convert-tags", "xy.tags", "xy_c.tags"], tmp_path)
    assert (tmp_path / "xy_c.tags").read_bytes() == (ref / "xy_bidirectional_compressed.tags").read_bytes()

    out = run(["find-mems", "xy.ri", "xy_c.tags", str(ref / "test_reads.txt"),
               "3", "1", "--engine", "host"], tmp_path)
    text = out.stdout.decode()
    assert "Seq: 1" in text and "MEM START: 0, MEM END: 3 BWT START: 989 SIZE: 136" in text


def test_print_stats_substructure_parity(ref_data, tmp_path):
    """print-stats reports per-ON-DISK-substructure bytes + bits/run in the
    reference's categories (print_stats.cpp:100-117, 175-184), and the
    section sizes must add up to the exact file sizes."""
    import re

    ref = ref_data / "bidirectional_test"
    out = run(["print-stats", str(ref / "xy.ri"),
               str(ref / "xy_bidirectional_compressed.tags")], tmp_path)
    text = out.stdout.decode()
    for cat in ["header:", "samples:", "last (sd_vector):", "last_to_run:",
                "sym_map:", "C:", "blocks_start_pos (sd_vector):",
                "blocks.character_cum_ranks:", "blocks.runs (pairs):",
                "encoded_runs (ByteCode):", "encoded_runs_starts (sd_vector):",
                "bwt_intervals (sd_vector):", "bits/run"]:
        assert cat in text, f"missing category {cat!r}"
    ri_total = int(re.search(r"TOTAL r-index \(on disk\): (\d+) bytes", text).group(1))
    assert ri_total == (ref / "xy.ri").stat().st_size
    tag_total = int(re.search(r"TOTAL tag arrays \(compressed\): (\d+) bytes", text).group(1))
    assert tag_total == (ref / "xy_bidirectional_compressed.tags").stat().st_size
    # encoded-format .ri reports the encoded-block categories
    run(["build-rindex", str(ref / "contigs_xy.rl_bwt"), "-o", "xy_enc.ri"], tmp_path)
    out2 = run(["print-stats", "xy_enc.ri"], tmp_path).stdout.decode()
    assert "blocks.encoded_start_bits (int_vector<0>):" in out2
    assert "blocks.encoded_stream (bytes):" in out2
    ri2 = int(re.search(r"TOTAL r-index \(on disk\): (\d+) bytes", out2).group(1))
    assert ri2 == (tmp_path / "xy_enc.ri").stat().st_size


def test_cli_error_paths(ref_data, tmp_path):
    r = run(["build-rindex", "missing.rl_bwt"], tmp_path, check=False)
    assert r.returncode == 1 and b"panidx:" in r.stderr
    r = run(["tags-check", "/bin/ls"], tmp_path, check=False)
    assert r.returncode == 1


def test_synthetic_graph_full_pipeline(tmp_path):
    """sequences -> GBZ -> text -> BWT -> r-index -> tags -> MEMs, all via the
    CLI on a generated graph (no reference fixtures involved)."""
    import numpy as np

    from pangenome_index_tpu.core.gbwt_build import random_pangenome_gbz
    from pangenome_index_tpu.formats.gbz_write import save_gbz

    rng = np.random.default_rng(23)
    gbz = random_pangenome_gbz(rng, n_nodes=40, n_paths=3)
    save_gbz(gbz, tmp_path / "synth.gbz")

    run(["extract-text", "synth.gbz", "-o", "synth.txt"], tmp_path)
    run(["build-bwt", "synth.txt", "synth.rl_bwt"], tmp_path)
    run(["build-rindex", "synth.rl_bwt", "-o", "synth.ri"], tmp_path)
    run(["build-tags", "synth.gbz", "synth.rl_bwt", "synth.tags"], tmp_path)
    run(["convert-tags", "synth.tags", "synth_c.tags", "--compact", "--no-compat"], tmp_path)
    r = run(["tags-check", "synth_c.tags", "--verify-gbz", "synth.gbz",
             "--verify-rlbwt", "synth.rl_bwt"], tmp_path)
    assert b"verification OK" in r.stdout
    # reads from the haplotypes
    lines = [l for l in (tmp_path / "synth.txt").read_bytes().split(b"\n") if l]
    reads = [lines[0][:30], lines[-1][5:35]]
    (tmp_path / "reads.txt").write_bytes(b"\n".join(reads) + b"\n")
    out = run(["find-mems", "synth.ri", "synth_c.tags", "reads.txt", "10", "1",
               "--engine", "host"], tmp_path)
    assert b"MEM START: 0" in out.stdout
    # device engine with multi-chunk work-sorted serving (batch-size < n_reads
    # + seed table => reads are processed in difficulty order and results
    # inverse-permuted): stdout must match the host engine exactly
    reads4 = [lines[0][:30], lines[-1][5:35], lines[0][10:40], lines[-1][:30]]
    (tmp_path / "reads4.txt").write_bytes(b"\n".join(reads4) + b"\n")
    outs = {}
    for eng, extra in (("host", []), ("device", ["--batch-size", "2", "--mer-len", "4"])):
        o = run(["find-mems", "synth.ri", "synth_c.tags", "reads4.txt", "10", "1",
                 "--engine", eng, *extra], tmp_path)
        outs[eng] = b"\n".join(l for l in o.stdout.splitlines()
                               if b"seconds" not in l)
    assert outs["device"] == outs["host"]


def test_mesh_cli_matches_host_engine(ref_data, tmp_path):
    """`find-mems --mesh 4x2` on an 8-virtual-device CPU mesh: stdout equals
    the host engine exactly (VERDICT r1 item 5: the mesh is reachable from
    the CLI, not library-only)."""
    ref = ref_data / "bidirectional_test"
    outs = {}
    for name, extra, env in (
        ("host", ["--engine", "host"], None),
        ("mesh", ["--mesh", "4x2"],
         {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}),
    ):
        o = run(["find-mems", str(ref / "xy.ri"),
                 str(ref / "xy_bidirectional_compressed.tags"),
                 str(ref / "test_reads.txt"), "3", "1", *extra],
                tmp_path, env_extra=env)
        outs[name] = b"\n".join(l for l in o.stdout.splitlines()
                                if b"seconds" not in l)
    assert outs["mesh"] == outs["host"]
    # with the seed tiers active (dense m-mer + long-seed dictionary,
    # replicated over the mesh): still byte-equal to the host engine
    for name, extra, env in (
        ("host12", ["--engine", "host"], None),
        ("mesh12", ["--mesh", "4x2", "--mer-len", "4", "--long-seed", "-1",
                    "--no-mer-cache"],
         {"XLA_FLAGS": "--xla_force_host_platform_device_count=8"}),
    ):
        o = run(["find-mems", str(ref / "xy.ri"),
                 str(ref / "xy_bidirectional_compressed.tags"),
                 str(ref / "test_reads.txt"), "12", "1", *extra],
                tmp_path, env_extra=env)
        outs[name] = b"\n".join(l for l in o.stdout.splitlines()
                                if b"seconds" not in l)
    assert outs["mesh12"] == outs["host12"]


def test_merge_tags_cli_accepts_all_formats(ref_data, tmp_path):
    """merge-tags consumes per-component inputs in any tag format (algorithm
    raw ByteCode, compressed bytecode, compressed sdsl) and a small --window,
    producing identical whole-genome output."""
    from pangenome_index_tpu.formats import tags as tagfmt

    base = ref_data / "two_contig_graph"
    # per-contig algorithm-format tag files built by our own pipeline
    for g, rl, name in [("x.gbz", "contigs_chrX.rl_bwt", "x"),
                        ("y.gbz", "contigs_chrY.rl_bwt", "y")]:
        run(["build-tags", str(base / g), str(base / rl), f"alg_{name}.tags"],
            tmp_path)
    d_alg = tmp_path / "d_alg"
    d_mix = tmp_path / "d_mix"
    d_alg.mkdir()
    d_mix.mkdir()
    for name in ("x", "y"):
        raw = (tmp_path / f"alg_{name}.tags").read_bytes()
        (d_alg / f"{name}.tags").write_bytes(raw)
    # mixed formats: x as compressed sdsl, y as compressed bytecode
    (d_mix / "x.tags").write_bytes(
        tagfmt.write_compressed_sdsl(tagfmt.read_algorithm((d_alg / "x.tags").read_bytes())))
    (d_mix / "y.tags").write_bytes(
        tagfmt.write_compressed_bytecode(tagfmt.read_algorithm((d_alg / "y.tags").read_bytes())))
    # build the whole-genome r-index
    run(["build-rindex", str(base / "contigs_XY.rl_bwt"), "-o", "xy.ri"], tmp_path)
    run(["merge-tags", str(base / "xy.gbz"), "xy.ri", str(d_alg), "merged_a.tags"],
        tmp_path)
    run(["merge-tags", str(base / "xy.gbz"), "xy.ri", str(d_mix), "merged_m.tags",
         "--window", "97"], tmp_path)
    a = (tmp_path / "merged_a.tags").read_bytes()
    m = (tmp_path / "merged_m.tags").read_bytes()
    assert a and a == m
    # device engine (sharded all_gather scan-merge over an 8-virtual-device
    # mesh, parallel/merge.py): byte-identical output (VERDICT r4 item 5)
    run(["merge-tags", str(base / "xy.gbz"), "xy.ri", str(d_alg),
         "merged_d.tags", "--engine", "device"], tmp_path,
        env_extra={"XLA_FLAGS": "--xla_force_host_platform_device_count=8"})
    assert (tmp_path / "merged_d.tags").read_bytes() == a


def test_query_tags_device_engine_matches_host(ref_data, tmp_path):
    """query-tags --engine device batches BOTH halves (count + tag lookup)
    on device; stdout equals the host engine exactly (VERDICT r4 item 6).
    A tiny --tag-capacity forces the overflow -> host re-query path too."""
    ref = ref_data / "bidirectional_test"
    outs = {}
    for name, extra in (("host", ["--engine", "host"]),
                        ("device", ["--engine", "device"]),
                        ("device_tiny", ["--engine", "device",
                                         "--tag-capacity", "4"])):
        o = run(["query-tags", str(ref / "xy.ri"),
                 str(ref / "xy_bidirectional_compressed.tags"),
                 str(ref / "test_reads.txt"), *extra], tmp_path)
        outs[name] = o.stdout
    assert outs["device"] == outs["host"]
    assert outs["device_tiny"] == outs["host"]


def test_find_mems_long_seed_matches_host(ref_data, tmp_path):
    """--long-seed -1 (sparse dictionary tier) must leave stdout identical
    to the host engine - seeds only skip guaranteed-pass extensions."""
    ref = ref_data / "bidirectional_test"
    outs = {}
    for name, extra in (("host", ["--engine", "host"]),
                        ("long", ["--engine", "device", "--mer-len", "4",
                                  "--long-seed", "-1", "--no-mer-cache"])):
        o = run(["find-mems", str(ref / "xy.ri"),
                 str(ref / "xy_bidirectional_compressed.tags"),
                 str(ref / "test_reads.txt"), "12", "1", *extra], tmp_path)
        outs[name] = b"\n".join(l for l in o.stdout.splitlines()
                                if b"seconds" not in l)
    assert outs["long"] == outs["host"]


def test_find_mems_overflow_escalates_on_device(ref_data, tmp_path):
    """--mem-capacity 2 makes most reads overflow; the escalation tiers must
    recover them on the device (stderr says so) with stdout identical to the
    host engine (VERDICT r4 item 3)."""
    ref = ref_data / "bidirectional_test"
    outs = {}
    o_host = run(["find-mems", str(ref / "xy.ri"),
                  str(ref / "xy_bidirectional_compressed.tags"),
                  str(ref / "test_reads.txt"), "3", "1", "--engine", "host"],
                 tmp_path)
    o_dev = run(["find-mems", str(ref / "xy.ri"),
                 str(ref / "xy_bidirectional_compressed.tags"),
                 str(ref / "test_reads.txt"), "3", "1", "--engine", "device",
                 "--mem-capacity", "2", "--mer-len", "0"], tmp_path)
    assert b"escalated" in o_dev.stderr
    assert b"host refind" not in o_dev.stderr
    strip = lambda b: b"\n".join(l for l in b.splitlines() if b"seconds" not in l)
    assert strip(o_dev.stdout) == strip(o_host.stdout)


def test_facade_api(ref_data):
    import pangenome_index_tpu as px

    idx = px.build_index([b"GATTACAGATTACAGT", b"ACTGCCAATGTTTGCC"])
    t = px.to_device(idx, dense=False)
    mems = px.find_mems(t, [b"GATTACA"], min_len=4, min_occ=1)
    assert len(mems) == 1 and all(len(m) == 4 for m in mems[0])
    ri = px.load_rindex(ref_data / "bidirectional_test/xy.ri")
    assert ri.n == 8022


def test_resolve_mer_len_scales_with_index_size():
    """-1 auto caps the seed table at ~128n entries (advisor r3: a tiny
    index must not trigger a multi-GB table) while keeping the measured
    m=14 optimum at bench scale."""
    from pangenome_index_tpu.cli import _resolve_mer_len

    # CPU backend in tests: backend cap is 8; the size cap must bite below it
    assert _resolve_mer_len(-1, 31, 100_000) <= 8
    assert _resolve_mer_len(-1, 31, 500) < 8
    # explicit m bypasses auto; min_len must exceed m
    assert _resolve_mer_len(6, 31, 500) == 6
    assert _resolve_mer_len(6, 6, 10**9) == 0
    # the documented rule directly: cap = floor(log2(128n)/2)
    import numpy as np
    for n in (10**5, 4 * 10**6, 2 * 10**9):
        m = _resolve_mer_len(-1, 99, n)
        assert 4 ** m <= 128 * n


def test_build_sdict_artifact(ref_data, tmp_path):
    """build-sdict materializes the exact content-keyed artifact the
    find-mems --long-seed path builds on demand."""
    import numpy as np

    from pangenome_index_tpu.formats import ri
    from pangenome_index_tpu.ops.sparsedict import (build_sparse_dict,
                                                    sparse_dict_key)

    ref = ref_data / "bidirectional_test"
    out = tmp_path / "xy.sdict.npz"
    r = run(["build-sdict", str(ref / "xy.ri"), "-s", "9",
             "-o", str(out)], tmp_path)
    assert "entries" in r.stderr.decode()
    idx = ri.load_file(str(ref / "xy.ri"))
    with np.load(out, allow_pickle=False) as z:
        assert str(z["key"]) == sparse_dict_key(idx, 9)
        keys, vals = build_sparse_dict(idx, 9)
        np.testing.assert_array_equal(z["keys"], keys)
        np.testing.assert_array_equal(z["vals"], vals)


def test_find_mems_min_len_32_device_matches_native(tmp_path):
    """min_len 32 on an int32 index: the auto long-seed window stops at the
    30 bases the device dictionary build holds (s=31 would raise), and the
    device output equals the native engine's."""
    from pangenome_index_tpu.formats.gbz_write import save_gbz
    from pangenome_index_tpu.utils.synth import synth_graph_gbz, synth_reads

    gbz, lines = synth_graph_gbz(6000, 8, seed=9)
    save_gbz(gbz, tmp_path / "g.gbz")
    reads = synth_reads(lines, 48, 120, error_rate=0.01, seed=10)
    (tmp_path / "reads.txt").write_bytes(b"\n".join(reads) + b"\n")
    run(["extract-text", "g.gbz", "-o", "g.txt"], tmp_path)
    run(["build-bwt", "g.txt", "g.rl_bwt"], tmp_path)
    run(["build-rindex", "g.rl_bwt", "-o", "g.ri"], tmp_path)
    run(["build-tags", "g.gbz", "g.rl_bwt", "g_full.tags"], tmp_path)
    run(["convert-tags", "g_full.tags", "g.tags", "--compact", "--no-compat"],
        tmp_path)
    outs = {}
    for eng in ("native", "device"):
        o = run(["find-mems", "g.ri", "g.tags", "reads.txt", "32", "5",
                 "--engine", eng], tmp_path)
        outs[eng] = o.stdout.rsplit(b"Total time", 2)[0]
    assert outs["device"] == outs["native"] and b"MEM START" in outs["native"]
    assert (tmp_path / "g.ri.sdict30.npz").exists()
    r = run(["find-mems", "g.ri", "g.tags", "reads.txt", "32", "5",
             "--long-seed", "31"], tmp_path, check=False)
    assert r.returncode != 0 and b"30 bases" in r.stderr
