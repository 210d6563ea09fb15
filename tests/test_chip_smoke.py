"""chip_smoke.py's phases and comparison helpers on a tiny seeded index.

On the CPU the device engines run on the requested CPU backend, so every
byte comparison of the smoke run is exercised here; the script itself must
refuse to report success without a GPU."""

import json
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(base_len=12_000, n_haps=6, n_reads=256, read_len=150,
                n_exact=64, bwt_base_len=1500, merge_base_len=4000,
                merge_haps=3, merge_comps=3)


def test_strip_timing():
    out = b"Seq: 1\nMEM START: 0\n\nTotal time for finding all MEMs: 1 s\n" \
          b"Total time for all tag queries: 2 s\n"
    assert cs.strip_timing(out) == b"Seq: 1\nMEM START: 0\n"
    with pytest.raises(cs.PhaseError):
        cs.strip_timing(b"Seq: 1\nMEM START: 0\n")


def test_same_bytes_reports_the_first_difference():
    cs.same_bytes("equal", b"abc", b"abc")
    with pytest.raises(cs.PhaseError, match="byte 1"):
        cs.same_bytes("differ", b"abc", b"axc")
    with pytest.raises(cs.PhaseError, match="byte 2"):
        cs.same_bytes("prefix", b"ab", b"abc")


def test_same_arrays(tmp_path):
    import numpy as np

    a, b = tmp_path / "a.npz", tmp_path / "b.npz"
    np.savez(a, keys=np.arange(4), vals=np.ones((4, 3), np.int32))
    np.savez(b, keys=np.arange(4), vals=np.ones((4, 3), np.int32))
    cs.same_arrays("equal", str(a), str(b))
    np.savez(b, keys=np.arange(4), vals=np.zeros((4, 3), np.int32))
    with pytest.raises(cs.PhaseError, match="vals"):
        cs.same_arrays("differ", str(a), str(b))


@pytest.mark.parametrize("mesh,report,ok", [
    ("1x4", "mesh 1x4: index rows 40, per device [10, 10, 10, 10]", True),
    ("4x1", "mesh 4x1: index rows 40, per device [40, 40, 40, 40]", True),
    ("1x4", "mesh 1x4: index rows 40, per device [40, 10, 10, 10]", False),
    ("1x4", "mesh 1x4: index rows 40, per device [20, 20]", False),
    ("4x1", "mesh 4x1: index rows 40, per device [40, 0, 0, 0]", False),
    ("1x4", "no report", False)])
def test_check_placement(mesh, report, ok):
    """Each device must hold its 1/n_model of the index rows: a table left
    whole on device 0 fails."""
    if ok:
        cs.check_placement(mesh, f"log\n{report}\nlog")
    else:
        with pytest.raises(cs.PhaseError):
            cs.check_placement(mesh, report)


def _smoke(tmp_path):
    return cs.Smoke(tmp_path, dict(os.environ, JAX_PLATFORMS="cpu"))


def test_one_card_phases_on_a_tiny_index(tmp_path):
    """Every one-card phase: index build, device-vs-native/host serving,
    build-bwt / merge-tags / print-stats, and the measurement child."""
    sm = _smoke(tmp_path)
    cs.phase_native(sm)
    cs.phase_dataset(sm, TINY)
    cs.phase_index(sm)
    cs.phase_serve(sm)
    cs.phase_other(sm, TINY)
    rec = cs.phase_measure(sm, "cpu")
    assert rec["mem_rps"] > 0 and rec["tags_rps"] > 0 and rec["ext_rate"] > 0
    assert rec["n_reads"] == TINY.n_reads and rec["sdict_s"] == cs.MIN_LEN - 1
    steps = {s["step"] for s in sm.steps}
    assert {"find-mems device", "query-tags device", "build-sdict device",
            "build-bwt device (small)", "merge-tags device"} <= steps
    assert all("compile_s" in s for s in sm.steps if "device" in s["step"])


def test_four_card_phase_on_virtual_devices(tmp_path):
    """The mesh paths (1x4, 4x1) and the device merge on the 8 virtual CPU
    devices the test session provides."""
    sm = _smoke(tmp_path)
    sz = TINY
    cs.phase_dataset(sm, sz)
    cs.phase_index(sm, host_sdict=False)
    cs.phase_merge_inputs(sm, sz)
    cs.phase_four_cards(sm)
    assert {"find-mems mesh 1x4", "find-mems mesh 4x1"} <= {
        s["step"] for s in sm.steps}


def _run_script(cwd, env):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, timeout=300)


def _is_result(line: bytes) -> bool:
    try:
        return "ok" in json.loads(line)
    except ValueError:
        return False


def test_script_fails_without_a_gpu():
    r = _run_script(REPO, dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or not _is_result(lines[-1])
    assert b"no GPU" in r.stderr


def test_script_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = _run_script(tmp_path, env)
    assert r.returncode != 0
    lines = r.stdout.strip().splitlines()
    assert not lines or not _is_result(lines[-1])


@pytest.mark.gpu
def test_one_card_phases_on_gpu(gpu_device, tmp_path):
    """The same tiny run with the device engines on the GPU."""
    sm = cs.Smoke(tmp_path)
    info = cs.phase_identify(sm, 1)
    assert info["platform"] == "gpu"
    cs.phase_native(sm)
    cs.phase_dataset(sm, TINY)
    cs.phase_index(sm)
    cs.phase_serve(sm)
    cs.phase_other(sm, TINY)
    cs.phase_measure(sm, info["card"])
