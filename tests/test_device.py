"""The serving-device helper: which device the engines get, the memory caps
derived from the device's allocator limit, the compile-cache placement, and
where the native library is built."""

import pathlib

import jax
import pytest

from pangenome_index_tpu import device, native

GIB = 1 << 30


class FakeDevice:
    def __init__(self, platform, bytes_limit=None):
        self.platform = platform
        self.device_kind = f"fake {platform}"
        self._limit = bytes_limit

    def memory_stats(self):
        return None if self._limit is None else {"bytes_limit": self._limit}


def test_serving_device_is_cpu_when_requested():
    assert device.cpu_requested()
    assert device.serving_device().platform == "cpu"
    assert all(d.platform == "cpu" for d in device.serving_devices())


@pytest.mark.parametrize("platform,cpu_asked,ok", [
    ("gpu", False, True), ("gpu", True, True), ("cpu", True, True),
    ("cpu", False, False), ("rocm", True, False)])
def test_serving_device_choice(monkeypatch, platform, cpu_asked, ok):
    fake = FakeDevice(platform)
    monkeypatch.setattr(jax, "devices", lambda *a: [fake])
    monkeypatch.setattr(device, "cpu_requested", lambda: cpu_asked)
    if ok:
        assert device.serving_device() is fake
    else:
        with pytest.raises(RuntimeError, match="no GPU"):
            device.serving_device()


@pytest.mark.parametrize("limit,m4,m8", [
    (60 * GIB, 14, 14),   # an 80 GB card at JAX's default three quarters
    (11 * GIB, 13, 13),   # the int32 m=14 table (3 GiB) > a quarter
    (1 * GIB, 12, 11)])
def test_memory_budget_caps(limit, m4, m8):
    b = device.memory_budget(FakeDevice("gpu", limit))
    assert b.bytes_limit == limit
    assert b.sdict_resident_max == limit * 3 // 8
    assert b.sdict_build_max == limit * 3 // 16
    assert b.mer_cache_max == limit // 64
    assert (b.mer_cap(4), b.mer_cap(8)) == (m4, m8)
    for itemsize, m in ((4, m4), (8, m8)):
        assert 4**m * 3 * itemsize <= limit // 4


def test_memory_budget_without_allocator_stats_uses_host_memory():
    b = device.memory_budget(FakeDevice("cpu"))
    assert b.bytes_limit > 0
    assert device.memory_budget().bytes_limit == b.bytes_limit


@pytest.mark.parametrize("limit,n,want", [
    (60 * GIB, 10**9, 14), (60 * GIB, 3 * 2**31, 14), (11 * GIB, 10**9, 13),
    (11 * GIB, 3 * 2**31, 13)])
def test_resolve_mer_len_follows_the_budget(monkeypatch, limit, n, want):
    from pangenome_index_tpu.cli import _resolve_mer_len

    monkeypatch.setattr(device, "serving_device",
                        lambda: FakeDevice("gpu", limit))
    assert _resolve_mer_len(-1, 31, n) == want


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_in_checkout_by_default(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    device.setup_compile_cache()
    assert jax.config.jax_compilation_cache_dir == str(
        device.REPO_ROOT / ".jax_cache")


def test_compile_cache_env_var_is_left_to_jax(monkeypatch, tmp_path,
                                              restore_cache_dir):
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    device.setup_compile_cache()
    assert jax.config.jax_compilation_cache_dir is None


def test_native_library_is_built_under_build_dir():
    repo = pathlib.Path(__file__).resolve().parent.parent
    assert native.build(), native.build_error
    assert native.LIB_PATH == repo / "build" / "libpanindex_native.so"
    assert native.LIB_PATH.exists()
    srcs = native.sources()
    assert srcs and all(s.exists() and s.suffix == ".cpp" for s in srcs)
    assert not list((repo / "src").rglob("*.so"))
    assert native.available()


def test_device_record_names_the_serving_device(monkeypatch):
    monkeypatch.setattr(device, "card_info", lambda: "Card X, 700.00 W")
    rec = device.device_record()
    assert rec["platform"] == "cpu" and rec["count"] == len(jax.devices("cpu"))
    assert rec["kind"] == jax.devices()[0].device_kind
    assert rec["jax"] == jax.__version__ and rec["card"] == "Card X, 700.00 W"
    fake = FakeDevice("gpu", 60 * GIB)
    monkeypatch.setattr(jax, "devices", lambda *a: [fake] * 4)
    rec = device.device_record(fake)
    assert (rec["platform"], rec["kind"], rec["count"], rec["bytes_limit"]) \
        == ("gpu", "fake gpu", 4, 60 * GIB)


def test_bench_refuses_without_a_gpu(capsys):
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))
    import bench

    assert bench.main() == 1
    out = capsys.readouterr()
    assert not out.out and "no GPU" in out.err
