"""The port's native file reader (rapidsnark_tpu_torch/io/native.py, the
ctypes bridge to native/binfile.cpp) against its pure-Python reader, as
tests/test_native.py holds the JAX package's copy; and the port's zkey
and wtns readers against the JAX package's on the committed fixtures.

Tolerance: section tables and bytes are identical."""

import os

import numpy as np
import pytest

from rapidsnark_tpu.io.wtns import read_wtns as j_read_wtns
from rapidsnark_tpu.io.zkey import read_zkey as j_read_zkey
from rapidsnark_tpu_torch.io import native as N
from rapidsnark_tpu_torch.io.binfile import BinFile, write_binfile
from rapidsnark_tpu_torch.io.wtns import read_wtns
from rapidsnark_tpu_torch.io.zkey import read_zkey

from conftest import FIXTURES

@pytest.fixture
def native():
    """The native reader's module, or a skip where the library can be
    neither found nor built (decided when a test runs, not at import)."""
    if N.load_library() is None:
        pytest.skip("native loader unavailable")
    return N


def test_native_matches_python_on_fixture(native):
    path = os.path.join(FIXTURES, "sqchain64.zkey")
    py = BinFile(path, "zkey", 1)
    nat = N.NativeBinFile(path, "zkey", 1)
    try:
        assert nat.version == py.version
        assert nat.sections == py.sections
        for sec, entries in py.sections.items():
            for pos in range(len(entries)):
                a = np.asarray(py.section_u8(sec, pos)).copy()
                b = nat.section_u8(sec, pos).copy()
                assert np.array_equal(a, b)
    finally:
        py.close()
        nat.close()


def test_native_error_messages(native, tmp_path):
    path = str(tmp_path / "x.bin")
    write_binfile(path, "test", 7, [(1, b"hello")])
    with pytest.raises(ValueError, match="Invalid file type"):
        N.NativeBinFile(path, "zkey", 9)
    with pytest.raises(ValueError, match="Invalid version"):
        N.NativeBinFile(path, "test", 3)
    with pytest.raises(ValueError, match="cannot open"):
        N.NativeBinFile(str(tmp_path / "missing.bin"), "test", 9)


def test_native_truncated_section(native, tmp_path):
    import struct
    path = str(tmp_path / "bad.bin")
    with open(path, "wb") as f:
        f.write(b"test" + struct.pack("<II", 1, 1))
        f.write(struct.pack("<IQ", 1, 1 << 40))  # size overruns the file
    with pytest.raises(ValueError, match="overruns"):
        N.NativeBinFile(path, "test", 9)


def test_zkey_reader_uses_backend_transparently(native):
    zk = read_zkey(os.path.join(FIXTURES, "multiplier.zkey"))
    assert zk.n_vars == 4
    assert isinstance(zk.file, N.NativeBinFile)
    zk.close()
    assert zk.file is None and zk.points_a is None


@pytest.mark.parametrize("mode", ["0", None])
def test_readers_match_jax_package(mode, monkeypatch):
    """RSTPU_NATIVE=0 (the Python reader) and unset (native when it can
    be built): the parsed zkey and wtns equal the JAX package's."""
    if mode is None:
        monkeypatch.delenv("RSTPU_NATIVE", raising=False)
    else:
        monkeypatch.setenv("RSTPU_NATIVE", mode)
    zk = read_zkey(os.path.join(FIXTURES, "sqchain64.zkey"))
    jz = j_read_zkey(os.path.join(FIXTURES, "sqchain64.zkey"))
    if mode == "0":
        assert isinstance(zk.file, BinFile)
    assert (zk.n_vars, zk.n_public, zk.domain_size, zk.n_coefs, zk.r) == \
        (jz.n_vars, jz.n_public, jz.domain_size, jz.n_coefs, jz.r)
    for name in ("points_a", "points_b1", "points_b2", "points_c",
                 "points_h", "ic", "coef_m", "coef_c", "coef_s", "coef_val",
                 "vk_alpha1", "vk_beta2", "vk_delta2"):
        assert np.array_equal(getattr(zk, name), getattr(jz, name)), name
    zk.close()
    jz.close()
    wt = read_wtns(os.path.join(FIXTURES, "sqchain64.wtns"))
    jw = j_read_wtns(os.path.join(FIXTURES, "sqchain64.wtns"))
    assert wt.prime == jw.prime and np.array_equal(wt.values, jw.values)


def test_native_required_raises_when_unbuildable(monkeypatch, tmp_path):
    """RSTPU_NATIVE=1 with no library and no way to build one raises;
    unset, the reader falls back to the Python one."""
    monkeypatch.setattr(N, "_lib", None)
    monkeypatch.setattr(N, "_SO_PATH", str(tmp_path / "libbinfile.so"))
    monkeypatch.setattr(N, "_build", lambda: False)
    monkeypatch.setenv("RSTPU_NATIVE", "1")
    with pytest.raises(RuntimeError, match="native binfile loader"):
        N.load_library()
    monkeypatch.delenv("RSTPU_NATIVE")
    assert N.load_library() is None
    f = N.open_binfile(os.path.join(FIXTURES, "multiplier.zkey"), "zkey", 1)
    assert isinstance(f, BinFile)
    f.close()
