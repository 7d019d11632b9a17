"""The port's native host library (utils/native.py) against the JAX package's.

- `tar_index` gives the JAX package's entries (name, payload offset, size,
  typeflag) on ustar, GNU (long names through ././@LongLink) and pax
  archives, and every regular member's bytes at its offset are tarfile's.
- `TarBackend` indexes an uncompressed tar natively and reads the bytes the
  JAX package's backend reads; a compressed tar goes through tarfile; the
  backend pickles and closes; `list_files` inside a tar matches.
- `hungarian` reaches scipy's optimum; `linear_sum_assignment` takes scipy,
  then the native solver, then numpy, as the JAX package does.
- The library is built from the port's own copy of the source into
  build/hbird_tpu_torch/, never beside native/; a failing build raises with
  the compiler's message, and a .tar read then raises too.
"""

import os
import pickle
import tarfile

import numpy as np
import pytest
from scipy.optimize import linear_sum_assignment as scipy_lsa

from hbird_tpu.data.backend import TarBackend as JTarBackend
from hbird_tpu.utils import io as jio
from hbird_tpu.utils import native as jnative
from hbird_tpu_torch.data.backend import TarBackend
from hbird_tpu_torch.utils import eval_metrics, io, native

FILES = {
    "a/b.txt": b"hello",
    "a/c/d.bin": bytes(range(256)),
    "empty.txt": b"",
    "img/x.png": b"\x89PNG" + b"\x00" * 700,
}
LONG = "deep/" + "x" * 120 + "/long_name_file.dat"  # > 100 chars: GNU or pax only
FORMATS = {"ustar": tarfile.USTAR_FORMAT, "gnu": tarfile.GNU_FORMAT, "pax": tarfile.PAX_FORMAT}


def _make_tar(tmp_path, fmt, suffix=".tar", mode="w"):
    root = tmp_path / f"content_{fmt}"
    files = dict(FILES)
    if fmt != "ustar":
        files[LONG] = b"L" * 1000
    for rel, payload in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_bytes(payload)
    path = str(tmp_path / f"t_{fmt}{suffix}")
    with tarfile.open(path, mode, format=FORMATS[fmt]) as t:
        t.add(str(root), arcname="content")
        info = tarfile.TarInfo("content/link")  # a non-regular member
        info.type, info.linkname = tarfile.SYMTYPE, "a/b.txt"
        t.addfile(info)
    return path, files


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_tar_index_matches_jax_and_tarfile(tmp_path, fmt):
    path, files = _make_tar(tmp_path, fmt)
    entries = native.tar_index(path)
    assert entries == jnative.tar_index(path)
    regular = {name: (off, size) for name, off, size, tf in entries if tf in ("0", "\x00")}
    assert sorted(regular) == sorted("content/" + rel for rel in files)
    with tarfile.open(path) as t, open(path, "rb") as f:
        members = [m for m in t.getmembers() if m.isfile()]
        assert sorted(m.name for m in members) == sorted(regular)
        for m in members:
            off, size = regular[m.name]
            f.seek(off)
            assert size == m.size and f.read(size) == t.extractfile(m).read(), m.name
    assert {tf for _, _, _, tf in entries} >= {"5", "2"}  # directories and the symlink


@pytest.mark.parametrize("fmt", ["ustar", "pax"])
def test_tar_backend_reads_what_jax_reads(tmp_path, fmt):
    path, files = _make_tar(tmp_path, fmt)
    b, jb = TarBackend(path), JTarBackend(path)
    assert b._index is not None  # the native index, not tarfile
    assert b.members == jb.members
    for member in b.members:
        assert b.read(member) == jb.read(member) == files[member[len("content/"):]]
    assert b.read("./content/a/b.txt") == b"hello"
    with pytest.raises(FileNotFoundError):
        b.read("content/missing")
    clone = pickle.loads(pickle.dumps(b))
    assert clone.read("content/a/c/d.bin") == files["a/c/d.bin"]
    b.close(), clone.close(), jb.close()
    assert getattr(b._local, "fd", None) is None


def test_compressed_tar_uses_tarfile(tmp_path):
    path, files = _make_tar(tmp_path, "pax", suffix=".tar.gz", mode="w:gz")
    b = TarBackend(path)
    assert b._index is None
    assert sorted(b.members) == sorted("content/" + rel for rel in files)
    assert b.read("content/a/b.txt") == b"hello"
    b.close()


def test_list_files_in_a_tar_matches_jax(tmp_path):
    path, _ = _make_tar(tmp_path, "gnu")
    inner = path + "!/content/a"
    assert sorted(io.list_files(inner)) == sorted(jio.list_files(inner)) == ["b.txt", "c/d.bin"]


@pytest.mark.parametrize("shape", [(4, 4), (6, 9), (9, 6), (151, 151)])
def test_hungarian_matches_scipy(shape):
    cost = np.random.default_rng(sum(shape)).uniform(size=shape)
    r1, c1 = native.hungarian(cost)
    r2, c2 = scipy_lsa(cost)
    assert len(r1) == min(shape)
    assert np.isclose(cost[r1, c1].sum(), cost[r2, c2].sum())
    r3, c3 = jnative.hungarian(cost)
    np.testing.assert_array_equal(r1, r3)
    np.testing.assert_array_equal(c1, c3)


def test_assignment_order_scipy_then_native_then_numpy(monkeypatch):
    cost = np.random.default_rng(3).uniform(size=(7, 7))
    best = cost[scipy_lsa(cost)].sum()
    calls = []
    monkeypatch.setattr(eval_metrics, "_SCIPY_AVAILABLE", False)
    monkeypatch.setattr(native, "hungarian", lambda c: calls.append("native") or scipy_lsa(c))
    r, c = eval_metrics.linear_sum_assignment(cost)
    assert calls == ["native"] and np.isclose(cost[r, c].sum(), best)
    monkeypatch.setattr(native, "available", lambda: False)
    r, c = eval_metrics.linear_sum_assignment(cost)
    assert calls == ["native"] and np.isclose(cost[r, c].sum(), best)


def test_library_is_built_into_build_not_native():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = sorted(os.listdir(os.path.join(repo, "native")))
    path = native.build()
    assert path == native.library_path() and path.exists()
    assert path.parent == native.BUILD_DIR and native.BUILD_DIR.parts[-2:] == ("build", "hbird_tpu_torch")
    assert native.SRC.parent.name == "native" and native.SRC.parent.parent.name == "hbird_tpu_torch"
    assert native.SRC.read_bytes() != b"" and sorted(os.listdir(os.path.join(repo, "native"))) == before


def test_a_failing_build_raises_with_the_compiler_message(tmp_path, monkeypatch):
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++;\n")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    assert not native.available()
    path, _ = _make_tar(tmp_path, "ustar")
    with pytest.raises(RuntimeError, match="bad.cpp"):
        TarBackend(path)
    assert not list((tmp_path / "build").glob("*.so"))
