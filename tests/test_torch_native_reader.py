"""The port's native packed reader (`renderih_tpu_torch/data/
native_reader.py` + `csrc/packed_reader.cpp`): test_native_reader.py's
four cases on the port, the no-fallback rule, and `PackedInterHand.load`
gathering through it equal to the memmap."""

import numpy as np
import pytest

from renderih_tpu_torch.data import native_reader
from renderih_tpu_torch.data.interhand import PackedInterHand, make_synthetic_packed
from renderih_tpu_torch.data.native_reader import PackedReader
from renderih_tpu_torch.kernels import _build


@pytest.fixture(scope="module")
def packed_file(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("native") / "data.u8")
    data = np.random.default_rng(0).integers(0, 255, (100, 16, 16, 3), dtype=np.uint8)
    data.tofile(path)
    return path, data


def test_native_builds():
    assert native_reader.load_library() is not None


def test_gather_matches_numpy(packed_file):
    path, data = packed_file
    r = PackedReader(path, (16, 16, 3), np.uint8, n_threads=3)
    assert len(r) == 100
    idx = np.asarray([0, 99, 42, 7, 42])
    np.testing.assert_array_equal(r.gather(idx), data[idx])
    r.close()


def test_out_of_bounds_raises(packed_file):
    path, _ = packed_file
    r = PackedReader(path, (16, 16, 3), np.uint8)
    with pytest.raises(IndexError):
        r.gather(np.asarray([100]))
    with pytest.raises(IndexError):
        r.gather(np.asarray([-1]))
    r.close()


def test_large_parallel_gather(packed_file):
    path, data = packed_file
    r = PackedReader(path, (16, 16, 3), np.uint8, n_threads=8)
    idx = np.random.default_rng(1).integers(0, 100, 512)
    np.testing.assert_array_equal(r.gather(idx), data[idx])
    r.close()


def test_failed_build_raises_instead_of_falling_back(tmp_path, monkeypatch, packed_file):
    """Unlike the JAX package's reader, a build that fails (here: the
    compiler path points at a missing file) raises, from the reader and
    from PackedInterHand.load(use_native=True); use_native=False still
    reads the memmap."""
    from renderih_tpu_torch.assets import make_synthetic_assets

    root = tmp_path / "packed"
    make_synthetic_packed(str(root), "train", make_synthetic_assets(0), n=4, seed=3)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "HOST_CXX", str(tmp_path / "missing" / "g++"))
    monkeypatch.setattr(_build, "_libs", {})
    with pytest.raises(RuntimeError, match="missing/g"):
        PackedReader(packed_file[0], (16, 16, 3))
    with pytest.raises(RuntimeError, match="missing/g"):
        PackedInterHand.load(str(root), "train", use_native=True)
    assert len(PackedInterHand.load(str(root), "train", use_native=False)) == 4
    assert not list((tmp_path / "build").glob("*.so"))


def test_packed_load_gathers_through_the_native_reader(tmp_path):
    from renderih_tpu_torch.assets import make_synthetic_assets

    ds = make_synthetic_packed(str(tmp_path), "train", make_synthetic_assets(0), n=16, seed=1)
    assert isinstance(ds.reader, PackedReader)
    plain = PackedInterHand.load(str(tmp_path), "train", use_native=False)
    assert plain.reader is None
    idx = np.asarray([3, 0, 15, 3, 7])
    got, want = ds.batch(idx), plain.batch(idx)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
