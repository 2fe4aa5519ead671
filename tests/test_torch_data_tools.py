"""The port's dataset tools (`renderih_tpu_torch/tools/`) against the JAX
package's (`tools/`) on the same seeded raw trees: each tool packs the
tree once per package, and the port's output is held to the JAX tool's.

Held on every fixture: `{split}_images.u8` equal byte for byte (the port's
image reader, resize and warp are bit-exact to cv2), except where the crop
matrix is made from MANO vertices (interhand_gen): MANO's float32 output
differs from JAX's in the last bits, so does the matrix, and a few pixels
round the other way (measured: max |Δ| 1 grey level on up to 0.15% of bytes;
held at max 1 on at most 0.5%), while every crop there equals cv2's warp
under the port's own matrix bit for bit; the same label keys,
each array within 1e-5 of its largest magnitude (1e-4 for the v2d/j2d
pixel labels, and for the labels of hands fitted by the IK, whose
parameters are held at 1e-4 in test_torch_ik.py); `{split}_meta.json`
equal; `convert_mano_pkl`'s npz equal key by key, bit for bit; every
clear-error case of `test_interhand_gen.py` raising the same exception
type. MANO and the IK run on the CPU here (`--device cpu`); the JAX tools
need cv2, so the file skips without it, as the JAX tests do.
"""

import argparse
import importlib.util
import json
import os
import pickle
import sys

import numpy as np
import pytest
import scipy.sparse

cv = pytest.importorskip("cv2")

from test_interhand_gen import _clone_tree, _gen_argv, official_tree  # noqa: E402,F401

from renderih_tpu_torch.tools import convert_assets, pack_data  # noqa: E402
from renderih_tpu_torch.tools.dataset_gen import (  # noqa: E402
    handdict_gen,
    interhand_gen,
    other_datasets_gen,
    tzionas_gen,
)

_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
_TOOLS = os.path.join(_ROOT, "tools", "dataset_gen")
_TWO_D = ("v2d_", "j2d_")


def _jax_tool(name, where=_TOOLS):
    """A JAX tool loaded from its file, as the JAX tests load it."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(where, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    sys.path.insert(0, where)
    spec.loader.exec_module(mod)
    return mod


def _run_jax_main(tool, argv):
    """`tool.main()` of a JAX tool that reads sys.argv."""
    saved = sys.argv
    sys.argv = [tool.__name__] + argv
    try:
        tool.main()
    finally:
        sys.argv = saved


def assert_packed_equal(port_dir, jax_dir, split, fitted=(), mano_crop=False):
    """The port's packed split against the JAX tool's (see the docstring);
    `fitted` names label keys filled by the IK, `mano_crop` says the crop
    matrices come from MANO vertices."""
    port_img = np.fromfile(os.path.join(port_dir, f"{split}_images.u8"), np.uint8)
    jax_img = np.fromfile(os.path.join(jax_dir, f"{split}_images.u8"), np.uint8)
    assert port_img.shape == jax_img.shape
    if mano_crop:
        diff = np.abs(port_img.astype(np.int16) - jax_img)
        share = float((diff > 0).sum()) / max(diff.size, 1)
        assert diff.max(initial=0) <= 1 and share <= 0.005, (diff.max(initial=0), share)
    else:
        assert np.array_equal(port_img, jax_img), "packed images differ"
    got = np.load(os.path.join(port_dir, f"{split}_labels.npz"))
    want = np.load(os.path.join(jax_dir, f"{split}_labels.npz"))
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].shape == want[k].shape and got[k].dtype == want[k].dtype, k
        rel = 1e-4 if k.startswith(_TWO_D) or k in fitted else 1e-5
        scale = max(float(np.abs(want[k]).max(initial=0.0)), 1e-30)
        err = float(np.abs(got[k].astype(np.float64) - want[k]).max(initial=0.0))
        assert err <= rel * scale, (k, err, scale)
    meta = f"{split}_meta.json"
    assert os.path.exists(os.path.join(port_dir, meta)) == os.path.exists(
        os.path.join(jax_dir, meta))
    if os.path.exists(os.path.join(jax_dir, meta)):
        assert json.load(open(os.path.join(port_dir, meta))) == json.load(
            open(os.path.join(jax_dir, meta)))


# --- the reference's preprocessed layout (pack_data) ------------------------

def test_pack_reference_dataset_matches_jax(official_tree, tmp_path):
    """`test_pack_reference_layout`'s fixture (256² noise JPEGs, PCA pose
    + root R, a camera per frame) plus one 300x200 frame that is resized."""
    from renderih_tpu.data.interhand import pack_reference_dataset

    root, split, _ = official_tree
    rng = np.random.default_rng(3)
    src = tmp_path / "refdata"
    for d in ("img", "anno", "ori_handdict"):
        (src / split / d).mkdir(parents=True)
    for i, (h, w) in enumerate(((256, 256), (256, 256), (200, 300))):
        img = rng.integers(0, 255, (h, w, 3), np.uint8)
        assert cv.imwrite(str(src / split / "img" / f"{i}.jpg"), img)
        with open(src / split / "anno" / f"{i}.pkl", "wb") as f:
            pickle.dump({}, f)
        hd = {}
        for hand in ("left", "right"):
            hd[hand] = {
                "verts3d": rng.normal(size=(778, 3)).astype(np.float32),
                "joints3d": rng.normal(size=(21, 3)).astype(np.float32),
                "verts2d": rng.uniform(0, 256, (778, 2)).astype(np.float32),
                "joints2d": rng.uniform(0, 256, (21, 2)).astype(np.float32),
                "R": cv.Rodrigues(rng.normal(0.0, 0.3, 3))[0][None].astype(np.float32),
                "pose": rng.normal(0.0, 0.5, (1, 45)).astype(np.float32),
                "shape": rng.normal(0.0, 0.5, (1, 10)).astype(np.float32),
                "camera": np.eye(3, dtype=np.float32),
            }
        np.save(src / split / "ori_handdict" / f"{i}.npy", hd)
    mano = ["--mano-left", str(root / "mano_left.npz"), "--mano-right", str(root / "mano_right.npz")]
    assert pack_data.main(["--data", str(src), "--split", split,
                           "--out", str(tmp_path / "port")] + mano) == 3
    assert pack_reference_dataset(str(src), split, str(tmp_path / "jax"),
                                  mano_left=mano[1], mano_right=mano[3]) == 3
    assert_packed_equal(tmp_path / "port", tmp_path / "jax", split)
    assert "camera_in" in np.load(tmp_path / "port" / f"{split}_labels.npz").files


# --- MANO pickle conversion (convert_assets) ---------------------------------

class _Chumpy:
    """Stands in for a chumpy array: the value sits in `.r`."""

    def __init__(self, r):
        self.r = r


def test_convert_assets_matches_jax(tmp_path):
    """convert_mano_pkl on pickles written from the synthetic MANO (chumpy
    shapedirs, scipy-sparse J_regressor, *_RIGHT/*_LEFT names): the npz
    equals JAX's key by key, bit for bit; the graphs rebuilt from the faces
    equal the JAX tool's (the rescaled Laplacians within 1e-5: the two
    coarsening ports sum in different orders)."""
    from renderih_tpu.mano.params import convert_mano_pkl as jax_convert

    from renderih_tpu_torch.mano.params import MANO_PARENTS, make_synthetic_mano

    paths = {}
    for hand in ("left", "right"):
        m = make_synthetic_mano(seed=0, is_right=hand == "right")
        kintree = np.zeros((2, 16), np.int64)
        kintree[0] = [2 ** 32 - 1] + list(MANO_PARENTS[1:])
        kintree[1] = np.arange(16)
        data = {
            "v_template": m.v_template.numpy().astype(np.float64),
            "shapedirs": _Chumpy(m.shapedirs.numpy().astype(np.float64)),
            "posedirs": m.posedirs.numpy().astype(np.float64),
            "J_regressor": scipy.sparse.csc_matrix(m.J_regressor.numpy().astype(np.float64)),
            "weights": m.weights.numpy().astype(np.float64),
            "hands_components": m.hands_components.numpy().astype(np.float64),
            "hands_mean": m.hands_mean.numpy().astype(np.float64),
            "f": m.faces.numpy().astype(np.uint32),
            "kintree_table": kintree,
        }
        paths[hand] = tmp_path / f"MANO_{hand.upper()}.pkl"
        with open(paths[hand], "wb") as f:
            pickle.dump(data, f)
    convert_assets.main(["--mano-left", str(paths["left"]), "--mano-right", str(paths["right"]),
                         "--out", str(tmp_path / "port")])
    _run_jax_main(_jax_tool("convert_assets", os.path.join(_ROOT, "tools")),
                  ["--mano-left", str(paths["left"]), "--mano-right", str(paths["right"]),
                   "--out", str(tmp_path / "jax")])
    for hand in ("left", "right"):
        jax_convert(str(paths[hand]), str(tmp_path / f"direct_{hand}.npz"))
        for name in (f"mano_{hand}.npz", f"graph_{hand}.npz"):
            got, want = np.load(tmp_path / "port" / name), np.load(tmp_path / "jax" / name)
            assert sorted(got.files) == sorted(want.files), name
            for k in want.files:
                assert got[k].dtype == want[k].dtype, (name, k)
                if k.startswith("laplacian"):  # float32 sums of two coarsen ports
                    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=1e-5,
                                               err_msg=f"{name}:{k}")
                else:
                    np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}:{k}")
        direct = np.load(tmp_path / f"direct_{hand}.npz")
        got = np.load(tmp_path / "port" / f"mano_{hand}.npz")
        for k in direct.files:
            np.testing.assert_array_equal(got[k], direct[k], err_msg=k)
        assert bool(got["is_right"]) == (hand == "right")


# --- the official InterHand2.6M release (interhand_gen) -----------------------

@pytest.mark.parametrize("hand_type", ["interacting", "right", "left"])
def test_interhand_gen_matches_jax(official_tree, tmp_path, monkeypatch, hand_type):
    root, split, _ = official_tree
    crops = []

    def warp(img, M, size):  # every crop is cv2's warp under the port's matrix
        out = interhand_gen.warp_affine_u8.__wrapped__(img, M, size)
        assert np.array_equal(out, cv.warpAffine(img, M, dsize=size))
        crops.append(out)
        return out

    warp.__wrapped__ = interhand_gen.warp_affine_u8
    monkeypatch.setattr(interhand_gen, "warp_affine_u8", warp)
    port_n = interhand_gen.main(_gen_argv(root, split, tmp_path / "port", hand_type)
                                + ["--device", "cpu"])
    _jax_tool("interhand_gen").main(_gen_argv(root, split, tmp_path / "jax", hand_type))
    assert port_n == len(crops) == {"interacting": 2, "right": 1, "left": 0}[hand_type]
    assert_packed_equal(tmp_path / "port", tmp_path / "jax", split, mano_crop=True)


def _pose_length(data, cams, mano):
    mano["0"]["100"]["right"]["pose"] = [0.0] * 45


def _non_numeric_trans(data, cams, mano):
    mano["1"]["201"]["left"]["trans"] = ["a", "b", "c"]


def _non_dict(data, cams, mano):
    mano["0"]["100"]["right"] = [1.0, 2.0]


def _unknown_image_id(data, cams, mano):
    data["annotations"][0]["image_id"] = 999


def _missing_camera(data, cams, mano):
    del cams["0"]["campos"]["400002"]


def _nested(data, cams, mano):
    for frame in (f for cap in mano.values() for f in cap.values() if f):
        for hand in (h for h in frame.values() if h):
            hand["pose"] = [hand["pose"]]
            hand["shape"] = [hand["shape"]]


@pytest.mark.parametrize("mutate", [_pose_length, _non_numeric_trans, _non_dict,
                                    _unknown_image_id, _missing_camera, "missing_image",
                                    _nested])
def test_interhand_gen_clear_errors_match_jax(official_tree, tmp_path, mutate):
    """Each malformed tree of test_interhand_gen.py fails in the port with
    the JAX tool's exception type; the nested (1, 48) exports pack alike."""
    if mutate == "missing_image":
        root, split = _clone_tree(official_tree, tmp_path, lambda *a: None)
        (root / "images" / split / "Capture0" / "cam400002" / "image100.png").unlink()
    else:
        root, split = _clone_tree(official_tree, tmp_path, mutate)
    outcome = {}
    for who, run in (("port", lambda out: interhand_gen.main(
                          _gen_argv(root, split, out) + ["--device", "cpu"])),
                     ("jax", lambda out: _jax_tool("interhand_gen").main(
                          _gen_argv(root, split, out)))):
        try:
            run(tmp_path / who)
            outcome[who] = None
        except Exception as e:  # noqa: BLE001 - the type is what is compared
            outcome[who] = type(e)
    assert outcome["port"] is outcome["jax"], outcome
    if mutate is _nested:
        assert outcome["port"] is None
        assert_packed_equal(tmp_path / "port", tmp_path / "jax", split, mano_crop=True)
    else:
        assert outcome["port"] in (ValueError, FileNotFoundError)


# --- per-frame hand dicts (handdict_gen) and Tzionas (tzionas_gen) ------------

def _hand(rng, joints_only=False):
    h = {"joints3d": rng.normal(0.0, 0.05, (21, 3)).astype(np.float32)}
    if not joints_only:
        h.update(verts3d=rng.normal(size=(778, 3)).astype(np.float32),
                 verts2d=rng.uniform(0, 256, (778, 2)).astype(np.float32),
                 joints2d=rng.uniform(0, 256, (21, 2)).astype(np.float32),
                 pose=rng.normal(0.0, 0.3, (1, 48)).astype(np.float32),
                 shape=rng.normal(0.0, 0.3, (1, 10)).astype(np.float32))
    return h


def _layout_a(path, split, rng, n=3):
    for d in ("img", "ori_handdict"):
        (path / split / d).mkdir(parents=True)
    for i in range(n):
        size = ((256, 256), (480, 640), (120, 100))[i % 3]
        assert cv.imwrite(str(path / split / "img" / f"{i}.jpg"),
                          rng.integers(0, 255, size + (3,), np.uint8),
                          [cv.IMWRITE_JPEG_QUALITY, 95])
        np.save(path / split / "ori_handdict" / f"{i}.npy",
                {"left": _hand(rng), "right": _hand(rng, joints_only=i == 1)})


def _layout_b(path, rng, n=3, joints_only=False):
    (path / "all").mkdir(parents=True)
    for i in range(n):
        size = ((256, 256), (300, 400), (512, 512))[i % 3]
        np.save(path / "all" / f"{i}.npy", {
            "img": rng.integers(0, 255, size + (3,), np.uint8),
            "left": _hand(rng, joints_only), "right": _hand(rng, joints_only)})


@pytest.mark.parametrize("layout", ["A", "B", "from_joints"])
def test_handdict_gen_matches_jax(tmp_path, layout):
    """Layout A (JPEGs of three sizes, one joints-only right hand), layout B
    (embedded BGR images, resized and the 2x area path), and --from_joints
    on layout A, fitted at 5 IK steps (the IK is chaotic at 200)."""
    rng = np.random.default_rng(5)
    data, split = tmp_path / "raw", "test"
    if layout == "B":
        _layout_b(data, rng)
    else:
        _layout_a(data, split, rng)
    argv = ["--data", str(data), "--split", split]
    extra = ["--from_joints", "--ik_iters", "5"] if layout == "from_joints" else []
    assert handdict_gen.main(argv + ["--out", str(tmp_path / "port"), "--device", "cpu"]
                             + extra) == 3
    _run_jax_main(_jax_tool("handdict_gen"), argv + ["--out", str(tmp_path / "jax")] + extra)
    fitted = ("v3d_right", "pose_right", "shape_right") if extra else ()
    assert_packed_equal(tmp_path / "port", tmp_path / "jax", split, fitted=fitted)


def test_tzionas_gen_matches_jax(tmp_path):
    rng = np.random.default_rng(6)
    _layout_b(tmp_path / "raw", rng)
    argv = ["--data", str(tmp_path / "raw")]
    assert tzionas_gen.main(argv + ["--out", str(tmp_path / "port")]) == 3
    _run_jax_main(_jax_tool("tzionas_gen"), argv + ["--out", str(tmp_path / "jax")])
    assert_packed_equal(tmp_path / "port", tmp_path / "jax", "test")


# --- Ego3DHands and H2O3D (other_datasets_gen) --------------------------------

def _ego3d_tree(path, rng):
    """test_other_datasets_gen.py's Ego3DHands fixture (480x640 PNGs)."""
    for i in range(3):
        d = path / f"seq{i}"
        d.mkdir(parents=True)
        cv.imwrite(str(d / "color_new.png"), rng.integers(0, 255, (480, 640, 3), np.uint8))
        np.save(d / "location_2d.npy", rng.uniform(0.2, 0.8, (2, 22, 2)))
        np.save(d / "location_3d_canonical.npy", rng.normal(size=(2, 22, 3)))


def _h2o3d_tree(path, rng):
    """test_other_datasets_gen.py's H2O3D fixture (480x640 noise JPEGs)."""
    seq, meta_dir = path / "train" / "ABC1" / "rgb", path / "train" / "ABC1" / "meta"
    seq.mkdir(parents=True)
    meta_dir.mkdir(parents=True)
    names = []
    for i in range(2):
        f = f"{i:04d}"
        names.append(f"ABC1/{f}")
        cv.imwrite(str(seq / (f + ".jpg")), rng.integers(0, 255, (480, 640, 3), np.uint8))
        anno = {
            "camMat": np.array([[600.0, 0, 320.0], [0, 600.0, 240.0], [0, 0, 1]]),
            "rightHandJoints3D": rng.normal(0, 0.03, (21, 3)) + [0, 0, -0.5],
            "leftHandJoints3D": rng.normal(0, 0.03, (21, 3)) + [0.1, 0, -0.5],
            "rightHandPose": rng.normal(0, 0.1, (48,)),
            "leftHandPose": rng.normal(0, 0.1, (48,)),
            "rightHandTrans": np.array([0.0, 0.0, -0.5]),
            "leftHandTrans": np.array([0.1, 0.0, -0.5]),
            "handBeta": rng.normal(0, 0.5, (10,)),
        }
        with open(meta_dir / (f + ".pkl"), "wb") as fh:
            pickle.dump(anno, fh)
    with open(path / "train.txt", "w") as fh:
        fh.write("\n".join(names) + "\n")


@pytest.mark.parametrize("case", ["ego3d", "h2o3d", "h2o3d_mano"])
def test_other_datasets_gen_matches_jax(official_tree, tmp_path, case):
    rng = np.random.default_rng(8)
    data = tmp_path / "raw"
    jax_tool = _jax_tool("other_datasets_gen")
    if case == "ego3d":
        _ego3d_tree(data, rng)
        ns = dict(data=str(data), split="train", limit=None)
        assert other_datasets_gen.main(["ego3d", "--data", str(data), "--out",
                                        str(tmp_path / "port")]) == 3
        jax_tool.convert_ego3d(argparse.Namespace(out=str(tmp_path / "jax"), **ns))
    else:
        _h2o3d_tree(data, rng)
        root = official_tree[0]
        mano = ([str(root / "mano_left.npz"), str(root / "mano_right.npz")]
                if case == "h2o3d_mano" else [None, None])
        argv = ["h2o3d", "--data", str(data), "--out", str(tmp_path / "port"), "--device", "cpu"]
        if mano[0]:
            argv += ["--mano-left", mano[0], "--mano-right", mano[1]]
        assert other_datasets_gen.main(argv) == 2
        jax_tool.convert_h2o3d(argparse.Namespace(
            data=str(data), mode="train", split="train", out=str(tmp_path / "jax"),
            mano_left=mano[0], mano_right=mano[1], limit=None))
    assert_packed_equal(tmp_path / "port", tmp_path / "jax", "train")
