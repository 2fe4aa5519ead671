"""Convert the reference's binary assets into the npz files the port
loads (counterpart of `tools/convert_assets.py`).

  python -m renderih_tpu_torch.tools.convert_assets --mano-left MANO_LEFT.pkl \
      --mano-right MANO_RIGHT.pkl --out assets/ \
      [--graph-left graph_left.pkl --graph-right graph_right.pkl] \
      [--upsample upsample.pkl] [--dense-color v_color.pkl] [--anchor-dir DIR]

Outputs mano_left.npz, mano_right.npz, graph_left.npz, graph_right.npz
and, when asked, upsample.npz, dense_color.npz and anchors.npz, which
`AssetConfig` paths name. Without --graph-*, the coarsened graphs are
rebuilt from the MANO faces by the port's deterministic HEM pipeline
(`graph/coarsen.py:build_graph_levels`, reference
`models/model_zoo/coarsening.py:397-428`). A real MANO pickle needs the
`chumpy` package to unpickle. Host code only.
"""

from __future__ import annotations

import argparse
import os
import pickle

import numpy as np

from renderih_tpu_torch.graph.coarsen import build_graph_levels, load_reference_graph_pkl
from renderih_tpu_torch.mano.params import convert_mano_pkl


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--mano-left", required=True)
    p.add_argument("--mano-right", required=True)
    p.add_argument("--graph-left", default=None)
    p.add_argument("--graph-right", default=None)
    p.add_argument("--upsample", default=None)
    p.add_argument("--dense-color", default=None)
    p.add_argument("--anchor-dir", default=None,
                   help="reference pose_data_optimize/assets/anchor dir "
                        "(face_vertex_idx/anchor_weight/merged_vertex_assignment txt files)")
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    convert_mano_pkl(args.mano_left, os.path.join(args.out, "mano_left.npz"))
    convert_mano_pkl(args.mano_right, os.path.join(args.out, "mano_right.npz"))
    print("converted MANO pkls")

    for hand, pkl_path in (("left", args.graph_left), ("right", args.graph_right)):
        out_path = os.path.join(args.out, f"graph_{hand}.npz")
        if pkl_path:
            g = load_reference_graph_pkl(pkl_path)
            print(f"loaded reference graph_{hand}.pkl: {g.node_counts}")
        else:
            mano = np.load(os.path.join(args.out, f"mano_{hand}.npz"))
            g = build_graph_levels(np.asarray(mano["faces"]), levels=4)
            print(f"built graph_{hand} from faces: {g.node_counts}")
        g.save_npz(out_path)

    if args.upsample:
        with open(args.upsample, "rb") as f:
            w = pickle.load(f)
        np.savez(os.path.join(args.out, "upsample.npz"), weight=np.asarray(w, np.float32))
        print("converted upsample weights", np.asarray(w).shape)

    if args.dense_color:
        with open(args.dense_color, "rb") as f:
            c = pickle.load(f)
        np.savez(os.path.join(args.out, "dense_color.npz"), color=np.asarray(c, np.float32))
        print("converted dense color", np.asarray(c).shape)

    if args.anchor_dir:
        from renderih_tpu_torch.optimize.anchors import load_anchor_txt

        spec = load_anchor_txt(args.anchor_dir)
        np.savez(os.path.join(args.out, "anchors.npz"),  # the JAX package's dtypes
                 tri_idx=spec.tri_idx.numpy().astype(np.int32), weights=spec.weights.numpy(),
                 classes=spec.classes.numpy().astype(np.int32))
        print("converted anchors", np.asarray(spec.tri_idx).shape)

    print(f"assets written to {args.out}")


if __name__ == "__main__":
    main()
