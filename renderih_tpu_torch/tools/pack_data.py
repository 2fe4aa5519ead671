"""Pack the reference's preprocessed InterHand2.6M tree into the packed
layout (counterpart of `tools/pack_data.py`).

  python -m renderih_tpu_torch.tools.pack_data --data DIR --split test --out P/ \
      [--limit N] [--mano-left mano_left.npz --mano-right mano_right.npz]

Input: {data}/{split}/img/{i}.jpg, {data}/{split}/ori_handdict/{i}.npy and
{data}/{split}/anno/{i}.pkl (which count the samples), the output of the
reference's `utils/dataset_gen/interhand.py --gen_anno`. Host code only:
images are decoded by the port's own reader (`data/image_io.py`).
"""

from __future__ import annotations

import argparse

from renderih_tpu_torch.data.interhand import pack_reference_dataset


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--mano-left", default=None,
                   help="MANO npz; needed to convert the reference's PCA pose "
                        "labels (else pose/shape stay zero)")
    p.add_argument("--mano-right", default=None)
    args = p.parse_args(argv)
    n = pack_reference_dataset(args.data, args.split, args.out, args.limit,
                               mano_left=args.mano_left, mano_right=args.mano_right)
    print(f"packed {n} samples -> {args.out}/{args.split}_*")
    return n


if __name__ == "__main__":
    main()
