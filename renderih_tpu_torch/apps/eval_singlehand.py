"""Single-hand evaluation (counterpart of `renderih_tpu/apps/eval_singlehand.py`;
reference `apps/eval_singlehand.py`).

Runs the standard evaluator over a packed single-hand dataset (the absent
hand's labels are zeros) and prints the chosen hand's metrics as JSON.

    python -m renderih_tpu_torch.apps.eval_singlehand [--data P/] [--hand right] \
        [--ckpt DIR | --torch_ckpt PTH] [--device cuda|cpu]
"""

from __future__ import annotations

import json

from renderih_tpu_torch.apps.eval_interhand import build_parser, run_eval

SYNTHETIC_N = 64


def main(argv=None) -> dict:
    p = build_parser(bs=256)
    p.add_argument("--hand", choices=["left", "right"], default="right")
    args = p.parse_args(argv)
    summary = run_eval(args, SYNTHETIC_N)
    h = args.hand
    out = {"hand": h, **{f"{key}_mm": float(summary[f"{key}_{h}_mm"]) for key in (
        "ori_mpjpe", "ori_mpvpe", "mpjpe", "mpvpe", "pa_mpjpe", "pa_mpvpe")},
        "images_per_sec": float(summary["images_per_sec"])}
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
