"""Tzionas hand-hand evaluation (counterpart of
`renderih_tpu/apps/eval_tzionas.py`; reference `apps/eval_tzionas.py`): the
eval_interhand metric stack over a packed Tzionas dataset.

    python -m renderih_tpu_torch.apps.eval_tzionas [--ckpt DIR] --data packed_tzionas/
"""

from renderih_tpu_torch.apps.eval_interhand import main

if __name__ == "__main__":
    main()
