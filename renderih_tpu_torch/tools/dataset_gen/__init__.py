"""Raw dataset trees -> the packed layout (`data/interhand.py`), without
JAX or cv2 (counterparts of `tools/dataset_gen/`)."""
