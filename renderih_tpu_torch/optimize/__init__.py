"""Offline two-hand pose optimisation (counterpart of
`renderih_tpu/optimize/`; the GAN naturalness prior waits for the port of
`models/aux_nets.py`)."""

from renderih_tpu_torch.optimize.anchors import (
    AnchorMatch,
    AnchorSpec,
    anchor_contact_loss,
    load_anchor_txt,
    make_synthetic_anchors,
    recover_anchors,
    search_anchor_pairs,
)
from renderih_tpu_torch.optimize.geo import (
    REFERENCE_SCHEDULE,
    GeoWeights,
    anchor_pairs,
    contact_loss,
    edge_preserve_loss,
    optimize_two_hands,
    pose_angle_limit_loss,
    repulsion_loss,
)

__all__ = [
    "AnchorMatch",
    "AnchorSpec",
    "REFERENCE_SCHEDULE",
    "GeoWeights",
    "anchor_contact_loss",
    "anchor_pairs",
    "contact_loss",
    "load_anchor_txt",
    "make_synthetic_anchors",
    "recover_anchors",
    "repulsion_loss",
    "search_anchor_pairs",
    "edge_preserve_loss",
    "pose_angle_limit_loss",
    "optimize_two_hands",
]
