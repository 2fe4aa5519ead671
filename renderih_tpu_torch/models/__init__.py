from renderih_tpu_torch.models.model import (  # noqa: F401
    HandNet,
    build_model,
    init_model,
    model_call_kwargs,
)
