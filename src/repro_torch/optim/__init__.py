from repro_torch.optim.optimizers import (  # noqa: F401
    adamw_init, adamw_update, clip_by_global_norm, cosine_schedule,
    sgd_init, sgd_update)
