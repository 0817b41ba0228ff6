from repro_torch.train.step import (  # noqa: F401
    TrainConfig, init_train_state, make_train_step)
