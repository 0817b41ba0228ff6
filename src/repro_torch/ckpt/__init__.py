from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager, load_checkpoint, save_checkpoint)
