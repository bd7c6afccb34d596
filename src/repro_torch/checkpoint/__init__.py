from repro_torch.checkpoint.ckpt import (
    CheckpointError,
    CheckpointManager,
    latest_step,
    load_checkpoint,
    load_leaf,
    save_checkpoint,
)
