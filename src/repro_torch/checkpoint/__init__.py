from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    save_checkpoint, restore_checkpoint, latest_step, AsyncCheckpointer,
)
