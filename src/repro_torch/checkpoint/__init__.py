from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    CheckpointManager,
    load_pytree,
    save_pytree,
)
