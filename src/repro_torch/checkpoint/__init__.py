from repro_torch.checkpoint.checkpoint import (  # noqa: F401
    load_pytree,
    save_pytree,
    latest_checkpoint,
    save_server_state,
    load_server_state,
    load_server_meta,
)
