from repro_torch.optim.adamw import adamw_init, adamw_update, global_norm  # noqa: F401
