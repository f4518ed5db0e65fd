from repro_torch.sharding.partition import (  # noqa: F401
    batch_pspec, cache_pspecs, dp_axes, input_pspecs, opt_pspecs,
    param_pspecs, per_device_bytes,
)
