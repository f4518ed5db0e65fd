from repro_torch.roofline.analysis import (  # noqa: F401
    HW, HWSpec, active_params, model_flops, roofline_terms,
)
