"""Architecture registry (port of ``repro/configs/__init__.py``): importing
this package registers every assigned architecture.  The paper's own
HiStore configuration is ``configs/histore.py``."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeSpec, SHAPES, Stage, layer_plan, input_specs,
    shape_applicable, get_config, all_archs, register,
)

# Assigned architectures (one module per arch id).
from repro_torch.configs import zamba2_7b            # noqa: F401
from repro_torch.configs import internvl2_76b        # noqa: F401
from repro_torch.configs import mistral_large_123b   # noqa: F401
from repro_torch.configs import command_r_35b        # noqa: F401
from repro_torch.configs import gemma3_27b           # noqa: F401
from repro_torch.configs import mistral_nemo_12b     # noqa: F401
from repro_torch.configs import deepseek_v2_lite_16b # noqa: F401
from repro_torch.configs import kimi_k2_1t_a32b      # noqa: F401
from repro_torch.configs import musicgen_large       # noqa: F401
from repro_torch.configs import falcon_mamba_7b      # noqa: F401

ARCH_IDS = [
    "zamba2-7b", "internvl2-76b", "mistral-large-123b", "command-r-35b",
    "gemma3-27b", "mistral-nemo-12b", "deepseek-v2-lite-16b",
    "kimi-k2-1t-a32b", "musicgen-large", "falcon-mamba-7b",
]
