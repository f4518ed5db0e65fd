"""The model path (port of ``repro/models``): shared layers, the Mamba-1
and Mamba-2 blocks, zamba2's weight-tied shared block, GQA attention
(global and sliding-window) and MLA, the SwiGLU MLP and the sort-dispatch
MoE, and the decoder stack: every config of ``repro_torch.configs``."""
