"""The model path (port of ``repro/models``): shared layers, the Mamba-1
block, GQA attention (global and sliding-window) with the SwiGLU MLP, and
the decoder stack.  Mamba-2 and the shared block (ROADMAP.md A3.2), MLA
and MoE (A3.3) are still to port."""
