"""The model path (port of ``repro/models``): shared layers, the Mamba-1
block and the decoder stack.  Attention, MoE and Mamba-2 are still to port
(ROADMAP.md item 16)."""
