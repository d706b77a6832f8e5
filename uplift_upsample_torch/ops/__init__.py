"""Compute ops: plain attention, and the three kernels of the serving path.

  spatial  — K1, the fused spatial stack (replaces pallas_spatial.fused_spatial_stack)
  temporal — K2, the temporal stack (replaces pallas_temporal_v3.fused_temporal_stack_v3)
  strided  — K3, strided block 1 (replaces pallas_strided.make_strided_b1_epilogue)

Each kernel wrapper runs the CUDA kernel on a CUDA tensor (or raises) and its
plain PyTorch version on a CPU tensor. `cuda_lib.LAUNCHES` counts the kernel
launches per wrapper.
"""
