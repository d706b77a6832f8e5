"""Compute ops: plain attention, and the kernels of the serving, training and eval paths.

  spatial        — K1, the fused spatial stack, with droppath scales in training
                   (replaces pallas_spatial.fused_spatial_stack)
  temporal       — K2, the temporal stack (replaces pallas_temporal_v3.fused_temporal_stack_v3)
  strided        — K3, strided block 1 (replaces pallas_strided.make_strided_b1_epilogue)
  spatial_bwd    — K4, the spatial stack's backward
                   (replaces pallas_spatial_bwd.fused_spatial_stack_bwd)
  temporal_train — K5, the temporal stack's training forward and backward
                   (replaces pallas_temporal_bwd.fused_temporal_stack_train)
  strided_train  — K6, strided block 1's training forward and backward
                   (replaces pallas_strided_bwd.fused_strided_block1_train)
  packed_attention — row 11, multi-head attention on packed q, k, v, behind
                   USE_PALLAS_ATTENTION (replaces pallas_attention.packed_multihead_attention)
  camera         — world→camera transform and 2D projection of AMASS batches (plain)

Each kernel wrapper runs the CUDA kernel on a CUDA tensor (or raises) and its
plain PyTorch version on a CPU tensor. `cuda_lib.LAUNCHES` counts the kernel
launches per wrapper.
"""
