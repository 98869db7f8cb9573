"""Hand-written Hopper kernels for FiCCO's performance-critical layers.

  * chunked_gemm     — K1, the tiled fp32-accumulating GEMM (the DMA
                       schedule's step GEMM), and K2, the same GEMM folded
                       into an accumulator in place (the 2D schedule's
                       step), ``csrc/chunked_gemm.cu``
  * dma_exchange     — K3, the copy-engine chunk all-to-all (the paper's DMA
                       offload), ``csrc/dma_exchange.cu``, and the
                       uniform-fused-1D composer
  * ficco_ag_matmul  — K4, the all-gather and the step GEMM in one kernel,
                       ``csrc/ficco_ag_matmul.cu``
  * ops / ref        — public wrappers + plain PyTorch versions
  * _build           — nvcc build into ``build/kernels`` and ctypes loading
"""
