"""Hand-written Hopper kernels for FiCCO's performance-critical layers.

  * chunked_gemm  — K1, the tiled fp32-accumulating GEMM (the DMA
                    schedule's step GEMM), ``csrc/chunked_gemm.cu``
  * dma_exchange  — K3, the copy-engine chunk all-to-all (the paper's DMA
                    offload), ``csrc/dma_exchange.cu``, and the
                    uniform-fused-1D composer
  * ops / ref     — public wrappers + plain PyTorch versions
  * _build        — nvcc build into ``build/kernels`` and ctypes loading
"""
