"""Hand-written Hopper kernels and their plain PyTorch versions:

  quant8     -- block int8 quantize / error-feedback quantize / dequantize /
                dequantize-accumulate, CUDA C++ in csrc/quant8.cu
  flashattn  -- online-softmax attention (forward), CUDA C++ in
                csrc/flashattn.cu
  ops        -- shape-polymorphic wrappers with the backend policy
  ref        -- plain PyTorch versions (the CPU path and the kernels'
                yardstick)
"""
