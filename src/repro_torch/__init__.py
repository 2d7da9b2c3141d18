"""PyTorch/CUDA port of the `repro` package for NVIDIA Hopper GPUs.

Mirrors the module paths of `repro` (the JAX reference, which stays as it
is): `repro_torch.core.engine` ports `repro.core.engine`, and so on. The port
imports `torch` and nothing of JAX or of `repro`. Its entry points run on
`cuda` unless the caller passes `device="cpu"`.
"""
