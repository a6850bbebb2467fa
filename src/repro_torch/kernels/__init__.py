"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref.py``) and the dispatch between them (``ops.py``).

* flash-attention forward: ``csrc/flash_attention_fwd.cu`` (CUDA C++ for
  sm_90a), wrapped by ``flash_attention.py``; replaces the reference's TPU
  kernel ``flash_attention.py::flash_attention_fwd``.
* LayerNorm: Triton, in ``rmsnorm.py``; replaces the reference's TPU
  kernel ``rmsnorm.py::layernorm``.
"""
