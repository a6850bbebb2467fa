"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref.py``) and the dispatch between them (``ops.py``).

* flash-attention forward and backward: ``csrc/flash_attention_fwd.cu`` and
  ``csrc/flash_attention_bwd.cu`` (CUDA C++ for sm_90a), wrapped by
  ``flash_attention.py``; replace the reference's TPU kernels
  ``flash_attention.py::flash_attention_fwd`` / ``flash_attention_bwd``.
* fused cross-entropy forward and backward: ``csrc/cross_entropy.cu``
  (CUDA C++ for sm_90a), wrapped by ``cross_entropy.py``; replace the
  reference's ``cross_entropy.py::fused_cross_entropy`` /
  ``fused_cross_entropy_bwd``.
* LayerNorm and RMSNorm: Triton, in ``rmsnorm.py``; replace the
  reference's TPU kernels ``rmsnorm.py::layernorm`` / ``rmsnorm``.
* flash-decoding: ``csrc/flash_decode.cu`` (CUDA C++ for sm_90a), wrapped
  by ``flash_decode.py``; replaces ``flash_decode.py::flash_decode``.
* fused sampling: ``csrc/sampling.cu`` (CUDA C++ for sm_90a), wrapped by
  ``sampling.py``; replaces ``sampling.py::fused_sample``.
* paged-KV attention: ``csrc/paged_attention.cu`` (CUDA C++ for sm_90a),
  wrapped by ``paged_attention.py``; its decode, chunk-prefill and
  K/V-insert kernels replace ``paged_attention.py::paged_flash_decode``,
  ``paged_flash_prefill`` and ``paged_kv_write``.
"""
