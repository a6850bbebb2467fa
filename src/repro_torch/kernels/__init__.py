"""Hand-written Hopper kernels of the port, their plain PyTorch versions
(``ref.py``) and the dispatch between them (``ops.py``).

* flash-attention forward and backward: ``csrc/flash_attention_fwd.cu`` and
  ``csrc/flash_attention_bwd.cu`` (CUDA C++ for sm_90a), wrapped by
  ``flash_attention.py``; replace the reference's TPU kernels
  ``flash_attention.py::flash_attention_fwd`` / ``flash_attention_bwd``.
* fused cross-entropy forward and backward: ``csrc/cross_entropy.cu``
  (CUDA C++ for sm_90a on the wgmma + TMA GEMM mainloop of
  ``csrc/ce_gemm.cuh``), wrapped by ``cross_entropy.py``; replace the
  reference's ``cross_entropy.py::fused_cross_entropy`` /
  ``fused_cross_entropy_bwd``.
* LayerNorm: ``csrc/layernorm.cu`` (CUDA C++ for sm_90a: Triton's
  launcher cost 20-40× the norm's device time at the decode shapes),
  wrapped by ``rmsnorm.py``; replaces the reference's TPU kernel
  ``rmsnorm.py::layernorm``.  Its backward (``layernorm_bwd``, same
  source) is the port's own: the reference pairs its Pallas forward with
  an XLA backward.
* RMSNorm: ``csrc/rmsnorm.cu`` (CUDA C++ for sm_90a, for the same reason),
  wrapped by ``rmsnorm.py``; replaces ``rmsnorm.py::rmsnorm``.
* flash-decoding: ``csrc/flash_decode.cu`` (CUDA C++ for sm_90a: cp.async
  rings of 16-key K/V stages, mma.sync products, an online softmax in one
  pass, in ``csrc/decode_split.cuh``), wrapped by ``flash_decode.py``;
  replaces ``flash_decode.py::flash_decode``.
* fused sampling: ``csrc/sampling.cu`` (CUDA C++ for sm_90a: a cluster of
  blocks a row over distributed shared memory), wrapped by
  ``sampling.py``; replaces ``sampling.py::fused_sample``.
* paged-KV attention: ``csrc/paged_attention.cu`` (CUDA C++ for sm_90a; the
  decode on flash-decoding's split body, addressed through the block
  table), wrapped by ``paged_attention.py``; its decode, chunk-prefill and
  K/V-insert kernels replace ``paged_attention.py::paged_flash_decode``,
  ``paged_flash_prefill`` and ``paged_kv_write``.
* ragged grouped matmul: ``csrc/grouped_matmul.cu`` (CUDA C++ for sm_90a),
  wrapped by ``grouped_matmul.py``; replaces ``grouped_matmul.py::gmm``.
* Mamba-2 SSD chunked scan: ``csrc/ssd_scan.cu`` (CUDA C++ for sm_90a),
  wrapped by ``ssd_scan.py``; replaces ``ssd_scan.py::ssd_scan``.
* its backward: ``csrc/ssd_scan_bwd.cu`` (CUDA C++ for sm_90a), wrapped by
  ``ssd_scan.py`` (``ssd_scan_bwd``, the ``SSDScan`` autograd Function);
  the port's own, as the reference's TPU kernel has no backward (it
  differentiates its jnp scan).
"""
