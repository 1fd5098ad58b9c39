"""PyTorch and CUDA port of typeagent-tpu's exact vector-search serving path.

The JAX package ``typeagent_tpu`` is the reference; this package mirrors
its module names. It holds the device-resident embedding store
(``vectorstore.VectorStore``), its coalescing server
(``serve.LookupBatcher``) and the hand-written Hopper kernels under them
(``ops/topk.py``, sources in ``csrc/``). It imports torch, numpy and the
standard library only; kernels build at first use, never at import.
"""
