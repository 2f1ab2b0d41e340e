"""Flash decode: one-token GQA attention over a KV cache (kernel B5's
package).

Port of ``repro.kernels.flash_decode``.  Modules:

* ``ref.py``    — the plain PyTorch version (one softmax over the whole
  sequence, the reference's finite ``NEG_INF`` mask).
* ``kernel.py`` — the wrapper of the hand-written CUDA kernel
  ``kernels/csrc/flash_decode.cu`` and its shared-memory plan.
* ``ops.py``    — the public entry ``flash_decode(q, k, v, q_pos, kv_pos)``.

In the reference, as here, no model path calls it: the LM's decode step
goes through ``nn/attention.py``.  ``ops.flash_decode`` is its entry point.
"""
