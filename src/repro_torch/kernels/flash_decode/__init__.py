"""Flash decode: one-token GQA attention over a KV cache (kernel B5's
package).

Port of ``repro.kernels.flash_decode``.  Modules:

* ``ref.py``    — the plain PyTorch version (one softmax over the whole
  sequence, the reference's finite ``NEG_INF`` mask).
* ``kernel.py`` — the wrapper of the hand-written CUDA kernel
  ``kernels/csrc/flash_decode.cu`` and its shared-memory plan.
* ``ops.py``    — the public entry ``flash_decode(q, k, v, q_pos, kv_pos)``.

In the reference no model path calls it: its LM decode step attends
through ``nn/attention.py``.  The port's decode step
(``models/transformer.py``) launches it once per layer on the card, on
the same function at one query position; ``ops.flash_decode`` is its
own entry point.
"""
