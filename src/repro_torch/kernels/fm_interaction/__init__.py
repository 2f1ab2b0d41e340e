"""FM pairwise interaction (kernel B4's package).

Port of ``repro.kernels.fm_interaction``.  Modules:

* ``ref.py``    — the plain PyTorch version (the sum-square identity).
* ``kernel.py`` — the wrapper of the hand-written CUDA kernel
  ``kernels/csrc/fm_interaction.cu`` and its shared-memory plan.
* ``ops.py``    — the public entry ``fm_interaction(v)``.

``repro_torch.models.recsys.forward(use_kernel=True)`` reaches it.
"""
