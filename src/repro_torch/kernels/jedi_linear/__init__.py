"""JEDI-linear: O(N_o) interaction aggregation (kernel B2's package).

Port of ``repro.kernels.jedi_linear``.  JEDI-linear (arXiv 2508.15468)
keeps f_R's first layer linear, so the pairwise message sum commutes
with it and the N_o x (N_o-1) edge grid collapses into one pooled
sender projection.  Modules:

* ``ref.py``           — plain PyTorch forwards: the O(N_o) pooled path
  and its O(N_o^2) edge-sum oracle.
* ``linear_kernel.py`` — the wrapper of the hand-written CUDA kernel
  ``kernels/csrc/jedi_linear_full.cu`` and its plain version.
* ``ops.py``           — the public entry (bind once, launch per batch).
* ``autotune.py``      — the kernel's shared-memory layout.

The paths register in ``repro_torch.core.jedi_linear_path``.
"""
