"""Kernels of the port (CUDA sources in ``csrc/``) and their plain PyTorch versions.

Importing this package registers the ``planedepth_tpu_torch::`` custom ops of
the eval forward's two kernels (``disp_head``, ``head_epilogue`` and their
backwards), which a program saved by ``cli/export.py`` calls: import it
before ``torch.export.load``.  Nothing is compiled at import.
"""
from planedepth_tpu_torch.ops import disp_head, head_epilogue  # noqa: F401  (registers the ops)
