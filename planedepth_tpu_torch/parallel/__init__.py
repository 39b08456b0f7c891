"""Data-parallel training across ranks (``planedepth_tpu/parallel/``)."""
