"""The stereo training step (``planedepth_tpu/train/``)."""
