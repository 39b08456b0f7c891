"""Data of the port: synthetic stereo batches (the KITTI reader is not ported yet)."""
