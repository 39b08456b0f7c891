"""Data of the port: the KITTI reader, its transforms and image files, the loader, synthetic stereo batches."""
