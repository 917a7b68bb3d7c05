"""PyTorch / CUDA port of the TSM point-cloud detector.

The package mirrors `tsm_det_pointcloud_tpu`'s module paths and class names;
it imports torch, numpy and yaml only. Kernels written by hand for Hopper
live in `csrc/` and are built at first use (`ops/_kernels.py`).
"""
