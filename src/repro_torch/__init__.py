"""PyTorch + CUDA port of the ``repro`` serving path for NVIDIA Hopper.

Module names mirror ``repro`` so each file has an obvious counterpart;
the package imports torch, numpy and the standard library only.
"""
