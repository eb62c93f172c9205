"""Tensor ops of the port (boxes, masks, sampling, deformable conv,
correlation, RoIAlign, NMS)."""
