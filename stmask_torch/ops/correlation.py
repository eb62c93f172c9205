"""Cross-frame local correlation (port of
``stmask_tpu/ops/correlation.py::correlate``).

For every site, the channel dot product between frame-1 features and
frame-2 features displaced by (dy, dx) in [-r, r]^2, zero outside the image,
output channel ``(dy+r)*patch + (dx+r)``, divided by the channel count and
passed through leaky-relu(0.1) (reference
``layers/modules/track_to_segment_head.py:40-62``).  A CPU tensor takes the
plain PyTorch version; a CUDA tensor takes kernel K1.
"""

from ..kernels.correlation import correlate  # noqa: F401
