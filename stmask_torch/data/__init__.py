"""Device-side batch preparation for training (the torch half of
``stmask_tpu/data/transforms.py``)."""
