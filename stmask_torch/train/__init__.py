"""Training of the flagship: losses, schedule, the train step, checkpoints
and the loop (port of ``stmask_tpu/train`` and ``train.py``)."""
