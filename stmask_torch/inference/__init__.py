"""Video inference: detect, track, postprocess."""

from .pipeline import (  # noqa: F401
    build_video_step, build_video_step_batched, cast_model)
from .postprocess import postprocess_frame, results2json_videoseg  # noqa: F401
