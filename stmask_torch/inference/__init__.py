"""Video inference: detect, track, postprocess."""

from .pipeline import build_video_step  # noqa: F401
from .postprocess import postprocess_frame, results2json_videoseg  # noqa: F401
