"""Frame-parallel and pipelined SIFT frontends (BASELINE config 3), port of
``sift_pyocl_tpu/parallel/video.py`` and ``pipeline_octaves.py``."""

from .pipeline_octaves import TwoStagePipeline  # noqa: F401
from .video import (FramesMesh, VideoSiftFrontend, batched_sift,  # noqa: F401
                    make_frames_mesh, sharded_sift_fn)
