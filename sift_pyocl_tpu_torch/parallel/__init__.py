"""Frame-parallel and pipelined SIFT frontends (BASELINE config 3), the
multi-process bootstrap and meshes, and the row-sharded scale space: port of
``sift_pyocl_tpu/parallel/``."""

from .multihost import (BAMesh, DeviceMesh, frames_x_ba_mesh, global_ba_mesh,  # noqa: F401
                        initialize_multihost)
from .pipeline_octaves import TwoStagePipeline  # noqa: F401
from .spatial import join_rows, sharded_scale_space  # noqa: F401
from .video import (FramesMesh, VideoSiftFrontend, batched_sift,  # noqa: F401
                    make_frames_mesh, sharded_sift_fn)
