"""SfM back end: two-view geometry, RANSAC, PnP, the pose graph, bundle
adjustment and incremental SfM (port of ``sift_pyocl_tpu/sfm``; the
distributed BA is still to come)."""

from .ba import BAObs, BAParams, lm_iteration, residuals, run_ba  # noqa: F401
from .evaluate import ate_rmse, camera_centers, umeyama_align  # noqa: F401
from .pipeline import IncrementalSfM, SfMResult  # noqa: F401
from .ransac import ransac, ransac_essential_normalized, ransac_homography  # noqa: F401
from .twoview import TwoViewInit, initialize_two_view  # noqa: F401
