from .fmap2pointmap import (naive_fmap2pointmap,
                            spatial_filtering_fmap2pointmap)
from .gnc import consistency_core, gnc_tls_pose
from .icp import icp_cloud_to_model, icp_point2point
from .kabsch import kabsch_umeyama, transform_residuals, triad_rigid
from .multistart import disambiguate_pose_depth, flip_hypotheses, so3_bank
from .ransac import ransac_pose
from .verify_pose import depth_consistency_score
from .zoomout import zoomout_refine

__all__ = ["naive_fmap2pointmap", "spatial_filtering_fmap2pointmap",
           "consistency_core", "gnc_tls_pose", "icp_cloud_to_model",
           "icp_point2point", "kabsch_umeyama", "transform_residuals",
           "triad_rigid", "ransac_pose", "disambiguate_pose_depth",
           "flip_hypotheses", "so3_bank", "depth_consistency_score",
           "zoomout_refine"]
