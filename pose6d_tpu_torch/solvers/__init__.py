from .fmap2pointmap import (naive_fmap2pointmap,
                            spatial_filtering_fmap2pointmap)
from .icp import icp_cloud_to_model, icp_point2point
from .kabsch import kabsch_umeyama, transform_residuals, triad_rigid
from .multistart import disambiguate_pose_depth, flip_hypotheses
from .ransac import ransac_pose
from .verify_pose import depth_consistency_score

__all__ = ["naive_fmap2pointmap", "spatial_filtering_fmap2pointmap",
           "icp_cloud_to_model", "icp_point2point", "kabsch_umeyama",
           "transform_residuals", "triad_rigid", "ransac_pose",
           "disambiguate_pose_depth", "flip_hypotheses",
           "depth_consistency_score"]
