"""Hand-written Hopper kernels of the port, each beside its plain version.

Importing this package registers the kernels as torch.library ops of the
pose6d_tpu_torch namespace (torch.ops.pose6d_tpu_torch.<name>), which an
exported artifact (serving.py) calls."""
from ._build import LAUNCHES, build_all, reset_launches
from .attention import (flash_cross_attention,
                        flash_cross_attention_backward,
                        flash_cross_attention_backward_plain,
                        flash_cross_attention_plain)
from .cdist import (masked_argmin_cdist, masked_argmin_cdist_plain,
                    masked_topk_cdist, masked_topk_cdist_plain)
from .consistency import (consistency_sum_rank_major,
                          consistency_sum_rank_major_plain,
                          masked_consistency_sum,
                          masked_consistency_sum_plain)
from .icp import icp_kabsch_update, icp_kabsch_update_plain
from .ransac import ransac_inlier_counts, ransac_inlier_counts_plain

__all__ = ["LAUNCHES", "build_all", "reset_launches",
           "flash_cross_attention", "flash_cross_attention_plain",
           "flash_cross_attention_backward",
           "flash_cross_attention_backward_plain",
           "masked_argmin_cdist", "masked_argmin_cdist_plain",
           "masked_topk_cdist", "masked_topk_cdist_plain",
           "consistency_sum_rank_major", "consistency_sum_rank_major_plain",
           "masked_consistency_sum", "masked_consistency_sum_plain",
           "ransac_inlier_counts", "ransac_inlier_counts_plain",
           "icp_kabsch_update", "icp_kabsch_update_plain"]
