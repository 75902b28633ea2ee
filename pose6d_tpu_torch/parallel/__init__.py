"""Data-parallel training and process-sharded evaluation over
torch.distributed (port of pose6d_tpu/parallel/)."""
from .mesh import (make_mesh, make_parallel_forward,  # noqa: F401
                   make_parallel_train_step, replicate, shard_batch)
from .multihost import (allreduce_metric_sums, init_multihost,  # noqa: F401
                        shard_frame_list)
