"""Multi-GPU distribution: meshes of ranks, sharded BA, sharded pose graph."""

from ucoslam_tpu_torch.parallel.distributed import global_mesh, init_distributed, is_primary  # noqa: F401
from ucoslam_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from ucoslam_tpu_torch.parallel.sharded_ba import shard_ba_problem, sharded_ba_solve  # noqa: F401
from ucoslam_tpu_torch.parallel.sharded_posegraph import (  # noqa: F401
    shard_pose_graph_problem,
    sharded_pose_graph_solve,
)
