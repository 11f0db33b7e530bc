"""Group sharding (``sharding_api``, ``sharding``)."""
from .sharding import (GroupShardedOptimizerStage2,  # noqa: F401
                       GroupShardedStage2, GroupShardedStage3)
from .sharding_api import (group_sharded_parallel,  # noqa: F401
                           save_group_sharded_model)
