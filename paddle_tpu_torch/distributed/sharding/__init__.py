"""``paddle.distributed.sharding`` (counterpart of
``paddle_tpu/distributed/sharding``): ``group_sharded_parallel`` and
``save_group_sharded_model``, implemented in
``fleet/meta_parallel/sharding_api.py``."""
from ..fleet.meta_parallel.sharding_api import (  # noqa: F401
    group_sharded_parallel, save_group_sharded_model)

__all__ = ["group_sharded_parallel", "save_group_sharded_model"]
