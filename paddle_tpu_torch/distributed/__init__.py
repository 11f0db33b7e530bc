"""Multi-rank machinery of the port (counterpart of
``paddle_tpu/distributed``): :mod:`.process_mesh` (a mesh of
``torch.distributed`` ranks with named axes), :mod:`.collective` (the
collectives and point-to-point transfers of the sharded steps, with their
counts), :mod:`.comm_watchdog` (their deadline monitor),
:mod:`.checkpoint` (sharded async checkpoints), :mod:`.pipelining`
(GPipe over a ``pipe`` axis), :mod:`.sharding` (``group_sharded_parallel``,
implemented in ``fleet/meta_parallel``) and :mod:`.launch` (the rank
launcher of the tests and ``chip_smoke.py``)."""
