"""Multi-rank machinery of the port (counterpart of
``paddle_tpu/distributed``): :mod:`.process_mesh` (a mesh of
``torch.distributed`` ranks with named axes), :mod:`.collective` (the
collectives the sharded serving steps use, with their counts) and
:mod:`.launch` (the rank launcher of the tests and ``chip_smoke.py``)."""
