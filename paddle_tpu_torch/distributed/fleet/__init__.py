"""The part of ``paddle_tpu.distributed.fleet`` the port has:
``meta_parallel``'s group-sharding entry
(:mod:`.meta_parallel.sharding_api`)."""
