"""``paddle.io`` of the port (counterpart of ``paddle_tpu/io``): datasets,
samplers, length bucketing and the DataLoader, whose worker processes
stream batches through shared-memory rings (``shm_ring``, over the C++
ring of ``_native/ringbuf.cc``)."""
from .dataset import (Dataset, IterableDataset, TensorDataset, ComposeDataset,
                      ChainDataset, Subset, ConcatDataset, random_split)
from .bucketing import (BucketedBatchSampler, pad_to_bucket,
                        default_buckets)
from .sampler import (Sampler, SequenceSampler, RandomSampler, BatchSampler,
                      DistributedBatchSampler, WeightedRandomSampler,
                      SubsetRandomSampler)
from .dataloader import DataLoader, default_collate_fn, get_worker_info
