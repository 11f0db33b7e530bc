"""``paddle.io`` of the port on the CPU: the reference's DataLoader and
bucketing tests (``test_dataloader_mp.py``, ``test_bucketing_varlen.py``)
retargeted at ``paddle_tpu_torch.io``, plus the port's own contract: the
multi-worker loader over the port's shared-memory ring yields batches
bitwise equal to ``num_workers=0`` and to the reference's loader (order
and bytes), every batch one ring frame; a killed worker and a worker's
error raise; a failed ring build raises (no thread fallback);
``state_dict`` resumes where the loader left off; the samplers draw the
reference's orders under ``np.random.seed``."""
import os
import threading

import numpy as np
import pytest

import paddle_tpu as R
import paddle_tpu_torch as P
from paddle_tpu_torch import _build
from paddle_tpu_torch.core.device import device_guard
from paddle_tpu_torch.io import (BucketedBatchSampler, DataLoader, Dataset,
                                 IterableDataset, default_buckets,
                                 pad_to_bucket)
from paddle_tpu_torch.io import shm_ring
from paddle_tpu_torch.io.shm_ring import ShmRing, decode_batch, encode_batch
from paddle_tpu_torch.testing.threads import \
    one_intra_op_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def on_cpu():
    with device_guard("cpu"):
        yield


def _ring_name(tag):
    return "/ptt-test-%s-%d" % (tag, os.getpid())


class ArrDataset(Dataset):
    def __init__(self, n=32, dim=6):
        self.x = np.arange(n * dim, dtype=np.float32).reshape(n, dim)
        self.y = np.arange(n, dtype=np.int64)

    def __getitem__(self, i):
        return self.x[i], self.y[i]

    def __len__(self):
        return len(self.x)


class StreamDataset(IterableDataset):
    """A stream that shards itself through ``get_worker_info``."""

    def __init__(self, n=20):
        self.n = n

    def __iter__(self):
        from paddle_tpu_torch.io import get_worker_info
        info = get_worker_info()
        wid = info.id if info else 0
        W = info.num_workers if info else 1
        for i in range(self.n):
            if i % W == wid:
                yield np.full((3,), i, np.float32)


class BrokenDataset(Dataset):
    def __getitem__(self, i):
        if i == 5:
            raise ValueError("boom at 5")
        return np.zeros(2, np.float32)

    def __len__(self):
        return 8


def _np(batches):
    return [[t.numpy() for t in b] if isinstance(b, (list, tuple))
            else b.numpy() for b in batches]


def test_ring_roundtrip_unit():
    name = _ring_name("unit")
    ring = ShmRing(name, 1 << 20, owner=True)
    peer = ShmRing(name, 1 << 20, owner=False)
    payload = encode_batch([np.arange(10, dtype=np.float32),
                            {"k": np.ones((2, 3), np.int64)}, "tag", 7],
                           b"B")
    peer.send_msg(payload)
    peer.send_msg(b"x" * 100)
    msg = ring.recv_msg()
    assert msg[:1].tobytes() == b"B"
    got = decode_batch(msg, 1)
    np.testing.assert_array_equal(got[0], np.arange(10, dtype=np.float32))
    np.testing.assert_array_equal(got[1]["k"], np.ones((2, 3), np.int64))
    assert got[2] == "tag" and got[3] == 7
    assert got[0].ctypes.data % 64 == msg.ctypes.data % 64   # aligned views
    assert ring.recv_msg().tobytes() == b"x" * 100
    peer.close_write()
    assert ring.recv_msg() is None      # EOF
    peer.detach()
    ring.detach()
    ring.unlink()


def test_ring_wraparound_and_oversized_frames():
    name = _ring_name("wrap")
    ring = ShmRing(name, 4096, owner=True)
    peer = ShmRing(name, 4096, owner=False)
    msgs = [bytes([i % 256]) * 1500 for i in range(20)]

    def produce():
        for m in msgs:
            peer.send_msg(m)
        peer.close_write()

    t = threading.Thread(target=produce)
    t.start()
    got = []
    while True:
        m = ring.recv_msg()
        if m is None:
            break
        got.append(m.tobytes())
    t.join()
    assert got == msgs
    with pytest.raises(OSError, match="does not fit"):
        peer.send_msg(b"y" * 5000)
    peer.detach()
    ring.detach()
    ring.unlink()


def test_mp_loader_matches_single_process_and_the_reference():
    ds = ArrDataset()
    single = _np(DataLoader(ds, batch_size=4, shuffle=False))
    loader = DataLoader(ds, batch_size=4, shuffle=False, num_workers=2)
    multi = _np(loader)
    ref = [[np.asarray(t.numpy()) for t in b]
           for b in R.io.DataLoader(ds, batch_size=4, num_workers=2)]
    assert len(single) == len(multi) == len(ref) == 8
    for s, m, r in zip(single, multi, ref):
        for a, b, c in zip(s, m, r):
            assert a.dtype == b.dtype == c.dtype
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, c)
    assert loader.ring_frames == 8
    assert loader.ring_bytes >= ds.x.nbytes + ds.y.nbytes


def test_mp_loader_three_workers_uneven():
    ds = ArrDataset(n=26)   # 7 batches of 4 (drop_last=False)
    out = list(DataLoader(ds, batch_size=4, num_workers=3))
    assert len(out) == 7
    assert [int(b[1].numpy()[0]) for b in out] == [0, 4, 8, 12, 16, 20, 24]


def test_mp_loader_shuffled_order_is_the_reference_order():
    ds = ArrDataset(n=24)
    np.random.seed(3)
    ref = [np.asarray(b[1].numpy()) for b in
           R.io.DataLoader(ds, batch_size=5, shuffle=True)]
    np.random.seed(3)
    got = [b[1].numpy() for b in DataLoader(ds, batch_size=5, shuffle=True,
                                            num_workers=2)]
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)


def test_mp_iterable_dataset():
    out = list(DataLoader(StreamDataset(20), batch_size=3, num_workers=2))
    vals = sorted(int(v) for b in out for v in b.numpy()[:, 0])
    assert vals == list(range(20))


def test_mp_iterable_unsharded_duplicates():
    class Naive(IterableDataset):
        def __iter__(self):
            yield from (np.full((1,), i, np.float32) for i in range(4))

    out = list(DataLoader(Naive(), batch_size=2, num_workers=2))
    total = sorted(int(v) for b in out for v in b.numpy()[:, 0])
    assert total == [0, 0, 1, 1, 2, 2, 3, 3]


def test_mp_dead_worker_detected():
    class KillerDataset(Dataset):
        def __getitem__(self, i):
            if i == 3:
                os.kill(os.getpid(), 9)
            return np.zeros(2, np.float32)

        def __len__(self):
            return 8

    with pytest.raises(RuntimeError, match="died unexpectedly"):
        list(DataLoader(KillerDataset(), batch_size=2, num_workers=2))


def test_mp_worker_error_propagates():
    with pytest.raises(RuntimeError, match="boom at 5"):
        list(DataLoader(BrokenDataset(), batch_size=4, num_workers=2))


def test_oversized_batch_raises_in_the_parent(monkeypatch):
    monkeypatch.setenv("FLAGS_dataloader_ring_bytes", str(1 << 12))
    with pytest.raises(RuntimeError, match="does not fit"):
        list(DataLoader(ArrDataset(n=512, dim=64), batch_size=64,
                        num_workers=2))


def test_failed_ring_build_raises_without_a_fallback(monkeypatch):
    def broken(*a, **k):
        raise _build.BuildError("no compiler")
    monkeypatch.setattr(shm_ring._build, "build_host", broken)
    monkeypatch.setattr(shm_ring, "_LIB", [None])
    with pytest.raises(_build.BuildError):
        list(DataLoader(ArrDataset(), batch_size=4, num_workers=2))


def test_mp_worker_info_and_init_fn(tmp_path):
    marker = str(tmp_path / "init")

    def init_fn(worker_id):
        with open(marker + str(worker_id), "w") as f:
            f.write("ok")

    class InfoDataset(Dataset):
        def __getitem__(self, i):
            from paddle_tpu_torch.io import get_worker_info
            return np.asarray([i, get_worker_info().id], np.int64)

        def __len__(self):
            return 8

    out = list(DataLoader(InfoDataset(), batch_size=2, num_workers=2,
                          worker_init_fn=init_fn))
    assert os.path.exists(marker + "0") and os.path.exists(marker + "1")
    for i, b in enumerate(out):
        assert int(b.numpy()[0, 1]) == i % 2


def test_mp_loader_with_tensor_samples_and_a_custom_collate():
    class TensorDataset(Dataset):
        def __getitem__(self, i):
            return P.to_tensor(np.full((2, 2), float(i), np.float32))

        def __len__(self):
            return 6

    out = list(DataLoader(TensorDataset(), batch_size=2, num_workers=2))
    assert len(out) == 3
    np.testing.assert_allclose(out[0].numpy()[1], 1.0)
    seen = []

    def collate(samples):
        seen.append(len(samples))
        return P.to_tensor(np.stack(samples).sum(0))

    out = list(DataLoader(ArrDataset(n=8), batch_size=4, num_workers=2,
                          collate_fn=lambda s: collate([x for x, _ in s])))
    assert seen == [4, 4]
    np.testing.assert_array_equal(out[0].numpy(),
                                  ArrDataset(n=8).x[:4].sum(0))


@pytest.mark.parametrize("workers,shared", [(0, True), (2, True),
                                            (2, False)])
def test_state_dict_resumes_where_the_loader_left_off(workers, shared):
    ds = ArrDataset(n=40)
    full = [b[1].numpy() for b in DataLoader(ds, batch_size=4)]
    loader = DataLoader(ds, batch_size=4, num_workers=workers,
                        use_shared_memory=shared)
    it = iter(loader)
    for _ in range(3):
        next(it)
    state = loader.state_dict()
    assert state == {"batches_yielded": 3}
    del it
    resumed = DataLoader(ds, batch_size=4, num_workers=workers,
                         use_shared_memory=shared)
    resumed.set_state_dict(state)
    rest = [b[1].numpy() for b in resumed]
    assert len(rest) == len(full) - 3
    for a, b in zip(rest, full[3:]):
        np.testing.assert_array_equal(a, b)


def test_queue_wait_is_observed():
    from paddle_tpu_torch.observability.metrics import default_registry
    list(DataLoader(ArrDataset(n=8), batch_size=4, num_workers=2))
    hist = default_registry().get("dataloader_queue_wait_seconds")
    assert hist is not None and "dataloader_queue_wait_seconds" in \
        default_registry().names()


def test_samplers_draw_the_reference_orders():
    ds = ArrDataset(n=17)
    cases = [
        lambda io: list(io.RandomSampler(ds)),
        lambda io: list(io.RandomSampler(ds, replacement=True,
                                         num_samples=9)),
        lambda io: list(io.WeightedRandomSampler(
            np.linspace(0.1, 1.0, 17), 12)),
        lambda io: list(io.SubsetRandomSampler([1, 4, 6, 9, 12])),
        lambda io: list(io.DistributedBatchSampler(
            ds, 3, num_replicas=2, rank=1, shuffle=True)),
        lambda io: list(io.BatchSampler(ds, shuffle=True, batch_size=4,
                                        drop_last=True)),
    ]
    for case in cases:
        np.random.seed(11)
        want = case(R.io)
        np.random.seed(11)
        assert case(P.io) == want


def test_datasets_match_the_reference():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    b = np.arange(6, dtype=np.int64)
    for name, make in (
            ("tensor", lambda io: io.TensorDataset([a, b])),
            ("compose", lambda io: io.ComposeDataset(
                [io.TensorDataset([a]), io.TensorDataset([b])])),
            ("concat", lambda io: io.ConcatDataset(
                [io.TensorDataset([a[:2]]), io.TensorDataset([a[2:]])])),
            ("subset", lambda io: io.Subset(io.TensorDataset([a]),
                                            [5, 0, 3]))):
        r, p = make(R.io), make(P.io)
        assert len(r) == len(p), name
        for i in range(len(r)):
            for x, y in zip(p[i], r[i]):
                np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    chain = P.io.ChainDataset([StreamDataset(3), StreamDataset(2)])
    assert [int(x[0]) for x in chain] == [0, 1, 2, 0, 1]


def test_random_split_keeps_the_seed_contract():
    ds = ArrDataset(n=10)
    P.seed(5)
    a = [s.indices for s in P.io.random_split(ds, [6, 4])]
    P.seed(5)
    b = [s.indices for s in P.io.random_split(ds, [0.5, 0.5])]
    P.seed(6)
    c = [s.indices for s in P.io.random_split(ds, [6, 4])]
    assert sorted(a[0] + a[1]) == list(range(10))
    assert a[0][:5] == b[0] and a != c
    assert [len(s) for s in b] == [5, 5]


class TestBucketing:
    def test_default_buckets_are_8_aligned(self):
        bs = default_buckets(2048)
        assert all(b % 8 == 0 for b in bs)
        assert bs[-1] == 2048 and bs == sorted(bs)
        assert bs == R.io.default_buckets(2048)

    def test_pad_to_bucket(self):
        padded, n = pad_to_bucket(np.arange(10), [8, 16, 32])
        assert padded.shape == (16,) and n == 10
        assert (padded[10:] == 0).all()
        with pytest.raises(ValueError, match="exceeds"):
            pad_to_bucket(np.arange(100), [8, 16, 32])

    def test_batches_share_bucket_and_equal_the_reference(self):
        rng = np.random.RandomState(0)
        lengths = rng.randint(1, 65, 100).tolist()
        buckets = [16, 32, 64]
        sampler = BucketedBatchSampler(lengths, buckets, batch_size=8,
                                       shuffle=True, seed=0)
        ref = R.io.BucketedBatchSampler(lengths, buckets, batch_size=8,
                                        shuffle=True, seed=0)
        batches = list(sampler)
        assert batches == list(ref) and len(batches) == len(sampler)
        n_samples = 0
        for batch in batches:
            bucket_ids = {sampler.bucket_of(lengths[i]) for i in batch}
            assert len(bucket_ids) == 1
            n_samples += len(batch)
        assert n_samples == 100

    def test_dataloader_integration(self):
        lengths = [3, 12, 5, 30, 7, 14]
        data = [np.arange(n, dtype=np.float32) for n in lengths]
        buckets = [8, 16, 32]

        def collate(items):
            return P.to_tensor(np.stack([pad_to_bucket(x, buckets)[0]
                                         for x in items]))

        sampler = BucketedBatchSampler(lengths, buckets, batch_size=2)
        loader = DataLoader(data, batch_sampler=sampler, collate_fn=collate)
        shapes = sorted({tuple(b.shape) for b in loader})
        assert shapes and all(s[1] in buckets for s in shapes)
