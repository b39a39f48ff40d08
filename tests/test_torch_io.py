"""The port's ``io`` (datasets, samplers, collation, the DataLoader in its
three modes, the reader decorators and ``paddle.batch``) against the JAX
package's: the same index streams under one ``np.random.seed`` and the same
batches, bit for bit. Twins of ``tests/test_dataloader_process.py``'s
worker-exception and killed-worker cases, and the default place without a
card."""
import os

import numpy as np
import pytest

import paddle_tpu.io as jio
import paddle_tpu_torch.io as pio
from paddle_tpu_torch.io.worker import WorkerFailure

from tests.torch_port_util import default_place, port_cpu  # noqa: F401


@pytest.fixture(autouse=True)
def _fork_start(monkeypatch, request):
    """fork-start for speed, as the JAX package's worker tests do; the
    default (forkserver) start runs in its own test."""
    if "forkserver" not in request.node.name:
        monkeypatch.setenv("PADDLE_TPU_WORKER_START", "fork")


class ArrayDS:
    """A map-style dataset both packages take: arrays and int labels."""

    def __init__(self, n=40, dim=3):
        self.x = np.arange(n * dim, dtype=np.float32).reshape(n, dim)

    def __getitem__(self, i):
        return self.x[i], np.int64(i)

    def __len__(self):
        return len(self.x)


class JArrayDS(ArrayDS, jio.Dataset):
    pass


class PArrayDS(ArrayDS, pio.Dataset):
    pass


class PBoomDS(PArrayDS):
    def __getitem__(self, i):
        if i == 13:
            raise ValueError("boom at 13")
        return super().__getitem__(i)


class PKillSelfDS(PArrayDS):
    def __getitem__(self, i):
        if i == 7:
            os._exit(42)  # a killed or crashed worker
        return super().__getitem__(i)


def _stream(it, seed):
    np.random.seed(seed)
    return [list(b) if isinstance(b, list) else b for b in it]


@pytest.mark.parametrize("make", [
    lambda io, ds: io.SequenceSampler(ds),
    lambda io, ds: io.RandomSampler(ds),
    lambda io, ds: io.RandomSampler(ds, replacement=True, num_samples=17),
    lambda io, ds: io.RandomSampler(ds, num_samples=9),
    lambda io, ds: io.SubsetRandomSampler([3, 1, 4, 15, 9, 26]),
    lambda io, ds: io.WeightedRandomSampler([0.1, 0.5, 2.0, 1.0], 11),
    lambda io, ds: io.WeightedRandomSampler([1, 2, 3], 3, replacement=False),
    lambda io, ds: io.BatchSampler(ds, shuffle=True, batch_size=6),
    lambda io, ds: io.BatchSampler(ds, shuffle=False, batch_size=7,
                                   drop_last=True),
    lambda io, ds: io.BatchSampler(sampler=io.RandomSampler(ds),
                                   batch_size=5),
    lambda io, ds: io.DistributedBatchSampler(ds, 4),
], ids=["sequence", "random", "random_replacement", "random_num_samples",
        "subset_random", "weighted", "weighted_no_replacement",
        "batch_shuffled", "batch_drop_last", "batch_of_sampler",
        "distributed_default_replicas"])
def test_samplers_give_the_jax_index_streams(make):
    j, p = make(jio, ArrayDS()), make(pio, ArrayDS())
    assert len(p) == len(j)
    for seed in (0, 7):
        assert _stream(p, seed) == _stream(j, seed)


@pytest.mark.parametrize("shuffle,drop_last", [(False, False), (True, True)])
def test_distributed_batch_sampler_with_explicit_replicas(shuffle, drop_last):
    for rank in range(3):
        kw = dict(batch_size=4, num_replicas=3, rank=rank, shuffle=shuffle,
                  drop_last=drop_last)
        j = jio.DistributedBatchSampler(ArrayDS(), **kw)
        p = pio.DistributedBatchSampler(ArrayDS(), **kw)
        for epoch in (0, 3):
            j.set_epoch(epoch)
            p.set_epoch(epoch)
            assert list(p) == list(j) and len(p) == len(j)


def test_datasets_and_random_split():
    x = np.arange(12, dtype=np.float32).reshape(6, 2)
    y = np.arange(6)
    for io in (jio, pio):
        assert isinstance(io.TensorDataset([x, y])[2][0], np.ndarray)
    jt, pt_ = jio.TensorDataset([x, y]), pio.TensorDataset([x, y])
    jc = jio.ComposeDataset([jt, jio.TensorDataset([y])])
    pc = pio.ComposeDataset([pt_, pio.TensorDataset([y])])
    for i in range(6):
        for a, b in zip(pc[i], jc[i]):
            np.testing.assert_array_equal(a, b)
    jcat = jio.ConcatDataset([jt, jt])
    pcat = pio.ConcatDataset([pt_, pt_])
    assert len(pcat) == len(jcat) == 12
    for i in (0, 5, 6, 11, -1):
        np.testing.assert_array_equal(pcat[i][0], jcat[i][0])
    assert list(iter(pio.ChainDataset([[1, 2], [3]]))) == list(
        iter(jio.ChainDataset([[1, 2], [3]])))
    np.random.seed(3)
    js = jio.random_split(ArrayDS(10), [4, 6])
    np.random.seed(3)
    ps = pio.random_split(ArrayDS(10), [4, 6])
    assert [s.indices for s in ps] == [s.indices for s in js]
    with pytest.raises(ValueError):
        pio.random_split(ArrayDS(10), [4, 5])
    with pytest.raises(RuntimeError):
        len(pio.IterableDataset())


def test_collate_gives_the_jax_arrays(port_cpu):
    from paddle_tpu.io import default_collate_fn as jcollate

    import paddle_tpu_torch as pt
    from paddle_tpu_torch.io import default_collate_fn as pcollate

    rng = np.random.RandomState(0)
    batch = [{"x": rng.randn(3).astype(np.float32), "n": int(i), "f": 0.5 * i,
              "s": f"s{i}", "pair": (np.int64(i), rng.randn(2))}
             for i in range(4)]
    j, p = jcollate(batch), pcollate(batch)
    assert p["s"] == j["s"]
    for k in ("x", "n", "f"):
        assert isinstance(p[k], pt.Tensor) and p[k].place == pt.CPUPlace()
        got, want = p[k].numpy(), np.asarray(j[k])
        # the JAX package runs x64 off: int64 and float64 come back 32-bit
        # there (ROADMAP.md C, the Paddle-API surface); the values agree
        np.testing.assert_array_equal(got.astype(want.dtype), want)
    np.testing.assert_array_equal(p["pair"][0].numpy(),
                                  np.asarray(j["pair"][0]))
    t = pt.to_tensor(np.ones((2, 2), np.float32))
    np.testing.assert_array_equal(pcollate([t, t]).numpy(), np.ones((2, 2, 2)))
    assert pio.default_convert_fn([np.ones(2)])[0].place == pt.CPUPlace()


def _batches(loader):
    return [[np.asarray(b) for b in batch] for batch in loader]


@pytest.mark.parametrize("mode", [
    {},
    {"num_workers": 2},
    {"num_workers": 2, "use_process": True},
    {"num_workers": 2, "use_process": True, "use_shared_memory": False},
], ids=["single", "threaded", "process", "process_pickled"])
def test_dataloader_gives_the_jax_batches(mode, port_cpu):
    import paddle_tpu_torch as pt

    kw = dict(batch_size=6, shuffle=True, drop_last=False)
    np.random.seed(11)
    want = _batches(jio.DataLoader(JArrayDS(), **kw))
    np.random.seed(11)
    loader = pio.DataLoader(PArrayDS(), **kw, **mode)
    got = list(loader)
    assert len(got) == len(want) == len(loader)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert isinstance(a, pt.Tensor) and a.place == pt.CPUPlace()
            np.testing.assert_array_equal(a.numpy(), b)


def test_dataloader_iterable_and_get_worker_info(port_cpu):
    class Stream(pio.IterableDataset):
        def __iter__(self):
            info = pio.get_worker_info()
            wid, nw = (info.id, info.num_workers) if info else (0, 1)
            for i in range(wid, 20, nw):
                yield np.float32(i)

    one = [b.numpy().tolist() for b in pio.DataLoader(Stream(), batch_size=6)]
    assert one == [[0, 1, 2, 3, 4, 5], [6, 7, 8, 9, 10, 11],
                   [12, 13, 14, 15, 16, 17], [18, 19]]
    got = sorted(v for b in pio.DataLoader(Stream(), batch_size=4,
                                           num_workers=2, use_process=True)
                 for v in b.numpy().tolist())
    assert got == list(range(20))
    with pytest.raises(NotImplementedError):
        pio.DataLoader.from_generator()


class ShardStream(pio.IterableDataset):
    """Each worker streams the ids its worker info gives it."""

    def __iter__(self):
        info = pio.get_worker_info()
        for i in range(info.id, 20, info.num_workers):
            yield np.float32(i)


def _late_second_worker(wid):
    if wid == 1:
        import time

        time.sleep(0.5)


def test_iterable_workers_each_stream_their_shard_once(port_cpu):
    """A worker that ends its stream before another has started takes no
    second epoch start: every shard comes once, in both epochs."""
    loader = pio.DataLoader(ShardStream(), batch_size=4, num_workers=2,
                            use_process=True, persistent_workers=True,
                            worker_init_fn=_late_second_worker)
    for _ in range(2):
        got = sorted(v for b in loader for v in b.numpy().tolist())
        assert got == list(range(20))


def test_dataloader_user_collate_runs_as_given(port_cpu):
    def collate(batch):
        return np.stack([b[0] for b in batch]).sum()

    out = list(pio.DataLoader(PArrayDS(6), batch_size=3, collate_fn=collate))
    assert [float(o) for o in out] == [36.0, 117.0]


def test_forkserver_default_start(port_cpu):
    assert os.environ.get("PADDLE_TPU_WORKER_START") is None
    ds = pio.TensorDataset([np.arange(24, dtype=np.float32).reshape(12, 2)])
    got = [b[0].numpy() for b in pio.DataLoader(ds, batch_size=4,
                                                num_workers=2,
                                                use_process=True)]
    np.testing.assert_array_equal(np.concatenate(got), ds.tensors[0])


_LEAVE_A_POOL = """
import json, multiprocessing.forkserver as fs, multiprocessing.resource_tracker as rt
import numpy as np
import paddle_tpu_torch.io as pio
ds = pio.TensorDataset([np.arange(24, dtype=np.float32).reshape(12, 2)])
loader = pio.DataLoader(ds, batch_size=4, num_workers=2, use_process=True,
                        persistent_workers=True, places="cpu")
assert len(list(loader)) == 3
print(json.dumps([fs._forkserver._forkserver_pid, rt._resource_tracker._pid]
                 + [p.pid for p in loader._pool._procs]))
"""


def _process_ended(pid):
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except FileNotFoundError:
        return True


def test_forkserver_and_workers_end_with_the_program(tmp_path):
    """A program that leaves a persistent pool alive has, when it has
    exited, no worker, forkserver or resource tracker left running."""
    import json
    import subprocess
    import sys

    env = {k: v for k, v in os.environ.items()
           if k != "PADDLE_TPU_WORKER_START"}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    # files, not pipes: a pipe's reader would wait for every process that
    # inherited its end, the ones this test looks for among them
    with open(tmp_path / "out", "w+") as out, \
            open(tmp_path / "err", "w+") as err:
        rc = subprocess.run([sys.executable, "-c", _LEAVE_A_POOL], cwd=root,
                            env=env, stdout=out, stderr=err,
                            timeout=120).returncode
        out.seek(0)
        err.seek(0)
        assert rc == 0, err.read()
        pids = json.loads(out.read().strip().splitlines()[-1])
    assert len(pids) == 4 and all(pids)
    assert [p for p in pids if not _process_ended(p)] == []


def test_process_worker_exception_propagates(port_cpu):
    loader = pio.DataLoader(PBoomDS(), batch_size=4, num_workers=2,
                            use_process=True)
    with pytest.raises(WorkerFailure, match="boom at 13"):
        list(loader)


def test_process_killed_worker_detected(port_cpu):
    loader = pio.DataLoader(PKillSelfDS(), batch_size=4, num_workers=2,
                            use_process=True, worker_restart_limit=0)
    with pytest.raises(WorkerFailure, match="exited unexpectedly"):
        list(loader)


def test_reader_decorators_and_batch_match_jax():
    import random

    import paddle_tpu as jp
    import paddle_tpu.reader as jr

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.reader as pr

    def r10():
        yield from range(10)

    def letters():
        yield from "abcdefghij"

    def run(reader_mod, batch):
        random.seed(4)
        out = {
            "shuffle": list(reader_mod.shuffle(r10, 4)()),
            "chain": list(reader_mod.chain(r10, letters)()),
            "compose": list(reader_mod.compose(r10, letters)()),
            "map": list(reader_mod.map_readers(lambda a, b: f"{a}{b}", r10,
                                               letters)()),
            "firstn": list(reader_mod.firstn(r10, 3)()),
            "cache": list(reader_mod.cache(r10)()),
            "buffered": list(reader_mod.buffered(r10, 2)()),
            "xmap": list(reader_mod.xmap_readers(lambda v: v * v, r10, 3, 4,
                                                 order=True)()),
            "batch": list(batch(r10, 4)()),
            "batch_drop": list(batch(r10, 4, drop_last=True)()),
        }
        return out

    assert run(pr, pt.batch) == run(jr, jp.batch)
    with pytest.raises(pr.ComposeNotAligned):
        list(pr.compose(r10, pr.firstn(letters, 3))())
    with pytest.raises(ValueError):
        pt.batch(r10, 0)


def test_default_place_without_a_card_raises(monkeypatch):
    import torch

    import paddle_tpu_torch as pt

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with default_place():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pio.DataLoader(PArrayDS(), batch_size=4)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pt.to_tensor([1.0])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            pio.DeviceLoader([np.ones(2)])
