"""The port's data-parallel pieces that run in one process, on the CPU: the
sharded sample order against the JAX package's (``epoch_indices``), the
evaluation sweeps' round-robin split, the ``parallel`` helpers without a
process group and in a gloo group of one rank (a DDP train step there is
the plain step, bit for bit), and the launchers the two-rank tests share
(``run_ranks``, ``torchrun``): every rank a process with one intra-op
thread, its process group on a ``file://`` store under the test's
temporary folder or on ``torch.distributed.run --standalone``'s own free
port, so that parallel test workers never meet on a port."""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from tcvom_tpu.data import loader as JLoader
from tcvom_tpu_torch import parallel
from tcvom_tpu_torch.data import loader as TLoader
from tcvom_tpu_torch.models.full_model import TaskConfig
from tcvom_tpu_torch.train.trainer import MattingTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# -- launchers ---------------------------------------------------------------

def rank_env(**extra) -> dict:
    """The children's environment: the repo importable, one thread each."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1", **extra)
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    env.update(extra)
    return env


def run_ranks_started(script: str, args, n: int = 2
                      ) -> list[subprocess.Popen]:
    """``python script *args`` started as ranks 0..n-1 of ``n`` (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` set; the script chooses its store);
    :func:`wait_all` collects them."""
    return [subprocess.Popen(
        [sys.executable, script, *map(str, args)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=rank_env(RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r)))
        for r in range(n)]


def run_ranks(script: str, args, n: int = 2, timeout: float = 600):
    """:func:`run_ranks_started` to the end; returns the ranks' output."""
    return wait_all(run_ranks_started(script, args, n), timeout)


def wait_all(procs, timeout: float) -> list[str]:
    """Each process's output; any one's failure fails the test with its
    output, and none is left running."""
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"process {r} exited {p.returncode}:\n" \
            + out[-6000:]
    return outs


def torchrun(module: str, args, n: int = 2, timeout: float = 600
             ) -> subprocess.Popen:
    """``python -m torch.distributed.run --standalone --nproc_per_node n
    -m module *args`` (or, for a ``.py`` path, the script), started;
    :func:`wait_all` collects it."""
    target = [module] if module.endswith(".py") else ["-m", module]
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         f"--nproc_per_node={n}", *target, *map(str, args)], cwd=ROOT,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=rank_env())


# -- the sharded order -----------------------------------------------------

@pytest.mark.parametrize("n,block", [(1, 1), (5, 2), (10, 4), (13, 3),
                                     (16, 4), (7, 1)])
@pytest.mark.parametrize("num_shards", [1, 2, 3])
def test_sharded_epoch_indices_match_jax(n, block, num_shards):
    """Every shard's order, with and without shuffling and wrapping, in
    three epochs, equals tcvom_tpu.data.loader.epoch_indices exactly."""
    for shard in range(num_shards):
        for drop_last in (True, False):
            for shuffle in (True, False):
                for epoch in range(3):
                    np.testing.assert_array_equal(
                        TLoader.epoch_indices(
                            n, epoch, shuffle, 11, drop_last, block,
                            num_shards=num_shards, shard=shard),
                        JLoader.epoch_indices(
                            n, epoch, shuffle, 11, num_shards, shard,
                            drop_last, block),
                        err_msg=str((shard, drop_last, shuffle, epoch)))


@pytest.mark.parametrize("n,block,num_shards", [(10, 2, 2), (13, 3, 2),
                                                (7, 2, 3), (4, 4, 2)])
def test_ranks_batches_concatenate_to_the_global_batch(n, block, num_shards):
    """The ranks' k-th batches, concatenated in rank order, are the k-th
    batch of one process at ``num_shards * block``, in every epoch; the
    sampler and the loader's length follow the shard."""
    for epoch in range(2):
        whole = TLoader.epoch_indices(n, epoch, True, 3,
                                      block=num_shards * block)
        parts = [TLoader.epoch_indices(n, epoch, True, 3, block=block,
                                       num_shards=num_shards, shard=s)
                 for s in range(num_shards)]
        assert all(len(p) == len(whole) // num_shards for p in parts)
        for k in range(len(whole) // (num_shards * block)):
            np.testing.assert_array_equal(
                np.concatenate([p[k * block:(k + 1) * block]
                                for p in parts]),
                whole[k * num_shards * block:(k + 1) * num_shards * block])
        sampler = TLoader.EpochSampler(n, block, seed=3,
                                       num_shards=num_shards, shard=1)
        sampler.set_epoch(epoch)
        assert list(sampler) == [(epoch, int(i)) for i in parts[1]]


@pytest.mark.parametrize("n,block,num_shards", [(5, 1, 2), (10, 3, 2),
                                                (7, 2, 3), (1, 2, 2)])
def test_sweep_split_reads_every_sample_once(n, block, num_shards):
    """An evaluation sweep over ranks: every sample once, nothing wrapped,
    and each rank's batches are batches of the one-process sweep."""
    parts = [TLoader.sweep_indices(n, block, num_shards, s)
             for s in range(num_shards)]
    assert sorted(np.concatenate(parts).tolist()) == list(range(n))
    one = [list(range(i, min(i + block, n))) for i in range(0, n, block)]
    for s, p in enumerate(parts):
        batches = [p[i:i + block].tolist() for i in range(0, len(p), block)]
        assert batches == one[s::num_shards]
        sampler = TLoader.EpochSampler(n, block, shuffle=False,
                                       drop_last=False,
                                       num_shards=num_shards, shard=s)
        assert [i for _, i in sampler] == p.tolist()


# -- the helpers -------------------------------------------------------------

def test_helpers_without_a_process_group(monkeypatch):
    """No ``WORLD_SIZE``: no group, the given device, one rank, and every
    reduction the identity."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert parallel.init_from_env("cpu") == torch.device("cpu")
    assert not dist.is_initialized() and not parallel.is_distributed()
    assert (parallel.world(), parallel.rank()) == (1, 0)
    t = torch.arange(3.0, requires_grad=True)
    assert torch.equal(parallel.all_reduce_sum(t), t.detach())
    assert parallel.all_reduce_sum_grad(t) is t
    assert parallel.shard_slice(4) == slice(0, 4)
    parallel.barrier()


def test_a_group_that_cannot_start_raises(monkeypatch, tmp_path):
    """``WORLD_SIZE`` set and the group does not start (NCCL asked for on
    a host without it): the error stands; nothing goes on as one
    process."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises((RuntimeError, ValueError)):
        parallel.init_from_env("cpu", backend="nccl",
                               init_method=f"file://{tmp_path}/store")
    assert not dist.is_initialized()


@pytest.fixture
def one_rank_group(monkeypatch, tmp_path):
    """Starts a gloo process group of one rank in this process when
    called (and ends it after the test), on one intra-op thread (beside
    the test run's other workers, many threads a process stall each
    other)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("LOCAL_RANK", "0")
    yield lambda: parallel.init_from_env(
        "cpu", init_method=f"file://{tmp_path}/pg")
    if dist.is_initialized():
        dist.destroy_process_group()
    torch.set_num_threads(threads)


def _clip(b, s=3, seed=0):
    rng = np.random.RandomState(seed)
    a = rng.uniform(0, 255, (b, s, 64, 64, 1)).astype(np.float32)
    a[a < 90] = 0
    a[a > 200] = 255
    return {"a": torch.from_numpy(a),
            **{k: torch.from_numpy(rng.randint(0, 256, (b, s, 64, 64, 3))
                                   .astype(np.float32)) for k in ("fg", "bg")}}


def test_ddp_step_of_one_rank_is_the_plain_step(one_rank_group):
    """A trainer made in a group of one rank wraps the model in DDP at its
    first step (``frozen_modules()`` and the frozen backbone's eval mode
    through the wrapper, its parameters no longer requiring a gradient)
    and two steps end where two plain steps (of a trainer made before the
    group started) end, bit for bit: losses, gradients, weights and
    statistics (``vmn_index`` with a frozen backbone, dropout live; B = 1,
    S = 3)."""
    cfg = TaskConfig(model="vmn_index", agg_window=3, freeze_backbone=True)
    batch = _clip(1)
    runs = []
    for ddp in (False, True):
        if ddp:
            one_rank_group()
            assert parallel.is_distributed() and parallel.world() == 1
        trainer = MattingTrainer(cfg, "vmd", device="cpu")
        state = trainer.init_state(torch.Generator().manual_seed(1))
        metrics = [trainer.train_step(state, batch)[1] for _ in range(2)]
        runs.append((state, metrics))
    (plain, m_plain), (wrapped, m_ddp) = runs
    assert plain.ddp is None and wrapped.ddp is not None
    net = wrapped.ddp
    assert [id(m) for m in net.frozen_modules()] == [
        id(m) for m in wrapped.model.frozen_modules()]
    net.eval().train()
    assert not wrapped.model.encoder.training and wrapped.model.fam.training
    frozen = {id(p) for m in wrapped.model.frozen_modules()
              for p in m.parameters()}
    for p in wrapped.model.parameters():
        assert p.requires_grad == (id(p) not in frozen)
    for a, b in zip(m_plain, m_ddp):
        assert a == b
    sd = wrapped.model.state_dict()
    for k, v in plain.model.state_dict().items():
        assert torch.equal(sd[k], v), k
    grads = dict(wrapped.model.named_parameters())
    for n, p in plain.model.named_parameters():
        if p.grad is not None:
            assert torch.equal(grads[n].grad, p.grad), n
