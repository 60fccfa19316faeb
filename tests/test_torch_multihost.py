"""The PyTorch port's multi-process layer (parallel/multihost.py) and its
``GroupMesh`` on gloo: four CPU processes, one shard each.

Tolerance: exact (bitwise). ``GroupMesh`` moves the same bytes as
``LocalMesh`` by other means, so its padded shards, counts and overflow
flags must equal those of ``LocalMesh(["cpu"] * 4)`` on the same input.
The four processes are spawned once for the module (a few seconds); each
checks its own shard and returns what it saw. This file imports no JAX, so
the spawned processes do not either.
"""

import os
import time

import numpy as np
import pytest
import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from vkradixsort_tpu_torch.parallel import multihost
from vkradixsort_tpu_torch.parallel.distributed import (
    GroupMesh,
    LocalMesh,
    gather_sorted,
    sort_distributed,
    sort_sharded,
)
from vkradixsort_tpu_torch.utils.fixtures import make_keys
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

WORLD = 4
N = WORLD * 3001


def _data():
    rng = np.random.default_rng(21)
    keys = make_keys(rng, N, np.uint32, "zipf")
    keys[::11] = np.uint32(0xFFFFFFFF)  # the pad sentinel, in every shard
    return keys, np.arange(N, dtype=np.int32), rng.standard_normal(N).astype(np.float32)


def _flat(res):
    """Every tensor of a sort_sharded result, in order."""
    out = list(res[0]) + [res[1], res[2]]
    for payload in res[3]:
        out += list(payload)
    return out


def _gather_without_mesh(res, want_keys) -> str:
    """What ``gather_sorted`` without ``mesh=`` gives a rank of a process
    group: "raised" (a ValueError asking for the mesh), "whole" (the whole
    sorted array) or "partial" (anything else, such as its own shard)."""
    try:
        got = gather_sorted(res[0], res[1])
    except ValueError as e:
        return "raised" if "mesh=" in str(e) else f"raised {e}"
    return "whole" if np.array_equal(got.numpy(), want_keys) else "partial"


def _worker(rank, init, queue):
    # LOCAL_RANK runs against the rank, so the host-major mesh puts shard s
    # on rank WORLD - 1 - s
    os.environ["LOCAL_RANK"] = str(WORLD - 1 - rank)
    torch.set_num_threads(1)
    assert multihost.ensure_initialized(init, WORLD, rank, backend="gloo") is True
    assert multihost.ensure_initialized() is True  # once only
    keys, v1, v2 = _data()
    m = N // WORLD
    local = LocalMesh(["cpu"] * WORLD)
    seen = {}
    for chunks in (1, 2):
        want = _flat(sort_sharded(torch.from_numpy(keys), local,
                                  values=(torch.from_numpy(v1), torch.from_numpy(v2)),
                                  overlap_chunks=chunks))
        for name, mesh in [("group", GroupMesh(device="cpu")),
                           ("host_major", multihost.global_mesh_1d(device="cpu"))]:
            (s,) = mesh.shard_ids
            part = [multihost.global_array_from_host_data(x[s * m:(s + 1) * m], mesh)
                    for x in (keys, v1, v2)]
            res = sort_sharded(part[0], mesh, values=(part[1], part[2]), overlap_chunks=chunks)
            got = _flat(res)
            # local shard s of the LocalMesh result: keys, count, flag, payloads
            mine = [want[s], want[WORLD][s:s + 1], want[WORLD + 1][s:s + 1],
                    want[WORLD + 2 + s], want[2 * WORLD + 2 + s]]
            seen[(name, chunks)] = (s, mesh.order, all(torch.equal(a, b)
                                                       for a, b in zip(got, mine)))
            got_k, (got_v1, got_v2) = gather_sorted(res[0], res[1], res[3], mesh=mesh)
            perm = np.argsort(keys, kind="stable")
            seen[(name, chunks, "gathered")] = (
                np.array_equal(got_k.numpy(), keys[perm]) and np.array_equal(
                    got_v1.numpy(), perm.astype(np.int32)) and np.array_equal(
                    got_v2.numpy(), v2[perm]))
            seen[(name, chunks, "no mesh")] = _gather_without_mesh(res, keys[perm])
        # several shards in one process: the LocalMesh output gathers alone
        got = gather_sorted(want[:WORLD], want[WORLD])
        seen[("local", chunks, "no mesh")] = np.array_equal(got.numpy(), np.sort(keys))
    mesh = multihost.global_mesh_1d(device="cpu")
    (s,) = mesh.shard_ids
    got = sort_distributed(torch.from_numpy(keys[s * m:(s + 1) * m]), mesh, slack=0.2)
    seen["retry"] = np.array_equal(got.numpy(), np.sort(keys))
    queue.put((rank, seen))
    tdist.barrier()
    tdist.destroy_process_group()


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    init = "file://" + str(tmp_path_factory.mktemp("gloo") / "store")
    ctx = mp.get_context("spawn")
    queue = ctx.SimpleQueue()
    procs = mp.start_processes(_worker, args=(init, queue), nprocs=WORLD, join=False,
                               start_method="spawn")
    deadline = time.monotonic() + 300
    while not procs.join(timeout=5):  # raises if a process failed
        if time.monotonic() > deadline:
            for proc in procs.processes:
                proc.kill()
            raise TimeoutError("the gloo processes did not finish in 300 s")
    out = {}  # a few hundred bytes: the queue's pipe held them through the join
    while not queue.empty():
        rank, seen = queue.get()
        out[rank] = seen
    assert sorted(out) == list(range(WORLD))
    return out


@pytest.mark.parametrize("chunks", [1, 2])
def test_group_mesh_equals_local_mesh(group_runs, chunks):
    for rank, seen in group_runs.items():
        s, order, same = seen[("group", chunks)]
        assert s == rank and order == list(range(WORLD))
        assert same, f"rank {rank}: GroupMesh shard differs from LocalMesh's"
        assert seen[("group", chunks, "gathered")]


@pytest.mark.parametrize("chunks", [1, 2])
def test_host_major_mesh_orders_by_local_rank(group_runs, chunks):
    for rank, seen in group_runs.items():
        s, order, same = seen[("host_major", chunks)]
        assert order == list(range(WORLD))[::-1]
        assert s == WORLD - 1 - rank
        assert same, f"rank {rank}: host-major shard {s} differs from LocalMesh's"
        assert seen[("host_major", chunks, "gathered")]


@pytest.mark.parametrize("chunks", [1, 2])
def test_gather_without_mesh_never_gives_a_shard_alone(group_runs, chunks):
    # a rank's one-shard output cannot be told from a whole array without
    # its mesh: every rank gets the whole array or a ValueError, never its
    # shard; a LocalMesh's output in the same processes still gathers
    for rank, seen in group_runs.items():
        for name in ("group", "host_major"):
            assert seen[(name, chunks, "no mesh")] in ("raised", "whole"), (rank, name)
        assert seen[("local", chunks, "no mesh")]


def test_group_overflow_retry(group_runs):
    assert all(seen["retry"] for seen in group_runs.values())


def test_ensure_initialized_single_process_noop(monkeypatch):
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.ensure_initialized() is False
    assert not tdist.is_initialized()


def test_global_array_from_host_data_feeds_sort_sharded(tmp_path):
    # one process, world size 1: the host-major mesh is that one rank
    tdist.init_process_group("gloo", init_method="file://" + str(tmp_path / "store"),
                             world_size=1, rank=0)
    try:
        assert multihost.ensure_initialized() is False
        mesh = multihost.global_mesh_1d(device="cpu")
        assert mesh.size == 1 and mesh.shard_ids == [0]
        keys, v1, _ = _data()
        part = multihost.global_array_from_host_data(keys, mesh)
        assert part.dtype == torch.uint32 and part.shape == (N,)
        pk, counts, overflow, pv = sort_sharded(part, mesh, values=torch.from_numpy(v1))
        assert not bool(overflow.any()) and counts.tolist() == [N]
        got_k, got_v = gather_sorted(pk, counts, pv, mesh=mesh)
        perm = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(got_k.numpy(), keys[perm])
        np.testing.assert_array_equal(got_v.numpy(), v1[perm])
        # at world size 1 the one shard is the whole array: no mesh needed
        np.testing.assert_array_equal(gather_sorted(pk, counts).numpy(), keys[perm])
    finally:
        tdist.destroy_process_group()
