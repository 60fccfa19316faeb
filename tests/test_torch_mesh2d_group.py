"""The PyTorch port's process-group 2-D mesh (``GroupMesh2D``,
``multihost.global_mesh_2d``) on gloo: four CPU processes, a 2 x 2 grid,
one position each.

Tolerance: exact (bitwise). Along either axis a rank's padded shard, count
and overflow flag must equal those of ``LocalMesh2D`` over the same grid of
CPU shards at its position (its count and flag at the rank's index along
the axis), and ``gather_sorted`` must give every rank the whole sorted
array; without ``mesh=`` it must give the whole array or raise, never the
rank's shard alone. The four processes are spawned once for the module;
each checks its own shards and returns what it saw. This file imports no
JAX, so the spawned processes, which import it, do not either.
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
    GroupMesh2D,
    LocalMesh2D,
    gather_sorted,
    sort_distributed,
    sort_sharded,
)
from vkradixsort_tpu_torch.utils.fixtures import make_keys
from torch_threads import one_torch_thread  # noqa: F401 (autouse)

SHAPE = (2, 2)
WORLD = SHAPE[0] * SHAPE[1]
N = 2 * 3001


def _data():
    rng = np.random.default_rng(23)
    keys = make_keys(rng, N, np.uint32, "zipf")
    keys[::11] = np.uint32(0xFFFFFFFF)  # the pad sentinel, in every shard
    return keys, np.arange(N, dtype=np.int32), rng.standard_normal(N).astype(np.float32)


def _flat(res):
    """Every tensor of a sort_sharded result, in order."""
    out = list(res[0]) + [res[1], res[2]]
    for payload in res[3]:
        out += list(payload)
    return out


def _worker(rank, init, queue):
    # LOCAL_RANK runs against the rank, so the host-major grid puts
    # position p on rank WORLD - 1 - p
    os.environ["LOCAL_RANK"] = str(WORLD - 1 - rank)
    torch.set_num_threads(1)
    assert multihost.ensure_initialized(init, WORLD, rank, backend="gloo") is True
    keys, v1, v2 = _data()
    local = LocalMesh2D([["cpu"] * SHAPE[1]] * SHAPE[0])
    meshes = {"grid": GroupMesh2D(SHAPE, device="cpu"),
              "host_major": multihost.global_mesh_2d(SHAPE, device="cpu")}
    seen = {name: (m.position, m.order) for name, m in meshes.items()}
    for axis in ("chip", "host"):
        P = local.shape[axis]
        m = N // P
        for chunks in (1, 2):
            want = _flat(sort_sharded(torch.from_numpy(keys), local,
                                      values=(torch.from_numpy(v1), torch.from_numpy(v2)),
                                      overlap_chunks=chunks, axis_name=axis))
            nout = WORLD  # output shards of the local mesh
            for name, mesh in meshes.items():
                r, c = mesh.position
                # this rank's index along the axis, and its local output shard
                s, i = (c, r * SHAPE[1] + c) if axis == "chip" else (r, c * SHAPE[0] + r)
                part = [torch.from_numpy(x[s * m:(s + 1) * m]) for x in (keys, v1, v2)]
                res = sort_sharded(part[0], mesh, values=(part[1], part[2]),
                                   overlap_chunks=chunks, axis_name=axis)
                mine = [want[i], want[nout][s:s + 1], want[nout + 1][s:s + 1],
                        want[nout + 2 + i], want[2 * nout + 2 + i]]
                seen[(name, axis, chunks)] = all(torch.equal(a, b)
                                                 for a, b in zip(_flat(res), mine))
                got_k, (got_v1, got_v2) = gather_sorted(res[0], res[1], res[3], mesh=mesh,
                                                        axis_name=axis)
                perm = np.argsort(keys, kind="stable")
                seen[(name, axis, chunks, "gathered")] = (
                    np.array_equal(got_k.numpy(), keys[perm]) and np.array_equal(
                        got_v1.numpy(), perm.astype(np.int32)) and np.array_equal(
                        got_v2.numpy(), v2[perm]))
                try:
                    got = gather_sorted(res[0], res[1])
                except ValueError as e:
                    seen[(name, axis, chunks, "no mesh")] = (
                        "raised" if "mesh=" in str(e) else f"raised {e}")
                else:
                    seen[(name, axis, chunks, "no mesh")] = (
                        "whole" if np.array_equal(got.numpy(), keys[perm]) else "partial")
            # the LocalMesh2D output in the same processes gathers one replica
            got = gather_sorted(want[:nout], want[nout])
            seen[("local", axis, chunks, "no mesh")] = np.array_equal(got.numpy(), np.sort(keys))
    mesh = meshes["host_major"]
    r, c = mesh.position
    mine = torch.from_numpy(keys[c * (N // 2):(c + 1) * (N // 2)])
    seen["overflowed"] = bool(sort_sharded(mine, mesh, slack=0.2, axis_name="chip")[2].any())
    got = sort_distributed(mine, mesh, slack=0.2, axis_name="chip")
    seen["retry"] = np.array_equal(got.numpy(), np.sort(keys))
    try:
        GroupMesh2D((1, 2), device="cpu")
    except ValueError as e:
        seen["wrong shape"] = str(e)
    try:
        mesh.along("x")
    except ValueError as e:
        seen["bad axis"] = str(e)
    queue.put((rank, seen))
    tdist.barrier()
    tdist.destroy_process_group()


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    init = "file://" + str(tmp_path_factory.mktemp("gloo2d") / "store")
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
@pytest.mark.parametrize("axis", ["chip", "host"])
def test_group_grid_equals_local_grid(group_runs, axis, chunks):
    for rank, seen in group_runs.items():
        position, order = seen["grid"]
        assert position == divmod(rank, SHAPE[1]) and order == list(range(WORLD))
        assert seen[("grid", axis, chunks)], f"rank {rank}: shard differs from LocalMesh2D's"
        assert seen[("grid", axis, chunks, "gathered")]


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("axis", ["chip", "host"])
def test_host_major_grid_orders_by_local_rank(group_runs, axis, chunks):
    for rank, seen in group_runs.items():
        position, order = seen["host_major"]
        assert order == list(range(WORLD))[::-1]
        assert position == divmod(WORLD - 1 - rank, SHAPE[1])
        assert seen[("host_major", axis, chunks)], f"rank {rank}: shard differs"
        assert seen[("host_major", axis, chunks, "gathered")]


@pytest.mark.parametrize("chunks", [1, 2])
@pytest.mark.parametrize("axis", ["chip", "host"])
def test_gather_without_mesh_never_gives_a_shard_alone(group_runs, axis, chunks):
    for rank, seen in group_runs.items():
        for name in ("grid", "host_major"):
            assert seen[(name, axis, chunks, "no mesh")] in ("raised", "whole"), (rank, name)
        assert seen[("local", axis, chunks, "no mesh")]


def test_group_grid_overflow_retry(group_runs):
    assert any(seen["overflowed"] for seen in group_runs.values())
    assert all(seen["retry"] for seen in group_runs.values())


def test_group_grid_refuses_a_wrong_shape_and_axis(group_runs):
    for seen in group_runs.values():
        assert "needs 2 ranks" in seen["wrong shape"]
        assert "('host', 'chip')" in seen["bad axis"]
