"""Entry points: one stable key-value sort, and a dry run of the distributed
sort over P logical shards.

Port of ``__graft_entry__.py``. Both run on the card unless ``device`` says
otherwise (the tests pass ``device="cpu"``).
"""

from __future__ import annotations

import numpy as np
import torch


def _device(device) -> torch.device:
    return torch.device("cuda", torch.cuda.current_device()) if device is None else \
        torch.device(device)


def entry(device=None):
    """``(fn, args)``: the flagship call, a stable u32 key-value
    ``sort_pairs`` at 2^20 (``BASELINE.json`` config 3, scaled down)."""
    import vkradixsort_tpu_torch as vt

    dev = _device(device)
    n = 1 << 20
    rng = np.random.default_rng(0)
    keys = torch.from_numpy(rng.integers(0, 1 << 32, size=n, dtype=np.uint32)).to(dev)
    values = torch.arange(n, dtype=torch.int32, device=dev).view(torch.uint32)

    def fn(k, v):
        return vt.sort_pairs(k, v)

    return fn, (keys, values)


def dryrun_multichip(n_devices: int, device=None) -> None:
    """One distributed sort over ``LocalMesh([device] * n_devices)``: float32
    keys with an int32 and a float32 payload, n = (10^6 // P + 3) * P (not a
    multiple of P^2: the internal padding must absorb it), the plain and the
    overlapped pipeline (``overlap_chunks`` 1 and 2), at the default slack.
    Raises unless nothing overflows, the largest shard holds at most 1.25
    times the mean, and keys and payloads equal numpy's stable sort."""
    from vkradixsort_tpu_torch.parallel.distributed import LocalMesh, gather_sorted, sort_sharded

    dev = _device(device)
    mesh = LocalMesh([dev] * n_devices)
    n = (1_000_000 // n_devices + 3) * n_devices
    rng = np.random.default_rng(1)
    keys_np = rng.standard_normal(n).astype(np.float32)
    v32_np = np.arange(n, dtype=np.int32)
    vf_np = rng.standard_normal(n).astype(np.float32)
    keys, v32, vf = (torch.from_numpy(x).to(dev) for x in (keys_np, v32_np, vf_np))
    perm = np.argsort(keys_np, kind="stable")
    for chunks in (1, 2):
        pk, counts, overflow, (pv, pw) = sort_sharded(keys, mesh, values=(v32, vf),
                                                      overlap_chunks=chunks)
        if bool(overflow.any()):
            raise AssertionError(f"bucket overflow at default slack (chunks={chunks})")
        c = counts.cpu().numpy()
        balance = c.max() / max(c.mean(), 1.0)
        if balance > 1.25:
            raise AssertionError(f"shard balance {balance:.3f} (chunks={chunks})")
        got_k, (got_v, got_w) = gather_sorted(pk, counts, (pv, pw))
        for what, got, want in [("keys", got_k, keys_np[perm]),
                                ("values", got_v, perm.astype(np.int32)),
                                ("payload-2", got_w, vf_np[perm])]:  # bitwise
            if not np.array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32)):
                raise AssertionError(f"{what} mismatch (chunks={chunks})")
        print(f"dryrun_multichip({n_devices}): chunks={chunks} n={n} float32 keys + 2 payloads "
              f"exact on {dev}, balance={balance:.3f}, no overflow")
    print(f"dryrun_multichip({n_devices}): distributed multi-payload sort exact on "
          f"{n_devices} logical shards of {dev} (plain + overlapped)")


if __name__ == "__main__":
    fn, args = entry()
    out = fn(*args)
    torch.cuda.synchronize()
    print("entry() ran:", out[0].shape, out[0].dtype)
    dryrun_multichip(8)
