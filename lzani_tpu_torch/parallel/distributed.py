"""Multi-process execution of the port: reference rows partitioned over
``torch.distributed`` processes, per-pair results merged on process 0.

The port's counterpart of ``lzani_tpu/parallel/distributed.py``:

  * every process loads the same FASTA set;
  * reference rows are split by a stride (process h owns the rows r with
    r % n == h). Rows are longest-first after the reorder, so the stride
    balances their cost;
  * each process runs the selected engine on its rows (``local_filter_csr``
    restricts the pair set to them), on its own card;
  * the per-pair triples and region records are gathered to process 0
    over gloo (``gather_merge``), which alone writes the outputs. The
    merge scatters by slot, so its result does not depend on timing.

A launch is configured by the JAX package's three variables, with the
same meaning, so one launch script serves both packages:
``JAX_COORDINATOR_ADDRESS`` (host:port of process 0's rendezvous),
``JAX_NUM_PROCESSES`` and ``JAX_PROCESS_ID``.

This module imports torch only inside the functions that need it: the
numpy helpers and a single-process ``gather_merge`` load no torch.
"""

from __future__ import annotations

import os
import sys
from datetime import timedelta

import numpy as np

ENV_ADDRESS = "JAX_COORDINATOR_ADDRESS"
ENV_NUM_PROCESSES = "JAX_NUM_PROCESSES"
ENV_PROCESS_ID = "JAX_PROCESS_ID"

#: how long the rendezvous waits for every process to join; a process
#: that cannot reach the coordinator fails after it
RENDEZVOUS_TIMEOUT = timedelta(seconds=300)
#: how long a collective waits for its peers. A process that finished its
#: share waits in the first gather for the slowest process's whole share,
#: which may take days in a large run, so the limit sits far above any
#: run (24 days: its milliseconds still fit a signed 32-bit count). A
#: peer that fails or is killed closes its connections, and that fails
#: the waiting collective at once, whatever this limit
COLLECTIVE_TIMEOUT = timedelta(days=24)


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the launch's gloo process group when a multi-process launch
    is configured (the arguments, else the JAX package's three
    variables); returns (process_id, num_processes).

    Returns (0, 1) without touching torch when no coordinator is given.
    A coordinator without the process count or id raises ValueError, and
    a coordinator that cannot be reached raises after
    RENDEZVOUS_TIMEOUT: such a launch never runs single-process."""
    address = coordinator_address or os.environ.get(ENV_ADDRESS)
    if not address:
        return 0, 1
    if num_processes is None and os.environ.get(ENV_NUM_PROCESSES):
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and os.environ.get(ENV_PROCESS_ID):
        process_id = int(os.environ[ENV_PROCESS_ID])
    if num_processes is None or process_id is None:
        raise ValueError(f"a multi-process launch (coordinator {address}) "
                         f"needs {ENV_NUM_PROCESSES} and {ENV_PROCESS_ID}")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process id {process_id} outside 0.."
                         f"{num_processes - 1}")
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    host, _, port = address.rpartition(":")
    host = host.strip("[]")      # an IPv6 address in brackets
    # the rendezvous has its own, short limit; the process group's
    # collectives get COLLECTIVE_TIMEOUT
    store = dist.TCPStore(host, int(port), num_processes, process_id == 0,
                          timeout=RENDEZVOUS_TIMEOUT, wait_for_workers=True)
    dist.init_process_group("gloo", store=store, rank=process_id,
                            world_size=num_processes,
                            timeout=COLLECTIVE_TIMEOUT)
    return dist.get_rank(), dist.get_world_size()


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    dist = sys.modules.get("torch.distributed")
    if dist is not None and dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _world() -> tuple[int, int]:
    """(rank, size) of the joined process group, (0, 1) without one."""
    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def card_share(device) -> int:
    """How many processes of the launch drive `device` on this host (1
    without a process group): those whose host name and device name equal
    this process's. Every process of the launch must call it."""
    _, size = _world()
    if size == 1:
        return 1
    import socket

    import torch.distributed as dist

    mine = (socket.gethostname(), str(device))
    every = [None] * size
    dist.all_gather_object(every, mine)
    return sum(e == mine for e in every)


def partition_refs(n_refs: int, n_hosts: int, host_id: int) -> np.ndarray:
    """Stride partition of the reference rows: process h owns the rows r
    with r % n_hosts == h."""
    return np.arange(host_id, n_refs, n_hosts, dtype=np.int64)


def local_filter_csr(rows: np.ndarray, n: int, filter_csr=None):
    """CSR restriction of the pair set to the reference rows `rows`.

    Dense (filter_csr None): each owned row x every other id. Filter: the
    owned slices of the global CSR. Returns (indptr, ids, global_slots):
    global_slots maps each local entry to its slot in the full result
    (dense: r*(n-1)+adj(q); filter: the global entry index), int64."""
    indptr = np.zeros(n + 1, np.int64)
    ids_parts = []
    slot_parts = []
    owned = np.zeros(n, bool)
    owned[rows] = True
    if filter_csr is None:
        for r in range(n):
            if owned[r]:
                q = np.concatenate([np.arange(0, r), np.arange(r + 1, n)])
                ids_parts.append(q.astype(np.int32))
                slot_parts.append(r * (n - 1)
                                  + np.where(q > r, q - 1, q).astype(np.int64))
            indptr[r + 1] = indptr[r] + (n - 1 if owned[r] else 0)
    else:
        g_indptr, g_ids = filter_csr
        for r in range(n):
            if owned[r]:
                lo, hi = int(g_indptr[r]), int(g_indptr[r + 1])
                ids_parts.append(np.asarray(g_ids[lo:hi], np.int32))
                slot_parts.append(np.arange(lo, hi, dtype=np.int64))
            indptr[r + 1] = indptr[r] + (
                int(g_indptr[r + 1] - g_indptr[r]) if owned[r] else 0)
    ids = (np.concatenate(ids_parts) if ids_parts
           else np.zeros(0, np.int32))
    slots = (np.concatenate(slot_parts) if slot_parts
             else np.zeros(0, np.int64))
    return indptr, ids, slots


def merge_host_triples(total_slots: int,
                       per_host: list[tuple[np.ndarray, np.ndarray]]
                       ) -> np.ndarray:
    """Scatter each process's (slots, triples) into the full flat
    (total_slots, 3) result. Slots are disjoint, so the order does not
    matter."""
    out = np.zeros((total_slots, 3), np.int32)
    for slots, triples in per_host:
        out[slots] = triples.reshape(-1, 3)
    return out


def gather_chunks(arr: np.ndarray, chunk: int, sink) -> None:
    """Gather every process's `arr` (rows along the first axis; the same
    dtype and row shape on every process, any length) to process 0 in
    rounds of at most `chunk` rows. On process 0, ``sink(h, rows)`` gets
    each process h's rows of a round, hosts in order within a round.

    Every process of the group must call it. The lengths go first (one
    all-gather of one int64 each), then each round is padded to the
    longest process's rows, since a collective needs equal shapes; a
    round holds at most (processes x chunk) rows on process 0 and chunk
    rows elsewhere."""
    import torch
    import torch.distributed as dist

    rank, size = _world()
    n = torch.tensor([len(arr)], dtype=torch.int64)
    lens = [torch.zeros_like(n) for _ in range(size)]
    dist.all_gather(lens, n)
    lens = [int(v) for v in lens]
    for k0 in range(0, max(lens), chunk):
        c = min(chunk, max(lens) - k0)
        part = np.zeros((c,) + arr.shape[1:], arr.dtype)
        take = arr[k0:k0 + c]
        part[:len(take)] = take
        t = torch.from_numpy(part)
        if rank != 0:
            dist.gather(t, dst=0)
            continue
        got = [torch.empty_like(t) for _ in range(size)]
        dist.gather(t, gather_list=got, dst=0)
        for h in range(size):
            hn = min(max(lens[h] - k0, 0), c)
            if hn:
                sink(h, got[h][:hn].numpy())


def gather_merge(slots: np.ndarray, triples: np.ndarray,
                 total_slots: int, region_blob: bytes = b"",
                 chunk: int | None = None
                 ) -> tuple[np.ndarray | None, bytes]:
    """Gather every process's (slots, triples, region bytes) to process 0,
    which scatters them into the full flat (total_slots, 3) int32 result
    and joins the region blobs in process order (region records are
    self-delimiting and order-free). Other processes return (None, b"")
    and never allocate a table of total_slots rows.

    The exchange runs in rounds of `chunk` pairs (default
    LZANI_TPU_MERGE_CHUNK, 1 << 22), each pair one int64 row {slot,
    triple}: gloo carries int64 as it is, so slots past 2^31 cross
    exactly. Single-process callers skip the collectives."""
    slots = np.asarray(slots, np.int64)
    triples = np.asarray(triples, np.int32).reshape(-1, 3)
    rank, size = _world()
    if size == 1:
        return merge_host_triples(total_slots, [(slots, triples)]), \
            region_blob
    if chunk is None:
        chunk = int(os.environ.get("LZANI_TPU_MERGE_CHUNK", 1 << 22))
    chunk = max(int(chunk), 1)

    out = np.zeros((total_slots, 3), np.int32) if rank == 0 else None

    def put(_, rows):
        out[rows[:, 0]] = rows[:, 1:]

    pairs = np.empty((len(slots), 4), np.int64)
    pairs[:, 0] = slots
    pairs[:, 1:] = triples
    gather_chunks(pairs, chunk, put)
    del pairs

    parts: list[list[bytes]] = [[] for _ in range(size)]
    gather_chunks(np.frombuffer(region_blob, np.uint8), chunk,
                  lambda h, rows: parts[h].append(rows.tobytes()))
    return out, b"".join(b"".join(p) for p in parts)


def all2all_multihost(codes, params, filter_csr=None, devices=None,
                      process_id=None, num_processes=None):
    """This process's share of the all-vs-all through ``all2all_cuda``:
    (slots, triples, total slots). `process_id` and `num_processes`
    default to ``init_distributed()``'s; merge the shares with
    ``gather_merge`` (or ``merge_host_triples`` when simulated).
    ``devices=["cpu"]`` runs the kernels' plain versions (tests)."""
    from ..ops.cuda_engine import all2all_cuda

    n = len(codes)
    if process_id is None or num_processes is None:
        process_id, num_processes = init_distributed()
    rows = partition_refs(n, num_processes, process_id)
    indptr, ids, slots = local_filter_csr(rows, n, filter_csr)
    triples = all2all_cuda(codes, params, filter_csr=(indptr, ids),
                           devices=devices)
    total = (n * (n - 1) if filter_csr is None
             else int(np.asarray(filter_csr[0])[-1]))
    return slots, triples, total
