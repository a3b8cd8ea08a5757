"""Artifact loading path: stream-overlapped host→device weight upload
(port of ``repro/serverless/loading.py``).

The paper loads artifacts with CUDA streams and asynchronous copies (§5);
this is that form on one card.  ``pipelined_device_put`` copies a
parameter tree to the device on a side stream and synchronises once at the
end:

* a leaf that already lies in pinned (page-locked) host memory — a
  ``HostTier`` — goes straight over: one ``non_blocking`` copy;
* pageable leaves go through a double-buffered pinned staging ring: the
  host copy of chunk i+1 into one buffer overlaps the DMA of chunk i out of
  the other (``stage_plan`` cuts the leaves' bytes into chunks).

``pin_host_tier`` makes the HOST tier of the artifact model: one flat
page-locked buffer holding every leaf, pinned to the byte with
``cudaHostRegister`` (the caching host allocator behind ``pin_memory``
would round the allocation up to a power of two).

There is no fallback: a failed pin, copy or device raises.  With
``device="cpu"`` (the tests) the same staging plan runs through unpinned
buffers and returns a copy of each leaf, equal bit for bit.
"""
from __future__ import annotations

import time
import weakref
from typing import Any, Dict, List, Tuple, Union

import torch

from repro_torch.core.lora import _zip_map, tree_leaves
from repro_torch.serverless.latency import Hardware, LatencyModel

Params = Dict[str, Any]

STAGE_CHUNK_BYTES = 64 << 20      # one staging buffer (two in the ring)
HOST_ALIGN = 256                  # byte alignment of each leaf in the arena
PAGE = 4096

# (leaf index, byte offset in the leaf, byte offset in the buffer, bytes)
Piece = Tuple[int, int, int, int]


def _bytes(x: torch.Tensor) -> torch.Tensor:
    """Flat uint8 view of a contiguous tensor's storage."""
    return x.reshape(-1).view(torch.uint8)


def _rebuild(params: Params, leaves: List[torch.Tensor]) -> Params:
    it = iter(leaves)
    return _zip_map(lambda x: None if x is None else next(it), params)


def stage_plan(sizes: List[int], chunk_bytes: int) -> List[List[Piece]]:
    """Cut the concatenated bytes of leaves of ``sizes`` bytes into chunks
    of at most ``chunk_bytes``: one list of pieces per chunk, in order.  A
    leaf may straddle chunks, and a leaf larger than a chunk spans several;
    every byte lies in exactly one piece."""
    if chunk_bytes <= 0:
        raise ValueError(f"chunk_bytes must be positive, got {chunk_bytes}")
    plan: List[List[Piece]] = []
    cur: List[Piece] = []
    fill = 0
    for i, n in enumerate(sizes):
        off = 0
        while off < n:
            take = min(n - off, chunk_bytes - fill)
            cur.append((i, off, fill, take))
            off += take
            fill += take
            if fill == chunk_bytes:
                plan.append(cur)
                cur, fill = [], 0
    if cur:
        plan.append(cur)
    return plan


def _staged(srcs: List[torch.Tensor], dsts: List[torch.Tensor],
            device: torch.device, stream) -> None:
    """Copy ``srcs`` (host) into ``dsts`` through two staging buffers of
    ``STAGE_CHUNK_BYTES``: host copy of chunk i+1 into one buffer while
    chunk i's DMA drains the other.  A buffer is refilled only after the
    event of its last DMA."""
    sb = [_bytes(s) for s in srcs]
    db = [_bytes(d) for d in dsts]
    plan = stage_plan([b.numel() for b in sb], STAGE_CHUNK_BYTES)
    if not plan:
        return
    cuda = device.type == "cuda"
    size = max(sum(p[3] for p in c) for c in plan)
    bufs = [torch.empty(size, dtype=torch.uint8, pin_memory=cuda)
            for _ in range(min(2, len(plan)))]
    done: List = [None] * len(bufs)
    for k, pieces in enumerate(plan):
        b = k % len(bufs)
        if done[b] is not None:
            done[b].synchronize()
        buf = bufs[b]
        for i, off, at, n in pieces:
            buf[at:at + n].copy_(sb[i][off:off + n])
        for i, off, at, n in pieces:
            db[i][off:off + n].copy_(buf[at:at + n], non_blocking=cuda)
        if cuda:
            done[b] = torch.cuda.Event()
            done[b].record(stream)


def pipelined_device_put(params: Union[Params, "HostTier"],
                         device="cuda") -> Tuple[Params, float]:
    """Upload a host parameter tree, or a ``HostTier``, to ``device``;
    returns (device tree, wall seconds), the reference's contract.

    On a CUDA device the destinations are allocated on the current
    (consuming) stream, the copies run on a side stream that first waits
    for it, and the current stream waits for the side stream before the
    tree is returned: one synchronisation in all.  Pinned leaves — every
    leaf of a ``HostTier``, whose registered memory ``Tensor.is_pinned``
    does not report, and leaves that ``is_pinned`` reports — are one
    ``non_blocking`` copy each; pageable ones go through the staging
    ring.  Source leaves must lie in host memory."""
    device = torch.device(device)
    registered = isinstance(params, HostTier)
    if registered:
        params = params.params
    leaves = tree_leaves(params)
    for x in leaves:
        if x.device.type != "cpu":
            raise ValueError(f"pipelined_device_put loads host tensors; a "
                             f"leaf lies on {x.device}")
    t0 = time.perf_counter()
    srcs = [x.contiguous() for x in leaves]
    if device.type == "cpu":
        dsts = [torch.empty_like(x) for x in srcs]
        _staged(srcs, dsts, device, None)
        return _rebuild(params, dsts), time.perf_counter() - t0
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    consumer = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    dsts = [torch.empty_like(x, device=device) for x in srcs]
    pinned = [registered or x.is_pinned() for x in srcs]
    side.wait_stream(consumer)
    with torch.cuda.stream(side):
        for s, d, p in zip(srcs, dsts, pinned):
            if p:
                d.copy_(s, non_blocking=True)
        _staged([s for s, p in zip(srcs, pinned) if not p],
                [d for d, p in zip(dsts, pinned) if not p],
                device, side)
    consumer.wait_stream(side)
    side.synchronize()
    return _rebuild(params, dsts), time.perf_counter() - t0


def _unregister(flat: torch.Tensor) -> None:
    torch.cuda.check_error(
        torch.cuda.cudart().cudaHostUnregister(flat.data_ptr()))


class HostTier:
    """A parameter tree in one flat page-locked host buffer of ``nbytes``:
    ``params`` holds views into it, each leaf at a ``HOST_ALIGN``-byte
    offset.  The buffer starts on a page and is registered with
    ``cudaHostRegister`` (pinned to the byte) while this object lives;
    ``close``, or its collection, unregisters it."""

    def __init__(self, nbytes: int):
        t0 = time.perf_counter()
        nbytes = max(nbytes, 1)
        raw = torch.empty(nbytes + PAGE, dtype=torch.uint8)
        start = -raw.data_ptr() % PAGE
        self.flat = raw[start:start + nbytes]
        torch.cuda.check_error(torch.cuda.cudart().cudaHostRegister(
            self.flat.data_ptr(), nbytes, 0))
        self._finalizer = weakref.finalize(self, _unregister, self.flat)
        self.params: Params = {}
        self.register_s = time.perf_counter() - t0   # allocate + register
        self.copy_s = 0.0                            # the tree copied in

    @property
    def nbytes_pinned(self) -> int:
        return self.flat.numel()

    def close(self) -> None:
        self._finalizer()


def pin_host_tier(params: Params) -> HostTier:
    """Copy a tree (from the device or the host) into a ``HostTier``: the
    HOST tier of an offloaded artifact, which ``pipelined_device_put``
    loads straight over.  The copies out of the device are synchronous.
    Raises if the registration fails."""
    leaves = tree_leaves(params)
    offsets, total = [], 0
    for x in leaves:
        offsets.append(total)
        n = x.numel() * x.element_size()
        total += (n + HOST_ALIGN - 1) // HOST_ALIGN * HOST_ALIGN
    tier = HostTier(total)
    t0 = time.perf_counter()
    views = []
    for x, off in zip(leaves, offsets):
        n = x.numel() * x.element_size()
        v = tier.flat[off:off + n].view(x.dtype).view(x.shape)
        v.copy_(x)
        views.append(v)
    tier.params = _rebuild(params, views)
    tier.copy_s = time.perf_counter() - t0
    return tier


def estimate_load_seconds(nbytes: int, hw: Hardware, *,
                          from_remote: bool = False,
                          overlap: float = 0.85) -> float:
    """Loading-latency estimate with pipelining: overlapped stages cost
    max(stage) + (1-overlap)·min(stage) instead of the sum."""
    lat = LatencyModel(hw)
    h2d = lat.host_to_gpu_s(nbytes)
    if not from_remote:
        return h2d
    remote = lat.remote_to_host_s(nbytes)
    hi, lo = max(remote, h2d), min(remote, h2d)
    return hi + (1.0 - overlap) * lo
