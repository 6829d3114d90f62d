"""Host-side streaming: native ring buffer -> block step on the card.

Counterpart of ``multirate_tpu/io/stream.py``. Real streaming sources
(audio, SDR, sockets) deliver arbitrary-sized chunks; the block step wants
fixed blocks. ``RingBuffer`` wraps the C++ lock-free SPSC ring
(``csrc/mr_ring.cpp``, built on first use with g++ into ``build/``);
``StreamingResampler`` assembles fixed blocks from pushed chunks and drives
any kernel of the package through ``FIRFilter``, carrying the FilterState
across blocks. ``flush`` runs the sub-block tail.

The block loop never reads a value back from the card: each block's output
count comes from the state's host ints (``indexing.host_carry``). Each
block leaves the ring as a copy (the ring's pop returns a scratch buffer
that the next pop overwrites), is staged through pinned memory and goes to
the card with a non-blocking copy, so the loop makes no synchronizing
call; ``pull`` is the one place where output moves to the host.

Under a profiler the stream records the tracer's spans
(``utils.profiling``): ``mr.stream.push`` and ``mr.stream.pull`` around
the public calls that do work, ``mr.stream.ring_push`` and
``mr.stream.ring_pop`` in the ring, ``mr.stream.block`` around a block's
staging and filtering, ``mr.stream.stage`` around its staging and
``mr.stream.to_host`` around the pull's copy to host memory.

The reference has no streaming runtime (its user loops over filt calls,
e.g. examples/Interactive Farrow Example.jl); this is the production-shaped
equivalent for a device-accelerated pipeline.
"""

from __future__ import annotations

import ctypes
import os
import time

import numpy as np
import torch

from ..models.resampler import Resampler
from ..ops.api import FIRFilter
from ..ops.cuda.build import build, load
from ..ops.params import default_device
from ..utils.checkpoint import state_from_host, state_to_host
from ..utils.profiling import recording, span

__all__ = ["RingBuffer", "StreamingResampler", "build_native"]

# The ring's C signatures for ``build.load`` (csrc/mr_ring.cpp).
_P, _SIZE = ctypes.c_void_p, ctypes.c_size_t
SIGNATURES = (("mr_ring_create", _P, (_SIZE,)),
              ("mr_ring_destroy", None, (_P,)),
              ("mr_ring_capacity", _SIZE, (_P,)),
              ("mr_ring_size", _SIZE, (_P,)),
              ("mr_ring_push", _SIZE, (_P, _P, _SIZE)),
              ("mr_ring_push_i16", _SIZE, (_P, _P, _SIZE)),
              ("mr_ring_pop_block", ctypes.POINTER(ctypes.c_float),
               (_P, _SIZE)),
              ("mr_ring_drain", _SIZE, (_P, _P, _SIZE)))


def build_native(force: bool = False) -> str:
    """Compile the native ring buffer (g++ -O3) into ``build/`` if not
    already built (always with ``force``); returns the library's path."""
    return str(build("mr_ring", force=force))


class RingBuffer:
    """Lock-free single-producer/single-consumer f32 ring buffer (native)."""

    def __init__(self, min_capacity: int = 1 << 20):
        lib = load("mr_ring", SIGNATURES)
        self._lib = lib
        self._ptr = lib.mr_ring_create(min_capacity)
        if not self._ptr:
            raise MemoryError("mr_ring_create failed")

    def __del__(self):
        ptr = getattr(self, "_ptr", None)
        if ptr:
            self._lib.mr_ring_destroy(ptr)
            self._ptr = None

    @property
    def capacity(self) -> int:
        return self._lib.mr_ring_capacity(self._ptr)

    def __len__(self) -> int:
        return self._lib.mr_ring_size(self._ptr)

    def push(self, chunk) -> int:
        """Append samples (float32 or int16 array); returns samples queued
        (0 if the ring is full). Traced as ``mr.stream.ring_push``."""
        return self._push(chunk, recording())

    def _push(self, chunk, on: bool) -> int:
        if on:
            with span("mr.stream.ring_push", True):
                return self._push(chunk, False)
        a = np.ascontiguousarray(chunk)
        if a.dtype == np.int16:
            return self._lib.mr_ring_push_i16(
                self._ptr, a.ctypes.data_as(ctypes.c_void_p), a.size)
        a = a.astype(np.float32, copy=False)
        return self._lib.mr_ring_push(
            self._ptr, a.ctypes.data_as(ctypes.c_void_p), a.size)

    def pop_block(self, block: int):
        """Pop exactly ``block`` samples as a numpy copy, or None. (The
        native pop returns a scratch buffer that the next pop overwrites.)
        Traced as ``mr.stream.ring_pop``."""
        return self._pop_block(block, recording())

    def _pop_block(self, block: int, on: bool):
        if on:
            with span("mr.stream.ring_pop", True):
                return self._pop_block(block, False)
        p = self._lib.mr_ring_pop_block(self._ptr, block)
        if not p:
            return None
        return np.ctypeslib.as_array(p, shape=(block,)).copy()

    def drain(self, max_n: int | None = None) -> np.ndarray:
        n = len(self) if max_n is None else min(max_n, len(self))
        out = np.empty(n, np.float32)
        got = self._lib.mr_ring_drain(
            self._ptr, out.ctypes.data_as(ctypes.c_void_p), n)
        return out[:got]


class StreamingResampler:
    """Push arbitrary chunks in; pull resampled blocks out.

    Takes a ``FIRFilter``, a kernel (``make_kernel``'s result) or a
    ``models.Resampler``. Assembles fixed ``block_size`` input blocks from
    the ring, runs the filter on the stream's device (the filter's, else
    the card) with the state carried, and keeps the outputs there until
    ``pull``.

    - ``flush()`` runs the sub-block tail as it is (PyTorch has no block
      shape to keep) and returns all output: the output count is the
      true tail's closed-form count, as in the JAX package, which pads the
      tail to ``block_size`` and trims. A flush ends the stream: further
      pushes raise until ``reset()``.
    - ``checkpoint_every=N`` saves the FilterState plus the consumed- and
      produced-sample counters to ``checkpoint_path`` after every N blocks.
      ``resume()`` restores it and returns the number of input samples
      already consumed, so a restarted producer re-feeds from that offset
      and the concatenated output is identical to an uninterrupted run.
    """

    def __init__(self, params_or_filter, block_size: int = 1 << 16,
                 ring_capacity: int | None = None,
                 checkpoint_every: int | None = None,
                 checkpoint_path: str | None = None):
        if isinstance(params_or_filter, Resampler):
            f = params_or_filter._filter
        elif isinstance(params_or_filter, FIRFilter):
            f = params_or_filter
        else:
            f = FIRFilter.__new__(FIRFilter)
            f.params = params_or_filter
            f.path = "auto"
            f.device = params_or_filter.device
            f.state = None
        if f.device is None:  # pin the stream now, not inside the loop
            f._pin(default_device())
        self._filter = f
        self.device = f.device
        self.block_size = block_size
        self.ring = RingBuffer(ring_capacity or max(4 * block_size, 1 << 16))
        self._out: list[torch.Tensor] = []
        self._ended = False
        self._blocks = 0
        self._consumed = 0
        self._produced = 0
        self._block_seconds_last = None
        self._block_seconds_ema = None
        self.checkpoint_every = checkpoint_every
        self.checkpoint_path = checkpoint_path
        if checkpoint_every and not checkpoint_path:
            raise ValueError("checkpoint_every requires checkpoint_path")

    @property
    def state(self):
        return self._filter.state

    def _to_device(self, blk: np.ndarray, on: bool) -> torch.Tensor:
        if on:
            with span("mr.stream.stage", True):
                return self._to_device(blk, False)
        x = torch.from_numpy(blk)
        if self.device.type == "cpu":
            return x
        # pinned staging and a non-blocking copy: no stream synchronize.
        # The caching host allocator keeps the pinned buffer alive until
        # its copy has ended.
        return x.pin_memory().to(self.device, non_blocking=True)

    def _run_block(self, blk: np.ndarray, on: bool):
        # y stays on the device (host transfer deferred to pull()): the
        # count is closed-form on the host, so nothing waits for the card.
        # The block's time is the span's, from the same two clock reads.
        if on:
            with span("mr.stream.block", True) as sp:
                y = self._filter.filt(self._to_device(blk, True))
            dt = (sp.end_ns - sp.start_ns) * 1e-9
        else:
            t0 = time.perf_counter_ns()
            y = self._filter.filt(self._to_device(blk, False))
            dt = (time.perf_counter_ns() - t0) * 1e-9
        self._out.append(y)
        self._blocks += 1
        self._consumed += blk.size
        self._produced += y.shape[-1]
        self._block_seconds_last = dt
        # EMA over ~16 blocks: smooth enough to read, fresh enough to alert
        self._block_seconds_ema = dt if self._block_seconds_ema is None \
            else 0.9375 * self._block_seconds_ema + 0.0625 * dt
        if self.checkpoint_every and \
                self._blocks % self.checkpoint_every == 0:
            self.checkpoint()

    def stats(self) -> dict:
        """Per-block observability: counters and block times.

        The block times are host wall time to dispatch a block once the
        ring has given it up (staging, the filter's host work and the
        kernel launch; not the ring's pop), the interval of the span
        ``mr.stream.block``; the card runs asynchronously, so they are not
        kernel time.
        """
        return {
            "blocks": self._blocks,
            "consumed_samples": self._consumed,
            "produced_samples": self._produced,
            "queued_samples": len(self.ring),
            "pending_output_chunks": len(self._out),
            "block_seconds_last": self._block_seconds_last,
            "block_seconds_ema": self._block_seconds_ema,
            "ended": self._ended,
        }

    def checkpoint(self) -> None:
        """Persist (FilterState, consumed/produced counters) atomically."""
        payload = state_to_host(self._filter.state)
        payload["consumed"] = np.asarray(self._consumed)
        payload["produced"] = np.asarray(self._produced)
        tmp = self.checkpoint_path + ".tmp.npz"
        np.savez(tmp, **payload)
        os.replace(tmp, self.checkpoint_path)

    def resume(self) -> int:
        """Restore the last checkpoint; returns the consumed-sample count
        (the offset from which the producer must re-feed input)."""
        with np.load(self.checkpoint_path) as z:
            d = {k: z[k] for k in z.files}
        self._consumed = int(d.pop("consumed"))
        self._produced = int(d.pop("produced"))
        self._filter.state = state_from_host(
            d, self.device, self._filter.params.h_min)
        self._blocks = 0
        self._ended = False
        self._out.clear()
        return self._consumed

    def push(self, chunk) -> int:
        """Queue samples; runs the filter for every complete block.
        Traced as ``mr.stream.push``."""
        if self._ended:
            raise RuntimeError("stream was flushed; call reset() to reuse")
        if not recording():
            return self._push(chunk, False)
        with span("mr.stream.push", True):
            return self._push(chunk, True)

    def _push(self, chunk, on: bool) -> int:
        # the ring's private entries take the answer: one check a push
        queued = self.ring._push(chunk, on)
        while True:
            blk = self.ring._pop_block(self.block_size, on)
            if blk is None:
                break
            self._run_block(blk, on)
        return queued

    def pull(self) -> np.ndarray:
        """All output produced so far (concatenated); empties the queue.
        This is where the deferred device->host transfer happens. A pull
        that moves output is traced as ``mr.stream.pull``."""
        if not self._out:
            return np.empty(0, np.float32)
        if not recording():
            return self._pull(False)
        with span("mr.stream.pull", True):
            return self._pull(True)

    def _pull(self, on: bool) -> np.ndarray:
        y = torch.cat(self._out, dim=-1)
        if on:
            with span("mr.stream.to_host", True):
                y = y.cpu()
        else:
            y = y.cpu()
        self._out.clear()
        return y.numpy()

    def flush(self) -> np.ndarray:
        """Run the remaining sub-block tail and return all output; the
        stream is then ended."""
        tail = self.ring.drain()
        if tail.size:
            y = self._filter.filt(self._to_device(tail, recording()))
            self._out.append(y)
            self._consumed += tail.size
            self._produced += y.shape[-1]
            self._ended = True
        return self.pull()

    def reset(self) -> "StreamingResampler":
        """Start a fresh stream (zero state, counters, queued output)."""
        self._filter.reset()
        self._out.clear()
        self._ended = False
        self._blocks = 0
        self._consumed = 0
        self._produced = 0
        return self
