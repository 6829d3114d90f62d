"""Streaming I/O runtime: native ring buffer + block streamer."""

from .stream import RingBuffer, StreamingResampler, build_native

__all__ = ["RingBuffer", "StreamingResampler", "build_native"]
