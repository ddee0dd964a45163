"""The native transfer plane: KV block bytes between hosts over the C++
agent (csrc/transfer_agent.cpp), bound with ctypes. See ``native.py``."""

from .native import NativeAgent, ensure_native, native_available, native_fetch

__all__ = ["NativeAgent", "ensure_native", "native_available", "native_fetch"]
