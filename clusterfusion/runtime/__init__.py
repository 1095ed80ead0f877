"""Native runtime layer: C++ paged-KV page allocator + continuous-batching
scheduler (native/kv_runtime.cpp via ctypes) and the serving engine that
drives the paged decode step with it — the framework-native counterpart of
the external SGLang runner the reference targets (`README.md:55-76`)."""

from clusterfusion.runtime.native import PagedKVScheduler
from clusterfusion.runtime.serving import ServingEngine

__all__ = ["PagedKVScheduler", "ServingEngine"]
