"""Serving runtime: page allocator, paged KV cache, continuous-batching engine."""
