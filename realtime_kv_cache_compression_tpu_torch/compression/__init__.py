from .compressor import (compress_layer_kv, compress_layer_kv_chunked,
                         concat_layer_caches, dequantize_layer_cache,
                         empty_layer_cache, summarize_layer_stats,
                         update_cache_chunk)
from .kv_cache import (CompressedLayerCache, DecodePool, RecentCache,
                       TierCache, append_recent, cache_storage_bytes,
                       dequantize_decode_pool, flush_recent,
                       init_decode_pool, init_recent_cache)

__all__ = [
    "compress_layer_kv", "compress_layer_kv_chunked", "concat_layer_caches",
    "dequantize_layer_cache", "empty_layer_cache", "summarize_layer_stats",
    "update_cache_chunk",
    "CompressedLayerCache", "DecodePool", "RecentCache", "TierCache",
    "append_recent", "cache_storage_bytes", "dequantize_decode_pool",
    "flush_recent", "init_decode_pool", "init_recent_cache",
]
