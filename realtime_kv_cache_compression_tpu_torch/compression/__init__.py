from .compressor import (compress_layer_kv, dequantize_layer_cache,
                         summarize_layer_stats)
from .kv_cache import (CompressedLayerCache, DecodePool, RecentCache,
                       TierCache, append_recent, cache_storage_bytes,
                       dequantize_decode_pool, flush_recent,
                       init_decode_pool, init_recent_cache)

__all__ = [
    "compress_layer_kv", "dequantize_layer_cache", "summarize_layer_stats",
    "CompressedLayerCache", "DecodePool", "RecentCache", "TierCache",
    "append_recent", "cache_storage_bytes", "dequantize_decode_pool",
    "flush_recent", "init_decode_pool", "init_recent_cache",
]
