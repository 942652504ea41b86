from .compressor import (compress_layer_kv, dequantize_layer_cache,
                         summarize_layer_stats)
from .kv_cache import (CompressedLayerCache, RecentCache, TierCache,
                       append_recent, cache_storage_bytes, init_recent_cache)

__all__ = [
    "compress_layer_kv", "dequantize_layer_cache", "summarize_layer_stats",
    "CompressedLayerCache", "RecentCache", "TierCache", "append_recent",
    "cache_storage_bytes", "init_recent_cache",
]
