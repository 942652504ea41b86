from .compressor import (compress_layer_kv, compress_layer_kv_chunked,
                         concat_layer_caches, dequantize_layer_cache,
                         empty_layer_cache, identify_prompt_length,
                         summarize_layer_stats,
                         summarize_layer_stats_per_row, update_cache_chunk)
from .kv_cache import (CompressedLayerCache, DecodePool, RecentCache,
                       TierCache, append_recent, cache_storage_bytes,
                       dequantize_decode_pool, flush_recent,
                       init_decode_pool, init_recent_cache,
                       layer_cache_report, uncompressed_kv_bytes)

__all__ = [
    "compress_layer_kv", "compress_layer_kv_chunked", "concat_layer_caches",
    "dequantize_layer_cache", "empty_layer_cache", "identify_prompt_length",
    "summarize_layer_stats", "summarize_layer_stats_per_row",
    "update_cache_chunk",
    "CompressedLayerCache", "DecodePool", "RecentCache", "TierCache",
    "append_recent", "cache_storage_bytes", "dequantize_decode_pool",
    "flush_recent", "init_decode_pool", "init_recent_cache",
    "layer_cache_report", "uncompressed_kv_bytes",
]
