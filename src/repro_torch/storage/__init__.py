"""Shredded columnar storage engine (PyTorch twin of ``repro.storage``):
persistent on-disk format for value-shredded nested collections with
zone-map scan pruning, streaming ingest, per-chunk lightweight
encodings (RLE / delta / bit-packing / dictionary), decoded on the card
by the kernels of ``kernels/csrc/decode.cu``, and morsel-streaming
out-of-core windows (DESIGN.md "Shredded columnar storage",
"Compressed chunks and morsel streaming")."""

from .catalog import (PartRequirement, StorageCatalog, StorageEnv,
                      storage_requirements)
from .encodings import (choose_encoding, decode_chunk, encode_chunk,
                        run_count)
from .format import DatasetMeta, PartMeta, chunk_may_match
from .morsel import MorselPlan, MorselWindow, load_morsel_window, \
    plan_morsels
from .reader import (STORAGE_STATS, StoredDataset, StoredPart,
                     reset_storage_stats, restore_encoders, table_stats)
from .writer import DatasetWriter

__all__ = ["DatasetMeta", "DatasetWriter", "MorselPlan", "MorselWindow",
           "PartMeta", "PartRequirement",
           "STORAGE_STATS", "StorageCatalog", "StorageEnv",
           "StoredDataset", "StoredPart", "choose_encoding",
           "chunk_may_match", "decode_chunk", "encode_chunk",
           "load_morsel_window", "plan_morsels",
           "reset_storage_stats", "restore_encoders", "run_count",
           "storage_requirements", "table_stats"]
