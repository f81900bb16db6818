"""Input pipeline: KFTR record format + native (C++) prefetch core.

A copy of the JAX package's kubeflow_tpu/data/ (it uses no JAX).  See
data/loader.py; the hot path (threaded read, ring buffer, shuffle) lives
in data/native/kft_data.cc, compiled on first use into data/_build/ and
loaded via ctypes with a pure-python fallback.
"""

from kubeflow_tpu_torch.data.loader import (
    DataError,
    RecordDataset,
    RecordWriter,
    decode_example,
    encode_example,
    read_records,
    tensor_batches,
    write_example_shards,
)

__all__ = [
    "DataError",
    "RecordDataset",
    "RecordWriter",
    "decode_example",
    "encode_example",
    "read_records",
    "tensor_batches",
    "write_example_shards",
]
